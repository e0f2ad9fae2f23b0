"""The port's predictor fleet (``mmlspark_tpu_torch.io.fleet``) against the
JAX package's, on the CPU.

Forests: a regression forest (500 × 8, 12 iterations) and a three-class
one (400 × 6, 6 iterations), fitted by the port and loaded into a CPU
booster of each package from the same model text (the native scorers).

* ``shard_tree_ranges`` and ``ConsistentHashRing`` routes equal the
  reference's; the port's ``ShardedPredictor`` equals the reference's
  bit for bit.
* ``PredictorFleet(spawn=False)`` (workers as threads over real sockets
  and frames): the shard fleet's reduce equals the reference's
  ``ShardedPredictor`` bit for bit, through seeded link kills too; the
  replica pool equals the full model, and a lost replica leaves the
  ring; the fleet drives a ``ScoringEngine``; the two-phase version
  cutover never mixes versions and a corrupt file aborts it.
* ``PredictorFleet(spawn=True)``: two spawned workers load the model on
  the booster's device (the CPU here) and equal the sharded reduce.
* The exchange's binary park: a malformed preamble costs one request,
  and a frame's deadline wraps the payload.
"""

import queue
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu.gbdt import Booster as RefBooster
from mmlspark_tpu.io import fleet as rfleet
from mmlspark_tpu_torch import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.gbdt import Booster
from mmlspark_tpu_torch.gbdt.booster import ModelDigestError
from mmlspark_tpu_torch.io import wire
from mmlspark_tpu_torch.io.chaos import ChaosPlan, ChaosTransport
from mmlspark_tpu_torch.io.fleet import (ConsistentHashRing, PredictorFleet,
                                         ShardedPredictor, _fleet_worker_main,
                                         shard_tree_ranges)
from mmlspark_tpu_torch.io.scoring import ColumnPlan, ScoringEngine
from mmlspark_tpu_torch.io.serving import MultiprocessHTTPServer
from mmlspark_tpu_torch.io.transport import (CH_CONTROL, CH_SCORING,
                                             TransportClient,
                                             TransportConfig,
                                             TransportError)
from torch_parity import one_torch_thread  # noqa: F401 - fixture

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(booster):
    text = booster.save_native_model_string()
    return (Booster.load_native_model_string(text, device="cpu"),
            RefBooster.load_native_model_string(text))


@pytest.fixture(scope="module")
def reg():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + np.sin(X[:, 3])).astype(np.float64)
    b = LightGBMRegressor(numIterations=12, numLeaves=15, verbosity=0,
                          device="cpu").fit({"features": X, "label": y})
    return (*_pair(b.getModel()), X)


@pytest.fixture(scope="module")
def multi():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    y = (np.abs(X[:, 0] + X[:, 1]) * 1.5).astype(np.int64) % 3
    b = LightGBMClassifier(numIterations=6, numLeaves=7, minDataInLeaf=5,
                           verbosity=0, device="cpu").fit(
        {"features": X, "label": y.astype(float)})
    port, ref, = _pair(b.getModel())
    assert port.num_class == 3
    return port, ref, X


# -- parity --------------------------------------------------------------------

@pytest.mark.parametrize("T,S,K", [(20, 3, 1), (18, 4, 3), (3, 5, 1),
                                   (0, 2, 1), (12, 1, 1), (30, 7, 3)])
def test_shard_tree_ranges_equal_the_reference(T, S, K):
    got = shard_tree_ranges(T, S, K)
    assert got == rfleet.shard_tree_ranges(T, S, K)
    assert got[0][0] == 0 and got[-1][1] == T
    for lo, hi in got:
        assert lo % K == 0 and (hi % K == 0 or hi == T)
    with pytest.raises(ValueError):
        shard_tree_ranges(10, 0)


def test_hash_ring_routes_equal_the_reference():
    ring, rring = ConsistentHashRing(range(4)), rfleet.ConsistentHashRing(
        range(4))
    keys = [f"k{i}" for i in range(2000)]
    before = {k: ring.route(k) for k in keys}
    assert before == {k: rring.route(k) for k in keys}
    assert min(list(before.values()).count(n) for n in range(4)) > 200
    ring.remove(2)
    rring.remove(2)
    for k, owner in before.items():
        assert ring.route(k) == rring.route(k)
        if owner != 2:
            assert ring.route(k) == owner
    ring.add(2)
    assert {k: ring.route(k) for k in keys} == before
    with pytest.raises(RuntimeError):
        ConsistentHashRing().route("k")


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_sharded_predictor_equals_the_reference(reg, multi, shards):
    for port, ref, X in (reg, multi):
        got = ShardedPredictor(port, num_shards=shards)(X[:64])
        want = np.asarray(rfleet.ShardedPredictor(ref, num_shards=shards)(
            X[:64]))
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert np.array_equal(got, want)
        parts = ShardedPredictor(port, num_shards=shards).partials(X[:8])
        assert len(parts) == shards
        assert all(p.shape == (8, port.num_class) for p in parts)


# -- the thread-topology fleet -------------------------------------------------

def test_shard_fleet_equals_the_reference_reduce(reg, multi):
    for port, ref, X in (reg, multi):
        fleet = PredictorFleet(port, num_shards=3, spawn=False,
                               join_timeout=20.0).start()
        try:
            want = np.asarray(rfleet.ShardedPredictor(ref, num_shards=3)(
                X[:64]))
            assert np.array_equal(fleet(X[:64]), want)
            assert fleet.mode == "fleet"
            assert fleet.num_features == X.shape[1]
        finally:
            fleet.stop()


def test_replica_pool_and_replica_loss(reg):
    port, _, X = reg
    fleet = PredictorFleet(port, num_shards=2, routing="replica",
                           spawn=False, join_timeout=20.0,
                           request_timeout_s=10.0).start()
    try:
        want = port.predict_margin(X[:16]).numpy()
        for _ in range(4):
            assert np.array_equal(fleet(X[:16]), want)
        with fleet._lock:
            sid = fleet._slot_sid[1]
        fleet._ts.drop_session(sid)
        deadline = time.time() + 10
        while 1 in fleet._ring.nodes() and time.time() < deadline:
            time.sleep(0.02)
        assert fleet._ring.nodes() == {0}
        for _ in range(4):
            assert np.array_equal(fleet(X[:16]), want)
    finally:
        fleet.stop()


def test_fleet_under_seeded_link_kills_stays_exact(reg):
    port, ref, X = reg
    plan = ChaosPlan(seed=1311)
    conn_n = [0]

    def wrap(sock):
        conn_n[0] += 1
        if conn_n[0] <= 2:
            return ChaosTransport(sock, plan, kill_on_sends={6},
                                  name=f"fleetkill{conn_n[0]}")
        return sock

    fleet = PredictorFleet(port, num_shards=2, spawn=False,
                           join_timeout=20.0, request_timeout_s=20.0,
                           transport_config=TransportConfig(
                               socket_wrap=wrap,
                               reconnect_backoff=(0.05, 0.3))).start()
    try:
        want = np.asarray(rfleet.ShardedPredictor(ref, 2)(X[:16]))
        for _ in range(8):
            assert np.array_equal(fleet(X[:16]), want)
        assert conn_n[0] > 2
    finally:
        fleet.stop()


def test_fleet_drives_the_scoring_engine(reg):
    port, _, X = reg

    class MiniServer:
        def __init__(self):
            self.request_queue = queue.Queue()
            self.got = {}

        def reply(self, rid, val, status=200):
            self.got[rid] = val
            return True

    fleet = PredictorFleet(port, num_shards=2, spawn=False,
                           join_timeout=20.0).start()
    srv = MiniServer()
    eng = ScoringEngine(srv, predictor=fleet,
                        plan=ColumnPlan("features", X.shape[1]),
                        max_rows=16, latency_budget_ms=2.0).start()
    try:
        for i in range(24):
            srv.request_queue.put((str(i), {"features": X[i].tolist()}))
        deadline = time.time() + 20
        while len(srv.got) < 24 and time.time() < deadline:
            time.sleep(0.02)
        want = ShardedPredictor(port, 2)(X[:24])
        assert [srv.got[str(i)] for i in range(24)] == want.tolist()
    finally:
        eng.stop()
        fleet.stop()


def test_version_cutover_never_mixes_and_corrupt_file_aborts(reg,
                                                             tmp_path):
    from mmlspark_tpu_torch.io.chaos import corrupt_file
    port, _, X = reg
    X = X[:64]
    rng = np.random.default_rng(5)
    y2 = (X[:, 1] - X[:, 4] + rng.normal(size=64)).astype(np.float64)
    b2 = LightGBMRegressor(numIterations=8, numLeaves=7, minDataInLeaf=5,
                           verbosity=0, device="cpu").fit(
        {"features": X, "label": y2}).getModel()
    w1 = ShardedPredictor(port, 2)(X)
    w2 = ShardedPredictor(b2, 2)(X)
    path = str(tmp_path / "v2.txt")
    b2.save_native_model(path)
    fleet = PredictorFleet(port, num_shards=2, spawn=False).start()
    results, stop = [], threading.Event()

    def loop():
        while not stop.is_set():
            results.append(fleet(X))

    t = threading.Thread(target=loop, daemon=True)
    try:
        assert np.array_equal(fleet(X), w1)
        v = fleet.load_version(path)
        t.start()
        time.sleep(0.05)
        fleet.activate_version(v)
        time.sleep(0.05)
        stop.set()
        t.join(10)
        assert fleet.active_version == v
        assert np.array_equal(fleet(X), w2)
        assert all(np.array_equal(r, w1) or np.array_equal(r, w2)
                   for r in results)
        mpath, lo, hi, ver = fleet._worker_spec(1)
        assert (mpath, (lo, hi), ver) == (path, tuple(fleet.ranges[1]), v)
        bad = str(tmp_path / "v3.txt")
        b2.save_native_model(bad)
        corrupt_file(bad, mode="bitflip")
        with pytest.raises((TransportError, ModelDigestError)):
            fleet.load_version(bad, timeout=10.0)
        assert fleet.active_version == v
        assert np.array_equal(fleet(X), w2)
    finally:
        stop.set()
        fleet.stop()


def test_a_loading_worker_needs_its_device():
    with pytest.raises(ValueError, match="device"):
        _fleet_worker_main("127.0.0.1", 1, 0, "model.txt", 0, 1, "auto",
                           "tok")


def test_spawned_fleet_loads_on_the_booster_device(reg):
    """Two spawned workers load the model file on the booster's device
    (the CPU: the native scorer) and answer the sharded reduce; the
    replica pool answers the full model."""
    port, ref, X = reg
    fleet = PredictorFleet(port, num_shards=2, spawn=True,
                           join_timeout=60.0).start()
    try:
        assert fleet._device == "cpu"
        want = np.asarray(rfleet.ShardedPredictor(ref, 2)(X[:32]))
        assert np.array_equal(fleet(X[:32]), want)
        assert np.array_equal(fleet(X[:1]), want[:1])
    finally:
        fleet.stop()


# -- the exchange's binary park ------------------------------------------------

def _fake_worker(srv):
    """Start ``srv`` with a transport client holding worker slot 0;
    returns the client and the list of what it received."""
    got, holder = [], {}

    def on_msg(sess, ch, obj, dl):
        got.append((ch, obj if isinstance(obj, dict) else bytes(obj)))

    def dial():
        h, p = srv._ts.address
        c = TransportClient((h, p), token=srv.token, on_message=on_msg,
                            cfg=TransportConfig(
                                reconnect_backoff=(0.05, 0.3)),
                            name="fake-worker")
        for _ in range(100):
            try:
                c.connect(retries=0)
                break
            except OSError:
                time.sleep(0.05)
        c.send(CH_CONTROL, {"op": "hello", "worker": 0,
                            "host": "127.0.0.1", "port": 1})
        holder["client"] = c

    t = threading.Thread(target=dial, daemon=True)
    t.start()
    srv.start()
    t.join(15)
    return holder["client"], got


def _reply_for(got, rid, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        for _ch, o in list(got):
            if isinstance(o, dict) and o.get("op") == "reply" \
                    and o.get("rid") == rid:
                return o
        time.sleep(0.02)
    return None


def test_binary_park_malformed_preamble_and_deadline():
    srv = MultiprocessHTTPServer(num_workers=1, spawn_workers=False,
                                 join_timeout=15.0)
    c = None
    try:
        c, got = _fake_worker(srv)
        good = wire.pack_matrix("badreq01", np.ones((1, 4), np.float32))
        c.send_bytes(CH_SCORING, bytes(good[:-8]))
        r = _reply_for(got, "badreq01")
        assert r is not None and r["status"] == 400
        c.send_bytes(CH_SCORING, b"\x07")
        c.send_bytes(CH_SCORING, wire.pack_matrix(
            "dl1", np.ones((1, 3), np.float32)), deadline_ms=5000)
        rid, payload, _t = srv.request_queue.get(timeout=10)
        assert rid == "dl1" and isinstance(payload, wire.BinaryReq)
        assert 0 < payload.deadline_ms <= 5000
        assert np.array_equal(payload.X, np.ones((1, 3), np.float32))
        c.send_bytes(CH_SCORING, wire.pack_matrix(
            "tworows1", np.ones((2, 4), np.float32)))
        r = _reply_for(got, "tworows1")
        assert r is not None and r["status"] == 400
        assert srv.request_queue.empty()
    finally:
        if c is not None:
            c.close()
        srv.stop()
