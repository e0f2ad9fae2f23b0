"""The port's scoring engine and HTTP serving (``mmlspark_tpu_torch.io``
``scoring`` / ``serving`` / the serving injectors of ``chaos``) against the
JAX package's, on the CPU.

* Engine replies: one model text (fitted by the port, 1,200 × 8, 12
  iterations; and a three-class forest) loaded into a CPU booster of each
  package; each package's ``ScoringEngine`` behind its own
  ``HTTPServer`` answers the same concurrent one-row JSON requests, and
  the replies are equal bit for bit (and equal ``predict_margin``).  The
  same over ``serve_forever``'s table path.
* The port's engine on a predictor that returns tensors (as the card's
  walk does): one host copy a batch, ``dispatch_host`` and
  ``device_wait`` recorded when the profiler is on.
* The port alone (the reference's behaviour, ported): deadline and
  row-cap batching, ``ColumnPlan`` on JSON and binary rows, per-row
  salvage, ``WorkerKilled`` restarts, shedding, expiry, drain, the health
  routes, slow and resetting clients, ``DistributedHTTPServer``'s
  cross-worker routing and the exchange's link-kill soak with the worker
  as a thread.
"""

import json
import queue
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import Booster as RefBooster
from mmlspark_tpu.io import scoring as rscoring
from mmlspark_tpu.io import serving as rserving
from mmlspark_tpu_torch import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.gbdt import Booster
from mmlspark_tpu_torch.io import wire
from mmlspark_tpu_torch.io.chaos import (ChaosPlan, ChaosPredictor,
                                         ChaosQueue, ChaosSocket,
                                         ChaosTransport)
from mmlspark_tpu_torch.io.scoring import (ColumnPlan, ScoringEngine,
                                           WorkerKilled, next_pow2)
from mmlspark_tpu_torch.io.serving import (DistributedHTTPServer,
                                           HTTPServer,
                                           MultiprocessHTTPServer,
                                           _Exchange, _mp_worker_main,
                                           _TrackedQueue, reply_from_table,
                                           request_table, serve_forever)
from mmlspark_tpu_torch.io.transport import TransportConfig
from torch_parity import one_torch_thread  # noqa: F401 - fixture

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    """``{name: (port booster, reference booster, rows)}``, both CPU
    boosters loaded from the port's model text."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1200, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2]).astype(np.float64)
    reg = LightGBMRegressor(numIterations=12, numLeaves=15, verbosity=0,
                            device="cpu").fit({"features": X, "label": y})
    yc = rng.integers(0, 3, size=len(X)).astype(np.float64)
    mc = LightGBMClassifier(numIterations=6, numLeaves=7, verbosity=0,
                            device="cpu").fit({"features": X, "label": yc})
    out = {}
    for name, m in (("regression", reg), ("multiclass", mc)):
        text = m.getModel().save_native_model_string()
        out[name] = (Booster.load_native_model_string(text, device="cpu"),
                     RefBooster.load_native_model_string(text), X)
    return out


def _post(addr, payload, timeout=15.0):
    req = urllib.request.Request(
        addr, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _concurrent_posts(addr, rows, threads=8):
    results, errors = {}, []

    def client(ids):
        for i in ids:
            try:
                results[i] = _post(addr, {"features": rows[i].tolist()})
            except Exception as e:  # noqa: BLE001
                errors.append((i, repr(e)))

    ts = [threading.Thread(target=client,
                           args=(range(k, len(rows), threads),))
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errors, errors[:3]
    return [results[i] for i in range(len(rows))]


class FakeServer:
    """The exchange contract: a raw request queue and recorded replies."""

    def __init__(self, q=None):
        self.request_queue = q if q is not None else queue.Queue()
        self.replies = []
        self._lock = threading.Lock()

    def reply(self, rid, val, status=200):
        with self._lock:
            self.replies.append((rid, val, status))
        return True

    def by_rid(self):
        with self._lock:
            return {r[0]: r for r in self.replies}


def scorer(X):
    return X[:, 0] * 2.0 + X[:, 1]


def wait_replies(srv, n, timeout=10.0):
    deadline = time.time() + timeout
    while len(srv.replies) < n and time.time() < deadline:
        time.sleep(0.01)
    return len(srv.replies)


# -- parity with the reference ---------------------------------------------

@pytest.mark.parametrize("name", ["regression", "multiclass"])
def test_engine_replies_equal_the_reference(models, name):
    port_b, ref_b, X = models[name]
    rows = X[np.random.default_rng(7).choice(len(X), 96, replace=False)]
    replies = {}
    for key, srv_mod, eng_mod, b in (
            ("port", None, None, port_b),
            ("ref", rserving, rscoring, ref_b)):
        srv = (srv_mod.HTTPServer() if srv_mod else HTTPServer()).start()
        Eng = eng_mod.ScoringEngine if eng_mod else ScoringEngine
        eng = Eng(srv, predictor=b.predictor(), max_rows=16,
                  latency_budget_ms=2.0, num_scorers=2).start()
        try:
            replies[key] = _concurrent_posts(srv.address, rows)
        finally:
            eng.stop()
            srv.stop()
    assert replies["port"] == replies["ref"]
    want = port_b.predict_margin(rows).numpy()
    assert np.array_equal(np.asarray(replies["port"], np.float32), want)


def test_serve_forever_table_path_equals_the_reference(models):
    """``serve_forever`` with a transform: both packages' tables and
    replies agree."""
    port_b, ref_b, X = models["regression"]
    rows = X[:24]
    out = {}
    for key, mod, b in (("port", None, port_b), ("ref", rserving, ref_b)):
        Srv = mod.HTTPServer if mod else HTTPServer
        loop = mod.serve_forever if mod else serve_forever
        srv = Srv().start()
        stop = threading.Event()

        def xform(t, b=b):
            m = b.predict_margin(np.asarray(t["features"], np.float32))
            return t.withColumn("pred", np.asarray(m, np.float32))

        th = threading.Thread(target=loop, args=(srv, xform, "pred"),
                              kwargs={"stop_event": stop}, daemon=True)
        th.start()
        try:
            out[key] = _concurrent_posts(srv.address, rows, threads=4)
        finally:
            stop.set()
            th.join(10)
            srv.stop()
    assert out["port"] == out["ref"]


def test_request_table_and_reply_from_table_equal_the_reference():
    batch = [("a", {"features": [1.0, 2.0], "k": 1}),
             ("b", np.asarray([[3.0, 4.0]], np.float32)),
             ("c", wire.BinaryReq(np.asarray([[5.0, 6.0]], np.float32),
                                  1000.0))]
    rbatch = [batch[0], batch[1],
              ("c", rserving.wire.BinaryReq(batch[2][1].X, 1000.0))]
    t, rt = request_table(batch), rserving.request_table(rbatch)
    assert list(t["id"]) == list(rt["id"]) == ["a", "b", "c"]
    assert np.array_equal(np.asarray(t["features"], np.float32),
                          np.asarray(rt["features"], np.float32))
    got = []

    class Rec:
        def reply(self, rid, val, status=200):
            got.append((rid, val, status))
            return True

    reply_from_table(Rec(), t.withColumn("y", np.arange(3.0)), "y")
    want = []
    Rec.reply = lambda self, rid, val, status=200: want.append(
        (rid, val, status)) or True
    rserving.reply_from_table(Rec(), rt.withColumn("y", np.arange(3.0)),
                              "y")
    assert got == want


# -- the port's engine on tensors --------------------------------------------

def test_tensor_margins_one_host_copy_and_dispatch_timers(models):
    """A predictor returning a tensor (the card's walk returns a CUDA
    one): the engine brings each batch's margins over once and, with
    the profiler on, records both halves of the dispatch bracket."""
    from mmlspark_tpu_torch.core.profiler import get_profiler
    port_b, _, X = models["regression"]
    pred = port_b.predictor(backend="jit")
    assert pred.mode == "jit"
    copies = []

    class Counting:
        num_features = pred.num_features
        mode = "jit"

        def __call__(self, M):
            out = pred(M)
            assert isinstance(out, torch.Tensor)
            copies.append(out.shape[0])
            return out

    prof = get_profiler()
    was = prof.enabled
    prof.configure(enabled=True)
    try:
        srv = FakeServer()
        for i in range(20):
            srv.request_queue.put((f"r{i}", {"features": X[i].tolist()}))
        eng = ScoringEngine(srv, predictor=Counting(), max_rows=64,
                            latency_budget_ms=20.0).start()
        try:
            assert wait_replies(srv, 20) == 20
        finally:
            eng.stop()
        by = srv.by_rid()
        want = port_b.predict_margin(X[:20]).numpy()
        assert [by[f"r{i}"][1] for i in range(20)] == want.tolist()
        # padded to the bucket (the reference's batches), one call each
        assert all(n == next_pow2(n) for n in copies)
        st = eng.stats_snapshot()["stages"]
        assert st["dispatch_host"]["count"] == len(copies)
        assert st["device_wait"]["count"] == len(copies)
    finally:
        prof.configure(enabled=was)


def test_pad_buckets_follow_the_backend(models):
    port_b, _, _ = models["regression"]
    fake = FakeServer()
    assert ScoringEngine(fake, predictor=port_b.predictor(
        backend="native"))._pad_buckets is False
    assert ScoringEngine(fake, predictor=port_b.predictor(
        backend="jit"))._pad_buckets is True
    assert ScoringEngine(fake, predictor=lambda X: X[:, 0],
                         plan=ColumnPlan("features", 8))._pad_buckets
    assert ScoringEngine(fake, predictor=port_b.predictor(backend="jit"),
                         pad_buckets=False)._pad_buckets is False


def test_binary_wire_scores_match_json_wire(models):
    port_b, _, X = models["regression"]
    plan = ColumnPlan("features", X.shape[1])
    pred = port_b.predictor()
    rows = X[:32]
    Xj = plan.decode([{"features": r.tolist()} for r in rows])
    views = [wire.unpack_matrix(wire.pack_matrix(str(i), rows[i:i + 1]))[2]
             for i in range(32)]
    Xb = plan.decode(views)
    assert np.array_equal(Xj, Xb)
    assert np.array_equal(pred(Xj).numpy(), pred(Xb).numpy())
    assert np.array_equal(pred(Xj).numpy(),
                          port_b.predict_margin(rows).numpy())


def test_binary_reply_mode_keeps_numpy(models):
    port_b, _, X = models["regression"]

    class BinServer(FakeServer):
        binary_wire = True

    batch = [(str(i), {"features": X[i].tolist()}) for i in range(8)]
    pairs = ScoringEngine(BinServer(),
                          predictor=port_b.predictor())._score_predictor(
        batch)
    pairs2 = ScoringEngine(FakeServer(),
                           predictor=port_b.predictor())._score_predictor(
        batch)
    assert all(isinstance(v, np.floating) for _r, v in pairs)
    assert all(isinstance(v, float) for _r, v in pairs2)
    assert [float(v) for _r, v in pairs] == [v for _r, v in pairs2]


# -- ColumnPlan ----------------------------------------------------------------

class TestColumnPlan:
    def test_vector_and_scalar_plans(self):
        X = ColumnPlan("features", 3).decode(
            [{"features": [1, 2, 3]}, {"features": [4, 5, 6]}])
        assert X.dtype == np.float32 and X.flags["C_CONTIGUOUS"]
        assert X.shape == (2, 3)
        X = ColumnPlan(["a", "b"]).decode([{"a": 1, "b": 2, "junk": 9},
                                           {"a": 3, "b": 4}])
        assert X.tolist() == [[1.0, 2.0], [3.0, 4.0]]
        with pytest.raises(ValueError, match="features"):
            ColumnPlan("features", 4).decode([{"features": [1, 2]}])

    def test_decode_table_matches_decode(self):
        batch = [("a", {"features": [1.0, 2.0]}),
                 ("b", {"features": [3.0, 4.0]})]
        plan = ColumnPlan("features", 2)
        assert np.array_equal(plan.decode_table(request_table(batch)),
                              plan.decode([p for _, p in batch]))

    def test_binary_rows(self):
        plan = ColumnPlan("features", 4)
        row = np.arange(4, dtype=np.float32).reshape(1, 4)
        view = wire.unpack_matrix(wire.pack_matrix("r", row))[2]
        assert plan.decode([view]) is view          # zero copy
        rows = [np.full((1, 4), i, np.float32) for i in range(5)]
        rows[2] = wire.BinaryReq(rows[2], 1000.0)
        X = plan.decode(rows)
        assert X.shape == (5, 4)
        assert np.array_equal(X[:, 0], np.arange(5, dtype=np.float32))
        with pytest.raises(ValueError, match="expects"):
            plan.decode([np.ones((1, 2), np.float32)])


# -- batching ------------------------------------------------------------------

class TestBatching:
    def test_closes_on_latency_budget(self):
        srv = FakeServer()
        eng = ScoringEngine(srv, predictor=lambda X: X[:, 0],
                            plan=ColumnPlan("features", 2),
                            max_rows=1000, latency_budget_ms=40.0)
        for i in range(3):
            srv.request_queue.put((f"r{i}", {"features": [float(i), 0.0]}))
        t0 = time.perf_counter()
        eng.start()
        try:
            assert wait_replies(srv, 3) == 3
            assert time.perf_counter() - t0 < 2.0
            snap = eng.stats_snapshot()
            assert snap["rows"] == 3
            assert snap["stages"]["e2e"]["count"] == 1
        finally:
            eng.stop()

    def test_closes_on_max_rows(self):
        srv = FakeServer()
        eng = ScoringEngine(srv, predictor=lambda X: X[:, 0],
                            plan=ColumnPlan("features", 2),
                            max_rows=4, latency_budget_ms=10_000.0)
        for i in range(8):
            srv.request_queue.put((f"r{i}", {"features": [float(i), 0.0]}))
        eng.start()
        try:
            assert wait_replies(srv, 8) == 8
            assert eng.stats_snapshot()["stages"]["e2e"]["count"] == 2
        finally:
            eng.stop()

    def test_legacy_get_batch_only_server(self):
        class PullServer:
            def __init__(self):
                self._q = queue.Queue()
                self.replies = []

            def get_batch(self, max_rows=64, timeout=0.05):
                batch = []
                try:
                    batch.append(self._q.get(timeout=timeout))
                    while len(batch) < max_rows:
                        batch.append(self._q.get_nowait())
                except queue.Empty:
                    pass
                return batch

            def reply(self, rid, val, status=200):
                self.replies.append((rid, val, status))
                return True

        srv = PullServer()
        eng = ScoringEngine(srv, predictor=lambda X: X[:, 0] + 1,
                            plan=ColumnPlan("features", 2),
                            latency_budget_ms=5.0).start()
        try:
            srv._q.put(("a", {"features": [41.0, 0.0]}))
            deadline = time.time() + 5
            while not srv.replies and time.time() < deadline:
                time.sleep(0.01)
            assert srv.replies == [("a", pytest.approx(42.0), 200)]
        finally:
            eng.stop()


# -- resilience ----------------------------------------------------------------

class TestResilience:
    def test_malformed_rows_get_their_own_400(self):
        srv = FakeServer()
        eng = ScoringEngine(srv, predictor=lambda X: X[:, 0] * 10,
                            plan=ColumnPlan("features", 2),
                            max_rows=8, latency_budget_ms=30.0)
        srv.request_queue.put(("bad", {"features": [1.0]}))
        srv.request_queue.put(("nokey", {"wrong_key": 1}))
        srv.request_queue.put(("g1", {"features": [1.0, 0.0]}))
        srv.request_queue.put(("g2", {"features": [2.0, 0.0]}))
        eng.start()
        try:
            assert wait_replies(srv, 4) == 4
            by = srv.by_rid()
            assert by["bad"][2] == by["nokey"][2] == 400
            assert by["g1"][1:] == (pytest.approx(10.0), 200)
            assert by["g2"][1:] == (pytest.approx(20.0), 200)
        finally:
            eng.stop()

    def test_poison_row_fails_alone_after_salvage(self):
        def poisoned(X):
            if np.any(X[:, 0] == 666.0):
                raise RuntimeError("poison payload")
            return X[:, 0]

        srv = FakeServer()
        eng = ScoringEngine(srv, predictor=poisoned,
                            plan=ColumnPlan("features", 2), max_rows=8,
                            latency_budget_ms=30.0, pad_buckets=False)
        for rid, v in (("g1", 1.0), ("bad", 666.0), ("g2", 2.0)):
            srv.request_queue.put((rid, {"features": [v, 0.0]}))
        eng.start()
        try:
            assert wait_replies(srv, 3) == 3
            by = srv.by_rid()
            assert by["bad"][2] == 500
            assert by["g1"][1] == pytest.approx(1.0)
            assert by["g2"][1] == pytest.approx(2.0)
            assert eng.stats_snapshot()["counters"]["salvaged"] == 2
        finally:
            eng.stop()

    def test_worker_kill_restarts_and_salvages(self):
        plan = ChaosPlan(seed=11)
        pred = ChaosPredictor(scorer, plan, kill_on_calls={1})
        srv = FakeServer()
        X = np.arange(24, dtype=np.float32).reshape(12, 2)
        for i in range(12):
            srv.request_queue.put((f"r{i}", {"features": X[i].tolist()}))
        eng = ScoringEngine(srv, predictor=pred,
                            plan=ColumnPlan("features", 2), max_rows=64,
                            latency_budget_ms=20.0).start()
        try:
            assert wait_replies(srv, 12) == 12
            want = scorer(X)
            by = srv.by_rid()
            for i in range(12):
                assert by[f"r{i}"][1:] == (pytest.approx(float(want[i])),
                                           200)
            c = eng.stats_snapshot()["counters"]
            assert c["restarted"] >= 1 and c["salvaged"] == 12
            assert pred.kills == 1
            srv.request_queue.put(("post", {"features": [5.0, 1.0]}))
            assert wait_replies(srv, 13) == 13
            assert len(srv.replies) == 13
            assert srv.by_rid()["post"][1] == pytest.approx(11.0)
            assert eng.is_ready()
        finally:
            eng.stop()
        assert issubclass(WorkerKilled, BaseException)
        assert not issubclass(WorkerKilled, Exception)

    def test_predictor_faults_zero_wrong_answers(self):
        plan = ChaosPlan(seed=5)
        pred = ChaosPredictor(scorer, plan, exc_rate=0.3)
        srv = FakeServer()
        eng = ScoringEngine(srv, predictor=pred,
                            plan=ColumnPlan("features", 2), max_rows=8,
                            latency_budget_ms=2.0).start()
        X = np.arange(120, dtype=np.float32).reshape(60, 2)
        try:
            for i in range(60):
                srv.request_queue.put((f"r{i}",
                                       {"features": X[i].tolist()}))
                if i % 7 == 0:
                    time.sleep(0.002)
            assert wait_replies(srv, 60) == 60
            want = scorer(X)
            by = srv.by_rid()
            assert {s for _, _, s in srv.replies} <= {200, 500}
            for i in range(60):
                if by[f"r{i}"][2] == 200:
                    assert by[f"r{i}"][1] == pytest.approx(float(want[i]))
                else:
                    assert by[f"r{i}"][1] == {"error": "scoring failed"}
            assert eng.stats_snapshot()["counters"]["salvaged"] > 0
        finally:
            eng.stop()

    def test_shed_under_burst(self):
        def slow(X):
            time.sleep(0.02)
            return scorer(X)

        srv = FakeServer()
        X = np.arange(80, dtype=np.float32).reshape(40, 2)
        for i in range(40):
            srv.request_queue.put((f"r{i}", {"features": X[i].tolist()}))
        eng = ScoringEngine(srv, predictor=slow,
                            plan=ColumnPlan("features", 2), max_rows=4,
                            latency_budget_ms=1.0, max_queue_depth=4,
                            num_scorers=2).start()
        try:
            assert wait_replies(srv, 40) == 40
            by = srv.by_rid()
            assert len(by) == 40
            want = scorer(X)
            shed = 0
            for i in range(40):
                _rid, val, status = by[f"r{i}"]
                if status == 503:
                    shed += 1
                    assert val == {"error": "shed"}
                else:
                    assert val == pytest.approx(float(want[i]))
            assert shed > 0
            assert eng.stats_snapshot()["counters"]["shed"] == shed
        finally:
            eng.stop()

    def test_expired_requests_are_never_scored(self):
        calls = []

        def counting(X):
            calls.append(len(X))
            return scorer(X)

        srv = FakeServer()
        old = time.perf_counter() - 10.0
        for i in range(4):
            srv.request_queue.put((f"stale{i}", {"features": [1.0, 0.0]},
                                   old))
        eng = ScoringEngine(srv, predictor=counting,
                            plan=ColumnPlan("features", 2),
                            deadline_ms=1000.0,
                            latency_budget_ms=5.0).start()
        try:
            assert wait_replies(srv, 4) == 4
            assert all(s == 504 and v == {"error": "expired"}
                       for _, v, s in srv.replies)
            assert calls == []
            assert eng.stats_snapshot()["counters"]["expired"] == 4
            srv.request_queue.put(("fresh", {"features": [3.0, 1.0]}))
            srv.request_queue.put(("custom", {"features": [1.0, 1.0],
                                              "_deadline_ms": 0.001},
                                   time.perf_counter() - 0.5))
            assert wait_replies(srv, 6) == 6
            by = srv.by_rid()
            assert by["fresh"][1] == pytest.approx(7.0)
            assert by["custom"][2] == 504
        finally:
            eng.stop()

    def test_queue_stalls_only_delay(self):
        plan = ChaosPlan(seed=9)
        srv = FakeServer(ChaosQueue(queue.Queue(), plan, stall_rate=0.5,
                                    stall_s=0.005))
        eng = ScoringEngine(srv, predictor=scorer,
                            plan=ColumnPlan("features", 2),
                            latency_budget_ms=2.0).start()
        try:
            X = np.arange(40, dtype=np.float32).reshape(20, 2)
            for i in range(20):
                srv.request_queue.put((f"r{i}",
                                       {"features": X[i].tolist()}))
            assert wait_replies(srv, 20) == 20
            by = srv.by_rid()
            want = scorer(X)
            for i in range(20):
                assert by[f"r{i}"][1] == pytest.approx(float(want[i]))
            assert plan.counts()["queue"]["fired"] > 0
        finally:
            eng.stop()

    def test_stop_drain_answers_queued_work(self):
        srv = FakeServer()
        eng = ScoringEngine(srv, predictor=scorer,
                            plan=ColumnPlan("features", 2), max_rows=4,
                            latency_budget_ms=1.0).start()
        for i in range(30):
            srv.request_queue.put((f"r{i}", {"features": [float(i), 0.0]}))
        eng.stop(drain=True, drain_timeout=10.0)
        assert len(srv.replies) == 30
        assert srv.request_queue.qsize() == 0
        assert not eng.is_ready()

    def test_tracked_queue_and_exchange_sweep(self):
        q = _TrackedQueue()
        assert q.put_unique(("a", {"x": 1}, 0.0)) is True
        assert q.put_unique(("a", {"x": 1}, 0.0)) is False
        assert q.get()[0] == "a"
        assert q.put_unique(("a", {"x": 1}, 0.0)) is True
        ex = _Exchange(reply_timeout=0.01, sweep_grace=0.0)
        rid, _ = ex.park({"x": 1})
        time.sleep(0.05)
        for _ in range(ex._SWEEP_EVERY):
            r2, _p = ex.park({"x": 2})
            ex.unpark(r2)
        assert rid not in ex.pending
        assert ex.reply(rid, {"y": 9}) is False


# -- the HTTP edge -------------------------------------------------------------

def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_health_metrics_and_status_routes():
    srv = HTTPServer().start()
    try:
        assert _get(srv.address + "/healthz") == (200, b'{"status": "ok"}')
        code, body = _get(srv.address + "/readyz")
        assert (code, json.loads(body)) == (503, {"ready": False})
        eng = ScoringEngine(srv, predictor=scorer,
                            plan=ColumnPlan("features", 2)).start()
        try:
            code, body = _get(srv.address + "/readyz")
            assert (code, json.loads(body)) == (200, {"ready": True})
            assert _post(srv.address, {"features": [2.0, 1.0]}) \
                == pytest.approx(5.0)
            code, text = _get(srv.address + "/metrics")
            assert code == 200 and b'ns="scoring"' in text
            code, status = _get(srv.address + "/statusz")
            assert code == 200 and status
        finally:
            eng.stop()
        code, body = _get(srv.address + "/readyz")
        assert (code, json.loads(body)) == (503, {"ready": False})
    finally:
        srv.stop()


def test_slow_and_resetting_clients_do_not_kill_the_server():
    plan = ChaosPlan(seed=23)
    srv = HTTPServer(request_read_timeout=0.5).start()
    eng = ScoringEngine(srv, predictor=scorer,
                        plan=ColumnPlan("features", 2),
                        latency_budget_ms=2.0).start()
    payload = json.dumps({"features": [1.0, 1.0]}).encode()
    raw = (b"POST / HTTP/1.1\r\nHost: x\r\n"
           b"Content-Type: application/json\r\n"
           b"Content-Length: %d\r\n\r\n%s" % (len(payload), payload))
    try:
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        t0 = time.perf_counter()
        s.sendall(b"POST / HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 100\r\n\r\n")     # body never sent
        s.settimeout(5.0)
        assert s.recv(4096) == b""
        assert time.perf_counter() - t0 < 4.0
        s.close()
        for i in range(12):
            base = socket.create_connection((srv.host, srv.port),
                                            timeout=5)
            cs = ChaosSocket(base, plan, reset_rate=0.3, partial_rate=0.3,
                             slow_rate=0.2, slow_s=0.01, name=f"c{i}")
            try:
                cs.sendall(raw)
                base.settimeout(5.0)
                base.recv(4096)
            except OSError:
                pass
            finally:
                try:
                    base.close()
                except OSError:
                    pass
        assert any(c["fired"] > 0 for c in plan.counts().values())
        assert _post(srv.address, {"features": [4.0, 2.0]}) \
            == pytest.approx(10.0)
    finally:
        eng.stop()
        srv.stop()


def test_distributed_server_routes_across_workers():
    srv = DistributedHTTPServer(num_workers=3, reply_timeout=30.0).start()
    try:
        results, threads = {}, []
        for i, addr in enumerate(srv.addresses):
            t = threading.Thread(target=lambda i=i, a=addr: results.
                                 __setitem__(i, _post(a, {"x": i})))
            t.start()
            threads.append(t)
        batch = []
        for _ in range(100):
            batch += srv.get_batch(max_rows=8, timeout=0.1)
            if len(batch) == 3:
                break
        assert len(batch) == 3
        for rid, payload in batch:
            assert srv.reply(rid, {"y": payload["x"] * 2})
        for t in threads:
            t.join(10)
        assert results == {i: {"y": 2 * i} for i in range(3)}
    finally:
        srv.stop()


def test_reply_timeout_gives_504_and_late_reply_is_dropped():
    srv = HTTPServer(reply_timeout=0.3).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.address, {"x": 1}, timeout=10)
        assert e.value.code == 504
        batch = srv.get_batch(max_rows=4, timeout=0.5)
        assert len(batch) == 1
        assert srv.reply(batch[0][0], {"late": True}) is False
    finally:
        srv.stop()


def test_exchange_soak_with_link_kills(models):
    """Scoring traffic over the multiprocess exchange (its worker as a
    thread) while ChaosTransport kills the link at seeded sends: every
    request is answered once, with its own row's margin."""
    port_b, _, X = models["regression"]
    plan = ChaosPlan(seed=4242)
    conn_n = [0]

    def wrap(sock):
        conn_n[0] += 1
        if conn_n[0] <= 3:
            return ChaosTransport(sock, plan, kill_on_sends={20},
                                  name=f"xlink{conn_n[0]}")
        return sock

    srv = MultiprocessHTTPServer(
        num_workers=1, spawn_workers=False, join_timeout=20.0,
        reply_timeout=10.0, ack_grace=3.0, reconnect_backoff=(0.05, 0.3),
        transport_config=TransportConfig(socket_wrap=wrap))
    h, p = srv._ts.address
    worker = threading.Thread(
        target=_mp_worker_main,
        args=(h, p, 0, "127.0.0.1", "/", 10.0, srv.token),
        kwargs={"reconnect_tries": 8, "reconnect_backoff": (0.05, 0.3)},
        daemon=True)
    worker.start()
    srv.start()
    eng = ScoringEngine(srv, predictor=port_b.predictor(), max_rows=8,
                        latency_budget_ms=2.0, num_scorers=2).start()
    try:
        got = _concurrent_posts(srv.addresses[0], X[:60], threads=12)
        assert conn_n[0] > 1
        assert np.array_equal(np.asarray(got, np.float32),
                              port_b.predict_margin(X[:60]).numpy())
    finally:
        eng.stop()
        srv.stop()
        worker.join(10)
    assert not worker.is_alive()


def test_importing_the_serving_plane_touches_no_card_and_no_jax():
    """``mmlspark_tpu_torch.io`` imports without initialising CUDA (its
    spawned workers only park sockets) and without JAX or the reference,
    and exports the reference's public names for its modules."""
    import subprocess
    import sys
    code = ("import sys, torch\n"
            "import mmlspark_tpu_torch.io as io\n"
            "print(torch.cuda.is_initialized())\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'mmlspark_tpu')))\n"
            "print(sorted(io.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    cuda, leaked, names = out.stdout.splitlines()[:3]
    assert cuda == "False" and leaked == "[]"
    import mmlspark_tpu.io as rio
    modules = ("serving", "scoring", "chaos", "transport", "wire", "fleet",
               "binary", "registry", "rollout", "ingest", "refresh")
    # and ChaosDrift, which the reference's chaos module holds and its
    # package does not export
    want = sorted([n for n in rio.__all__
                   if getattr(rio, n).__module__.rsplit(".", 1)[-1]
                   in modules] + ["ChaosDrift"])
    assert names == str(want)
