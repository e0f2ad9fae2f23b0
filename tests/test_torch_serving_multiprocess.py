"""The port's ``MultiprocessHTTPServer`` on the CPU: two spawned worker
processes (which park sockets and forward over the transport, and never
touch a CUDA device) in front of the port's ``ScoringEngine`` on a CPU
booster; and the exchange's raw-float32 wire driven as the reference's
``tools/bench_serving.py`` drives it.

* Concurrent one-row JSON requests through both workers get their own
  row's margin, equal to ``predict_margin`` bit for bit; no worker died.
* ``/metrics`` on a worker fans in the driver's and the workers' stats.
* A SIGKILLed worker is respawned by the supervisor and the service
  answers again through its slot.
* The binary wire: a client holding the worker slot parks packed float32
  rows (``wire.pack_matrix``) and gets raw-float32 reply blocks equal to
  the JSON wire's values and to ``predict_margin`` bit for bit.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from mmlspark_tpu_torch import LightGBMRegressor
from mmlspark_tpu_torch.io import wire
from mmlspark_tpu_torch.io.chaos import kill_process
from mmlspark_tpu_torch.io.scoring import ScoringEngine
from mmlspark_tpu_torch.io.serving import MultiprocessHTTPServer
from mmlspark_tpu_torch.io.transport import (CH_CONTROL, CH_SCORING,
                                             TransportClient,
                                             TransportConfig)
from torch_parity import one_torch_thread  # noqa: F401 - fixture

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1200, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2]).astype(np.float64)
    b = LightGBMRegressor(numIterations=12, numLeaves=15, verbosity=0,
                          device="cpu").fit({"features": X, "label": y})
    return b.getModel(), X


def _post(addr, payload, timeout=20.0):
    req = urllib.request.Request(
        addr, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _posts(addrs, rows, threads=8):
    out, errors = {}, []

    def client(k):
        for i in range(k, len(rows), threads):
            try:
                out[i] = _post(addrs[i % len(addrs)],
                               {"features": rows[i].tolist()})
            except Exception as e:  # noqa: BLE001
                errors.append((i, repr(e)))

    ts = [threading.Thread(target=client, args=(k,))
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errors, errors[:3]
    return np.asarray([out[i] for i in range(len(rows))], np.float32)


def test_spawned_workers_serve_the_engine(model):
    b, X = model
    srv = MultiprocessHTTPServer(num_workers=2).start()
    eng = ScoringEngine(srv, predictor=b.predictor(), max_rows=32,
                        latency_budget_ms=2.0, num_scorers=2).start()
    try:
        rows = X[:80]
        got = _posts(srv.addresses, rows)
        assert np.array_equal(got, b.predict_margin(rows).numpy())
        assert srv.counters["worker_deaths"] == 0
        url = srv.addresses[1].rstrip("/") + "/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode()
        assert 'ns="scoring"' in text and "worker_up" in text
        # a killed worker is respawned and its slot serves again
        kill_process(srv._procs[0])
        deadline = time.time() + 60
        while srv.counters["worker_respawns"] < 1 \
                and time.time() < deadline:
            time.sleep(0.1)
        assert srv.counters["worker_respawns"] >= 1
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                v = _post(srv.addresses[0],
                          {"features": X[5].tolist()}, timeout=5)
                break
            except OSError:
                time.sleep(0.2)
        assert np.float32(v) == b.predict_margin(X[5:6]).numpy()[0]
    finally:
        eng.stop()
        srv.stop()


class _WireClient:
    """Holds worker slot 0 of a ``MultiprocessHTTPServer`` built with
    ``spawn_workers=False`` and parks rows straight on the exchange:
    packed float32 blocks on the binary wire, ``op=park`` JSON frames
    otherwise."""

    def __init__(self, srv, binary):
        self.binary = binary
        self.got = {}
        self.cv = threading.Condition()
        holder = {}

        def on_msg(session, channel, msg, dl):
            if isinstance(msg, (bytes, memoryview)):
                entries = wire.unpack_replies(msg)
            elif isinstance(msg, dict) and msg.get("op") == "reply":
                entries = [(msg["rid"], msg["response"])]
            else:
                return
            with self.cv:
                for rid, v in entries:
                    self.got[rid] = v
                self.cv.notify_all()
            rids = [rid for rid, _ in entries]
            self.client.send(CH_SCORING, {"op": "ack_many", "rids": rids,
                                          "delivered": [True] * len(rids)},
                             timeout=2.0)

        def dial():
            h, p = srv._ts.address
            c = TransportClient((h, p), token=srv.token,
                                cfg=TransportConfig(offer_binary=binary),
                                on_message=on_msg, name="wire-client")
            for _ in range(200):
                try:
                    c.connect(retries=0)
                    break
                except OSError:
                    time.sleep(0.05)
            c.send(CH_CONTROL, {"op": "hello", "worker": 0,
                                "host": "127.0.0.1", "port": 1})
            holder["c"] = c

        t = threading.Thread(target=dial, daemon=True)
        t.start()
        srv.start()
        t.join(20)
        self.client = holder["c"]
        assert self.client.session.peer_binary == binary

    def score(self, rows):
        for i, r in enumerate(rows):
            rid = f"w{i}"
            if self.binary:
                self.client.send_bytes(CH_SCORING,
                                       wire.pack_matrix(rid, r[None]))
            else:
                self.client.send(CH_SCORING, {
                    "op": "park", "rid": rid,
                    "payload": {"features": r.tolist()}})
        with self.cv:
            self.cv.wait_for(lambda: len(self.got) == len(rows), 30)
        return np.asarray([np.asarray(self.got[f"w{i}"],
                                      np.float32).reshape(())
                           for i in range(len(rows))])


def test_binary_wire_replies_equal_json_wire(model):
    b, X = model
    rows = X[100:164]
    out = {}
    for binary in (True, False):
        srv = MultiprocessHTTPServer(num_workers=1, spawn_workers=False,
                                     join_timeout=20.0)
        cl = _WireClient(srv, binary)
        eng = ScoringEngine(srv, predictor=b.predictor(), max_rows=16,
                            latency_budget_ms=2.0).start()
        try:
            out[binary] = cl.score(rows)
        finally:
            eng.stop()
            cl.client.close()
            srv.stop()
    want = b.predict_margin(rows).numpy()
    assert np.array_equal(out[True], want)
    assert np.array_equal(out[False], want)
