"""The port's model lifecycle, serving half (``mmlspark_tpu_torch.io``
``registry`` / ``rollout`` and ``chaos.ChaosDrift``) against the JAX
package's, on the CPU.

* Registry: the same publishes write the same bytes (model files, their
  digest headers, the profile files, the manifest's entries but their
  clocks); a port registry loads the reference's version and back, to
  margins equal bit for bit; a corrupted file raises
  ``ModelCorruption``, is quarantined and never activates; prune keeps
  the active, candidate and quarantined entries, as the reference's
  does; ``load`` takes its device, ``"cuda"`` by default.
* Rollout: rid routing sends the same rows to the same arm as the
  reference's; a canary's margins equal the reference's bit for bit;
  with ``ChaosPredictor`` errors in the canary, the gate gives the
  reference's verdicts (rollback, promote) on the same stream with the
  same counters; the holdout gauge equals the reference's; an arm whose
  predictor returns tensors (as the card's walk does) is brought to the
  host in one copy; behind a ``ScoringEngine`` every reply is its pinned
  arm's margin.
* ``ChaosDrift``: the step, NaN and ramp streams equal the reference's
  for the same seed, whatever the batch boundaries.

The models are fitted once by the port (600 × 6, 6 and 10 iterations);
each package loads their text.  Every comparison is exact.
"""

import inspect
import json
import os
import queue
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.io import chaos as rchaos
from mmlspark_tpu.io import registry as rregistry
from mmlspark_tpu.io import rollout as rrollout
from mmlspark_tpu_torch import LightGBMRegressor
from mmlspark_tpu_torch.io import ChaosDrift, RefreshController
from mmlspark_tpu_torch.io.chaos import (ChaosPlan, ChaosPredictor,
                                         corrupt_file)
from mmlspark_tpu_torch.io.registry import (ModelCorruption, ModelRegistry,
                                            RegistryError)
from mmlspark_tpu_torch.io.rollout import RolloutConfig, RolloutController
from mmlspark_tpu_torch.io.scoring import ScoringEngine
from torch_parity import one_torch_thread, reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    """Two model generations as native-model text, their rows, margins
    and the first model's reference-profile JSON."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]).astype(np.float64)
    fits = [LightGBMRegressor(numIterations=it, numLeaves=leaves,
                              parallelism="serial", verbosity=0,
                              device="cpu").fit({"features": X, "label": y})
            .getModel() for it, leaves in ((6, 7), (10, 15))]
    w = [b.predict_margin(X).numpy() for b in fits]
    assert not np.array_equal(w[0], w[1])
    return {"t1": fits[0].save_native_model_string(),
            "t2": fits[1].save_native_model_string(), "X": X,
            "w1": w[0], "w2": w[1],
            "profile": fits[0].reference_profile.to_json()}


def _registries(tmp_path, models):
    """The same publishes in each package: v1 active (with the profile),
    v2 a candidate."""
    out = []
    for mod, name in ((ModelRegistry, "port"),
                      (rregistry.ModelRegistry, "ref")):
        reg = mod(str(tmp_path / name))
        reg.publish(models["t1"], activate=True, profile=models["profile"],
                    meta={"note": "base"})
        reg.publish(models["t2"])
        out.append(reg)
    return out


# -- the registry --------------------------------------------------------------

def test_published_files_equal_the_reference(tmp_path, models):
    port, ref = _registries(tmp_path, models)
    for v in (1, 2):
        with open(port.model_path(v), "rb") as a, \
                open(ref.model_path(v), "rb") as b:
            assert a.read() == b.read()
    with open(port.profile_path(1), "rb") as a, \
            open(ref.profile_path(1), "rb") as b:
        assert a.read() == b.read()

    def entries(reg):
        with open(os.path.join(reg.root, "manifest.json")) as fh:
            m = json.load(fh)
        for e in m["entries"].values():
            for clock in ("created", "promoted_at"):
                e.pop(clock, None)
        return m

    assert entries(port) == entries(ref)
    assert port.read_text(2) == ref.read_text(2)
    assert port.candidates() == ref.candidates() == [2]


def test_each_package_loads_the_others_versions(tmp_path, models,
                                                reference_native):
    port, ref = _registries(tmp_path, models)
    X = models["X"]
    # the port reads the reference's root, the reference the port's
    b = ModelRegistry(ref.root).load(device="cpu")
    assert b.device == "cpu" and b.reference_profile is not None
    assert np.array_equal(b.predict_margin(X).numpy(), models["w1"])
    rb = rregistry.ModelRegistry(port.root).load(2)
    assert np.array_equal(np.asarray(rb.predict_margin(X), np.float32),
                          models["w2"])


def test_loads_take_their_device_cuda_by_default():
    for fn in (ModelRegistry.load, RolloutController.__init__,
               RefreshController.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("mode", ["bitflip", "torn"])
def test_a_corrupted_version_is_quarantined(tmp_path, models, mode):
    port, ref = _registries(tmp_path, models)
    for reg, exc in ((port, ModelCorruption),
                     (ref, rregistry.ModelCorruption)):
        corrupt_file(reg.model_path(2), ChaosPlan(3), mode=mode)
        assert not reg.verify(2)
        with pytest.raises(exc):
            reg.read_text(2)
        assert reg.entry(2)["promoted_state"] == "quarantined"
    with pytest.raises(ModelCorruption):
        port.load(2, device="cpu")
    with pytest.raises(RegistryError, match="quarantined"):
        port.activate(2)
    assert port.active_version() == 1


def test_prune_keeps_active_candidate_and_quarantined(tmp_path, models):
    """One sequence of publishes, promotions, a rollback, a quarantine
    and prunes in each package: the same pruned versions, the same
    states, the same files left."""
    out = []
    for mod, name in ((ModelRegistry, "port"),
                      (rregistry.ModelRegistry, "ref")):
        reg = mod(str(tmp_path / name))
        for _ in range(5):
            reg.publish(models["t1"], activate=True)
        reg.rollback()                            # v5 rolled back, v4 on
        reg.quarantine(2)
        cand = reg.publish(models["t2"])
        pruned = [reg.prune(keep_last=1), reg.prune(keep_last=0),
                  reg.prune(keep_last=0)]
        states = {v: e["promoted_state"] for v, e in reg.entries().items()}
        files = sorted(os.listdir(os.path.join(reg.root, "models")))
        out.append((pruned, states, files, cand, reg.active_version()))
    assert out[0] == out[1]
    pruned, states, _, cand, active = out[0]
    assert states == {2: "quarantined", 4: "active", cand: "candidate"}
    assert pruned[-1] == [] and active == 4
    with pytest.raises(RegistryError):
        ModelRegistry(str(tmp_path / "port")).prune(keep_last=-1)


# -- the rollout ---------------------------------------------------------------

def _controllers(tmp_path, models, **cfg):
    """A controller of each package over the same registries (CPU
    boosters, their native scorers)."""
    port, ref = _registries(tmp_path, models)
    kw = dict(canary_fraction=0.4, soak_s=0.0, min_canary_rows=20,
              canary_deadline_ms=None, fast_window_s=5.0,
              slow_window_s=10.0, retire_grace_s=0.5)
    kw.update(cfg)
    pc = RolloutController(port, config=RolloutConfig(**kw), device="cpu")
    rc = rrollout.RolloutController(ref,
                                    config=rrollout.RolloutConfig(**kw))
    return port, ref, pc, rc


def test_rid_routing_equals_the_reference(tmp_path, models,
                                          reference_native):
    _, _, pc, rc = _controllers(tmp_path, models)
    rids = [f"req-{i}" for i in range(2000)]
    for frac, salt in ((0.05, "2"), (0.4, "2"), (0.4, "3")):
        got = [pc.arm_for(r, frac, salt) for r in rids]
        assert got == [rc.arm_for(r, frac, salt) for r in rids]
        share = got.count("canary") / len(rids)
        assert abs(share - frac) < 0.05
    assert pc.arm_for("x") == "baseline"          # no canary in flight
    pc.start_canary(2)
    rc.start_canary(2)
    assert [pc.arm_for(r) for r in rids] == [rc.arm_for(r) for r in rids]


def test_canary_margins_equal_the_reference(tmp_path, models,
                                            reference_native):
    port, ref, pc, rc = _controllers(tmp_path, models)
    X = models["X"]
    rids = [f"r{i}" for i in range(len(X))]
    assert pc.start_canary() == rc.start_canary() == 2
    for lo, hi in ((0, 1), (0, 37), (37, 300), (0, len(X))):
        got = pc.score_routed(X[lo:hi], rids[lo:hi])
        want = rc.score_routed(X[lo:hi], rids[lo:hi])
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        arms = np.array([pc.arm_for(r) == "canary" for r in rids[lo:hi]])
        assert np.array_equal(got, np.where(arms, models["w2"][lo:hi],
                                            models["w1"][lo:hi]))
    for k in ("baseline_rows", "canary_rows"):
        assert pc.stats.counter(k) == rc.stats.counter(k)
    assert np.array_equal(pc(X[:10]), models["w1"][:10])


@pytest.mark.parametrize("exc_rate,min_rows,verdict", [
    (0.5, 10 ** 9, "rolled_back"),     # errors burn the gate
    (0.0, 100, "promoted"),            # a clean canary soaks and promotes
])
def test_gate_verdicts_equal_the_reference(tmp_path, models,
                                           reference_native, exc_rate,
                                           min_rows, verdict):
    """The same stream of routed batches through each package's
    controller, canary wrapped in a ``ChaosPredictor`` of one seed: the
    same ticks, counters, replies (every one the baseline's or the
    canary's answer, errors rescued on the baseline) and registry
    states."""
    X = models["X"]
    port, ref, pc, rc = _controllers(tmp_path, models,
                                     min_canary_rows=min_rows)
    pc.canary_wrap = lambda p: ChaosPredictor(p, ChaosPlan(11),
                                              exc_rate=exc_rate,
                                              name="canary")
    rc.canary_wrap = lambda p: rchaos.ChaosPredictor(
        p, rchaos.ChaosPlan(11), exc_rate=exc_rate, name="canary")
    runs = []
    for ctl, reg in ((pc, port), (rc, ref)):
        ctl.start_canary(2)
        ticks, outs = [], []
        for b in range(6):
            rows = slice(b * 64, (b + 1) * 64)
            outs.append(ctl.score_routed(
                X[rows], [f"q{b}_{i}" for i in range(64)]))
            ticks.append(ctl.tick())
            if ticks[-1] != "soaking":
                break
        runs.append((ticks, np.concatenate(outs),
                     {k: ctl.stats.counter(k) for k in (
                         "canary_rows", "canary_errors",
                         "canary_fallback_rows", "promotions",
                         "rollbacks")},
                     reg.entry(2)["promoted_state"], reg.active_version()))
    (ticks, out, counters, state, active), want = runs[0], runs[1]
    assert ticks == want[0] and np.array_equal(out, want[1])
    assert (counters, state, active) == want[2:]
    assert ticks[-1] == verdict
    n = len(out)
    assert np.all((out == models["w1"][:n]) | (out == models["w2"][:n]))
    if verdict == "rolled_back":
        assert counters["canary_errors"] > 0 and state == "rolled_back"
        assert active == 1 and pc.state() == "steady"
    else:
        assert counters["canary_errors"] == 0 and active == 2
        assert np.array_equal(pc(X[:5]), models["w2"][:5])


def test_holdout_drift_gauge_equals_the_reference(tmp_path, models,
                                                  reference_native):
    _, _, pc, rc = _controllers(tmp_path, models,
                                holdout_drift_threshold=1e9)
    for ctl in (pc, rc):
        ctl.set_holdout(models["X"][:64])
        ctl.start_canary(2)
        ctl.tick()
    got = pc.stats.gauge("canary_holdout_drift")
    assert got == rc.stats.gauge("canary_holdout_drift")
    assert got == pytest.approx(float(np.mean(np.abs(
        models["w2"][:64] - models["w1"][:64]))), rel=1e-6)


def test_tensor_arms_come_to_the_host_in_one_copy(tmp_path, models,
                                                  monkeypatch):
    """An arm whose predictor returns a tensor, as a card booster's walk
    does: each sub-batch is sliced and copied to the host once, and the
    routed margins are the arms' own."""
    _, _, pc, _ = _controllers(tmp_path, models)
    pc.start_canary(2)
    copies = []
    real_cpu = torch.Tensor.cpu

    def counted(t, *a, **k):
        copies.append(t.shape)
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    arms = pc._arms

    class AsTensor:
        def __init__(self, pred):
            self.pred = pred
            self.mode = "jit"

        def __call__(self, X):
            return torch.from_numpy(np.asarray(self.pred(X)))

    monkeypatch.setattr(arms, "baseline", AsTensor(arms.baseline))
    monkeypatch.setattr(arms, "canary", AsTensor(arms.canary))
    X = models["X"][:100]
    rids = [f"t{i}" for i in range(100)]
    got = pc.score_routed(X, rids)
    canary = np.array([pc.arm_for(r) == "canary" for r in rids])
    assert np.array_equal(got, np.where(canary, models["w2"][:100],
                                        models["w1"][:100]))
    assert sorted(s[0] for s in copies) == sorted(
        [int(canary.sum()), int((~canary).sum())])


class _Server:
    """The exchange contract: a request queue and recorded replies."""

    binary_wire = False

    def __init__(self):
        self.request_queue = queue.Queue()
        self.replies = {}
        self._lock = threading.Lock()

    def reply(self, rid, val, status=200):
        with self._lock:
            self.replies[rid] = (val, status)
        return True


def test_engine_replies_are_each_rows_pinned_arm(tmp_path, models):
    _, _, pc, _ = _controllers(tmp_path, models)
    srv = _Server()
    eng = ScoringEngine(srv, predictor=pc, max_rows=16,
                        latency_budget_ms=2.0, num_scorers=2,
                        num_repliers=0).start()
    X = models["X"]
    try:
        pc.start_canary(2)
        for k in range(120):
            srv.request_queue.put((f"e{k}", {"features": X[k].tolist()},
                                   time.perf_counter()))
        deadline = time.monotonic() + 20
        while len(srv.replies) < 120 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pc.tick() == "promoted"
    finally:
        eng.stop()
    assert len(srv.replies) == 120
    for k in range(120):
        val, status = srv.replies[f"e{k}"]
        want = models["w2"] if pc.arm_for(f"e{k}", 0.4, "2") == "canary" \
            else models["w1"]
        assert status == 200 and np.float32(val) == want[k]


# -- ChaosDrift ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(feature=1, shift=10.0, after_rows=25),
    dict(feature=0, scale=2.0, shift=-1.0, nan_rate=0.5, after_rows=40),
    dict(feature=2, shift=3.0, scale=1.5, after_rows=30, ramp_rows=120),
    dict(feature=0, shift=4.0, nan_rate=0.2, ramp_rows=60),
])
def test_chaos_drift_streams_equal_the_reference(kw):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    port = ChaosDrift(ChaosPlan(seed=9), **kw)
    ref = rchaos.ChaosDrift(rchaos.ChaosPlan(seed=9), **kw)
    one = ref(X)
    parts = [port(X[i:i + 23]) for i in range(0, 300, 23)]
    np.testing.assert_array_equal(np.concatenate(parts), one)
    assert (port.rows_seen, port.rows_injected, port.nans_injected) == \
        (ref.rows_seen, ref.rows_injected, ref.nans_injected)
    assert np.isfinite(X).all()                   # the input is untouched
    # a single row keeps its shape
    assert ChaosDrift(ChaosPlan(1), feature=0, shift=1.0)(X[0]).shape == \
        X[0].shape
