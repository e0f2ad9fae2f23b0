"""The port's model lifecycle, training half (``mmlspark_tpu_torch.io``
``ingest`` / ``refresh``) and its drills, against the JAX package's, on
the CPU.

* Ingest: the same appends write the same bytes in each package (meta,
  ``mapper.json``, every segment, a compaction's snapshot) and keep the
  same window and reservoir; replay after a kill is exact; batch
  boundaries change nothing; a gapped replay and a wrong mapper are
  refused; the scoring engine's tap feeds it.
* Refresh: a drifting feed triggers an episode in each package whose
  merged model text is the same bytes (both fits pinned to
  ``"segment"``); a trainer process SIGKILLed mid-fit resumes to the
  text an uninterrupted fit writes; a failing fit backs off, gives up,
  and resets under a cooldown; a starved trigger waits for rows.
* The drills: ``chaos_drift`` and ``chaos_online`` on ``--device cpu``
  at the reference's sizes pass every verdict (the online drill's
  replies: none wrong, none dropped).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mmlspark_tpu.core import drift as rdrift
from mmlspark_tpu.core import slo as rslo
from mmlspark_tpu.core import telemetry as rtelemetry
from mmlspark_tpu.gbdt import engine as rengine
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit_bin_mapper
from mmlspark_tpu.io import ingest as ringest
from mmlspark_tpu.io import refresh as rrefresh
from mmlspark_tpu.io import registry as rregistry
from mmlspark_tpu_torch.core.drift import DriftConfig, DriftMonitor
from mmlspark_tpu_torch.core.slo import SLOMonitor, default_objectives
from mmlspark_tpu_torch.core.telemetry import MetricsRegistry
from mmlspark_tpu_torch.gbdt import fit_bin_mapper
from mmlspark_tpu_torch.gbdt.booster import split_native_digest
from mmlspark_tpu_torch.gbdt.engine import (TrainParams, train,
                                            train_incremental)
from mmlspark_tpu_torch.gbdt.objectives import RegressionL2
from mmlspark_tpu_torch.io.ingest import IngestBuffer, IngestError
from mmlspark_tpu_torch.io.refresh import RefreshConfig, RefreshController
from mmlspark_tpu_torch.io.registry import ModelRegistry
from mmlspark_tpu_torch.io.scoring import ColumnPlan, ScoringEngine
from mmlspark_tpu_torch.tools import chaos_drift, chaos_online
from torch_parity import one_torch_thread, reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the refresh fits of both packages (the reference's defaults, pinned to
#: the segment histogram)
FIT = dict(num_leaves=15, learning_rate=0.1, min_data_in_leaf=5,
           parallelism="serial", verbosity=0, histogram_method="segment")


def _data(seed=0, n=800, f=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    return X, (X[:, 0] + 0.5 * X[:, 1]).astype(np.float64)


def _mappers(X, max_bin=63):
    """The port's and the reference's mapper of ``X``: one ladder."""
    pm, rm = fit_bin_mapper(X, max_bin=max_bin), \
        ref_fit_bin_mapper(X, max_bin=max_bin)
    assert pm.to_json() == rm.to_json()
    return pm, rm


def _files(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as fh:
            out[fn] = fh.read()
    return out


# -- ingest --------------------------------------------------------------------

def test_ingest_writes_the_references_bytes(tmp_path, reference_native):
    X, y = _data(n=2000)
    pm, rm = _mappers(X)
    kw = dict(window_rows=600, reservoir_rows=200, segment_rows=128,
              seed=3, max_segments=6, register=False)
    port = IngestBuffer(str(tmp_path / "port"), pm, **kw)
    ref = ringest.IngestBuffer(str(tmp_path / "ref"), rm, **kw)
    for i in range(0, 2000, 77):
        port.append(X[i:i + 77], y[i:i + 77])
        ref.append(X[i:i + 77], y[i:i + 77])
    assert _files(port.root) == _files(ref.root)   # meta, mapper, segs
    assert any(f.startswith("state_") for f in os.listdir(port.root))
    for a, b in zip(port.training_view(), ref.training_view()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    port.flush(), ref.flush()
    port.compact(), ref.compact()
    assert _files(port.root) == _files(ref.root)
    for k in ("rows", "rows_dropped", "segments_spilled", "compactions"):
        assert port.stats.counter(k) == ref.stats.counter(k)
    # the reference replays the port's directory and the reverse
    for a, b in zip(ringest.IngestBuffer(port.root,
                                         register=False).training_view(),
                    IngestBuffer(ref.root, register=False).training_view()):
        assert np.array_equal(a, b)


def test_replay_after_a_kill_is_exact(tmp_path):
    X, y = _data(n=2000)
    mapper = fit_bin_mapper(X, max_bin=63)
    kw = dict(window_rows=600, reservoir_rows=200, segment_rows=128,
              seed=3, register=False)
    ing = IngestBuffer(str(tmp_path / "ing"), mapper, **kw)
    for i in range(0, 2000, 77):
        ing.append(X[i:i + 77], y[i:i + 77])
    durable = ing.rows_durable
    assert durable < 2000                        # a tail is in flight
    reopened = IngestBuffer(ing.root, register=False)   # no shutdown
    assert reopened.rows_durable == durable
    fed = IngestBuffer(str(tmp_path / "fed"), mapper, **kw)
    fed.append(X[:durable], y[:durable])
    fed.flush()
    for a, b in zip(reopened.training_view(), fed.training_view()):
        assert np.array_equal(a, b)
    assert reopened.stats.counter("segments_replayed") > 0


def test_batch_boundaries_change_nothing(tmp_path):
    X, y = _data(n=1500)
    mapper = fit_bin_mapper(X, max_bin=63)
    kw = dict(window_rows=300, reservoir_rows=120, segment_rows=100,
              seed=9, register=False)
    one = IngestBuffer(str(tmp_path / "a"), mapper, **kw)
    one.append(X, y)
    one.flush()
    many = IngestBuffer(str(tmp_path / "b"), mapper, **kw)
    for i in range(0, 1500, 37):
        many.append(X[i:i + 37], y[i:i + 37])
    many.flush()
    for a, b in zip(one.training_view(), many.training_view()):
        assert np.array_equal(a, b)
    bv, yv = many.training_view()
    assert bv.dtype == np.uint8 and many.rows_retained == 300 + 120
    assert np.array_equal(yv[-300:], y[-300:])    # exact recency
    assert np.array_equal(bv[-300:], mapper.transform_packed(X[-300:])
                          .numpy())


def test_gapped_replay_and_wrong_mapper_are_refused(tmp_path):
    X, y = _data(n=1200)
    d = str(tmp_path / "ing")
    ing = IngestBuffer(d, fit_bin_mapper(X, max_bin=63), segment_rows=100,
                       register=False)
    ing.append(X, y)
    with pytest.raises(IngestError, match="different ladder"):
        IngestBuffer(d, fit_bin_mapper(X * 2.0, max_bin=63),
                     register=False)
    with pytest.raises(IngestError, match="features"):
        ing.append(X[:3, :4], y[:3])
    victim = sorted(f for f in os.listdir(d) if f.startswith("seg_"))[3]
    os.unlink(os.path.join(d, victim))
    with pytest.raises(IngestError, match="missing"):
        IngestBuffer(d, register=False)
    text = ing.render_prometheus()
    for fam in ("ingest_rows_total", "ingest_segments_total",
                "ingest_retained_rows", "ingest_spilled_bytes_total"):
        assert f"# TYPE mmlspark_tpu_{fam} " in text


def test_the_engines_tap_feeds_the_buffer(tmp_path):
    X, y = _data(n=64, f=4)
    mapper = fit_bin_mapper(X, max_bin=63)
    base = train(mapper.transform_packed(X), y, None, mapper,
                 RegressionL2(), TrainParams(num_iterations=2, **FIT),
                 device="cpu")
    ing = IngestBuffer(str(tmp_path / "ing"), mapper, register=False)
    srv = chaos_drift._QueueServer()
    eng = ScoringEngine(srv, predictor=base.predictor(),
                        plan=ColumnPlan("features", 4), max_rows=16,
                        num_scorers=1, num_repliers=0,
                        ingest_tap=lambda rows, m: ing.append(rows, m)
                        ).start()
    try:
        chaos_drift.pump(srv, 0, X[:32], "t", binary=True)
    finally:
        eng.stop()
    assert ing.rows_seen == 32
    bv, yv = ing.training_view()
    assert np.array_equal(yv, base.predict_margin(X[:32]).numpy())


# -- refresh -------------------------------------------------------------------

def _burning(dmon, registry):
    """A private SLO monitor over ``dmon``'s drift gauges (``registry``:
    its package's ``MetricsRegistry``)."""
    dmon.flush()
    dmon.evaluate(force=True)
    registry.register("drift", dmon)
    return registry


def _episode_setup(root, pm, X, y, Xd, yd, base):
    """The port's registry (``base`` active with its profile), an ingest
    buffer holding the drifted feed and an SLO monitor burning on it."""
    registry = ModelRegistry(os.path.join(root, "reg"))
    registry.publish(base, activate=True)
    ingest = IngestBuffer(os.path.join(root, "ing"), pm, window_rows=800,
                          reservoir_rows=200, segment_rows=128,
                          register=False)
    for i in range(0, len(Xd), 100):
        ingest.append(Xd[i:i + 100], yd[i:i + 100])
    dmon = DriftMonitor(base.reference_profile,
                        DriftConfig(duty=1.0, eval_interval_s=0.02,
                                    min_rows=100))
    dmon.observe(Xd, base.predict_margin(Xd).numpy())
    reg = _burning(dmon, MetricsRegistry())
    slo = SLOMonitor([o for o in default_objectives()
                      if o.name in ("feature_drift", "prediction_drift")],
                     registry=reg, fast_window_s=3.0, slow_window_s=6.0)
    return registry, ingest, slo


def _drift(X, shift=3.0):
    Xd = X.copy()
    Xd[:, 0] += shift
    return Xd, (Xd[:, 0] + 0.5 * Xd[:, 1]).astype(np.float64)


def test_refreshed_text_equals_the_references(tmp_path, reference_native):
    """One episode in each package over the same base model, feed and
    settings: the candidate's file (digest header and model text) is the
    same bytes, its tree count the base's plus the refresh's."""
    X, y = _data(n=600, f=4)
    pm, rm = _mappers(X)
    base = train(pm.transform_packed(X), y, None, pm, RegressionL2(),
                 TrainParams(num_iterations=6, **FIT), device="cpu")
    Xd, yd = _drift(X)
    registry, ingest, slo = _episode_setup(str(tmp_path / "port"), pm, X,
                                           y, Xd, yd, base)
    cfg = dict(hysteresis_evals=2, cooldown_s=30.0, min_fit_rows=200,
               num_iterations=4, checkpoint_chunk=2)
    port = RefreshController(
        str(tmp_path / "port" / "ref"), registry=registry, rollout=None,
        ingest=ingest, monitor=slo, config=RefreshConfig(**cfg),
        train_params=TrainParams(**FIT), register=False, device="cpu")
    # the reference: the same base text and profile, its own feed
    rreg = rregistry.ModelRegistry(str(tmp_path / "ref" / "reg"))
    rreg.publish(base.save_native_model_string(), activate=True,
                 profile=base.reference_profile.to_json())
    rbase = rreg.load()
    ring = ringest.IngestBuffer(str(tmp_path / "ref" / "ing"), rm,
                                window_rows=800, reservoir_rows=200,
                                segment_rows=128, register=False)
    for i in range(0, len(Xd), 100):
        ring.append(Xd[i:i + 100], yd[i:i + 100])
    rmon = rdrift.DriftMonitor(rbase.reference_profile, rdrift.DriftConfig(
        duty=1.0, eval_interval_s=0.02, min_rows=100))
    rmon.observe(Xd, np.asarray(rbase.predict_margin(Xd)))
    rslo_mon = rslo.SLOMonitor(
        [o for o in rslo.default_objectives()
         if o.name in ("feature_drift", "prediction_drift")],
        registry=_burning(rmon, rtelemetry.MetricsRegistry()),
        fast_window_s=3.0, slow_window_s=6.0)
    ref = rrefresh.RefreshController(
        str(tmp_path / "ref" / "ref"), registry=rreg, rollout=None,
        ingest=ring, monitor=rslo_mon, config=rrefresh.RefreshConfig(**cfg),
        train_params=rengine.TrainParams(**FIT), register=False)
    seen = [[c.poll(now=float(i)) for i in range(5)] for c in (port, ref)]
    assert seen[0] == seen[1] == ["idle", "idle", "triggered", "fitting",
                                  "candidate"]
    assert _files(str(tmp_path / "port" / "ing")) == \
        _files(str(tmp_path / "ref" / "ing"))
    with open(registry.model_path(2), "rb") as a, \
            open(rreg.model_path(2), "rb") as b:
        assert a.read() == b.read()
    assert registry.entry(2)["meta"] == rreg.entry(2)["meta"]
    assert len(registry.load(2, device="cpu").trees) == 6 + 4
    assert port.stats.counter("fits") == ref.stats.counter("fits") == 1


_KILL_SCRIPT = r'''
import os, sys
sys.path.insert(0, sys.argv[3])
import numpy as np
from mmlspark_tpu_torch.core.drift import DriftConfig, DriftMonitor
from mmlspark_tpu_torch.core.slo import SLOMonitor, default_objectives
from mmlspark_tpu_torch.core.telemetry import MetricsRegistry
from mmlspark_tpu_torch.gbdt.engine import TrainParams
from mmlspark_tpu_torch.io.ingest import IngestBuffer
from mmlspark_tpu_torch.io.refresh import RefreshConfig, RefreshController
from mmlspark_tpu_torch.io.registry import ModelRegistry
root, phase = sys.argv[1], sys.argv[2]
registry = ModelRegistry(os.path.join(root, "reg"))
ingest = IngestBuffer(os.path.join(root, "ing"), register=False)
base = registry.load(1, device="cpu")
with np.load(os.path.join(root, "drifted.npz")) as d:
    Xd = d["X"]
dmon = DriftMonitor(base.reference_profile,
                    DriftConfig(duty=1.0, eval_interval_s=0.02,
                                min_rows=100))
dmon.observe(Xd, base.predict_margin(Xd).numpy())
dmon.flush(); dmon.evaluate(force=True)
reg = MetricsRegistry(); reg.register("drift", dmon)
slo = SLOMonitor([o for o in default_objectives()
                  if o.name in ("feature_drift", "prediction_drift")],
                 registry=reg, fast_window_s=3.0, slow_window_s=6.0)
refresh = RefreshController(
    os.path.join(root, "ref"), registry=registry, rollout=None,
    ingest=ingest, monitor=slo,
    config=RefreshConfig(hysteresis_evals=1, min_fit_rows=200,
                         num_iterations=12, checkpoint_chunk=4),
    train_params=TrainParams(num_leaves=15, min_data_in_leaf=5,
                             parallelism="serial", verbosity=0),
    register=False, device="cpu")
if phase == "kill":
    def killer(it, trees):
        if it >= 6:
            os._exit(37)   # dies mid-fit, after boundary 4 is durable
    refresh.fit_callbacks = [killer]
    for i in range(8):
        refresh.poll(now=float(i))
    print("UNREACHABLE"); sys.exit(3)
assert refresh.state == "fitting", refresh.state
assert refresh.stats.counter("recoveries") == 1
assert refresh.poll(now=10.0) == "candidate"
print("RECOVERED", refresh.candidate_version)
'''


def test_a_killed_trainer_resumes_to_the_uninterrupted_text(tmp_path):
    X, y = _data(n=600, f=4)
    mapper = fit_bin_mapper(X, max_bin=63)
    params = dict(num_leaves=15, min_data_in_leaf=5, parallelism="serial",
                  verbosity=0)
    base = train(mapper.transform_packed(X), y, None, mapper,
                 RegressionL2(), TrainParams(num_iterations=6, **params),
                 device="cpu")
    Xd, yd = _drift(X)
    root = str(tmp_path / "state")
    registry, _, _ = _episode_setup(root, mapper, X, y, Xd, yd, base)
    np.savez(os.path.join(root, "drifted.npz"), X=Xd)
    script = str(tmp_path / "trainer.py")
    with open(script, "w") as fh:
        fh.write(_KILL_SCRIPT)

    def run(phase):
        return subprocess.run([sys.executable, script, root, phase, REPO],
                              capture_output=True, text=True, timeout=300)

    r = run("kill")
    assert r.returncode == 37, r.stdout[-2000:] + r.stderr[-3000:]
    with open(os.path.join(root, "ref", "refresh_state.json")) as fh:
        assert json.load(fh)["state"] == "fitting"
    assert os.path.exists(os.path.join(root, "ref", "ckpt_0001",
                                       "boost_checkpoint.npz"))
    r = run("recover")
    assert r.returncode == 0 and "RECOVERED 2" in r.stdout, r.stderr[-3000:]
    registry.reload()
    with np.load(os.path.join(root, "ref", "dataset_0001.npz")) as ds:
        clean = train_incremental(
            ds["bins"], ds["labels"], mapper,
            init_booster=registry.load(1, device="cpu"),
            objective=RegressionL2(),
            params=TrainParams(num_iterations=12, checkpoint_chunk=4,
                               **params), device="cpu")
    assert split_native_digest(registry.read_text(2)) == \
        clean.save_native_model_string()
    assert "[num_iterations: 18]" in clean.save_native_model_string()


def _refresh(tmp_path, **cfg):
    X, y = _data(n=600, f=4)
    mapper = fit_bin_mapper(X, max_bin=63)
    base = train(mapper.transform_packed(X), y, None, mapper,
                 RegressionL2(), TrainParams(num_iterations=4, **FIT),
                 device="cpu")
    Xd, yd = _drift(X)
    registry, ingest, slo = _episode_setup(str(tmp_path), mapper, X, y,
                                           Xd, yd, base)
    return RefreshController(
        str(tmp_path / "ref"), registry=registry, rollout=None,
        ingest=ingest, monitor=slo,
        config=RefreshConfig(hysteresis_evals=2, cooldown_s=30.0,
                             num_iterations=2, **cfg),
        train_params=TrainParams(**FIT), register=False, device="cpu")


def test_a_failing_fit_backs_off_then_gives_up(tmp_path):
    refresh = _refresh(tmp_path, min_fit_rows=200, max_retries=2,
                       backoff_s=2.0)

    def bomb(it, trees):
        raise RuntimeError("injected fit failure")

    refresh.fit_callbacks = [bomb]
    seen = [refresh.poll(now=t) for t in (0.0, 1.0, 2.0, 3.0, 4.0, 5.0,
                                          6.0, 30.0, 31.0)]
    assert seen == ["idle", "idle", "triggered", "fitting", "backoff",
                    "backoff", "backoff", "gave_up", "gave_up"]
    assert refresh.stats.counter("retries") == 2
    refresh.reset(now=40.0)
    assert refresh.state == "idle" and refresh.poll(now=41.0) == "cooldown"
    text = refresh.render_prometheus()
    assert '# TYPE mmlspark_tpu_refresh_state gauge' in text


def test_a_starved_trigger_waits_for_rows(tmp_path):
    refresh = _refresh(tmp_path, min_fit_rows=5000)
    assert [refresh.poll(now=float(t)) for t in range(4)] == \
        ["idle", "idle", "triggered", "starved"]
    refresh.cfg.min_fit_rows = 200
    assert refresh.poll(now=4.0) == "fitting"


# -- the drills ----------------------------------------------------------------

def test_the_drift_drill_passes_on_the_cpu(tmp_path):
    out = str(tmp_path / "drift.json")
    assert chaos_drift.main(["--device", "cpu", "--out", out]) == 0
    with open(out) as fh:
        art = json.load(fh)
    assert art["healthy"] and art["verdicts_total"] == 18
    assert art["scenarios"]["feature_shift"]["injected_feature"] == "f2"


def test_the_online_drill_passes_on_the_cpu(tmp_path):
    out = str(tmp_path / "online.json")
    assert chaos_online.main(["--device", "cpu", "--out", out]) == 0
    with open(out) as fh:
        art = json.load(fh)
    assert art["healthy"] and art["verdicts_total"] == 26
    led = art["scenarios"]["serving_consistency"]["replies"]
    assert led["wrong"] == 0 and led["dropped"] == 0
    assert led["total"] >= 4000 and len(led["by_version"]) >= 3
    a = art["scenarios"]["sigkill_mid_refresh"]
    assert a["resumed_fit"]["candidate"] == a["refreshed_version"]
