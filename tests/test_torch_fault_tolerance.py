"""In-process chunk replay in the port (``faultTolerantRetries``) on the
CPU: the counterpart of the reference's ``TestFaultTolerance`` and
``TestMeshFaultTolerance`` (``tests/test_fault_tolerance.py``).

Failures are injected by wrapping the engine's chunk function
(``engine._boost_chunk``) with :class:`ChaosBoostStep`, which also makes
the fit forget its device buffers before it raises, as a lost device
does: a replay must upload every input again.  Each replayed fit writes
the model text of the same fit without a failure, byte for byte: serial,
on D = 2 and D = 4 meshes, with validation, with GOSS, bagging,
multiclass, EFB and lambdarank.  Spent retries re-raise; a replay
whose upload fails spends one attempt; a ``KeyboardInterrupt`` is not
replayed; DART warns that it does not
replay.  Inputs come from numpy seeds at small sizes.
"""

import logging

import numpy as np
import pytest

from mmlspark_tpu.io.chaos import ChaosBoostStep as RefChaosBoostStep
from mmlspark_tpu.io.chaos import ChaosPlan as RefChaosPlan
from mmlspark_tpu_torch import LightGBMClassifier
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import engine, fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train
from mmlspark_tpu_torch.gbdt.ranking import LambdarankGradient
from mmlspark_tpu_torch.io.chaos import ChaosBoostStep, ChaosPlan
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _data(n=360, seed=21, classes=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)
    if classes == 1:
        return X, (s > 0).astype(np.float64)
    return X, np.digitize(s, [-0.6, 0.6]).astype(np.float64)


def _logloss(m, y, w):
    p = np.clip(1.0 / (1.0 + np.exp(-m)), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


#: each case's fit: data shards and options; every case runs more than
#: one chunk (32 iterations a chunk under retries, 8 under callbacks)
CASES = {
    "serial": dict(),
    "serial_val": dict(val=True, early_stopping_round=40),
    "d2": dict(d=2, collective="psum"),
    "d4": dict(d=4, collective="psum"),
    "d4_val": dict(d=4, collective="psum", val=True),
    "goss": dict(boosting="goss"),
    "goss_d2": dict(boosting="goss", d=2),
    "bagging": dict(bagging_fraction=0.7, bagging_freq=3,
                    feature_fraction=0.8),
    "multiclass": dict(classes=3),
    "efb": dict(enable_bundle=True, onehot=True),
    "lambdarank": dict(ranking=True),
}


def _fit(case, retries=0, iterations=40):
    kw = dict(CASES[case])
    d, classes = kw.pop("d", 1), kw.pop("classes", 1)
    val, onehot = kw.pop("val", False), kw.pop("onehot", False)
    ranking = kw.pop("ranking", False)
    X, y = _data(classes=classes)
    if onehot:
        c = np.random.default_rng(3).integers(0, 6, size=len(y))
        X[:, 2:] = 0.0
        X[np.arange(len(y)), 2 + c] = 1.0
    m = fit_bin_mapper(X, max_bin=31)
    vmask = np.random.default_rng(2).random(len(y)) < 0.25
    tr = ~vmask if val else np.ones(len(y), bool)
    extra = {}
    if val:
        extra = dict(val_bins=m.transform(X[vmask], "cpu"),
                     val_labels=y[vmask], val_metric=_logloss)
    if ranking:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
        extra["ranking_info"] = dict(query_ids=np.arange(len(y)) // 12,
                                     sigma=1.0, truncation_level=20)
    mesh = build_mesh(d, devices=["cpu"] * d) if d > 1 else None
    obj = (get_objective("multiclass", num_class=3) if classes > 1
           else get_objective("lambdarank" if ranking else "binary"))
    params = TrainParams(num_iterations=iterations, num_leaves=5,
                         verbosity=0, histogram_method="segment",
                         fault_tolerant_retries=retries,
                         learning_rate=0.05, min_data_in_leaf=10, **kw)
    return train(m.transform(X[tr], "cpu"), y[tr], None, m, obj, params,
                 device="cpu", mesh=mesh, **extra)


def _counters():
    return dict(engine.train_stats.snapshot()["counters"])


@pytest.mark.parametrize("case", list(CASES))
def test_injected_failure_is_replayed_identically(case, monkeypatch):
    """The second chunk's first attempt fails after the fit's device
    buffers are dropped; the replay uploads them again and the fit writes
    the undisturbed model text."""
    clean = _fit(case).save_native_model_string()
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=2),
                          fail_on_calls={2}, drop_device=True)
    monkeypatch.setattr(engine, "_boost_chunk", step)
    before = _counters()
    recovered = _fit(case, retries=1).save_native_model_string()
    assert step.failures == 1 and step.calls >= 3
    assert _counters()["chunks_replayed"] - before["chunks_replayed"] == 1
    assert recovered == clean


def _failing_upload(monkeypatch, fail_on):
    """Make the ``fail_on``-th upload of a fit (the first is the fit's
    own, the later ones a replay's) raise as an out-of-memory error
    would; returns the list of uploads made."""
    upload, calls = engine._BoostFit.upload, []

    def flaky(self, *a, **kw):
        calls.append(len(calls) + 1)
        if len(calls) == fail_on:
            raise RuntimeError("chaos: upload failed")
        return upload(self, *a, **kw)

    monkeypatch.setattr(engine._BoostFit, "upload", flaky)
    return calls


@pytest.mark.parametrize("retries", [1, 2])
@pytest.mark.parametrize("case", ["serial", "d2"])
def test_failed_reupload_spends_an_attempt(case, retries, monkeypatch):
    """A replay's upload runs inside the attempt: when it raises, that
    attempt is spent, and the next one uploads again; with no attempt
    left the fit re-raises the upload's error."""
    clean = _fit(case).save_native_model_string()
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=2),
                          fail_on_calls={2}, drop_device=True)
    monkeypatch.setattr(engine, "_boost_chunk", step)
    uploads = _failing_upload(monkeypatch, fail_on=2)
    before = _counters()
    if retries == 1:
        with pytest.raises(RuntimeError, match="upload failed"):
            _fit(case, retries=retries)
        assert uploads == [1, 2]
        return
    assert _fit(case, retries=retries).save_native_model_string() == clean
    assert uploads == [1, 2, 3]
    assert _counters()["chunks_replayed"] - before["chunks_replayed"] == 2


@pytest.mark.parametrize("case", ["serial", "d2"])
def test_exhausted_retries_reraise(case, monkeypatch):
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=0),
                          exc_rate=1.0)
    monkeypatch.setattr(engine, "_boost_chunk", step)
    with pytest.raises(RuntimeError, match="chaos"):
        _fit(case, retries=2)
    assert step.calls == 3


def test_bagging_replay_keeps_stream(monkeypatch):
    """Replays of the first and second chunk reuse their drawn bag rows,
    so the recovered bagged fit equals the clean one."""
    clean = _fit("bagging").save_native_model_string()
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=4),
                          fail_on_calls={1, 3}, drop_device=True)
    monkeypatch.setattr(engine, "_boost_chunk", step)
    assert _fit("bagging", retries=1).save_native_model_string() == clean
    assert step.failures == 2


def test_injector_drops_device_arrays_before_raising(monkeypatch):
    """The injector empties the fit's device state, so a replay that
    skipped the upload would fail: with the upload of a replay made a
    no-op, the fit raises."""
    seen = []

    def spy(fit, *args):
        seen.append(fit)
        return inner(fit, *args)

    inner = engine._boost_chunk
    step = ChaosBoostStep(spy, ChaosPlan(seed=5), fail_on_calls={1},
                          drop_device=True)
    monkeypatch.setattr(engine, "_boost_chunk", step)
    with pytest.raises(RuntimeError, match="chaos"):
        _fit("serial", retries=0)
    assert seen == []             # the failing call never reached the fit
    uploads = []
    real_upload = engine._BoostFit.upload

    def upload_once(self, *a):
        uploads.append(1)
        if len(uploads) == 1:
            real_upload(self, *a)

    monkeypatch.setattr(engine._BoostFit, "upload", upload_once)
    monkeypatch.setattr(engine, "_boost_chunk", ChaosBoostStep(
        inner, ChaosPlan(seed=5), fail_on_calls={1}, drop_device=True))
    with pytest.raises(AttributeError):
        _fit("serial", retries=1)
    assert len(uploads) == 2


def test_keyboard_interrupt_is_not_replayed(monkeypatch):
    calls = []

    def interrupted(*args):
        calls.append(1)
        raise KeyboardInterrupt

    monkeypatch.setattr(engine, "_boost_chunk", interrupted)
    with pytest.raises(KeyboardInterrupt):
        _fit("serial", retries=3)
    assert calls == [1]


def test_dart_warns_retries_are_inert(caplog):
    with caplog.at_level(logging.WARNING):
        train(*_dart_inputs(), TrainParams(
            num_iterations=3, num_leaves=5, boosting="dart", verbosity=0,
            fault_tolerant_retries=1), device="cpu")
    assert "faultTolerantRetries is inert" in caplog.text


def _dart_inputs():
    X, y = _data(n=200)
    m = fit_bin_mapper(X, max_bin=31)
    return m.transform(X, "cpu"), y, None, m, get_objective("binary")


def test_estimator_fault_tolerant_retries(monkeypatch):
    X, y = _data(n=300, seed=8)
    table = {"features": X, "label": y}
    kw = dict(numIterations=40, numLeaves=5, device="cpu", verbosity=0,
              baggingFraction=0.8, baggingFreq=1)
    clean = LightGBMClassifier(**kw).fit(table).getNativeModel()
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=6),
                          fail_on_calls={2}, drop_device=True)
    monkeypatch.setattr(engine, "_boost_chunk", step)
    got = LightGBMClassifier(faultTolerantRetries=1,
                             **kw).fit(table).getNativeModel()
    assert got == clean and step.failures == 1


def test_ranking_gradient_source_is_rebuilt_on_replay(monkeypatch):
    built = []
    real = LambdarankGradient.serial.__func__

    def counting(cls, *a, **kw):
        built.append(1)
        return real(cls, *a, **kw)

    monkeypatch.setattr(LambdarankGradient, "serial",
                        classmethod(counting))
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=7),
                          fail_on_calls={1}, drop_device=True)
    monkeypatch.setattr(engine, "_boost_chunk", step)
    _fit("lambdarank", retries=1, iterations=4)
    assert len(built) == 2


# -- the injector -------------------------------------------------------------

def test_chaos_boost_step_fail_on_calls():
    calls = []
    step = ChaosBoostStep(lambda x: calls.append(x) or x,
                          ChaosPlan(seed=1), fail_on_calls={2, 4})
    assert step(10) == 10
    with pytest.raises(RuntimeError, match="chaos"):
        step(11)
    assert step(12) == 12
    with pytest.raises(RuntimeError, match="chaos"):
        step(13)
    assert step.calls == 4 and step.failures == 2
    assert calls == [10, 12]       # failed calls never reach the inner


def _decisions(cls, plan_cls, seed, n=80):
    s = cls(lambda: None, plan_cls(seed=seed), exc_rate=0.35)
    out = []
    for _ in range(n):
        try:
            s()
            out.append(False)
        except RuntimeError:
            out.append(True)
    return out


@pytest.mark.parametrize("seed", [0, 9, "drill"])
def test_chaos_boost_step_rate_matches_reference(seed):
    got = _decisions(ChaosBoostStep, ChaosPlan, seed)
    assert got == _decisions(RefChaosBoostStep, RefChaosPlan, seed)
    assert any(got) and not all(got)
