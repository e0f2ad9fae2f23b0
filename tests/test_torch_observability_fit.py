"""Every port fit is instrumented as the reference's is.

The same numpy-seeded serial fits run through ``mmlspark_tpu``'s
``engine.train`` and the port's (both pinned to ``"segment"``):

* the fit span's journal — ``fit_begin``, the ``profile_span`` /
  ``boost_chunk`` pairs, the ``ckpt_saved`` events, ``fit_end`` — is the
  reference's event for event, with equal non-timing fields (span ids and
  clocks aside) and ``train_loss`` within 1e-6 relative;
* a custom-gradient fit (``grad_fn_override``) writes the reference's
  model text and journals one ``boost_chunk`` an iteration, as the
  reference's host loop does;
* the booster's reference profile equals the reference's, and survives
  stage persistence as the reference's does (it does not);
* a failing fit journals ``fit_failed`` and writes a flight record; the
  ``MMLSPARK_TPU_REF_PROFILE=0`` gate skips the capture; debug mode
  stops a fit whose gradient holds a NaN before its first tree;
* the registry carries ``train`` and the two info gauges; the elastic
  watchdog registers ``elastic``, stamps the fit span into its lease and
  journals a lost peer.
"""

import json
import os

import numpy as np
import pytest

from mmlspark_tpu.core import telemetry as ref_tm
from mmlspark_tpu.gbdt import LightGBMClassificationModel as RefClsModel
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch import LightGBMClassifier
from mmlspark_tpu_torch.core import debug
from mmlspark_tpu_torch.core import telemetry as tm
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.gbdt import engine, fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train
from mmlspark_tpu_torch.io.chaos import ChaosBoostStep, ChaosPlan
from torch_parity import one_torch_thread  # noqa: F401 - fixture

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(num_iterations=6, num_leaves=7, min_data_in_leaf=5, max_bin=31,
          verbosity=0, histogram_method="segment")
#: journal fields that carry clocks or span ids
_TIMING = {"ts", "pid", "seq", "fit", "dur_s", "dur_ms", "ms_per_tree",
           "rows_per_s", "host_ms", "device_ms"}


def _table(n=900, f=6, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


def _span_events(journal):
    """The newest fit span's events, in order."""
    evs = journal.events()
    span = [e for e in evs if e["ev"] == "fit_begin"][-1]["fit"]
    return [e for e in evs if e.get("fit") == span]


def _split(events):
    """(non-timing fields of each event, its train_loss or None)."""
    out, losses = [], []
    for e in events:
        losses.append(e.get("train_loss"))
        out.append({k: v for k, v in e.items()
                    if k not in _TIMING and k != "train_loss"})
    return out, losses


def _custom_grad(y):
    """A binary logloss gradient computed in numpy float32: the same
    floats whichever package calls it."""
    y32 = y.astype(np.float32)

    def fn(scores):
        s = np.asarray(scores, np.float32)
        p = (np.float32(1) / (np.float32(1) + np.exp(-s))).astype(
            np.float32)
        return p - y32, np.maximum(p * (np.float32(1) - p),
                                   np.float32(1e-6))
    return fn


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Each package's checkpointed serial fit and custom-gradient fit,
    with the journal events of each fit's span."""
    X, y = _table()
    out = {}
    for name, fit, tr, params, obj, journal, extra in (
            ("ref", ref_fit, ref_train, RefParams, ref_objective,
             ref_tm.get_journal(), {}),
            ("port", fit_bin_mapper, train, TrainParams, get_objective,
             tm.get_journal(), {"device": "cpu"})):
        mapper = fit(X, max_bin=31)
        bins = mapper.transform_packed(X)
        ck = str(tmp_path_factory.mktemp(f"ck_{name}"))
        b = tr(bins, y, None, mapper, obj("binary"),
               params(**KW, checkpoint_dir=ck, checkpoint_chunk=2),
               **extra)
        main = _span_events(journal)
        c = tr(bins, y, None, mapper, obj("binary"),
               params(**{**KW, "bagging_fraction": 0.7,
                         "bagging_freq": 2}),
               grad_fn_override=_custom_grad(y), **extra)
        out[name] = (b, main, c, _span_events(journal))
    return X, y, out


def test_fit_journal_equals_reference(fits):
    _, _, out = fits
    port, ref = out["port"][1], out["ref"][1]
    (pf, pl), (rf, rl) = _split(port), _split(ref)
    assert pf == rf
    assert [e["ev"] for e in pf] == (
        ["fit_begin"]
        + ["profile_span", "boost_chunk", "ckpt_saved"] * 2
        + ["profile_span", "boost_chunk", "fit_end"])
    assert [(e["it_start"], e["it_end"]) for e in pf
            if e["ev"] == "boost_chunk"] == [(0, 2), (2, 4), (4, 6)]
    assert pf[-1]["trees"] == 6
    assert len({e["fit"] for e in port}) == 1
    for a, b in zip(pl, rl):
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, rel=1e-6)
    assert out["port"][0].save_native_model_string() == \
        out["ref"][0].save_native_model_string()


def test_custom_gradient_fit_equals_reference(fits):
    _, _, out = fits
    assert out["port"][2].save_native_model_string() == \
        out["ref"][2].save_native_model_string()
    (pf, pl), (rf, rl) = _split(out["port"][3]), _split(out["ref"][3])
    assert pf == rf
    assert [(e["it_start"], e["it_end"]) for e in pf
            if e["ev"] == "boost_chunk"] == [(i, i + 1) for i in range(6)]
    assert pl == rl == [None] * len(pf)


def test_reference_profile_equals_reference(fits):
    _, _, out = fits

    def doc(booster):
        d = json.loads(booster.reference_profile.to_json())
        d["meta"] = {k: v for k, v in d["meta"].items()
                     if k not in ("created", "fit_span")}
        return d

    assert doc(out["port"][0]) == doc(out["ref"][0])
    meta = json.loads(out["port"][0].reference_profile.to_json())["meta"]
    assert meta["fit_span"] == out["port"][1][0]["fit"]
    assert meta["trees"] == 6 and meta["n_rows"] == 900


def test_profile_capture_persistence_and_gate(tmp_path, monkeypatch):
    X, y = _table(400, seed=3)
    table = {"features": X, "label": y}
    kw = dict(numIterations=3, numLeaves=4, verbosity=0,
              histogramMethod="segment")
    model = LightGBMClassifier(device="cpu", **kw).fit(table)
    assert model.getModel().reference_profile is not None
    model.save(str(tmp_path / "m"))
    loaded = load_stage(str(tmp_path / "m"))
    # neither package persists the profile with a stage
    assert loaded.getModel().reference_profile is None
    assert RefClsModel.loadNativeModelFromString(
        model.getNativeModel()).getModel().reference_profile is None
    before = engine.train_stats.counter("ref_profiles")
    monkeypatch.setenv(engine.REF_PROFILE_ENV, "0")
    off = LightGBMClassifier(device="cpu", **kw).fit(table)
    assert off.getModel().reference_profile is None
    assert engine.train_stats.counter("ref_profiles") == before
    assert off.getNativeModel() == model.getNativeModel()
    monkeypatch.delenv(engine.REF_PROFILE_ENV)
    mapper = fit_bin_mapper(X, max_bin=31)
    bins = mapper.transform_packed(X)
    merged = engine.train_incremental(
        bins, y, mapper, init_booster=model.getModel(),
        objective=get_objective("binary"),
        params=TrainParams(**{**KW, "num_iterations": 2}), device="cpu")
    prof = json.loads(merged.reference_profile.to_json())
    assert prof["meta"]["trees"] == len(merged.trees) == 5


def test_failing_fit_journals_and_writes_a_flight_record(tmp_path,
                                                          monkeypatch):
    X, y = _table(300, seed=5)
    mapper = fit_bin_mapper(X, max_bin=31)
    bins = mapper.transform_packed(X)
    fr = str(tmp_path / "fr")
    tm.configure_flight_recorder(directory=fr, min_interval_s=0.0)
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=1),
                          fail_on_calls=[1])
    monkeypatch.setattr(engine, "_boost_chunk", step)
    try:
        with pytest.raises(RuntimeError, match="chaos"):
            train(bins, y, None, mapper, get_objective("binary"),
                  TrainParams(**KW), device="cpu")
        evs = _span_events(tm.get_journal())
        assert [e["ev"] for e in evs] == ["fit_begin", "fit_failed"]
        assert evs[-1]["error"] == "RuntimeError"
        assert tm.current_fit_span() is None
        (path,) = [os.path.join(fr, p) for p in os.listdir(fr)]
        with open(path) as fh:
            rec = json.load(fh)
        assert rec["reason"] == "fit_failed"
        assert rec["context"]["fit"] == evs[0]["fit"]
        assert rec["journal_tail"][-1]["ev"] == "fit_failed"
        assert "memory_bytes" in rec["profile"]
    finally:
        tm.configure_flight_recorder(directory=os.environ.get(
            tm.FLIGHTREC_DIR_ENV, "artifacts"), min_interval_s=5.0)


def test_debug_mode_stops_a_nan_gradient_before_the_first_tree():
    X, y = _table(300, seed=6)
    mapper = fit_bin_mapper(X, max_bin=31)
    bins = mapper.transform_packed(X)
    calls = []

    def nan_grad(scores):
        calls.append(1)
        g = np.zeros(len(y), np.float32)
        g[7] = np.nan
        return g, np.ones(len(y), np.float32)

    prev = debug.debug_enabled()
    try:
        debug.debug_mode(True)
        with pytest.raises(debug.DebugCheckError, match="non-finite"):
            train(bins, y, None, mapper, get_objective("binary"),
                  TrainParams(**KW), device="cpu",
                  grad_fn_override=nan_grad)
        evs = _span_events(tm.get_journal())
        assert [e["ev"] for e in evs] == ["fit_begin", "fit_failed"]
        assert calls == [1]
        with pytest.raises(debug.DebugCheckError, match="out of range"):
            bad = bins.clone()
            bad[3, 2] = 40                       # past max_bin's 32 bins
            train(bad, y, None, mapper, get_objective("binary"),
                  TrainParams(**KW), device="cpu")
    finally:
        debug.debug_mode(prev)


def test_nested_fit_joins_the_enclosing_span_and_registry():
    X, y = _table(300, seed=7)
    mapper = fit_bin_mapper(X, max_bin=31)
    bins = mapper.transform_packed(X)
    tm.set_current_fit_span("outer0000000000")
    seq0 = tm.get_journal().events()[-1]["seq"]
    try:
        train(bins, y, None, mapper, get_objective("binary"),
              TrainParams(**{**KW, "num_iterations": 2}), device="cpu")
    finally:
        tm.set_current_fit_span(None)
    evs = [e for e in tm.get_journal().events() if e["seq"] > seq0]
    assert "fit_begin" not in [e["ev"] for e in evs]
    assert {e["fit"] for e in evs} == {"outer0000000000"}
    text = tm.get_registry().render_prometheus()
    assert 'mmlspark_tpu_events_total{event="boost_chunks",ns="train"}' \
        in text
    assert "mmlspark_tpu_train_histogram_method_info{" in text
    assert 'mmlspark_tpu_train_quantized_info{bits="0"' in text
    with pytest.raises(NotImplementedError, match="single-model"):
        train(bins, (y * 2).astype(np.float64) % 3, None, mapper,
              get_objective("multiclass", num_class=3),
              TrainParams(**KW), device="cpu",
              grad_fn_override=_custom_grad(y))


def test_elastic_watchdog_registers_stamps_and_journals(tmp_path):
    from mmlspark_tpu_torch.gbdt.elastic import (ElasticConfig,
                                                 HeartbeatWatchdog)
    lost = []
    cfg = ElasticConfig(heartbeat_dir=str(tmp_path), process_id=0,
                        num_processes=2, heartbeat_interval_s=0.02,
                        straggler_age_s=0.05, lease_timeout_s=0.1,
                        startup_grace_s=0.0)
    wd = HeartbeatWatchdog(cfg, on_peer_lost=lambda p, a: lost.append(p))
    tm.set_current_fit_span("feedface00000000")
    seq0 = tm.get_journal().events()[-1]["seq"]
    try:
        wd.start()
        assert tm.get_registry().snapshot()["elastic"]["counters"][
            "peer_lost"] == 0
        with open(wd.path_for(1), "w") as fh:
            fh.write("0\n")
        import time
        deadline = time.time() + 10
        while not lost and time.time() < deadline:
            time.sleep(0.02)
    finally:
        wd.stop()
        tm.set_current_fit_span(None)
    assert lost == [1]
    with open(wd.path_for(0)) as fh:
        assert fh.read().split()[1] == "feedface00000000"
    evs = [e for e in tm.get_journal().events() if e["seq"] > seq0]
    kinds = [e["ev"] for e in evs]
    assert "peer_stalled" in kinds and "peer_lost" in kinds
    assert all(e["fit"] == "feedface00000000" and e["peer"] == 1
               for e in evs if e["ev"].startswith("peer_"))
