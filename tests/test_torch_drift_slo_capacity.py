"""The port's data-quality and capacity layer against the reference's.

``mmlspark_tpu_torch/core/sketch.py``, ``drift.py``, ``slo.py`` and
``capacity.py`` are numpy copies of ``mmlspark_tpu/core``'s; fed the same
numpy-seeded inputs (and, where a monitor reads a clock, the same injected
times), both packages give equal results:

* sketches, their snapshots and merges, reference profiles built from the
  same bins and margins (equal JSON), PSI and JS divergences;
* a :class:`DriftMonitor` fed the same stream reaches the same verdicts,
  gauges and counters;
* :meth:`SLOMonitor.evaluate` over the same registry readings;
* the :class:`KneeEstimator`'s raw and published knees, and a
  :class:`CapacityMonitor`'s gauges over the same ticks.

Every monitor thread a test starts is stopped in the test.
"""

import json

import numpy as np
import pytest

from mmlspark_tpu.core import capacity as ref_capacity
from mmlspark_tpu.core import drift as ref_drift
from mmlspark_tpu.core import profiling as ref_profiling
from mmlspark_tpu.core import sketch as ref_sketch
from mmlspark_tpu.core import slo as ref_slo
from mmlspark_tpu.core import telemetry as ref_tm
from mmlspark_tpu.gbdt.binning import fit_bin_mapper as ref_fit
from mmlspark_tpu_torch.core import capacity, drift, profiling, sketch, slo
from mmlspark_tpu_torch.core import telemetry as tm
from mmlspark_tpu_torch.gbdt.binning import fit_bin_mapper

PKGS = {"ref": (ref_sketch, ref_drift, ref_slo, ref_capacity,
                ref_profiling, ref_tm),
        "port": (sketch, drift, slo, capacity, profiling, tm)}


def _table(seed=15, n=1500, f=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(n) < 0.05, 1] = np.nan
    X[:, 4] = rng.integers(0, 6, size=n)             # a coarse column
    return X


# -- sketches and divergences ------------------------------------------------


def test_stream_and_matrix_sketches_equal_reference():
    rng = np.random.default_rng(1)
    edges = np.sort(rng.normal(size=12))
    vals = np.concatenate([rng.normal(size=3000), [np.nan] * 7,
                           [np.inf, -np.inf, 50.0, -50.0]])
    snaps, merged, qs = [], [], []
    for mod in (ref_sketch, sketch):
        a = mod.StreamSketch(edges, float(edges[0]), float(edges[-1]))
        b = mod.StreamSketch(edges, float(edges[0]), float(edges[-1]))
        a.update(vals[:1500])
        b.update(vals[1500:])
        snaps.append((a.snapshot(), b.snapshot()))
        merged.append(mod.merge_sketch_snapshots(
            [a.snapshot(), b.snapshot()]))
        m = a.merge(b)
        qs.append([m.quantile(q) for q in (0.01, 0.5, 0.99)]
                  + [v() if callable(v) else v for v in (
                      m.mean, m.var, m.null_rate, m.oor_rate, m.total)])
        back = mod.StreamSketch.from_snapshot(m.snapshot(), edges)
        assert back.snapshot() == m.snapshot()
        ms = mod.MatrixSketch([edges, edges[::2]])
        ms.update(np.stack([vals[:200], vals[200:400]], axis=1))
        snaps.append(ms.snapshot())
    assert snaps[0] == snaps[2] and snaps[1] == snaps[3]
    assert merged[0] == merged[1]
    assert qs[0] == qs[1]
    assert list(sketch.downsample_edges(edges, 5)) == \
        list(ref_sketch.downsample_edges(edges, 5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psi_and_js_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 500, size=17).astype(np.int64)
    live = np.maximum(0, ref + rng.integers(-80, 300, size=17))
    live[3] = 0
    for a, b in ((ref, live), (ref, ref), (ref * 0, live)):
        assert sketch.psi(a, b) == ref_sketch.psi(a, b)
        assert sketch.js_divergence(a, b) == ref_sketch.js_divergence(a, b)


@pytest.fixture(scope="module")
def profiles():
    """A reference profile built by each package from the same bins (each
    package's own mapper over the same table) and the same margins."""
    X = _table()
    margins = np.random.default_rng(3).normal(size=len(X)) * 2.0
    out = {}
    for name, fit in (("ref", ref_fit), ("port", fit_bin_mapper)):
        mapper = fit(X, max_bin=63)
        bins = mapper.transform_packed(X)
        mod = PKGS[name][0]
        out[name] = (mod.build_reference_profile(
            bins, mapper, margins, feature_names=[f"c{j}" for j in
                                                  range(X.shape[1])],
            meta={"created": 0.0, "fit_span": "s"}), mapper)
    return X, margins, out


def test_reference_profile_json_equals_reference(profiles):
    _, _, out = profiles
    port, ref = out["port"][0].to_json(), out["ref"][0].to_json()
    assert port == ref
    back = sketch.ReferenceProfile.from_json(ref)
    assert back.to_json() == port
    assert json.loads(port)["meta"]["n_rows"] == 1500


def _monitor_run(name, profile, X, margins):
    """One stream of batches (clean, shifted feature 3, shifted margins,
    a NaN storm) through a monitor of one package; returns its verdicts
    after each batch, its journal events, snapshot counters and render."""
    _, dmod, _, _, _, tmod = PKGS[name]
    journal = tmod.get_journal()
    seq0 = journal.events()[-1]["seq"] if journal.events() else 0
    mon = dmod.DriftMonitor(profile, dmod.DriftConfig(
        duty=1.0, eval_interval_s=0.0, min_rows=200, window_s=1e6))
    verdicts = []
    try:
        rng = np.random.default_rng(8)
        for step in range(4):
            idx = rng.integers(0, len(X), 400)
            xb, mb = X[idx].copy(), margins[idx].copy()
            if step == 1:
                xb[:, 3] += 4.0
            if step == 2:
                mb += 25.0
            if step == 3:
                xb[: 300, 0] = np.nan
            assert mon.observe(xb, mb)
            rep = mon.report()
            verdicts.append({k: rep[k] for k in (
                "alerting", "worst_feature", "gauges", "rows_observed",
                "rows_skipped")} | {"signals": rep["signals"]})
        snap = mon.snapshot()
        text = mon.render_prometheus()
    finally:
        mon.close()
    evs = [{k: v for k, v in e.items() if k not in ("ts", "pid", "seq")}
           for e in journal.events()
           if e["seq"] > seq0 and e["ev"].startswith("drift_")]
    return verdicts, evs, snap, text


def test_drift_monitor_verdicts_equal_reference(profiles):
    X, margins, out = profiles
    prof = out["ref"][0]
    ref = _monitor_run("ref", prof, X, margins)
    port = _monitor_run("port", sketch.ReferenceProfile.from_json(
        prof.to_json()), X, margins)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert "c3" in port[0][1]["alerting"]
    assert any(e["ev"] == "drift_onset" for e in port[1])
    counters = port[2]["counters"]
    rep = drift.drift_report_from_counters(counters, prof)
    assert rep == ref_drift.drift_report_from_counters(counters, prof)


def test_process_global_drift_monitor_slot(profiles):
    prof = profiles[2]["port"][0]
    mon = drift.DriftMonitor(prof)
    try:
        assert drift.set_drift_monitor(mon) is mon
        assert drift.peek_drift_monitor() is mon
        assert drift.get_drift_monitor() is mon
        assert "mmlspark_tpu_drift" in tm.get_registry().render_prometheus()
    finally:
        drift.set_drift_monitor(None)
        mon.close()
    assert drift.peek_drift_monitor() is None


# -- SLO ----------------------------------------------------------------------


def _slo_run(name):
    """The same counter and gauge stream, sampled at the same injected
    times, through each package's SLOMonitor."""
    _, _, smod, _, pmod, tmod = PKGS[name]
    reg = tmod.MetricsRegistry()
    scoring, elastic = pmod.StageStats(), pmod.StageStats()
    scoring.incr("shed", 0)
    reg.register("scoring", scoring)
    reg.register("elastic", elastic)
    objectives = [
        smod.SLObjective("avail", 0.99, bad=(("scoring", "shed"),),
                         total=(("scoring", "rows"),
                                ("scoring", "shed"))),
        smod.SLObjective("hb", 0.9, gauge=("elastic",
                                           "heartbeat_age_ms"),
                         threshold=1000.0)]
    mon = smod.SLOMonitor(objectives, registry=reg, fast_window_s=10.0,
                          slow_window_s=40.0, fast_burn_threshold=2.0,
                          slow_burn_threshold=2.0)
    rng = np.random.default_rng(4)
    out = []
    for i in range(30):
        scoring.add_rows(int(rng.integers(50, 150)))
        if 8 <= i < 16:
            scoring.incr("shed", int(rng.integers(5, 40)))
        elastic.set_gauge("heartbeat_age_ms",
                          5000.0 if i % 3 == 0 else 10.0)
        mon.sample(now=float(2 * i))
        out.append(mon.evaluate())
    rep = mon.report()
    return out, {k: v for k, v in rep.items() if k != "ts"}, \
        mon.render_prometheus()


def test_slo_evaluations_equal_reference():
    ref, port = _slo_run("ref"), _slo_run("port")
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert any(v["avail"]["breach"] for v in port[0])
    names = [o.name for o in slo.default_objectives()]
    assert names == [o.name for o in ref_slo.default_objectives()]


def test_slo_monitor_thread_and_global_slot():
    mon = slo.SLOMonitor(registry=tm.MetricsRegistry())
    try:
        mon.start(tick_s=0.01)
        assert mon._thread is not None
    finally:
        mon.stop()
    n = len(mon._samples)
    mon.maybe_sample(min_interval_s=60.0)
    mon.maybe_sample(min_interval_s=60.0)
    assert len(mon._samples) == n + (0 if n else 1)
    prev = slo.get_monitor()
    try:
        assert slo.set_monitor(mon) is mon and slo.get_monitor() is mon
    finally:
        slo.set_monitor(prev)


# -- capacity -----------------------------------------------------------------


def _hinge(knee, baseline=20.0, slope=2.0, lo=10, hi=200, step=10):
    return [(float(x), baseline + (slope * (x - knee) if x > knee
                                   else 0.0))
            for x in range(lo, hi + 1, step)]


@pytest.mark.parametrize("case", ["clean", "noisy", "flat", "narrow",
                                  "collapse", "regime"])
def test_knee_estimates_equal_reference(case):
    def run(mod):
        kw = dict(rise_factor=6.0) if case == "collapse" else \
            dict(window=40, band=0.15, confirm=3) if case == "regime" \
            else dict(min_load_span=1.5) if case == "narrow" else {}
        est = mod.KneeEstimator(**kw)
        pts = {"clean": _hinge(100.0),
               "noisy": [(x, y * (1.0 + 0.1 * (-1) ** i)) for i, (x, y)
                         in enumerate(_hinge(80.0, 10.0, 1.5, 10, 160,
                                             5))],
               "flat": [(float(x), 20.0) for x in range(10, 200, 10)],
               "narrow": [(100.0 + i, 20.0 + i) for i in range(20)],
               "collapse": [(float(x), 1.0 + 0.02 * x)
                            for x in range(10, 101, 10)]
               + [(90.0, 180.0), (80.0, 320.0), (70.0, 410.0),
                  (65.0, 430.0)],
               "regime": _hinge(100.0, lo=10, hi=200, step=5)}[case]
        for x, y in pts:
            est.observe(x, y)
        got = [est.raw_estimate(), est.update()]
        if case == "regime":
            for x, y in _hinge(50.0, lo=10, hi=200, step=5):
                est.observe(x, y)
            got += [est.update() for _ in range(4)]
        return got + [est.knee]

    port, ref = run(capacity), run(ref_capacity)
    assert port == ref
    if case in ("clean", "regime"):
        assert port[0] == pytest.approx(100.0, rel=0.15)


class _OneNs:
    def __init__(self, ns, stats):
        self.ns, self.stats = ns, stats

    def snapshot(self):
        return {self.ns: self.stats.snapshot()}


def _capacity_run(name):
    _, _, _, cmod, pmod, _ = PKGS[name]
    stats = pmod.StageStats()
    est = cmod.KneeEstimator(confirm=10 ** 9)
    for x, y in _hinge(100.0):
        est.observe(x, y)
    est.update()
    mon = cmod.CapacityMonitor(
        registry=_OneNs("scoring", stats), window_s=1.0, min_dt_s=0.4,
        onset_ticks=2, clear_ticks=2,
        resources=(cmod.ResourceSpec("scoring", "scoring", ("e2e",)),),
        estimators={"scoring": est})
    t, out = 2000.0, []
    mon.sample(now=t)
    for rows in (50, 96, 96, 0, 0, 40):
        t += 1.0
        stats.add_rows(rows)
        for _ in range(5):
            stats.timer("e2e").record(0.02)
        mon.sample(now=t)
        snap = mon.snapshot()
        out.append({"counters": snap["counters"],
                    "gauges": {k: v for k, v in snap["gauges"].items()
                               if not k.startswith(("busy_", "load_"))}})
    return out


def test_capacity_monitor_ticks_equal_reference():
    port, ref = _capacity_run("port"), _capacity_run("ref")
    assert port == ref
    assert port[2]["gauges"]["saturated_scoring"] == 1.0


def test_capacity_exposition_statusz_and_sampler():
    mon = capacity.CapacityMonitor(registry=_OneNs("scoring",
                                                   profiling.StageStats()))
    rmon = ref_capacity.CapacityMonitor(registry=_OneNs(
        "scoring", ref_profiling.StageStats()))
    for m in (mon, rmon):
        m.stats.set_gauge("headroom_scoring", 0.8)
        m.stats.set_gauge("knee_scoring", 120.0)
        m.stats.set_gauge("busy_train.host_iter", 0.4)
    assert mon.render_prometheus() == rmon.render_prometheus()
    prev = capacity.peek_capacity_monitor()
    try:
        capacity.set_capacity_monitor(mon)
        text = capacity.render_statusz({"version": 3})
        assert "== capacity headroom ==" in text and "version: 3" in text
        assert text.splitlines()[0] == "mmlspark_tpu statusz"
        sampler = capacity.ensure_capacity_sampler(interval_s=0.01)
        assert sampler is not None
    finally:
        m = capacity.peek_capacity_monitor()
        if m is not None:
            m.stop()
        if prev is not None:
            capacity.set_capacity_monitor(prev)
    assert [r.name for r in capacity.default_resources()] == \
        [r.name for r in ref_capacity.default_resources()]
    stats = profiling.StageStats()
    mon = capacity.CapacityMonitor(
        registry=_OneNs("scoring", stats), window_s=1.0, min_dt_s=0.4,
        resources=(capacity.ResourceSpec("scoring", "scoring", ("e2e",)),))
    prev = capacity.configure()
    try:
        assert capacity.configure(enabled=False) is False
        assert capacity.capacity_enabled() is False
        mon.sample(now=1.0)
        stats.add_rows(100)
        mon.sample(now=2.0)
        assert "load_scoring" not in mon.snapshot()["gauges"]
    finally:
        capacity.configure(enabled=prev)
