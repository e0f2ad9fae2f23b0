"""The port's telemetry core against the reference's, on the same inputs.

``mmlspark_tpu_torch/core/telemetry.py``, ``profiling.py``, ``profiler.py``,
``debug.py``, ``utils.py`` and the copied tools (``tools/trace_report.py``,
``tools/perf_report.py``) beside ``mmlspark_tpu/core``'s:

* the Prometheus exposition of identically recorded stats sources, and
  :func:`merge_snapshots` of identical snapshots, are byte-equal /
  equal in both packages (the reference's float formatting and label
  escaping are copied, not rewritten);
* one event stream round-trips through both packages' ``read_journal``
  (torn tail included);
* the log-bucket ladder, the percentile estimator and the stage
  snapshots agree;
* the profiler's phases, spans, build ledger (the port's replacement of
  the jax compile ledger), sampler, exposition and flight records, and
  its card watermarks — which never start CUDA;
* the debug checks raise the port's named error only in debug mode.

No wall-clock ratio is asserted here.
"""

import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import profiling as ref_profiling
from mmlspark_tpu.core import telemetry as ref_tm
from mmlspark_tpu_torch.core import debug, profiling, telemetry as tm
from mmlspark_tpu_torch.core import utils
from mmlspark_tpu_torch.core.profiler import (Profiler, device_wait,
                                              get_profiler)
from mmlspark_tpu_torch.tools import perf_report, trace_report

_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{([^}]*)\})?"
    r" (-?(?:[0-9]*\.)?[0-9]+(?:[eE][+-]?[0-9]+)?|NaN|[+-]Inf)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    """Every non-comment line must be ``name{labels} value``; returns
    ``{(name, frozenset(labels)): value}`` (the reference tests'
    parser)."""
    out = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _LINE.match(line)
        assert m, f"invalid exposition line: {line!r}"
        name, labels_raw, value = m.groups()
        labels = {}
        if labels_raw:
            consumed = _LABEL.findall(labels_raw)
            assert ",".join(f'{k}="{v}"' for k, v in consumed) \
                == labels_raw, labels_raw
            labels = dict(consumed)
        out[(name, frozenset(labels.items()))] = float(value)
    return out


def _fill(stats, seed):
    """Record one seeded stream of counters, gauges, stage latencies and
    rows into a StageStats of either package."""
    rng = np.random.default_rng(seed)
    for name in ("shed", "salvaged", 'e"v\\x'):
        stats.incr(name, int(rng.integers(0, 50)))
    stats.incr("zero", 0)
    for name, v in (("depth", 7.5), ("worst_age", float("inf")),
                    ("neg", float("-inf")), ("ratio", 1 / 3),
                    ("big", 1.5e17), ("tiny", 2.5e-9),
                    ("queue_depth", float(rng.integers(0, 9))),
                    ("worker_up", float(rng.integers(0, 2)))):
        stats.set_gauge(name, v)
    for stage in ("decode", "score", "reply"):
        t = stats.timer(stage)
        for x in rng.lognormal(-6.0, 1.5, size=40):
            t.record(float(x))
    t = stats.timer("overflow")
    t.record(1e4)


def _pair(seed):
    a, b = ref_profiling.StageStats(), profiling.StageStats()
    _fill(a, seed)
    _fill(b, seed)
    return a, b


def _stable(snap):
    """A StageStats snapshot without its clock-dependent rows/s."""
    return {k: v for k, v in snap.items() if k != "rows_per_s"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_prometheus_equals_reference(seed):
    regs = []
    a, b = _pair(seed)
    for reg_cls, stats in ((ref_tm.MetricsRegistry, a),
                           (tm.MetricsRegistry, b)):
        reg = reg_cls()
        reg.register("scoring", stats)
        reg.register('we"ird\\ns', stats)
        regs.append(reg.render_prometheus())
    assert regs[0] == regs[1]
    parse_prometheus(regs[1])
    snaps = {"ns1": _stable(a.snapshot()), "x\ny": {"counters": {"e": 1}}}
    assert tm.render_prometheus(snaps) == ref_tm.render_prometheus(snaps)
    assert tm.render_prometheus(snaps, prefix="other") == \
        ref_tm.render_prometheus(snaps, prefix="other")
    assert tm.PREFIX == ref_tm.PREFIX == "mmlspark_tpu"


def test_formatting_and_escaping_helpers_equal_reference():
    for v in (0, 1, -3, 2.5, 1 / 3, 1e-12, 1.5e300, float("inf"),
              float("-inf"), float("nan"), True, np.float32(0.1),
              np.int64(7), "1.25", None):
        try:
            ref = ref_tm._fmt(v)
        except Exception as e:  # noqa: BLE001 - both must fail alike
            with pytest.raises(type(e)):
                tm._fmt(v)
            continue
        assert tm._fmt(v) == ref, v
    for s in ('plain', 'q"uote', 'back\\slash', 'new\nline', 7):
        assert tm._esc(s) == ref_tm._esc(s)
    lab = {"b": 'x"y', "a": 1, "le": "+Inf"}
    assert tm._labels(lab) == ref_tm._labels(lab)


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_snapshots_equals_reference(seed):
    snaps = []
    for s in range(3):
        a, b = _pair(seed * 10 + s)
        a.add_rows(100 + s)
        snaps.append(_stable(a.snapshot()))
    snaps.append({"gauges": {"exchange_link_up": 0.0,
                             "fanout_inflight": 2.0},
                  "counters": {"shed": 4}})
    assert tm.merge_snapshots(snaps) == ref_tm.merge_snapshots(snaps)
    for name in ("queue_depth", "fanout_inflight", "shards_awaited",
                 "replies_depth", "worker_up", "worker_busy",
                 "headroom_scoring", "heartbeat_age_ms", "link_up"):
        assert tm.gauge_merge_mode(name) == ref_tm.gauge_merge_mode(name)


def test_registry_semantics_follow_reference():
    class Bad:
        def snapshot(self):
            raise RuntimeError("broken source")

    for mod in (ref_tm, tm):
        reg = mod.MetricsRegistry()
        a = profiling.StageStats()
        a.incr("x", 2)
        reg.register("ns1", profiling.StageStats())
        reg.register("ns1", a)              # newest wins
        reg.register("bad", Bad())          # skipped, not fatal
        reg.register_exposition("extra", lambda: "# extra\n")
        reg.register_exposition("broken", lambda: 1 / 0)
        snap = reg.snapshot()
        assert snap["ns1"]["counters"]["x"] == 2 and "bad" not in snap
        assert "# extra" in reg.render_prometheus()
        reg.unregister("ns1")
        reg.unregister_exposition("extra")
        assert reg.namespaces() == ["bad"]


def test_latency_ladder_and_percentiles_equal_reference():
    rng = np.random.default_rng(5)
    xs = np.concatenate([rng.lognormal(-7, 2, 500), [0.0, 1e-9, 1e3]])
    assert profiling.LE_STRS == ref_profiling.LE_STRS
    for x in xs:
        assert profiling.bucket_index(float(x)) == \
            ref_profiling.bucket_index(float(x))
    a, b = ref_profiling.LatencyStats(), profiling.LatencyStats()
    for x in xs:
        a.record(float(x))
        b.record(float(x))
    sa, sb = a.snapshot(), b.snapshot()
    assert sa == sb
    for q in (1, 50, 90, 99, 100):
        assert profiling.percentile_from_buckets(sb["buckets"], q) == \
            ref_profiling.percentile_from_buckets(sa["buckets"], q)
        assert b.percentile(q) == a.percentile(q)


def test_stage_stats_surface_equals_reference():
    a, b = _pair(9)
    for s in (a, b):
        s.add_rows(10)
        s.add_rows(30)
        with s.time("ctx"):
            pass
        s.adopt("shared", s.timer("score"))
    sa, sb = a.snapshot(), b.snapshot()
    assert sa.keys() == sb.keys()
    assert sb["rows"] == sa["rows"] == b.rows == 40
    assert sb["counters"] == sa["counters"]
    assert sb["gauges"] == sa["gauges"]
    for k in ("decode", "score", "reply", "overflow", "shared"):
        assert sb["stages"][k] == sa["stages"][k]
    assert sb["stages"]["ctx"]["count"] == 1
    assert b.counter("shed") == a.counter("shed")
    assert b.gauge("missing", 4.0) == 4.0
    assert b.rows_per_s() >= 0.0


# -- the journal --------------------------------------------------------------


def test_journal_round_trips_through_both_readers(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = tm.EventJournal(capacity=64, path=path)
    for i in range(20):
        j.emit("boost_chunk", fit="abc", it_start=i, it_end=i + 1,
               train_loss=0.5 / (i + 1), note=f'q"{i}\n')
    with j.span("phase", fit="abc"):
        pass
    j.configure(None)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"ts": 1.0, "ev": "torn"')      # a crash's torn tail
    mine, theirs = tm.read_journal(path), ref_tm.read_journal(path)
    assert mine == theirs == j.events()
    assert [e["ev"] for e in mine][-2:] == ["phase_begin", "phase_end"]
    assert [e["seq"] for e in mine] == list(range(1, 23))
    dump = str(tmp_path / "dump.jsonl")
    assert j.dump(dump) == 22
    assert ref_tm.read_journal(dump) == mine


def test_journal_is_bounded_rotates_and_mirrors_from_env(tmp_path,
                                                         monkeypatch):
    j = tm.EventJournal(capacity=5)
    for i in range(12):
        j.emit("e", i=i)
    assert [e["i"] for e in j.events()] == list(range(7, 12))
    assert [e["i"] for e in j.tail(2)] == [10, 11]
    j.clear()
    assert j.events() == []
    path = str(tmp_path / "rot.jsonl")
    j.configure(path, max_bytes=400)
    for i in range(40):
        j.emit("e", i=i)
    j.configure(None)
    kept = ref_tm.read_journal(path + ".1") + ref_tm.read_journal(path)
    assert [e["i"] for e in kept] == list(range(kept[0]["i"], 40))
    monkeypatch.setenv(tm.JOURNAL_DIR_ENV, str(tmp_path / "jd"))
    try:
        mirror = tm.mirror_journal_from_env("worker")
        tm.get_journal().emit("hello")
        assert ref_tm.read_journal(mirror)[-1]["ev"] == "hello"
    finally:
        tm.get_journal().configure(None)
    monkeypatch.delenv(tm.JOURNAL_DIR_ENV)
    assert tm.mirror_journal_from_env() is None


def test_trace_identity_and_host_info():
    ids = {tm.new_trace_id() for _ in range(50)}
    assert len(ids) == 50 and all(re.fullmatch(r"[0-9a-f]{16}", i)
                                  for i in ids)
    assert tm.host_info().keys() == ref_tm.host_info().keys()
    assert tm.current_fit_span() is None
    tm.set_current_fit_span("span1")
    try:
        assert tm.current_fit_span() == "span1"
    finally:
        tm.set_current_fit_span(None)


# -- the profiler -------------------------------------------------------------


def test_profiler_phases_spans_and_disabled_noop():
    p = Profiler(enabled=True)
    for x in (0.001, 0.002, 0.004):
        p.record_phase("train.host_iter", x)
    with p.phase("ctx"):
        pass
    seq0 = tm.get_journal().events()[-1]["seq"] \
        if tm.get_journal().events() else 0
    p.span("quick", 0.001)                       # below the journal bar
    p.span("forced", 0.001, journal=True, it=3)
    p.span("slow", 0.2, record=False)
    snap = p.snapshot()
    st = snap["phases"]["stages"]
    assert st["train.host_iter"]["count"] == 3
    assert st["ctx"]["count"] == 1 and "slow" not in st
    spans = [e for e in tm.get_journal().events()
             if e["ev"] == "profile_span" and e["seq"] > seq0]
    assert [e["phase"] for e in spans] == ["forced", "slow"]
    assert spans[0]["it"] == 3 and spans[1]["dur_ms"] == 200.0
    off = Profiler(enabled=False)
    off.record_phase("x", 1.0)
    off.dispatch("site", 1.0, 1.0)
    off.record_build("nvcc_build", 1.0)
    with off.phase("y"):
        pass
    s = off.snapshot()
    assert s["phases"]["stages"] == {} and s["dispatch"] == {}
    assert s["compile_seq"] == 0 and s["build_events"] == {}
    assert off.configure(enabled=True).enabled


def test_profiler_timer_and_alias_share_histograms():
    p = Profiler(enabled=True)
    t = p.timer("train.host_iter")
    assert p.timer("train.host_iter") is t
    t.record(0.002)
    own = profiling.LatencyStats()
    own.record(0.004)
    p.alias("scoring.score", own)
    own.record(0.008)                  # recorded by its owner only
    st = p.snapshot()["phases"]["stages"]
    assert st["train.host_iter"]["count"] == 1
    assert st["scoring.score"]["count"] == 2


def test_build_ledger_classifies_dispatches_hit_vs_miss():
    p = Profiler(enabled=True)
    seq = p.compile_seq()
    p.record_build("nvcc_build", 2.5)       # a call that built a kernel
    p.record_build("cuda_load", 0.01)
    p.dispatch("train.boost_chunk", 0.1, 0.2, p.compile_seq() - seq)
    seq = p.compile_seq()
    p.dispatch("train.boost_chunk", 0.1, 0.2, p.compile_seq() - seq)
    p.count_dispatch("other")
    snap = p.snapshot()
    assert snap["dispatch"] == {"train.boost_chunk":
                                {"hits": 1, "misses": 1},
                                "other": {"hits": 1, "misses": 0}}
    assert snap["build_events"] == {
        "nvcc_build": {"count": 1, "total_s": 2.5},
        "cuda_load": {"count": 1, "total_s": 0.01}}
    assert snap["compile_seq"] == 2
    st = snap["phases"]["stages"]
    assert st["train.boost_chunk.dispatch_host"]["count"] == 2
    assert st["train.boost_chunk.device_wait"]["count"] == 2
    led = perf_report.compile_ledger(snap)
    assert led["backend_compiles"] == 1
    assert led["compile_seconds_total"] == 2.5
    assert led["sites"]["train.boost_chunk"]["hit_ratio"] == 0.5
    # a reference snapshot's jax events read alike
    ref_led = perf_report.compile_ledger(
        {"jax_events": {"backend_compile": {"count": 3, "total_s": 1.0}}})
    assert ref_led["backend_compiles"] == 3


def test_profiler_exposition_parses_and_joins_the_registry():
    p = Profiler(enabled=True)
    p.record_phase("train.host_iter", 0.003)
    p.dispatch("train.boost_chunk", 0.01, 0.02, 1)
    p.record_build("native_build", 0.4)
    p.record_memory("cuda:0", "bytes_in_use", 1024)
    text = p.render_prometheus()
    parsed = parse_prometheus(text)
    names = {n for n, _ in parsed}
    for fam in ("enabled", "phase_seconds_bucket", "phase_seconds_sum",
                "phase_seconds_count", "dispatch_total",
                "build_events_total", "build_seconds_total",
                "memory_bytes", "sampler_samples_total"):
        assert f"mmlspark_tpu_profile_{fam}" in names, fam
    assert parsed[("mmlspark_tpu_profile_memory_bytes",
                   frozenset({"device": "cuda:0",
                              "kind": "bytes_in_use"}.items()))] == 1024
    totals = perf_report.parse_stage_totals(text)
    assert totals["train.host_iter"]["count"] == 1
    assert "mmlspark_tpu_profile_enabled" in \
        tm.get_registry().render_prometheus()
    assert get_profiler() is get_profiler()


def test_stack_sampler_collapses_and_stops():
    p = Profiler(enabled=True)
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(range(200))

    t = threading.Thread(target=busy, name="probe-worker", daemon=True)
    t.start()
    try:
        p.start_sampler(hz=200.0, thread_prefixes=("probe-",),
                        max_stacks=2)
        deadline = time.time() + 10
        while p.snapshot()["sampler"]["samples"] < 5 \
                and time.time() < deadline:
            time.sleep(0.02)
    finally:
        p.stop_sampler()
        stop.set()
        t.join(5)
    lines = p.flamegraph_lines()
    assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
    assert all(ln.startswith(("probe-worker;", "<overflow>"))
               for ln in lines)
    assert len([ln for ln in lines if not ln.startswith("<")]) <= 2
    assert p._sampler_thread is None


def test_card_watermarks_never_start_cuda(monkeypatch):
    """sample_memory reads each visible card only in a process that has
    started CUDA; otherwise it touches nothing of torch.cuda (a CPU
    scorer's metrics scrape must not take the card)."""
    calls = []

    def forbidden(*a, **k):
        calls.append(a)
        raise AssertionError("torch.cuda read in a process without CUDA")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("device_count", "memory_allocated",
                 "max_memory_allocated", "get_device_properties",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    p = Profiler(enabled=True)
    p.sample_memory(min_interval_s=0.0)
    p.snapshot()
    p.render_prometheus()
    device_wait()
    device_wait([torch.device("cpu")])
    assert calls == [] and p.snapshot()["memory_bytes"] == {}

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda i: 100 + i)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i: 200 + i)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    p.sample_memory(min_interval_s=0.0)
    assert p.snapshot()["memory_bytes"] == {
        "cuda:0/bytes_in_use": 100.0, "cuda:0/peak_bytes_in_use": 200.0,
        "cuda:0/bytes_limit": float(80 << 30),
        "cuda:1/bytes_in_use": 101.0, "cuda:1/peak_bytes_in_use": 201.0,
        "cuda:1/bytes_limit": float(80 << 30)}


# -- the flight recorder ------------------------------------------------------


def test_flight_record_holds_tail_metrics_profile_and_rotates(tmp_path):
    d = str(tmp_path / "fr")
    tm.configure_flight_recorder(directory=d, cap=2, min_interval_s=0.0)
    try:
        tm.get_journal().emit("fit_begin", fit="f1")
        get_profiler().record_memory("cuda:0", "bytes_limit", 7.0)
        tm.set_current_fit_span("f1")
        paths = [tm.record_flight(f"reason{i}", {"k": i})
                 for i in range(3)]
        tm.set_current_fit_span(None)
        assert all(paths) and len(os.listdir(d)) == 2
        with open(paths[-1]) as fh:
            rec = json.load(fh)
        assert rec["reason"] == "reason2" and rec["context"] == {"k": 2}
        assert rec["fit_span"] == "f1"
        assert rec["journal_tail"][-1]["ev"] == "fit_begin"
        assert "mmlspark_tpu_profile_enabled" in rec["metrics_exposition"]
        assert rec["profile"]["memory_bytes"]["cuda:0/bytes_limit"] == 7.0
        assert rec["threads"]
        tm.configure_flight_recorder(min_interval_s=60.0)
        assert tm.record_flight("throttled") is not None
        assert tm.record_flight("throttled") is None
    finally:
        tm.configure_flight_recorder(directory=os.environ.get(
            tm.FLIGHTREC_DIR_ENV, "artifacts"), cap=8, min_interval_s=5.0)


# -- traces and tools ---------------------------------------------------------


def test_summarize_trace_reads_the_ports_chrome_traces(tmp_path):
    assert profiling.summarize_trace(str(tmp_path)) == []
    card = {"traceEvents": [
        {"ph": "X", "pid": 0, "name": "hist_full", "dur": 1500,
         "cat": "kernel"},
        {"ph": "X", "pid": 0, "name": "hist_full", "dur": 500,
         "cat": "kernel"},
        {"ph": "X", "pid": 0, "name": "Memcpy DtoH", "dur": 250,
         "cat": "gpu_memcpy"},
        {"ph": "X", "pid": 9, "name": "aten::add", "dur": 9e6,
         "cat": "cpu_op"}]}
    with open(tmp_path / "fit_1_2.trace.json", "w") as fh:
        json.dump(card, fh)
    assert profiling.summarize_trace(str(tmp_path)) == [
        (2.0, "hist_full"), (0.25, "Memcpy DtoH"),
        (2.25, "total_device_ms")]
    cpu = {"traceEvents": [
        {"ph": "X", "pid": 3, "name": "a", "dur": 100},
        {"ph": "X", "pid": 4, "name": "b", "dur": 700},
        {"ph": "X", "pid": 4, "name": "c", "dur": 300}]}
    newer = tmp_path / "sub" / "fit_0_3.trace.json"
    newer.parent.mkdir()
    with open(newer, "w") as fh:
        json.dump(cpu, fh)
    later = time.time() + 5
    os.utime(newer, (later, later))
    assert profiling.summarize_trace(str(tmp_path)) == [
        (0.7, "b"), (0.3, "c"), (1.0, "total_device_ms")]


def test_maybe_trace_writes_a_chrome_trace_summarize_reads(tmp_path):
    with profiling.maybe_trace(None):
        pass
    assert not os.listdir(tmp_path)
    with profiling.maybe_trace(str(tmp_path / "tr")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (name,) = os.listdir(tmp_path / "tr")
    assert name.startswith("fit_") and name.endswith(".trace.json")
    rows = profiling.summarize_trace(str(tmp_path / "tr"))
    assert rows[-1][1] == "total_device_ms" and rows[-1][0] > 0


def test_trace_report_and_perf_report_read_a_port_journal(tmp_path,
                                                          capsys):
    path = str(tmp_path / "j.jsonl")
    j = tm.EventJournal(path=path)
    j.emit("fit_begin", fit="aa")
    j.emit("profile_span", phase="train.boost_chunk", dur_ms=12.5,
           fit="aa", it=0)
    for it in range(0, 50, 25):
        j.emit("boost_chunk", fit="aa", it_start=it, it_end=it + 25)
    j.emit("ckpt_saved", fit="aa", it=25, n_chunks=1)
    j.emit("fit_end", fit="aa", dur_s=1.0, trees=50)
    j.emit("fit_begin", fit="bb")
    j.configure(None)
    events = trace_report.load_events([path])
    rep = trace_report.timeline_report(events, fit="aa")
    assert rep["schema"] == "mmlspark_tpu.trace_timeline/v1"
    assert json.loads(json.dumps(rep)) == rep
    assert rep["fits"] == ["aa", "bb"]
    assert rep["fit"]["complete"] is True
    assert [e["ev"] for e in rep["fit"]["events"]] == [
        "fit_begin", "profile_span", "boost_chunk", "boost_chunk",
        "ckpt_saved", "fit_end"]
    assert trace_report.fit_timeline(events)["fit"] == "bb"
    assert trace_report.main([path, "--fit", "aa", "--format",
                              "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fit"]["fit"] == "aa"
    assert trace_report.main([path, "--fit", "latest"]) == 0
    assert "fit span=bb" in capsys.readouterr().out
    p = Profiler(enabled=True)
    p.record_phase("train.boost_chunk", 0.5)
    art = {"telemetry": {"profile": p.snapshot(),
                         "metrics_exposition": p.render_prometheus()}}
    rep = perf_report.build_report(art, [path])
    assert rep["journal_costs"]["profile_span:train.boost_chunk"][
        "total_ms"] == 12.5
    assert rep["attribution"]["top_phases"][0]["phase"] == \
        "train.boost_chunk"
    art_path = tmp_path / "art.json"
    art_path.write_text(json.dumps(art))
    assert perf_report.main([str(art_path), "--journal", path]) == 0
    assert "compile ledger" in capsys.readouterr().out


# -- debug mode and the utilities ---------------------------------------------


def test_debug_checks_raise_the_named_error_only_in_debug_mode():
    bad = torch.tensor([[0.5, float("nan"), 1.0]])
    codes = torch.tensor([[0, 3], [7, 2]], dtype=torch.int32)
    prev = debug.debug_enabled()
    try:
        debug.debug_mode(False)
        debug.check_finite("gradients/hessians", bad)
        debug.check_bins_in_range(codes, 4)
        debug.debug_mode(True)
        with pytest.raises(debug.DebugCheckError, match="non-finite"):
            debug.check_finite("gradients/hessians", bad)
        with pytest.raises(debug.DebugCheckError, match="out of range"):
            debug.check_bins_in_range(codes, 4)
        with pytest.raises(debug.DebugCheckError):
            debug.check_bins_in_range(torch.tensor([[-1]]), 4)
        debug.check_finite("ok", torch.ones(3), np.zeros(2))
        debug.check_bins_in_range(torch.tensor([[0, 3]],
                                               dtype=torch.uint8), 4)
        fn = debug.checked(len)
        assert fn is len
    finally:
        debug.debug_mode(prev)
    assert issubclass(debug.DebugCheckError, RuntimeError)


def test_utils_report_the_cpu_topology_and_retry():
    assert utils.ClusterUtil.get_num_processes() == 1
    assert utils.ClusterUtil.get_process_index() == 0
    assert utils.ClusterUtil.get_default_platform() in ("cpu", "gpu")
    assert utils.ClusterUtil.get_num_devices() >= 1
    tree = {"a": [torch.ones(2), 3], "b": "x"}
    assert utils.block_until_ready(tree) is tree
    n = {"calls": 0}

    def flaky():
        n["calls"] += 1
        if n["calls"] < 3:
            raise OSError("blip")
        return 7

    assert utils.FaultToleranceUtils.retry_with_timeout(
        flaky, retries=3, backoff_s=0.0) == 7
    with pytest.raises(ValueError):
        utils.FaultToleranceUtils.retry_with_timeout(
            lambda: (_ for _ in ()).throw(ValueError("x")), retries=2,
            backoff_s=0.0)
    w = utils.StopWatch()
    assert w.elapsed() >= 0.0 and w.restart() >= 0.0


_NO_JAX = r"""
import json, sys
before = set(sys.modules)
import mmlspark_tpu_torch.core
import mmlspark_tpu_torch.core.capacity
import mmlspark_tpu_torch.core.debug
import mmlspark_tpu_torch.core.profiler
import mmlspark_tpu_torch.core.slo
import mmlspark_tpu_torch.tools.perf_report
new = set(sys.modules) - before
print(json.dumps(sorted(m for m in new if m.split(".")[0] in
                        ("jax", "jaxlib", "mmlspark_tpu"))))
"""


def test_port_observability_modules_import_no_jax(tmp_path):
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _NO_JAX],
                         env=dict(os.environ, PYTHONPATH=root),
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
