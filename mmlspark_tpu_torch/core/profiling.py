"""Latency histograms, stage statistics and device traces.

The port's counterpart of ``mmlspark_tpu/core/profiling.py``:

* :class:`LatencyStats` — a thread-safe streaming accumulator over a
  FIXED log-bucketed histogram: counts per logarithmic latency bucket,
  so two workers' snapshots MERGE exactly (bucket counts sum;
  percentiles recompute from the summed buckets with
  :func:`percentile_from_buckets`).
* :class:`StageStats` — named stages, event counters, point-in-time
  gauges and a rows counter: the surface ``engine.train_stats``, the
  elastic watchdog's ``stats`` and the profiler's phases share.
* :func:`trace` / :func:`maybe_trace` (``profileTraceDir``) — a
  ``torch.profiler`` recording of the wrapped region (the host, and the
  card's kernels when CUDA is available) written as one Chrome trace
  (``chrome://tracing`` / Perfetto) per region; the reference records a
  ``jax.profiler`` trace.
* :func:`summarize_trace` — per-op device-time totals of the newest
  trace in a directory, read without TensorBoard.

The ladder, the histogram and the snapshot schema are the reference's,
line for line.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import threading
import time
from bisect import bisect_left
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

# -- log-bucket ladder -------------------------------------------------------

#: multiplicative bucket growth: 2**0.25 bounds the relative error of a
#: bucket-midpoint percentile estimate to ~±9% — tight enough for an SLO
#: readout, coarse enough that a stage's occupied buckets stay few
HIST_GROWTH = 2.0 ** 0.25
#: lowest bucket upper bound (10 µs); the top finite bound is
#: ``HIST_GROWTH**(HIST_BUCKETS-1)`` above it (~300 s) — everything
#: slower lands in the +Inf overflow bucket
HIST_FLOOR = 1e-5
HIST_BUCKETS = 100

#: upper (``le``) bounds of the finite buckets, ascending
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    HIST_FLOOR * HIST_GROWTH ** i for i in range(HIST_BUCKETS))
#: stable string keys for the bucket bounds — the wire/snapshot
#: representation (identical across processes because the ladder is a
#: module constant, never computed from data)
LE_STRS: Tuple[str, ...] = tuple(
    format(b, ".6g") for b in BUCKET_BOUNDS) + ("+Inf",)
_LE_INDEX = {s: i for i, s in enumerate(LE_STRS)}


def bucket_index(seconds: float) -> int:
    """Index into ``LE_STRS`` of the bucket holding ``seconds`` (the
    first bound >= the value; the last index is the +Inf overflow)."""
    return bisect_left(BUCKET_BOUNDS, seconds)


def _bucket_mid(i: int) -> float:
    """Representative value (geometric midpoint) for bucket ``i`` —
    the percentile estimate returned for ranks landing in it."""
    if i >= HIST_BUCKETS:                       # +Inf overflow
        return BUCKET_BOUNDS[-1] * math.sqrt(HIST_GROWTH)
    return BUCKET_BOUNDS[i] / math.sqrt(HIST_GROWTH)


def percentile_from_buckets(buckets: Dict[str, int], q: float) -> float:
    """q-th percentile (0-100), in seconds, of a sparse ``{le: count}``
    bucket dict (the ``snapshot()["buckets"]`` shape).  Deterministic in
    the bucket counts alone, so summing two sources' buckets and calling
    this is EXACTLY the percentile of the combined population at the
    ladder's resolution — the property ``merge_snapshots`` relies on."""
    total = 0
    per_idx: List[Tuple[int, int]] = []
    for le, c in buckets.items():
        i = _LE_INDEX.get(le)
        if i is None or not c:
            continue
        per_idx.append((i, int(c)))
        total += int(c)
    if total <= 0:
        return 0.0
    rank = max(1, math.ceil(q / 100.0 * total))
    cum = 0
    for i, c in sorted(per_idx):
        cum += c
        if cum >= rank:
            return _bucket_mid(i)
    return _bucket_mid(per_idx[-1][0] if per_idx else 0)


class LatencyStats:
    """Thread-safe streaming latency accumulator over the fixed
    log-bucket ladder.

    Keeps exact count/total plus one integer per occupied bucket —
    O(1) per record, bounded memory, and (unlike the sample ring it
    replaced) MERGEABLE: ``snapshot()["buckets"]`` from any number of
    workers can be key-wise summed and the percentiles recomputed
    exactly for the combined population.

    Two views coexist: the CUMULATIVE buckets (the exposition's
    ``_bucket`` rows and the merge representation — Prometheus
    consumers ``rate()`` them for any window they like), and a
    RECENT-WINDOW pair of bucket epochs rotated every
    ``window_s`` seconds that the ``p50_ms``/``p99_ms`` snapshot keys
    are estimated from — a latency SLO watches *current* tail latency,
    and a lifetime-cumulative estimate would dilute a regression under
    millions of historical fast samples (the property the old sample
    ring had, kept).  ``capacity`` is accepted and ignored for
    backward compatibility with the ring-buffer signature.
    """

    #: half-window for the recent-percentile epochs: estimates span
    #: the last 1-2 windows' samples
    WINDOW_S = 60.0

    __slots__ = ("_lock", "_count", "_total", "_buckets", "_recent",
                 "_prev", "_epoch_t")

    def __init__(self, capacity: int = 4096):
        del capacity                    # ring-era knob, no longer used
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._buckets = [0] * len(LE_STRS)
        self._recent = [0] * len(LE_STRS)
        self._prev = [0] * len(LE_STRS)
        self._epoch_t = time.monotonic()

    def _roll_locked(self) -> None:
        elapsed = time.monotonic() - self._epoch_t
        if elapsed < self.WINDOW_S:
            return
        if elapsed >= 2 * self.WINDOW_S:
            # a traffic gap longer than the whole window: BOTH epochs
            # are stale — shifting would present the pre-gap epoch as
            # "recent" for another window
            self._prev = [0] * len(LE_STRS)
        else:
            self._prev = self._recent
        self._recent = [0] * len(LE_STRS)
        self._epoch_t = time.monotonic()

    def record(self, seconds: float) -> None:
        i = bucket_index(seconds)
        with self._lock:
            self._roll_locked()
            self._count += 1
            self._total += seconds
            self._buckets[i] += 1
            self._recent[i] += 1

    @property
    def count(self) -> int:
        return self._count

    def _window_counts_locked(self):
        """Recent-window bucket counts (last 1-2 epochs), falling back
        to the cumulative buckets when the window is empty (e.g. right
        after a rotation with no fresh traffic) so percentiles degrade
        to the lifetime estimate instead of reading 0."""
        self._roll_locked()
        window = [a + b for a, b in zip(self._recent, self._prev)]
        return window if any(window) else list(self._buckets)

    def percentile(self, q: float) -> float:
        """q-th percentile (0-100) over the recent window, in seconds
        (bucket-midpoint estimate, ~±9% relative; same estimator as
        ``snapshot()`` — both delegate to
        :func:`percentile_from_buckets`)."""
        with self._lock:
            counts = self._window_counts_locked()
        return percentile_from_buckets(
            {LE_STRS[i]: c for i, c in enumerate(counts) if c}, q)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            count, total = self._count, self._total
            counts = list(self._buckets)
            window = self._window_counts_locked()
        sparse = {LE_STRS[i]: c for i, c in enumerate(counts) if c}
        wsparse = {LE_STRS[i]: c for i, c in enumerate(window) if c}
        return {
            "count": count,
            "total_s": round(total, 6),
            "mean_ms": round(total / count * 1e3, 4) if count else 0.0,
            "p50_ms": round(
                percentile_from_buckets(wsparse, 50) * 1e3, 4),
            "p99_ms": round(
                percentile_from_buckets(wsparse, 99) * 1e3, 4),
            "buckets": sparse,
        }


class StageStats:
    """Named :class:`LatencyStats` per pipeline stage + a rows counter.

    The scoring engine instruments every hop (queue wait, decode, score,
    reply, end-to-end) through one of these; ``snapshot()`` is the
    JSON-able stats surface ``ScoringEngine.stats()`` exposes and
    the profiler and the training counters share.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, LatencyStats] = {}
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._rows = 0
        self._t_first: Optional[float] = None
        self._t_last = 0.0

    def timer(self, stage: str) -> LatencyStats:
        with self._lock:
            stats = self._stages.get(stage)
            if stats is None:
                stats = self._stages[stage] = LatencyStats()
            return stats

    def adopt(self, stage: str, stats: LatencyStats) -> None:
        """Expose an EXISTING :class:`LatencyStats` under ``stage`` —
        the histogram object is SHARED, not copied, so records made by
        its original owner show up here with zero extra hot-path work
        (the profiler's alias mechanism).  Replaces any
        previous timer of that name."""
        with self._lock:
            self._stages[stage] = stats

    @contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timer(stage).record(time.perf_counter() - t0)

    def incr(self, name: str, n: int = 1) -> None:
        """Bump a named event counter (``n=0`` pre-registers the name so
        a snapshot shows an explicit zero instead of a missing key —
        the resilience counters ``shed``/``expired``/``salvaged``/
        ``restarted`` are seeded this way by the scoring engine, so
        "no degradation happened" is observable, not ambiguous)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        """Record a point-in-time level (last-write-wins) — e.g. the
        elastic watchdog's worst peer heartbeat age, where "how stale
        NOW" matters and a count or latency distribution would not."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def add_rows(self, n: int) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
            self._rows += n

    @property
    def rows(self) -> int:
        return self._rows

    def _rows_per_s_locked(self) -> float:
        if self._t_first is None or self._t_last <= self._t_first:
            return 0.0
        return self._rows / (self._t_last - self._t_first)

    def rows_per_s(self) -> float:
        with self._lock:
            return self._rows_per_s_locked()

    def snapshot(self) -> Dict[str, object]:
        # one lock acquisition for the WHOLE top-level read: reading
        # self._rows and calling rows_per_s() after release could pair a
        # newer row count with an older window (or vice versa), so a
        # concurrent add_rows() made rows and rows_per_s mutually
        # inconsistent in one snapshot
        with self._lock:
            stages = dict(self._stages)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            rows = self._rows
            rows_per_s = self._rows_per_s_locked()
        return {
            "rows": rows,
            "rows_per_s": round(rows_per_s, 2),
            "counters": counters,
            "gauges": gauges,
            "stages": {name: s.snapshot() for name, s in stages.items()},
        }


@contextmanager
def trace(out_dir: str):
    """Record the wrapped region with ``torch.profiler`` (CPU activity,
    and CUDA activity when a card is present) and export it as
    ``out_dir/fit_<ns>_<pid>.trace.json``."""
    import torch
    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        out_dir, f"fit_{time.time_ns()}_{os.getpid()}.trace.json"))


@contextmanager
def maybe_trace(out_dir: Optional[str]):
    """:func:`trace` when ``out_dir`` is set; no-op otherwise (the shape
    engine code wants: one `with` either way)."""
    if not out_dir:
        yield
        return
    with trace(out_dir):
        yield


#: Chrome-trace categories of work that ran on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(out_dir: str, top: int = 25
                    ) -> List[Tuple[float, str]]:
    """Aggregate device-op durations from the newest Chrome trace under
    ``out_dir`` (``*.trace.json``, or gzipped).  Returns ``[(total_ms,
    op_name), ...]`` sorted descending, with one trailing
    ``(total_device_ms, "total_device_ms")`` summary row (the whole
    trace's device time); empty when no trace file exists.

    Device events are the card's kernels, copies and memsets (their
    ``cat``); a trace without any (a CPU fit) counts the busiest
    process's events instead, as the reference does.  "Newest" is by
    mtime, so a re-run into the same directory wins."""
    paths = [p for pat in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(out_dir, "**", pat),
                                recursive=True)]
    if not paths:
        return []
    newest = max(paths, key=lambda p: (os.path.getmtime(p), p))
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", []) if isinstance(data, dict) \
        else data
    agg: Dict[Tuple[object, str], float] = defaultdict(float)
    dev_keys = set()
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            key = (e.get("pid", 0), e.get("name", "?"))
            agg[key] += float(e["dur"])
            if e.get("cat") in _DEVICE_CATS:
                dev_keys.add(key)
    if not dev_keys:
        by_pid: Dict[object, float] = defaultdict(float)
        for (pid, _), d in agg.items():
            by_pid[pid] += d
        busiest = max(by_pid, key=by_pid.get) if by_pid else None
        dev_keys = {k for k in agg if k[0] == busiest}
    by_name: Dict[str, float] = defaultdict(float)
    for key in dev_keys:
        by_name[key[1]] += agg[key]
    rows = sorted(((d / 1e3, name) for name, d in by_name.items()),
                  reverse=True)
    total_ms = round(sum(ms for ms, _ in rows), 3)
    return rows[:top] + [(total_ms, "total_device_ms")]
