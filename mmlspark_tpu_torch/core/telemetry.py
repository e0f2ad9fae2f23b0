"""Unified telemetry — the port's observability subsystem.

The port's copy of ``mmlspark_tpu/core/telemetry.py``, stdlib only and
kept line for line: the metric prefix, the family names, the journal's
event names and fields, the snapshot schemas and the exposition's float
formatting (:func:`_fmt`) and label escaping (:func:`_esc`) are the
reference's, so a scrape, a journal or a snapshot from the port reads
like one from the reference.  Training (``engine.train_stats``), the
elastic watchdog and the profiler federate here:

* :class:`MetricsRegistry` — a process-wide registry of named stats
  sources (anything with a ``snapshot()`` in the
  :class:`~mmlspark_tpu_torch.core.profiling.StageStats` shape), rendered as
  Prometheus text exposition for the ``/metrics`` route every serving
  server exposes (pull-model metrics, Prometheus-style).
* :class:`EventJournal` — a bounded, thread-safe event ring (optionally
  mirrored to a JSONL file): span begin/end, shed/expired/salvage,
  checkpoint save/resume/discard, peer_lost.  ``tools/trace_report.py``
  reconstructs per-request and per-fit timelines from it
  (Dapper-style correlated tracing, minus the distributed collector).
* Trace identity — :func:`new_trace_id` mints ids; a scoring request's
  trace id is the ``_trace_id`` its client sent, else the request id
  minted at admission (so every request is traceable without opt-in).
  A fit's span id is process-global (:func:`current_fit_span`) so the
  checkpoint writer and the heartbeat lease can stamp it without
  threading an argument through the whole engine.

Metric naming scheme (see docs/observability.md):

==============================================  =========  ==================
family                                          type       labels
==============================================  =========  ==================
``mmlspark_tpu_rows_total``                     counter    ``ns``
``mmlspark_tpu_rows_per_second``                gauge      ``ns``
``mmlspark_tpu_events_total``                   counter    ``ns``, ``event``
``mmlspark_tpu_gauge``                          gauge      ``ns``, ``name``
``mmlspark_tpu_stage_latency_seconds``          histogram  ``ns``, ``stage``, ``le``
==============================================  =========  ==================

(Plus the ``mmlspark_tpu_slo_*`` families rendered by
:mod:`mmlspark_tpu_torch.core.slo` through the registry's exposition-provider
hook.)  ``ns`` is the registry namespace (``scoring``, ``train``,
``elastic``, ``serving_exchange``, ``worker<N>``/``workers`` for the
multiprocess topology's per-worker and aggregated blocks).

Stage latencies are log-bucketed histograms
(:class:`~mmlspark_tpu_torch.core.profiling.LatencyStats`): the ``_bucket``
rows carry cumulative counts with ``le`` upper bounds, which is what
makes :func:`merge_snapshots` EXACT across workers — bucket counts sum,
and the aggregate percentile is recomputed from the summed buckets
instead of averaging per-worker estimates ("The Tail at
Scale" aggregation discipline).

This module additionally hosts the **crash flight recorder**
(:func:`record_flight`): on a worker death, chaos verdict failure or
unhandled engine exception, the journal tail + latest metrics
exposition + per-thread stacks are dumped atomically to a bounded,
rotated ``artifacts/flightrec_*.json`` set, so every post-mortem is
self-contained.

Everything here is stdlib-only and import-light: the serving hot path
and the training loop both call into it.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional

from .profiling import percentile_from_buckets

PREFIX = "mmlspark_tpu"

# -- Prometheus text exposition ---------------------------------------------

#: family -> (type, help); histograms additionally emit
#: _bucket/_sum/_count rows
_FAMILIES = (
    ("rows_total", "counter", "Rows processed by this source."),
    ("rows_per_second", "gauge",
     "Rows/s over the source's active window."),
    ("events_total", "counter",
     "Named event counters (shed/expired/salvaged/restarted, "
     "ckpt_saved/ckpt_resumed/..., heartbeat_stalls/peer_lost, ...)."),
    ("gauge", "gauge",
     "Point-in-time levels (heartbeat_age_ms, ms_per_tree, ...)."),
    ("stage_latency_seconds", "histogram",
     "Per-stage wall-clock latency (log-bucketed, cross-worker "
     "mergeable)."),
)


def _esc(v: Any) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: Any) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if f != f:                       # NaN
        return "NaN"
    if f == float("inf"):            # before int(f): int(inf) raises,
        return "+Inf"                # and one inf gauge must not 503
    if f == float("-inf"):           # the whole scrape
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(d: Dict[str, Any]) -> str:
    return "{" + ",".join(f'{k}="{_esc(v)}"'
                          for k, v in sorted(d.items())) + "}"


def render_prometheus(snapshots: Dict[str, dict],
                      prefix: str = PREFIX) -> str:
    """Render ``{namespace: StageStats.snapshot()-shaped dict}`` as
    Prometheus text exposition (format 0.0.4).  Unknown/missing snapshot
    keys are skipped, never fatal — a scrape must not 500 because one
    source misbehaved."""
    rows: Dict[str, List[str]] = {fam: [] for fam, _, _ in _FAMILIES}
    for ns in sorted(snapshots):
        snap = snapshots[ns]
        if not isinstance(snap, dict):
            continue
        lab = {"ns": ns}
        if "rows" in snap:
            rows["rows_total"].append(
                f"{prefix}_rows_total{_labels(lab)} "
                f"{_fmt(snap.get('rows', 0))}")
            rows["rows_per_second"].append(
                f"{prefix}_rows_per_second{_labels(lab)} "
                f"{_fmt(snap.get('rows_per_s', 0.0))}")
        for name in sorted(snap.get("counters") or {}):
            rows["events_total"].append(
                f"{prefix}_events_total"
                f"{_labels({**lab, 'event': name})} "
                f"{_fmt(snap['counters'][name])}")
        for name in sorted(snap.get("gauges") or {}):
            rows["gauge"].append(
                f"{prefix}_gauge{_labels({**lab, 'name': name})} "
                f"{_fmt(snap['gauges'][name])}")
        for stage in sorted(snap.get("stages") or {}):
            s = snap["stages"][stage]
            if not isinstance(s, dict):
                continue
            slab = {**lab, "stage": stage}
            base = f"{prefix}_stage_latency_seconds"
            count = s.get("count", 0)
            # cumulative _bucket rows over the sparse occupied bounds
            # (Prometheus histograms allow any bound subset as long as
            # counts are cumulative and +Inf is present); snapshots
            # without buckets (hand-built test dicts, version-skewed
            # beacons) still render a valid +Inf-only histogram
            buckets = s.get("buckets") or {}
            cum = 0
            for le, c in sorted(
                    ((le, c) for le, c in buckets.items()
                     if le != "+Inf"),
                    key=lambda kv: float(kv[0])):
                cum += int(c)
                rows["stage_latency_seconds"].append(
                    f"{base}_bucket{_labels({**slab, 'le': le})} "
                    f"{cum}")
            rows["stage_latency_seconds"].append(
                f"{base}_bucket{_labels({**slab, 'le': '+Inf'})} "
                f"{_fmt(count)}")
            rows["stage_latency_seconds"].append(
                f"{base}_sum{_labels(slab)} {_fmt(s.get('total_s', 0.0))}")
            rows["stage_latency_seconds"].append(
                f"{base}_count{_labels(slab)} {_fmt(count)}")
    out: List[str] = []
    for fam, typ, help_ in _FAMILIES:
        if not rows[fam]:
            continue
        out.append(f"# HELP {prefix}_{fam} {help_}")
        out.append(f"# TYPE {prefix}_{fam} {typ}")
        out.extend(rows[fam])
    return "\n".join(out) + "\n" if out else "# no metrics registered\n"


#: point-in-time gauges whose cross-process aggregate is the SUM —
#: backlog/occupancy COUNTS where the fleet-wide total is the operable
#: number (total queued requests, total in-flight fan-outs), not the
#: single deepest member.  Level/ratio-style gauges (ages, busy
#: fractions, headroom ratios) stay max — summing two 0.6 busy
#: fractions into 1.2 would be nonsense.  Keyed by metric name so a
#: beacon from an older worker merges under the same policy as a local
#: snapshot.
GAUGE_SUM_NAMES = frozenset({
    "queue_depth", "fanout_inflight", "shards_awaited",
})
GAUGE_SUM_SUFFIXES = ("_depth", "_inflight")


def gauge_merge_mode(name: str) -> str:
    """``"min"`` | ``"sum"`` | ``"max"`` — the cross-process merge
    policy for a point-in-time gauge, keyed by its metric name:
    ``*_up`` health booleans take min (one degraded member must show),
    depth/in-flight backlog counts sum (the aggregate is the total
    backlog), everything else takes max (the worst level)."""
    if name.endswith("_up"):
        return "min"
    if name in GAUGE_SUM_NAMES or name.endswith(GAUGE_SUM_SUFFIXES):
        return "sum"
    return "max"


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Merge several StageStats snapshots into one aggregate (the
    "workers" total block of a multiprocess scrape): rows and counters
    SUM, rows/s sums (concurrent sources), gauges merge under the
    name-keyed :func:`gauge_merge_mode` policy — MIN for up-style
    health booleans (``*_up``, where 1 is healthy and one degraded
    member must show in the aggregate), SUM for depth/in-flight
    backlog counts (per-worker queue depths are point-in-time levels,
    but the fleet-wide backlog is their total — taking the max under-
    reported it), MAX for every other level-style gauge (ages, ratios,
    occupancies).  Stage latencies merge EXACTLY: the
    log-bucket counts every :class:`~mmlspark_tpu_torch.core.profiling.
    LatencyStats` snapshot carries are key-wise summed and the
    aggregate p50/p99 recomputed from the combined buckets — the
    percentile OF the combined population at ladder resolution, not an
    average or max of per-worker estimates.  A source with no
    ``buckets`` (hand-built dicts, version-skewed beacons) degrades
    that stage to the old conservative max-of-percentiles bound."""
    out: dict = {"rows": 0, "rows_per_s": 0.0, "counters": {},
                 "gauges": {}, "stages": {}}
    bucketless: Dict[str, bool] = {}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        out["rows"] += int(snap.get("rows", 0) or 0)
        out["rows_per_s"] = round(
            out["rows_per_s"] + float(snap.get("rows_per_s", 0.0) or 0.0),
            2)
        for k, v in (snap.get("counters") or {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, v in (snap.get("gauges") or {}).items():
            mode = gauge_merge_mode(k)
            if mode == "min":
                out["gauges"][k] = min(
                    out["gauges"].get(k, float("inf")), v)
            elif mode == "sum":
                out["gauges"][k] = out["gauges"].get(k, 0) + v
            else:
                out["gauges"][k] = max(
                    out["gauges"].get(k, float("-inf")), v)
        for stage, s in (snap.get("stages") or {}).items():
            if not isinstance(s, dict):
                continue
            agg = out["stages"].setdefault(
                stage, {"count": 0, "total_s": 0.0, "mean_ms": 0.0,
                        "p50_ms": 0.0, "p99_ms": 0.0, "buckets": {}})
            agg["count"] += int(s.get("count", 0) or 0)
            agg["total_s"] = round(
                agg["total_s"] + float(s.get("total_s", 0.0) or 0.0), 6)
            agg["p50_ms"] = max(agg["p50_ms"], s.get("p50_ms", 0.0))
            agg["p99_ms"] = max(agg["p99_ms"], s.get("p99_ms", 0.0))
            if isinstance(s.get("buckets"), dict):
                for le, c in s["buckets"].items():
                    agg["buckets"][le] = agg["buckets"].get(le, 0) \
                        + int(c)
            elif s.get("count"):
                bucketless[stage] = True
            if agg["count"]:
                agg["mean_ms"] = round(
                    agg["total_s"] / agg["count"] * 1e3, 4)
    for stage, agg in out["stages"].items():
        if bucketless.get(stage):
            # mixed bucketed/bucketless sources: a partial bucket set
            # under the full count would render every bucketless
            # sample as a >300s +Inf outlier — drop the buckets so the
            # stage degrades to a +Inf-only histogram consistently
            # with its conservative max-of-percentiles bound
            agg.pop("buckets", None)
        elif agg["buckets"]:
            agg["p50_ms"] = round(
                percentile_from_buckets(agg["buckets"], 50) * 1e3, 4)
            agg["p99_ms"] = round(
                percentile_from_buckets(agg["buckets"], 99) * 1e3, 4)
    return out


class MetricsRegistry:
    """Process-wide federation of named stats sources.

    A source is anything exposing ``snapshot() -> dict`` in the
    :class:`~mmlspark_tpu_torch.core.profiling.StageStats` shape (a plain
    pre-built snapshot dict also works).  ``register`` REPLACES an
    existing namespace — the newest engine/watchdog instance wins, which
    is what a scrape of a restarted component should see."""

    def __init__(self, prefix: str = PREFIX):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._sources: Dict[str, Any] = {}
        self._expositions: Dict[str, Callable[[], str]] = {}

    def register(self, namespace: str, source: Any) -> Any:
        with self._lock:
            self._sources[namespace] = source
        return source

    def unregister(self, namespace: str) -> None:
        with self._lock:
            self._sources.pop(namespace, None)

    def register_exposition(self, name: str,
                            provider: Callable[[], str]) -> None:
        """Register a raw-exposition provider: ``provider()`` returns
        Prometheus text appended verbatim to every render.  This is how
        families OUTSIDE the StageStats shape (the SLO monitor's
        ``mmlspark_tpu_slo_*``) join the scrape without forcing their
        data through a snapshot dict."""
        with self._lock:
            self._expositions[name] = provider

    def unregister_exposition(self, name: str) -> None:
        with self._lock:
            self._expositions.pop(name, None)

    def namespaces(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._sources.items())
        out: Dict[str, dict] = {}
        for ns, src in items:
            try:
                out[ns] = (src.snapshot() if hasattr(src, "snapshot")
                           else dict(src))
            except Exception:  # noqa: BLE001 - one bad source must not
                continue       # fail the whole scrape
        return out

    def render_prometheus(self,
                          extra: Optional[Dict[str, dict]] = None) -> str:
        """Render every registered source (plus ``extra`` pre-built
        snapshot blocks — the multiprocess coordinator passes its workers'
        reported stats here) as Prometheus text, then append every
        registered exposition provider's families (one failing
        provider is skipped, never fatal to the scrape)."""
        snaps = self.snapshot()
        if extra:
            snaps.update(extra)
        text = render_prometheus(snaps, self.prefix)
        with self._lock:
            providers = list(self._expositions.items())
        for name, provider in providers:
            try:
                block = provider()
            except Exception:  # noqa: BLE001 - scrape must not 500
                continue
            if block:
                if not text.endswith("\n"):
                    text += "\n"
                text += block if block.endswith("\n") else block + "\n"
        return text


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every ``/metrics`` route renders."""
    return _registry


# -- event journal -----------------------------------------------------------


class EventJournal:
    """Bounded, thread-safe event ring with optional JSONL mirroring.

    ``emit`` stamps each record with a wall-clock ``ts``, the emitting
    ``pid`` (so merged multi-process journals attribute every event to
    its process) and a process-monotonic ``seq`` (total order within
    one process; readers merging journals from several processes sort
    by ``(ts, seq)``).  The in-memory ring is bounded (``capacity``),
    so an always-on journal can never grow without bound;
    :meth:`configure` additionally appends every record to a JSONL file
    for post-mortem reads, with size-capped rotation — when the mirror
    exceeds ``max_bytes`` it is renamed to ``<path>.1`` (replacing any
    previous ``.1``) and a fresh file starts, so the on-disk footprint
    is bounded by ~2x the cap."""

    def __init__(self, capacity: int = 8192, path: Optional[str] = None,
                 max_bytes: int = 8 << 20):
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=int(capacity))
        self._seq = 0
        self._fh = None
        self._path: Optional[str] = None
        self._max_bytes = int(max_bytes)
        self._written = 0
        if path:
            self.configure(path, max_bytes=max_bytes)

    def configure(self, path: Optional[str],
                  max_bytes: Optional[int] = None) -> None:
        """Mirror subsequent events to ``path`` (append mode); ``None``
        stops mirroring.  ``max_bytes`` caps the mirror file before it
        rotates to ``<path>.1``.  Ring behavior is unchanged either
        way."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            self._path = path or None
            if max_bytes is not None:
                self._max_bytes = int(max_bytes)
            if path:
                self._fh = open(path, "a", encoding="utf-8")
                try:
                    self._written = os.path.getsize(path)
                except OSError:
                    self._written = 0

    def _rotate_locked(self) -> None:
        """Close the mirror, shift it to ``.1`` (dropping the previous
        ``.1``), and reopen fresh.  Called under ``self._lock``."""
        try:
            self._fh.close()
        except OSError:
            pass
        try:
            os.replace(self._path, self._path + ".1")
        except OSError:
            pass   # rotation is best-effort; keep appending regardless
        try:
            self._fh = open(self._path, "a", encoding="utf-8")
        except OSError:
            self._fh = None
        self._written = 0

    def emit(self, ev: str, **fields) -> dict:
        rec: dict = {"ts": round(time.time(), 6), "ev": ev,
                     "pid": os.getpid()}
        rec.update(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            if self._fh is not None:
                try:
                    line = json.dumps(rec, default=str) + "\n"
                    self._fh.write(line)
                    self._fh.flush()
                    self._written += len(line)
                    if self._path and self._written > self._max_bytes:
                        self._rotate_locked()
                except (OSError, ValueError):
                    pass   # a full disk must not kill the hot path
        return rec

    @contextmanager
    def span(self, name: str, **fields):
        """Emit ``<name>_begin`` / ``<name>_end`` (with ``dur_ms``)
        around the wrapped region."""
        t0 = time.perf_counter()
        self.emit(f"{name}_begin", **fields)
        try:
            yield
        finally:
            self.emit(f"{name}_end",
                      dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                      **fields)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int = 50) -> List[dict]:
        with self._lock:
            return list(self._ring)[-int(n):]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, path: str) -> int:
        """Write the current ring to ``path`` as JSONL, fsync'd —
        a dump is a post-mortem artifact, and a crash right after it
        must not leave a torn or page-cache-only file; returns the
        number of records written."""
        events = self.events()
        with open(path, "w", encoding="utf-8") as fh:
            for rec in events:
                fh.write(json.dumps(rec, default=str) + "\n")
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass
        return len(events)


def read_journal(path: str) -> List[dict]:
    """Read a JSONL journal; malformed lines (torn tail after a crash)
    are skipped, not fatal — a post-mortem reader must read what's
    there."""
    out: List[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


_journal = EventJournal()


def get_journal() -> EventJournal:
    """The process-global journal the engines emit into."""
    return _journal


#: env var naming a directory every process (coordinator AND spawned
#: workers, which inherit the environment) mirrors its journal into —
#: the cross-process trace story depends on each side's journal being
#: readable after the fact
JOURNAL_DIR_ENV = "MMLSPARK_TPU_JOURNAL_DIR"


def mirror_journal_from_env(tag: str = "") -> Optional[str]:
    """If :data:`JOURNAL_DIR_ENV` is set, mirror this process's global
    journal to ``<dir>/journal_<tag>_<pid>.jsonl`` and return the path
    (``None`` when the env var is unset or the directory unusable).
    Worker entrypoints call this at startup so a coordinator-side tool can
    merge coordinator+worker journals into one cross-process timeline."""
    jdir = os.environ.get(JOURNAL_DIR_ENV)
    if not jdir:
        return None
    try:
        os.makedirs(jdir, exist_ok=True)
        name = f"journal_{tag}_{os.getpid()}.jsonl" if tag \
            else f"journal_{os.getpid()}.jsonl"
        path = os.path.join(jdir, name)
        _journal.configure(path)
        return path
    except OSError:
        return None


# -- crash flight recorder ---------------------------------------------------


FLIGHTREC_DIR_ENV = "MMLSPARK_TPU_FLIGHTREC_DIR"

_flight_lock = threading.Lock()
_flight_cfg = {"dir": None, "cap": 8, "min_interval_s": 5.0}
_flight_last: Dict[str, float] = {}


def configure_flight_recorder(directory: Optional[str] = None,
                              cap: Optional[int] = None,
                              min_interval_s: Optional[float] = None
                              ) -> None:
    """Set where flight records land (default: ``$MMLSPARK_TPU_
    FLIGHTREC_DIR`` or ``artifacts/``), how many are kept before the
    oldest rotate out, and the per-reason dump throttle."""
    with _flight_lock:
        if directory is not None:
            _flight_cfg["dir"] = directory
        if cap is not None:
            _flight_cfg["cap"] = max(1, int(cap))
        if min_interval_s is not None:
            _flight_cfg["min_interval_s"] = float(min_interval_s)


def _thread_stacks() -> Dict[str, str]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')}-{ident}"
        out[label] = "".join(traceback.format_stack(frame))
    return out


def record_flight(reason: str, context: Optional[dict] = None,
                  journal_tail: int = 400) -> Optional[str]:
    """Crash flight recorder: atomically dump the journal
    tail, the latest metrics exposition and every thread's stack to
    ``<dir>/flightrec_<utc>_<reason>_<pid>.json`` so a post-mortem is
    self-contained — no scrape to replay, no journal to hunt down.

    Bounded on every axis: the journal tail is capped, dumps of the
    same ``reason`` are throttled to one per ``min_interval_s``, and at
    most ``cap`` records are kept (oldest rotated out).  Never raises —
    a failing recorder must not worsen the crash it is recording.
    Returns the path written, or ``None`` when throttled/failed."""
    try:
        now = time.time()
        with _flight_lock:
            last = _flight_last.get(reason, 0.0)
            if now - last < _flight_cfg["min_interval_s"]:
                return None
            _flight_last[reason] = now
            directory = (_flight_cfg["dir"]
                         or os.environ.get(FLIGHTREC_DIR_ENV)
                         or "artifacts")
            cap = _flight_cfg["cap"]
        os.makedirs(directory, exist_ok=True)
        try:
            metrics = get_registry().render_prometheus()
        except Exception:  # noqa: BLE001
            metrics = "# metrics render failed\n"
        try:
            # the profiler lives one import down (it imports this
            # module); a flight record carries its snapshot so a
            # post-mortem has the cost attribution at crash time too
            from .profiler import get_profiler
            profile = get_profiler().snapshot()
        except Exception:  # noqa: BLE001 - recorder must not fail
            profile = None
        rec = {
            "reason": reason,
            "ts": round(now, 6),
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                 time.gmtime(now)),
            "pid": os.getpid(),
            "context": context or {},
            "fit_span": current_fit_span(),
            "journal_tail": get_journal().tail(journal_tail),
            "metrics_exposition": metrics,
            "profile": profile,
            "threads": _thread_stacks(),
        }
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:40]
        stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime(now))
        path = os.path.join(
            directory,
            f"flightrec_{stamp}_{int((now % 1) * 1e6):06d}"
            f"_{safe}_{os.getpid()}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(rec, fh, indent=1, default=str)
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass
        os.replace(tmp, path)
        # rotation: keep the newest `cap` records
        try:
            recs = sorted(
                (p for p in os.listdir(directory)
                 if p.startswith("flightrec_") and p.endswith(".json")),
                key=lambda p: os.path.getmtime(
                    os.path.join(directory, p)))
            for p in recs[:-cap]:
                os.unlink(os.path.join(directory, p))
        except OSError:
            pass
        return path
    except Exception:  # noqa: BLE001 - the recorder must never make a
        return None    # crash worse


# -- trace identity ----------------------------------------------------------


def host_info() -> dict:
    """Host CPU readings for bench/sentinel artifacts:
    ``cores_effective`` is what this process may actually RUN on —
    ``sched_getaffinity`` sees cgroup/affinity caps the advertised
    ``cpu_count`` does not.  ONE definition so the fleet-scaling gate,
    the bench host block, and the perf sentinel can never diverge on
    what "a core" means."""
    return {
        "cpu_count": os.cpu_count(),
        "cores_effective": (len(os.sched_getaffinity(0))
                            if hasattr(os, "sched_getaffinity")
                            else os.cpu_count()),
    }


def new_trace_id() -> str:
    """A fresh 16-hex-char trace/span id."""
    return uuid.uuid4().hex[:16]


#: process-global (NOT thread-local) on purpose: the heartbeat watchdog
#: thread and the checkpoint writer both stamp the span of the fit the
#: process is running, which is a process-level fact (``train_stats`` is
#: process-global for the same reason).  Concurrent fits in one process
#: would interleave stamps — as they already interleave counters.
_current_fit = {"span": None}


def set_current_fit_span(span: Optional[str]) -> None:
    _current_fit["span"] = span


def current_fit_span() -> Optional[str]:
    return _current_fit["span"]
