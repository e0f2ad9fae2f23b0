"""Saturation & capacity observability.

The port's copy of ``mmlspark_tpu/core/capacity.py``, kept line for line
(its profiler is the port's :mod:`.profiler`).

The stack so far can say *that* the SLO is burning (core/slo.py) and
*where* the time goes (core/profiler.py) but not *how much more load
the fleet can take* or *which resource saturates first*.  This module
is the USE-method layer (utilization / saturation / errors — errors
already live in the resilience counters) plus an online capacity-knee
estimator:

* **Utilization** — :meth:`CapacityMonitor.sample` derives per-stage
  busy fractions (Δ ``total_s`` / Δ wall-clock) from the profiler's
  existing phase timers — the scoring engine, transport and fleet
  already alias their hot-path histograms into the profiler, so
  utilization costs ZERO extra hot-path records.  The instantaneous
  saturation gauges (scoring ``queue_depth`` / ``batch_occupancy`` /
  ``worker_busy``, transport ``credit_occupancy``, fleet
  ``fanout_inflight``) are set by the components themselves on their
  own :class:`~mmlspark_tpu_torch.core.profiling.StageStats`, so the
  existing beacon + :func:`~mmlspark_tpu_torch.core.telemetry.
  merge_snapshots` machinery federates them cross-process with no new
  transport (see the gauge merge policy in core/telemetry.py — depth-
  style gauges SUM to a total backlog, level-style gauges take the
  worst value).

* **Saturation / knee** — per resource (``scoring``, ``transport``),
  the monitor windows the rotating-epoch latency histograms: each tick
  diffs the cumulative log-bucket counts against a reading ~
  ``window_s`` old, so the percentile is of the LAST WINDOW's
  population exactly (the same delta-histogram discipline the SLO
  monitor uses for counters).  The (throughput, latency) pairs feed a
  :class:`KneeEstimator` — a hinge (flat-then-rising) regressor whose
  breakpoint is the load where latency departs its flat baseline, i.e.
  the goodput knee.  The published knee moves only after the raw
  estimate has left a relative dead-band for several consecutive
  ticks (hysteresis), so bursts wiggle the raw fit without flapping
  the headroom surface.

* **Headroom** — ``mmlspark_tpu_capacity_headroom_ratio{resource=}``
  = current load / published knee load.  Two gauge-form SLO
  objectives (``scoring_headroom``, ``transport_headroom``, declared
  in core/slo.py) feed the existing multiwindow burn machinery, so
  "approaching saturation" pages BEFORE "SLO violated" does.
  Saturation onset/clear transitions (with per-verdict hysteresis)
  journal ``saturation_onset`` / ``saturation_cleared`` and dump a
  flight record at onset — the post-mortem for "why did we start
  shedding" is self-contained.

Overhead contract: with capacity observability DISABLED
(``MMLSPARK_TPU_CAPACITY=0`` or :func:`configure`) the component taps
are one cached-bool check and the sampler never runs; ENABLED, the
taps are a few gauge stores per BATCH (not per row) and the sampler is
one registry snapshot per second.  The perf sentinel pins the
enabled-vs-disabled p50 delta of a closed-loop scoring burst under 3%
(tools/perf_sentinel.py).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .profiling import StageStats, percentile_from_buckets
from .telemetry import (PREFIX, _fmt, _labels, get_journal, get_registry,
                        record_flight)

__all__ = ["CapacityMonitor", "KneeEstimator", "ResourceSpec",
           "default_resources", "capacity_enabled", "configure",
           "get_capacity_monitor", "set_capacity_monitor",
           "peek_capacity_monitor", "ensure_capacity_sampler",
           "render_statusz", "CAPACITY_ENV",
           "SATURATION_ONSET_RATIO", "SATURATION_CLEAR_RATIO"]

#: set to ``"0"`` to disable capacity observability process-wide; the
#: sentinel overhead A/B and tests flip :func:`configure` instead
#: (same switch, no env round-trip)
CAPACITY_ENV = "MMLSPARK_TPU_CAPACITY"

#: headroom (load / knee) at which a resource is "approaching
#: saturation".  The ``*_headroom`` SLO objectives in core/slo.py use
#: the SAME constant as their gauge threshold — the burn gate and the
#: journal verdict must agree on what "saturating" means.
SATURATION_ONSET_RATIO = 0.9

#: headroom below which a saturated resource is considered recovered;
#: the gap to the onset ratio is the anti-flap hysteresis band
SATURATION_CLEAR_RATIO = 0.75

_enabled = {"on": os.environ.get(CAPACITY_ENV, "1") != "0"}


def capacity_enabled() -> bool:
    """Process-wide capacity-observability switch.  Components CACHE
    this at construction time (one attribute check on their hot paths);
    the sampler re-reads it every tick so :func:`configure` pauses a
    running monitor immediately."""
    return _enabled["on"]


def configure(enabled: Optional[bool] = None) -> bool:
    """Flip the process-wide switch (None = leave unchanged); returns
    the resulting state.  Components constructed AFTER the flip pick it
    up — the sentinel A/B constructs a fresh engine per arm."""
    if enabled is not None:
        _enabled["on"] = bool(enabled)
    return _enabled["on"]


# -- knee estimation ---------------------------------------------------------


class KneeEstimator:
    """Online goodput-knee estimator over (load, latency) observations.

    Model: a hinge — latency is FLAT at a baseline ``a`` up to the knee
    load ``k``, then rises linearly with slope ``c``.  :meth:`
    raw_estimate` grid-searches the breakpoint over the observed loads,
    fitting ``a`` as the mean of the left segment and ``c`` by least
    squares on the right, and returns the SSE-minimizing ``k`` — but
    only when the curve actually shows a knee: enough points, enough
    load dynamic range, a positive right-segment slope, and a modeled
    rise of at least ``rise_factor`` over the baseline at the max
    observed load.  An open-loop sweep past saturation (throughput
    plateaus, latency explodes) and a closed-loop concurrency curve
    (latency rises smoothly) both fit this shape.  When overload
    instead REDUCES delivered load (congestion collapse: latency-vs-
    load folds back and no hinge fits), a fallback splits the points
    on latency and estimates the knee as the max load sustained below
    ``rise_factor`` times the low-latency baseline.

    Hysteresis: the PUBLISHED knee (:attr:`knee`) moves only after the
    raw estimate has been outside a ``band`` relative dead-band around
    it for ``confirm`` consecutive :meth:`update` calls — a burst that
    wiggles the raw fit for a tick or two cannot flap the headroom
    surface the autoscaler will act on."""

    def __init__(self, window: int = 240, min_points: int = 10,
                 min_load_span: float = 1.5, rise_factor: float = 1.3,
                 band: float = 0.15, confirm: int = 3,
                 min_left: int = 3, min_right: int = 3):
        self.window = int(window)
        self.min_points = int(min_points)
        self.min_load_span = float(min_load_span)
        self.rise_factor = float(rise_factor)
        self.band = float(band)
        self.confirm = int(confirm)
        self.min_left = int(min_left)
        self.min_right = int(min_right)
        self._pts: "deque[Tuple[float, float]]" = deque(maxlen=self.window)
        self._published: Optional[float] = None
        self._pending: Optional[float] = None
        self._pending_n = 0

    def observe(self, load: float, latency_ms: float) -> None:
        """Add one (throughput, latency) observation; non-positive
        readings carry no information and are dropped."""
        if load > 0 and latency_ms > 0:
            self._pts.append((float(load), float(latency_ms)))

    def raw_estimate(self) -> Optional[float]:
        """The hinge-fit knee of the current window, or ``None`` while
        the curve shows no credible knee (too few points, too little
        load range, or latency still flat)."""
        pts = sorted(self._pts)
        n = len(pts)
        if n < self.min_points:
            return None
        loads = [p[0] for p in pts]
        lats = [p[1] for p in pts]
        if loads[0] <= 0 or loads[-1] / loads[0] < self.min_load_span:
            return None
        mean_all = sum(lats) / n
        sse_flat = sum((y - mean_all) ** 2 for y in lats)
        best: Optional[Tuple[float, float, float, float]] = None
        # candidate breakpoints: every observed load that leaves both
        # segments enough points to fit
        for i in range(self.min_left - 1, n - self.min_right):
            k = loads[i]
            left = lats[: i + 1]
            a = sum(left) / len(left)
            xs = [x - k for x in loads[i + 1:]]
            ys = [y - a for y in lats[i + 1:]]
            sxx = sum(x * x for x in xs)
            if sxx <= 0:
                continue
            c = max(0.0, sum(x * y for x, y in zip(xs, ys)) / sxx)
            sse = sum((y - a) ** 2 for y in left) \
                + sum((y - c * x) ** 2 for x, y in zip(xs, ys))
            if best is None or sse < best[0]:
                best = (sse, k, a, c)
        if best is not None:
            sse, k, a, c = best
            modeled_max = a + c * (loads[-1] - k)
            if c > 0 and sse < sse_flat and (
                    a <= 0 or modeled_max >= self.rise_factor * a):
                return k
        # Fold-back fallback: past saturation an open-loop system can
        # deliver LESS than at the knee (congestion collapse — the
        # sender, shedder, and scorer fight for the same cores), so
        # latency-vs-load is multivalued and no hinge explains it: the
        # highest-load points are the healthy ones.  Split on latency
        # instead — congested points sit >= rise_factor over the
        # low-latency baseline — and take the knee as the best load the
        # system ever sustained while healthy.
        base = sorted(lats)[: max(self.min_left, n // 4)]
        a = sum(base) / len(base)
        if a <= 0:
            return None
        healthy = [x for x, y in pts if y < self.rise_factor * a]
        congested = n - len(healthy)
        if congested >= self.min_right and len(healthy) >= self.min_left:
            return max(healthy)
        return None               # flat explains the data just as well

    def update(self) -> Optional[float]:
        """Re-fit and (maybe) move the published knee; returns it."""
        raw = self.raw_estimate()
        if raw is None:
            return self._published
        if self._published is None:
            self._published = raw
            self._pending, self._pending_n = None, 0
            return self._published
        if abs(raw - self._published) <= self.band * self._published:
            self._pending, self._pending_n = None, 0   # inside dead-band
            return self._published
        if self._pending is not None and \
                abs(raw - self._pending) <= self.band * self._pending:
            self._pending_n += 1
        else:
            self._pending, self._pending_n = raw, 1
        if self._pending_n >= self.confirm:
            self._published = self._pending
            self._pending, self._pending_n = None, 0
        return self._published

    @property
    def knee(self) -> Optional[float]:
        return self._published


# -- resource tracking -------------------------------------------------------


class ResourceSpec:
    """One saturable resource: where its load counter and latency
    histograms live in the metrics registry.

    ``load`` is ``"rows"`` (the StageStats row counter) or a named
    event counter; ``stages`` are the latency stages whose windowed
    p50s SUM into the resource's latency reading (scoring sums queue
    age + e2e, so queueing delay — where saturation actually shows —
    counts even though the engine clocks it separately)."""

    def __init__(self, name: str, ns: str, stages: Sequence[str],
                 load: str = "rows"):
        self.name = str(name)
        self.ns = str(ns)
        self.stages = tuple(stages)
        self.load = str(load)


def default_resources() -> Tuple[ResourceSpec, ...]:
    """The resources the serving substrate saturates first."""
    return (
        ResourceSpec("scoring", "scoring", ("queue_age", "e2e"),
                     load="rows"),
        ResourceSpec("transport", "transport", ("wire_write",),
                     load="frames_sent"),
    )


class _ResourceTracker:
    """Windowed (throughput, latency) reader for one resource: keeps a
    short ring of cumulative readings and diffs the newest against one
    ~``window_s`` older, so both the rate and the percentile describe
    the SAME trailing window."""

    def __init__(self, spec: ResourceSpec, window_s: float,
                 estimator: Optional[KneeEstimator] = None,
                 min_dt_s: float = 0.5):
        self.spec = spec
        self.window_s = float(window_s)
        self.min_dt_s = float(min_dt_s)
        self.est = estimator if estimator is not None else KneeEstimator()
        #: ring of (t, cum_load, {stage: cum_buckets})
        self._ring: "deque[Tuple[float, float, Dict[str, Dict[str, int]]]]" \
            = deque(maxlen=4096)

    def tick(self, reg_snap: Dict[str, dict], t: float
             ) -> Tuple[Optional[float], Optional[float]]:
        """Record one reading; returns ``(load_per_s, latency_ms)`` over
        the trailing window (either may be ``None`` when the window is
        still filling or saw no traffic)."""
        src = reg_snap.get(self.spec.ns)
        if not isinstance(src, dict):
            return None, None
        if self.spec.load == "rows":
            cum = float(src.get("rows", 0) or 0)
        else:
            cum = float((src.get("counters") or {})
                        .get(self.spec.load, 0) or 0)
        buckets: Dict[str, Dict[str, int]] = {}
        for st in self.spec.stages:
            s = (src.get("stages") or {}).get(st)
            if isinstance(s, dict) and isinstance(s.get("buckets"), dict):
                buckets[st] = dict(s["buckets"])
        # base = newest reading at least window_s old (else the oldest
        # kept); drop anything older than 2x the window
        while self._ring and t - self._ring[0][0] > 2 * self.window_s \
                and len(self._ring) > 1 \
                and t - self._ring[1][0] >= self.window_s:
            self._ring.popleft()
        base = None
        for rec in reversed(self._ring):
            if t - rec[0] >= self.window_s:
                base = rec
                break
        if base is None and self._ring:
            base = self._ring[0]
        self._ring.append((t, cum, buckets))
        if base is None:
            return None, None
        t0, cum0, buckets0 = base
        dt = t - t0
        if dt < self.min_dt_s:
            return None, None
        d_load = cum - cum0
        load = d_load / dt if d_load > 0 else 0.0
        lat_ms = 0.0
        saw = False
        for st, nb in buckets.items():
            ob = buckets0.get(st, {})
            delta = {le: int(c) - int(ob.get(le, 0))
                     for le, c in nb.items()
                     if int(c) - int(ob.get(le, 0)) > 0}
            if delta:
                lat_ms += percentile_from_buckets(delta, 50) * 1e3
                saw = True
        return load, (lat_ms if saw else None)


# -- the monitor -------------------------------------------------------------


class CapacityMonitor:
    """Per-process saturation/capacity sampler.

    ``sample()`` takes one reading: busy fractions from the profiler's
    phase timers, windowed (load, latency) per declared resource into
    its knee estimator, then the derived headroom / knee / saturation
    gauges — all onto one :class:`StageStats` (``self.stats``), so the
    block is beacon-able and ``merge_snapshots``-able like every other
    telemetry source.  Deterministic given its inputs: tests drive
    ``sample(now=...)`` manually; ``start()`` runs a 1 Hz daemon
    ticker for live serving."""

    def __init__(self, registry=None, *, window_s: float = 30.0,
                 onset_ratio: float = SATURATION_ONSET_RATIO,
                 clear_ratio: float = SATURATION_CLEAR_RATIO,
                 onset_ticks: int = 3, clear_ticks: int = 3,
                 resources: Optional[Sequence[ResourceSpec]] = None,
                 estimators: Optional[Dict[str, KneeEstimator]] = None,
                 min_dt_s: float = 0.5):
        self._registry = registry
        self.window_s = float(window_s)
        self.onset_ratio = float(onset_ratio)
        self.clear_ratio = float(clear_ratio)
        self.onset_ticks = int(onset_ticks)
        self.clear_ticks = int(clear_ticks)
        self.stats = StageStats()
        self.stats.incr("saturation_onsets", 0)
        self.stats.incr("saturation_cleared", 0)
        specs = tuple(resources if resources is not None
                      else default_resources())
        self._trackers: Dict[str, _ResourceTracker] = {
            s.name: _ResourceTracker(
                s, self.window_s,
                (estimators or {}).get(s.name), min_dt_s=min_dt_s)
            for s in specs}
        #: saturation verdict state per resource
        self._sat: Dict[str, Dict[str, Any]] = {
            s.name: {"saturated": False, "onset_n": 0, "clear_n": 0}
            for s in specs}
        self._prev_phases: Dict[str, float] = {}
        self._prev_t: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    def resource_names(self) -> List[str]:
        return sorted(self._trackers)

    def estimator(self, resource: str) -> KneeEstimator:
        return self._trackers[resource].est

    # ---- sampling ----

    def sample(self, now: Optional[float] = None) -> None:
        """One reading of every utilization and saturation surface.
        No-ops while capacity observability is disabled, so
        :func:`configure` pauses a running ticker immediately."""
        if not capacity_enabled():
            return
        t = time.monotonic() if now is None else float(now)
        snap = self._reg().snapshot()
        with self._lock:
            self._sample_busy_locked(t)
            for name, tracker in self._trackers.items():
                load, lat = tracker.tick(snap, t)
                if load is not None:
                    self.stats.set_gauge(f"load_{name}", round(load, 3))
                    if lat is not None:
                        tracker.est.observe(load, lat)
                        self.stats.set_gauge(f"latency_ms_{name}",
                                             round(lat, 3))
                knee = tracker.est.update()
                self.stats.set_gauge(
                    f"knee_{name}",
                    round(knee, 3) if knee else 0.0)
                headroom = (load / knee) if (knee and load) else 0.0
                self.stats.set_gauge(f"headroom_{name}",
                                     round(headroom, 4))
                self._verdict_locked(name, headroom, knee, load)

    def _sample_busy_locked(self, t: float) -> None:
        """Busy fractions from the profiler's phase timers: Δtotal_s
        over Δwall per phase.  The hot paths alias their stage
        histograms into the profiler, so this reads utilization they
        already paid to measure; a fraction can exceed 1.0 when several
        workers run the phase concurrently (it is per-process, not
        per-core)."""
        from .profiler import get_profiler
        try:
            phases = (get_profiler().stats.snapshot().get("stages")
                      or {})
        except Exception:  # noqa: BLE001 - observer must not raise
            phases = {}
        dt = (t - self._prev_t) if self._prev_t is not None else None
        for phase, s in phases.items():
            if not isinstance(s, dict):
                continue
            tot = float(s.get("total_s", 0.0) or 0.0)
            prev = self._prev_phases.get(phase)
            if dt is not None and dt > 0 and prev is not None:
                busy = max(0.0, (tot - prev) / dt)
                self.stats.set_gauge(f"busy_{phase}", round(busy, 4))
            self._prev_phases[phase] = tot
        self._prev_t = t

    def _verdict_locked(self, name: str, headroom: float,
                        knee: Optional[float],
                        load: Optional[float]) -> None:
        """Saturation onset/clear with consecutive-tick hysteresis;
        journals the transitions and flight-records the onset."""
        st = self._sat[name]
        if headroom >= self.onset_ratio:
            st["onset_n"] += 1
            st["clear_n"] = 0
        elif headroom <= self.clear_ratio:
            st["clear_n"] += 1
            st["onset_n"] = 0
        else:
            st["onset_n"] = 0
            st["clear_n"] = 0
        if not st["saturated"] and st["onset_n"] >= self.onset_ticks:
            st["saturated"] = True
            self.stats.incr("saturation_onsets")
            get_journal().emit("saturation_onset", resource=name,
                               headroom=round(headroom, 4),
                               knee=round(knee or 0.0, 3),
                               load=round(load or 0.0, 3))
            record_flight("saturation_onset",
                          {"resource": name,
                           "headroom": round(headroom, 4),
                           "knee": round(knee or 0.0, 3),
                           "load": round(load or 0.0, 3)})
        elif st["saturated"] and st["clear_n"] >= self.clear_ticks:
            st["saturated"] = False
            self.stats.incr("saturation_cleared")
            get_journal().emit("saturation_cleared", resource=name,
                               headroom=round(headroom, 4))
        self.stats.set_gauge(f"saturated_{name}",
                             1.0 if st["saturated"] else 0.0)

    def snapshot(self) -> dict:
        """The StageStats-shaped saturation block (gauges ``headroom_*``
        / ``knee_*`` / ``load_*`` / ``busy_*`` / ``saturated_*``,
        transition counters) — what the worker stats beacon carries and
        the coordinating process merges."""
        return self.stats.snapshot()

    # ---- exposition ----

    def render_prometheus(self, prefix: str = PREFIX) -> str:
        """The ``mmlspark_tpu_capacity_*`` families (joined to every
        scrape through the registry's exposition-provider hook)."""
        snap = self.stats.snapshot()
        gauges: Dict[str, float] = snap.get("gauges") or {}
        lines: List[str] = []

        def fam(suffix: str, help_: str) -> str:
            name = f"{prefix}_capacity_{suffix}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            return name

        n = fam("enabled",
                "1 while capacity observability is sampling.")
        lines.append(f"{n} {1 if capacity_enabled() else 0}")

        def by_prefix(p: str) -> List[Tuple[str, float]]:
            return sorted((k[len(p):], v) for k, v in gauges.items()
                          if k.startswith(p))

        fams = (
            ("headroom_ratio", "headroom_", "resource",
             "Current load / estimated knee load (0 while the knee is "
             "unknown; >= ~0.9 is approaching saturation)."),
            ("knee_load", "knee_", "resource",
             "Estimated goodput-knee load (rows/s or frames/s; 0 = "
             "not yet estimable)."),
            ("load", "load_", "resource",
             "Current windowed load (rows/s or frames/s)."),
            ("saturated", "saturated_", "resource",
             "1 while the resource is past saturation onset "
             "(hysteresis-debounced)."),
            ("busy_fraction", "busy_", "phase",
             "Fraction of wall-clock the phase was executing over the "
             "last sampling interval (per-process; can exceed 1 with "
             "concurrent workers)."),
        )
        for suffix, gpfx, label, help_ in fams:
            vals = by_prefix(gpfx)
            if not vals:
                continue
            n = fam(suffix, help_)
            for key, v in vals:
                lines.append(f"{n}{_labels({label: key})} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    # ---- background ticker ----

    def start(self, interval_s: float = 1.0) -> "CapacityMonitor":
        """Start the 1 Hz (default) sampling ticker; idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.sample()
                except Exception:  # noqa: BLE001 - the observer must
                    pass           # outlive a transient registry error

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="capacity-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- process-global install --------------------------------------------------


_cap_lock = threading.Lock()
_cap_monitor: Optional[CapacityMonitor] = None


def peek_capacity_monitor() -> Optional[CapacityMonitor]:
    """The installed monitor, or ``None`` — never creates one (the
    stats beacon peeks so a worker without a monitor sends no block)."""
    return _cap_monitor


def get_capacity_monitor() -> CapacityMonitor:
    """The process-global monitor (created and registered on first
    use; replace with :func:`set_capacity_monitor`)."""
    global _cap_monitor
    with _cap_lock:
        if _cap_monitor is None:
            _set_locked(CapacityMonitor())
        return _cap_monitor


def set_capacity_monitor(monitor: CapacityMonitor) -> CapacityMonitor:
    """Install ``monitor`` as the process-global one, registering its
    stats under ns ``capacity`` (that is where the ``*_headroom`` SLO
    objectives read the headroom gauges) and its ``capacity_*``
    exposition into the global registry."""
    with _cap_lock:
        return _set_locked(monitor)


def _set_locked(monitor: CapacityMonitor) -> CapacityMonitor:
    global _cap_monitor
    old, _cap_monitor = _cap_monitor, monitor
    if old is not None:
        old.stop()
    get_registry().register("capacity", monitor.stats)
    get_registry().register_exposition(
        "capacity", lambda: _cap_monitor.render_prometheus()
        if _cap_monitor is not None else "")
    return monitor


def ensure_capacity_sampler(interval_s: float = 1.0
                            ) -> Optional[CapacityMonitor]:
    """Idempotent engine-startup hook: install the global monitor and
    start its ticker — unless capacity observability is disabled, in
    which case nothing is created and ``None`` returns (the sentinel's
    disabled arm must cost zero)."""
    if not capacity_enabled():
        return None
    m = get_capacity_monitor()
    m.start(interval_s)
    return m


# -- /statusz ----------------------------------------------------------------


def render_statusz(model_info: Optional[dict] = None,
                   workers: Optional[Dict[str, dict]] = None) -> str:
    """One human-readable operational summary (the ``/statusz`` route
    body): active model version, SLO burn states, headroom ratios,
    top-3 busiest phases, worker liveness — ALL assembled from the
    registries that already exist; no new state, and any piece that
    fails to render degrades to a line saying so (a status page must
    not 500 because one subsystem is sick)."""
    from .profiler import get_profiler
    from .slo import get_monitor
    lines: List[str] = [f"{PREFIX} statusz",
                        time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime()), ""]
    # model
    lines.append("== model ==")
    if model_info:
        for k in sorted(model_info):
            lines.append(f"  {k}: {model_info[k]}")
    else:
        lines.append("  (no model info provider)")
    # slo
    lines.append("")
    lines.append("== slo burn ==")
    try:
        rep = get_monitor().report()
        breaching = rep.get("breaching") or []
        lines.append(f"  healthy: {rep.get('healthy')}"
                     f"  breaching: {breaching or 'none'}")
        for name in sorted(rep.get("objectives") or {}):
            v = rep["objectives"][name]
            lines.append(
                f"  {name}: burn_fast={v.get('burn_rate_fast')} "
                f"burn_slow={v.get('burn_rate_slow')} "
                f"{'BREACH' if v.get('breach') else 'ok'}")
    except Exception as e:  # noqa: BLE001 - status must render anyway
        lines.append(f"  (slo monitor unavailable: {e!r})")
    # capacity / headroom
    lines.append("")
    lines.append("== capacity headroom ==")
    cm = peek_capacity_monitor()
    if cm is None:
        lines.append("  (no capacity monitor installed)")
    else:
        try:
            gauges = cm.snapshot().get("gauges") or {}
            names = cm.resource_names()
            for r in names:
                lines.append(
                    f"  {r}: headroom={gauges.get(f'headroom_{r}', 0)} "
                    f"knee={gauges.get(f'knee_{r}', 0)} "
                    f"load={gauges.get(f'load_{r}', 0)} "
                    f"saturated="
                    f"{int(gauges.get(f'saturated_{r}', 0) or 0)}")
            if not names:
                lines.append("  (no resources tracked)")
        except Exception as e:  # noqa: BLE001
            lines.append(f"  (capacity monitor unavailable: {e!r})")
    # top phases
    lines.append("")
    lines.append("== top phases (by total_s) ==")
    try:
        stages = (get_profiler().stats.snapshot().get("stages") or {})
        top = sorted(stages.items(),
                     key=lambda kv: -float(
                         kv[1].get("total_s", 0.0) or 0.0))[:3]
        for phase, s in top:
            lines.append(
                f"  {phase}: total_s={s.get('total_s')} "
                f"count={s.get('count')} p50_ms={s.get('p50_ms')}")
        if not top:
            lines.append("  (no phases recorded)")
    except Exception as e:  # noqa: BLE001
        lines.append(f"  (profiler unavailable: {e!r})")
    # workers
    lines.append("")
    lines.append("== workers ==")
    if workers:
        for w in sorted(workers):
            info = workers[w] or {}
            up = info.get("up")
            age = info.get("beacon_age_s")
            lines.append(
                f"  {w}: {'up' if up else 'DOWN'}"
                + (f" beacon_age_s={round(age, 2)}"
                   if age is not None else ""))
    else:
        lines.append("  (single-process: no worker fleet)")
    return "\n".join(lines) + "\n"
