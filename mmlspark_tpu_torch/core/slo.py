"""SLO burn-rate monitor.

The port's copy of ``mmlspark_tpu/core/slo.py``, kept line for line so
both packages evaluate the same objectives alike.

The serving and chaos layers *defend* implicit objectives — goodput,
deadline misses, shedding, transport health, heartbeat freshness — but
until now nothing in the repo *evaluated* them: the drills asserted
point facts and the dashboards showed raw counters.  This module closes
that loop with the multiwindow burn-rate discipline (Google SRE
workbook, ch. 5): each declared objective has an error budget
(``1 - target``), and the monitor reports how fast the budget is being
consumed over a FAST and a SLOW window.  A breach requires both windows
to burn — the fast window reacts quickly, the slow window filters
blips — which is what makes the verdict pageable rather than noisy.

Pieces:

* :class:`SLObjective` — one declared objective: either a RATIO over
  registry counters (``bad`` events / ``total`` events, e.g. expired /
  (rows + expired)) or a GAUGE freshness bound (fraction of samples
  where the gauge exceeded ``threshold`` — heartbeat staleness has no
  event counter to ratio over).
* :class:`SLOMonitor` — samples the process
  :class:`~mmlspark_tpu_torch.core.telemetry.MetricsRegistry`, keeps a
  bounded ring of cumulative readings, computes windowed bad-ratios and
  burn rates, journals ``slo_burn`` / ``slo_recovered`` transition
  events, and renders the ``mmlspark_tpu_slo_*`` gauge families into
  every ``/metrics`` scrape (via the registry's exposition-provider
  hook).  ``/slo`` on every serving server returns
  :meth:`SLOMonitor.report` as JSON.
* :func:`default_objectives` — the objectives the production substrate
  implicitly defends, declared explicitly.

``tools/bench_serving.py`` and both chaos drills sample a monitor
through their load phases and embed its verdict in their artifacts, so
every committed run carries "was the SLO being burned, and how fast"
next to the raw numbers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .telemetry import PREFIX, get_journal, get_registry

__all__ = ["SLObjective", "SLOMonitor", "default_objectives",
           "get_monitor", "set_monitor"]

#: (namespace, key) counter spec; ``key == "rows"`` reads the rows
#: counter, anything else reads ``counters[key]``
Spec = Tuple[str, str]


@dataclass
class SLObjective:
    """One declared service-level objective.

    Ratio form (``bad``/``total`` set): the windowed error rate is
    ``Δbad / Δtotal`` from registry counter deltas; ``target`` is the
    success objective (0.999 → 0.1% error budget).

    Gauge form (``gauge`` set): each monitor sample scores 1 when the
    gauge exceeds ``threshold``; the windowed error rate is the bad
    fraction of samples — "the heartbeat may be stale at most 1% of
    the time" has no event counter, only observations.
    """
    name: str
    target: float
    description: str = ""
    bad: Tuple[Spec, ...] = ()
    total: Tuple[Spec, ...] = ()
    gauge: Optional[Spec] = None
    threshold: float = 0.0

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - float(self.target))


def default_objectives() -> Tuple[SLObjective, ...]:
    """The objectives the serving/chaos stack implicitly defends."""
    # local import: capacity pulls in telemetry/profiling and this
    # module is imported during interpreter-level bootstrap paths
    from .capacity import SATURATION_ONSET_RATIO
    return (
        SLObjective(
            "scoring_goodput", 0.999,
            "scored rows vs requests degraded (shed or expired)",
            bad=(("scoring", "shed"), ("scoring", "expired")),
            total=(("scoring", "rows"), ("scoring", "shed"),
                   ("scoring", "expired"))),
        SLObjective(
            "scoring_deadline_miss", 0.999,
            "requests expired (504) past their deadline",
            bad=(("scoring", "expired"),),
            total=(("scoring", "rows"), ("scoring", "expired"))),
        SLObjective(
            "scoring_shed", 0.99,
            "requests shed (503) by admission control",
            bad=(("scoring", "shed"),),
            total=(("scoring", "rows"), ("scoring", "shed"))),
        SLObjective(
            "transport_retransmit", 0.99,
            "exchange frames needing retransmission",
            bad=(("transport", "retransmits"),),
            total=(("transport", "frames_sent"),)),
        SLObjective(
            "heartbeat_freshness", 0.99,
            "fraction of time the worst peer heartbeat stays fresh",
            gauge=("elastic", "heartbeat_age_ms"), threshold=2000.0),
        SLObjective(
            "feature_drift", 0.99,
            "worst per-feature PSI (live traffic vs the fit-time "
            "reference profile) staying under the drift threshold "
            "(core/drift.py publishes the gauge under ns='drift'; "
            "silent until a drift monitor is installed).  The "
            "threshold MATCHES DriftConfig.psi_threshold's default — "
            "the burn gate and the instantaneous alert gauge must "
            "agree on what 'drifted' means",
            gauge=("drift", "psi_worst"), threshold=0.25),
        SLObjective(
            "prediction_drift", 0.99,
            "prediction-margin PSI (live scoring output vs the "
            "fit-time training-margin sketch) staying under the "
            "drift threshold (silent until a drift monitor runs)",
            gauge=("drift", "psi_prediction"), threshold=0.25),
        SLObjective(
            "perf_latency_budget", 0.99,
            "perf-sentinel worst stage-vs-baseline ratio staying "
            "inside the latency budget (tools/perf_sentinel.py "
            "publishes the gauge; silent until a sentinel ran).  The "
            "threshold MATCHES the sentinel's relative regression "
            "gate (--rel, default 1.8) — a stricter SLO would breach "
            "on runs the sentinel itself calls healthy",
            gauge=("perf", "worst_regression_ratio"), threshold=1.8),
        SLObjective(
            "scoring_headroom", 0.99,
            "scoring load staying below the saturation-onset fraction "
            "of the estimated capacity knee (core/capacity.py "
            "publishes the headroom gauge under ns='capacity'; silent "
            "until a capacity monitor runs).  Burns BEFORE "
            "scoring_goodput does: headroom crosses onset while "
            "requests are still being answered in time, so the page "
            "says 'approaching saturation', not 'SLO violated'",
            gauge=("capacity", "headroom_scoring"),
            threshold=SATURATION_ONSET_RATIO),
        SLObjective(
            "transport_headroom", 0.99,
            "transport load staying below the saturation-onset "
            "fraction of the estimated wire-capacity knee (silent "
            "until a capacity monitor runs)",
            gauge=("capacity", "headroom_transport"),
            threshold=SATURATION_ONSET_RATIO),
    )


def _read_spec(snapshot: Dict[str, dict], specs: Sequence[Spec]
               ) -> float:
    out = 0.0
    for ns, key in specs:
        src = snapshot.get(ns)
        if not isinstance(src, dict):
            continue
        if key == "rows":
            out += float(src.get("rows", 0) or 0)
        else:
            out += float((src.get("counters") or {}).get(key, 0) or 0)
    return out


class SLOMonitor:
    """Windowed burn-rate evaluator over the metrics registry.

    ``sample()`` appends one cumulative reading per objective;
    ``evaluate()`` computes, per objective and per window, the bad
    ratio (``Δbad/Δtotal`` across the window's samples) and the burn
    rate (``bad_ratio / error_budget`` — burn 1.0 means the budget is
    being consumed exactly at the sustainable rate; burn 14.4 over the
    fast window means a 30-day budget dies in 2 days).  A breach
    requires BOTH windows above their thresholds.  Deterministic given
    its samples: tools drive ``sample()`` manually for reproducible
    artifacts, or ``start()`` a background ticker for live serving.
    """

    def __init__(self, objectives: Optional[Sequence[SLObjective]] = None,
                 registry=None, *,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 fast_burn_threshold: float = 14.4,
                 slow_burn_threshold: float = 6.0,
                 capacity: int = 4096):
        self.objectives = tuple(objectives if objectives is not None
                                else default_objectives())
        self._registry = registry
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)
        self._lock = threading.Lock()
        #: ring of (t_monotonic, {name: (cum_bad, cum_total)})
        self._samples: "deque[Tuple[float, Dict[str, Tuple[float, float]]]]" \
            = deque(maxlen=int(capacity))
        #: gauge objectives accumulate synthetic counters here (one
        #: observation per sample), so both forms window identically
        self._gauge_cum: Dict[str, Tuple[float, float]] = {}
        self._breached: Dict[str, bool] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- sampling ----

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    def maybe_sample(self, min_interval_s: float = 0.5) -> None:
        """Take a sample unless one was taken within
        ``min_interval_s`` — the scrape-driven sampling mode: a
        deployment watched only through ``/metrics`` (no ticker, no
        ``/slo`` probes) still accumulates one reading per scrape, so
        the burn gauges move instead of rendering NaN forever."""
        with self._lock:
            if self._samples and (time.monotonic() - self._samples[-1][0]
                                  < min_interval_s):
                return
        self.sample()

    def sample(self, now: Optional[float] = None) -> None:
        """Take one reading of every objective's counters/gauges."""
        snap = self._reg().snapshot()
        t = time.monotonic() if now is None else float(now)
        reading: Dict[str, Tuple[float, float]] = {}
        with self._lock:
            for obj in self.objectives:
                if obj.gauge is not None:
                    ns, key = obj.gauge
                    src = snap.get(ns)
                    val = None
                    if isinstance(src, dict):
                        val = (src.get("gauges") or {}).get(key)
                    cb, ct = self._gauge_cum.get(obj.name, (0.0, 0.0))
                    if val is not None:
                        cb += 1.0 if float(val) > obj.threshold else 0.0
                        ct += 1.0
                    self._gauge_cum[obj.name] = (cb, ct)
                    reading[obj.name] = (cb, ct)
                else:
                    reading[obj.name] = (_read_spec(snap, obj.bad),
                                         _read_spec(snap, obj.total))
            self._samples.append((t, reading))

    # ---- evaluation ----

    def _window_ratio(self, name: str, window_s: float,
                      samples) -> Tuple[Optional[float], float]:
        """(bad_ratio or None when the window saw no events, Δtotal)
        over the trailing ``window_s``."""
        if len(samples) < 2:
            return None, 0.0
        t_end, end = samples[-1]
        base = samples[0]
        for t, reading in samples:
            if t <= t_end - window_s:
                base = (t, reading)      # newest sample OUTSIDE window
            else:
                break
        b0, t0 = base[1].get(name, (0.0, 0.0))
        b1, t1 = end.get(name, (0.0, 0.0))
        dtotal = max(0.0, t1 - t0)
        if dtotal <= 0:
            return None, 0.0
        dbad = min(dtotal, max(0.0, b1 - b0))
        return dbad / dtotal, dtotal

    def evaluate(self) -> Dict[str, dict]:
        """Per-objective burn verdicts; journals ``slo_burn`` /
        ``slo_recovered`` on breach transitions."""
        with self._lock:
            samples = list(self._samples)
        out: Dict[str, dict] = {}
        transitions: List[Tuple[str, bool, dict]] = []
        for obj in self.objectives:
            fast, n_fast = self._window_ratio(
                obj.name, self.fast_window_s, samples)
            slow, n_slow = self._window_ratio(
                obj.name, self.slow_window_s, samples)
            burn_fast = (fast / obj.budget) if fast is not None else None
            burn_slow = (slow / obj.budget) if slow is not None else None
            breach = (burn_fast is not None and burn_slow is not None
                      and burn_fast > self.fast_burn_threshold
                      and burn_slow > self.slow_burn_threshold)
            rec = {
                "target": obj.target,
                "budget": obj.budget,
                "bad_ratio_fast": None if fast is None
                else round(fast, 6),
                "bad_ratio_slow": None if slow is None
                else round(slow, 6),
                "burn_rate_fast": None if burn_fast is None
                else round(burn_fast, 3),
                "burn_rate_slow": None if burn_slow is None
                else round(burn_slow, 3),
                "events_fast": n_fast,
                "events_slow": n_slow,
                "breach": breach,
            }
            out[obj.name] = rec
            # transition detection is read-compare-write on _breached:
            # under the lock, or two concurrent evaluators (ticker +
            # scrape) double-journal one onset or lose a recovery
            with self._lock:
                was = self._breached.get(obj.name, False)
                if breach != was:
                    self._breached[obj.name] = breach
                    transitions.append((obj.name, breach, rec))
        for name, breach, rec in transitions:
            get_journal().emit(
                "slo_burn" if breach else "slo_recovered", slo=name,
                burn_fast=rec["burn_rate_fast"],
                burn_slow=rec["burn_rate_slow"],
                target=rec["target"])
        return out

    def report(self) -> dict:
        """Sample + evaluate — the ``/slo`` route body and the shape
        the tools embed in their artifacts."""
        self.sample()
        verdicts = self.evaluate()
        return {
            "objectives": verdicts,
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "burn_thresholds": {"fast": self.fast_burn_threshold,
                                "slow": self.slow_burn_threshold},
            "samples": len(self._samples),
            "breaching": sorted(n for n, v in verdicts.items()
                                if v["breach"]),
            "healthy": not any(v["breach"] for v in verdicts.values()),
        }

    # ---- exposition ----

    def render_prometheus(self, prefix: str = PREFIX) -> str:
        """The ``mmlspark_tpu_slo_*`` gauge families (appended to every
        registry render through ``register_exposition``).  Each render
        also samples (rate-limited): a Prometheus-only deployment gets
        scrape-driven readings with no ticker or ``/slo`` probes."""
        self.maybe_sample()
        verdicts = self.evaluate()
        lines: List[str] = []

        def fam(suffix: str, help_: str) -> str:
            name = f"{prefix}_slo_{suffix}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            return name

        n = fam("objective", "Declared success objective (target).")
        for obj in self.objectives:
            lines.append(f'{n}{{slo="{obj.name}"}} {obj.target}')
        n = fam("bad_ratio",
                "Windowed error rate (bad events / total events).")
        for name, v in verdicts.items():
            for w in ("fast", "slow"):
                r = v[f"bad_ratio_{w}"]
                lines.append(
                    f'{n}{{slo="{name}",window="{w}"}} '
                    f'{"NaN" if r is None else r}')
        n = fam("burn_rate",
                "Error-budget burn rate (1.0 = sustainable).")
        for name, v in verdicts.items():
            for w in ("fast", "slow"):
                r = v[f"burn_rate_{w}"]
                lines.append(
                    f'{n}{{slo="{name}",window="{w}"}} '
                    f'{"NaN" if r is None else r}')
        n = fam("breach",
                "1 while both windows burn above threshold.")
        for name, v in verdicts.items():
            lines.append(
                f'{n}{{slo="{name}"}} {1 if v["breach"] else 0}')
        return "\n".join(lines) + "\n"

    # ---- background ticker ----

    def start(self, tick_s: float = 1.0) -> "SLOMonitor":
        self._stop.clear()

        def loop():
            while not self._stop.wait(tick_s):
                try:
                    self.sample()
                    self.evaluate()
                except Exception:  # noqa: BLE001 - the monitor must
                    pass           # outlive a transient registry error

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_monitor_lock = threading.Lock()
_monitor: Optional[SLOMonitor] = None


def get_monitor() -> SLOMonitor:
    """The process-global monitor the ``/slo`` route reports and the
    ``/metrics`` exposition carries (created on first use with the
    default objectives; replace with :func:`set_monitor`)."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            set_monitor_locked(SLOMonitor())
        return _monitor


def set_monitor(monitor: SLOMonitor) -> SLOMonitor:
    """Install ``monitor`` as the process-global one (re-pointing the
    registry's ``slo`` exposition at it)."""
    with _monitor_lock:
        return set_monitor_locked(monitor)


def set_monitor_locked(monitor: SLOMonitor) -> SLOMonitor:
    global _monitor
    _monitor = monitor
    get_registry().register_exposition(
        "slo", lambda: _monitor.render_prometheus()
        if _monitor is not None else "")
    return monitor
