"""Streaming drift monitor — live traffic vs the fit-time reference
profile.

The port's copy of ``mmlspark_tpu/core/drift.py`` (numpy and the
port's telemetry, nothing of torch), kept line for line so both
packages reach the same verdicts on the same stream.

:class:`DriftMonitor` sits on the scoring hot path (the engine hands it
the already-decoded float32 batch and the margins it just scored),
maintains live :mod:`~mmlspark_tpu_torch.core.sketch` sketches behind a
duty-cycle gate, and continuously compares them against the
:class:`~mmlspark_tpu_torch.core.sketch.ReferenceProfile` captured at fit
time:

* **PSI / JS per feature** and for the prediction-margin distribution,
  plus null-rate deltas and out-of-training-range ratios.
* **Gauges** (``psi_worst`` / ``psi_prediction`` / ``null_delta_worst``
  / ``oor_worst``) published through the monitor's StageStats-shaped
  ``snapshot()`` so the :mod:`~mmlspark_tpu_torch.core.slo` gauge objectives
  (``feature_drift`` / ``prediction_drift``) and the
  :class:`~mmlspark_tpu_torch.io.rollout.RolloutController`'s live-traffic
  drift objective read them exactly like every other gauge.
* **Journal events** — ``drift_onset`` when a signal (a feature or the
  prediction distribution) crosses its PSI threshold with enough live
  evidence, ``drift_recovered`` when it drops back; onsets also write a
  crash-flight record so the post-mortem carries the scene.
* **Cross-process merging** — ``snapshot()["counters"]`` flattens the
  sketch tallies under stable keys (``f<j>.b<i>`` / ``f<j>.nan`` /
  ``m.b<i>`` ...), so the existing
  :func:`~mmlspark_tpu_torch.core.telemetry.merge_snapshots` sums them
  EXACTLY like StageStats counters — the multiprocess stats beacon and
  ``tools/drift_report.py`` recompute divergences from the merged
  counts, never an average of per-worker PSIs.

Overhead contract (same discipline as the profiler's sampler): each
``observe`` measures its own cost and arms a cooldown of
``cost * (1/duty - 1)`` seconds, so the sketch work is bounded to a
``duty`` fraction of wall time no matter the traffic rate; batches
inside the cooldown only bump the ``rows_skipped`` counter.  The perf
sentinel A/Bs the whole path enabled-vs-disabled under a <3% p50 gate.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from .sketch import (ReferenceProfile, StreamSketch, js_divergence,
                     merge_sketch_snapshots, psi)
from .telemetry import (PREFIX, _fmt, _labels, get_journal,
                        get_registry, record_flight)

log = logging.getLogger(__name__)

__all__ = ["DriftConfig", "DriftMonitor", "drift_report_from_counters",
           "get_drift_monitor", "peek_drift_monitor",
           "set_drift_monitor", "sketches_from_counters"]

#: registry namespace the process-global monitor federates under
DRIFT_NS = "drift"


@dataclass
class DriftConfig:
    """Monitor knobs (docs/observability.md §Drift)."""
    #: duty-cycle cap on the sketch-update cost share of wall time —
    #: 2% keeps the whole path inside the perf sentinel's <3% p50
    #: overhead gate with margin for the per-batch fixed cost
    duty: float = 0.02
    #: PSI above this flags a feature as drifting
    psi_threshold: float = 0.25
    #: PSI above this flags the prediction distribution
    prediction_psi_threshold: float = 0.25
    #: absolute null-rate increase (live − reference) that flags a
    #: feature regardless of PSI (a NaN storm is a quality incident
    #: even while the non-null values still look on-distribution)
    null_delta_threshold: float = 0.10
    #: minimum live rows per signal before any verdict — PSI over a
    #: handful of rows is noise, and a false page is the one thing the
    #: clean-traffic drill forbids
    min_rows: int = 200
    #: re-evaluation cadence (evaluations are O(f · buckets), far
    #: heavier than an observe — never per batch)
    eval_interval_s: float = 1.0
    #: recency half-window: drift VERDICTS are computed over the last
    #: 1–2 windows of traffic (two rotating sketch epochs, exactly the
    #: LatencyStats discipline) so a shift that starts after days of
    #: clean history is judged against recent rows, not diluted under
    #: millions of historical ones; the CUMULATIVE counters the scrape
    #: merges keep the all-time totals regardless
    window_s: float = 600.0


class DriftMonitor:
    """Live sketches + reference comparison + alert state machine.

    Thread-safe; ``observe`` is the only hot-path entry point and is
    safe to call from several scoring workers at once.
    """

    GAUGE_SEED = ("psi_worst", "psi_prediction", "null_delta_worst",
                  "oor_worst")

    def __init__(self, profile: ReferenceProfile,
                 config: Optional[DriftConfig] = None, *,
                 enabled: bool = True):
        self.profile = profile
        self.cfg = config or DriftConfig()
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # three sketch generations (LatencyStats' epoch discipline):
        # verdicts read prev+recent (the last 1-2 windows); rotation
        # folds the outgoing epoch into the cumulative sketch, so the
        # scrape counters always carry the exact all-time totals
        self._cum = profile.live_matrix_sketch()
        self._cum_m = profile.live_margin_sketch()
        self._recent = profile.live_matrix_sketch()
        self._recent_m = profile.live_margin_sketch()
        self._prev = None
        self._prev_m = None
        self._epoch_t = time.monotonic()
        # async sketch pipeline (the <3% overhead contract): the hot
        # path only gate-checks, copies the batch (a few KB) and
        # enqueues; a daemon drain thread does the actual
        # searchsorted/bincount work, so a sketch update never stalls
        # a scoring worker (and the closed-loop pipeline behind it)
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self._last_cost = 1e-3
        self._thread: Optional[threading.Thread] = None
        self._thread_stop = threading.Event()
        self._rows_observed = 0
        self._rows_skipped = 0
        self._next_ok = 0.0
        self._last_eval = 0.0
        self._report: Dict[str, Any] = {}
        self._gauges: Dict[str, float] = {
            k: 0.0 for k in self.GAUGE_SEED}
        self._alerting: Dict[str, bool] = {}
        # reference dist vectors resolved once — evaluate() is called
        # on a cadence, but why re-ravel the profile every time
        self._ref_feats = [profile.ref_feature(j)
                           for j in range(profile.num_features)]
        self._ref_margin = profile.ref_margin()

    # -- hot path ------------------------------------------------------------

    def _roll_locked(self) -> None:
        """Rotate the recency epochs (called under the lock): the
        outgoing epoch merges into the cumulative sketch — counters
        lose nothing — and after a traffic gap of 2+ windows BOTH
        epochs are stale and fold away (the LatencyStats rule)."""
        elapsed = time.monotonic() - self._epoch_t
        if elapsed < self.cfg.window_s:
            return
        if self._prev is not None:
            self._cum.merge(self._prev)
            self._cum_m.merge(self._prev_m)
        if elapsed >= 2 * self.cfg.window_s:
            self._cum.merge(self._recent)
            self._cum_m.merge(self._recent_m)
            self._recent = self.profile.live_matrix_sketch()
            self._recent_m = self.profile.live_margin_sketch()
            self._prev = None
            self._prev_m = None
        else:
            self._prev = self._recent
            self._prev_m = self._recent_m
            self._recent = self.profile.live_matrix_sketch()
            self._recent_m = self.profile.live_margin_sketch()
        self._epoch_t = time.monotonic()

    def observe(self, X, margins=None) -> bool:
        """Offer one scored batch (decoded float32 rows + the margins
        they scored to).  Returns True when the batch was accepted for
        sketching, False when the duty-cycle gate (or a full queue)
        skipped it.  Never raises — a drift-observation bug must not
        fail a scoring batch.

        Hot-path contract: one LOCK-FREE clock read against
        ``_next_ok``, then (gate open) a defensive copy of the batch
        and a non-blocking enqueue — the searchsorted/bincount sketch
        work runs on the monitor's daemon drain thread, never inline
        with scoring.  Skip accounting is best-effort (plain, unlocked
        increments): a racing pair of workers can under-count
        ``rows_skipped`` or both slip through one gate window, which
        costs one extra queued update, not correctness."""
        if not self.enabled:
            return False
        now = time.perf_counter()
        if now < self._next_ok:
            try:
                self._rows_skipped += len(X)
            except TypeError:
                pass
            return False
        try:
            X = np.asarray(X)
            if X.ndim != 2:
                return False
            n = int(X.shape[0])
            item = (np.array(X, np.float32, copy=True),
                    None if margins is None
                    else np.array(margins, copy=True), n)
            self._q.put_nowait(item)
        except queue.Full:
            self._rows_skipped += n
            return False
        except Exception:  # noqa: BLE001 - observation is advisory
            log.exception("drift observe failed; batch skipped")
            return False
        # provisional cooldown from the LAST measured update cost (the
        # drain thread refines it after this update actually runs) so a
        # burst cannot flood the queue inside one gate window
        duty = max(1e-4, float(self.cfg.duty))
        self._next_ok = now + self._last_cost * (1.0 / duty - 1.0)
        self._ensure_thread()
        return True

    def _ensure_thread(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._drain, name="drift-sketch",
                    daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        """Daemon worker: apply queued batch updates to the sketches
        and keep the duty-cycle cooldown honest with measured costs."""
        while not self._thread_stop.is_set():
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                if item is None:
                    return
                X, margins, n = item
                with self._lock:
                    self._roll_locked()
                    t0 = time.perf_counter()
                    self._recent.update(X)
                    if margins is not None:
                        self._recent_m.update(margins)
                    self._rows_observed += n
                    cost = time.perf_counter() - t0
                self._last_cost = cost
                duty = max(1e-4, float(self.cfg.duty))
                self._next_ok = time.perf_counter() \
                    + cost * (1.0 / duty - 1.0)
            except Exception:  # noqa: BLE001 - one bad batch must not
                log.exception("drift sketch update failed")
            finally:
                self._q.task_done()

    def flush(self, timeout: float = 2.0) -> bool:
        """Wait (bounded) until every queued batch has been sketched —
        control-plane callers (reports, drills, tests) read AFTER the
        async pipeline drained.  Returns False on timeout."""
        deadline = time.monotonic() + timeout
        # Queue.join() has no timeout; unfinished_tasks counts queued
        # AND in-flight items (decremented by task_done), which is
        # exactly the "work outstanding" signal a bounded wait needs
        while self._q.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def close(self) -> None:
        """Stop the drain thread (idempotent; queued work is
        abandoned).  Monitors are normally process-lifetime — this is
        for tests and tools that create many."""
        self._thread_stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None

    # -- sketch views --------------------------------------------------------

    def _parts_locked(self, window_only: bool):
        parts = [] if window_only else [(self._cum, self._cum_m)]
        if self._prev is not None:
            parts.append((self._prev, self._prev_m))
        parts.append((self._recent, self._recent_m))
        return parts

    def _merged_locked(self, window_only: bool):
        """(feature sketches, margin sketch) merged over the chosen
        epochs; a window with no traffic degrades to the lifetime
        view instead of judging an empty sketch."""
        parts = self._parts_locked(window_only)
        feats: List[StreamSketch] = []
        for j in range(self.profile.num_features):
            lo, hi = self.profile.feature_span(j)
            snap = merge_sketch_snapshots(
                [p[0].features[j].snapshot() for p in parts])
            feats.append(StreamSketch.from_snapshot(
                snap, self.profile.feature_edges[j], lo, hi))
        margin = StreamSketch.from_snapshot(
            merge_sketch_snapshots([p[1].snapshot() for p in parts]),
            self.profile.margin_edges)
        if window_only and margin.total == 0 \
                and all(f.total == 0 for f in feats):
            return self._merged_locked(False)
        return feats, margin

    # -- evaluation ----------------------------------------------------------

    def _signal_reports(self) -> List[Dict[str, Any]]:
        """Per-signal comparison rows (features + ``_prediction_``),
        judged over the recent 1-2 windows (lifetime fallback when the
        window is empty)."""
        rows: List[Dict[str, Any]] = []
        with self._lock:
            self._roll_locked()
            live_feats, live_margin = self._merged_locked(True)
        for j, live in enumerate(live_feats):
            ref = self._ref_feats[j]
            rows.append(self._compare(
                self.profile.feature_names[j], ref, live,
                feature_index=j))
        rows.append(self._compare("_prediction_", self._ref_margin,
                                  live_margin, feature_index=None))
        return rows

    def _compare(self, name: str, ref: StreamSketch,
                 live: StreamSketch,
                 feature_index: Optional[int]) -> Dict[str, Any]:
        rows = live.total
        enough = rows >= self.cfg.min_rows
        p = psi(ref.dist_counts(), live.dist_counts()) if enough \
            else 0.0
        js = js_divergence(ref.dist_counts(), live.dist_counts()) \
            if enough else 0.0
        null_ref = ref.null_rate()
        null_live = live.null_rate()
        rec = {
            "signal": name,
            "feature_index": feature_index,
            "rows": rows,
            "enough_rows": enough,
            "psi": round(p, 6),
            "js": round(js, 6),
            "null_rate_ref": round(null_ref, 6),
            "null_rate_live": round(null_live, 6),
            "null_delta": round(null_live - null_ref, 6),
            "oor_rate": round(live.oor_rate(), 6),
            "mean_ref": round(ref.mean, 6),
            "mean_live": round(live.mean, 6),
            "quantiles_ref": [round(ref.quantile(q), 6)
                              for q in (0.1, 0.5, 0.9)],
            "quantiles_live": [round(live.quantile(q), 6)
                               for q in (0.1, 0.5, 0.9)],
        }
        thr = self.cfg.prediction_psi_threshold \
            if name == "_prediction_" else self.cfg.psi_threshold
        rec["alert"] = bool(enough and (
            p > thr
            or (feature_index is not None
                and rec["null_delta"] > self.cfg.null_delta_threshold)))
        return rec

    def evaluate(self, force: bool = False) -> Dict[str, Any]:
        """Recompute the drift report (rate-limited unless ``force``),
        refresh the gauges, and journal alert transitions."""
        now = time.monotonic()
        with self._lock:
            if not force and self._report \
                    and now - self._last_eval < self.cfg.eval_interval_s:
                return self._report
            self._last_eval = now
        signals = self._signal_reports()
        feat = [s for s in signals if s["feature_index"] is not None]
        pred = signals[-1]
        worst = max(feat, key=lambda s: s["psi"], default=None)
        gauges = {
            "psi_worst": max((s["psi"] for s in feat), default=0.0),
            "psi_prediction": pred["psi"],
            "null_delta_worst": max(
                (s["null_delta"] for s in feat), default=0.0),
            "oor_worst": max((s["oor_rate"] for s in feat),
                             default=0.0),
        }
        report = {
            "signals": signals,
            "worst_feature": worst["signal"] if worst else None,
            "alerting": sorted(s["signal"] for s in signals
                               if s["alert"]),
            "gauges": {k: round(v, 6) for k, v in gauges.items()},
            "rows_observed": self._rows_observed,
            "rows_skipped": self._rows_skipped,
            "thresholds": {
                "psi": self.cfg.psi_threshold,
                "prediction_psi": self.cfg.prediction_psi_threshold,
                "null_delta": self.cfg.null_delta_threshold,
                "min_rows": self.cfg.min_rows,
            },
        }
        transitions = []
        with self._lock:
            self._gauges.update(gauges)
            self._report = report
            for s in signals:
                was = self._alerting.get(s["signal"], False)
                if s["alert"] != was:
                    self._alerting[s["signal"]] = s["alert"]
                    transitions.append(s)
        for s in transitions:
            ev = {"signal": s["signal"], "psi": s["psi"],
                  "null_delta": s["null_delta"], "rows": s["rows"]}
            if s["alert"]:
                get_journal().emit("drift_onset", **ev)
                record_flight("drift_onset", ev)
            else:
                get_journal().emit("drift_recovered", **ev)
        return report

    def report(self) -> Dict[str, Any]:
        """Drained, freshly-evaluated report (the control-plane read)."""
        self.flush()
        return self.evaluate(force=True)

    # -- telemetry surfaces --------------------------------------------------

    @staticmethod
    def _flat_counters(feature_snaps: List[dict],
                       margin_snap: dict) -> Dict[str, int]:
        """The cross-process wire form: every sketch tally flattened
        under stable keys so plain counter summing
        (:func:`~mmlspark_tpu_torch.core.telemetry.merge_snapshots`) IS
        sketch merging.  Keys: ``f<j>.b<i>`` bucket counts,
        ``f<j>.{n,nan,below,above}`` tallies, ``m.*`` for the margin
        sketch."""
        out: Dict[str, int] = {}

        def emit(prefix: str, snap: dict) -> None:
            out[f"{prefix}.n"] = int(snap.get("n", 0) or 0)
            for k in ("nan", "below", "above"):
                out[f"{prefix}.{k}"] = int(snap.get(k, 0) or 0)
            for b, c in (snap.get("buckets") or {}).items():
                out[f"{prefix}.b{b}"] = int(c)

        for j, snap in enumerate(feature_snaps):
            emit(f"f{j}", snap)
        emit("m", margin_snap)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """StageStats-shaped block for the metrics registry / worker
        stats beacon: counters carry the flattened sketch counts (sum
        across workers = the merged sketch), gauges the current PSI
        readings (max across workers = the worst arm — the
        ``merge_snapshots`` gauge convention)."""
        self.evaluate()
        with self._lock:
            feats, margin = self._merged_locked(False)
            counters = self._flat_counters(
                [f.snapshot() for f in feats], margin.snapshot())
            counters["rows_observed"] = self._rows_observed
            counters["rows_skipped"] = self._rows_skipped
            gauges = dict(self._gauges)
        return {"rows": self._rows_observed, "rows_per_s": 0.0,
                "counters": counters, "gauges": gauges, "stages": {}}

    def render_prometheus(self, prefix: str = PREFIX) -> str:
        """The ``mmlspark_tpu_drift_*`` families (appended to the
        process scrape through ``register_exposition``)."""
        report = self.evaluate()
        lines: List[str] = []

        def fam(suffix: str, typ: str, help_: str) -> str:
            name = f"{prefix}_drift_{suffix}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            return name

        n = fam("enabled", "gauge",
                "1 while a drift monitor is observing this process's "
                "scoring traffic.")
        lines.append(f"{n} {1 if self.enabled else 0}")
        n = fam("rows_total", "counter",
                "Rows sketched vs skipped by the duty-cycle gate.")
        lines.append(f'{n}{_labels({"state": "observed"})} '
                     f'{report["rows_observed"]}')
        lines.append(f'{n}{_labels({"state": "skipped"})} '
                     f'{report["rows_skipped"]}')
        sigs = report["signals"]
        n = fam("psi", "gauge",
                "Population Stability Index per signal (features + "
                "_prediction_), live vs fit-time reference.")
        for s in sigs:
            lines.append(f'{n}{_labels({"signal": s["signal"]})} '
                         f'{_fmt(s["psi"])}')
        n = fam("js", "gauge",
                "Jensen-Shannon divergence (base 2) per signal.")
        for s in sigs:
            lines.append(f'{n}{_labels({"signal": s["signal"]})} '
                         f'{_fmt(s["js"])}')
        n = fam("null_rate", "gauge",
                "Null (NaN/missing) rate per signal and source.")
        for s in sigs:
            lines.append(
                f'{n}{_labels({"signal": s["signal"], "src": "reference"})}'
                f' {_fmt(s["null_rate_ref"])}')
            lines.append(
                f'{n}{_labels({"signal": s["signal"], "src": "live"})}'
                f' {_fmt(s["null_rate_live"])}')
        n = fam("out_of_range_ratio", "gauge",
                "Fraction of live finite values outside the training "
                "edge span.")
        for s in sigs:
            if s["feature_index"] is not None:
                lines.append(f'{n}{_labels({"signal": s["signal"]})} '
                             f'{_fmt(s["oor_rate"])}')
        n = fam("alert", "gauge",
                "1 while the signal is over its drift threshold "
                "(instantaneous; the SLO burn gate adds the windowed "
                "verdict).")
        for s in sigs:
            lines.append(f'{n}{_labels({"signal": s["signal"]})} '
                         f'{1 if s["alert"] else 0}')
        return "\n".join(lines) + "\n"


# -- merged-counter readers ---------------------------------------------------


def sketches_from_counters(counters: Dict[str, Any],
                           profile: ReferenceProfile):
    """Inverse of ``DriftMonitor.snapshot()``'s counter flattening:
    rebuild per-feature + margin :class:`StreamSketch` objects from a
    (possibly cross-process-merged) ``counters`` dict.  This is how
    ``tools/drift_report.py`` and the drill read a merged scrape."""
    def collect(prefix: str) -> Dict[str, Any]:
        snap: Dict[str, Any] = {"buckets": {}}
        plen = len(prefix) + 1
        for k, v in counters.items():
            if not k.startswith(prefix + "."):
                continue
            sub = k[plen:]
            if sub.startswith("b") and sub[1:].isdigit():
                snap["buckets"][sub[1:]] = int(v)
            else:
                snap[sub] = int(v)
        return snap

    feats = []
    for j in range(profile.num_features):
        lo, hi = profile.feature_span(j)
        feats.append(StreamSketch.from_snapshot(
            collect(f"f{j}"), profile.feature_edges[j], lo, hi))
    margin = StreamSketch.from_snapshot(collect("m"),
                                        profile.margin_edges)
    return feats, margin


def drift_report_from_counters(counters: Dict[str, Any],
                               profile: ReferenceProfile,
                               config: Optional[DriftConfig] = None
                               ) -> Dict[str, Any]:
    """Full drift report off merged counters (the coordinator-side /
    offline view over any number of workers' summed snapshots)."""
    mon = DriftMonitor(profile, config)
    feats, margin = sketches_from_counters(counters, profile)
    for sk, live in zip(mon._cum.features, feats):
        sk.merge(live)
    mon._cum_m.merge(margin)
    mon._rows_observed = int(counters.get("rows_observed", 0) or 0)
    mon._rows_skipped = int(counters.get("rows_skipped", 0) or 0)
    return mon.evaluate(force=True)


# -- process-global wiring ----------------------------------------------------


_monitor_lock = threading.Lock()
_monitor: Optional[DriftMonitor] = None


def set_drift_monitor(monitor: Optional[DriftMonitor]
                      ) -> Optional[DriftMonitor]:
    """Install ``monitor`` as the process-global drift monitor: it
    federates under ``ns="drift"`` in the metrics registry (which is
    what the SLO gauge objectives and the worker stats beacon read) and
    renders the ``mmlspark_tpu_drift_*`` families into every scrape.
    ``None`` uninstalls."""
    global _monitor
    with _monitor_lock:
        _monitor = monitor
        reg = get_registry()
        if monitor is None:
            reg.unregister(DRIFT_NS)
            reg.unregister_exposition("drift")
        else:
            reg.register(DRIFT_NS, monitor)
            reg.register_exposition(
                "drift", lambda: _monitor.render_prometheus()
                if _monitor is not None else "")
        return monitor


def peek_drift_monitor() -> Optional[DriftMonitor]:
    """The installed monitor, or None — never creates one (a drift
    monitor is meaningless without a reference profile)."""
    return _monitor


def get_drift_monitor() -> Optional[DriftMonitor]:
    return peek_drift_monitor()
