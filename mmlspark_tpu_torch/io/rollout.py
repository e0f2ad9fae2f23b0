"""SLO-gated zero-downtime model rollout.  The port's copy of
``mmlspark_tpu/io/rollout.py``: a :class:`RolloutController` that runs
blue/green predictor arms over the versioned
:class:`~mmlspark_tpu_torch.io.registry.ModelRegistry` and lets the SLO
burn-rate machinery (:mod:`mmlspark_tpu_torch.core.slo`) make the
promote/rollback decision — a canary that trips a fast-window burn gets
yanked without a human.

How it composes with the serving stack:

* **Arms** — each arm is a ``Booster.predictor()``
  (:class:`~mmlspark_tpu_torch.gbdt.booster.CompiledPredictor`) of a
  booster the registry loads on the controller's ``device`` (``"cuda"``
  by default): baseline serves, a canary (when a rollout is in flight)
  takes a configurable traffic fraction.  Each arm's margins come back
  to the host in ONE explicit device→host copy a sub-batch
  (:func:`~mmlspark_tpu_torch.io.scoring._host_margins`), whatever the
  device.  Arms live in an immutable :class:`_Arms` snapshot; a batch
  pins the snapshot for its whole scoring call, so a promote or
  rollback mid-batch NEVER mixes tree versions inside one batch —
  in-flight batches finish on the arms they started with.
* **Routing** — deterministic per-request-id hashing
  (:meth:`RolloutController.arm_for`): sha256 of ``rid`` + the canary
  version as salt, so (a) a retry/salvage of the same rid lands on the
  same arm, and (b) each new canary samples an independent traffic
  slice.  The :class:`~mmlspark_tpu_torch.io.scoring.ScoringEngine` detects
  the controller's ``routes_by_rid`` attribute and hands it the batch's
  rids alongside the feature matrix.
* **The gate** — per-arm counters feed dedicated
  :class:`~mmlspark_tpu_torch.core.slo.SLObjective` s
  (``canary_error_ratio``, ``canary_deadline_miss``, plus an optional
  holdout-margin drift gauge) evaluated by a private
  :class:`~mmlspark_tpu_torch.core.slo.SLOMonitor` on every :meth:`tick`:

  - **breach** (both burn windows over threshold) → immediate
    :meth:`rollback`: the canary slot is cleared atomically, the
    registry entry is marked ``rolled_back``, a ``rollout_rolled_back``
    journal event + crash-flight record capture the scene;
  - **SLO-clean for the soak window** (and at least
    ``min_canary_rows`` scored) → :meth:`promote`: the registry entry
    activates, the canary becomes the baseline in one atomic snapshot
    swap, and the superseded booster's ``invalidate_cache()`` is
    called once the last pinned batch drains — any predictor still
    bound to the old forest raises instead of silently serving it.
* **Zero wrong answers under canary faults** — a canary batch that
  raises is transparently rescored on the baseline (counted as
  ``canary_errors`` + ``canary_fallback_rows``); the client sees a
  correct baseline answer, the gate sees the burn.

The port's drills (:mod:`mmlspark_tpu_torch.tools.chaos_drift`,
:mod:`mmlspark_tpu_torch.tools.chaos_online`) run the controller under
drift and refresh.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.profiling import StageStats
from ..core.slo import SLObjective, SLOMonitor
from ..core.telemetry import (PREFIX, get_journal, get_registry,
                              record_flight)
from ..device import DeviceLike
from .registry import ModelRegistry, RegistryError
from .scoring import _host_margins, next_pow2

log = logging.getLogger(__name__)

__all__ = ["RolloutConfig", "RolloutController",
           "render_model_info", "rollout_objectives"]


@dataclass
class RolloutConfig:
    """Gate knobs (docs/rollout.md §Knobs)."""
    #: fraction of requests the canary arm takes, by rid hash
    canary_fraction: float = 0.05
    #: SLO-clean seconds before a canary is promoted
    soak_s: float = 60.0
    #: minimum rows the canary must have scored before promotion (a
    #: canary that saw no traffic proved nothing)
    min_canary_rows: int = 200
    #: per-batch canary scoring deadline; batches slower than this
    #: count every row as a deadline miss (None disables the objective)
    canary_deadline_ms: Optional[float] = 250.0
    #: success targets for the canary objectives
    error_target: float = 0.999
    deadline_target: float = 0.99
    #: burn windows/thresholds for the PRIVATE gate monitor (chaos
    #: drills shrink these; production keeps SRE-ish defaults)
    fast_window_s: float = 15.0
    slow_window_s: float = 60.0
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0
    #: holdout drift gauge threshold (mean |canary − baseline| margin
    #: on the registered holdout); None disables the objective
    holdout_drift_threshold: Optional[float] = None
    holdout_target: float = 0.99
    #: LIVE-traffic drift gate: worst per-feature /
    #: prediction PSI from the attached
    #: :class:`~mmlspark_tpu_torch.core.drift.DriftMonitor` staying under
    #: this while the canary soaks; None disables (and without
    #: :meth:`RolloutController.attach_drift` the objectives are never
    #: declared).  Unlike the holdout gauge this watches the traffic
    #: actually hitting the rollout, so a canary promoted INTO a
    #: drifting feed is caught even when the model itself is healthy.
    live_drift_threshold: Optional[float] = 0.25
    live_drift_target: float = 0.99
    #: background gate cadence (:meth:`RolloutController.start`)
    tick_s: float = 0.5
    #: how long promote/rollback waits for in-flight pinned batches
    #: before invalidating the superseded booster's cache
    retire_grace_s: float = 5.0


def rollout_objectives(cfg: RolloutConfig,
                       holdout: bool = False,
                       live_drift: bool = False) -> List[SLObjective]:
    """The canary gate's objectives, reading the ``rollout``
    namespace's counters (plus, with ``live_drift``, the attached
    drift monitor's ``ns="drift"`` gauges)."""
    objs = [
        SLObjective(
            "canary_error_ratio", cfg.error_target,
            "canary scoring errors (rescued on the baseline) per "
            "canary row",
            bad=(("rollout", "canary_errors"),),
            total=(("rollout", "canary_rows"),
                   ("rollout", "canary_errors"))),
    ]
    if cfg.canary_deadline_ms is not None:
        objs.append(SLObjective(
            "canary_deadline_miss", cfg.deadline_target,
            "canary rows scored past the canary deadline",
            bad=(("rollout", "canary_deadline_miss"),),
            total=(("rollout", "canary_rows"),
                   ("rollout", "canary_errors"))))
    if holdout and cfg.holdout_drift_threshold is not None:
        objs.append(SLObjective(
            "canary_holdout_drift", cfg.holdout_target,
            "mean |canary - baseline| margin on the holdout staying "
            "under the drift threshold",
            gauge=("rollout", "canary_holdout_drift"),
            threshold=float(cfg.holdout_drift_threshold)))
    if live_drift and cfg.live_drift_threshold is not None:
        objs.append(SLObjective(
            "canary_live_drift", cfg.live_drift_target,
            "worst per-feature PSI on LIVE traffic (attached drift "
            "monitor vs the fit-time reference profile) staying under "
            "the rollout drift threshold",
            gauge=("drift", "psi_worst"),
            threshold=float(cfg.live_drift_threshold)))
        objs.append(SLObjective(
            "canary_prediction_drift", cfg.live_drift_target,
            "prediction-margin PSI on live traffic staying under the "
            "rollout drift threshold",
            gauge=("drift", "psi_prediction"),
            threshold=float(cfg.live_drift_threshold)))
    return objs


class _Arms:
    """One immutable blue/green snapshot.  Batches pin it (refcount)
    for their whole scoring call: swaps replace the controller's
    POINTER, never the snapshot a batch is using, so no batch ever
    sees two generations of arms."""

    __slots__ = ("baseline", "canary", "fraction", "baseline_info",
                 "canary_info", "refs", "lock", "drained")

    def __init__(self, baseline, canary, fraction: float,
                 baseline_info: Dict[str, Any],
                 canary_info: Optional[Dict[str, Any]]):
        self.baseline = baseline
        self.canary = canary
        self.fraction = float(fraction) if canary is not None else 0.0
        self.baseline_info = baseline_info
        self.canary_info = canary_info
        self.refs = 0
        self.lock = threading.Lock()
        self.drained = threading.Event()
        self.drained.set()

    def pin(self) -> "_Arms":
        with self.lock:
            self.refs += 1
            self.drained.clear()
        return self

    def unpin(self) -> None:
        with self.lock:
            self.refs -= 1
            if self.refs <= 0:
                self.drained.set()


def render_model_info(arm_infos: List[Dict[str, Any]],
                      prefix: str = PREFIX) -> str:
    """The ``mmlspark_tpu_serving_model_info`` info-style family: one
    always-1 gauge per serving arm, labelled with the arm name, the
    registry version and the content digest — joinable against any
    other family the scrape carries (the Prometheus *_info idiom)."""
    name = f"{prefix}_serving_model_info"
    lines = [
        f"# HELP {name} Active model per serving arm (info-style: "
        "value is always 1; labels carry version/digest/arm).",
        f"# TYPE {name} gauge",
    ]
    for info in arm_infos:
        arm = info.get("arm", "baseline")
        version = info.get("version", "")
        digest = str(info.get("digest", ""))
        lines.append(
            f'{name}{{arm="{arm}",digest="{digest}",'
            f'version="{version}"}} 1')
    return "\n".join(lines) + "\n"


class RolloutController:
    """Blue/green rollout over a :class:`ModelRegistry`, gated by SLO
    burn rates.  Plugs into :class:`~mmlspark_tpu_torch.io.scoring
    .ScoringEngine` as an ordinary predictor (``engine =
    ScoringEngine(server, predictor=controller)``); the engine detects
    ``routes_by_rid`` and calls :meth:`score_routed` with the batch's
    request ids so the canary split is per-request and retry-stable.

    Lifecycle::

        ctl = RolloutController(registry, device="cuda").install(server)
        engine = ScoringEngine(server, predictor=ctl).start()
        ctl.start()                      # background gate ticks
        ...
        v = registry.publish(new_booster)     # candidate
        ctl.start_canary(v)                   # canary takes traffic
        # the gate promotes or rolls back on its own
    """

    #: the ScoringEngine hook: batches arrive with their rids
    routes_by_rid = True

    def __init__(self, registry: ModelRegistry, *,
                 backend: str = "auto",
                 config: Optional[RolloutConfig] = None,
                 stats: Optional[StageStats] = None,
                 device: DeviceLike = "cuda"):
        self.registry = registry
        self.cfg = config or RolloutConfig()
        self._backend = backend
        #: where every arm's booster is loaded, and so where it scores
        self.device = device
        self.stats = stats or StageStats()
        for k in ("baseline_rows", "canary_rows", "canary_errors",
                  "canary_deadline_miss", "canary_fallback_rows",
                  "promotions", "rollbacks", "canaries_started"):
            self.stats.incr(k, 0)
        self._pt_baseline = self.stats.timer("arm_baseline")
        self._pt_canary = self.stats.timer("arm_canary")
        self._journal = get_journal()
        self._lock = threading.Lock()
        self._boosters: Dict[str, Any] = {}   # arm -> live Booster
        self._soak_started: Optional[float] = None
        # counters are process-cumulative; the gate and the journal
        # must report THIS rollout's traffic, so start_canary snapshots
        # a zero-point and everything gates on the delta — otherwise a
        # canary that saw no traffic inherits the previous rollout's
        # rows and sails through min_canary_rows
        self._canary_rows0 = 0
        self._canary_errors0 = 0
        self._monitor: Optional[SLOMonitor] = None
        self._holdout: Optional[np.ndarray] = None
        self._holdout_ref: Optional[np.ndarray] = None
        #: live-traffic drift gate: attach_drift() installs
        #: a DriftMonitor; canaries then gate on its PSI gauges too
        self._drift = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: chaos/test seam: wraps the canary predictor at
        #: :meth:`start_canary` (the drill injects ChaosPredictor here)
        self.canary_wrap: Optional[Callable[[Any], Any]] = None
        active = registry.active_version()
        if active is None:
            raise RegistryError(
                "registry has no active version to serve as baseline; "
                "publish(model, activate=True) one first")
        booster = registry.load(active, device=device)
        self._boosters["baseline"] = booster
        self._arms = _Arms(
            booster.predictor(backend=backend), None, 0.0,
            self._info_for(active), None)
        self.num_features = self._arms.baseline.num_features
        get_registry().register("rollout", self.stats)
        get_registry().register_exposition(
            "serving_model_info",
            lambda: render_model_info(self.model_info()["arms"]))

    # -- wiring --------------------------------------------------------------

    @property
    def mode(self) -> str:
        return "rollout"

    def _info_for(self, version: int) -> Dict[str, Any]:
        e = self.registry.entry(version)
        return {"version": int(version), "digest": e["digest"],
                "state": e["promoted_state"]}

    def install(self, server) -> "RolloutController":
        """Hook the server's ``/readyz`` model block (and any
        fan-out the server does to worker processes)."""
        if hasattr(server, "model_info_provider"):
            server.model_info_provider = self.model_info
        return self

    def model_info(self) -> Dict[str, Any]:
        """The active arms — the ``/readyz`` model block and the
        ``serving_model_info`` labels."""
        arms = self._arms
        out = [{"arm": "baseline", **arms.baseline_info}]
        if arms.canary is not None and arms.canary_info is not None:
            out.append({"arm": "canary", **arms.canary_info,
                        "fraction": arms.fraction})
        return {"arms": out,
                "active_version": arms.baseline_info.get("version"),
                "canary_version":
                    (arms.canary_info or {}).get("version"),
                "state": self.state()}

    def state(self) -> str:
        return "canarying" if self._arms.canary is not None else "steady"

    def set_holdout(self, X) -> None:
        """Register a holdout matrix for the drift gauge: each tick
        with a live canary scores it on both arms and gauges the mean
        absolute margin difference."""
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        self._holdout = X
        self._holdout_ref = None      # recomputed against current arms

    def attach_drift(self, monitor) -> "RolloutController":
        """Attach a :class:`~mmlspark_tpu_torch.core.drift.DriftMonitor`:
        it is installed process-wide (``ns="drift"`` +
        exposition) and every canary's private gate gains the
        live-traffic drift objectives (``canary_live_drift`` /
        ``canary_prediction_drift``) next to the holdout gauge — a
        canary soaking while the input or prediction distribution
        shifts past ``cfg.live_drift_threshold`` is auto-rolled-back
        by the same burn machinery as an erroring one."""
        from ..core.drift import set_drift_monitor
        self._drift = monitor
        set_drift_monitor(monitor)
        return self

    # -- routing -------------------------------------------------------------

    def arm_for(self, rid: str, fraction: Optional[float] = None,
                salt: Optional[str] = None) -> str:
        """Deterministic per-rid arm choice: the first 8 hex digits of
        ``sha256(rid:salt)`` as a uniform draw in [0, 1).  Same rid →
        same arm, always — retries and per-row salvage land where the
        original did.  The salt is the canary version, so each rollout
        samples an independent slice of the id space."""
        arms = self._arms
        if fraction is None:
            fraction = arms.fraction
        if fraction <= 0.0:
            return "baseline"
        if salt is None:
            salt = str((arms.canary_info or {}).get("version", ""))
        h = hashlib.sha256(f"{rid}:{salt}".encode("utf-8")).hexdigest()
        draw = int(h[:8], 16) / float(0x100000000)
        return "canary" if draw < fraction else "baseline"

    def __call__(self, X):
        """Plain predictor contract (no rids — e.g. a transform-mode
        caller): everything scores on the baseline arm."""
        arms = self._arms.pin()
        try:
            return self._score_arm(arms, "baseline", np.asarray(X))
        finally:
            arms.unpin()

    def _score_arm(self, arms: _Arms, arm: str, X: np.ndarray):
        """Score one arm with pow2 padding (the engine skips its own
        padding for routed predictors — sub-batches pad here, as the
        reference pads them for its compile cache, so each arm sees the
        reference's batches); its margins reach the host in one copy."""
        pred = arms.baseline if arm == "baseline" else arms.canary
        n = X.shape[0]
        pad = getattr(pred, "mode", "jit") != "native"
        if pad:
            b = next_pow2(n)
            if b > n:
                Xp = np.zeros((b, X.shape[1]), np.float32)
                Xp[:n] = X
                X = Xp
        timer = self._pt_baseline if arm == "baseline" \
            else self._pt_canary
        t0 = time.perf_counter()
        out = _host_margins(pred(X), n)
        dur = time.perf_counter() - t0
        timer.record(dur)
        if arm == "canary":
            self.stats.incr("canary_rows", n)
            dl = self.cfg.canary_deadline_ms
            if dl is not None and dur * 1e3 > dl:
                self.stats.incr("canary_deadline_miss", n)
        else:
            self.stats.incr("baseline_rows", n)
        return out

    def score_routed(self, X, rids) -> np.ndarray:
        """The engine's routed entrypoint: split the batch's rows by
        arm, score each sub-batch on its pinned arm, scatter the
        margins back into input order.  A canary failure is rescored
        on the baseline (zero wrong answers; the gate counts the
        burn).  The arms snapshot is pinned for the whole call, so a
        concurrent promote/rollback cannot mix versions inside this
        batch."""
        X = np.asarray(X)
        arms = self._arms.pin()
        try:
            if arms.canary is None:
                return self._score_arm(arms, "baseline", X)
            salt = str((arms.canary_info or {}).get("version", ""))
            canary_idx = [i for i, rid in enumerate(rids)
                          if self.arm_for(str(rid), arms.fraction,
                                          salt) == "canary"]
            if not canary_idx:
                return self._score_arm(arms, "baseline", X)
            cset = set(canary_idx)
            base_idx = [i for i in range(X.shape[0])
                        if i not in cset]
            parts: List[tuple] = []
            if base_idx:
                parts.append((base_idx, self._score_arm(
                    arms, "baseline", X[base_idx])))
            try:
                cm = self._score_arm(arms, "canary", X[canary_idx])
            except Exception:  # noqa: BLE001 - canary fault: the
                # client still gets a CORRECT answer (baseline), the
                # gate gets the error signal
                log.exception("canary scoring failed; rescoring %d "
                              "rows on the baseline", len(canary_idx))
                self.stats.incr("canary_errors", len(canary_idx))
                self.stats.incr("canary_fallback_rows",
                                len(canary_idx))
                cm = self._score_arm(arms, "baseline", X[canary_idx])
            parts.append((canary_idx, cm))
            first = parts[0][1]
            out_shape = (X.shape[0],) + first.shape[1:]
            out = np.empty(out_shape, first.dtype)
            for idx, vals in parts:
                out[idx] = vals
            return out
        finally:
            arms.unpin()

    # -- the gate ------------------------------------------------------------

    def start_canary(self, version: Optional[int] = None) -> int:
        """Load ``version`` (default: the newest candidate) from the
        registry (digest-verified) and put it in the canary slot.  The
        soak clock and a FRESH gate monitor start now."""
        with self._lock:
            if self._arms.canary is not None:
                raise RegistryError(
                    "a canary rollout is already in flight "
                    f"(version {self._arms.canary_info['version']})")
            if version is None:
                cands = self.registry.candidates()
                if not cands:
                    raise RegistryError(
                        "registry has no candidate version to canary")
                version = cands[-1]
            booster = self.registry.load(   # digest-verified
                version, device=self.device)
            pred = booster.predictor(backend=self._backend)
            if self.canary_wrap is not None:
                pred = self.canary_wrap(pred)
            old = self._arms
            self._boosters["canary"] = booster
            self._arms = _Arms(old.baseline, pred,
                               self.cfg.canary_fraction,
                               old.baseline_info,
                               self._info_for(version))
            self._soak_started = time.monotonic()
            self._canary_rows0 = self.stats.counter("canary_rows")
            self._canary_errors0 = self.stats.counter("canary_errors")
            # fresh per-rollout gate: burn windows must not inherit a
            # previous canary's errors
            self._monitor = SLOMonitor(
                rollout_objectives(
                    self.cfg, holdout=self._holdout is not None,
                    live_drift=self._drift is not None),
                fast_window_s=self.cfg.fast_window_s,
                slow_window_s=self.cfg.slow_window_s,
                fast_burn_threshold=self.cfg.fast_burn_threshold,
                slow_burn_threshold=self.cfg.slow_burn_threshold)
            # the zero-point reading: windowed deltas count from the
            # canary's first moment, so the FIRST tick after traffic
            # already sees the burn instead of needing two post-fault
            # samples
            self._monitor.sample()
            self._holdout_ref = None
            self.stats.incr("canaries_started")
        self._journal.emit("rollout_started", version=int(version),
                           fraction=self.cfg.canary_fraction,
                           soak_s=self.cfg.soak_s)
        return int(version)

    def _retire(self, arms: _Arms, booster) -> None:
        """Wait (bounded) for the superseded snapshot's pinned batches
        to drain, then invalidate the retired booster's prediction
        cache so any predictor still bound to it RAISES instead of
        silently scoring the old forest."""
        if booster is None:
            return
        # still serving under another arm (promote moves the canary
        # booster into the baseline slot) → must NOT be invalidated
        with self._lock:
            if any(b is booster for b in self._boosters.values()):
                return
        if not arms.drained.wait(self.cfg.retire_grace_s):
            log.warning("rollout: %d batch(es) still pinned to the "
                        "retired arms after %.1fs; invalidating anyway",
                        arms.refs, self.cfg.retire_grace_s)
        booster.invalidate_cache()

    def promote(self) -> int:
        """Atomic cutover: the canary's registry entry activates, the
        canary predictor becomes the baseline, and the superseded
        baseline booster is invalidated after its in-flight batches
        drain.  Returns the promoted version."""
        with self._lock:
            old = self._arms
            if old.canary is None or old.canary_info is None:
                raise RegistryError("no canary in flight to promote")
            version = int(old.canary_info["version"])
            self.registry.activate(version)
            info = self._info_for(version)
            # the promoted predictor may be chaos-wrapped (canary_wrap
            # is a drill seam); the baseline must serve the REAL one
            booster = self._boosters.pop("canary")
            retired_booster = self._boosters.get("baseline")
            self._boosters["baseline"] = booster
            self._arms = _Arms(booster.predictor(
                backend=self._backend), None, 0.0, info, None)
            self._soak_started = None
            self._monitor = None
            self._holdout_ref = None
            self.stats.incr("promotions")
            rows = (self.stats.counter("canary_rows")
                    - self._canary_rows0)
        self._journal.emit("rollout_promoted", version=version,
                           canary_rows=rows)
        self._retire(old, retired_booster)   # the superseded baseline
        return version

    def rollback(self, reason: str = "slo_burn",
                 detail: Optional[dict] = None) -> int:
        """Yank the canary: clear the slot atomically, mark the
        registry entry ``rolled_back``, journal + flight-record the
        scene.  Returns the version rolled back."""
        with self._lock:
            old = self._arms
            if old.canary is None or old.canary_info is None:
                raise RegistryError("no canary in flight to roll back")
            version = int(old.canary_info["version"])
            try:
                self.registry.mark(version, "rolled_back")
            except RegistryError:
                pass   # already quarantined by a failed load elsewhere
            retired_booster = self._boosters.pop("canary", None)
            self._arms = _Arms(old.baseline, None, 0.0,
                               old.baseline_info, None)
            self._soak_started = None
            self._monitor = None
            self._holdout_ref = None
            self.stats.incr("rollbacks")
            rows = (self.stats.counter("canary_rows")
                    - self._canary_rows0)
            errors = (self.stats.counter("canary_errors")
                      - self._canary_errors0)
        ev = {"version": version, "reason": reason,
              "canary_rows": rows, "canary_errors": errors}
        if detail:
            ev["slo"] = detail
        self._journal.emit("rollout_rolled_back", **ev)
        record_flight("rollout_rolled_back", ev)
        self._retire(old, retired_booster)
        return version

    def _gauge_holdout_drift(self, arms: _Arms) -> None:
        if self._holdout is None or arms.canary is None:
            return
        try:
            if self._holdout_ref is None:
                self._holdout_ref = _host_margins(
                    arms.baseline(self._holdout),
                    len(self._holdout)).astype(np.float32)
            cm = _host_margins(arms.canary(self._holdout),
                               len(self._holdout)).astype(np.float32)
            drift = float(np.mean(np.abs(cm - self._holdout_ref)))
            self.stats.set_gauge("canary_holdout_drift", drift)
        except Exception:  # noqa: BLE001 - the drift gauge is advisory;
            # a canary fault here shows up through the error objective
            # on live traffic instead
            log.exception("rollout: holdout drift probe failed")

    def tick(self) -> str:
        """One gate evaluation.  Returns the resulting state:
        ``steady`` (no canary), ``soaking``, ``promoted`` or
        ``rolled_back``.  Deterministic given the counters — the chaos
        drill pumps it manually; :meth:`start` runs it on a cadence."""
        with self._lock:
            arms = self._arms
            monitor = self._monitor
            soak_started = self._soak_started
            rows0 = self._canary_rows0
        if arms.canary is None or monitor is None:
            return "steady"
        self._gauge_holdout_drift(arms)
        if self._drift is not None:
            # refresh the live PSI gauges before the gate samples them
            # (rate-limited inside by DriftConfig.eval_interval_s)
            self._drift.evaluate()
        monitor.sample()
        verdicts = monitor.evaluate()
        breaching = sorted(n for n, v in verdicts.items()
                           if v["breach"])
        if breaching:
            self.rollback(reason=f"slo_burn:{','.join(breaching)}",
                          detail={n: verdicts[n] for n in breaching})
            return "rolled_back"
        soaked = (soak_started is not None
                  and time.monotonic() - soak_started
                  >= self.cfg.soak_s)
        if soaked and (self.stats.counter("canary_rows") - rows0
                       >= self.cfg.min_canary_rows):
            self.promote()
            return "promoted"
        return "soaking"

    def slo_report(self) -> Optional[dict]:
        """The gate monitor's current report (None outside a rollout)
        — the chaos drill embeds it next to each verdict."""
        monitor = self._monitor
        if monitor is None:
            return None
        return monitor.report()

    # -- background gate -----------------------------------------------------

    def start(self) -> "RolloutController":
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.cfg.tick_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - the gate must
                    # outlive a transient registry/monitor error
                    log.exception("rollout gate tick failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rollout-gate")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
