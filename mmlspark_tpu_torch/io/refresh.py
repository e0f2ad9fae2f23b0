"""Drift-triggered incremental refresh — the control plane that closes
the online-learning loop.  The port's copy of
``mmlspark_tpu/io/refresh.py``.

Without it a sustained ``feature_drift`` burn could only roll a canary
*back* — never *fix* the model.  :class:`RefreshController` is the
state machine::

    IDLE ──burn×hysteresis──▶ TRIGGERED ──dataset durable──▶ FITTING
      ▲                                                         │
      │                                      fit ok → publish   │
      │  promoted / rolled_back                 candidate       ▼
      └────────── CANARY ◀──start_canary── CANDIDATE ◀──────────┘
                                    (fit failure: bounded backoff
                                     retry ×N, then GAVE_UP)

* **Trigger** — subscribes to the :class:`~mmlspark_tpu_torch.core.slo.
  SLOMonitor`'s ``feature_drift`` / ``prediction_drift`` burn verdicts;
  ``hysteresis_evals`` consecutive breached polls are required to arm,
  and a ``cooldown_s`` window after every completed episode (promoted,
  rolled back, or given up) absorbs drift storms — with the
  single-state-machine design this also enforces
  max-concurrent-refresh = 1 by construction.
* **Fit** — continued training from the streaming ingest's retained
  rows (:func:`mmlspark_tpu_torch.gbdt.engine.train_incremental` with
  ``init_model`` = the registry's ACTIVE version), on the controller's
  ``device`` (``"cuda"`` by default: the card's ``hist_full`` once a
  tree and ``hist_segment`` once a split); the init model is loaded
  there too.  The training view
  is first made durable (``flush()`` + one atomic dataset file) and the
  fit runs under ``checkpoint_dir``, so a trainer SIGKILLed mid-boost
  resumes from the last durable chunk on the SAME bytes — bit-identical
  to an unkilled fit.  Fit failures retry with doubling bounded
  backoff; exhausting ``max_retries`` journals + flight-records a
  ``GAVE_UP`` terminal (a human decision point, never a retrain storm).
* **Hand-off** — the merged forest is published as a registry
  candidate (stamped with the refresh episode) and handed to
  :meth:`~mmlspark_tpu_torch.io.rollout.RolloutController.start_canary`; the
  rollout gate owns promote/rollback, and the controller watches the
  REGISTRY entry state (the durable source of truth) to close the
  episode.
* **Kill-anywhere recovery** — every transition commits a state file
  (tmp+fsync+rename, the registry's manifest discipline) BEFORE acting
  on it, and every action is idempotent against its own re-execution:
  a re-run TRIGGERED re-snapshots the dataset; a re-run FITTING first
  *adopts* an already-published candidate for its episode from the
  registry (so publish is exactly-once even if the process dies between
  publish and commit); a re-run CANDIDATE re-issues ``start_canary``
  against the rebuilt rollout.  docs/online-learning.md §Recovery
  matrix enumerates every kill point.

Telemetry: StageStats under ``ns="refresh"`` plus the
``mmlspark_tpu_refresh_*`` families (docs/observability.md); every
transition journals a ``refresh_*`` event carrying the episode id, so
one merged journal trace reconstructs the whole
trigger→fit→canary→promote chain (the chaos drill's evidence).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import List, Optional

import numpy as np

from ..core.profiling import StageStats
from ..core.slo import SLOMonitor
from ..core.telemetry import PREFIX, _fmt, _labels, get_journal, \
    get_registry, record_flight
from ..device import DeviceLike
from ..gbdt.engine import TrainParams, train_incremental
from ..gbdt.objectives import Objective, RegressionL2
from .ingest import IngestBuffer, _savez_atomic
from .registry import ModelRegistry, RegistryError, _atomic_write
from .rollout import RolloutController

log = logging.getLogger(__name__)

__all__ = ["RefreshConfig", "RefreshController", "RefreshError"]

_STATE_FILE = "refresh_state.json"
_DATASET_FMT = "dataset_%04d.npz"
_CKPT_FMT = "ckpt_%04d"
_FORMAT = 1

REFRESH_NS = "refresh"

#: machine states (docs/online-learning.md §State machine)
STATES = ("idle", "triggered", "fitting", "candidate", "canary",
          "gave_up")


class RefreshError(RuntimeError):
    """Refresh contract violation (unknown durable state, incompatible
    directory)."""


@dataclasses.dataclass
class RefreshConfig:
    """Knobs (docs/online-learning.md §Knobs)."""
    #: SLO objective names whose breach arms the trigger
    trigger_objectives: tuple = ("feature_drift", "prediction_drift")
    #: consecutive breached polls required to arm (debounce)
    hysteresis_evals: int = 2
    #: quiet period after every completed episode
    cooldown_s: float = 60.0
    #: fit attempts per episode before GAVE_UP
    max_retries: int = 3
    #: base retry backoff (doubles per attempt, capped)
    backoff_s: float = 1.0
    backoff_max_s: float = 30.0
    #: refuse to fit on fewer retained rows (stay TRIGGERED, waiting)
    min_fit_rows: int = 256
    #: trees added per refresh fit
    num_iterations: int = 20
    #: chunk boundary for the fit's durable checkpoints
    checkpoint_chunk: int = 8


class RefreshController:
    """The drift → retrain → canary state machine.

    ``root`` is the controller's durable directory (state file,
    episode datasets, fit checkpoints).  Reopening a directory whose
    previous owner was SIGKILLed resumes from the committed state.
    Drive it with :meth:`poll` (each call performs at most one
    state-transition's work; ``now`` injects a fake clock for tests)
    or :meth:`start`/:meth:`stop` for a background thread.
    """

    def __init__(self, root: str, *, registry: ModelRegistry,
                 rollout: Optional[RolloutController],
                 ingest: IngestBuffer,
                 monitor: Optional[SLOMonitor] = None,
                 config: Optional[RefreshConfig] = None,
                 objective: Optional[Objective] = None,
                 train_params: Optional[TrainParams] = None,
                 stats: Optional[StageStats] = None,
                 own_sampling: bool = True,
                 register: bool = True,
                 device: DeviceLike = "cuda"):
        self.root = os.path.abspath(root)
        #: where the init model is loaded and the refresh fit runs
        self.device = device
        os.makedirs(self.root, exist_ok=True)
        self.registry = registry
        self.rollout = rollout
        self.ingest = ingest
        self.monitor = monitor
        self.cfg = config or RefreshConfig()
        self.objective = objective or RegressionL2()
        base = train_params or TrainParams(
            num_leaves=15, learning_rate=0.1, min_data_in_leaf=5,
            parallelism="serial", verbosity=0)
        self._params = dataclasses.replace(
            base, num_iterations=self.cfg.num_iterations,
            checkpoint_chunk=self.cfg.checkpoint_chunk)
        self.stats = stats or StageStats()
        self._own_sampling = own_sampling
        self._journal = get_journal()
        self._lock = threading.RLock()
        self._streak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: chaos/test seam: callbacks handed to the incremental fit
        #: (the drill injects its mid-boost SIGKILL here, the exact
        #: analog of the rollout's ``canary_wrap``)
        self.fit_callbacks: Optional[List] = None
        for k in ("triggers", "fits", "fit_failures", "retries",
                  "candidates", "canaries", "promotions", "rollbacks",
                  "gave_up", "recoveries", "starved"):
            self.stats.incr(k, 0)
        # durable state
        self.state = "idle"
        self.episode = 0
        self.attempt = 0
        self.candidate_version: Optional[int] = None
        self.cooldown_until = 0.0
        self.backoff_until = 0.0
        self._load_or_init()
        if register:
            reg = get_registry()
            reg.register(REFRESH_NS, self.stats)
            reg.register_exposition(REFRESH_NS, self.render_prometheus)
        self._registered = register

    # -- durable state -------------------------------------------------------

    def _state_path(self) -> str:
        return os.path.join(self.root, _STATE_FILE)

    def _commit(self) -> None:
        doc = {"format": _FORMAT, "state": self.state,
               "episode": self.episode, "attempt": self.attempt,
               "candidate_version": self.candidate_version,
               "cooldown_until": self.cooldown_until,
               "backoff_until": self.backoff_until}
        _atomic_write(self._state_path(),
                      json.dumps(doc, indent=1,
                                 sort_keys=True).encode("utf-8"))

    def _load_or_init(self) -> None:
        path = self._state_path()
        if not os.path.exists(path):
            self._commit()
            return
        try:
            with open(path, "rb") as fh:
                doc = json.loads(fh.read().decode("utf-8"))
        except (OSError, ValueError) as e:
            raise RefreshError(
                f"unreadable refresh state {path}: {e}") from e
        if doc.get("format") != _FORMAT:
            raise RefreshError(
                f"refresh state format {doc.get('format')!r} not "
                f"supported (want {_FORMAT})")
        if doc["state"] not in STATES:
            raise RefreshError(
                f"refresh state {doc['state']!r} unknown")
        self.state = doc["state"]
        self.episode = int(doc["episode"])
        self.attempt = int(doc["attempt"])
        cv = doc.get("candidate_version")
        self.candidate_version = None if cv is None else int(cv)
        self.cooldown_until = float(doc.get("cooldown_until", 0.0))
        self.backoff_until = float(doc.get("backoff_until", 0.0))
        if self.state != "idle":
            # a previous owner died mid-episode; the next poll()
            # resumes exactly where the committed state says
            self.stats.incr("recoveries")
            self._journal.emit("refresh_recovered", state=self.state,
                              episode=self.episode,
                              attempt=self.attempt)

    def _transition(self, state: str, event: str, **fields) -> None:
        self.state = state
        self._commit()
        self._journal.emit(event, episode=self.episode,
                          state=state, **fields)

    # -- paths ---------------------------------------------------------------

    def dataset_path(self, episode: Optional[int] = None) -> str:
        ep = self.episode if episode is None else episode
        return os.path.join(self.root, _DATASET_FMT % ep)

    def checkpoint_dir(self, episode: Optional[int] = None) -> str:
        ep = self.episode if episode is None else episode
        return os.path.join(self.root, _CKPT_FMT % ep)

    # -- the machine ---------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> str:
        """Advance the machine by at most one transition's work.
        Returns a status string (the state after the poll, or a
        wait-reason like ``"cooldown"`` / ``"backoff"`` /
        ``"starved"``)."""
        t = time.time() if now is None else float(now)
        with self._lock:
            self.stats.set_gauge(
                "cooldown_remaining_s",
                max(0.0, self.cooldown_until - t))
            if self.state == "gave_up":
                return "gave_up"
            if self.state == "idle":
                return self._poll_idle(t)
            if self.state == "triggered":
                return self._poll_triggered(t)
            if self.state == "fitting":
                return self._poll_fitting(t)
            if self.state == "candidate":
                return self._poll_candidate(t)
            if self.state == "canary":
                return self._poll_canary(t)
            raise RefreshError(f"unreachable state {self.state!r}")

    def _breaching(self, t: float) -> List[str]:
        if self.monitor is None:
            return []
        if self._own_sampling:
            self.monitor.sample(now=t)
        verdicts = self.monitor.evaluate()
        return sorted(
            name for name in self.cfg.trigger_objectives
            if verdicts.get(name, {}).get("breach"))

    def _poll_idle(self, t: float) -> str:
        if t < self.cooldown_until:
            self._streak = 0
            self.stats.set_gauge("breach_streak", 0)
            return "cooldown"
        burning = self._breaching(t)
        self._streak = self._streak + 1 if burning else 0
        self.stats.set_gauge("breach_streak", self._streak)
        if self._streak < self.cfg.hysteresis_evals:
            return "idle"
        self._streak = 0
        self.episode += 1
        self.attempt = 0
        self.candidate_version = None
        self.stats.incr("triggers")
        self.stats.set_gauge("breach_streak", 0)
        self._transition("triggered", "refresh_triggered",
                         objectives=",".join(burning))
        return "triggered"

    def _poll_triggered(self, t: float) -> str:
        self.ingest.flush()
        bins, labels = self.ingest.training_view()
        if len(bins) < self.cfg.min_fit_rows:
            self.stats.incr("starved")
            return "starved"
        # the fit dataset becomes ONE durable file: a killed-and-
        # resumed fit must see the identical bytes or the checkpoint
        # fingerprint would (correctly) refuse to resume
        _savez_atomic(self.dataset_path(), bins=bins, labels=labels,
                      episode=np.int64(self.episode))
        self._transition("fitting", "refresh_dataset",
                         rows=int(len(bins)))
        return "fitting"

    def _adopt_candidate_locked(self) -> Optional[int]:
        """Exactly-once publish: if a previous owner died between
        publish and commit, the registry already holds this episode's
        candidate — adopt it instead of re-fitting."""
        for v, e in sorted(self.registry.entries().items()):
            meta = e.get("meta") or {}
            if meta.get("refresh_episode") == self.episode:
                return int(v)
        return None

    def _poll_fitting(self, t: float) -> str:
        if t < self.backoff_until:
            return "backoff"
        adopted = self._adopt_candidate_locked()
        if adopted is not None:
            self.candidate_version = adopted
            self.stats.incr("candidates")
            self._transition("candidate", "refresh_candidate",
                             version=adopted, adopted=True)
            return "candidate"
        active = self.registry.active_version()
        if active is None:
            raise RefreshError(
                "refresh needs an active registry version as the "
                "init model")
        try:
            with np.load(self.dataset_path()) as ds:
                bins = np.ascontiguousarray(ds["bins"], np.uint8)
                labels = np.asarray(ds["labels"], np.float64)
            init = self.registry.load(active, device=self.device)
            params = dataclasses.replace(
                self._params, checkpoint_dir=self.checkpoint_dir())
            self.stats.incr("fits")
            self._journal.emit("refresh_fit_begin",
                              episode=self.episode,
                              attempt=self.attempt,
                              init_version=active,
                              rows=int(len(bins)))
            with self.stats.time("fit"):
                merged = train_incremental(
                    bins, labels, self.ingest.mapper,
                    init_booster=init, objective=self.objective,
                    params=params, device=self.device,
                    callbacks=self.fit_callbacks)
            version = self.registry.publish(
                merged, meta={"refresh_episode": self.episode,
                              "init_version": int(active),
                              "attempt": self.attempt})
        except Exception as e:  # noqa: BLE001 - bounded retry wall
            self.stats.incr("fit_failures")
            self.attempt += 1
            if self.attempt > self.cfg.max_retries:
                self.stats.incr("gave_up")
                self._transition("gave_up", "refresh_gave_up",
                                 attempts=self.attempt,
                                 error=type(e).__name__)
                record_flight("refresh_gave_up",
                              {"episode": self.episode,
                               "attempts": self.attempt,
                               "error": repr(e)})
                log.exception(
                    "refresh episode %d gave up after %d attempts",
                    self.episode, self.attempt)
                return "gave_up"
            back = min(self.cfg.backoff_s * 2 ** (self.attempt - 1),
                       self.cfg.backoff_max_s)
            self.backoff_until = t + back
            self.stats.incr("retries")
            self._commit()
            self._journal.emit("refresh_retry", episode=self.episode,
                              attempt=self.attempt,
                              backoff_s=round(back, 3),
                              error=type(e).__name__)
            log.warning("refresh fit attempt %d failed (%s); retrying "
                        "in %.1fs", self.attempt, e, back)
            return "backoff"
        self.candidate_version = version
        self.stats.incr("candidates")
        self._transition("candidate", "refresh_candidate",
                         version=version, trees=len(merged.trees))
        return "candidate"

    def _poll_candidate(self, t: float) -> str:
        v = self.candidate_version
        state = self.registry.entry(v)["promoted_state"]
        if state in ("active", "retired"):
            return self._finish(t, "promoted")
        if state in ("rolled_back", "quarantined"):
            return self._finish(t, "rolled_back")
        if self.rollout is None:
            return "candidate"      # waiting for a rollout to attach
        info = self.rollout.model_info()
        arms = {a["arm"]: a for a in info["arms"]}
        if "canary" in arms:
            if arms["canary"].get("version") == v:
                self.stats.incr("canaries")
                self._transition("canary", "refresh_canary", version=v)
                return "canary"
            return "blocked"        # someone else's canary in flight
        try:
            self.rollout.start_canary(v)
        except RegistryError as e:
            self._journal.emit("refresh_canary_blocked",
                              episode=self.episode, version=v,
                              error=str(e))
            return "blocked"
        self.stats.incr("canaries")
        self._transition("canary", "refresh_canary", version=v)
        return "canary"

    def _poll_canary(self, t: float) -> str:
        # the registry entry state is the durable verdict — the gate
        # (or a human) commits promote/rollback there
        state = self.registry.entry(
            self.candidate_version)["promoted_state"]
        if state in ("active", "retired"):
            return self._finish(t, "promoted")
        if state in ("rolled_back", "quarantined"):
            return self._finish(t, "rolled_back")
        return "canary"

    def _finish(self, t: float, outcome: str) -> str:
        self.stats.incr(
            "promotions" if outcome == "promoted" else "rollbacks")
        self.cooldown_until = t + self.cfg.cooldown_s
        self.backoff_until = 0.0
        version = self.candidate_version
        self.candidate_version = None
        self.attempt = 0
        self._transition("idle", "refresh_" + outcome,
                         version=version,
                         cooldown_s=self.cfg.cooldown_s)
        return outcome

    def reset(self, now: Optional[float] = None) -> None:
        """Clear a GAVE_UP terminal (the human acknowledged) back to
        IDLE under a fresh cooldown."""
        t = time.time() if now is None else float(now)
        with self._lock:
            if self.state != "gave_up":
                raise RefreshError(
                    f"reset only applies to gave_up, state is "
                    f"{self.state!r}")
            self.cooldown_until = t + self.cfg.cooldown_s
            self.attempt = 0
            self.candidate_version = None
            self._transition("idle", "refresh_reset")

    # -- background drive ----------------------------------------------------

    def start(self, interval_s: float = 1.0) -> "RefreshController":
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception:   # noqa: BLE001 - keep the loop up
                    log.exception("refresh poll failed")

        self._thread = threading.Thread(
            target=loop, name="refresh-controller", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        self.stop()
        if self._registered:
            reg = get_registry()
            reg.unregister(REFRESH_NS)
            reg.unregister_exposition(REFRESH_NS)
            self._registered = False

    # -- exposition ----------------------------------------------------------

    def render_prometheus(self, prefix: str = PREFIX) -> str:
        """The ``mmlspark_tpu_refresh_*`` families
        (docs/observability.md §Metric families)."""
        snap = self.stats.snapshot()
        c, g = snap["counters"], snap["gauges"]
        with self._lock:
            state, episode = self.state, self.episode
        lines: List[str] = []

        def fam(suffix: str, typ: str, help_: str) -> str:
            name = f"{prefix}_refresh_{suffix}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            return name

        n = fam("state", "gauge",
                "1 for the refresh state machine's current state, 0 "
                "for the others.")
        for s in STATES:
            lines.append(f'{n}{_labels({"state": s})} '
                         f'{1 if s == state else 0}')
        n = fam("episode", "gauge",
                "Monotonic refresh episode counter.")
        lines.append(f"{n} {episode}")
        n = fam("transitions_total", "counter",
                "Refresh lifecycle events, by event.")
        for ev, key in (("triggered", "triggers"),
                        ("fit", "fits"),
                        ("fit_failed", "fit_failures"),
                        ("retry", "retries"),
                        ("candidate", "candidates"),
                        ("canary", "canaries"),
                        ("promoted", "promotions"),
                        ("rolled_back", "rollbacks"),
                        ("gave_up", "gave_up"),
                        ("recovered", "recoveries"),
                        ("starved", "starved")):
            lines.append(f'{n}{_labels({"event": ev})} '
                         f'{c.get(key, 0)}')
        n = fam("breach_streak", "gauge",
                "Consecutive breached trigger polls (arms at the "
                "hysteresis threshold).")
        lines.append(f"{n} {_fmt(g.get('breach_streak', 0))}")
        n = fam("cooldown_seconds", "gauge",
                "Seconds of post-episode cooldown remaining.")
        lines.append(
            f"{n} {_fmt(g.get('cooldown_remaining_s', 0))}")
        return "\n".join(lines) + "\n"
