"""Sharded predictor fleet over the resumable transport.

The port's copy of ``mmlspark_tpu/io/fleet.py``.  The single-host
:class:`~mmlspark_tpu_torch.io.scoring.ScoringEngine` tops out at one
process's share of the machine; this module is the tier above it, on
the resumable transport:

* **Tree-range sharding** (``routing="shard"``) — a large forest is
  split into contiguous tree ranges aligned to ``num_class`` boundaries
  (:func:`shard_tree_ranges`); each worker process scores ONLY its
  slice (``Booster.predictor(tree_range=...)``, init score on shard 0
  exactly once) and the driver reduces the partial margin sums in
  shard order.  :class:`ShardedPredictor` is the same partial-sum
  computation run locally — the single-host reference the fleet is
  pinned bit-exact against (the reduce order is identical, so float32
  addition associates identically).
* **Replicated pool** (``routing="replica"``) — every worker holds the
  FULL model and each request routes to exactly one replica by
  consistent hashing (:class:`ConsistentHashRing`): losing or adding a
  replica remaps only the ring arc it owned, not the whole key space —
  the right shape for small models where sharding would just add
  reduce latency.
* **Resumable wire** — every driver↔worker hop is a
  :mod:`mmlspark_tpu_torch.io.transport` session carrying
  :mod:`mmlspark_tpu_torch.io.wire` raw-float32 blocks (requests ship ONE
  packed feature matrix; partials come back as ONE packed margin
  block).  A link blip replays only the unacked frames in both
  directions — an in-flight request's partials survive the blip
  without rescoring, and :class:`~mmlspark_tpu_torch.io.chaos.ChaosTransport`
  drills exactly that.
* **The booster's device** — every worker scores on the device of the
  booster the fleet was handed: a spawned worker loads the model file
  with that device, so a card fleet runs several processes on one card
  and a CPU fleet's workers use the native scorer.  Each partial comes
  to the host in one explicit copy before it is packed; nothing falls
  back to the CPU.

:class:`PredictorFleet` is an ordinary predictor callable
(``(n, f) float32 -> margins`` with ``num_features``/``mode``), so it
plugs straight into ``ScoringEngine(predictor=fleet)`` — the whole
serving stack (admission control, deadlines, salvage, telemetry) rides
on top unchanged.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import queue
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.capacity import capacity_enabled
from ..core.profiler import get_profiler
from ..core.profiling import StageStats
from ..core.telemetry import get_registry
from . import wire
from ..device import resolve_device
from .scoring import _host_margins
from .transport import (CH_CONTROL, CH_SCORING, TransportClient,
                        TransportConfig, TransportServer, TransportError)

log = logging.getLogger(__name__)

__all__ = [
    "ConsistentHashRing", "PredictorFleet", "ShardedPredictor",
    "shard_tree_ranges",
]


def shard_tree_ranges(num_trees: int, num_shards: int,
                      num_class: int = 1) -> List[Tuple[int, int]]:
    """Split a forest of ``num_trees`` into ``num_shards`` contiguous
    ``(lo, hi)`` tree ranges aligned to ``num_class`` boundaries (both
    forest walkers assign class = local index % K, so shards must hold
    whole boosting iterations).  Ranges are balanced to within one
    iteration; shards beyond the iteration count come back empty
    ``(T, T)`` rather than failing, so a 4-shard fleet can serve a
    3-iteration model."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    K = max(1, int(num_class))
    units = (num_trees + K - 1) // K          # boosting iterations
    base, extra = divmod(units, num_shards)
    ranges: List[Tuple[int, int]] = []
    lo_u = 0
    for s in range(num_shards):
        hi_u = lo_u + base + (1 if s < extra else 0)
        ranges.append((min(lo_u * K, num_trees),
                       min(hi_u * K, num_trees)))
        lo_u = hi_u
    return ranges


class ShardedPredictor:
    """Tree-range partial-sum scoring run locally — the single-host
    reference for the fleet's reduce (identical shard split, identical
    float32 reduce order → bit-exact), and a usable predictor in its
    own right (each call walks the same trees, just as N partial
    walks).  ``include_init_score`` lands on shard 0 exactly once."""

    def __init__(self, booster, num_shards: int = 2,
                 backend: str = "auto",
                 ranges: Optional[Sequence[Tuple[int, int]]] = None):
        self.ranges = list(ranges) if ranges is not None else \
            shard_tree_ranges(len(booster.trees), num_shards,
                              booster.num_class)
        self.num_features = booster.max_feature_idx + 1
        self._K = booster.num_class
        self._parts = [
            booster.predictor(backend=backend, tree_range=(lo, hi),
                              include_init_score=(i == 0))
            for i, (lo, hi) in enumerate(self.ranges)]

    @property
    def mode(self) -> str:
        return "sharded"

    def partials(self, X) -> List[np.ndarray]:
        """Each shard's ``(n, K)`` float32 partial margin block."""
        n = np.shape(X)[0]
        return [_host_margins(p(X), n).astype(np.float32, copy=False)
                .reshape(n, -1) for p in self._parts]

    def __call__(self, X):
        parts = self.partials(X)
        out = parts[0]
        for p in parts[1:]:         # shard order: the pinned reduce
            out = out + p
        return out[:, 0] if self._K == 1 else out


class ConsistentHashRing:
    """Consistent hashing with virtual nodes: ``route(key)`` maps a
    request id to one replica; removing a node remaps ONLY the arcs it
    owned (its keys spread over the survivors) and re-adding it
    restores them — the property that keeps a replica loss from
    reshuffling every client's affinity."""

    def __init__(self, nodes: Sequence[Any] = (), vnodes: int = 64):
        self._vnodes = int(vnodes)
        self._ring: List[Tuple[int, Any]] = []
        self._nodes: set = set()
        for n in nodes:
            self.add(n)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.md5(key.encode("utf-8")).digest()[:8], "big")

    def add(self, node: Any) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        # build-and-rebind (like remove): route() bisects the list
        # lock-free from scorer threads, so it must never observe a
        # mid-sort ring
        ring = self._ring + [(self._hash(f"{node}#{v}"), node)
                             for v in range(self._vnodes)]
        ring.sort()
        self._ring = ring

    def remove(self, node: Any) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]

    def nodes(self) -> set:
        return set(self._nodes)

    def route(self, key: str) -> Any:
        """The node owning ``key``'s ring arc (clockwise successor)."""
        if not self._ring:
            raise RuntimeError("consistent-hash ring has no nodes")
        h = self._hash(str(key))
        ring = self._ring
        lo, hi = 0, len(ring)
        while lo < hi:                  # first vnode hash > h
            mid = (lo + hi) // 2
            if ring[mid][0] <= h:
                lo = mid + 1
            else:
                hi = mid
        return ring[lo % len(ring)][1]


class _FleetCall:
    """One in-flight fleet request: the partials collected so far and
    the shard set still owed."""

    __slots__ = ("event", "parts", "expect", "error")

    def __init__(self, expect):
        self.event = threading.Event()
        self.parts: Dict[int, np.ndarray] = {}
        self.expect = set(expect)
        self.error: Optional[str] = None


def _rid_version(rid: str) -> Optional[int]:
    """The model version a fleet rid is stamped with (``v<N>|...``), or
    ``None`` for unstamped rids (pre-rollout drivers)."""
    if rid.startswith("v"):
        head, sep, _ = rid.partition("|")
        if sep:
            try:
                return int(head[1:])
            except ValueError:
                return None
    return None


def _fleet_worker_main(driver_host: str, driver_port: int,
                       shard_id: int, model_path: Optional[str],
                       lo: int, hi: int, backend: str, token: str,
                       replica: bool = False,
                       booster=None, version: int = 0,
                       device: Optional[str] = None) -> None:
    """Fleet worker entrypoint (module-level for spawn pickling; tests
    run it as a thread passing ``booster`` directly).  Holds the shard's
    tree-range partial predictor (or the full model in replica mode),
    answers raw-float32 score requests with packed partial blocks, and
    rides ONE resumable transport session — a link blip replays, it
    does not rescore.

    Model rollout: the worker holds a VERSIONED predictor
    map.  ``load_version`` control messages stage a new model from a
    digest-verified file (the registry's) for this shard's new tree
    range; ``activate_version`` flips the default atomically and keeps
    the PREVIOUS version's predictor alive — every score request's rid
    is stamped with the version the driver fanned it out under, so an
    in-flight request completes on its own version on every shard and
    no reduce ever mixes tree-range shards from two models.

    ``device`` is where a loaded model scores (the fleet's booster's
    device, passed by :meth:`PredictorFleet._spawn_proc`): a worker that
    cannot reach it raises, it never falls back to the CPU."""
    if booster is None:
        if device is None:
            raise ValueError("a fleet worker that loads its model needs "
                             "the device to score on")
        from ..gbdt.booster import Booster
        booster = Booster.load_native_model(model_path, device=device)
    else:
        device = str(resolve_device(booster.device))
    if replica:
        pred = booster.predictor(backend=backend)
    else:
        pred = booster.predictor(backend=backend, tree_range=(lo, hi),
                                 include_init_score=(lo == 0))
    #: version -> predictor; staged entries await activate_version
    preds: Dict[int, Any] = {int(version): pred}
    staged: Dict[int, Any] = {}
    active = {"v": int(version)}
    stop_evt = threading.Event()
    work: "queue.Queue" = queue.Queue()

    def on_message(session, channel, msg, deadline_ms):
        if channel == CH_CONTROL and isinstance(msg, dict):
            op = msg.get("op")
            if op == "stop":
                stop_evt.set()
                work.put(None)
            elif op in ("load_version", "activate_version"):
                # model loads block (file read + predictor build):
                # run them on the work queue, never the read pump
                work.put(msg)
            return
        if channel == CH_SCORING:
            # scoring runs OFF the read pump (a long model load or
            # first walk must not stall keepalives into a false
            # half-open teardown)
            work.put(msg)

    def handle_version_op(msg) -> None:
        op, v = msg.get("op"), int(msg.get("version", -1))
        try:
            if op == "load_version":
                from ..gbdt.booster import Booster
                # digest-verified load: a torn/bit-flipped model file
                # raises here and the driver aborts the cutover —
                # never a shard serving garbage
                b = Booster.load_native_model(msg["path"],
                                              device=device)
                if replica:
                    p = b.predictor(backend=backend)
                else:
                    nlo, nhi = int(msg["lo"]), int(msg["hi"])
                    p = b.predictor(backend=backend,
                                    tree_range=(nlo, nhi),
                                    include_init_score=(nlo == 0))
                staged[v] = p
                client.send(CH_CONTROL,
                            {"op": "version_loaded",
                             "shard": shard_id, "version": v})
            elif op == "activate_version":
                p = staged.pop(v, preds.get(v))
                if p is None:
                    raise RuntimeError(
                        f"version {v} was never staged on shard "
                        f"{shard_id}")
                prev = active["v"]
                preds[v] = p
                active["v"] = v
                # keep ONLY the previous version for in-flight
                # requests stamped with it; older ones retire
                for old in [k for k in preds
                            if k not in (v, prev)]:
                    preds.pop(old, None)
                client.send(CH_CONTROL,
                            {"op": "version_active",
                             "shard": shard_id, "version": v})
        except Exception as e:  # noqa: BLE001 - one failed cutover
            # step, reported; the worker keeps serving its current
            # version
            log.exception("fleet shard %d: %s for version %d failed",
                          shard_id, op, v)
            try:
                client.send(CH_CONTROL,
                            {"op": "version_op_failed",
                             "shard": shard_id, "version": v,
                             "req_op": op, "detail": repr(e)})
            except OSError:
                pass

    def on_connect(resumed):
        try:
            client.send(CH_CONTROL, {"op": "hello", "shard": shard_id})
        except OSError:
            pass    # link died instantly; the next reconnect re-hellos

    client = TransportClient(
        (driver_host, driver_port), token=token,
        cfg=TransportConfig(reconnect_backoff=(0.05, 1.0),
                            reconnect_tries=8),
        on_message=on_message, on_connect=on_connect,
        on_down=lambda: (stop_evt.set(), work.put(None)),
        name=f"fleet-shard{shard_id}")
    client.connect()

    def score_one(msg) -> None:
        rid = ""
        try:
            if isinstance(msg, (bytes, memoryview)):
                _kind, rid, X = wire.unpack_matrix(msg)
            elif isinstance(msg, dict):
                if msg.get("op") in ("load_version",
                                     "activate_version"):
                    handle_version_op(msg)
                    return
                if msg.get("op") != "score":
                    return
                # negotiated JSON fallback (peer without the binary
                # capability)
                rid = str(msg.get("rid", ""))
                X = np.asarray(msg["X"], np.float32)
            else:
                return
            # version pinning: score with the predictor the rid was
            # stamped for (the driver's fan-out version), falling back
            # to the active one for unstamped rids — a cutover racing
            # this request cannot make shards answer from two models
            rv = _rid_version(rid)
            p = preds.get(rv if rv is not None else active["v"])
            if p is None:
                p = staged.get(rv)
            if p is None:
                raise RuntimeError(
                    f"shard {shard_id} no longer holds version {rv}")
            m = _host_margins(p(X), X.shape[0]).astype(
                np.float32, copy=False).reshape(X.shape[0], -1)
            if client.session.peer_binary:
                client.send_bytes(
                    CH_SCORING,
                    wire.pack_matrix(rid, m, kind=wire.K_PARTIAL))
            else:
                client.send(CH_SCORING, {"op": "partial", "rid": rid,
                                         "shard": shard_id,
                                         "m": m.tolist()})
        except Exception as e:  # noqa: BLE001 - one request, not the loop
            log.exception("fleet shard %d: scoring failed", shard_id)
            try:
                client.send(CH_SCORING, {"op": "partial_error",
                                         "rid": rid, "shard": shard_id,
                                         "detail": repr(e)})
            except OSError:
                pass

    while not stop_evt.is_set():
        msg = work.get()
        if msg is None:
            break
        score_one(msg)
    client.close()


class PredictorFleet:
    """A multiprocess predictor pool behind one callable.

    ``routing="shard"`` — tree-range sharding with partial-sum reduce:
    every request fans out to ALL shards as one packed float32 block;
    the driver sums the partial margin blocks in shard order (the
    pinned reduce :class:`ShardedPredictor` reproduces locally).

    ``routing="replica"`` — full-model replicas behind consistent-hash
    routing: each request's id picks ONE replica on the ring.

    ``spawn=True`` forks real worker processes (the model rides a temp
    native-model file); ``spawn=False`` runs the workers as threads in
    this process sharing ``booster`` — the test topology (still real
    sockets, real frames, chaos-wrappable).
    """

    def __init__(self, booster, num_shards: int = 2, *,
                 routing: str = "shard", backend: str = "auto",
                 token: Optional[str] = None, host: str = "127.0.0.1",
                 spawn: bool = True, join_timeout: float = 60.0,
                 request_timeout_s: float = 30.0,
                 transport_config: Optional[TransportConfig] = None):
        import secrets
        if routing not in ("shard", "replica"):
            raise ValueError("routing must be 'shard' or 'replica'")
        self.routing = routing
        self.num_shards = int(num_shards)
        self.num_features = booster.max_feature_idx + 1
        self._K = booster.num_class
        self._init_score = float(booster.init_score)
        self._booster = booster
        self._device = str(resolve_device(booster.device))
        self._backend = backend
        self._spawn = bool(spawn)
        self._join_timeout = join_timeout
        self._timeout = request_timeout_s
        self.token = secrets.token_hex(16) if token is None else token
        self.ranges = ([(0, len(booster.trees))] * self.num_shards
                       if routing == "replica" else
                       shard_tree_ranges(len(booster.trees),
                                         self.num_shards,
                                         self._K))
        self._ts = TransportServer(
            host, 0, token=self.token,
            cfg=transport_config or TransportConfig(),
            on_message=self._on_msg, on_session_lost=self._on_lost,
            name="fleet-driver")
        self._ring = ConsistentHashRing(range(self.num_shards))
        self._slot_sid: Dict[int, str] = {}
        self._calls: Dict[str, _FleetCall] = {}
        # model rollout state: per-version shard ranges +
        # reduce metadata; score() snapshots ONE version per request
        # and stamps it into the rid, so a cutover mid-fan-out can
        # never mix tree-range shards from two models in one reduce
        self._active_version = 0
        # "path" (set in start() / load_version) is what a respawned
        # worker reloads — kept per version so _worker_spec always
        # hands out the active model's file, not the original one
        self._version_meta: Dict[int, Dict[str, Any]] = {
            0: {"ranges": list(self.ranges), "K": self._K,
                "init_score": self._init_score, "path": None}}
        #: (op, version) -> {"event", "acked": set, "failed": dict}
        self._ctrl_waiters: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self._procs: List[Any] = []
        self._threads: List[threading.Thread] = []
        self._model_path: Optional[str] = None
        self._supervisor: Optional[threading.Thread] = None
        # fleet telemetry, federated like every other subsystem
        self.stats = StageStats()
        for k in ("requests", "partials", "timeouts", "shard_errors",
                  "worker_respawns", "version_cutovers"):
            self.stats.incr(k, 0)
        # resolved once: timer() locks per call — per-request tax.
        # All four are fleet-owned and ALIASED into the profile view
        # (newest fleet wins, like the scoring engine's stages) so the
        # perf_report phase table never mixes a per-instance e2e with
        # process-lifetime accumulators
        self._rtt = self.stats.timer("fleet_rtt")
        self._pt_fanout = self.stats.timer("fanout")
        self._pt_wait = self.stats.timer("wait")
        self._pt_reduce = self.stats.timer("reduce")
        prof = get_profiler()
        prof.alias("fleet.request", self._rtt)
        prof.alias("fleet.fanout", self._pt_fanout)
        prof.alias("fleet.wait", self._pt_wait)
        prof.alias("fleet.reduce", self._pt_reduce)
        # saturation taps, flag cached like the scoring
        # engine's: in-flight fan-outs and shard responses still owed
        # are the fleet's backlog gauges (summed across processes by
        # the gauge merge policy); reduce_wait_ms is the last request's
        # wait+reduce tail — the first number to grow when a shard
        # stops keeping up
        self._cap_taps = capacity_enabled()
        if self._cap_taps:
            self.stats.set_gauge("fanout_inflight", 0.0)
            self.stats.set_gauge("shards_awaited", 0.0)
        # data-quality tap: attach_drift() installs a
        # DriftMonitor; score() then sketches every request's feature
        # block + reduced margins at the fan-out point
        self._drift = None

    def _note_backlog_locked(self) -> None:
        """Refresh the fan-out backlog gauges (called under
        ``self._lock``): requests in flight, and shard responses still
        owed across them — the per-shard saturation signal."""
        self.stats.set_gauge("fanout_inflight", float(len(self._calls)))
        self.stats.set_gauge(
            "shards_awaited",
            float(sum(len(c.expect) for c in self._calls.values())))

    def attach_drift(self, monitor) -> "PredictorFleet":
        """Attach a :class:`~mmlspark_tpu_torch.core.drift.DriftMonitor`
        (built from the served model's reference profile) and install
        it process-wide so the drift SLO objectives and the
        ``mmlspark_tpu_drift_*`` families read it."""
        from ..core.drift import set_drift_monitor
        self._drift = monitor
        set_drift_monitor(monitor)
        return self

    @property
    def mode(self) -> str:
        return "fleet"

    # ---- lifecycle ----

    def _worker_spec(self, shard: int) -> Tuple[Optional[str], int,
                                                int, int]:
        """The ``(model_path, lo, hi, version)`` a (re)spawned worker
        for ``shard`` must come up with: always the ACTIVE version's
        file and tree range.  After a cutover ``self._model_path``
        still names the version-0 model while ``self.ranges`` describes
        the new one — a respawn mixing the two would load the wrong
        forest, hold only version 0, and fail every ``vN|…`` request
        until the next cutover."""
        with self._lock:
            ver = self._active_version
            meta = self._version_meta[ver]
            lo, hi = meta["ranges"][shard]
            path = meta.get("path") or self._model_path
        return path, lo, hi, ver

    def _spawn_proc(self, shard: int):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        dh, dp = self._ts.address
        path, lo, hi, ver = self._worker_spec(shard)
        p = ctx.Process(
            target=_fleet_worker_main,
            args=(dh, dp, shard, path, lo, hi,
                  self._backend, self.token,
                  self.routing == "replica"),
            kwargs={"version": ver, "device": self._device},
            daemon=True)
        p.start()
        return p

    def start(self) -> "PredictorFleet":
        self._ts.start()
        if self._spawn:
            fd, self._model_path = tempfile.mkstemp(
                suffix=".lgbm.txt", prefix="fleet_model_")
            os.close(fd)
            self._booster.save_native_model(self._model_path)
            with self._lock:
                self._version_meta[0]["path"] = self._model_path
            self._procs = [self._spawn_proc(s)
                           for s in range(self.num_shards)]
        else:
            dh, dp = self._ts.address
            self._threads = [
                threading.Thread(
                    target=_fleet_worker_main,
                    args=(dh, dp, s, None, *self.ranges[s],
                          self._backend, self.token,
                          self.routing == "replica"),
                    kwargs={"booster": self._booster},
                    name=f"fleet-shard{s}", daemon=True)
                for s in range(self.num_shards)]
            for t in self._threads:
                t.start()
        deadline = time.monotonic() + self._join_timeout
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._slot_sid) == self.num_shards:
                    break
            time.sleep(0.02)
        else:
            missing = [s for s in range(self.num_shards)
                       if s not in self._slot_sid]
            self.stop()
            raise RuntimeError(
                f"fleet shards {missing} never joined within "
                f"{self._join_timeout}s")
        if self._spawn:
            self._supervisor = threading.Thread(
                target=self._supervise, name="fleet-supervisor",
                daemon=True)
            self._supervisor.start()
        get_registry().register("fleet", self.stats)
        return self

    def _supervise(self) -> None:
        while not self._closing.wait(0.5):
            for s, p in enumerate(self._procs):
                if p.is_alive() or self._closing.is_set():
                    continue
                log.warning("fleet: shard %d process died (exitcode "
                            "%s); respawning", s, p.exitcode)
                self.stats.incr("worker_respawns")
                self._procs[s] = self._spawn_proc(s)

    def stop(self) -> None:
        self._closing.set()
        for session in list(self._ts.sessions.values()):
            try:
                session.send(CH_CONTROL, {"op": "stop"}, timeout=1.0)
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for t in self._threads:
            t.join(timeout=5)
        self._ts.stop()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
            self._supervisor = None
        if self._model_path:
            try:
                os.unlink(self._model_path)
            except OSError:
                pass
            self._model_path = None
        # release any caller still parked on an in-flight request
        with self._lock:
            calls = list(self._calls.values())
            self._calls.clear()
        for c in calls:
            c.error = "fleet stopped"
            c.event.set()

    # ---- driver-side protocol ----

    def _on_msg(self, session, channel: int, msg, deadline_ms) -> None:
        if channel == CH_CONTROL and isinstance(msg, dict) \
                and msg.get("op") in ("version_loaded",
                                      "version_active",
                                      "version_op_failed"):
            self._on_version_ack(msg)
            return
        if channel == CH_CONTROL and isinstance(msg, dict) \
                and msg.get("op") == "hello":
            s = msg.get("shard")
            if isinstance(s, int) and 0 <= s < self.num_shards:
                stale_sid = None
                with self._lock:
                    old_sid = self._slot_sid.get(s)
                    if old_sid is not None and old_sid != session.sid:
                        # a respawned worker took the slot over: drop
                        # the superseded session NOW instead of letting
                        # it linger until resume grace fires on_lost
                        stale_sid = old_sid
                    self._slot_sid[s] = session.sid
                    session.meta["shard"] = s
                    # a (re)joined replica re-enters the routing ring —
                    # its old arcs come back, everyone else's keys stay
                    # where they were
                    self._ring.add(s)
                if stale_sid is not None:
                    self._ts.drop_session(stale_sid, notify=False)
            else:
                log.warning("fleet: ignoring hello with invalid shard "
                            "id %r", s)
            return
        if channel != CH_SCORING:
            return
        if isinstance(msg, (bytes, memoryview)):
            try:
                kind, rid, m = wire.unpack_matrix(msg)
            except wire.WireError as e:
                # one malformed partial costs one request, never the
                # session: fail the waiter if the rid is recoverable
                rid = wire.peek_rid(msg)
                self._fail_call(rid, f"malformed partial: {e}")
                return
            if kind != wire.K_PARTIAL:
                return
            self._add_partial(session, rid, m)
        elif isinstance(msg, dict):
            op = msg.get("op")
            if op == "partial":
                m = np.asarray(msg.get("m"), np.float32)
                self._add_partial(session, str(msg.get("rid")), m,
                                  shard=msg.get("shard"))
            elif op == "partial_error":
                self.stats.incr("shard_errors")
                self._fail_call(str(msg.get("rid")),
                                f"shard {msg.get('shard')} failed: "
                                f"{msg.get('detail')}")

    def _add_partial(self, session, rid: str, m: np.ndarray,
                     shard: Optional[int] = None) -> None:
        if shard is None:
            shard = session.meta.get("shard")
        with self._lock:
            call = self._calls.get(rid)
            if call is None or shard not in call.expect:
                return        # late/duplicate partial: already answered
            call.parts[shard] = np.asarray(m, np.float32)
            call.expect.discard(shard)
            done = not call.expect
        self.stats.incr("partials")
        if done:
            call.event.set()

    def _fail_call(self, rid: str, detail: str) -> None:
        with self._lock:
            call = self._calls.pop(rid, None)
        if call is not None:
            call.error = detail
            call.event.set()

    def _on_lost(self, session) -> None:
        """A shard session died for good (resume grace expired): free
        its slot for the respawned worker's hello, take a dead REPLICA
        out of the routing ring (its arcs remap to the survivors — the
        failover the ring exists for; shard-mode fan-out still needs
        every range, so a lost shard there fails calls fast instead),
        and fail the calls still waiting on it — the engine's salvage
        path rescores them once capacity returns."""
        with self._lock:
            s = session.meta.get("shard")
            held = (s is not None
                    and self._slot_sid.get(s) == session.sid)
            if held:
                self._slot_sid.pop(s, None)
                self._ring.remove(s)
            # only a session that still HELD the slot strands calls: a
            # superseded session's loss must not fail requests the NEW
            # healthy session is already serving
            stranded = ([rid for rid, c in self._calls.items()
                         if s in c.expect] if held else [])
        for rid in stranded:
            self._fail_call(rid, f"shard {s} session lost")

    def _session_for(self, shard: int):
        with self._lock:
            sid = self._slot_sid.get(shard)
        session = self._ts.sessions.get(sid) if sid else None
        if session is None:
            raise TransportError(
                f"fleet shard {shard} has no live session")
        return session

    # ---- versioned cutover ----

    def _on_version_ack(self, msg: dict) -> None:
        op = {"version_loaded": "load_version",
              "version_active": "activate_version",
              "version_op_failed": None}[msg["op"]]
        v = int(msg.get("version", -1))
        shard = msg.get("shard")
        keys = ([(op, v)] if op is not None
                else [("load_version", v), ("activate_version", v)])
        with self._lock:
            for key in keys:
                w = self._ctrl_waiters.get(key)
                if w is None:
                    continue
                if msg["op"] == "version_op_failed":
                    w["failed"][shard] = msg.get("detail", "")
                else:
                    w["acked"].add(shard)
                if w["failed"] or len(w["acked"]) >= self.num_shards:
                    w["event"].set()

    def _version_barrier(self, op: str, version: int, payloads,
                         timeout: float) -> None:
        """Send one control message per shard and wait for EVERY shard
        to ack — the all-or-nothing half of the two-phase cutover."""
        waiter = {"event": threading.Event(), "acked": set(),
                  "failed": {}}
        with self._lock:
            self._ctrl_waiters[(op, version)] = waiter
        try:
            for s in range(self.num_shards):
                self._session_for(s).send(
                    CH_CONTROL, payloads[s], timeout=timeout)
            if not waiter["event"].wait(timeout):
                missing = sorted(set(range(self.num_shards))
                                 - waiter["acked"])
                raise TransportError(
                    f"fleet {op} v{version}: shards {missing} never "
                    f"acked within {timeout}s")
            if waiter["failed"]:
                raise TransportError(
                    f"fleet {op} v{version} failed on shards "
                    f"{waiter['failed']}")
        finally:
            with self._lock:
                self._ctrl_waiters.pop((op, version), None)

    def load_version(self, model_path: str,
                     version: Optional[int] = None,
                     timeout: Optional[float] = None) -> int:
        """Phase 1 of the shard-consistent cutover: stage
        ``model_path`` (a digest-stamped native-model file — e.g.
        ``ModelRegistry.model_path(v)``) on EVERY shard under
        ``version``, each shard building its predictor for the NEW
        model's tree ranges.  Blocks until all shards acked the load;
        any shard's failure (digest mismatch included) aborts with the
        fleet still serving the old version everywhere.  ``model_path``
        must stay readable for as long as the version serves: the
        supervisor reloads it when it respawns a crashed worker."""
        from ..gbdt.booster import Booster
        timeout = self._join_timeout if timeout is None else timeout
        # driver-side load verifies the digest once more and yields
        # the new forest's shape for the per-shard tree ranges
        b = Booster.load_native_model(model_path, device=self._device)
        if b.max_feature_idx + 1 > self.num_features:
            raise ValueError(
                f"new model wants {b.max_feature_idx + 1} features, "
                f"fleet clients send {self.num_features}")
        K = b.num_class
        ranges = ([(0, len(b.trees))] * self.num_shards
                  if self.routing == "replica" else
                  shard_tree_ranges(len(b.trees), self.num_shards, K))
        with self._lock:
            if version is None:
                version = max(self._version_meta) + 1
            version = int(version)
            if version in self._version_meta:
                raise ValueError(
                    f"fleet already holds version {version}")
        payloads = [{"op": "load_version", "version": version,
                     "path": model_path, "lo": lo, "hi": hi}
                    for lo, hi in ranges]
        self._version_barrier("load_version", version, payloads,
                              timeout)
        with self._lock:
            self._version_meta[version] = {
                "ranges": ranges, "K": K,
                "init_score": float(b.init_score),
                "path": model_path}
        return version

    def activate_version(self, version: int,
                         timeout: Optional[float] = None) -> int:
        """Phase 2: flip every shard's default to ``version`` (must be
        staged via :meth:`load_version` first) and then flip the
        driver's fan-out version atomically.  Requests fanned out
        before the flip carry the old version in their rids and reduce
        against the OLD model on every shard; requests after carry the
        new one — no reduce ever mixes the two."""
        timeout = self._join_timeout if timeout is None else timeout
        version = int(version)
        with self._lock:
            meta = self._version_meta.get(version)
            if meta is None:
                raise ValueError(
                    f"version {version} was never load_version()ed")
        payloads = [{"op": "activate_version", "version": version}
                    for _ in range(self.num_shards)]
        self._version_barrier("activate_version", version, payloads,
                              timeout)
        with self._lock:
            prev_active = self._active_version
            self._active_version = version
            self.ranges = list(meta["ranges"])
            self._K = meta["K"]
            self._init_score = meta["init_score"]
            # drop metadata for versions the workers retired (they
            # keep only current + previous)
            for v in [v for v in self._version_meta
                      if v not in (version, prev_active)]:
                self._version_meta.pop(v, None)
        self.stats.incr("version_cutovers")
        return version

    @property
    def active_version(self) -> int:
        return self._active_version

    # ---- the predictor contract ----

    def __call__(self, X):
        return self.score(X)

    def score(self, X, key: Optional[str] = None) -> np.ndarray:
        """Score a batch.  ``routing="shard"`` fans the packed block to
        every shard and reduces the partial sums in shard order;
        ``routing="replica"`` consistent-hash-routes the whole request
        to one replica (``key`` overrides the auto request id as the
        ring key — e.g. a client id for session affinity)."""
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim != 2:
            raise ValueError(f"expected (n, f) input, got {X.shape}")
        # ONE version snapshot per request, stamped into the rid: every
        # shard scores this request under exactly this version, and a
        # cutover racing the fan-out changes only LATER requests — the
        # shard-consistency contract (docs/rollout.md §Fleet cutover)
        with self._lock:
            ver = self._active_version
            meta = self._version_meta[ver]
            ranges, K, init_score = (meta["ranges"], meta["K"],
                                     meta["init_score"])
        rid = f"v{ver}|f{next(self._seq)}"
        if self.routing == "shard":
            targets = [s for s, (lo, hi) in enumerate(ranges)
                       if hi > lo]
            if not targets:
                # a 0-tree forest has no shard to ask: the margin is
                # the init score — answer immediately instead of
                # parking a waiter nothing will ever complete
                out = np.full((X.shape[0], K), np.float32(init_score))
                return out[:, 0] if K == 1 else out
        else:
            targets = [self._ring.route(key if key is not None
                                        else rid)]
        call = _FleetCall(targets)
        with self._lock:
            self._calls[rid] = call
            if self._cap_taps:
                self._note_backlog_locked()
        self.stats.incr("requests")
        prof = get_profiler()
        t0 = time.perf_counter()
        try:
            buf = None
            for s in targets:
                session = self._session_for(s)
                if session.peer_binary:
                    if buf is None:
                        buf = wire.pack_matrix(rid, X)
                    session.send_bytes(CH_SCORING, buf,
                                       timeout=self._timeout)
                else:   # negotiated JSON fallback
                    session.send(CH_SCORING,
                                 {"op": "score", "rid": rid,
                                  "X": X.tolist()},
                                 timeout=self._timeout)
            self._pt_fanout.record(time.perf_counter() - t0)
            t_wait = time.perf_counter()
            if not call.event.wait(self._timeout):
                self.stats.incr("timeouts")
                raise TransportError(
                    f"fleet request {rid} timed out after "
                    f"{self._timeout}s (missing shards "
                    f"{sorted(call.expect)})")
            if call.error:
                raise TransportError(
                    f"fleet request {rid} failed: {call.error}")
        finally:
            with self._lock:
                self._calls.pop(rid, None)
                if self._cap_taps:
                    self._note_backlog_locked()
        wait_s = time.perf_counter() - t_wait
        self._pt_wait.record(wait_s)
        t_red = time.perf_counter()
        if self.routing == "replica":
            out = call.parts[targets[0]]
        else:
            # the PINNED reduce: ascending shard order, float32 — the
            # exact association ShardedPredictor uses locally, so the
            # fleet is bit-exact with the single-host reference
            order = sorted(call.parts)
            out = call.parts[order[0]]
            for s in order[1:]:
                out = out + call.parts[s]
        reduce_s = time.perf_counter() - t_red
        self._pt_reduce.record(reduce_s)
        if self._cap_taps:
            # the wait+reduce tail of THIS request, as an instantaneous
            # level — the per-shard lag signal the merged scrape shows
            # without waiting for a histogram window to fill
            self.stats.set_gauge("reduce_wait_ms",
                                 round((wait_s + reduce_s) * 1e3, 3))
        # the request window covers fanout+wait+reduce — it is the
        # fleet's e2e and the aliased fleet.request denominator; slow
        # fan-outs also land on the trace timeline (rid doubles as the
        # trace id for fleet-internal requests)
        req_s = time.perf_counter() - t0
        self._rtt.record(req_s)
        prof.span("fleet.request", req_s, tid=rid, record=False)
        out = out[:, 0] if K == 1 else out
        if self._drift is not None:
            # fleet topology's drift tap: the driver is the
            # one process that sees every request's full feature block
            # AND the reduced margin — sketching here covers all
            # shards/replicas with one monitor (duty-gated inside)
            self._drift.observe(X, out)
        return out
