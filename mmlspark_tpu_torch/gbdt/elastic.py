"""Elastic training: heartbeat leases, retried rendezvous, gang
supervision.

The port's counterpart of ``mmlspark_tpu/gbdt/elastic.py``, the layer the
reference builds on its chunk checkpoints (``TrainParams.checkpoint_dir``,
:mod:`.checkpoint`): a controller that abandons a wedged gang loses at
most one chunk, since the respawned gang resumes from the last boundary
and writes the same forest.

* :class:`HeartbeatWatchdog`: each controller touches its lease file in a
  shared directory and ages its peers' leases.  A peer is as old as the
  local monotonic time since its lease was last seen to change, never a
  comparison with another host's clock, so clock skew against a shared
  filesystem cannot age a healthy peer.  Beyond ``straggler_age_s`` a
  peer is a straggler (counted, its age gauged); beyond
  ``lease_timeout_s`` it is lost, and the default handler exits with
  :data:`RESTART_EXIT_CODE`.
* :func:`initialize_with_retry`: ``torch.distributed.init_process_group``
  (``gloo`` on the CPU, ``nccl`` on the card) under bounded exponential
  backoff, so that a rendezvous that fails for a moment (a port still in
  TIME_WAIT, a peer not bound yet) retries; a parameter error
  (``ValueError``, ``TypeError``) is raised at once.
* :func:`supervise`: run rounds of controller processes, and respawn the
  whole gang on a fresh port while any member exits nonzero.

The reference's ``enable_cpu_collectives`` is a jax setting with no
counterpart: ``torch.distributed`` has gloo on the CPU already.  Still to
come (ROADMAP.md, Queue A items 10 and 11): the lease beacons over the
reference's transport (``transport_address``, ``HeartbeatHub``) and the
controller entry point ``run_worker`` with sharded ingestion.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..core.profiling import StageStats

log = logging.getLogger("mmlspark_tpu_torch.gbdt.elastic")

#: the exit code of a controller that abandons a wedged gang after a
#: peer's lease expired ("respawn me; the checkpoint has my state"),
#: apart from crash codes so that the supervisor tells the two apart
RESTART_EXIT_CODE = 76

_HB_FILE = "hb_p{:03d}"


@dataclass
class ElasticConfig:
    """One controller's elastic settings."""
    heartbeat_dir: str
    process_id: int
    num_processes: int
    #: lease beacons over a transport (``host:port``); not ported yet
    transport_address: str = ""
    #: how often each controller touches its lease file
    heartbeat_interval_s: float = 0.25
    #: a peer's lease age beyond which it counts as a straggler
    straggler_age_s: float = 1.0
    #: a peer's lease age beyond which it is lost
    lease_timeout_s: float = 5.0
    #: how long a peer's lease file may take to first appear
    startup_grace_s: float = 60.0

    def __post_init__(self):
        if self.transport_address:
            raise NotImplementedError(
                "ElasticConfig.transport_address: lease beacons over the "
                "transport are not ported yet (ROADMAP.md, Queue A item "
                "11); use the shared heartbeat_dir")


class HeartbeatWatchdog:
    """A file-lease heartbeat: one thread per controller that, each tick,
    runs ``write_hook`` (a chaos injector's stall), touches this
    process's lease file and ages every peer's.  ``stats`` (a
    :class:`..core.profiling.StageStats`) counts ``heartbeat_stalls`` (a
    peer turning straggler) and ``peer_lost`` (a lease expiring) and
    gauges ``heartbeat_age_ms`` (the oldest peer at the latest tick).

    ``on_peer_lost(pid, age_s)`` is called once for each expired peer; by
    default the process exits with :data:`RESTART_EXIT_CODE` through
    ``os._exit``, since a survivor is typically blocked in a collective
    whose peer is gone."""

    def __init__(self, cfg: ElasticConfig, *,
                 stats: Optional[StageStats] = None,
                 on_peer_lost: Optional[Callable[[int, float], None]] = None,
                 write_hook: Optional[Callable[[], None]] = None):
        self.cfg = cfg
        self.stats = stats if stats is not None else StageStats()
        self.stats.incr("heartbeat_stalls", 0)
        self.stats.incr("peer_lost", 0)
        self.stats.set_gauge("heartbeat_age_ms", 0.0)
        self._on_peer_lost = on_peer_lost
        self._write_hook = write_hook
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stalled: Dict[int, bool] = {}
        self._lost: Dict[int, bool] = {}
        self._t0 = 0.0
        # each peer's last seen mtime, and the local monotonic instant it
        # was seen to change
        self._peer_mtime: Dict[int, float] = {}
        self._peer_seen: Dict[int, float] = {}

    def path_for(self, pid: int) -> str:
        return os.path.join(self.cfg.heartbeat_dir, _HB_FILE.format(pid))

    def _touch(self) -> None:
        with open(self.path_for(self.cfg.process_id), "w") as fh:
            fh.write(f"{time.time()}\n")

    def peer_ages(self) -> Dict[int, float]:
        """Seconds since each peer's lease was last seen to change (inf:
        never seen)."""
        now = time.monotonic()
        ages: Dict[int, float] = {}
        for p in range(self.cfg.num_processes):
            if p == self.cfg.process_id:
                continue
            try:
                mt = os.path.getmtime(self.path_for(p))
            except OSError:
                ages[p] = float("inf")
                continue
            if self._peer_mtime.get(p) != mt:
                self._peer_mtime[p] = mt
                self._peer_seen[p] = now
            ages[p] = now - self._peer_seen[p]
        return ages

    def start(self) -> "HeartbeatWatchdog":
        os.makedirs(self.cfg.heartbeat_dir, exist_ok=True)
        self.stats.set_gauge("heartbeat_age_ms", 0.0)
        self._t0 = time.time()
        self._touch()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="elastic-heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _check_peers(self) -> None:
        cfg = self.cfg
        in_grace = time.time() - self._t0 < cfg.startup_grace_s
        worst = 0.0
        for p, age in self.peer_ages().items():
            if age == float("inf"):
                if in_grace:
                    continue        # the peer is still starting
                # a lease missing past the grace reads as expired
                worst = max(worst, cfg.lease_timeout_s)
            else:
                worst = max(worst, age)
            stalled = age > cfg.straggler_age_s
            if stalled and not self._stalled.get(p):
                self.stats.incr("heartbeat_stalls")
                log.warning("peer %d heartbeat is %.2fs stale "
                            "(straggler threshold %.2fs)", p, age,
                            cfg.straggler_age_s)
            self._stalled[p] = stalled
            if age > cfg.lease_timeout_s and not self._lost.get(p):
                self._lost[p] = True
                self.stats.incr("peer_lost")
                self._handle_lost(p, age)
        self.stats.set_gauge("heartbeat_age_ms", round(worst * 1e3, 3))

    def _handle_lost(self, pid: int, age: float) -> None:
        if self._on_peer_lost is not None:
            self._on_peer_lost(pid, age)
            return
        log.error("controller %d lease expired (%.2fs > %.2fs); "
                  "abandoning the gang with RESTART_EXIT_CODE=%d: the "
                  "chunk checkpoint resumes it", pid, age,
                  self.cfg.lease_timeout_s, RESTART_EXIT_CODE)
        os._exit(RESTART_EXIT_CODE)

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.heartbeat_interval_s):
            try:
                if self._write_hook is not None:
                    self._write_hook()
                self._touch()
                self._check_peers()
            except Exception:  # noqa: BLE001 - the watchdog must outlive
                # a passing filesystem error
                log.exception("heartbeat tick failed; continuing")


def initialize_with_retry(coordinator_address: str, num_processes: int,
                          process_id: int, *, retries: int = 4,
                          backoff_s: float = 0.5,
                          sleep: Callable[[float], None] = time.sleep,
                          backend: Optional[str] = None) -> int:
    """``torch.distributed.init_process_group`` at
    ``tcp://coordinator_address`` (``host:port``) with ``num_processes``
    ranks, this one ``process_id``, under bounded exponential backoff
    (``backoff_s · 2^attempt``).  ``backend``: ``nccl`` when a card is
    present, else ``gloo``.  A ``ValueError`` or ``TypeError`` (bad
    parameters) is raised at once; after ``retries`` failed retries a
    ``RuntimeError`` is.  Returns the retries used."""
    import torch
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(
                backend=backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id)
            return attempt
        except (ValueError, TypeError):
            raise                    # bad parameters: a retry cannot help
        except Exception as e:  # noqa: BLE001 - rendezvous errors
            last = e
            if attempt >= retries:
                break
            wait = backoff_s * (2 ** attempt)
            log.warning("rendezvous with %s failed (%s: %s); retry "
                        "%d/%d in %.1fs", coordinator_address,
                        type(e).__name__, e, attempt + 1, retries, wait)
            sleep(wait)
    raise RuntimeError(
        f"rendezvous with {coordinator_address} failed after "
        f"{retries + 1} attempts") from last


def free_port() -> int:
    """A free TCP port the OS assigns (racy by nature: pair it with
    :func:`initialize_with_retry` or a fresh-port round of
    :func:`supervise`)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def supervise(spawn_round: Callable[[int, int], List],
              *, max_restarts: int = 3, round_timeout_s: float = 600.0,
              verbose: bool = True) -> int:
    """The gang supervisor: run rounds of ``spawn_round(attempt, port) ->
    [Popen, ...]`` until one round exits all zero.  Any nonzero exit (a
    killed member, a survivor's :data:`RESTART_EXIT_CODE`, a crash) fails
    the round, and the whole gang respawns on a fresh port (a collective
    group cannot take back one member); a round past
    ``round_timeout_s`` is killed and fails.  Returns the restarts used;
    raises ``RuntimeError`` after ``max_restarts`` failed rounds."""
    import subprocess
    for attempt in range(max_restarts + 1):
        port = free_port()
        procs = spawn_round(attempt, port)
        deadline = time.time() + round_timeout_s
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0,
                                              deadline - time.time())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        if any(rc is None for rc in rcs):
            for p in procs:          # a hung round: kill it and retry
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if verbose:
            log.info("gang round %d exited %s", attempt, rcs)
        if all(rc == 0 for rc in rcs):
            return attempt
        if attempt >= max_restarts:
            raise RuntimeError(
                f"gang failed after {attempt + 1} rounds "
                f"(last exit codes: {rcs})")
    raise AssertionError("unreachable")
