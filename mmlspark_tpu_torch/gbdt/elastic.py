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
  under bounded exponential backoff, so that a rendezvous that fails for
  a moment (a port still in TIME_WAIT, a peer not bound yet) retries; a
  parameter error (``ValueError``, ``TypeError``) is raised at once.  The
  backend follows the topology (:func:`select_backend`), chosen before
  the first collective from every rank's host and device, which each
  rank publishes in the rendezvous store (:func:`gang_devices`), so
  that every rank chooses alike: ``nccl`` only when every rank has a
  card of its own, ``gloo`` when ranks share a card or run on the CPU
  (the gang's gathers then stage CUDA tensors through host memory).  A
  failure is never retried on another backend.
* :func:`supervise`: run rounds of controller processes, and respawn the
  whole gang on a fresh port while any member exits nonzero.
* :func:`run_worker` / :func:`main` (``python -m
  mmlspark_tpu_torch.gbdt.elastic``): one controller of a gang — the
  rendezvous, the watchdog, a sharded ``train`` over its own shards with
  ``checkpoint_dir`` live, and a stats dump.  Every controller
  regenerates the table and the shared bin mapper from the seed and bins
  only its own rows.

The reference's ``enable_cpu_collectives`` is a jax setting with no
counterpart: ``torch.distributed`` has gloo on the CPU already.  The
telemetry is the reference's: the watchdog's ``stats`` join the process
registry as ``"elastic"``, a lease file carries the fit span, a peer
turning straggler or lost journals ``peer_stalled`` / ``peer_lost``, an
abandoning controller writes a ``peer_lost_abandon`` flight record, and
:func:`run_worker`'s stats dump carries the journal's tail.  Still to come
(ROADMAP.md, Queue A item 11, slice 11c): the lease beacons over the
transport (``transport_address``, ``HeartbeatHub``).
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..core import telemetry as _tm
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
    #: the rendezvous's retries and first backoff
    #: (:func:`initialize_with_retry`; :func:`run_worker` reads them)
    init_retries: int = 4
    init_backoff_s: float = 0.5

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
        """Write this process's lease: the time and the fit span."""
        with open(self.path_for(self.cfg.process_id), "w") as fh:
            fh.write(f"{time.time()} {_tm.current_fit_span() or ''}\n")

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
        # the watchdog's gauges join the process registry (a controller's
        # /metrics or stats dump carries them)
        _tm.get_registry().register("elastic", self.stats)
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
                _tm.get_journal().emit(
                    "peer_stalled", fit=_tm.current_fit_span(), peer=p,
                    age_s=round(age, 3) if age != float("inf")
                    else "inf")
                log.warning("peer %d heartbeat is %.2fs stale "
                            "(straggler threshold %.2fs)", p, age,
                            cfg.straggler_age_s)
            self._stalled[p] = stalled
            if age > cfg.lease_timeout_s and not self._lost.get(p):
                self._lost[p] = True
                self.stats.incr("peer_lost")
                _tm.get_journal().emit(
                    "peer_lost", fit=_tm.current_fit_span(), peer=p,
                    age_s=round(age, 3) if age != float("inf")
                    else "inf")
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
        # os._exit runs no cleanup: the flight record is what this process
        # leaves behind about why it abandoned
        _tm.record_flight("peer_lost_abandon",
                          {"peer": pid, "age_s": round(age, 3),
                           "process_id": self.cfg.process_id})
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


def select_backend(rank_devices: Optional[Sequence] = None) -> str:
    """The ``torch.distributed`` backend of a gang whose ranks run on
    ``rank_devices`` (one per rank, ``"cuda:0"`` or, across hosts,
    ``"host/cuda:0"`` as :func:`gang_devices` lists them): ``nccl`` only
    when every rank has a CUDA card of its own (NCCL refuses two ranks on
    one device), else ``gloo`` (ranks sharing a card, or on the CPU).
    Unknown devices: ``gloo``."""
    import torch
    if not rank_devices:
        return "gloo"
    cards = []
    for spec in rank_devices:
        host, _, dev = str(spec).rpartition("/")
        d = torch.device(dev)
        if d.type != "cuda":
            return "gloo"
        cards.append((host, d.index))
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def _rendezvous_store(coordinator_address: str, num_processes: int,
                      process_id: int):
    """The gang's ``TCPStore`` at ``host:port``, bound by process 0."""
    import torch.distributed as dist
    host, port = coordinator_address.rsplit(":", 1)
    return dist.TCPStore(host, int(port), num_processes,
                         is_master=process_id == 0,
                         timeout=dist.constants.default_pg_timeout,
                         wait_for_workers=False)


def gang_devices(store, num_processes: int, process_id: int,
                 device) -> List[str]:
    """Every rank's ``"host/device"``: each rank publishes its own in the
    rendezvous ``store`` and reads the others', so that every rank holds
    the same list, whatever cards its own host has."""
    store.set(f"gang_device/{process_id}", f"{socket.gethostname()}/{device}")
    keys = [f"gang_device/{r}" for r in range(num_processes)]
    store.wait(keys)
    return [store.get(k).decode() for k in keys]


def initialize_with_retry(coordinator_address: str, num_processes: int,
                          process_id: int, *, retries: int = 4,
                          backoff_s: float = 0.5,
                          sleep: Callable[[float], None] = time.sleep,
                          backend: Optional[str] = None,
                          device=None) -> int:
    """``torch.distributed.init_process_group`` over the rendezvous store
    at ``coordinator_address`` (``host:port``, bound by process 0) with
    ``num_processes`` ranks, this one ``process_id``, under bounded
    exponential backoff (``backoff_s · 2^attempt``).  ``backend``: given;
    else, with this rank's ``device``, chosen from every rank's device
    before the group forms (:func:`gang_devices`, then
    :func:`select_backend`, so every rank picks the same); else
    ``gloo``.  A failure retries the same backend, never another.  A
    ``ValueError`` or ``TypeError`` (bad parameters) is raised at once;
    after ``retries`` failed retries a ``RuntimeError`` is.  Returns the
    retries used."""
    import torch.distributed as dist
    last: Optional[BaseException] = None
    store = None
    for attempt in range(retries + 1):
        try:
            if store is None:
                store = _rendezvous_store(coordinator_address,
                                          num_processes, process_id)
            if backend is None:
                backend = "gloo" if device is None else select_backend(
                    gang_devices(store, num_processes, process_id, device))
            dist.init_process_group(backend=backend, store=store,
                                    world_size=num_processes,
                                    rank=process_id)
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


# -- the controller entry point ----------------------------------------------


def _demo_table(seed: int, n: int, f: int, num_class: int = 2):
    """The table every controller regenerates from the seed (a real
    deployment reads its own files): ``f`` normal features and the
    reference's label, ``X0 + 0.5·X1 − 0.2·X2 > 0``, or with ``num_class``
    > 2 that score cut at its quantiles into classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] - 0.2 * X[:, 2]
    if num_class > 2:
        cuts = np.quantile(score, np.arange(1, num_class) / num_class)
        return X, np.digitize(score, cuts).astype(np.float64)
    return X, (score > 0).astype(np.float64)


def _table_fn(spec: str) -> Callable:
    """``"demo"`` (:func:`_demo_table`) or ``"module:function"``, a
    function ``(seed, rows, features, num_class) -> (X, y)``."""
    if spec == "demo":
        return _demo_table
    mod, _, name = spec.partition(":")
    if not name:
        raise ValueError(f"--table {spec!r}: use 'demo' or 'module:function'")
    return getattr(importlib.import_module(mod), name)


def _rank_device(spec: str, local_rank: int):
    """This rank's device: ``cpu``, ``cuda:N``, or ``cuda`` — the card of
    the rank's local index on its host, modulo the host's cards (local
    ranks share cards when there are more of them than cards)."""
    import torch
    if spec == "cuda":
        return torch.device("cuda",
                            local_rank % max(1, torch.cuda.device_count()))
    return torch.device(spec)


def _shard_cuts(args, n: int) -> List:
    """The rows of each data shard: cut at ``args.cuts`` (row indexes),
    else ``array_split`` into equal parts."""
    import numpy as np
    D = args.num_processes * args.shards_per_process
    if args.cuts:
        cuts = [int(c) for c in args.cuts.split(",")]
        if len(cuts) != D - 1 or sorted(cuts) != cuts or \
                not 0 < cuts[0] <= cuts[-1] < n:
            raise ValueError(f"--cuts {args.cuts!r}: {D - 1} increasing "
                             f"row indexes inside (0, {n}) needed")
        return np.split(np.arange(n), cuts)
    return np.array_split(np.arange(n), D)


def sharded_fit(args, process_id: Optional[int], device):
    """The fit :func:`run_worker` runs, as a function of its arguments:
    the table from ``args.table``, the bin mapper fitted on every row,
    the last ``args.val_rows`` rows the validation set, the rest cut into
    ``num_processes × shards_per_process`` data shards.  With
    ``process_id`` this is that controller of a gang (it bins and holds
    its own shards alone, on ``device``); without, one controller holding
    every shard on a mesh of ``device`` (the gang's reference fit).
    Returns ``(booster, fit seconds, seconds before the fit)`` (the
    table, the mapper and the binning)."""
    import numpy as np

    from ..core.mesh import build_mesh
    from .binning import fit_bin_mapper
    from .engine import TrainParams, train
    from .objectives import get_objective
    t_prep = time.perf_counter()
    X, y = _table_fn(args.table)(args.data_seed, args.rows, args.features,
                                 args.num_class)
    mapper = fit_bin_mapper(X, max_bin=args.max_bin)
    n = args.rows - args.val_rows
    idx = _shard_cuts(args, n)
    m = args.shards_per_process
    owned = (range(len(idx)) if process_id is None
             else range(process_id * m, (process_id + 1) * m))
    slots_b: List = [None] * len(idx)
    for d in owned:
        slots_b[d] = mapper.transform_packed(X[idx[d]])
    mesh = build_mesh(len(idx) if process_id is None else None,
                      devices=[device] * len(owned))
    params = TrainParams(
        num_iterations=args.iterations, num_leaves=args.num_leaves,
        learning_rate=args.learning_rate, max_bin=args.max_bin,
        bagging_fraction=args.bagging_fraction,
        bagging_freq=args.bagging_freq,
        feature_fraction=args.feature_fraction, boosting=args.boosting,
        quantized_grad=args.quantized, early_stopping_round=args.esr,
        verbosity=0, checkpoint_dir=args.checkpoint_dir,
        checkpoint_chunk=args.checkpoint_chunk)
    name = "binary" if args.num_class <= 2 else "multiclass"
    objective = get_objective(name, num_class=args.num_class)
    val = {}
    if args.val_rows:
        from .classifier import LightGBMClassifier
        val = dict(val_bins=mapper.transform_packed(X[n:]),
                   val_labels=y[n:], val_metric=LightGBMClassifier(
                       objective=name)._val_metric())
    t0 = time.perf_counter()
    prep_s = t0 - t_prep
    booster = train(slots_b, [y[i] for i in idx],
                    [np.ones(len(i)) for i in idx], mapper, objective,
                    params, mesh=mesh, shard_rows=[len(i) for i in idx],
                    **val)
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    return booster, time.perf_counter() - t0, prep_s


def _write_atomic_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a per-thread temporary file and
    a rename, so that a reader never sees it torn (the watchdog's dump on
    a lost peer can race the main thread's)."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def run_worker(args) -> int:
    """One elastic controller: the rendezvous (retried, on the backend
    the ranks' devices call for), the watchdog, :func:`sharded_fit` over
    this process's shards with ``checkpoint_dir`` live, and the stats
    dump (the recovery counters, the watchdog's, the journal's tail, the
    backend, the fit's seconds, its gathers and its kernels' launches).  Process 0 writes
    the model text."""
    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist

    from ..ops import cuda_histogram as ch
    from ..ops.collectives import gang_stats
    from .engine import last_fit_info, train_stats
    cfg = ElasticConfig(
        heartbeat_dir=args.heartbeat_dir, process_id=args.process_id,
        num_processes=args.num_processes,
        heartbeat_interval_s=args.heartbeat_interval,
        straggler_age_s=args.straggler_age,
        lease_timeout_s=args.lease_timeout,
        init_retries=args.init_retries, init_backoff_s=args.init_backoff)
    # the process's index on its host: LOCAL_RANK where a launcher sets
    # it, else the process id (every controller on one host)
    device = _rank_device(args.device, int(os.environ.get(
        "LOCAL_RANK", args.process_id)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t_init = time.perf_counter()
    retry_used = initialize_with_retry(
        args.coordinator, args.num_processes, args.process_id,
        retries=cfg.init_retries, backoff_s=cfg.init_backoff_s,
        device=device)
    # seconds from the worker's entry: torch and the device, then the
    # rendezvous; the fit's own phases follow
    fit: Dict[str, object] = {"setup_s": t_init - t_start,
                              "rendezvous_s": time.perf_counter() - t_init}
    write_hook = None
    if args.chaos_heartbeat_stall:
        from ..io.chaos import ChaosHeartbeat
        after_s, stall_s = (float(x) for x
                            in args.chaos_heartbeat_stall.split(":"))
        write_hook = ChaosHeartbeat(after_s=after_s, stall_s=stall_s)
    wd_stats = StageStats()

    def dump_stats() -> None:
        if args.stats_out:
            _write_atomic_text(args.stats_out, json.dumps({
                "process_id": args.process_id,
                "rendezvous_retries": retry_used,
                "backend": dist.get_backend(), "device": str(device),
                "train": train_stats.snapshot(),
                "watchdog": wd_stats.snapshot(),
                # the journal's tail (fit span, boost_chunk, ckpt_* and
                # peer_* events), so the stats dump carries a trace
                # excerpt that tools/trace_report.py turns into a timeline
                "journal_tail": _tm.get_journal().tail(80), **fit},
                indent=1))

    def on_lost(pid, age):
        log.error("controller %d lease expired (%.2fs); abandoning with "
                  "RESTART_EXIT_CODE", pid, age)
        dump_stats()
        _tm.record_flight("peer_lost_abandon",
                          {"peer": pid, "age_s": round(age, 3),
                           "process_id": args.process_id})
        os._exit(RESTART_EXIT_CODE)

    wd = HeartbeatWatchdog(cfg, stats=wd_stats, on_peer_lost=on_lost,
                           write_hook=write_hook)
    wd.start()
    if args.chaos_kill_at_boundary > 0 and args.checkpoint_dir:
        from ..io.chaos import ChaosControllerKill
        ChaosControllerKill(args.checkpoint_dir,
                            args.chaos_kill_at_boundary).start()
    try:
        ch.histogram_cuda.launches = ch.histogram_cuda_fused.launches = 0
        for k in gang_stats:
            gang_stats[k] = type(gang_stats[k])(0)
        booster, fit_s, prep_s = sharded_fit(args, args.process_id, device)
        fit.update(prep_s=prep_s, fit_s=fit_s, gathers=dict(gang_stats),
                   launches={"hist_full": ch.histogram_cuda.launches,
                             "hist_segment":
                                 ch.histogram_cuda_fused.launches},
                   fit_info=dict(last_fit_info))
    finally:
        wd.stop()
    if args.process_id == 0 and args.out:
        _write_atomic_text(args.out, booster.save_native_model_string())
    dump_stats()
    dist.destroy_process_group()
    print("ELASTIC_OK", flush=True)
    return 0


def parse_args(argv=None):
    """:func:`main`'s arguments (the reference's, and the port's
    ``--device``, table and fit options)."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.gbdt.elastic",
        description="one controller of an elastic gang: a sharded fit "
                    "over torch.distributed")
    ap.add_argument("--coordinator", default="127.0.0.1:29500",
                    help="host:port of the rendezvous (process 0 binds it)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (the card of the process's local rank "
                         "modulo the host's cards) or cuda:N")
    ap.add_argument("--heartbeat-dir", default="")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--out", default="",
                    help="native model text written by process 0")
    ap.add_argument("--stats-out", default="",
                    help="recovery-counter JSON written on exit")
    ap.add_argument("--table", default="demo",
                    help="'demo' or module:function giving (X, y) from "
                         "(seed, rows, features, num_class)")
    ap.add_argument("--rows", type=int, default=600)
    ap.add_argument("--features", type=int, default=6)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--val-rows", type=int, default=0,
                    help="the table's last rows, held out for validation")
    ap.add_argument("--shards-per-process", type=int, default=1)
    ap.add_argument("--cuts", default="",
                    help="comma-separated rows at which the training rows "
                         "are cut into shards (default: equal parts)")
    ap.add_argument("--max-bin", type=int, default=31)
    ap.add_argument("--num-class", type=int, default=2)
    ap.add_argument("--iterations", type=int, default=24)
    ap.add_argument("--num-leaves", type=int, default=7)
    ap.add_argument("--learning-rate", type=float, default=0.1)
    ap.add_argument("--bagging-fraction", type=float, default=0.7)
    ap.add_argument("--bagging-freq", type=int, default=2)
    ap.add_argument("--feature-fraction", type=float, default=0.8)
    ap.add_argument("--boosting", default="gbdt")
    ap.add_argument("--quantized", default="off")
    ap.add_argument("--esr", type=int, default=0,
                    help="early-stopping rounds (with --val-rows)")
    ap.add_argument("--checkpoint-chunk", type=int, default=6)
    ap.add_argument("--heartbeat-interval", type=float, default=0.25)
    ap.add_argument("--straggler-age", type=float, default=1.0)
    ap.add_argument("--lease-timeout", type=float, default=5.0)
    ap.add_argument("--init-retries", type=int, default=4)
    ap.add_argument("--init-backoff", type=float, default=0.5)
    ap.add_argument("--chaos-heartbeat-stall", default="",
                    help="AFTER_S:STALL_S: one stall of this controller's "
                         "lease writes (io.chaos.ChaosHeartbeat)")
    ap.add_argument("--chaos-kill-at-boundary", type=int, default=0,
                    help="SIGKILL this controller once the checkpoint meta "
                         "reaches this boundary (io.chaos."
                         "ChaosControllerKill; 0 disables)")
    args = ap.parse_args(argv)
    if not args.heartbeat_dir:
        ap.error("--heartbeat-dir is required")
    return args


def main(argv=None) -> int:
    return run_worker(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
