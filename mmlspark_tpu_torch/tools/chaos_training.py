"""The training chaos drill: faults injected into a real gang of two
controller processes (``python -m mmlspark_tpu_torch.gbdt.elastic``, a
sharded fit over ``torch.distributed``), each phase run under the gang
supervisor (:func:`..gbdt.elastic.supervise`).  The port's counterpart of
the reference's ``tools/chaos_training.py``:

0. **baseline** — the uninterrupted gang fit, its checkpoint directory
   cleared at the end;
1. **kill** — controller 1 SIGKILLed the moment the first chunk boundary
   is durable (``io.chaos.ChaosControllerKill``); the survivor is torn
   down, the whole gang respawns on a fresh port and resumes from that
   boundary (``ckpt_resumed`` in each controller's stats);
2. **corrupt** — the kill's durable snapshot (a copy taken before the
   kill phase's respawn) with its meta bit-flipped, under a fresh gang:
   the snapshot is discarded (``ckpt_discarded``) and the fit starts
   fresh;
3. **stall** — controller 1's lease writes stall once for longer than the
   straggler age and shorter than the lease: counted
   (``heartbeat_stalls``), no restart.  :func:`run_phase` with
   ``transport=True`` runs a phase's leases through a
   :class:`..gbdt.elastic.HeartbeatHub` in this process (the transport
   mode) in place of the lease files;
4. **transport heartbeats** (:func:`transport_heartbeat_drill`, in this
   process) — two watchdogs beacon through a hub while controller 0's
   link is cut twice and controller 1's beacons stall once: a link blip
   never fakes a dead peer, the stall is counted, and the transport's
   reconnect and resume counters move.  An SLO monitor samples the phase
   (``heartbeat_freshness``, ``transport_retransmit``).

Every gang phase's model text must equal the baseline's byte for byte: a
recovery path writes the forest an uninterrupted fit writes.  The result
carries a telemetry section (:func:`telemetry_block`): the kill phase's
controllers' counters as a Prometheus exposition and their merged
journal tails.

Run: ``python -m mmlspark_tpu_torch.tools.chaos_training --device cpu``
(~40 s on a CPU; any further arguments after ``--`` go to every
controller, e.g. ``-- --shards-per-process 2``); the verdicts print as
JSON, and it exits 0 when all hold.  The stall (``--heartbeat-stall
AFTER_S:STALL_S``) must fall inside the fit, so the fit must outlast
``AFTER_S`` plus the straggler age.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from ..gbdt.checkpoint import _CKPT_FILE
from ..gbdt.elastic import HeartbeatHub, supervise
from ..io.chaos import corrupt_file

N_PROCESSES = 2
#: the shared secret of the drill's heartbeat hubs
HUB_TOKEN = "hb-drill"


def spawn_worker(pid: int, port: int, workdir: str, phase: str,
                 attempt: int, ckpt: str, worker_args: Sequence[str],
                 stall: str = "", kill_at_boundary: int = 0,
                 env: Optional[Dict[str, str]] = None,
                 hub: str = "") -> subprocess.Popen:
    """Controller ``pid`` of a round: its heartbeat directory, model text
    and stats file under ``workdir`` by phase and round, its log in a
    file (an undrained pipe would wedge a worker with a long traceback),
    the stall and the kill armed on controller 1 only; ``hub``: the
    ``host:port`` of a :class:`..gbdt.elastic.HeartbeatHub` to beacon
    leases to in place of the lease files."""
    hb = os.path.join(workdir, f"hb_{phase}_{attempt}")
    os.makedirs(hb, exist_ok=True)
    cmd = [sys.executable, "-m", "mmlspark_tpu_torch.gbdt.elastic",
           "--coordinator", f"127.0.0.1:{port}",
           "--num-processes", str(N_PROCESSES), "--process-id", str(pid),
           "--heartbeat-dir", hb, "--checkpoint-dir", ckpt,
           "--out", os.path.join(workdir, f"model_{phase}.txt"),
           "--stats-out", os.path.join(
               workdir, f"stats_{phase}_{attempt}_p{pid}.json"),
           *worker_args]
    if stall and pid == 1:
        cmd += ["--chaos-heartbeat-stall", stall]
    if kill_at_boundary and pid == 1:
        cmd += ["--chaos-kill-at-boundary", str(kill_at_boundary)]
    if hub:
        cmd += ["--heartbeat-transport", hub, "--heartbeat-token", HUB_TOKEN]
    log_path = os.path.join(workdir, f"log_{phase}_{attempt}_p{pid}.txt")
    with open(log_path, "w") as log_fh:
        return subprocess.Popen(cmd, stdout=log_fh, stderr=subprocess.STDOUT,
                                env=env)


def read_stats(workdir: str, phase: str, attempt: int) -> Dict[str, dict]:
    """The round's stats dumps by process id (a killed controller has
    none)."""
    out = {}
    for pid in range(N_PROCESSES):
        path = os.path.join(workdir, f"stats_{phase}_{attempt}_p{pid}.json")
        if os.path.exists(path):
            with open(path) as fh:
                out[str(pid)] = json.load(fh)
    return out


def run_phase(phase: str, workdir: str, worker_args: Sequence[str], *,
              checkpoint_chunk: int, kill: bool = False, corrupt: str = "",
              stall: str = "", max_restarts: int = 3,
              phase_timeout: float = 300.0,
              env: Optional[Dict[str, str]] = None,
              checkpoint: bool = True, transport: bool = False,
              keep_snapshot: str = "", from_snapshot: str = "") -> dict:
    """One phase: gang rounds under :func:`supervise` until one finishes
    clean.  ``kill``: controller 1 dies once boundary ``checkpoint_chunk``
    is durable (round 0 only); ``keep_snapshot``: a directory the
    checkpoint is copied to before round 1; ``from_snapshot``: a copy of
    such a directory is the phase's checkpoint at the start; ``corrupt``:
    the meta is corrupted in this mode before round 1, or before round 0
    when the phase starts ``from_snapshot``; ``stall``: ``AFTER_S:STALL_S``
    on controller 1; ``checkpoint=False``: no checkpoint directory;
    ``transport``: the controllers beacon their leases through a
    heartbeat hub started here for the phase.  Returns the model text,
    the restarts, every round's stats and exit codes, the tails of the
    logs of every round that failed, the events and the seconds."""
    ckpt = os.path.join(workdir, f"ckpt_{phase}")
    os.makedirs(ckpt, exist_ok=True)
    if from_snapshot:
        shutil.copytree(from_snapshot, ckpt, dirs_exist_ok=True)
    args = [*worker_args, "--checkpoint-chunk", str(checkpoint_chunk)]
    events: List[dict] = []
    procs_by_round: Dict[int, list] = {}

    def spawn_round(attempt, port):
        if keep_snapshot and attempt == 1:
            shutil.copytree(ckpt, keep_snapshot, dirs_exist_ok=True)
        if corrupt and attempt == (0 if from_snapshot else 1):
            meta = os.path.join(ckpt, _CKPT_FILE)
            if os.path.exists(meta):
                corrupt_file(meta, mode=corrupt)
                events.append({"event": f"corrupted the meta ({corrupt})",
                               "round": attempt})
            else:
                events.append({"event": "no durable snapshot to corrupt",
                               "round": attempt})
        kb = checkpoint_chunk if kill and attempt == 0 else 0
        if kb:
            events.append({"event": "armed SIGKILL of controller 1 at "
                                    f"boundary {kb}", "round": attempt})
        procs = [spawn_worker(pid, port, workdir, phase, attempt,
                              ckpt if checkpoint else "", args, stall, kb,
                              env, hub.address if hub else "")
                 for pid in range(N_PROCESSES)]
        procs_by_round[attempt] = procs
        return procs

    t0 = time.perf_counter()
    hub = HeartbeatHub(token=HUB_TOKEN).start() if transport else None
    try:
        restarts = supervise(spawn_round, max_restarts=max_restarts,
                             round_timeout_s=phase_timeout, verbose=False)
    finally:
        if hub is not None:
            hub.stop()
    with open(os.path.join(workdir, f"model_{phase}.txt")) as fh:
        model = fh.read()
    failed_logs, port_taken = {}, 0
    for a, ps in procs_by_round.items():
        if any(p.returncode for p in ps):
            logs = {}
            for pid in range(N_PROCESSES):
                path = os.path.join(workdir,
                                    f"log_{phase}_{a}_p{pid}.txt")
                with open(path, errors="replace") as fh:
                    logs[str(pid)] = fh.read()
            failed_logs[str(a)] = {k: v[-2000:] for k, v in logs.items()}
            port_taken += any(_rendezvous_port_taken(v)
                              for v in logs.values())
    return {"model": model, "restarts": restarts,
            "port_taken_rounds": port_taken, "failed_logs": failed_logs,
            "seconds": time.perf_counter() - t0,
            "stats": {str(a): read_stats(workdir, phase, a)
                      for a in range(restarts + 1)},
            "exit_codes": {str(a): [p.returncode for p in ps]
                           for a, ps in procs_by_round.items()},
            "events": events, "ckpt_leftover": sorted(os.listdir(ckpt))}


def _rendezvous_port_taken(log: str) -> bool:
    """Whether a controller's log shows the rendezvous port taken between
    :func:`..gbdt.elastic.free_port` and the bind (a race of the host, not
    a fault of the gang: the supervisor's fresh-port round repairs it)."""
    return "EADDRINUSE" in log or "address already in use" in log.lower()


def _counter(stats_by_pid: dict, group: str, name: str) -> list:
    """Each controller's ``name`` counter in its ``group`` snapshot."""
    return [s.get(group, {}).get("counters", {}).get(name, 0)
            for _, s in sorted(stats_by_pid.items())]


def verdicts(base: dict, killp: dict, corr: dict, stallp: dict) -> dict:
    """The drill's verdicts over its four phases' results."""
    def last(res):
        return res["stats"][str(res["restarts"])]

    def restarts(res):
        # rounds lost to a taken rendezvous port are the host's, not
        # the fault's
        return res["restarts"] - res["port_taken_rounds"]

    kill_last, corr_last, stall_last = last(killp), last(corr), last(stallp)
    # the round the kill fired in: the survivor must not report success
    kill_round = next((c for c in killp["exit_codes"].values() if -9 in c),
                      [])
    return {
        "baseline_clean": restarts(base) == 0,
        "baseline_ckpt_cleared": base["ckpt_leftover"] == [],
        "kill_recovered_to_completion": restarts(killp) == 1,
        "kill_sigkill_observed": bool(kill_round),
        "kill_survivor_torn_down": bool(kill_round)
        and all(rc != 0 for rc in kill_round),
        "kill_resumed_in_every_controller":
            len(kill_last) == N_PROCESSES
            and all(c == 1 for c in _counter(kill_last, "train",
                                              "ckpt_resumed")),
        "kill_forest_bit_identical": killp["model"] == base["model"],
        "kill_ckpt_cleared": killp["ckpt_leftover"] == [],
        "corrupt_snapshot_discarded":
            sum(_counter(corr_last, "train", "ckpt_discarded")) >= 1,
        "corrupt_forest_bit_identical": corr["model"] == base["model"],
        "stall_completed_without_restart": restarts(stallp) == 0,
        "stall_ckpt_cleared": stallp["ckpt_leftover"] == [],
        "stall_straggler_counted":
            sum(_counter(stall_last, "watchdog", "heartbeat_stalls")) >= 1,
        "stall_no_false_peer_loss":
            sum(_counter(stall_last, "watchdog", "peer_lost")) == 0,
        "stall_forest_bit_identical": stallp["model"] == base["model"],
    }


def drill(workdir: str, worker_args: Sequence[str], *,
          checkpoint_chunk: int = 6, stall: str = "0.5:1.5",
          max_restarts: int = 3, phase_timeout: float = 300.0,
          base: Optional[dict] = None,
          env: Optional[Dict[str, str]] = None,
          stallp: Optional[dict] = None) -> dict:
    """Phases 0–3 over ``worker_args`` (the controllers' fit options);
    ``base``: an uninterrupted phase's result to use as phase 0;
    ``stallp``: an uninterrupted phase run under the stall to use as
    phase 3 (it may be ``base`` itself).  Returns every phase's result
    (model texts left out) and the verdicts."""
    kw = dict(checkpoint_chunk=checkpoint_chunk, max_restarts=max_restarts,
              phase_timeout=phase_timeout, env=env)
    if base is None:
        base = run_phase("baseline", workdir, worker_args, **kw)
    snapshot = os.path.join(workdir, "killed_snapshot")
    killp = run_phase("kill", workdir, worker_args, kill=True,
                      keep_snapshot=snapshot, **kw)
    corr = run_phase("corrupt", workdir, worker_args, corrupt="bitflip",
                     from_snapshot=snapshot, **kw)
    if stallp is None:
        stallp = run_phase("stall", workdir, worker_args, stall=stall, **kw)
    out = {name: {k: v for k, v in res.items() if k != "model"}
           for name, res in (("baseline", base), ("kill", killp),
                             ("corrupt", corr), ("stall", stallp))}
    out["verdicts"] = verdicts(base, killp, corr, stallp)
    return out


def telemetry_block(stats_by_pid: Dict[str, dict],
                    journal_tail: int = 60) -> dict:
    """The result's telemetry section: the controllers' dumped counters
    (``train`` and ``watchdog`` each, and summed over the gang) in the
    Prometheus exposition a ``/metrics`` scrape returns, and their
    journal tails merged into one ``(ts, seq)``-ordered excerpt — the
    recovery story (``ckpt_saved`` / ``ckpt_resumed``, ``peer_stalled``,
    fit spans) read from the telemetry."""
    from ..core.telemetry import merge_snapshots, render_prometheus
    snaps, journal = {}, []
    for pid in sorted(stats_by_pid):
        st = stats_by_pid[pid]
        for group in ("train", "watchdog"):
            if isinstance(st.get(group), dict):
                snaps[f"{group}_p{pid}"] = st[group]
        journal.extend(st.get("journal_tail") or [])
    for group in ("train", "watchdog"):
        members = [st[group] for st in stats_by_pid.values()
                   if isinstance(st.get(group), dict)]
        if members:
            snaps[f"{group}_gang"] = merge_snapshots(members)
    journal.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return {"metrics_exposition": render_prometheus(snaps),
            "journal_excerpt": journal[-journal_tail:]}


def transport_heartbeat_drill(seed: int = 17, runtime_s: float = 4.0):
    """Phase 4: two watchdogs beacon their leases through a
    :class:`..gbdt.elastic.HeartbeatHub` over resumable transport
    sessions, while controller 0's link is cut twice and controller 1's
    beacons stall once for 1 s (above the 0.5 s straggler age, below the
    3 s lease).  Returns ``(verdicts, detail)``: no peer lost (a session
    resume outruns the lease), the stall counted, and the transport's
    resumes moved."""
    from ..core.profiling import StageStats
    from ..gbdt.elastic import ElasticConfig, HeartbeatWatchdog
    from ..io import transport as tp
    from ..io.chaos import ChaosHeartbeat, ChaosPlan

    c0 = dict(tp.transport_stats.snapshot()["counters"])
    hub = HeartbeatHub(token=HUB_TOKEN).start()
    lost, watchdogs, stats = [], [], {}
    stall = ChaosHeartbeat(ChaosPlan(seed=seed), after_s=1.0, stall_s=1.0)
    try:
        for pid in range(N_PROCESSES):
            cfg = ElasticConfig(
                heartbeat_dir="", process_id=pid,
                num_processes=N_PROCESSES, heartbeat_interval_s=0.1,
                straggler_age_s=0.5, lease_timeout_s=3.0,
                transport_address=hub.address, transport_token=HUB_TOKEN)
            stats[pid] = StageStats()
            watchdogs.append(HeartbeatWatchdog(
                cfg, stats=stats[pid],
                on_peer_lost=lambda p, a: lost.append((p, round(a, 2))),
                write_hook=stall if pid == 1 else None).start())
        time.sleep(1.0)
        # cut controller 0's hub link twice; its session must resume
        # before any lease expires
        kills = 0
        for _ in range(2):
            sock = watchdogs[0]._client.session._sock
            if sock is not None:
                sock.close()
                kills += 1
            time.sleep(runtime_s / 2)
    finally:
        for wd in watchdogs:
            wd.stop()
        hub.stop()
    c1 = tp.transport_stats.snapshot()["counters"]
    delta = {k: c1[k] - c0.get(k, 0) for k in c1}
    snap = {pid: st.snapshot() for pid, st in stats.items()}
    stalls = sum(s["counters"].get("heartbeat_stalls", 0)
                 for s in snap.values())
    verdicts = {
        "transport_hb_no_false_peer_loss": not lost,
        "transport_hb_link_resumed":
            kills >= 1 and delta.get("resumes", 0) >= 1,
        "transport_hb_straggler_counted": stalls >= 1,
    }
    detail = {"link_kills": kills, "peer_lost": lost,
              "injected_stalls": stall.stalls,
              "watchdog_stats": {str(k): v for k, v in snap.items()},
              "counters_delta": delta}
    return verdicts, detail


def transport_phase() -> dict:
    """Phase 4 under an SLO monitor sampling every 0.25 s: its verdicts,
    and ``slo_evaluated`` (the heartbeat-freshness and
    transport-retransmit objectives got windowed burn numbers)."""
    from ..core.slo import SLOMonitor, set_monitor
    monitor = set_monitor(SLOMonitor(fast_window_s=2.0, slow_window_s=8.0))
    monitor.start(tick_s=0.25)
    try:
        verdicts, detail = transport_heartbeat_drill()
    finally:
        monitor.stop()
    report = monitor.report()
    objs = report["objectives"]
    verdicts["slo_evaluated"] = bool(objs) and all(
        objs.get(name, {}).get("burn_rate_slow") is not None
        for name in ("heartbeat_freshness", "transport_retransmit"))
    return {"verdicts": verdicts, "detail": detail,
            "slo": {k: report[k] for k in ("healthy", "breaching")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.tools.chaos_training",
        description="kill, corrupt and stall a two-controller gang fit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--out", default="", help="the result as JSON")
    ap.add_argument("--iterations", type=int, default=24)
    ap.add_argument("--rows", type=int, default=20_000,
                    help="the demo table's rows (the stall needs a fit "
                         "that outlasts it)")
    ap.add_argument("--checkpoint-chunk", type=int, default=6)
    ap.add_argument("--lease-timeout", type=float, default=4.0)
    ap.add_argument("--straggler-age", type=float, default=0.6)
    ap.add_argument("--heartbeat-stall", default="0.5:1.5",
                    help="AFTER_S:STALL_S, between the straggler age and "
                         "the lease")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--phase-timeout", type=float, default=300.0)
    ap.add_argument("worker_args", nargs="*",
                    help="further controller arguments (after --)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_training_")
    os.makedirs(workdir, exist_ok=True)
    worker_args = ["--device", args.device, "--iterations",
                   str(args.iterations), "--rows", str(args.rows),
                   "--lease-timeout",
                   str(args.lease_timeout), "--straggler-age",
                   str(args.straggler_age), *args.worker_args]
    res = drill(workdir, worker_args,
                checkpoint_chunk=args.checkpoint_chunk,
                stall=args.heartbeat_stall, max_restarts=args.max_restarts,
                phase_timeout=args.phase_timeout)
    res["transport_heartbeats"] = transport_phase()
    res["verdicts"].update(res["transport_heartbeats"]["verdicts"])
    res["telemetry"] = telemetry_block(
        res["kill"]["stats"][str(res["kill"]["restarts"])])
    ok = all(res["verdicts"].values())
    print(json.dumps({"workdir": workdir, "verdicts": res["verdicts"],
                      "pass": ok}, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
