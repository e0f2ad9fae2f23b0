"""The training chaos drill: faults injected into a real gang of two
controller processes (``python -m mmlspark_tpu_torch.gbdt.elastic``, a
sharded fit over ``torch.distributed``), each phase run under the gang
supervisor (:func:`..gbdt.elastic.supervise`).  The port's counterpart of
the reference's ``tools/chaos_training.py``, phases 0–3:

0. **baseline** — the uninterrupted gang fit, its checkpoint directory
   cleared at the end;
1. **kill** — controller 1 SIGKILLed the moment the first chunk boundary
   is durable (``io.chaos.ChaosControllerKill``); the survivor is torn
   down, the whole gang respawns on a fresh port and resumes from that
   boundary (``ckpt_resumed`` in each controller's stats);
2. **corrupt** — the same kill, then the snapshot meta bit-flipped before
   the respawn: the snapshot is discarded (``ckpt_discarded``) and the
   fit starts fresh;
3. **stall** — controller 1's lease writes stall once for longer than the
   straggler age and shorter than the lease: counted
   (``heartbeat_stalls``), no restart.

Every phase's model text must equal the baseline's byte for byte: a
recovery path writes the forest an uninterrupted fit writes.  The
reference's phase 4 (lease beacons over its transport) and its telemetry
section wait for the elastic transport (ROADMAP.md, Queue A item 11,
slice 11c).

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
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from ..gbdt.checkpoint import _CKPT_FILE
from ..gbdt.elastic import supervise
from ..io.chaos import corrupt_file

N_PROCESSES = 2


def spawn_worker(pid: int, port: int, workdir: str, phase: str,
                 attempt: int, ckpt: str, worker_args: Sequence[str],
                 stall: str = "", kill_at_boundary: int = 0,
                 env: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """Controller ``pid`` of a round: its heartbeat directory, model text
    and stats file under ``workdir`` by phase and round, its log in a
    file (an undrained pipe would wedge a worker with a long traceback),
    the stall and the kill armed on controller 1 only."""
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
              checkpoint: bool = True) -> dict:
    """One phase: gang rounds under :func:`supervise` until one finishes
    clean.  ``kill``: controller 1 dies once boundary ``checkpoint_chunk``
    is durable (round 0 only); ``corrupt``: the meta is corrupted in this
    mode before round 1; ``stall``: ``AFTER_S:STALL_S`` on controller 1;
    ``checkpoint=False``: no checkpoint directory.  Returns the model
    text, the restarts, every round's stats and exit codes, the tails of
    the logs of every round that failed, the events and the seconds."""
    ckpt = os.path.join(workdir, f"ckpt_{phase}")
    os.makedirs(ckpt, exist_ok=True)
    args = [*worker_args, "--checkpoint-chunk", str(checkpoint_chunk)]
    events: List[dict] = []
    procs_by_round: Dict[int, list] = {}

    def spawn_round(attempt, port):
        if corrupt and attempt == 1:
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
                              env)
                 for pid in range(N_PROCESSES)]
        procs_by_round[attempt] = procs
        return procs

    t0 = time.perf_counter()
    restarts = supervise(spawn_round, max_restarts=max_restarts,
                         round_timeout_s=phase_timeout, verbose=False)
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
          env: Optional[Dict[str, str]] = None) -> dict:
    """Phases 0–3 over ``worker_args`` (the controllers' fit options);
    ``base``: an uninterrupted phase's result to use as phase 0.  Returns
    every phase's result (model texts left out) and the verdicts."""
    kw = dict(checkpoint_chunk=checkpoint_chunk, max_restarts=max_restarts,
              phase_timeout=phase_timeout, env=env)
    if base is None:
        base = run_phase("baseline", workdir, worker_args, **kw)
    killp = run_phase("kill", workdir, worker_args, kill=True, **kw)
    corr = run_phase("corrupt", workdir, worker_args, kill=True,
                     corrupt="bitflip", **kw)
    stallp = run_phase("stall", workdir, worker_args, stall=stall, **kw)
    out = {name: {k: v for k, v in res.items() if k != "model"}
           for name, res in (("baseline", base), ("kill", killp),
                             ("corrupt", corr), ("stall", stallp))}
    out["verdicts"] = verdicts(base, killp, corr, stallp)
    return out


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
    ok = all(res["verdicts"].values())
    print(json.dumps({"workdir": workdir, "verdicts": res["verdicts"],
                      "pass": ok}, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
