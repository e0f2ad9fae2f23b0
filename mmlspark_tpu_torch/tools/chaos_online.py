"""The online-learning chaos drill: the whole self-healing loop —
streaming ingest → drift-triggered incremental refresh → gated hot-swap —
on its worst day.  The port's copy of ``tools/chaos_online.py``: every
model loads, scores and fits on ``--device`` (``cuda`` by default), the
trainer processes too, and the trainers import the port alone.

A. **sigkill_mid_refresh** — a drifting feed (ramped
   :class:`ChaosDrift`) served through a real
   :class:`ScoringEngine` + :class:`RolloutController` is tapped into
   an :class:`IngestBuffer`; the SLO burn auto-triggers a refresh in a
   separate trainer process, which is SIGKILLed mid-boost; a fresh
   trainer resumes the SAME episode from the durable dataset +
   checkpoint, publishes the candidate, and the driver canaries and
   promotes it through the standard gate.
B. **canary_drift_rollback_converge** — the feed drifts again; the
   second refresh's canary is soaking when a NEW drift hits the live
   feed — the canary drift gate auto-rolls-back; the episode parks
   under cooldown; once the feed stabilises a third episode fits on
   the post-drift window, canaries clean, promotes, and a fresh
   monitor built from the new active profile shows the SLO burn is
   OUT — the loop converged, no human involved.
C. **serving_consistency** — every reply pumped during A and B is
   bit-exact against exactly one registry version live at that
   moment; zero wrong answers, zero dropped replies, while models
   hot-swap underneath.
D. **journal_chain** — ONE merged trace (driver mirror + both trainer
   mirrors) reconstructs the full chain across three pids:
   triggered → dataset → fit_begin → SIGKILL → recovered →
   candidate → canary → promoted → rolled_back → … → promoted.

All injection is seeded (:class:`ChaosPlan`).  Run:
``python -m mmlspark_tpu_torch.tools.chaos_online --device cpu
[--rows 1600 --features 6] [--out online.json]``; it exits 0 when every
verdict passes.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import chaos_drift
from .chaos_drift import (_QueueServer, fresh_monitor, journal_seq, pump,
                          slo_breach_probe, verdict)

SCHEMA = "mmlspark_tpu_torch.chaos_online/v1"
#: the root of the checkout that holds the port: the trainers import it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

KEEP = ("refresh_triggered", "refresh_dataset", "refresh_fit_begin",
        "refresh_retry", "refresh_recovered", "refresh_candidate",
        "refresh_canary", "refresh_canary_blocked", "refresh_promoted",
        "refresh_rolled_back", "refresh_gave_up", "rollout_started",
        "rollout_promoted", "rollout_rolled_back", "trainer_sigkill",
        "ingest_replay", "drift_onset")


def journal_excerpt(since_seq, max_events=60):
    return chaos_drift.journal_excerpt(since_seq, keep=KEEP,
                                       max_events=max_events)


def label_fn(X):
    # the drill's known ground truth — stands in for the label join a
    # real deployment does before appending to the buffer
    return (X[:, 0] + 0.5 * X[:, 1]).astype("float64")


def host_margins(booster, X):
    """``predict_margin`` of ``X`` on the booster's device, on the host as
    float32 (one device→host copy)."""
    return booster.predict_margin(X).cpu().numpy().astype(np.float32)


class Ctx:
    """Shared drill state: data, registry, rollout, ingest, ledger.
    ``rows`` × ``features`` on-distribution rows (``features`` ≥ 3: the
    drifts hit columns 0–2), every model loaded and fitted on
    ``device``."""

    def __init__(self, root, seed, device="cuda", rows=1600, features=6):
        from ..gbdt import fit_bin_mapper
        from ..gbdt.engine import TrainParams, train
        from ..gbdt.objectives import RegressionL2
        from ..io.chaos import ChaosPlan
        from ..io.ingest import IngestBuffer
        from ..io.registry import ModelRegistry
        from ..io.rollout import RolloutConfig, RolloutController
        if features < 3:
            raise ValueError("the drill drifts features 0-2: features >= 3")
        self.root = root
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.plan = ChaosPlan(seed)
        self.X = self.rng.normal(size=(rows, features)).astype(np.float32)
        y = label_fn(self.X)
        self.mapper = fit_bin_mapper(self.X, max_bin=63)
        self.base = train(
            self.mapper.transform_packed(self.X), y, None,
            self.mapper, RegressionL2(),
            TrainParams(num_iterations=10, num_leaves=15,
                        min_data_in_leaf=5, parallelism="serial",
                        verbosity=0), device=device)
        assert self.base.reference_profile is not None
        self.registry = ModelRegistry(os.path.join(root, "registry"))
        self.registry.publish(self.base, activate=True)
        # reservoir is SEASONING (~3% of the fit window): big enough
        # that a refresh never fully forgets the old regime, small
        # enough that the candidate's reference profile stays within
        # the canary drift gate's PSI budget against settled
        # post-drift traffic — oversize it and the loop can never
        # converge (every refreshed profile keeps old-regime mass the
        # live feed no longer has)
        self.ingest = IngestBuffer(
            os.path.join(root, "ingest"), self.mapper,
            window_rows=2000, reservoir_rows=64, segment_rows=256,
            seed=seed, register=False)
        self.rollout = RolloutController(
            self.registry, backend="auto",
            config=RolloutConfig(canary_fraction=0.5, soak_s=0.3,
                                 min_canary_rows=200,
                                 canary_deadline_ms=None,
                                 fast_window_s=1.0, slow_window_s=2.0,
                                 live_drift_threshold=0.25),
            device=device)
        self.led = {"total": 0, "wrong": 0, "dropped": 0,
                    "by_version": {}}
        self._boosters = {1: self.base}

    def tap(self, rows, margins):
        self.ingest.append(rows, label_fn(rows))

    def reopen_ingest(self):
        """Pick up whatever another process spilled — a fresh handle
        replays the durable segments (the kill-anywhere contract)."""
        from ..io.ingest import IngestBuffer
        self.ingest = IngestBuffer(os.path.join(self.root, "ingest"),
                                   register=False)

    def booster(self, v):
        if v not in self._boosters:
            self._boosters[v] = self.registry.load(v, device=self.device)
        return self._boosters[v]

    def steady(self, n, shifts):
        """Sample on-distribution rows, then apply the settled drift
        regime (feature → additive shift)."""
        batch = self.X[self.rng.integers(0, len(self.X), n)].copy()
        for f, s in shifts.items():
            batch[:, f] += s
        return batch


def make_engine(ctx, server, mon=None):
    from ..io.scoring import ColumnPlan, ScoringEngine
    return ScoringEngine(
        server, predictor=ctx.rollout,
        plan=ColumnPlan("features", ctx.X.shape[1]),
        max_rows=64, latency_budget_ms=5.0, num_scorers=1,
        num_repliers=0, drift_monitor=mon,
        ingest_tap=ctx.tap).start()


def serve_batch(ctx, server, served, batch, versions, tag,
                binary=False):
    """Pump one batch and classify every reply bit-exactly against the
    registry versions live at this instant (scenario C evidence): each
    version's ``predict_margin`` on its device.  ``binary``: the rows go
    as float32 row views (:func:`.chaos_drift.pump`)."""
    exp = {v: host_margins(ctx.booster(v), batch) for v in versions}
    served_new = pump(server, served, batch, tag, binary=binary)
    for i in range(len(batch)):
        val, status = server.replies[f"{tag}{served + i}"]
        ctx.led["total"] += 1
        if status != 200:
            ctx.led["dropped"] += 1
            continue
        v32 = np.float32(val)
        for v, w in exp.items():
            if v32 == w[i]:
                key = f"v{v}"
                ctx.led["by_version"][key] = \
                    ctx.led["by_version"].get(key, 0) + 1
                break
        else:
            ctx.led["wrong"] += 1
    return served_new


def make_slo(mon):
    """Private burn monitor over the live drift gauges (fake-clock
    sampled by the refresh controller's polls)."""
    from ..core.slo import SLOMonitor, default_objectives
    from ..core.telemetry import MetricsRegistry
    mon.flush()
    mon.evaluate(force=True)
    reg = MetricsRegistry()
    reg.register("drift", mon)
    objs = [o for o in default_objectives()
            if o.name in ("feature_drift", "prediction_drift")]
    return SLOMonitor(objs, registry=reg, fast_window_s=3.0,
                      slow_window_s=6.0)


#: the drill's refresh settings (the trainers' too, but the hysteresis)
REFRESH = dict(hysteresis_evals=2, cooldown_s=5.0, min_fit_rows=400,
               num_iterations=12, checkpoint_chunk=4)


def make_refresh(ctx, monitor, rollout=None):
    from ..io.refresh import RefreshConfig, RefreshController
    return RefreshController(
        os.path.join(ctx.root, "refresh"), registry=ctx.registry,
        rollout=rollout if rollout is not None else ctx.rollout,
        ingest=ctx.ingest, monitor=monitor,
        config=RefreshConfig(**REFRESH), register=False,
        device=ctx.device)


# the trainer process: the SAME durable dirs, its own burn monitor, the
# settings of ``trainer.json`` under the root (:func:`write_trainer_config`);
# in phase "kill" a fit callback SIGKILLs the process once the boost has
# reached ``kill_at`` iterations (the refresh analog of the rollout's
# ``canary_wrap`` seam).  It prints ``READY <wall clock>`` once torch and
# its device are up, and a JSON line of its fit at the end.
_TRAINER_SRC = """
import json, os, signal, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
root, phase = {root!r}, {phase!r}
with open(os.path.join(root, "trainer.json")) as fh:
    cfg = json.load(fh)
device = torch.device(cfg["device"])
if device.type == "cuda":
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
print("READY", time.time(), flush=True)
from mmlspark_tpu_torch.core.telemetry import (configure_flight_recorder,
                                               get_journal)
configure_flight_recorder(directory=root)
get_journal().configure(
    os.path.join(root, "journal_trainer_" + phase + ".jsonl"),
    max_bytes=8 << 20)
from mmlspark_tpu_torch.core.drift import DriftConfig, DriftMonitor
from mmlspark_tpu_torch.core.slo import SLOMonitor, default_objectives
from mmlspark_tpu_torch.core.telemetry import MetricsRegistry
from mmlspark_tpu_torch.gbdt.engine import TrainParams
from mmlspark_tpu_torch.gbdt.objectives import get_objective
from mmlspark_tpu_torch.io.ingest import IngestBuffer
from mmlspark_tpu_torch.io.refresh import RefreshConfig, RefreshController
from mmlspark_tpu_torch.io.registry import ModelRegistry
from mmlspark_tpu_torch.ops import cuda_histogram as ch
registry = ModelRegistry(os.path.join(root, "registry"))
ingest = IngestBuffer(os.path.join(root, "ingest"), register=False)
active = registry.load(device=device)
with np.load(os.path.join(root, "drifted.npz")) as d:
    Xd = d["X"]
mon = DriftMonitor(active.reference_profile,
                   DriftConfig(duty=1.0, eval_interval_s=0.02,
                               min_rows=200))
mon.observe(Xd, active.predict_margin(Xd).cpu().numpy())
mon.flush(); mon.evaluate(force=True)
reg = MetricsRegistry(); reg.register("drift", mon)
objs = [o for o in default_objectives()
        if o.name in ("feature_drift", "prediction_drift")]
slo = SLOMonitor(objs, registry=reg, fast_window_s=3.0,
                 slow_window_s=6.0)
refresh = RefreshController(
    os.path.join(root, "refresh"), registry=registry, rollout=None,
    ingest=ingest, monitor=slo,
    config=RefreshConfig(**dict(cfg["refresh"], hysteresis_evals=1)),
    objective=get_objective(cfg["objective"]),
    train_params=TrainParams(**cfg["train"]),
    register=False, device=device)
if phase == "kill":
    def killer(it, trees):
        if it >= cfg["kill_at"]:
            get_journal().emit("trainer_sigkill", it=int(it))
            os.kill(os.getpid(), signal.SIGKILL)
    refresh.fit_callbacks = [killer]
    for i in range(10):
        refresh.poll(now=float(i))
    print("UNREACHABLE"); sys.exit(3)
assert refresh.state == "fitting", refresh.state
ch.histogram_cuda.launches = ch.histogram_cuda_fused.launches = 0
out = None
for i in range(6):
    out = refresh.poll(now=20.0 + i)
    if out == "candidate":
        break
assert out == "candidate", out
fit = refresh.stats.snapshot()["stages"].get("fit", {{}})
print(json.dumps({{"candidate": refresh.candidate_version,
                  "fit_s": fit.get("total_s"),
                  "launches": {{"hist_full": ch.histogram_cuda.launches,
                               "hist_segment":
                                   ch.histogram_cuda_fused.launches}}}}),
      flush=True)
print("CANDIDATE", refresh.candidate_version)
"""


def write_trainer_config(root, *, device, objective="regression",
                         refresh=None, train=None, kill_at=6):
    """The trainers' settings under ``root``: their device, objective
    (a ``get_objective`` name), refresh settings (:data:`REFRESH` by
    default), fit parameters (``TrainParams`` fields; the refresh
    controller's defaults by default) and the iteration at which the
    "kill" trainer dies."""
    if train is None:
        train = dict(num_leaves=15, learning_rate=0.1, min_data_in_leaf=5,
                     parallelism="serial", verbosity=0)
    with open(os.path.join(root, "trainer.json"), "w") as fh:
        json.dump({"device": str(device), "objective": objective,
                   "refresh": dict(refresh or REFRESH), "train": train,
                   "kill_at": int(kill_at)}, fh)


def run_trainer(root, phase, timeout=300):
    """One trainer process over ``root`` (phase ``"kill"`` or
    ``"resume"``).  Returns ``(completed process, its JSON line or None,
    seconds from the launch until it was READY)``."""
    src = _TRAINER_SRC.format(repo=REPO, root=root, phase=phase)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", src],
                       capture_output=True, text=True, timeout=timeout)
    ready = info = None
    for line in r.stdout.splitlines():
        if line.startswith("READY "):
            ready = float(line.split()[1]) - t0
        elif line.startswith("{"):
            info = json.loads(line)
    return r, info, ready


D1 = {0: 3.0}                       # episode-1 drift, settled
D2 = {0: 3.0, 2: 2.5}               # + episode-2 drift, settled
D3 = {0: 3.0, 2: 2.5, 1: 4.0}       # + the mid-canary hit, settled


def scenario_sigkill_mid_refresh(art, ctx):
    print("== A. sigkill_mid_refresh ==")
    from ..io.chaos import ChaosDrift
    ledger = []
    seq0 = journal_seq()
    # 1. the feed starts drifting: ramped injector over live serving,
    #    every scored batch tapped into the ingest buffer
    drift = ChaosDrift(ctx.plan, feature=0, shift=3.0, after_rows=0,
                       ramp_rows=600, name="feed_drift_ep1")
    server = _QueueServer()
    eng = make_engine(ctx, server)
    served, drifted = 0, []
    try:
        for i in range(8):
            batch = drift(ctx.X[ctx.rng.integers(0, len(ctx.X), 200)])
            drifted.append(batch)
            served = serve_batch(ctx, server, served, batch, [1],
                                 f"a{i}_")
    finally:
        eng.stop()
    ctx.ingest.flush()
    rows_ingested = ctx.ingest.rows_durable
    # the trainer builds its burn monitor off the drifted tail
    np.savez(os.path.join(ctx.root, "drifted.npz"),
             X=np.concatenate(drifted)[-800:])
    # 2. trainer auto-triggers and is SIGKILLed mid-boost
    write_trainer_config(ctx.root, device=ctx.device)
    r1, _, start1 = run_trainer(ctx.root, "kill")
    verdict(ledger, "trainer_sigkilled_mid_fit", r1.returncode == -9,
            f"returncode={r1.returncode}")
    state_path = os.path.join(ctx.root, "refresh",
                              "refresh_state.json")
    with open(state_path) as fh:
        state = json.load(fh)
    ck = os.path.join(ctx.root, "refresh", "ckpt_0001",
                      "boost_checkpoint.npz")
    verdict(ledger, "durable_fitting_state",
            state["state"] == "fitting" and os.path.exists(ck),
            f"state={state['state']}, checkpoint={os.path.exists(ck)}")
    # 3. a fresh trainer resumes the SAME episode and publishes
    r2, info2, start2 = run_trainer(ctx.root, "resume")
    ok2 = r2.returncode == 0 and "CANDIDATE" in r2.stdout
    verdict(ledger, "resumed_fit_published_candidate", ok2,
            (r2.stdout.strip() or r2.stderr[-400:]))
    if not ok2:
        art["scenarios"]["sigkill_mid_refresh"] = {
            "verdicts": ledger, "stderr": r2.stderr[-2000:]}
        return ledger
    v2 = int(r2.stdout.split()[-1])
    ctx.registry.reload()           # see the trainer's publish
    meta = ctx.registry.entry(v2).get("meta") or {}
    verdict(ledger, "candidate_tagged_with_episode",
            meta.get("refresh_episode") == 1, json.dumps(meta))
    # 4. the driver adopts the durable state and runs the gate
    ctx.reopen_ingest()
    refresh = make_refresh(ctx, monitor=None)
    out = refresh.poll(now=50.0)
    verdict(ledger, "candidate_canaried", out == "canary",
            f"poll -> {out}")
    server2 = _QueueServer()
    eng2 = make_engine(ctx, server2)
    gate, served2 = "soaking", 0
    try:
        for i in range(40):
            batch = ctx.steady(200, D1)
            served2 = serve_batch(ctx, server2, served2, batch,
                                  [1, v2], f"ap{i}_")
            gate = ctx.rollout.tick()
            time.sleep(0.12)
            if gate == "promoted":
                break
    finally:
        eng2.stop()
    out2 = refresh.poll(now=60.0)
    verdict(ledger, "gate_promoted_refreshed_model",
            gate == "promoted" and out2 == "promoted",
            f"gate={gate}, refresh={out2}")
    verdict(ledger, "registry_active_is_refreshed",
            ctx.registry.active_version() == v2,
            f"active={ctx.registry.active_version()}")
    merged = ctx.booster(v2)
    verdict(ledger, "merged_forest_extended",
            len(merged.trees) == 10 + 12,
            f"{len(merged.trees)} trees (10 base + 12 refresh)")
    art["scenarios"]["sigkill_mid_refresh"] = {
        "verdicts": ledger,
        "rows_ingested_durable": rows_ingested,
        "refreshed_version": v2,
        "candidate_meta": meta,
        "trainer_start_s": [start1, start2],
        "resumed_fit": info2,
        "injections": ctx.plan.counts(),
        "journal": journal_excerpt(seq0),
    }
    return ledger


def scenario_rollback_converge(art, ctx):
    print("== B. canary_drift_rollback_converge ==")
    from ..io.chaos import ChaosDrift
    ledger = []
    seq0 = journal_seq()
    v_active = ctx.registry.active_version()
    # 1. the feed drifts AGAIN (ramped, a different feature); the burn
    #    vs the refreshed model's own profile triggers episode 2
    drift2 = ChaosDrift(ctx.plan, feature=2, shift=2.5, after_rows=0,
                        ramp_rows=400, name="feed_drift_ep2")
    mon2 = fresh_monitor(ctx.booster(v_active).reference_profile)
    server = _QueueServer()
    eng = make_engine(ctx, server, mon=mon2)
    served = 0
    try:
        # enough post-ramp traffic that the recency window is pure
        # settled-D2 by fit time (see the reservoir sizing note above)
        for i in range(12):
            batch = drift2(ctx.steady(200, D1))
            served = serve_batch(ctx, server, served, batch,
                                 [v_active], f"b{i}_")
    finally:
        eng.stop()
    refresh = make_refresh(ctx, monitor=make_slo(mon2))
    trace, t = [], 100.0
    while t < 120.0:
        out = refresh.poll(now=t)
        trace.append(out)
        t += 1.0
        if out in ("candidate", "gave_up"):
            break
    verdict(ledger, "second_episode_fit", out == "candidate",
            f"trace={trace}")
    if out != "candidate":
        art["scenarios"]["canary_drift_rollback_converge"] = {
            "verdicts": ledger, "trace": trace}
        return ledger
    v3 = refresh.candidate_version
    # 2. canary soaks with the drift gate armed off the CANDIDATE's
    #    fit-time profile (trained on the drifted window: the settled
    #    D2 feed looks clean to it).  The gate's monitor is fed the
    #    CANARY's view of the traffic — rows scored by the candidate —
    #    not the engine's mixed baseline/canary margin stream, which
    #    would read as prediction drift for any candidate that
    #    (correctly) predicts differently from the model it replaces.
    mon3 = fresh_monitor(ctx.booster(v3).reference_profile)
    ctx.rollout.attach_drift(mon3)

    def observe_as(mon, v, batch):
        mon.observe(batch, host_margins(ctx.booster(v), batch))

    # this phase exists to prove the gate ROLLS BACK a canary hit by
    # drift mid-soak, so the soak window must outlast the clean-soak
    # batches plus the drift's detection latency (production default is
    # 60 s; the drill's promote phases compress it to 0.3 s) — restored
    # before episode 3 canaries
    ctx.rollout.cfg.soak_s = 60.0
    out = refresh.poll(now=t)
    verdict(ledger, "second_candidate_canaried", out == "canary",
            f"poll -> {out}")
    server3 = _QueueServer()
    eng3 = make_engine(ctx, server3)
    drift3 = ChaosDrift(ctx.plan, feature=1, shift=4.0, after_rows=0,
                        name="mid_canary_hit")
    gate, served3, held_clean = "soaking", 0, None
    try:
        for i in range(4):          # clean soak: the gate must hold
            batch = ctx.steady(150, D2)
            served3 = serve_batch(ctx, server3, served3, batch,
                                  [v_active, v3], f"bc{i}_")
            observe_as(mon3, v3, batch)
            gate = ctx.rollout.tick()
            time.sleep(0.12)
        held_clean = gate == "soaking"
        for i in range(40):         # then the mid-canary drift hits
            batch = drift3(ctx.steady(150, D2))
            served3 = serve_batch(ctx, server3, served3, batch,
                                  [v_active, v3], f"bd{i}_")
            observe_as(mon3, v3, batch)
            gate = ctx.rollout.tick()
            time.sleep(0.1)
            if gate == "rolled_back":
                break
    finally:
        eng3.stop()
    verdict(ledger, "clean_canary_held", bool(held_clean),
            f"gate after clean soak: {'soaking' if held_clean else gate}")
    verdict(ledger, "mid_canary_drift_rolled_back",
            gate == "rolled_back", f"gate={gate}")
    t += 1.0
    out = refresh.poll(now=t)
    verdict(ledger, "episode_finished_rolled_back",
            out == "rolled_back"
            and ctx.registry.entry(v3)["promoted_state"]
            == "rolled_back"
            and ctx.registry.active_version() == v_active,
            f"poll={out}, v3={ctx.registry.entry(v3)['promoted_state']}"
            f", active={ctx.registry.active_version()}")
    t += 1.0
    verdict(ledger, "cooldown_enforced",
            refresh.poll(now=t) == "cooldown", "")
    # 3. the feed settles on the post-hit distribution; episode 3
    #    fits on it, canaries clean, promotes, and the burn goes out
    server4 = _QueueServer()
    mon2b = fresh_monitor(ctx.booster(v_active).reference_profile)
    eng4 = make_engine(ctx, server4, mon=mon2b)
    served4 = 0
    try:
        for i in range(11):
            batch = ctx.steady(200, D3)
            served4 = serve_batch(ctx, server4, served4, batch,
                                  [v_active], f"bs{i}_")
    finally:
        eng4.stop()
    refresh3 = make_refresh(ctx, monitor=make_slo(mon2b))
    t += 10.0                       # past the episode-2 cooldown
    trace3 = []
    while t < 160.0:
        out = refresh3.poll(now=t)
        trace3.append(out)
        t += 1.0
        if out in ("candidate", "gave_up"):
            break
    verdict(ledger, "third_episode_fit", out == "candidate",
            f"trace={trace3}")
    if out != "candidate":
        art["scenarios"]["canary_drift_rollback_converge"] = {
            "verdicts": ledger, "trace": trace, "trace3": trace3}
        return ledger
    v4 = refresh3.candidate_version
    mon4 = fresh_monitor(ctx.booster(v4).reference_profile)
    ctx.rollout.attach_drift(mon4)
    ctx.rollout.cfg.soak_s = 0.3    # promote phase: short soak again
    out = refresh3.poll(now=t)
    server5 = _QueueServer()
    eng5 = make_engine(ctx, server5)
    gate, served5 = "soaking", 0
    try:
        for i in range(40):
            batch = ctx.steady(200, D3)
            served5 = serve_batch(ctx, server5, served5, batch,
                                  [v_active, v4], f"bp{i}_")
            observe_as(mon4, v4, batch)
            gate = ctx.rollout.tick()
            time.sleep(0.12)
            if gate == "promoted":
                break
    finally:
        eng5.stop()
    t += 1.0
    out = refresh3.poll(now=t)
    verdict(ledger, "second_refresh_promoted",
            gate == "promoted" and out == "promoted"
            and ctx.registry.active_version() == v4,
            f"gate={gate}, refresh={out}, "
            f"active={ctx.registry.active_version()}")
    # the convergence check: a FRESH monitor off the new active
    # profile sees the live feed as in-distribution — no burn left
    mon_check = fresh_monitor(ctx.booster(v4).reference_profile)
    batch = ctx.steady(800, D3)
    mon_check.observe(batch, host_margins(ctx.booster(v4), batch))
    mon_check.flush()
    verdicts = slo_breach_probe(mon_check)
    verdict(ledger, "converged_slo_clean",
            not any(v["breach"] for v in verdicts.values())
            and not mon_check.report()["alerting"],
            json.dumps({k: v["breach"] for k, v in verdicts.items()}))
    art["scenarios"]["canary_drift_rollback_converge"] = {
        "verdicts": ledger,
        "rolled_back_version": v3,
        "converged_version": v4,
        "trace_episode2": trace,
        "trace_episode3": trace3,
        "final_slo": {k: v["breach"] for k, v in verdicts.items()},
        "final_drift_gauges": mon_check.report()["gauges"],
        "journal": journal_excerpt(seq0),
    }
    return ledger


def scenario_serving_consistency(art, ctx):
    print("== C. serving_consistency ==")
    ledger = []
    led = ctx.led
    verdict(ledger, "replies_observed", led["total"] >= 4000,
            f"{led['total']} replies across the drill")
    verdict(ledger, "zero_dropped", led["dropped"] == 0,
            f"dropped={led['dropped']}")
    verdict(ledger, "all_bit_exact_one_version", led["wrong"] == 0,
            f"wrong={led['wrong']}, by_version={led['by_version']}")
    verdict(ledger, "served_from_multiple_versions",
            len(led["by_version"]) >= 3,
            f"versions seen: {sorted(led['by_version'])}")
    art["scenarios"]["serving_consistency"] = {
        "verdicts": ledger, "replies": dict(led)}
    return ledger


def scenario_journal_chain(art, ctx):
    print("== D. journal_chain ==")
    from ..core.telemetry import read_journal
    ledger = []
    evs = []
    for path in sorted(glob.glob(
            os.path.join(ctx.root, "journal_*.jsonl"))):
        evs += read_journal(path)
    evs = [e for e in evs if e["ev"] in KEEP]
    evs.sort(key=lambda e: (e["ts"], e["seq"]))

    def first(ev, episode=None):
        for i, e in enumerate(evs):
            if e["ev"] == ev and (episode is None
                                  or e.get("episode") == episode):
                return i, e
        return None, None

    chain1 = ["refresh_triggered", "refresh_dataset",
              "refresh_fit_begin", "trainer_sigkill",
              "refresh_recovered", "refresh_candidate",
              "refresh_canary", "refresh_promoted"]
    idx = [first(ev, None if ev == "trainer_sigkill" else 1)[0]
           for ev in chain1]
    ok1 = all(i is not None for i in idx) and idx == sorted(idx)
    verdict(ledger, "episode1_chain_ordered", ok1,
            " -> ".join(f"{ev}@{i}" for ev, i in zip(chain1, idx)))
    i_fit, e_fit = first("refresh_fit_begin", 1)
    i_rec, e_rec = first("refresh_recovered", 1)
    verdict(ledger, "recovery_crossed_processes",
            e_fit and e_rec and e_fit["pid"] != e_rec["pid"],
            f"fit pid={e_fit and e_fit['pid']}, "
            f"recover pid={e_rec and e_rec['pid']}")
    i_rb, _ = first("refresh_rolled_back", 2)
    verdict(ledger, "episode2_rolled_back_in_trace", i_rb is not None,
            f"idx={i_rb}")
    i_p3, _ = first("refresh_promoted", 3)
    verdict(ledger, "episode3_promoted_in_trace",
            i_p3 is not None and (i_rb is None or i_rb < i_p3),
            f"idx={i_p3}")
    pids = {e["pid"] for e in evs}
    verdict(ledger, "trace_spans_processes", len(pids) >= 3,
            f"{len(pids)} pids in the merged trace")
    art["scenarios"]["journal_chain"] = {
        "verdicts": ledger,
        "events": [{k: e.get(k) for k in
                    ("ts", "pid", "ev", "episode", "state", "version")}
                   for e in evs],
    }
    return ledger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.tools.chaos_online",
        description="the online-learning loop under a SIGKILLed refresh, "
                    "a drifting canary and hot swaps")
    ap.add_argument("--device", default="cuda",
                    help="where the models load, score and fit (the "
                         "trainer processes too): cpu or cuda")
    ap.add_argument("--rows", type=int, default=1600,
                    help="the on-distribution rows the base model fits "
                         "and the traffic samples")
    ap.add_argument("--features", type=int, default=6,
                    help="their features (at least 3)")
    ap.add_argument("--out", default="", help="the result as JSON")
    ap.add_argument("--seed", type=int, default=18)
    args = ap.parse_args(argv)
    import tempfile

    from ..core.drift import set_drift_monitor
    from ..core.telemetry import (configure_flight_recorder,
                                  get_journal, host_info)
    t0 = time.time()
    art = {"schema": SCHEMA, "seed": args.seed, "host": host_info(),
           "device": args.device, "rows": args.rows,
           "features": args.features, "scenarios": {}}
    ledgers = []
    with tempfile.TemporaryDirectory() as root:
        configure_flight_recorder(directory=root)
        get_journal().configure(
            os.path.join(root, "journal_driver.jsonl"),
            max_bytes=8 << 20)
        ctx = Ctx(root, args.seed, args.device, args.rows, args.features)
        try:
            ledgers += scenario_sigkill_mid_refresh(art, ctx)
            ledgers += scenario_rollback_converge(art, ctx)
            ledgers += scenario_serving_consistency(art, ctx)
            ledgers += scenario_journal_chain(art, ctx)
        finally:
            ctx.rollout.stop()
            set_drift_monitor(None)
            get_journal().configure(None)
    art["verdicts_total"] = len(ledgers)
    art["verdicts_pass"] = sum(1 for v in ledgers if v["pass"])
    art["healthy"] = art["verdicts_pass"] == art["verdicts_total"]
    art["wall_s"] = round(time.time() - t0, 1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(art, fh, indent=1)
    print(f"\n{art['verdicts_pass']}/{art['verdicts_total']} verdicts "
          f"pass in {art['wall_s']}s")
    return 0 if art["healthy"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
