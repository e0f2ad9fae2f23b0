"""The drift chaos drill: the streaming data-quality contract end to
end.  The port's copy of ``tools/chaos_drift.py``, on the device
``--device`` names (``cuda`` by default):

A. **clean_traffic** — on-distribution traffic through a real
   :class:`ScoringEngine` + :class:`DriftMonitor` raises NO drift
   alert, NO ``drift_onset`` journal event and NO drift-SLO breach:
   zero false alarms is as much the contract as detection.
B. **feature_shift** — a seeded :class:`ChaosDrift` shifts one feature
   column mid-traffic (upstream recalibration); the monitor flags the
   INJECTED feature within the drill's traffic window (detection
   latency recorded in rows), the ``feature_drift`` SLO burns to a
   breach, a ``drift_onset`` journal event + flight record land, and
   :mod:`.drift_report` names the injected feature as the top
   drifter off the monitor's merged counters.
C. **nan_storm** — the same feature goes 80% NaN mid-traffic (silent
   upstream null-out); detected through the null-rate delta / missing
   distribution slot with the same evidence chain.
D. **canary_drift_rollback** — a live :class:`RolloutController`
   canary soaks while the INPUT feed starts drifting; the
   ``canary_live_drift`` objective (attached drift monitor) trips the
   gate and the canary is auto-rolled-back — no human, no error burn,
   drift alone.

All injection is seeded (:class:`ChaosPlan`): same seed, same fault
schedule.  Each scenario embeds its verdicts, the drift report, the
SLO verdicts and a journal excerpt; scenario B additionally embeds the
monitor's raw merged counters so ``drift_report --artifact`` can
re-render the table from the written file alone.

Run: ``python -m mmlspark_tpu_torch.tools.chaos_drift --device cpu
[--out drift.json]``; it exits 0 when every verdict passes.
"""

import argparse
import json
import os
import queue
import time

from . import drift_report

SCHEMA = "mmlspark_tpu_torch.chaos_drift/v1"


def verdict(ledger, name, ok, detail=""):
    ledger.append({"name": name, "pass": bool(ok), "detail": detail})
    print(f"  [{'PASS' if ok else 'FAIL'}] {name}"
          + (f" — {detail}" if detail else ""))


def journal_excerpt(since_seq, keep=("drift_onset", "drift_recovered",
                                     "slo_burn", "slo_recovered",
                                     "rollout_rolled_back",
                                     "rollout_started"),
                    max_events=40):
    from ..core.telemetry import get_journal
    return [e for e in get_journal().events()
            if e["ev"] in keep and e["seq"] > since_seq][-max_events:]


def journal_seq():
    from ..core.telemetry import get_journal
    evs = get_journal().events()
    return evs[-1]["seq"] if evs else 0


class _QueueServer:
    """Minimal in-process exchange (the engine's documented queue
    contract): requests park on ``request_queue``, replies land in a
    dict — the drill drives the REAL engine hot path without sockets."""

    def __init__(self):
        self.request_queue = queue.Queue()
        self.replies = {}

    def reply(self, rid, body, status=200):
        self.replies[rid] = (body, status)


def build_model(seed, device="cuda"):
    """The drill's regressor (2,000 × 8 rows from ``seed``, 10
    iterations, 15 leaves), fitted on ``device``."""
    import numpy as np
    from ..gbdt import LightGBMRegressor
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2000, 8)).astype(np.float32)
    y = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
         - 0.3 * X[:, 3]).astype(np.float64)
    booster = LightGBMRegressor(
        numIterations=10, numLeaves=15, parallelism="serial",
        verbosity=0, device=device).fit(
            {"features": X, "label": y}).getModel()
    assert booster.reference_profile is not None, \
        "fit did not capture a reference profile"
    return X, y, booster


def fresh_monitor(profile):
    from ..core.drift import DriftConfig, DriftMonitor
    # duty=1.0: the drill wants every batch sketched (determinism);
    # production keeps the 2% duty gate — the perf sentinel A/Bs it
    return DriftMonitor(profile, DriftConfig(
        duty=1.0, eval_interval_s=0.02, min_rows=200))


def pump(server, engine_rows, X_rows, tag, binary=False):
    """Push rows as payloads, one request a row, and wait for every
    reply.  A payload is a JSON-style dict, or with ``binary`` the row's
    float32 ``(1, f)`` view (the binary wire's payload: no per-value
    Python objects)."""
    import numpy as np
    want = len(X_rows)
    if binary:
        X_rows = np.ascontiguousarray(X_rows, np.float32)
    for i, row in enumerate(X_rows):
        # rid unique across pumps (engine_rows is the running total)
        server.request_queue.put(
            (f"{tag}{engine_rows + i}",
             row[None, :] if binary
             else {"features": [float(v) for v in row]}))
    t0 = time.time()
    while len(server.replies) < engine_rows + want:
        if time.time() - t0 > 30:
            raise RuntimeError(
                f"pump timeout: {len(server.replies)} replies, want "
                f"{engine_rows + want}")
        time.sleep(0.005)
    return engine_rows + want


def slo_breach_probe(drift_mon, samples=10):
    """Deterministic burn-gate evaluation over a synthetic timeline:
    one private SLOMonitor over the stock drift objectives, reading a
    private registry that carries the live drift monitor's gauges,
    sampled at fixed fake timestamps.  Returns the
    feature/prediction-drift verdict dict."""
    from ..core.slo import SLOMonitor, default_objectives
    from ..core.telemetry import MetricsRegistry
    reg = MetricsRegistry()
    reg.register("drift", drift_mon)
    objs = [o for o in default_objectives()
            if o.name in ("feature_drift", "prediction_drift")]
    mon = SLOMonitor(objs, registry=reg,
                     fast_window_s=3.0, slow_window_s=6.0)
    for i in range(samples):
        mon.sample(now=float(i))
    return mon.evaluate()


def scenario_clean(art, X, booster, seed):
    print("== A. clean_traffic ==")
    import numpy as np
    from ..core.drift import set_drift_monitor
    from ..io.scoring import ColumnPlan, ScoringEngine
    ledger = []
    seq0 = journal_seq()
    rng = np.random.default_rng(seed + 1)
    server = _QueueServer()
    mon = fresh_monitor(booster.reference_profile)
    eng = ScoringEngine(server, predictor=booster.predictor(
        backend="auto"), plan=ColumnPlan("features", X.shape[1]),
        max_rows=64, latency_budget_ms=2.0, num_scorers=1,
        num_repliers=0, drift_monitor=mon).start()
    try:
        rows = 0
        for _ in range(8):
            batch = X[rng.integers(0, len(X), 200)]
            rows = pump(server, rows, batch, "c")
    finally:
        eng.stop()
        set_drift_monitor(None)
    report = mon.report()
    verdicts = slo_breach_probe(mon)
    evs = journal_excerpt(seq0, keep=("drift_onset",))
    verdict(ledger, "rows_sketched", report["rows_observed"] >= 1000,
            f"{report['rows_observed']} rows observed")
    verdict(ledger, "no_alert", not report["alerting"],
            f"alerting={report['alerting']}")
    verdict(ledger, "no_drift_onset_event", not evs,
            f"{len(evs)} drift_onset events")
    verdict(ledger, "no_slo_breach",
            not any(v["breach"] for v in verdicts.values()),
            json.dumps({k: v["breach"] for k, v in verdicts.items()}))
    art["scenarios"]["clean_traffic"] = {
        "verdicts": ledger,
        "drift_gauges": report["gauges"],
        "slo": {k: v["breach"] for k, v in verdicts.items()},
        "journal": journal_excerpt(seq0),
    }
    return ledger


def _run_injected(X, booster, seed, drift_kwargs, tag):
    """Shared B/C body: clean warmup, then injected traffic; returns
    (monitor, detection dict, ledger-ready evidence)."""
    import numpy as np
    from ..core.drift import set_drift_monitor
    from ..io.chaos import ChaosDrift, ChaosPlan
    from ..io.scoring import ColumnPlan, ScoringEngine
    rng = np.random.default_rng(seed + 2)
    plan = ChaosPlan(seed)
    drift = ChaosDrift(plan, after_rows=0, name=f"{tag}_inject",
                       **drift_kwargs)
    server = _QueueServer()
    mon = fresh_monitor(booster.reference_profile)
    eng = ScoringEngine(server, predictor=booster.predictor(
        backend="auto"), plan=ColumnPlan("features", X.shape[1]),
        max_rows=64, latency_budget_ms=2.0, num_scorers=1,
        num_repliers=0, drift_monitor=mon).start()
    detection_rows = None
    try:
        rows = 0
        # clean warmup: the live sketch must hold enough
        # on-distribution mass that detection is a real distribution
        # test, not an empty-sketch artifact
        for _ in range(5):
            batch = X[rng.integers(0, len(X), 200)]
            rows = pump(server, rows, batch, f"{tag}w")
        assert not mon.report()["alerting"], \
            "false alarm during warmup"
        injected = 0
        for i in range(40):
            batch = drift(X[rng.integers(0, len(X), 200)])
            rows = pump(server, rows, batch, f"{tag}i{i}_")
            injected += len(batch)
            if mon.report()["alerting"]:
                detection_rows = injected
                break
    finally:
        eng.stop()
        set_drift_monitor(None)
    return mon, drift, plan, detection_rows


def scenario_shift(art, X, booster, seed):
    print("== B. feature_shift ==")
    ledger = []
    seq0 = journal_seq()
    feat = 2
    mon, drift, plan, det = _run_injected(
        X, booster, seed, {"feature": feat, "shift": 3.0}, "s")
    report = mon.report()
    verdicts = slo_breach_probe(mon)
    evs = journal_excerpt(seq0, keep=("drift_onset",))
    counters = mon.snapshot()["counters"]
    rep = drift_report.build_report(booster.reference_profile,
                                    counters)
    text = drift_report.render_text(rep, top=5)
    print(text)
    verdict(ledger, "detected_in_window", det is not None,
            f"detection after {det} injected rows "
            f"({drift.rows_injected} injected total)")
    verdict(ledger, "injected_feature_flagged",
            f"f{feat}" in report["alerting"],
            f"alerting={report['alerting']}")
    verdict(ledger, "drift_onset_journaled",
            any(e.get("signal") == f"f{feat}" for e in evs),
            f"{len(evs)} drift_onset events")
    verdict(ledger, "feature_drift_slo_breach",
            verdicts["feature_drift"]["breach"],
            f"burn_fast={verdicts['feature_drift']['burn_rate_fast']}")
    verdict(ledger, "report_names_injected_top",
            rep["worst_feature"] == f"f{feat}",
            f"top drifter {rep['worst_feature']}")
    art["scenarios"]["feature_shift"] = {
        "verdicts": ledger,
        "injected_feature": f"f{feat}",
        "detection_rows": det,
        "injections": plan.counts(),
        "drift_gauges": report["gauges"],
        "drift_counters": counters,
        "report_text": text,
        "slo": {k: {kk: v[kk] for kk in
                    ("breach", "burn_rate_fast", "burn_rate_slow")}
                for k, v in verdicts.items()},
        "journal": journal_excerpt(seq0),
    }
    return ledger


def scenario_nan(art, X, booster, seed):
    print("== C. nan_storm ==")
    ledger = []
    seq0 = journal_seq()
    feat = 4
    mon, drift, plan, det = _run_injected(
        X, booster, seed, {"feature": feat, "nan_rate": 0.8}, "n")
    report = mon.report()
    sig = next(s for s in report["signals"]
               if s["signal"] == f"f{feat}")
    verdicts = slo_breach_probe(mon)
    evs = journal_excerpt(seq0, keep=("drift_onset",))
    verdict(ledger, "detected_in_window", det is not None,
            f"detection after {det} injected rows "
            f"({drift.nans_injected} NaNs injected)")
    verdict(ledger, "null_delta_flagged",
            sig["null_delta"] > mon.cfg.null_delta_threshold,
            f"null live={sig['null_rate_live']} vs "
            f"ref={sig['null_rate_ref']}")
    verdict(ledger, "drift_onset_journaled",
            any(e.get("signal") == f"f{feat}" for e in evs),
            f"{len(evs)} drift_onset events")
    verdict(ledger, "feature_drift_slo_breach",
            verdicts["feature_drift"]["breach"], "")
    art["scenarios"]["nan_storm"] = {
        "verdicts": ledger,
        "injected_feature": f"f{feat}",
        "detection_rows": det,
        "nans_injected": drift.nans_injected,
        "injections": plan.counts(),
        "drift_gauges": report["gauges"],
        "signal": sig,
        "slo": {k: v["breach"] for k, v in verdicts.items()},
        "journal": journal_excerpt(seq0),
    }
    return ledger


def scenario_canary(art, X, y, booster, seed, tmpdir, device="cuda"):
    print("== D. canary_drift_rollback ==")
    import numpy as np
    from ..core.drift import set_drift_monitor
    from ..gbdt import LightGBMRegressor
    from ..io.chaos import ChaosDrift, ChaosPlan
    from ..io.registry import ModelRegistry
    from ..io.rollout import RolloutConfig, RolloutController
    from ..io.scoring import ColumnPlan, ScoringEngine
    ledger = []
    seq0 = journal_seq()
    rng = np.random.default_rng(seed + 3)
    plan = ChaosPlan(seed)
    registry = ModelRegistry(os.path.join(tmpdir, "registry"))
    registry.publish(booster, activate=True)
    b2 = LightGBMRegressor(numIterations=14, numLeaves=15,
                           parallelism="serial", verbosity=0,
                           device=device).fit(
        {"features": X, "label": y}).getModel()
    v2 = registry.publish(b2)
    cfg = RolloutConfig(canary_fraction=0.3, soak_s=60.0,
                        min_canary_rows=100000,
                        canary_deadline_ms=None,
                        fast_window_s=1.0, slow_window_s=2.0,
                        live_drift_threshold=0.25)
    ctl = RolloutController(registry, backend="auto", config=cfg,
                            device=device)
    mon = fresh_monitor(booster.reference_profile)
    ctl.attach_drift(mon)
    server = _QueueServer()
    eng = ScoringEngine(server, predictor=ctl,
                        plan=ColumnPlan("features", X.shape[1]),
                        max_rows=64, latency_budget_ms=2.0,
                        num_scorers=1, num_repliers=0,
                        drift_monitor=mon).start()
    drift = ChaosDrift(plan, feature=1, shift=4.0, after_rows=0,
                       name="canary_inject")
    state = "soaking"
    clean_state = None
    try:
        rows = 0
        # clean soak first: the gate must hold a healthy canary
        ctl.start_canary(v2)
        for _ in range(6):
            batch = X[rng.integers(0, len(X), 150)]
            rows = pump(server, rows, batch, "dcl")
            clean_state = ctl.tick()
            time.sleep(0.15)
        held_clean = clean_state == "soaking"
        # then the feed starts drifting under the soaking canary
        for i in range(40):
            batch = drift(X[rng.integers(0, len(X), 150)])
            rows = pump(server, rows, batch, f"ddr{i}_")
            state = ctl.tick()
            time.sleep(0.1)
            if state == "rolled_back":
                break
    finally:
        eng.stop()
        set_drift_monitor(None)
    evs = journal_excerpt(seq0, keep=("rollout_rolled_back",))
    reason = evs[-1].get("reason", "") if evs else ""
    verdict(ledger, "clean_canary_held", held_clean,
            f"state after clean soak: {clean_state}")
    verdict(ledger, "auto_rolled_back", state == "rolled_back",
            f"final state {state}")
    verdict(ledger, "rolled_back_by_drift_objective",
            "canary_live_drift" in reason
            or "canary_prediction_drift" in reason,
            f"reason={reason!r}")
    verdict(ledger, "registry_marked_rolled_back",
            registry.entry(v2)["promoted_state"] == "rolled_back",
            registry.entry(v2)["promoted_state"])
    verdict(ledger, "baseline_still_active",
            registry.active_version() == 1,
            f"active={registry.active_version()}")
    art["scenarios"]["canary_drift_rollback"] = {
        "verdicts": ledger,
        "rollback_reason": reason,
        "drift_gauges": mon.report()["gauges"],
        "injections": plan.counts(),
        "journal": journal_excerpt(seq0),
    }
    return ledger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.tools.chaos_drift",
        description="clean traffic, a feature shift, a NaN storm and a "
                    "drifting canary through the drift monitor")
    ap.add_argument("--device", default="cuda",
                    help="where the models fit and score (cpu or cuda)")
    ap.add_argument("--out", default="", help="the result as JSON")
    ap.add_argument("--seed", type=int, default=15)
    args = ap.parse_args(argv)
    import tempfile

    from ..core.telemetry import host_info
    t0 = time.time()
    X, y, booster = build_model(args.seed, args.device)
    art = {"schema": SCHEMA, "seed": args.seed, "host": host_info(),
           "profile": json.loads(
               booster.reference_profile.to_json()),
           "scenarios": {}}
    ledgers = []
    with tempfile.TemporaryDirectory() as tmpdir:
        # drift onsets / rollbacks dump flight records — into the
        # drill's scratch dir, not the committed artifacts/ tree
        from ..core.telemetry import configure_flight_recorder
        configure_flight_recorder(directory=tmpdir)
        ledgers += scenario_clean(art, X, booster, args.seed)
        ledgers += scenario_shift(art, X, booster, args.seed)
        ledgers += scenario_nan(art, X, booster, args.seed)
        ledgers += scenario_canary(art, X, y, booster, args.seed,
                                   tmpdir, args.device)
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
