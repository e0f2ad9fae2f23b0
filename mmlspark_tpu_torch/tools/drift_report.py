"""Drift report: the top-drifting features, live traffic against the
fit-time reference profile.  The port's copy of ``tools/drift_report.py``.

Inputs are the two artifacts the drift subsystem already produces:

* the **reference profile** JSON (``ModelRegistry.load_profile`` /
  ``booster.reference_profile.to_json()`` — the registry stores it as
  ``models/v*.profile.json``), and
* a **live counters** block — a ``DriftMonitor.snapshot()`` (or any
  cross-process MERGE of several workers' snapshots: the counters sum
  key-wise, so the report recomputes PSI/JS over the combined
  population, never an average of per-worker divergences), either as a
  raw ``{"counters": ...}`` dict or the bare counters mapping.

Or point it at a drift drill's result
(``--artifact drift.json --scenario feature_shift``, written by
``python -m mmlspark_tpu_torch.tools.chaos_drift --out drift.json``),
which embeds both.

Output: per-signal table sorted by PSI descending — PSI, JS, null
rates (reference vs live), out-of-training-range ratio, and the
reference-vs-live q10/q50/q90 quantiles that show *where* the
distribution moved.  ``--json`` emits the machine-readable report (the
``core.drift`` report schema) instead.

Run::

    python -m mmlspark_tpu_torch.tools.drift_report \
        --profile models/v000001.profile.json \
        --counters drift_counters.json [--top 10] [--json]
"""

import argparse
import json


def load_inputs(args):
    """Resolve (profile, counters) from the CLI's input modes."""
    from ..core.sketch import ReferenceProfile
    if args.artifact:
        with open(args.artifact) as fh:
            art = json.load(fh)
        scenarios = art.get("scenarios", {})
        if args.scenario:
            sc = scenarios.get(args.scenario)
            if sc is None:
                raise SystemExit(
                    f"artifact has no scenario {args.scenario!r}; "
                    f"have {sorted(scenarios)}")
        else:
            with_drift = [s for s in scenarios.values()
                          if "drift_counters" in s]
            if not with_drift:
                raise SystemExit("artifact embeds no drift counters")
            sc = with_drift[0]
        profile = ReferenceProfile.from_json(
            json.dumps(sc.get("profile") or art.get("profile")))
        return profile, sc["drift_counters"]
    if not (args.profile and args.counters):
        raise SystemExit("pass --profile + --counters, or --artifact")
    with open(args.profile) as fh:
        profile = ReferenceProfile.from_json(fh.read())
    with open(args.counters) as fh:
        counters = json.load(fh)
    if isinstance(counters, dict) and "counters" in counters:
        counters = counters["counters"]
    return profile, counters


def build_report(profile, counters):
    from ..core.drift import drift_report_from_counters
    return drift_report_from_counters(counters, profile)


def render_text(report, top: int = 10) -> str:
    sigs = sorted(report["signals"], key=lambda s: -s["psi"])
    lines = [
        f"rows observed: {report['rows_observed']}  "
        f"(skipped by duty gate: {report['rows_skipped']})",
        f"alerting: {', '.join(report['alerting']) or '(none)'}",
        "",
        f"{'signal':<16} {'psi':>8} {'js':>7} {'null ref':>9} "
        f"{'null live':>9} {'oor':>6}  "
        f"{'ref q10/q50/q90':>24}  {'live q10/q50/q90':>24}",
    ]
    for s in sigs[:top]:
        rq = "/".join(f"{v:.3g}" for v in s["quantiles_ref"])
        lq = "/".join(f"{v:.3g}" for v in s["quantiles_live"])
        flag = " <<< ALERT" if s["alert"] else ""
        lines.append(
            f"{s['signal']:<16} {s['psi']:>8.4f} {s['js']:>7.4f} "
            f"{s['null_rate_ref']:>9.4f} {s['null_rate_live']:>9.4f} "
            f"{s['oor_rate']:>6.3f}  {rq:>24}  {lq:>24}{flag}")
    if len(sigs) > top:
        lines.append(f"... {len(sigs) - top} more signals "
                     f"(raise --top)")
    worst = report.get("worst_feature")
    lines.append("")
    lines.append(f"top drifter: {worst or '(none)'}  "
                 f"(psi_worst={report['gauges']['psi_worst']}, "
                 f"prediction psi="
                 f"{report['gauges']['psi_prediction']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.tools.drift_report",
        description="Top-drifting features: live sketches vs the "
                    "fit-time reference profile")
    ap.add_argument("--profile", help="reference-profile JSON path")
    ap.add_argument("--counters",
                    help="DriftMonitor.snapshot() JSON (or merged "
                         "counters) path")
    ap.add_argument("--artifact",
                    help="chaos-drift drill artifact embedding "
                         "profile + counters")
    ap.add_argument("--scenario",
                    help="scenario name inside --artifact")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    args = ap.parse_args(argv)
    profile, counters = load_inputs(args)
    report = build_report(profile, counters)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(render_text(report, args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
