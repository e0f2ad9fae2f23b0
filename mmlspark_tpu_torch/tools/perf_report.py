"""Performance attribution report: merge journals and profile
snapshots into a per-request / per-fit cost breakdown.

The port's copy of the reference's ``tools/perf_report.py``.  It reads
journals through the port's :mod:`.trace_report` (so it runs on a card
host without jax) and the port's profiler snapshot, whose compile ledger
is the kernel build ledger (``build_events``: ``nvcc_build``,
``cuda_load``, ``native_build``, ``native_load``) where the reference's
is ``jax_events``; a reference snapshot's ``jax_events`` are read alike.

Inputs (any combination):

* an **artifact** with a telemetry block (the reference's
  ``tools/bench_serving.py --out``, or one assembled from the port's
  profiler snapshot and registry render, as ``chip_smoke.py`` does): its
  ``telemetry.profile`` block (the continuous profiler's snapshot) and
  ``telemetry.metrics_exposition`` (the scoring/transport stage
  histograms) feed the phase attribution and the compile ledger;
* **journal JSONL files** (``--journal``, repeatable — the coordinator's
  plus each worker's ``MMLSPARK_TPU_JOURNAL_DIR`` mirror): per-request
  and per-fit timelines gain a per-hop cost column;
* a **timeline JSON** produced by ``tools/trace_report.py --format
  json`` (``--timeline`` — the stable
  ``mmlspark_tpu.trace_timeline/v1`` schema).

Outputs:

* **phase attribution** — top-N phases by total seconds, each with its
  share of the end-to-end wall time (``scoring.e2e``), and the
  ``attributed_fraction``: how much of e2e the NAMED phases
  (form/decode/score/reply/queue-wait plus the transport codec/wire
  phases) explain.  The acceptance bar is >= 0.9 on a bench_serving
  run — below that, something unattributed is eating the hot path and
  the report says so instead of hiding it.
* **compile ledger** — per-site hit vs miss dispatch counts (from the
  profiler's compile-seq bracketing: a miss built or loaded a kernel)
  and the cumulative build seconds, separated by event.
* **per-request / per-fit cost tables** — the journal's ``dur_ms``
  fields and profile spans rolled up per event kind.
* ``--flamegraph out.txt`` — the sampler's collapsed stacks, ready for
  ``flamegraph.pl`` / speedscope.

CLI::

    python -m mmlspark_tpu_torch.tools.perf_report ARTIFACT.json \
        [--journal j.jsonl ...] [--timeline t.json] [--top 15] \
        [--flamegraph stacks.txt] [--format text|json]
"""

import argparse
import json
import re
import sys
from typing import Dict, List, Optional

from .trace_report import load_events

#: phases that ARE the end-to-end measurement (denominators, never
#: counted as attribution — they contain the others).  ORDERED: the
#: first one present wins — when a fleet serves as an engine's
#: predictor its fleet.request windows sit INSIDE scoring.e2e, so
#: summing both would double-count the denominator
E2E_PHASES = ("scoring.e2e", "fleet.request")

#: the serving pipeline's named phases — the attribution numerator.
#: These are pairwise NON-overlapping segments of the engine's
#: end-to-end path, so their sum never double-counts: scoring.score
#: CONTAINS scoring.dispatch_host/device_wait, and the transport
#: encode/wire phases run INSIDE scoring.reply on the exchange
#: topology — those are reported as detail rows, not summed again.
ATTRIBUTED_PHASES = (
    "scoring.form", "scoring.decode", "scoring.score", "scoring.reply",
    "scoring.queue_wait", "scoring.trace",
)

#: named detail phases that overlap the attributed ones (shown with
#: their own share, excluded from the fraction)
DETAIL_PHASES = (
    "scoring.dispatch_host", "scoring.device_wait",
    "transport.encode_json", "transport.decode_json",
    "transport.encode_binary", "transport.decode_binary",
    "transport.wire_write", "fleet.fanout", "fleet.wait",
    "fleet.reduce",
)

_STAGE_RE = re.compile(
    r'^mmlspark_tpu_stage_latency_seconds_(sum|count)'
    r'\{ns="([^"]+)",stage="([^"]+)"\} ([0-9.eE+-]+|NaN)$')
_PROFILE_RE = re.compile(
    r'^mmlspark_tpu_profile_phase_seconds_(sum|count)'
    r'\{phase="([^"]+)"\} ([0-9.eE+-]+|NaN)$')


def parse_stage_totals(exposition: str) -> Dict[str, dict]:
    """Pull per-stage ``{name: {"total_s", "count"}}`` out of a
    Prometheus exposition — both the namespaced
    ``stage_latency_seconds`` family (keys ``<ns>.<stage>``) and the
    profiler's ``profile_phase_seconds`` family (keys as-is)."""
    out: Dict[str, dict] = {}

    def slot(key):
        return out.setdefault(key, {"total_s": 0.0, "count": 0})

    for line in exposition.splitlines():
        m = _STAGE_RE.match(line)
        if m:
            kind, ns, stage, val = m.groups()
            ent = slot(f"{ns}.{stage}")
        else:
            m = _PROFILE_RE.match(line)
            if not m:
                continue
            kind, stage, val = m.groups()
            ent = slot(stage)
        try:
            v = float(val)
        except ValueError:
            continue
        if kind == "sum":
            ent["total_s"] += v
        else:
            ent["count"] += int(v)
    return out


def phases_from_profile(profile: dict) -> Dict[str, dict]:
    """``{phase: {"total_s", "count", "p50_ms", "p99_ms"}}`` from a
    profiler snapshot's ``phases`` StageStats block."""
    out: Dict[str, dict] = {}
    for name, s in ((profile or {}).get("phases") or {}).get(
            "stages", {}).items():
        if isinstance(s, dict):
            out[name] = {"total_s": float(s.get("total_s", 0.0)),
                         "count": int(s.get("count", 0)),
                         "p50_ms": s.get("p50_ms"),
                         "p99_ms": s.get("p99_ms")}
    return out


def merge_phase_tables(*tables) -> Dict[str, dict]:
    """Sum ``total_s``/``count`` per phase across sources (multiple
    processes' snapshots merge exactly — log-bucket counts are
    additive, and totals/counts certainly are)."""
    out: Dict[str, dict] = {}
    for table in tables:
        for name, ent in (table or {}).items():
            agg = out.setdefault(name, {"total_s": 0.0, "count": 0})
            agg["total_s"] += float(ent.get("total_s", 0.0))
            agg["count"] += int(ent.get("count", 0))
            for k in ("p50_ms", "p99_ms"):
                if ent.get(k) is not None:
                    agg[k] = max(agg.get(k) or 0.0, ent[k])
    return out


def attribution(phases: Dict[str, dict],
                top: int = 15) -> dict:
    """The cost-attribution verdict over a merged phase table."""
    e2e = 0.0
    for name in E2E_PHASES:
        e2e = float(phases.get(name, {}).get("total_s", 0.0))
        if e2e > 0:
            break
    named = {n: phases[n] for n in ATTRIBUTED_PHASES if n in phases}
    named_s = sum(v["total_s"] for v in named.values())
    rows = []
    for name, ent in sorted(phases.items(),
                            key=lambda kv: -kv[1]["total_s"]):
        if name in E2E_PHASES:
            continue
        rows.append({
            "phase": name,
            "total_s": round(ent["total_s"], 6),
            "count": ent["count"],
            "share_of_e2e": (round(ent["total_s"] / e2e, 4)
                             if e2e > 0 else None),
            "attributed": name in ATTRIBUTED_PHASES,
        })
    return {
        "e2e_s": round(e2e, 6),
        "named_s": round(named_s, 6),
        "attributed_fraction": (round(named_s / e2e, 4)
                                if e2e > 0 else None),
        "top_phases": rows[:top],
    }


#: build-ledger events that are a compilation (the rest are loads)
BUILD_COMPILE_EVENTS = ("nvcc_build", "native_build")


def compile_ledger(profile: dict) -> dict:
    """Hit vs miss dispatches per site plus the cumulative build-time
    bill from the kernel build ledger (a reference snapshot's
    jax.monitoring events are read alike)."""
    profile = profile or {}
    dispatch = profile.get("dispatch") or {}
    build_events = (profile.get("build_events")
                    or profile.get("jax_events") or {})
    compile_s = sum(v.get("total_s", 0.0)
                    for k, v in build_events.items() if "compile" in k
                    or k in BUILD_COMPILE_EVENTS
                    or k in ("jaxpr_trace", "jaxpr_to_mlir_module"))
    return {
        "sites": {
            site: {
                "hits": int(v.get("hits", 0)),
                "misses": int(v.get("misses", 0)),
                "hit_ratio": (round(v.get("hits", 0)
                                    / max(1, v.get("hits", 0)
                                          + v.get("misses", 0)), 4)),
            } for site, v in sorted(dispatch.items())},
        "build_events": build_events,
        "compile_seconds_total": round(compile_s, 6),
        "backend_compiles": int(sum(
            (build_events.get(k) or {}).get("count", 0)
            for k in BUILD_COMPILE_EVENTS + ("backend_compile",))),
    }


def journal_costs(events: List[dict]) -> dict:
    """Per-event-kind duration rollup over merged journals: the
    per-hop cost column for the timelines (``dur_ms`` fields of
    form/decode/score/reply/hop events and ``profile_span``s)."""
    agg: Dict[str, dict] = {}
    for e in events:
        ev = e.get("ev", "?")
        if ev == "profile_span":
            ev = f"profile_span:{e.get('phase', '?')}"
        dur = e.get("dur_ms")
        ent = agg.setdefault(ev, {"count": 0, "total_ms": 0.0,
                                  "with_dur": 0})
        ent["count"] += 1
        if isinstance(dur, (int, float)):
            ent["with_dur"] += 1
            ent["total_ms"] += float(dur)
    for ent in agg.values():
        ent["total_ms"] = round(ent["total_ms"], 3)
        ent["mean_ms"] = (round(ent["total_ms"] / ent["with_dur"], 3)
                          if ent["with_dur"] else None)
    return agg


def request_cost_breakdown(timeline: dict) -> Optional[dict]:
    """Per-hop cost table for one request timeline (the ``request``
    block of a ``trace_timeline/v1`` document)."""
    if not timeline:
        return None
    rows = []
    for e in timeline.get("events", []):
        if isinstance(e.get("dur_ms"), (int, float)) \
                or e.get("ev") in ("hop_enqueue", "hop_send",
                                   "hop_ack", "hop_deliver"):
            rows.append({"ev": e.get("ev"), "pid": e.get("pid"),
                         "ts": e.get("ts"),
                         "dur_ms": e.get("dur_ms"),
                         "offset_ms": e.get("offset_ms")})
    attributed_ms = sum(r["dur_ms"] for r in rows
                        if isinstance(r.get("dur_ms"), (int, float)))
    return {"trace_id": timeline.get("trace_id"),
            "rid": timeline.get("rid"),
            "complete": timeline.get("complete"),
            "cross_process": timeline.get("cross_process"),
            "hops": rows,
            "attributed_ms": round(attributed_ms, 3)}


def build_report(artifact: Optional[dict] = None,
                 journals: Optional[List[str]] = None,
                 timeline_doc: Optional[dict] = None,
                 top: int = 15) -> dict:
    """Assemble the full report dict (the ``--format json`` body)."""
    profile = None
    exposition = ""
    if artifact:
        tel = artifact.get("telemetry") or {}
        profile = tel.get("profile")
        exposition = tel.get("metrics_exposition") or ""
    tables = [phases_from_profile(profile)]
    if exposition:
        # the exposition's scoring/transport stage histograms cover
        # processes whose profiler view we don't hold (old artifacts,
        # remote workers) — ONLY used when the profile block lacks the
        # phase (no double counting).  The few ns.stage names that
        # differ from their profile-phase aliases are remapped FIRST,
        # so they dedup against the profile block instead of leaking
        # through as duplicate rows
        remap = {"scoring.batch_form": "scoring.form",
                 "fleet.fleet_rtt": "fleet.request"}
        expo = {remap.get(k, k): v
                for k, v in parse_stage_totals(exposition).items()}
        have = set(tables[0])
        tables.append({k: v for k, v in expo.items() if k not in have
                       and k.startswith(("scoring.", "transport.",
                                         "fleet."))})
    phases = merge_phase_tables(*tables)
    events: List[dict] = []
    if journals:
        events = load_events(journals)
    report = {
        "schema": "mmlspark_tpu_torch.perf_report/v1",
        "attribution": attribution(phases, top=top),
        "compile_ledger": compile_ledger(profile),
        "journal_costs": journal_costs(events) if events else None,
        "request_breakdown": request_cost_breakdown(
            (timeline_doc or {}).get("request")),
        "memory_bytes": (profile or {}).get("memory_bytes") or {},
        "sampler": {
            "samples": ((profile or {}).get("sampler") or {}).get(
                "samples", 0)},
    }
    return report


def print_text(report: dict) -> None:
    att = report["attribution"]
    frac = att["attributed_fraction"]
    print(f"e2e wall: {att['e2e_s']:.3f}s   named phases: "
          f"{att['named_s']:.3f}s   attributed: "
          f"{'n/a' if frac is None else f'{frac:.1%}'}")
    print(f"{'phase':36s} {'total_s':>10s} {'count':>9s} "
          f"{'share':>7s}  attr")
    for r in att["top_phases"]:
        share = r["share_of_e2e"]
        print(f"{r['phase']:36s} {r['total_s']:10.4f} "
              f"{r['count']:9d} "
              f"{'   n/a' if share is None else f'{share:6.1%}'}  "
              f"{'*' if r['attributed'] else ''}")
    led = report["compile_ledger"]
    print(f"\ncompile ledger: {led['backend_compiles']} kernel "
          f"builds, {led['compile_seconds_total']:.3f}s cumulative")
    for site, v in led["sites"].items():
        print(f"  {site:28s} hits={v['hits']:<8d} "
              f"misses={v['misses']:<6d} hit_ratio={v['hit_ratio']}")
    for ev, v in (led["build_events"] or {}).items():
        print(f"  build/{ev:24s} n={v.get('count', 0):<9d} "
              f"{v.get('total_s', 0.0):.3f}s")
    if report.get("journal_costs"):
        print("\nper-event journal costs:")
        for ev, v in sorted(report["journal_costs"].items(),
                            key=lambda kv: -kv[1]["total_ms"]):
            print(f"  {ev:32s} n={v['count']:<9d} "
                  f"total={v['total_ms']:.1f}ms mean="
                  f"{v['mean_ms']}ms")
    rb = report.get("request_breakdown")
    if rb:
        print(f"\nrequest {rb['trace_id']} (rid={rb['rid']}, "
              f"complete={rb['complete']}, "
              f"cross_process={rb['cross_process']}): "
              f"{rb['attributed_ms']}ms attributed over "
              f"{len(rb['hops'])} hops")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-request / per-fit performance attribution "
                    "from profile snapshots and journals")
    ap.add_argument("artifact", nargs="?", default=None,
                    help="artifact JSON with a telemetry block "
                         "({'telemetry': {'profile': ..., "
                         "'metrics_exposition': ...}})")
    ap.add_argument("--journal", action="append", default=[],
                    help="journal JSONL file (repeatable)")
    ap.add_argument("--timeline", default=None,
                    help="trace_report --format json document")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--flamegraph", default=None,
                    help="write the sampler's collapsed stacks here")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    args = ap.parse_args(argv)
    artifact = None
    if args.artifact:
        with open(args.artifact) as f:
            artifact = json.load(f)
    timeline_doc = None
    if args.timeline:
        with open(args.timeline) as f:
            timeline_doc = json.load(f)
    report = build_report(artifact, args.journal or None,
                          timeline_doc, top=args.top)
    if args.flamegraph:
        stacks = (((artifact or {}).get("telemetry") or {})
                  .get("profile") or {}).get("sampler", {}) \
            .get("stacks", [])
        with open(args.flamegraph, "w") as f:
            f.write("\n".join(stacks) + ("\n" if stacks else ""))
        print(f"flamegraph -> {args.flamegraph} "
              f"({len(stacks)} stacks)", file=sys.stderr)
    if args.format == "json":
        print(json.dumps(report, sort_keys=True))
    else:
        print_text(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
