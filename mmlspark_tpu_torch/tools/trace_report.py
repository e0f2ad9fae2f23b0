"""Trace-report reader: reconstruct per-request and per-fit timelines
from :class:`mmlspark_tpu_torch.core.telemetry.EventJournal` JSONL dumps,
including CROSS-PROCESS timelines merged from several processes'
journals.

The port's copy of the reference's ``tools/trace_report.py``: it reads
journals through the port's :func:`..core.telemetry.read_journal`, so it
runs on a card host without jax, and it reads the reference's journals
alike (the event names and fields are the same).

The serving engine journals per-BATCH pipeline events
(``form``/``decode``/``score``/``reply``, plus
``shed``/``expired``/``salvage``) carrying the batch's request ids and
trace ids; the transport journals per-hop spans (``hop_enqueue`` /
``hop_send`` / ``hop_ack`` sender-side, ``hop_deliver`` with the
send→recv clock offset receiver-side, a ``retrans`` flag on replayed
sends); the multiprocess serving worker journals ``request_recv`` /
``request_reply`` where the client socket lives; the training engine
journals per-FIT events (``fit_begin``, ``boost_chunk``,
``ckpt_saved``/``ckpt_resumed``/``ckpt_discarded``,
``chunk_replayed``, ``peer_stalled``/``peer_lost``, ``fit_end``)
stamped with a fit span id.  This tool stitches any of it back into a
timeline:

* :func:`request_timeline` — given a trace id (the client's
  ``_trace_id`` payload key, or the request id minted at admission),
  find the request's events across every journal handed in and order
  them: a complete scored request on the multiprocess topology shows
  ``request_recv → hop_enqueue/hop_send → hop_deliver → form → decode
  → score → reply → hop_enqueue/hop_send → hop_deliver →
  request_reply`` spanning both processes (``cross_process`` reports
  how many pids contributed).
* :func:`fit_timeline` — given a fit span id (or the newest fit in the
  journal), order everything stamped with it.

CLI::

    python -m mmlspark_tpu_torch.tools.trace_report JOURNAL.jsonl \
        [more.jsonl ...] \
        [--trace-id TID] [--fit SPAN | --fit latest] \
        [--format text|json]

``--format json`` emits ONE machine-readable
document in the stable ``mmlspark_tpu.trace_timeline/v1`` schema (see
:func:`timeline_report`) — the shape ``tools/perf_report.py`` (:mod:`.perf_report`) consumes
to put a per-hop cost breakdown under every timeline.

Multiple journal files (e.g. the coordinator's plus each worker's
``MMLSPARK_TPU_JOURNAL_DIR`` mirror, or one per controller of a gang)
are merged and ordered by ``(ts, seq)`` — ``seq`` is
process-monotonic, ``ts`` is wall clock, so cross-process order is as
honest as the hosts' clocks (the ``hop_deliver`` ``offset_ms`` field
carries the measured send→recv skew for exactly that reason).
"""

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional

#: the serving pipeline stages a fully-served request passes through
REQUEST_STAGES = ("form", "decode", "score", "reply")

#: per-hop transport span events (single ``tid`` field, not the batch
#: ``trace_ids`` list)
HOP_EVENTS = ("hop_enqueue", "hop_send", "hop_ack", "hop_deliver")

#: worker-process bookend events of a multiprocess request
WORKER_EVENTS = ("request_recv", "request_reply")


def load_events(paths) -> List[dict]:
    """Load and merge one or more JSONL journals (or pass event dicts
    through), ordered by ``(ts, seq)``."""
    from ..core.telemetry import read_journal
    events: List[dict] = []
    for p in ([paths] if isinstance(paths, str) else list(paths)):
        if isinstance(p, dict):
            events.append(p)
        else:
            events.extend(read_journal(p))
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return events


def _resolve_rid(events: Iterable[dict], trace_id: str) -> str:
    """Map a trace id to its request id via any batch event that
    carries both aligned lists (or a worker bookend event carrying
    both scalar fields); a trace id that never appears is assumed to
    BE the rid (the minted-at-admission default, where the two are the
    same string)."""
    for e in events:
        tids = e.get("trace_ids") or []
        if trace_id in tids:
            rids = e.get("rids") or []
            i = tids.index(trace_id)
            if i < len(rids):
                return str(rids[i])
        if e.get("tid") == trace_id and e.get("rid"):
            return str(e["rid"])
    return trace_id


def request_timeline(events: Iterable[dict], trace_id: str) -> dict:
    """Reconstruct one request's pipeline timeline across every
    journal handed in (coordinator + workers).

    Returns ``{"trace_id", "rid", "events": [...], "stages": [...],
    "hops": [...], "pids": [...], "cross_process": bool,
    "complete": bool}`` — ``complete`` means the full
    form→decode→score→reply chain was observed (a shed/expired request
    is legitimately incomplete and shows its degradation event
    instead); ``hops`` is the subset of per-hop transport spans,
    ``retransmits`` counts replayed sends among them, and
    ``cross_process`` is True when more than one pid contributed
    events — the stitched coordinator+worker view."""
    events = list(events)
    rid = _resolve_rid(events, trace_id)
    ids = {trace_id, rid}
    mine: List[dict] = []
    for e in events:
        if ids & set(e.get("rids") or []) \
                or ids & set(e.get("trace_ids") or []) \
                or e.get("tid") in ids or e.get("rid") in ids:
            mine.append(e)
    mine.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    stages = [e.get("ev") for e in mine]
    hops = [e for e in mine if e.get("ev") in HOP_EVENTS]
    pids = sorted({e["pid"] for e in mine if e.get("pid") is not None})
    return {
        "trace_id": trace_id,
        "rid": rid,
        "events": mine,
        "stages": stages,
        "hops": hops,
        "retransmits": sum(1 for e in hops if e.get("retrans")),
        "pids": pids,
        "cross_process": len(pids) > 1,
        "complete": all(s in stages for s in REQUEST_STAGES),
    }


def list_fits(events: Iterable[dict]) -> List[str]:
    """Fit span ids in first-seen order."""
    out: List[str] = []
    for e in events:
        span = e.get("fit")
        if span and span not in out:
            out.append(span)
    return out


def fit_timeline(events: Iterable[dict],
                 fit_span: Optional[str] = None) -> dict:
    """Reconstruct one fit's timeline (``fit_span=None`` picks the
    NEWEST fit that has a ``fit_begin`` — the one a post-mortem usually
    wants).  ``complete`` means both ``fit_begin`` and ``fit_end`` were
    observed; a crashed fit shows ``fit_failed`` or simply no end."""
    events = list(events)
    if fit_span is None:
        begins = [e.get("fit") for e in events
                  if e.get("ev") == "fit_begin" and e.get("fit")]
        fit_span = begins[-1] if begins else None
    mine = [e for e in events if e.get("fit") == fit_span]
    mine.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    kinds = [e.get("ev") for e in mine]
    return {
        "fit": fit_span,
        "events": mine,
        "kinds": kinds,
        "complete": "fit_begin" in kinds and "fit_end" in kinds,
    }


#: machine-readable schema tag; bump the suffix on ANY key change —
#: perf_report and external consumers key off it
TIMELINE_SCHEMA = "mmlspark_tpu.trace_timeline/v1"


def timeline_report(events, trace_id: Optional[str] = None,
                    fit: Optional[str] = None) -> dict:
    """The stable machine-readable timeline document (``--format
    json``).  Keys are FIXED for the schema version:

    * ``schema`` — :data:`TIMELINE_SCHEMA`.
    * ``events_total`` — merged event count across the journals.
    * ``event_counts`` — ``{ev: count}`` over every merged event.
    * ``fits`` — fit span ids in first-seen order.
    * ``request`` — :func:`request_timeline` output for ``trace_id``
      (``null`` when no trace id was asked for).
    * ``fit`` — :func:`fit_timeline` output (``null`` unless asked;
      ``fit="latest"`` picks the newest ``fit_begin``).

    Every value is JSON-native (the journal records already are), so
    ``json.loads(json.dumps(report)) == report`` — the round-trip the
    tier-1 schema test pins."""
    events = list(events)
    kinds: Dict[str, int] = {}
    for e in events:
        kinds[e.get("ev", "?")] = kinds.get(e.get("ev", "?"), 0) + 1
    return {
        "schema": TIMELINE_SCHEMA,
        "events_total": len(events),
        "event_counts": kinds,
        "fits": list_fits(events),
        "request": (request_timeline(events, trace_id)
                    if trace_id else None),
        "fit": (fit_timeline(events, None if fit == "latest" else fit)
                if fit else None),
    }


def _fmt_event(e: dict, t0: float) -> str:
    extras = {k: v for k, v in e.items()
              if k not in ("ts", "seq", "ev", "rids", "trace_ids",
                           "pid")}
    nrows = len(e.get("rids") or [])
    if nrows:
        extras["batch"] = nrows
    tail = " ".join(f"{k}={v}" for k, v in sorted(extras.items()))
    pid = f"[{e['pid']:>7}] " if e.get("pid") is not None else ""
    return (f"  +{e.get('ts', t0) - t0:9.3f}s  {pid}"
            f"{e.get('ev', '?'):14s} {tail}")


def print_request(report: dict) -> None:
    print(f"request trace_id={report['trace_id']} rid={report['rid']} "
          f"complete={report['complete']} "
          f"cross_process={report.get('cross_process', False)} "
          f"hops={len(report.get('hops') or [])} "
          f"retransmits={report.get('retransmits', 0)}")
    evs = report["events"]
    t0 = evs[0].get("ts", 0.0) if evs else 0.0
    for e in evs:
        print(_fmt_event(e, t0))


def print_fit(report: dict) -> None:
    print(f"fit span={report['fit']} complete={report['complete']} "
          f"({len(report['events'])} events)")
    evs = report["events"]
    t0 = evs[0].get("ts", 0.0) if evs else 0.0
    for e in evs:
        print(_fmt_event(e, t0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="reconstruct request/fit timelines from telemetry "
                    "journals")
    ap.add_argument("journals", nargs="+", help="JSONL journal file(s)")
    ap.add_argument("--trace-id", default=None,
                    help="report this request's pipeline timeline")
    ap.add_argument("--fit", default=None,
                    help="fit span id to report ('latest' for the "
                         "newest fit in the journal)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text",
                    help="json: one stable machine-readable timeline "
                         "document (mmlspark_tpu.trace_timeline/v1)")
    args = ap.parse_args(argv)
    events = load_events(args.journals)
    if args.format == "json":
        print(json.dumps(timeline_report(events, args.trace_id,
                                         args.fit),
                         sort_keys=True))
        return 0
    print(f"{len(events)} events from {len(args.journals)} journal(s)")
    did = False
    if args.trace_id:
        print_request(request_timeline(events, args.trace_id))
        did = True
    if args.fit:
        span = None if args.fit == "latest" else args.fit
        print_fit(fit_timeline(events, span))
        did = True
    if not did:
        # no selector: summarize what's in there
        kinds: Dict[str, int] = {}
        for e in events:
            kinds[e.get("ev", "?")] = kinds.get(e.get("ev", "?"), 0) + 1
        print("event counts:", json.dumps(kinds, sort_keys=True))
        fits = list_fits(events)
        print(f"fits: {fits}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
