"""Export a flight-recorder ledger as a Chrome trace (Perfetto JSON).

The counterpart of tpu_reductions/obs/trace_export.py, with the same
rules, so a ledger either package wrote exports the same:

    python -m tpu_reductions_torch.obs.trace_export ledger.jsonl \
        [--out trace.json]

`build_spans` rebuilds span records from the flat event list:
  * a `<name>.start` / `<name>.end` pair is one slice, matched by span id
    when the events carry one (obs/trace.py), else by name as a stack per
    pid; the legacy pairs `collective.launch`/`collective.done`,
    `serve.start`/`serve.stop` and `route.start`/`route.stop` pair the
    same way;
  * a point event carrying `dur_s` (else `exec_s`) is a slice ending at
    its own time;
  * an open whose close died with its process (an orphan) closes at the
    first `trace.cut` of its trace after it, else at its pid's last
    event, and is marked `cut`;
  * each serving request (`serve.enqueue` .. `serve.respond`) becomes a
    request span with its queued and exec children.

`chrome_trace` lays the spans out one process a pid, one lane a (pid,
trace), with instants for the other point events and flow arrows where a
span's parent lives in another process (the parent propagated
TPU_REDUCTIONS_TRACE_CTX to it). A rotated ledger's `<ledger>.1` is read
first (obs/timeline.read_ledger). Offline: stdlib only, no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

# legacy-named bracket pairs that predate the `.start`/`.end` span
# convention — registered event names (lint/grammar.py), paired here
OPENER_CLOSERS = {"collective.launch": "collective.done",
                  "serve.start": "serve.stop",
                  "route.start": "route.stop"}
CLOSER_SUFFIX = ".end"
OPENER_SUFFIX = ".start"
# point-event duration fields, in precedence order (the emitters close
# their perf_counter windows before emitting — docs/OBSERVABILITY.md)
DUR_FIELDS = ("dur_s", "exec_s")


def _split_bracket(ev: str) -> Tuple[Optional[str], Optional[str]]:
    """(base, kind) where kind is 'open'/'close'/None for a point."""
    if ev in OPENER_CLOSERS:
        return ev, "open"
    for base, closer in OPENER_CLOSERS.items():
        if ev == closer:
            return base, "close"
    if ev.endswith(OPENER_SUFFIX):
        return ev[:-len(OPENER_SUFFIX)], "open"
    if ev.endswith(CLOSER_SUFFIX):
        return ev[:-len(CLOSER_SUFFIX)], "close"
    return None, None


def _cut_time(e: dict, cuts: List[dict], pid_last: Dict) -> float:
    """Synthetic close time for an orphaned open: the first trace.cut
    of the same trace after it, else the pid's last recorded instant
    (which is >= the open by construction)."""
    tr = e.get("trace")
    for c in cuts:
        if c["t"] >= e["t"] and (tr is None or c.get("trace") == tr):
            return c["t"]
    return pid_last.get(e.get("pid"), e["t"])


def build_spans(events: List[dict]) -> List[dict]:
    """Reconstruct span records from a flat event list (module
    docstring has the rules). Each record: {name, pid, t0, t1, dur_s,
    trace, span, parent, cut, fields}."""
    spans: List[dict] = []
    cuts = [e for e in events if e["ev"] == "trace.cut"]
    pid_last: Dict = {}
    for e in events:
        pid_last[e.get("pid")] = max(pid_last.get(e.get("pid"), e["t"]),
                                     e["t"])
    by_span: Dict = {}      # (pid, span_id) -> open event
    by_name: Dict = {}      # (pid, base) -> [open events] (legacy stack)
    skip = {"t", "ev", "pid", "trace", "span", "parent"}

    def _close(open_e: dict, base: str, t1: float, cut: bool,
               close_fields: Optional[dict] = None) -> None:
        fields = {k: v for k, v in open_e.items() if k not in skip}
        for k, v in (close_fields or {}).items():
            if k not in skip and k not in DUR_FIELDS:
                fields.setdefault(k, v)
        spans.append({"name": base, "pid": open_e.get("pid"),
                      "t0": open_e["t"], "t1": max(t1, open_e["t"]),
                      "dur_s": round(max(t1 - open_e["t"], 0.0), 6),
                      "trace": open_e.get("trace"),
                      "span": open_e.get("span"),
                      "parent": open_e.get("parent"),
                      "cut": cut, "fields": fields})

    for e in events:
        base, kind = _split_bracket(e["ev"])
        if kind == "open":
            key = (e.get("pid"), e.get("span"))
            if e.get("span") is not None:
                by_span[key] = e
            else:
                by_name.setdefault((e.get("pid"), base), []).append(e)
        elif kind == "close":
            key = (e.get("pid"), e.get("span"))
            open_e = by_span.pop(key, None) if e.get("span") is not None \
                else None
            if open_e is None:
                stack = by_name.get((e.get("pid"), base))
                open_e = stack.pop() if stack else None
            if open_e is not None:
                _close(open_e, base, e["t"], cut=False, close_fields=e)
        else:
            for df in DUR_FIELDS:
                d = e.get(df)
                if isinstance(d, (int, float)) and d > 0:
                    fields = {k: v for k, v in e.items() if k not in skip}
                    spans.append({"name": e["ev"], "pid": e.get("pid"),
                                  "t0": e["t"] - float(d), "t1": e["t"],
                                  "dur_s": round(float(d), 6),
                                  "trace": e.get("trace"),
                                  "span": e.get("span"),
                                  "parent": e.get("parent"),
                                  "cut": False, "fields": fields})
                    break
    # orphaned opens: the close died with the process — synthesize it
    # at the trace.cut (or the pid's last instant), never leave a torn
    # tree
    for open_e in list(by_span.values()) + \
            [e for stack in by_name.values() for e in stack]:
        base, _ = _split_bracket(open_e["ev"])
        _close(open_e, base or open_e["ev"],
               _cut_time(open_e, cuts, pid_last), cut=True)
    spans.extend(_request_spans(events))
    spans.sort(key=lambda s: (s["t0"], s["t1"]))
    return spans


def _request_spans(events: List[dict]) -> List[dict]:
    """Per-request span synthesis: one trace per serving request (the
    request id is the trace id — obs/trace.request_context), bracketed
    enqueue→respond with queued/exec child slices from the queue_s
    split the respond event stamps."""
    enq: Dict[str, dict] = {}
    out: List[dict] = []
    for e in events:
        rid = e.get("req")
        if not isinstance(rid, str):
            continue
        if e["ev"] == "serve.enqueue":
            enq[rid] = e
        elif e["ev"] == "serve.respond" and rid in enq:
            e0 = enq.pop(rid)
            t0, t1 = e0["t"], e["t"]
            base = {"pid": e0.get("pid"), "trace": rid, "span": rid,
                    "parent": None, "cut": False}
            out.append({**base, "name": f"request {rid}",
                        "t0": t0, "t1": t1,
                        "dur_s": round(t1 - t0, 6),
                        "fields": {"status": e.get("status"),
                                   "method": e0.get("method"),
                                   "n": e0.get("n"),
                                   "batch_size": e.get("batch_size")}})
            q = e.get("queue_s")
            if isinstance(q, (int, float)) and 0 < q <= t1 - t0:
                out.append({**base, "name": "queued", "parent": rid,
                            "span": f"{rid}.q", "t0": t0, "t1": t0 + q,
                            "dur_s": round(q, 6), "fields": {}})
                out.append({**base, "name": "exec", "parent": rid,
                            "span": f"{rid}.x", "t0": t0 + q, "t1": t1,
                            "dur_s": round(t1 - t0 - q, 6), "fields": {}})
    return out


def chrome_trace(events: List[dict]) -> dict:
    """The Chrome trace-event JSON ({"traceEvents": [...]}) for a
    parsed ledger: X slices for spans, i instants for point events,
    M metadata naming the process/trace lanes, s/f flow arrows for
    cross-process parentage (module docstring)."""
    spans = build_spans(events)
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = events[0]["t"]
    for s in spans:
        t_base = min(t_base, s["t0"])

    def _us(t: float) -> float:
        return round((t - t_base) * 1e6, 1)

    # tid lanes: per (pid, trace), stable in first-appearance order
    lanes: Dict[Tuple, int] = {}
    lane_label: Dict[Tuple, str] = {}

    def _tid(pid, trace_id) -> int:
        key = (pid, trace_id)
        if key not in lanes:
            lanes[key] = len([k for k in lanes if k[0] == pid]) + 1
            if trace_id is None:
                lane_label[key] = "untraced"
            elif trace_id.startswith("r") and trace_id[1:].isdigit():
                lane_label[key] = f"request {trace_id}"
            else:
                lane_label[key] = f"trace {trace_id}"
        return lanes[key]

    prog_by_pid: Dict = {}
    for e in events:
        if e["ev"] == "session.start" and e.get("pid") is not None:
            prog_by_pid.setdefault(e["pid"], e.get("prog")
                                   or e.get("src") or "session")
    out: List[dict] = []
    span_ids: Dict[str, dict] = {}
    for s in spans:
        tid = _tid(s["pid"], s["trace"])
        args = {k: v for k, v in s["fields"].items() if v is not None}
        if s["cut"]:
            args["cut"] = True
        out.append({"ph": "X", "name": s["name"],
                    "cat": s["name"].split(".")[0],
                    "ts": _us(s["t0"]),
                    "dur": max(round(s["dur_s"] * 1e6, 1), 1.0),
                    "pid": s["pid"] if s["pid"] is not None else 0,
                    "tid": tid, "args": args})
        if s["span"] is not None:
            span_ids[s["span"]] = s
    # flow arrows: a span whose parent lives in ANOTHER pid was
    # propagated there via TPU_REDUCTIONS_TRACE_CTX — draw the arrow
    flow_n = 0
    for s in spans:
        p = s.get("parent")
        if p is None or p not in span_ids:
            continue
        parent = span_ids[p]
        if parent["pid"] == s["pid"]:
            continue
        flow_n += 1
        common = {"cat": "propagation", "name": "trace-ctx",
                  "id": flow_n}
        out.append({**common, "ph": "s", "pid": parent["pid"],
                    "tid": _tid(parent["pid"], parent["trace"]),
                    "ts": _us(min(max(parent["t0"], s["t0"]),
                                  parent["t1"]))})
        out.append({**common, "ph": "f", "bp": "e", "pid": s["pid"],
                    "tid": _tid(s["pid"], s["trace"]),
                    "ts": _us(s["t0"])})
    # instants for point events that did not become slices
    sliced = {(s["pid"], s["t1"], s["name"]) for s in spans}
    for e in events:
        base, kind = _split_bracket(e["ev"])
        if kind is not None:
            continue
        if any(isinstance(e.get(df), (int, float)) and e[df] > 0
               for df in DUR_FIELDS):
            continue
        if (e.get("pid"), e["t"], e["ev"]) in sliced:
            continue
        args = {k: v for k, v in e.items()
                if k not in ("t", "ev", "pid", "trace", "span", "parent")
                and v is not None}
        out.append({"ph": "i", "s": "t", "name": e["ev"],
                    "cat": e["ev"].split(".")[0], "ts": _us(e["t"]),
                    "pid": e.get("pid") if e.get("pid") is not None
                    else 0,
                    "tid": _tid(e.get("pid"), e.get("trace")),
                    "args": args})
    # lane metadata last (ph M sorts anywhere; keep deterministic)
    for pid, prog in sorted(prog_by_pid.items(), key=lambda kv: str(kv)):
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": f"{prog} (pid {pid})"}})
    for (pid, _tr), tid in sorted(lanes.items(),
                                  key=lambda kv: (str(kv[0][0]), kv[1])):
        out.append({"ph": "M", "name": "thread_name",
                    "pid": pid if pid is not None else 0, "tid": tid,
                    "args": {"name": lane_label[(pid, _tr)]}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    """CLI: ledger.jsonl -> trace.json (module docstring; the runbook
    step is "open trace.json in https://ui.perfetto.dev")."""
    from tpu_reductions_torch.obs.timeline import read_ledger
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.obs.trace_export",
        description="Export a flight-recorder ledger as Chrome-trace/"
                    "Perfetto JSON (span tree, process/trace lanes)")
    p.add_argument("ledger", help="JSONL event ledger (obs/ledger.py; "
                                  "a rotated <ledger>.1 is stitched in)")
    p.add_argument("--out", default="trace.json",
                   help="Chrome trace JSON output (default trace.json)")
    ns = p.parse_args(argv)
    try:
        events, torn = read_ledger(ns.ledger)
    except OSError as e:
        print(f"trace_export: cannot read {ns.ledger}: {e}",
              file=sys.stderr)
        return 1
    doc = chrome_trace(events)
    from tpu_reductions_torch.utils.jsonio import atomic_json_dump
    atomic_json_dump(ns.out, doc)
    slices = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
    lanes = len({(e.get("pid"), e.get("tid"))
                 for e in doc["traceEvents"] if e["ph"] == "X"})
    print(f"trace_export: {len(events)} event(s) ({torn} torn) -> "
          f"{slices} slice(s) on {lanes} lane(s): {ns.out} "
          "(open in https://ui.perfetto.dev)", file=sys.stderr)
    return 0 if events else 1


if __name__ == "__main__":
    sys.exit(main())
