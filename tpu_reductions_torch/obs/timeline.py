"""Post-mortem timeline: rebuild the sessions of a flight-recorder ledger
and attribute their wall clock by phase.

The counterpart of tpu_reductions/obs/timeline.py, with the same
summaries, keys and rounding, so a ledger either package wrote reads the
same through either. Offline: no device, safe to run right after a
watchdog exit 3 or 4. Per session (one `session.start` .. end or exit
stream per pid) and for the window:

  * a chronological narrative (every event, T+offset from the first);
  * per-phase wall clock from the heartbeat's `hb.phase` transitions
    (utils/heartbeat.py): measure, compile, staging and host, with retry
    backoff (`retry.attempt`) carved out of host time and an exit-4
    stall's age (`watchdog.exit`) out of the stalled guard's bucket;
  * the window's utilization: the share of recorded seconds in each
    bucket;
  * the critical path over the span tree (obs/critical_path.py);
  * the summaries of the scheduler, serving, router, stream,
    collective, reshard, autoscale, recovery, compile and execution
    core events.

A ledger rotated by its size cap is read whole: `read_ledger` stitches
`<ledger>.1` in front of the live file for every reader (the timeline,
obs/trace_export, sched/priors). Unparseable lines are counted, never
fatal.

CLI:
    python -m tpu_reductions_torch.obs.timeline <ledger.jsonl> \
        [--json OUT] [--summary-md] [--quiet] [--max-events N]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

BUCKETS = ("measure", "compile", "staging", "retrying", "stalled",
           "host")


def _bucket(phase: Optional[str]) -> str:
    """Map a heartbeat phase label to an attribution bucket. Unknown
    guarded phases (chained/fetch/bulk/periter/device/steady/...) are
    measurement by construction — only guarded device regions carry a
    phase at all (utils/heartbeat.py)."""
    if phase is None:
        return "host"
    if phase == "compile":
        return "compile"
    if phase == "staging":
        return "staging"
    return "measure"


def read_ledger(path) -> Tuple[List[dict], int]:
    """Parse a JSONL ledger -> (events sorted by t, torn_line_count).
    A line that fails to parse, or parses to something that is not an
    event row, counts as torn. A rotated predecessor segment
    `<path>.1` (obs/ledger.py's size-cap rotation renames the full
    file there) is stitched back IN FRONT of the live file, so a
    session whose ledger rolled over mid-run reads whole — every
    consumer of this reader (timeline, trace_export, sched/priors)
    gets the stitch for free. OSError only when no segment exists."""
    events: List[dict] = []
    torn = 0

    def _parse(fobj) -> None:
        nonlocal torn
        for line in fobj:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if isinstance(rec, dict) and isinstance(rec.get("t"),
                                                    (int, float)) \
                    and isinstance(rec.get("ev"), str):
                events.append(rec)
            else:
                torn += 1

    rotated = f"{path}.1"
    stitched = False
    try:
        with open(rotated, errors="replace") as f:
            _parse(f)
        stitched = True
    except OSError:
        pass
    try:
        with open(path, errors="replace") as f:
            _parse(f)
    except OSError:
        if not stitched:
            raise
    events.sort(key=lambda e: e["t"])
    return events, torn


def split_sessions(events: List[dict]) -> List[dict]:
    """Group events into sessions: per pid, a new session opens at each
    `session.start` (events before one — e.g. shell supervisor events —
    form their own leading pseudo-session). Sessions order by first
    event time."""
    by_pid: dict = {}
    for e in events:
        by_pid.setdefault(e.get("pid"), []).append(e)
    sessions = []
    for pid, evs in by_pid.items():
        cur = None
        for e in evs:
            if e["ev"] == "session.start" or cur is None:
                cur = {"pid": pid, "events": []}
                sessions.append(cur)
            cur["events"].append(e)
    sessions.sort(key=lambda s: s["events"][0]["t"])
    return sessions


def analyze_session(sess: dict) -> dict:
    """Per-phase wall-clock attribution for one session (module
    docstring has the carving rules)."""
    evs = sess["events"]
    t0, t1 = evs[0]["t"], evs[-1]["t"]
    buckets = dict.fromkeys(BUCKETS, 0.0)
    phase: Optional[str] = None
    retry_s = 0.0
    exit_event = None
    prog = next((e.get("prog") for e in evs
                 if e["ev"] == "session.start"), None)
    for i, e in enumerate(evs):
        if e["ev"] == "hb.phase":
            phase = e.get("phase")
        if e["ev"] == "retry.attempt":
            d = e.get("delay_s")
            retry_s += float(d) if isinstance(d, (int, float)) else 0.0
        if e["ev"] == "watchdog.exit" and exit_event is None:
            exit_event = e
        nxt = evs[i + 1]["t"] if i + 1 < len(evs) else t1
        buckets[_bucket(phase)] += max(0.0, nxt - e["t"])
    # retry backoff sleeps run between guards (phase None -> host):
    # carve them into their own bucket, bounded so clock skew between
    # events can never drive host time negative
    carve = min(retry_s, buckets["host"])
    buckets["host"] -= carve
    buckets["retrying"] += carve
    # an exit-4 hang accrued its no-progress age inside the stalled
    # guard's phase bucket — reattribute it as stalled time
    if exit_event is not None and exit_event.get("code") == 4:
        age = exit_event.get("age_s")
        age = float(age) if isinstance(age, (int, float)) else 0.0
        b = _bucket(exit_event.get("phase"))
        carve = min(age, buckets[b])
        buckets[b] -= carve
        buckets["stalled"] += carve
    wall = max(t1 - t0, 0.0)
    ended = any(e["ev"] == "session.end" for e in evs)
    if exit_event is not None:
        end = f"exit {exit_event.get('code')}"
    elif ended:
        end = "end"
    else:
        end = "cut"       # no terminal event: SIGKILL-class death
    return {
        "pid": sess["pid"],
        "prog": prog,
        "t0": t0, "t1": t1,
        "wall_s": round(wall, 6),
        "end": end,
        "events": len(evs),
        "phases_s": {k: round(v, 6) for k, v in buckets.items()},
        "utilization": {k: (round(v / wall, 4) if wall > 0 else 0.0)
                        for k, v in buckets.items()},
        "persists": sum(1 for e in evs if e["ev"] == "artifact.persist"),
        "reused_rows": sum(1 for e in evs if e["ev"] == "resume.reuse"),
        "retries": sum(1 for e in evs if e["ev"] == "retry.attempt"),
        "faults": sum(1 for e in evs if e["ev"] == "fault.fire"),
    }


def sched_summary(events: List[dict]) -> Optional[dict]:
    """Plan-vs-actual attribution from the scheduler's typed events
    (sched.plan/pick/skip/done/replan — lint/grammar.py SCHED_EVENTS;
    tpu_reductions/sched/). One record per task in first-pick order:
    planned vs actual seconds and the settled status, plus the replan
    count — the committed answer to 'what did the planner promise and
    what did the window deliver'. None when no scheduler ran."""
    tasks: dict = {}
    order: List[str] = []
    replans = 0
    for e in events:
        ev = e["ev"]
        if ev not in ("sched.pick", "sched.done", "sched.skip",
                      "sched.replan", "sched.plan"):
            continue
        if ev == "sched.replan":
            replans += 1
            continue
        if ev == "sched.plan":
            continue
        name = e.get("task")
        if not isinstance(name, str):
            continue
        if name not in tasks:
            tasks[name] = {"task": name, "planned_s": None,
                           "actual_s": None, "status": None}
            order.append(name)
        rec = tasks[name]
        if ev == "sched.pick":
            rec["planned_s"] = e.get("est_s")
            rec["status"] = rec["status"] or "picked"
        elif ev == "sched.done":
            rec["actual_s"] = e.get("actual_s")
            rec["status"] = e.get("status") or "done"
        elif ev == "sched.skip":
            rec["status"] = "skipped"
            rec["reason"] = e.get("reason")
    if not tasks:
        return None
    return {"tasks": [tasks[n] for n in order], "replans": replans}


def _percentile(sorted_vals: List[float], q: float) -> float:
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def serve_summary(events: List[dict]) -> Optional[dict]:
    """Per-request latency attribution from the serving engine's typed
    events (serve.enqueue/coalesce/launch/verify/respond —
    lint/grammar.py SERVE_EVENTS; tpu_reductions/serve/). The post-hoc
    answer  requires: how many requests, how they resolved,
    where their milliseconds went (queued vs in-launch — the engine
    stamps queue_s/latency_s on every respond event), and how hard
    coalescing worked (batches, mean size). None when no engine ran.

    Requests JOIN BY ID: the `req` field — the
    request's trace id, obs/trace.request_context — keys every
    enqueue→respond pair, so the latency split never misaligns under
    reordered completion, and the mismatches are FLAGGED (`orphans`):
    an admitted request that never got a respond (a torn session), or
    a non-rejected respond with no enqueue (rejected responds are
    legitimately enqueue-less — admission control sheds before the
    queue)."""
    enq = [e for e in events if e["ev"] == "serve.enqueue"]
    responds = [e for e in events if e["ev"] == "serve.respond"]
    launches = [e for e in events if e["ev"] == "serve.launch"]
    sheds = [e for e in events if e["ev"] == "serve.shed"]
    routes = [e for e in events if e["ev"] == "route.done"]
    if not enq and not responds and not routes:
        return None
    by_status: dict = {}
    for e in responds:
        s = e.get("status") or "?"
        by_status[s] = by_status.get(s, 0) + 1
    out = {"requests": len(enq), "responses": len(responds),
           "by_status": by_status, "batches": len(launches),
           "shed_episodes": len(sheds)}
    shards = sum(1 for e in events if e["ev"] == "serve.shard")
    if shards:
        out["sharded_launches"] = shards
    router = _router_summary(events, routes)
    if router:
        out["router"] = router
    sizes = [e["size"] for e in launches
             if isinstance(e.get("size"), int)]
    if sizes:
        out["mean_batch"] = round(sum(sizes) / len(sizes), 2)
    pending = {e["req"] for e in enq if isinstance(e.get("req"), str)}
    joined: List[dict] = []
    orphan_responses = 0
    for e in responds:
        rid = e.get("req")
        if isinstance(rid, str) and rid in pending:
            pending.discard(rid)
            joined.append(e)
        elif e.get("status") != "rejected":
            orphan_responses += 1
    if pending or orphan_responses:
        out["orphans"] = {"requests": len(pending),
                          "responses": orphan_responses}
    ok_lat = sorted(e["latency_s"] for e in joined
                    if e.get("status") == "ok"
                    and isinstance(e.get("latency_s"), (int, float)))
    if ok_lat:
        out["latency_s"] = {"p50": round(_percentile(ok_lat, 0.5), 6),
                            "p99": round(_percentile(ok_lat, 0.99), 6)}
    queued = sorted(e["queue_s"] for e in joined
                    if isinstance(e.get("queue_s"), (int, float)))
    if queued:
        out["queue_s"] = {"p50": round(_percentile(queued, 0.5), 6),
                          "p99": round(_percentile(queued, 0.99), 6)}
    return out


def _router_summary(events: List[dict],
                    routes: List[dict]) -> Optional[dict]:
    """Per-replica attribution from the router's typed events
    (lint/grammar.py ROUTE_EVENTS/REPLICA_EVENTS; serve/router.py —
    the scaling tier: per replica, how many terminal outcomes
    it served with what latency tail and how much of the shed/error
    weight it carried; plus the re-route and replica-death record
    (how much work moved because a replica failed). None when no
    router ran."""
    reroutes = [e for e in events if e["ev"] == "route.reroute"]
    downs = [e for e in events if e["ev"] == "replica.down"]
    if not routes and not reroutes and not downs:
        return None
    per: dict = {}
    for e in routes:
        rep = e.get("replica") or "(none)"
        d = per.setdefault(rep, {"requests": 0, "ok": 0, "shed": 0,
                                 "error": 0, "_lat": []})
        d["requests"] += 1
        s = e.get("status")
        if s in d:
            d[s] += 1
        if s == "ok" and isinstance(e.get("latency_s"), (int, float)):
            d["_lat"].append(e["latency_s"])
    for e in reroutes:
        rep = e.get("replica") or "(none)"
        d = per.setdefault(rep, {"requests": 0, "ok": 0, "shed": 0,
                                 "error": 0, "_lat": []})
        d["rerouted_away"] = d.get("rerouted_away", 0) + 1
    for rep, d in per.items():
        lat = sorted(d.pop("_lat"))
        if lat:
            d["latency_s"] = {"p50": round(_percentile(lat, 0.5), 6),
                              "p99": round(_percentile(lat, 0.99), 6)}
    return {"routed": len(routes), "reroutes": len(reroutes),
            "replica_downs": [{"replica": e.get("replica"),
                               "reason": e.get("reason")}
                              for e in downs],
            "replicas": per}


def stream_summary(events: List[dict]) -> Optional[dict]:
    """Streaming-pipeline attribution from the stream.* typed events
    (lint/grammar.py STREAM_EVENTS; ops/stream.py + bench/stream.py).
    The committed answer to the acceptance question: how many
    chunks streamed at what sustained rate, how often the honest
    partial materialized, whether any stream resumed mid-payload, and
    — when the serial comparator ran — the overlap efficiency
    (serial stage-then-reduce wall-clock over streamed wall-clock;
    > 1 means transfer/compute overlap paid off). None when no stream
    ran."""
    starts = [e for e in events if e["ev"] == "stream.start"]
    ends = [e for e in events if e["ev"] == "stream.end"]
    if not starts and not ends:
        return None
    out = {
        "streams": len(starts),
        "chunks": sum(1 for e in events if e["ev"] == "stream.chunk"),
        "syncs": sum(1 for e in events if e["ev"] == "stream.sync"),
        "resumed": sum(1 for e in starts
                       if isinstance(e.get("start_chunk"), int)
                       and e["start_chunk"] > 0),
    }
    rates = [e["gbps"] for e in ends
             if isinstance(e.get("gbps"), (int, float))]
    if rates:
        out["gbps_sustained"] = round(max(rates), 4)
    cps = [e["chunks_per_s"] for e in ends
           if isinstance(e.get("chunks_per_s"), (int, float))]
    if cps:
        out["chunks_per_s"] = round(max(cps), 4)
    overlaps = [e for e in events if e["ev"] == "stream.overlap"]
    if overlaps:
        last = overlaps[-1]
        for key in ("stream_wall_s", "serial_wall_s"):
            if isinstance(last.get(key), (int, float)):
                out[key] = last[key]
        if isinstance(last.get("efficiency"), (int, float)):
            out["overlap_efficiency"] = last["efficiency"]
    return out


def collective_summary(events: List[dict]) -> Optional[dict]:
    """Collective-phase attribution from the collective.* typed events
    (lint/grammar.py COLLECTIVE_EVENTS; bench/collective_driver.py +
    bench/quant_curve.py). The answer to "where did the
    collective minutes go": per selected algorithm, how many launches
    ran and how much wall-clock their device phases took (the
    launch/done brackets), plus how often the selector fell back off
    its first choice (a select whose note marks a degrade). None when
    no collective ran."""
    selects = [e for e in events if e["ev"] == "collective.select"]
    dones = [e for e in events if e["ev"] == "collective.done"]
    launches = sum(1 for e in events if e["ev"] == "collective.launch")
    if not selects and not dones and not launches:
        return None
    algos: dict = {}
    order: List[str] = []
    total_s = 0.0
    for e in dones:
        a = e.get("algorithm")
        if not isinstance(a, str):
            continue
        if a not in algos:
            algos[a] = {"algorithm": a, "launches": 0, "wall_s": 0.0}
            order.append(a)
        algos[a]["launches"] += 1
        d = e.get("wall_s")
        if isinstance(d, (int, float)):
            algos[a]["wall_s"] += float(d)
            total_s += float(d)
    for rec in algos.values():
        rec["wall_s"] = round(rec["wall_s"], 6)
    return {"selects": len(selects), "launches": launches,
            "collective_s": round(total_s, 6),
            "algorithms": [algos[a] for a in order]}


def reshard_summary(events: List[dict]) -> Optional[dict]:
    """Per-primitive redistribution attribution from the reshard.*
    typed events (lint/grammar.py RESHARD_EVENTS; reshard/
    primitives.execute_plan). The answer to "where did the
    reshard minutes go": per primitive (all_gather / dynamic_slice /
    collective_permute / reduce_scatter), how many steps ran and how
    much wall-clock they took to host materialization, plus how many
    whole programs executed. None when no reshard ran."""
    plans = sum(1 for e in events if e["ev"] == "reshard.plan")
    steps = [e for e in events if e["ev"] == "reshard.step"]
    dones = [e for e in events if e["ev"] == "reshard.done"]
    if not plans and not steps and not dones:
        return None
    prims: dict = {}
    order: List[str] = []
    total_s = 0.0
    for e in steps:
        p = e.get("primitive")
        if not isinstance(p, str):
            continue
        if p not in prims:
            prims[p] = {"primitive": p, "steps": 0, "wall_s": 0.0}
            order.append(p)
        prims[p]["steps"] += 1
        d = e.get("wall_s")
        if isinstance(d, (int, float)):
            prims[p]["wall_s"] += float(d)
            total_s += float(d)
    for rec in prims.values():
        rec["wall_s"] = round(rec["wall_s"], 6)
    return {"plans": plans, "programs": len(dones),
            "reshard_s": round(total_s, 6),
            "primitives": [prims[p] for p in order]}


def autoscale_summary(events: List[dict]) -> Optional[dict]:
    """Replica-count-vs-load attribution from the elastic fleet's
    typed events (lint/grammar.py AUTOSCALE_EVENTS/DRAIN_EVENTS;
    serve/autoscale.py). Per tick: how many replicas were
    active against what per-replica load; per action: scale-ups with
    their prewarm counts and scale-downs with the drain protocol's
    evidence (wait wall-clock, handed-off keys, shed count, the
    oracle verdict on the redistribution program). None when no
    autoscaler ran."""
    ticks = [e for e in events if e["ev"] == "autoscale.tick"]
    ups = [e for e in events if e["ev"] == "autoscale.up"]
    downs = [e for e in events if e["ev"] == "autoscale.down"]
    dones = [e for e in events if e["ev"] == "drain.done"]
    if not ticks and not ups and not downs and not dones:
        return None
    counts = [e["replicas"] for e in ticks
              if isinstance(e.get("replicas"), int)]
    loads = [float(e["load_per_replica"]) for e in ticks
             if isinstance(e.get("load_per_replica"), (int, float))]
    resh_by_replica = {e.get("replica"): e for e in events
                       if e["ev"] == "drain.reshard"}
    drains = []
    for e in dones:
        rec = {"replica": e.get("replica"),
               "waited_s": e.get("waited_s"),
               "keys": e.get("keys"),
               "shed": e.get("shed"), "expired": e.get("expired"),
               "reshard_ok": e.get("reshard_ok")}
        resh = resh_by_replica.get(e.get("replica"))
        if resh is not None:
            rec["program"] = resh.get("program")
            rec["reshard_s"] = resh.get("wall_s")
            rec["measured_mem_factor"] = resh.get("measured_mem_factor")
        drains.append(rec)
    out = {"ticks": len(ticks), "ups": len(ups), "downs": len(downs),
           "prewarmed": sum(int(e.get("prewarmed", 0)) for e in ups),
           "drains": drains}
    if counts:
        out["replicas_min"] = min(counts)
        out["replicas_max"] = max(counts)
    if loads:
        out["load_max"] = round(max(loads), 4)
    return out


def recovery_summary(events: List[dict]) -> Optional[dict]:
    """Crash-recovery attribution from the control plane's typed
    events (lint/grammar.py JOURNAL_EVENTS/ADOPT_EVENTS + serve.dedup;
    serve/journal.py, serve/router.adopt_fleet). Per
    recovery: the adopt.begin -> adopt.done wall clock IS the MTTR
    evidence, with the per-child verdicts (adopted vs INT-first
    reaped vs already gone) and the exactly-once record (dedup cache
    hits that answered retried keys without re-touching the device).
    None when no journal was in play."""
    begins = [e for e in events if e["ev"] == "adopt.begin"]
    dones = [e for e in events if e["ev"] == "adopt.done"]
    reps = [e for e in events if e["ev"] == "adopt.replica"]
    journal_records = sum(1 for e in events
                          if e["ev"] == "journal.record")
    replays = [e for e in events if e["ev"] == "journal.replay"]
    dedup_hits = sum(1 for e in events if e["ev"] == "serve.dedup")
    if not begins and not dones and not journal_records \
            and not replays and not dedup_hits:
        return None
    verdicts: dict = {}
    for e in reps:
        v = e.get("verdict")
        if isinstance(v, str):
            verdicts[v] = verdicts.get(v, 0) + 1
    recoveries = []
    for e in dones:
        recoveries.append({"adopted": e.get("adopted"),
                           "reaped": e.get("reaped"),
                           "mttr_s": e.get("wall_s")})
    out = {"recoveries": len(dones),
           "adopted": sum(int(e.get("adopted", 0)) for e in dones),
           "reaped": sum(int(e.get("reaped", 0)) for e in dones),
           "verdicts": verdicts,
           "journal_records": journal_records,
           "journal_replays": len(replays),
           "dedup_hits": dedup_hits}
    mttrs = [r["mttr_s"] for r in recoveries
             if isinstance(r["mttr_s"], (int, float))]
    if mttrs:
        out["mttr_max_s"] = round(max(float(m) for m in mttrs), 6)
    if recoveries:
        out["per_recovery"] = recoveries
    return out


def compile_summary(events: List[dict]) -> Optional[dict]:
    """Per-surface compile attribution from the compile observatory's
    typed events (compile.start/end, warm.* — lint/grammar.py
    COMPILE_EVENTS; obs/compile.py). The committed answer to the
    acceptance question: which surfaces compiled this window,
    cold or warm (the build directory's verdict), at what cost, and how much
    of the recorded window went to compiling at all. None when no
    instrumented compile ran."""
    ends = [e for e in events if e["ev"] == "compile.end"]
    if not ends:
        return None
    surfaces: dict = {}
    order: List[str] = []
    total_s = 0.0
    for e in ends:
        s = e.get("surface")
        if not isinstance(s, str):
            continue
        if s not in surfaces:
            surfaces[s] = {"surface": s, "count": 0, "cold_s": None,
                           "warm_s": None, "last_verdict": None,
                           "errors": 0}
        rec = surfaces[s]
        rec["count"] += 1
        d = e.get("dur_s")
        d = float(d) if isinstance(d, (int, float)) else 0.0
        total_s += d
        v = e.get("verdict")
        if v in ("cold", "warm"):
            rec[f"{v}_s"] = d
        rec["last_verdict"] = v
        if e.get("error"):
            rec["errors"] += 1
        if s not in order:
            order.append(s)
    out = {"compiles": len(ends), "compile_s": round(total_s, 6),
           "surfaces": [surfaces[s] for s in order]}
    warm_runs = sum(1 for e in events if e["ev"] == "warm.end")
    if warm_runs:
        out["warm_runs"] = warm_runs
    return out


def exec_summary(events: List[dict]) -> Optional[dict]:
    """Execution-core attribution from the exec.* typed events
    (lint/grammar.py EXEC_EVENTS; exec/core.run + exec/cost.py —
   ). Per surface: how many LaunchPlans were declared, how
    many completed (the exec.plan vs exec.done join IS the
    duplicate-launch audit the chaos suite runs), how many failed, and
    the wall-clock the core attributed to each. Plus every cost-oracle
    decision (exec.select) with its static baseline, so a regime flip
    is visible in the window record, not just in exec_decisions.json.
    None when no plan executed."""
    plans = [e for e in events if e["ev"] == "exec.plan"]
    selects = [e for e in events if e["ev"] == "exec.select"]
    launches = sum(1 for e in events if e["ev"] == "exec.launch")
    dones = [e for e in events if e["ev"] == "exec.done"]
    if not plans and not selects and not launches and not dones:
        return None
    surfaces: dict = {}
    order: List[str] = []
    total_s = 0.0
    failures = 0

    def rec_for(e: dict) -> Optional[dict]:
        s = e.get("surface")
        if not isinstance(s, str):
            return None
        if s not in surfaces:
            surfaces[s] = {"surface": s, "kind": e.get("kind"),
                           "plans": 0, "done": 0, "failed": 0,
                           "wall_s": 0.0}
            order.append(s)
        return surfaces[s]

    for e in plans:
        rec = rec_for(e)
        if rec is not None:
            rec["plans"] += 1
            if rec["kind"] is None and isinstance(e.get("kind"), str):
                rec["kind"] = e["kind"]
    for e in dones:
        rec = rec_for(e)
        if rec is None:
            continue
        rec["done"] += 1
        if e.get("ok") is False:
            rec["failed"] += 1
            failures += 1
        d = e.get("wall_s")
        if isinstance(d, (int, float)):
            rec["wall_s"] += float(d)
            total_s += float(d)
    for rec in surfaces.values():
        rec["wall_s"] = round(rec["wall_s"], 6)
    sel_rows = [{"axis": e.get("axis"), "choice": e.get("choice"),
                 "static_choice": e.get("static"),
                 "flipped": bool(e.get("flipped",
                                       e.get("choice") != e.get("static"))),
                 "reason": e.get("reason")} for e in selects]
    return {"plans": len(plans), "launches": launches,
            "done": len(dones), "failures": failures,
            "exec_s": round(total_s, 6),
            "surfaces": [surfaces[s] for s in order],
            "selects": sel_rows}


def summarize(path, events: List[dict], torn: int) -> dict:
    """The machine-readable summary JSON (bench/regen collates it into
    report.md as obs_timeline.json)."""
    sessions = [analyze_session(s) for s in split_sessions(events)]
    out = {"ledger": str(path), "events": len(events),
           "torn_lines": torn, "sessions": sessions}
    sched = sched_summary(events)
    if sched is not None:
        out["sched"] = sched
    serve = serve_summary(events)
    if serve is not None:
        out["serve"] = serve
    stream = stream_summary(events)
    if stream is not None:
        out["stream"] = stream
    coll = collective_summary(events)
    if coll is not None:
        out["collective"] = coll
    resh = reshard_summary(events)
    if resh is not None:
        out["reshard"] = resh
    auto = autoscale_summary(events)
    if auto is not None:
        out["autoscale"] = auto
    rec = recovery_summary(events)
    if rec is not None:
        out["recovery"] = rec
    comp = compile_summary(events)
    if comp is not None:
        out["compile"] = comp
    execu = exec_summary(events)
    if execu is not None:
        out["exec"] = execu
    from tpu_reductions_torch.obs import critical_path as _cp
    cp = _cp.compute(events)
    if cp is not None:
        out["critical_path"] = cp
    if events:
        t0, t1 = events[0]["t"], events[-1]["t"]
        wall = max(t1 - t0, 0.0)
        totals = dict.fromkeys(BUCKETS, 0.0)
        for s in sessions:
            for k, v in s["phases_s"].items():
                totals[k] += v
        recorded = sum(totals.values())
        out["window"] = {
            "t0": t0, "t1": t1, "wall_s": round(wall, 6),
            "recorded_s": round(recorded, 6),
            "phases_s": {k: round(v, 6) for k, v in totals.items()},
            "utilization": {k: (round(v / recorded, 4)
                                if recorded > 0 else 0.0)
                            for k, v in totals.items()},
        }
    return out


def _fmt_event(e: dict, t0: float) -> str:
    skip = {"t", "ev", "pid"}
    detail = " ".join(f"{k}={e[k]}" for k in e if k not in skip)
    return f"  T+{e['t'] - t0:9.3f}s [{e.get('pid')}] {e['ev']:<18} " \
           f"{detail}".rstrip()


def narrative(events: List[dict], torn: int, summary: dict,
              max_events: int = 400) -> str:
    """The human text report: chronological event narrative + the
    per-session attribution block."""
    lines = []
    if not events:
        return "empty ledger (no parseable events)"
    t0 = events[0]["t"]
    lines.append(f"{summary['events']} event(s), {torn} torn line(s), "
                 f"{len(summary['sessions'])} session(s), "
                 f"{summary.get('window', {}).get('wall_s', 0.0):.1f} s "
                 "recorded")
    shown = events[:max_events]
    for e in shown:
        lines.append(_fmt_event(e, t0))
    if len(events) > len(shown):
        lines.append(f"  ... {len(events) - len(shown)} more event(s) "
                     "(raise --max-events)")
    for s in summary["sessions"]:
        ph = s["phases_s"]
        util = " | ".join(f"{k} {ph[k]:.2f}s ({s['utilization'][k]:.0%})"
                          for k in BUCKETS if ph[k] > 0)
        lines.append(f"session {s['prog'] or '(shell)'} pid={s['pid']} "
                     f"T+{s['t0'] - t0:.3f}s..T+{s['t1'] - t0:.3f}s "
                     f"-> {s['end']}: {util or 'no attributed time'}; "
                     f"{s['persists']} persist(s), "
                     f"{s['reused_rows']} reused row(s), "
                     f"{s['retries']} retry(ies)")
    return "\n".join(lines)


def summary_markdown(summary: dict) -> str:
    """The per-window utilization table for WINDOW_SUMMARY.md — the
    satellite contract: the next round's summary is computed from the
    ledger, never hand-written."""
    lines = ["## window utilization (flight recorder)", ""]
    lines.append("| session | wall s | measure | compile | staging "
                 "| retry | stalled | host | end |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    for s in summary.get("sessions", []):
        u = s["utilization"]
        lines.append(
            f"| {s['prog'] or '(shell)'} (pid {s['pid']}) "
            f"| {s['wall_s']:.1f} "
            f"| {u['measure']:.0%} | {u['compile']:.0%} "
            f"| {u['staging']:.0%} | {u['retrying']:.0%} "
            f"| {u['stalled']:.0%} | {u['host']:.0%} | {s['end']} |")
    win = summary.get("window")
    if win:
        u = win["utilization"]
        lines.append("")
        lines.append(
            f"window: {win['recorded_s']:.1f} s recorded — "
            f"measure {u['measure']:.0%}, compile {u['compile']:.0%}, "
            f"staging {u['staging']:.0%}, retrying {u['retrying']:.0%}, "
            f"stalled {u['stalled']:.0%}, host {u['host']:.0%}"
            + (f"; {summary['torn_lines']} torn line(s)"
               if summary.get("torn_lines") else ""))
    cp = summary.get("critical_path")
    if cp:
        # the span tree's longest dependent chain: at every
        # instant, the DEEPEST open span holds the wall clock —
        # obs/critical_path.py has the model and the markdown
        from tpu_reductions_torch.obs.critical_path import markdown as _cp_md
        lines.append("")
        lines.extend(_cp_md(cp))
        lines.pop()     # the section's trailing blank: joined below
    sched = summary.get("sched")
    if sched:
        # the scheduler's plan-vs-actual record:
        # per task, what the planner promised vs what the window
        # delivered — skipped tasks carry their reason
        lines.append("")
        lines.append("### plan vs actual (scheduler)")
        lines.append("")
        lines.append("| task | planned s | actual s | status |")
        lines.append("|---|---|---|---|")
        for rec in sched["tasks"]:
            status = rec.get("status") or "?"
            if status == "skipped" and rec.get("reason"):
                status = f"skipped ({rec['reason']})"
            planned = rec.get("planned_s")
            actual = rec.get("actual_s")
            lines.append(
                f"| {rec['task']} "
                f"| {planned if planned is not None else '-'} "
                f"| {actual if actual is not None else '-'} "
                f"| {status} |")
        lines.append("")
        lines.append(f"{sched['replans']} replan(s)")
    serve = summary.get("serve")
    if serve:
        # the serving engine's per-request record: request
        # counts by terminal status + the latency split the respond
        # events carry
        lines.append("")
        lines.append("### serving (per-request attribution)")
        lines.append("")
        statuses = ", ".join(f"{k}: {v}" for k, v
                             in sorted(serve["by_status"].items())) \
            or "-"
        lines.append(f"{serve['requests']} request(s), "
                     f"{serve['responses']} response(s) ({statuses}); "
                     f"{serve['batches']} launch(es)"
                     + (f", mean batch {serve['mean_batch']}"
                        if serve.get("mean_batch") else "")
                     + (f", {serve['shed_episodes']} shed episode(s)"
                        if serve.get("shed_episodes") else ""))
        lat, q = serve.get("latency_s"), serve.get("queue_s")
        if lat:
            lines.append(
                f"ok latency p50 {lat['p50'] * 1e3:.2f} ms / "
                f"p99 {lat['p99'] * 1e3:.2f} ms"
                + (f"; queued p50 {q['p50'] * 1e3:.2f} ms / "
                   f"p99 {q['p99'] * 1e3:.2f} ms" if q else ""))
        if serve.get("sharded_launches"):
            lines.append(f"{serve['sharded_launches']} device-parallel "
                         "sharded launch(es)")
        router = serve.get("router")
        if router:
            # the scaling tier's record: per replica, the
            # terminal outcomes it served and the shed/error weight it
            # carried, plus what moved because a replica failed
            lines.append("")
            lines.append("### router (per-replica attribution)")
            lines.append("")
            lines.append("| replica | requests | ok | shed | error "
                         "| rerouted away | p50 ms | p99 ms |")
            lines.append("|---|---|---|---|---|---|---|---|")
            for rep in sorted(router["replicas"]):
                d = router["replicas"][rep]
                lat = d.get("latency_s")
                lines.append(
                    f"| {rep} | {d['requests']} | {d['ok']} "
                    f"| {d['shed']} | {d['error']} "
                    f"| {d.get('rerouted_away', 0)} "
                    f"| {lat['p50'] * 1e3:.2f} | {lat['p99'] * 1e3:.2f} |"
                    if lat else
                    f"| {rep} | {d['requests']} | {d['ok']} "
                    f"| {d['shed']} | {d['error']} "
                    f"| {d.get('rerouted_away', 0)} | - | - |")
            downs = router.get("replica_downs") or []
            lines.append("")
            lines.append(
                f"{router['routed']} routed, {router['reroutes']} "
                f"re-route(s), {len(downs)} replica death(s)"
                + (": " + ", ".join(
                    f"{d.get('replica')} ({d.get('reason')})"
                    for d in downs) if downs else ""))
    stream = summary.get("stream")
    if stream:
        # the streaming pipeline's record: chunk throughput,
        # honest-sync cadence, resume count, and — when the serial
        # comparator ran — the overlap-efficiency verdict
        lines.append("")
        lines.append("### streaming pipeline")
        lines.append("")
        lines.append(
            f"{stream['streams']} stream(s), {stream['chunks']} "
            f"chunk(s), {stream['syncs']} honest sync(s)"
            + (f", {stream['resumed']} resumed mid-payload"
               if stream.get("resumed") else "")
            + (f"; sustained {stream['gbps_sustained']} GB/s"
               if stream.get("gbps_sustained") is not None else "")
            + (f", {stream['chunks_per_s']} chunks/s"
               if stream.get("chunks_per_s") is not None else ""))
        if stream.get("overlap_efficiency") is not None:
            lines.append(
                f"overlap efficiency x{stream['overlap_efficiency']} "
                f"(serial {stream.get('serial_wall_s', '?')} s vs "
                f"streamed {stream.get('stream_wall_s', '?')} s)")
    coll = summary.get("collective")
    if coll:
        # the collective suite's record: per selected
        # algorithm, launches and device-phase wall-clock — the
        # collective share of the window, attributed by the registry
        # label the ONE selector picked
        lines.append("")
        lines.append("### collective (per-algorithm attribution)")
        lines.append("")
        lines.append("| algorithm | launches | wall s |")
        lines.append("|---|---|---|")
        for rec in coll["algorithms"]:
            lines.append(f"| {rec['algorithm']} | {rec['launches']} "
                         f"| {rec['wall_s']:.3f} |")
        lines.append("")
        lines.append(f"{coll['selects']} selection(s), "
                     f"{coll['launches']} launch(es), "
                     f"{coll['collective_s']:.2f} s in collective "
                     "device phases")
    resh = summary.get("reshard")
    if resh:
        # the reshard engine's record: per-primitive step
        # counts and device-phase wall-clock — which redistribution
        # move the window actually paid for
        lines.append("")
        lines.append("### reshard (per-primitive attribution)")
        lines.append("")
        lines.append("| primitive | steps | wall s |")
        lines.append("|---|---|---|")
        for rec in resh["primitives"]:
            lines.append(f"| {rec['primitive']} | {rec['steps']} "
                         f"| {rec['wall_s']:.3f} |")
        lines.append("")
        lines.append(f"{resh['plans']} plan(s), "
                     f"{resh['programs']} program(s) executed, "
                     f"{resh['reshard_s']:.2f} s in reshard device "
                     "phases")
    auto = summary.get("autoscale")
    if auto:
        # the elastic fleet's record: replica count vs
        # load across the window + per-drain protocol evidence — the
        # committed proof that planned scale-down sheds nothing
        lines.append("")
        lines.append("### elastic fleet (replica count vs load)")
        lines.append("")
        span = (f"replicas {auto['replicas_min']}.."
                f"{auto['replicas_max']}"
                if auto.get("replicas_max") is not None else "replicas ?")
        lines.append(
            f"{auto['ticks']} control tick(s), {span}, "
            f"{auto['ups']} scale-up(s) "
            f"({auto['prewarmed']} key(s) prewarmed), "
            f"{auto['downs']} planned drain(s)"
            + (f"; peak load/replica {auto['load_max']}"
               if auto.get("load_max") is not None else ""))
        if auto["drains"]:
            lines.append("")
            lines.append("| drained replica | waited s | keys handed "
                         "| shed | expired | reshard |")
            lines.append("|---|---|---|---|---|---|")
            for d in auto["drains"]:
                waited = d.get("waited_s")
                resh_cell = "-"
                if d.get("program"):
                    ok = "ok" if d.get("reshard_ok") else "FAILED"
                    resh_cell = (f"{d['program']} ({ok}, mem x"
                                 f"{d.get('measured_mem_factor')})")
                elif d.get("reshard_ok"):
                    resh_cell = "ok"
                lines.append(
                    f"| {d['replica']} "
                    f"| {waited if waited is not None else '-'} "
                    f"| {d.get('keys', '-')} | {d.get('shed', '-')} "
                    f"| {d.get('expired', '-')} | {resh_cell} |")
    rec = summary.get("recovery")
    if rec:
        # the crash-consistent control plane's record:
        # per-recovery MTTR from the adopt.begin -> adopt.done wall
        # clock, the per-child adoption verdicts, and the dedup-cache
        # hits that made router retries exactly-once
        lines.append("")
        lines.append("### crash recovery (journal / adoption / dedup)")
        lines.append("")
        verdicts = ", ".join(f"{k}: {v}" for k, v
                             in sorted(rec["verdicts"].items())) or "-"
        lines.append(
            f"{rec['recoveries']} recovery(ies), "
            f"{rec['adopted']} replica(s) adopted, "
            f"{rec['reaped']} reaped ({verdicts}); "
            f"{rec['journal_records']} journal record(s), "
            f"{rec['journal_replays']} replay(s), "
            f"{rec['dedup_hits']} dedup hit(s)"
            + (f"; MTTR <= {rec['mttr_max_s']:.3f} s"
               if rec.get("mttr_max_s") is not None else ""))
        if rec.get("per_recovery"):
            lines.append("")
            lines.append("| recovery | adopted | reaped | MTTR s |")
            lines.append("|---|---|---|---|")
            for i, r in enumerate(rec["per_recovery"]):
                mttr = r.get("mttr_s")
                lines.append(
                    f"| {i} | {r.get('adopted', '-')} "
                    f"| {r.get('reaped', '-')} "
                    f"| {f'{mttr:.3f}' if isinstance(mttr, (int, float)) else '-'} |")
    comp = summary.get("compile")
    if comp:
        # the compile observatory's record: per-surface
        # cold/warm compile latency + the compile share of the window —
        # the axis the window planner was blind on
        lines.append("")
        lines.append("### compile observatory (per-surface cold/warm)")
        lines.append("")
        lines.append("| surface | cold s | warm s | last verdict "
                     "| compiles |")
        lines.append("|---|---|---|---|---|")
        for rec in comp["surfaces"]:
            cold = rec.get("cold_s")
            warm_v = rec.get("warm_s")
            lines.append(
                f"| {rec['surface']} "
                f"| {f'{cold:.3f}' if cold is not None else '-'} "
                f"| {f'{warm_v:.3f}' if warm_v is not None else '-'} "
                f"| {rec.get('last_verdict') or '?'} "
                f"| {rec['count']}"
                + (f" ({rec['errors']} error(s))" if rec["errors"]
                   else "") + " |")
        recorded = summary.get("window", {}).get("recorded_s") or 0.0
        share = (f", {comp['compile_s'] / recorded:.0%} of the "
                 "recorded window" if recorded > 0 else "")
        lines.append("")
        lines.append(f"{comp['compiles']} instrumented compile(s), "
                     f"{comp['compile_s']:.2f} s total{share}"
                     + (f"; {comp['warm_runs']} warming pass(es)"
                        if comp.get("warm_runs") else ""))
    execu = summary.get("exec")
    if execu:
        # the execution core's record: per-surface plan/done
        # counts (the duplicate-launch audit is this join) + the
        # cost-oracle decisions with their static baselines
        lines.append("")
        lines.append("### execution core (per-surface LaunchPlan "
                     "attribution)")
        lines.append("")
        lines.append("| surface | kind | plans | done | failed "
                     "| wall s |")
        lines.append("|---|---|---|---|---|---|")
        for rec in execu["surfaces"]:
            lines.append(
                f"| {rec['surface']} | {rec.get('kind') or '?'} "
                f"| {rec['plans']} | {rec['done']} | {rec['failed']} "
                f"| {rec['wall_s']:.3f} |")
        lines.append("")
        lines.append(f"{execu['plans']} plan(s), {execu['launches']} "
                     f"launch(es), {execu['done']} completed, "
                     f"{execu['failures']} failure(s), "
                     f"{execu['exec_s']:.2f} s in planned device work")
        if execu["selects"]:
            lines.append("")
            lines.append("| decision axis | chosen | static pick "
                         "| flipped | why |")
            lines.append("|---|---|---|---|---|")
            for sel in execu["selects"]:
                lines.append(
                    f"| {sel.get('axis') or '?'} "
                    f"| {sel.get('choice') or '?'} "
                    f"| {sel.get('static_choice') or '?'} "
                    f"| {'YES' if sel.get('flipped') else 'no'} "
                    f"| {sel.get('reason') or '-'} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI: reconstruct the session timeline from a ledger (module
    docstring). Exit 0 with events, 1 on an empty/absent ledger."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.obs.timeline",
        description="Post-mortem timeline + window-utilization metrics "
                    "from a flight-recorder ledger")
    p.add_argument("ledger", help="JSONL event ledger (obs/ledger.py)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the machine-readable summary here "
                        "(atomic; bench/regen collates it)")
    p.add_argument("--summary-md", action="store_true",
                   help="print ONLY the WINDOW_SUMMARY.md utilization "
                        "table")
    p.add_argument("--quiet", action="store_true",
                   help="no stdout (use with --json from scripts)")
    p.add_argument("--max-events", type=int, default=400,
                   help="narrative event cap (default 400)")
    ns = p.parse_args(argv)
    try:
        events, torn = read_ledger(ns.ledger)
    except OSError as e:
        print(f"timeline: cannot read {ns.ledger}: {e}",
              file=sys.stderr)
        return 1
    summary = summarize(ns.ledger, events, torn)
    if ns.json_out:
        from tpu_reductions_torch.utils.jsonio import atomic_json_dump
        atomic_json_dump(ns.json_out, summary)
    if ns.quiet:
        pass
    elif ns.summary_md:
        print(summary_markdown(summary))
    else:
        print(narrative(events, torn, summary,
                        max_events=ns.max_events))
        print()
        print(summary_markdown(summary))
    return 0 if events else 1


if __name__ == "__main__":
    sys.exit(main())
