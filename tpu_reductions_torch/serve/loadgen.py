"""The load generator: the closed-loop serving curve, the open-loop
scaling grid, the elastic fleet and the crash-recovery instrument.

The counterpart of tpu_reductions/serve/loadgen.py, whole. Closed loop: N
client threads each submit, wait and submit again (concurrency =
clients); a run distills into requests/s and p50/p99 at N clients,
`coalesced` against `sequential` (max_batch 1) on the same workload. Each
in-process row also carries what the engine and its executor did in the
measured window: `batches`, `launches` (serve-bucket launches) and
`seconds` (the executor's host seconds of fill, stack, copy, reduce and
verify). Open loop: `open_arrivals` (poisson, bursty, diurnal),
`plan_workload` (same seed, identical plan) and `run_open_load` (dispatch
at the planned offsets, completion by callback), which the fleet modes
build on:

  --scale      `sequential` / `coalesced` / `routerN` (N LocalReplica
               engines behind serve/router.py) over one seeded workload
               at each client count, poisson and bursty, and one
               `sharded` row: an oversized request through the engine's
               shard route over --devices ranks, its collective choice
               read back from the ledger and the host seconds of its
               fill, fold, combine and verify (`seconds`);
  --elastic    an autoscaled fleet (serve/autoscale.py) tracking the
               seeded --plan=diurnal shape at each client count, then
               the drain-versus-kill pair on one seeded mid-burst
               workload behind a relay of at least 25 ms a launch;
  --recovery   kill-router (a real `serve.router --journal` subprocess
               over ProcessReplica children, killed by the scripted
               `router.crash` exit and restarted on the same journal),
               kill-replica and drain on one idem-keyed workload: MTTR,
               shed and ledger-joined duplicate device executions.

On the card the replicas share one H100 (docs/PORT.md "The fleet on one
card"): LocalReplica engines are worker threads, ProcessReplica children
processes with CUDA contexts of their own. --launch-latency-ms models a
launch's round trip through the chaos relay (faults/relay.py); a card has
no tunnel, so it defaults to 0 here (the JAX CLI's default is 2).

Artifacts have the bench/resume.Checkpoint shape ({meta, complete,
rows}), a row persisted as it lands and resumed from an artifact left
incomplete; bench/regen folds them (`curve_markdown`, `scale_markdown`,
`elastic_markdown`, `recovery_markdown`).

CLI:
    python -m tpu_reductions_torch.serve.loadgen [--platform=cpu] \
        [--clients=8 --requests=32 --n=65536 --methods=SUM,MIN,MAX \
         --type=int] [--connect HOST:PORT] [--out=out/serving_curve.json]
    python -m tpu_reductions_torch.serve.loadgen --scale [--devices=8 \
        --replicas=4 --scale-clients=64,256,1024 --seed=0] --out=...
    python -m tpu_reductions_torch.serve.loadgen --elastic [--devices=8 \
        --plan=diurnal] --out=...
    python -m tpu_reductions_torch.serve.loadgen --recovery \
        [--recovery-requests=48 --crash-after=16] --out=...
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_reductions_torch.config import DTYPE_ALIASES, METHODS, PLATFORMS


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        raise ValueError("percentile of empty sample")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _client_loop(submit, client: int, requests: int, methods: List[str],
                 dtype: str, n: int, deadline_s: Optional[float],
                 out: List[dict], barrier: threading.Barrier,
                 seed: int) -> None:
    from tpu_reductions_torch.serve.request import ReduceRequest
    barrier.wait()
    for i in range(requests):
        # wave-aligned mix: in a closed loop the clients advance in
        # rough lockstep, so indexing by i alone gives each wave ONE
        # method — the concurrency shape coalescing exists for (a
        # per-client offset would guarantee mixed keys every wave and
        # measure the scheduler instead of the batcher)
        req = ReduceRequest(method=methods[i % len(methods)],
                            dtype=dtype, n=n,
                            seed=seed * 1000003 + client * 100003 + i,
                            deadline_s=deadline_s)
        t0 = time.monotonic()
        try:
            resp = submit(req)
        except Exception as e:              # a client error is a row,
            out.append({"status": "client-error",   # never a crash
                        "latency_s": time.monotonic() - t0,
                        "error": f"{type(e).__name__}: {e}"})
            continue
        # the request id is the request's trace id: stamped through the
        # response path so rows join the ledger's serve.enqueue/respond
        # events by id, never positionally
        out.append({"req": resp.request_id,
                    "status": resp.status,
                    "latency_s": (resp.latency_s
                                  if resp.latency_s is not None
                                  else time.monotonic() - t0),
                    "batch_size": resp.batch_size})


def run_load(submit, *, clients: int, requests: int, methods: List[str],
             dtype: str, n: int, deadline_s: Optional[float] = None,
             seed: int = 0) -> dict:
    """Drive the closed loop; `submit(req) -> ReduceResponse` is either
    the in-process engine (resolved PendingResponse) or the TCP client.
    Returns the raw per-mode measurement (one curve row, mode-less)."""
    per_client: List[List[dict]] = [[] for _ in range(clients)]
    barrier = threading.Barrier(clients + 1)
    threads = [threading.Thread(
        target=_client_loop,
        args=(submit, c, requests, methods, dtype, n, deadline_s,
              per_client[c], barrier, seed), daemon=True)
        for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    wall = max(time.monotonic() - t0, 1e-9)
    rows = [r for recs in per_client for r in recs]
    return {"clients": clients, **_distill(rows, wall)}


def _distill(rows: List[dict], wall: float) -> dict:
    """One curve/scale row from per-request records (shared by the
    closed and open loops so the two artifacts' columns line up)."""
    by_status: Dict[str, int] = {}
    for r in rows:
        by_status[r["status"]] = by_status.get(r["status"], 0) + 1
    ok_lat = sorted(r["latency_s"] for r in rows
                    if r["status"] == "ok"
                    and isinstance(r.get("latency_s"), (int, float)))
    sizes = [r["batch_size"] for r in rows
             if isinstance(r.get("batch_size"), int)]
    row = {
        "requests": len(rows),
        "wall_s": round(wall, 6),
        "rps": round(len(rows) / wall, 2),
        "ok": by_status.get("ok", 0),
        "by_status": by_status,
        "mean_batch": (round(sum(sizes) / len(sizes), 2)
                       if sizes else None),
    }
    if ok_lat:
        row["p50_ms"] = round(percentile(ok_lat, 0.50) * 1e3, 3)
        row["p99_ms"] = round(percentile(ok_lat, 0.99) * 1e3, 3)
    return row


# --------------------------------------------------------------------------
# Open loop: seeded arrival processes + callback completion
# --------------------------------------------------------------------------

# the seeded time-varying arrival plan (the fleet's --plan=diurnal):
# ramp + burst epochs composed from the poisson/bursty processes —
# (name, fraction of count, rate factor vs the base rate, process).
# The elastic curve drives THIS shape so the autoscaler has real
# scale-up (burst, peak) and scale-down (ebb, tail) signals to track.
DIURNAL_EPOCHS = (
    ("ramp", 0.20, 0.25, "poisson"),
    ("burst", 0.20, 2.00, "bursty"),
    ("ebb", 0.20, 0.25, "poisson"),
    ("peak", 0.20, 1.50, "bursty"),
    ("tail", 0.20, 0.25, "poisson"),
)
# total plan duration in units of count/base_rate: sum(frac / factor)
# over the epochs; the elastic mode sizes base_rate from this so that a
# cell spans --elastic-seconds of wall clock
DIURNAL_TIME_FACTOR = sum(f / r for _, f, r, _ in DIURNAL_EPOCHS)


def diurnal_epoch_counts(count: int) -> List[int]:
    """Per-epoch arrival counts for a `count`-arrival diurnal plan:
    floor(frac * count) each, remainder into the last epoch — so the
    composition is exact and deterministic for any count."""
    counts = [int(frac * count) for _, frac, _, _ in DIURNAL_EPOCHS]
    counts[-1] += count - sum(counts)
    return counts


def open_arrivals(rng: random.Random, *, count: int, rate_rps: float,
                  process: str = "poisson",
                  burst: int = 32) -> List[float]:
    """`count` arrival offsets (seconds from t0) drawn from the named
    process at aggregate `rate_rps`:

      * poisson — i.i.d. exponential gaps (the memoryless open-loop
        default);
      * bursty  — Poisson BURST epochs, `burst` back-to-back arrivals
        each (same long-run rate, pathological short-run concurrency —
        the coalescing window's stress shape);
      * diurnal — the DIURNAL_EPOCHS composition (ramp -> burst ->
        ebb -> peak -> tail), each epoch its own poisson/bursty
        process at `rate_rps` x the epoch's factor, time offsets
        accumulated across epochs — deterministic per rng state like
        the primitives it composes.
    """
    if count <= 0 or rate_rps <= 0:
        raise ValueError("count and rate_rps must be positive")
    offsets: List[float] = []
    t = 0.0
    if process == "poisson":
        for _ in range(count):
            t += rng.expovariate(rate_rps)
            offsets.append(t)
    elif process == "bursty":
        while len(offsets) < count:
            t += rng.expovariate(rate_rps / burst)
            offsets.extend([t] * min(burst, count - len(offsets)))
    elif process == "diurnal":
        for (_, _, factor, proc), k in zip(DIURNAL_EPOCHS,
                                           diurnal_epoch_counts(count)):
            if k <= 0:
                continue
            sub = open_arrivals(rng, count=k,
                                rate_rps=rate_rps * factor,
                                process=proc, burst=burst)
            offsets.extend(t + o for o in sub)
            t = offsets[-1]
    else:
        raise ValueError(f"unknown arrival process {process!r} "
                         "(poisson|bursty|diurnal)")
    return offsets


def plan_workload(seed: int, *, count: int, methods: Sequence[str],
                  dtype: str, n_choices: Sequence[int],
                  rate_rps: float, process: str = "poisson",
                  burst: int = 32, deadline_s: Optional[float] = None,
                  slo: Optional[str] = None) -> List[Tuple]:
    """The seeded open-loop plan: `count` (offset_s, ReduceRequest)
    pairs, fully determined by `seed` (same seed -> identical offsets
    AND request specs), so every series
    of a scaling run replays the SAME workload. `slo` stamps every
    request with that SLO class (the elastic mode's p99 contract)."""
    from tpu_reductions_torch.serve.request import ReduceRequest
    rng = random.Random(seed)
    offsets = open_arrivals(rng, count=count, rate_rps=rate_rps,
                            process=process, burst=burst)
    plan = []
    for off in offsets:
        plan.append((off, ReduceRequest(
            method=rng.choice(list(methods)), dtype=dtype,
            n=rng.choice(list(n_choices)),
            seed=rng.randrange(1 << 30), deadline_s=deadline_s,
            slo=slo)))
    return plan


def run_open_load(submit_async, plan: List[Tuple], *,
                  timeout_s: float = 600.0) -> dict:
    """Dispatch the planned arrivals at their offsets regardless of
    completions (open loop) and collect terminal outcomes via
    `PendingResponse.add_done_callback` — one dispatcher thread total,
    so 1000+ clients are cheap. `submit_async(req)` must return a
    PendingResponse (ServeEngine.submit or ReplicaRouter.submit).
    Latency per request = dispatch-to-resolution wall clock."""
    rows: List[dict] = []
    lock = threading.Lock()
    done = threading.Event()
    remaining = [len(plan)]
    t_last = [0.0]

    def _record(resp, t_sub):
        now = time.monotonic()
        with lock:
            rows.append({"req": resp.request_id, "status": resp.status,
                         "latency_s": now - t_sub,
                         "batch_size": resp.batch_size})
            t_last[0] = max(t_last[0], now)
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()

    t0 = time.monotonic()
    for off, req in plan:
        delay = t0 + off - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t_sub = time.monotonic()
        try:
            pending = submit_async(req)
        except Exception as e:
            _record(type("R", (), {"request_id": "?",
                                   "status": "client-error",
                                   "batch_size": None,
                                   "error": str(e)})(), t_sub)
            continue
        pending.add_done_callback(
            lambda resp, ts=t_sub: _record(resp, ts))
    if not done.wait(timeout_s):
        raise TimeoutError(f"open loop: {remaining[0]} of {len(plan)} "
                           f"requests unresolved after {timeout_s}s — "
                           "the no-hang contract is broken upstream")
    wall = max(t_last[0] - t0, 1e-9)
    with lock:
        return _distill(list(rows), wall)


def curve_markdown(artifact: dict) -> str:
    """The report.md section bench/regen.py appends: the serving curve
    next to the GB/s tables."""
    lines = ["## serving under concurrent load (requests/s, latency)",
             ""]
    meta = ", ".join(f"{k}={artifact[k]}"
                     for k in ("dtype", "n", "methods", "platform",
                               "launch_latency_ms")
                     if artifact.get(k) is not None)
    if meta:
        lines += [f"workload: {meta}", ""]
    lines.append("| mode | clients | requests | req/s | p50 ms "
                 "| p99 ms | mean batch | ok | other |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    rows = {r.get("mode"): r for r in artifact.get("rows", [])
            if isinstance(r, dict)}
    for mode, r in rows.items():
        other = ", ".join(f"{k}:{v}"
                          for k, v in sorted(r.get("by_status",
                                                   {}).items())
                          if k != "ok") or "-"
        lines.append(
            f"| {mode} | {r.get('clients', '-')} "
            f"| {r.get('requests', '-')} | {r.get('rps', '-')} "
            f"| {r.get('p50_ms', '-')} | {r.get('p99_ms', '-')} "
            f"| {r.get('mean_batch', '-')} | {r.get('ok', '-')} "
            f"| {other} |")
    co, seq = rows.get("coalesced"), rows.get("sequential")
    if co and seq and seq.get("rps"):
        lines += ["", f"coalescing speedup: "
                      f"{co['rps'] / seq['rps']:.2f}x requests/s "
                      "(same workload, same executor, batch size 1 vs "
                      "coalesced)"]
    return "\n".join(lines)


def scale_markdown(artifact: dict) -> str:
    """The report.md section for the open-loop scaling curve
    (bench/regen.py folds it next to the closed-loop serving curve)."""
    lines = ["## serving scale-out (open loop: requests/s and latency "
             "vs clients)", ""]
    meta = ", ".join(f"{k}={artifact[k]}"
                     for k in ("dtype", "methods", "n_choices",
                               "replicas", "seed", "launch_latency_ms",
                               "platform")
                     if artifact.get(k) is not None)
    if meta:
        lines += [f"workload: {meta}", ""]
    rows = [r for r in artifact.get("rows", []) if isinstance(r, dict)]
    grid = [r for r in rows if r.get("series") != "sharded"]
    if grid:
        lines.append("| series | clients | process | req/s | p50 ms "
                     "| p99 ms | ok | other |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for r in sorted(grid, key=lambda r: (r.get("process", ""),
                                             r.get("clients", 0),
                                             r.get("series", ""))):
            other = ", ".join(
                f"{k}:{v}" for k, v in sorted(r.get("by_status",
                                                    {}).items())
                if k != "ok") or "-"
            lines.append(
                f"| {r.get('series', '-')} | {r.get('clients', '-')} "
                f"| {r.get('process', '-')} | {r.get('rps', '-')} "
                f"| {r.get('p50_ms', '-')} | {r.get('p99_ms', '-')} "
                f"| {r.get('ok', '-')} | {other} |")
    by_key = {r.get("key"): r for r in grid}
    router_series = sorted({r["series"] for r in grid
                            if str(r.get("series", "")).startswith(
                                "router")})
    for rs in router_series:
        # the 1-vs-N record at every client count both series ran (one
        # line per count: the scaling story, not a cherry-picked point)
        for clients in sorted({r.get("clients") for r in grid
                               if isinstance(r.get("clients"), int)}):
            ro = by_key.get(f"{rs}@{clients}@poisson")
            co = by_key.get(f"coalesced@{clients}@poisson")
            if ro and co and co.get("rps"):
                lines += ["", f"replica scale-out at {clients} "
                              f"open-loop clients: {rs} serves "
                              f"{ro['rps'] / co['rps']:.2f}x the "
                              "single coalesced engine's requests/s "
                              "(same seeded workload, same shared "
                              "slow relay)"]
    sh = next((r for r in rows if r.get("series") == "sharded"), None)
    if sh:
        mib = (sh.get("nbytes") or 0) / (1 << 20)
        lines += ["", f"device-parallel sharded row: n={sh.get('n')} "
                      f"({mib:.0f} MiB, over the "
                      f"{sh.get('shard_threshold_mib', 512):.0f} MiB "
                      f"shard threshold) -> status={sh.get('status')} "
                      f"via algorithm={sh.get('algorithm')} on "
                      f"{sh.get('devices')} devices "
                      f"(collective.select in the armed ledger; "
                      f"latency {sh.get('latency_s')}s)"]
    return "\n".join(lines)


def _run_scale(ns, methods: List[str]) -> int:
    """`--scale`: the open-loop scaling grid and the sharded row (module
    docstring). One shared slow relay, when --launch-latency-ms asks for
    one, gates every series."""
    from tpu_reductions_torch.bench.resume import Checkpoint
    from tpu_reductions_torch.obs import ledger
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.executor import BatchExecutor
    from tpu_reductions_torch.serve.request import ReduceRequest
    from tpu_reductions_torch.serve.router import local_router

    n_choices = (max(1024, ns.n // 2), ns.n, ns.n * 2)
    counts = sorted({int(c) for c in ns.scale_clients.split(",")
                     if c.strip()})
    series_router = f"router{ns.replicas}"
    meta = {"instrument": "serving_scale",
            "dtype": DTYPE_ALIASES[ns.dtype], "methods": ",".join(methods),
            "n_choices": list(n_choices), "replicas": ns.replicas,
            "seed": ns.seed, "rate_factor": ns.rate_factor,
            "burst": ns.burst,
            "launch_latency_ms": ns.launch_latency_ms,
            "platform": ns.platform}
    ck = Checkpoint(ns.out, meta, key_fn=lambda r: r.get("key"))

    relay = None
    if ns.launch_latency_ms > 0:
        from tpu_reductions_torch.faults.relay import FakeRelay
        from tpu_reductions_torch.faults.schedule import Phase
        relay = FakeRelay([Phase("slow",
                                 delay_s=ns.launch_latency_ms / 1e3)])
        relay.start()

    def _transport():
        if relay is None:
            return None
        from tpu_reductions_torch.serve.transport import RelayTransport
        return RelayTransport(ports=(relay.port,), assume_tunneled=True,
                              drain=True)

    def _prewarm(engines, up_to_batch):
        for e in engines:
            for m in methods:
                for n in n_choices:
                    e.prewarm(m, ns.dtype, n, up_to_batch=up_to_batch)

    # grid: every series at every client count (poisson), plus the
    # bursty stress rows at the middle count for the batched series
    cells = [(s, c, "poisson") for c in counts
             for s in ("sequential", "coalesced", series_router)]
    mid = counts[len(counts) // 2] if counts else 0
    cells += [(s, mid, "bursty") for s in ("coalesced", series_router)]
    try:
        for series, clients, process in cells:
            key = f"{series}@{clients}@{process}"
            prior = ck.resume(key,
                              reusable=lambda r: bool(r.get("requests")))
            if prior is not None:
                print(f"scale {key}: resumed from prior artifact",
                      file=sys.stderr)
                ck.add(prior)
                continue
            # same (seed, clients, process) -> same plan for EVERY
            # series: the 1-vs-N comparison replays one workload
            plan_seed = (ns.seed * 1_000_003 + clients * 31
                         + (1 if process == "bursty" else 0))
            plan = plan_workload(
                plan_seed, count=clients, methods=methods,
                dtype=ns.dtype, n_choices=n_choices,
                rate_rps=ns.rate_factor * clients, process=process,
                burst=ns.burst)
            common = dict(max_queue=max(2048, 2 * clients),
                          device_window_s=ns.device_window_ms / 1e3,
                          platform=ns.platform)
            if series == "sequential":
                target = ServeEngine(max_batch=1, coalesce_window_s=0.0,
                                     transport=_transport(),
                                     **common).start()
                submit_async, engines = target.submit, [target]
                batch = 1
            elif series == "coalesced":
                target = ServeEngine(max_batch=ns.max_batch,
                                     coalesce_window_s=0.0,
                                     transport=_transport(),
                                     **common).start()
                submit_async, engines = target.submit, [target]
                batch = ns.max_batch
            else:
                target = local_router(
                    ns.replicas,
                    engine_kwargs=dict(max_batch=ns.max_batch,
                                       coalesce_window_s=0.0,
                                       transports=[_transport()
                                                   for _ in
                                                   range(ns.replicas)],
                                       **common)).start()
                submit_async = target.submit
                engines = target.replicas
                batch = ns.max_batch
            _prewarm(engines, min(batch, 8))
            row = run_open_load(submit_async, plan, timeout_s=900)
            target.stop()
            ck.add({"key": key, "series": series, "clients": clients,
                    "process": process, **row})
            print(f"scale {key}: rps={row.get('rps')} "
                  f"p99_ms={row.get('p99_ms')}", file=sys.stderr)

        # the device-parallel sharded row: one oversized request
        # through the engine's shard path, algorithm choice read back
        # from the armed ledger's collective.select event
        prior = ck.resume("sharded",
                          reusable=lambda r: r.get("status") == "ok")
        if prior is not None:
            ck.add(prior)
        elif not ns.skip_sharded:
            ledger_path = ledger.arm(None)
            if ledger_path is None and ns.out:
                ledger_path = ledger.arm(ns.out + ".ledger.jsonl")
            req = ReduceRequest("SUM", "int", ns.sharded_n,
                                seed=ns.seed)
            shard_ex = BatchExecutor(ns.platform,
                                     ranks=ns.num_devices or 1)
            engine = ServeEngine(max_queue=8, max_batch=4,
                                 transport=_transport(),
                                 executor=shard_ex,
                                 platform=ns.platform).start()
            resp = engine.submit(req).result(timeout=900)
            engine.stop()
            row = {"key": "sharded", "series": "sharded",
                   "status": resp.status, "n": req.n,
                   "nbytes": req.nbytes,
                   "shard_threshold_mib":
                       engine._shard_threshold / (1 << 20),
                   "result": resp.result, "error": resp.error,
                   "latency_s": resp.latency_s,
                   # the host seconds of the sharded request's steps
                   # (executor.last_shard): fill, fold, combine, verify
                   "seconds": ({k: round(v, 6)
                                for k, v in shard_ex.last_shard.items()}
                               if shard_ex.last_shard else None)}
            row.update(_sharded_evidence(ledger_path))
            ck.add(row)
    finally:
        if relay is not None:
            relay.stop()
    if ns.out:
        ck.finalize()
    artifact = {**meta, "rows": ck.rows}
    print(scale_markdown(artifact))
    if ns.out:
        print(f"wrote {ns.out}")
    return 0


def _sharded_evidence(ledger_path: Optional[str]) -> dict:
    """Pull the sharded launch's algorithm choice back out of the
    armed ledger (collective.select / serve.verify events) so the
    committed artifact row carries the evidence pointer inline."""
    out: dict = {"ledger": ledger_path}
    if not ledger_path or not os.path.exists(ledger_path):
        return out
    try:
        with open(ledger_path) as f:
            for line in f:
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if ev.get("ev") == "collective.select":
                    out["algorithm"] = ev.get("algorithm")
                    out["wire_factor"] = ev.get("wire_factor")
                    out["quantized"] = ev.get("quantized")
                    out["ranks"] = ev.get("ranks")
                elif ev.get("ev") == "serve.verify":
                    if ev.get("devices") is not None:
                        out["devices"] = ev.get("devices")
    except OSError:
        pass
    return out


def elastic_markdown(artifact: dict) -> str:
    """The report.md section for the elastic fleet (bench/regen.py
    folds it after the scaling curve): replica trajectory per cell +
    the drain-vs-kill contract line."""
    lines = ["## elastic serving fleet (autoscaler tracking the "
             "diurnal plan)", ""]
    meta = ", ".join(f"{k}={artifact[k]}"
                     for k in ("plan", "slo_s", "autoscale_min",
                               "autoscale_max", "cooldown_s", "seed",
                               "platform")
                     if artifact.get(k) is not None)
    if meta:
        lines += [f"config: {meta}", ""]
    rows = [r for r in artifact.get("rows", []) if isinstance(r, dict)]
    cells = [r for r in rows if str(r.get("key", "")).startswith(
        "elastic@")]
    if cells:
        lines.append("| clients | req/s | p99 ms | in SLO | replicas "
                     "min..max | ups | downs | ok | other |")
        lines.append("|---|---|---|---|---|---|---|---|---|")
        for r in sorted(cells, key=lambda r: r.get("clients", 0)):
            other = ", ".join(
                f"{k}:{v}" for k, v in sorted(r.get("by_status",
                                                    {}).items())
                if k != "ok") or "-"
            lines.append(
                f"| {r.get('clients', '-')} | {r.get('rps', '-')} "
                f"| {r.get('p99_ms', '-')} "
                f"| {'yes' if r.get('p99_in_slo') else 'NO'} "
                f"| {r.get('replicas_min', '-')}.."
                f"{r.get('replicas_max', '-')} "
                f"| {r.get('scale_ups', '-')} "
                f"| {r.get('scale_downs', '-')} "
                f"| {r.get('ok', '-')} | {other} |")
    dr = next((r for r in rows if r.get("key") == "drain"), None)
    kl = next((r for r in rows if r.get("key") == "kill"), None)
    if dr and kl:
        rs = dr.get("reshard") or {}
        lines += ["", "drain-vs-kill on the same seeded mid-burst "
                      "workload: planned drain shed "
                      f"{dr.get('victim_shed')} requests (redistribution "
                      f"program {rs.get('program')} oracle-verified="
                      f"{rs.get('ok')}, measured peak-memory factor "
                      f"{rs.get('measured_mem_factor')} <= declared "
                      f"{rs.get('mem_factor')}); SIGKILL shed "
                      f"{kl.get('victim_shed')} in-flight requests the "
                      "router had to re-route"]
    return "\n".join(lines)


def _compress_trajectory(history: List[dict],
                         keep_every: int = 10) -> List[dict]:
    """The committed replica-count-vs-load trajectory: every tick that
    acted (or changed the replica count) plus every `keep_every`-th
    hold tick — bounded, but the scale-up/down story stays intact."""
    if not history:
        return []
    t0 = history[0].get("t", 0.0)
    out = []
    last_n = None
    for i, rec in enumerate(history):
        act = rec.get("action") != "hold"
        changed = rec.get("replicas") != last_n
        if act or changed or i % keep_every == 0 \
                or i == len(history) - 1:
            out.append({"t": round(rec.get("t", t0) - t0, 3),
                        "replicas": rec.get("replicas"),
                        "load": rec.get("load_per_replica"),
                        "queued": rec.get("queued"),
                        "action": rec.get("action")})
        last_n = rec.get("replicas")
    return out


def _run_elastic(ns, methods: List[str]) -> int:
    """`--elastic`: the elastic-fleet curve. Per client
    count, an autoscaled LocalReplica fleet (serve/autoscale.py)
    tracks the seeded --plan arrival shape — replica count must
    follow load while p99 stays inside the declared SLO — then the
    drain-vs-kill pair retires a replica mid-burst both ways on one
    seeded workload: the planned drain's victim sheds ZERO requests
    (warm keys handed off, partials resharded under the declared
    peak-memory bound, oracle-verified), the SIGKILL control's victim
    sheds its queue."""
    from tpu_reductions_torch.bench.resume import Checkpoint
    from tpu_reductions_torch.serve.autoscale import Autoscaler, drain_replica
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.executor import BatchExecutor
    from tpu_reductions_torch.serve.router import LocalReplica, local_router
    from tpu_reductions_torch import config as cfg

    n_choices = (max(1024, ns.n // 2), ns.n, ns.n * 2)
    counts = sorted({int(c) for c in ns.scale_clients.split(",")
                     if c.strip()})
    amin = cfg.autoscale_min(ns.autoscale_min)
    amax = cfg.autoscale_max(ns.autoscale_max)
    # flag > env > the CELL-scale default: an 8-second plan needs a
    # sub-second cooldown, not config.py's live-fleet 5 s
    cooldown = (ns.autoscale_cooldown_s
                if ns.autoscale_cooldown_s is not None
                else cfg._env_float("TPU_REDUCTIONS_AUTOSCALE_COOLDOWN_S"))
    if cooldown is None:
        cooldown = 0.75
    meta = {"instrument": "serving_elastic", "plan": ns.plan,
            "dtype": DTYPE_ALIASES[ns.dtype],
            "methods": ",".join(methods),
            "n_choices": list(n_choices), "seed": ns.seed,
            "slo_s": ns.slo_s, "autoscale_min": amin,
            "autoscale_max": amax, "cooldown_s": cooldown,
            "elastic_seconds": ns.elastic_seconds,
            "launch_latency_ms": ns.launch_latency_ms,
            "platform": ns.platform}
    ck = Checkpoint(ns.out, meta, key_fn=lambda r: r.get("key"))

    relay = None
    if ns.launch_latency_ms > 0:
        from tpu_reductions_torch.faults.relay import FakeRelay
        from tpu_reductions_torch.faults.schedule import Phase
        relay = FakeRelay([Phase("slow",
                                 delay_s=ns.launch_latency_ms / 1e3)])
        relay.start()

    def _transport():
        if relay is None:
            return None
        from tpu_reductions_torch.serve.transport import RelayTransport
        return RelayTransport(ports=(relay.port,), assume_tunneled=True,
                              drain=True)

    # the drains' reshard runs on this executor's ranks (--devices)
    executor = BatchExecutor(ns.platform, ranks=ns.num_devices or 1)
    slo_classes = {"std": ns.slo_s}
    dk_relay = None

    def _engine_kwargs(clients):
        return dict(max_batch=ns.max_batch, coalesce_window_s=0.0,
                    device_window_s=ns.device_window_ms / 1e3,
                    max_queue=max(2048, 2 * clients),
                    slo_classes=dict(slo_classes), platform=ns.platform)

    def _prewarm(replicas):
        for rep in replicas:
            for m in methods:
                for n in n_choices:
                    rep.prewarm(m, ns.dtype, n)

    def _epoch_table(plan):
        bounds, i = [], 0
        for (name, _, factor, proc), k in zip(
                DIURNAL_EPOCHS, diurnal_epoch_counts(len(plan))):
            if k <= 0:
                continue
            bounds.append({"epoch": name, "t0": round(plan[i][0], 3),
                           "arrivals": k, "rate_factor": factor,
                           "process": proc})
            i += k
        return bounds

    try:
        # -- the autoscaled cells: replica count tracks the plan ------
        for clients in counts:
            key = f"elastic@{clients}@{ns.plan}"
            prior = ck.resume(key,
                              reusable=lambda r: bool(r.get("requests")))
            if prior is not None:
                print(f"elastic {key}: resumed from prior artifact",
                      file=sys.stderr)
                ck.add(prior)
                continue
            base_rate = (clients * DIURNAL_TIME_FACTOR
                         / max(ns.elastic_seconds, 0.5)
                         if ns.plan == "diurnal"
                         else clients / max(ns.elastic_seconds, 0.5))
            plan_seed = ns.seed * 1_000_003 + clients * 31 + 7
            plan = plan_workload(
                plan_seed, count=clients, methods=methods,
                dtype=ns.dtype, n_choices=n_choices,
                rate_rps=base_rate, process=ns.plan, burst=ns.burst,
                slo="std")
            ekw = _engine_kwargs(clients)
            router = local_router(
                amin, engine_kwargs=dict(
                    transports=[_transport() for _ in range(amin)],
                    **ekw)).start()
            _prewarm(router.replicas)
            spawned = []

            def spawn(i, _ekw=ekw, _spawned=spawned):
                rep = LocalReplica(
                    f"replica-e{i}",
                    ServeEngine(transport=_transport(), **_ekw))
                _spawned.append(rep)
                return rep

            scaler = Autoscaler(
                router, spawn, min_replicas=amin, max_replicas=amax,
                cooldown_s=cooldown, slo_classes=dict(slo_classes),
                executor=executor, down_ticks=ns.down_ticks
            ).start(interval_s=ns.tick_s)
            row = run_open_load(router.submit, plan, timeout_s=900)
            # let the loop observe the post-plan calm so the ebb-side
            # story (scale-down back toward min) lands in-trajectory
            settle = time.monotonic() + max(
                4 * (cooldown + ns.down_ticks * ns.tick_s), 1.0)
            while time.monotonic() < settle:
                snap = router.load_snapshot()
                if sum(1 for r in snap["replicas"]
                       if r["alive"] and not r["draining"]) <= amin:
                    break
                time.sleep(ns.tick_s)
            scaler.stop()
            router.stop()
            hist = scaler.history
            ups = sum(1 for r in hist if r["action"] == "up")
            downs = sum(1 for r in hist if r["action"] == "down")
            p99_in_slo = (row.get("p99_ms") is not None
                          and row["p99_ms"] / 1e3 <= ns.slo_s)
            ck.add({"key": key, "clients": clients, "plan": ns.plan,
                    **row, "p99_in_slo": bool(p99_in_slo),
                    "slo_s": ns.slo_s,
                    "replicas_min": min(r["replicas"] for r in hist),
                    "replicas_max": max(r["replicas"] for r in hist),
                    "scale_ups": ups, "scale_downs": downs,
                    "ticks": len(hist),
                    "epochs": _epoch_table(plan),
                    "trajectory": _compress_trajectory(hist),
                    "drains": [d["reshard"] for d in scaler.drains
                               if d.get("reshard")]})
            print(f"elastic {key}: rps={row.get('rps')} "
                  f"p99_ms={row.get('p99_ms')} ups={ups} downs={downs}",
                  file=sys.stderr)

        # -- drain-vs-kill: one seeded mid-burst workload, two exits --
        dk_clients = counts[len(counts) // 2] if counts else 64
        dk_seed = ns.seed * 1_000_003 + dk_clients * 31 + 13
        # the pair runs behind a deliberately slow relay (>= 25 ms per
        # launch): a burst then genuinely QUEUES behind the in-flight
        # batch, so the SIGKILL's victim dies with work on its queue —
        # the loss the planned drain exists to avoid
        dk_latency_ms = max(ns.launch_latency_ms, 25.0)
        if dk_latency_ms > 0:
            from tpu_reductions_torch.faults.relay import FakeRelay
            from tpu_reductions_torch.faults.schedule import Phase
            dk_relay = FakeRelay([Phase("slow",
                                        delay_s=dk_latency_ms / 1e3)])
            dk_relay.start()

        def _dk_transport():
            if dk_relay is None:
                return None
            from tpu_reductions_torch.serve.transport import RelayTransport
            return RelayTransport(ports=(dk_relay.port,),
                                  assume_tunneled=True, drain=True)

        for mode in ("drain", "kill"):
            prior = ck.resume(
                mode, reusable=lambda r: r.get("victim_shed") is not None)
            if prior is not None:
                ck.add(prior)
                continue
            plan = plan_workload(
                dk_seed, count=dk_clients, methods=methods,
                dtype=ns.dtype, n_choices=n_choices,
                rate_rps=4.0 * dk_clients, process="bursty",
                burst=ns.burst, slo="std")
            router = local_router(
                3, engine_kwargs=dict(
                    transports=[_dk_transport() for _ in range(3)],
                    **_engine_kwargs(dk_clients))).start()
            _prewarm(router.replicas)
            victim = router.replicas[-1]
            # trigger at the END of a burst run (a maximal run of
            # equal offsets past the 1/3 mark): the whole burst has
            # dispatched, the worker is inside a slow launch, and the
            # victim's share of the burst sits QUEUED — the contract's
            # hard case for both exits
            offsets = [off for off, _ in plan]
            s = len(offsets) // 3
            while s + 1 < len(offsets) \
                    and offsets[s + 1] != offsets[s]:
                s += 1
            trig = s
            while trig + 1 < len(offsets) \
                    and offsets[trig + 1] == offsets[s]:
                trig += 1
            fired = threading.Event()
            evidence: dict = {}

            def act(_router=router, _victim=victim, _mode=mode,
                    _evidence=evidence, _fired=fired):
                _fired.wait(timeout=60)
                if _mode == "drain":
                    # redlint: disable=RED018 -- the drain's wall seconds are the fleet's recovery metric, host-observed by definition
                    _evidence.update(drain_replica(
                        _router, _victim, executor=executor))
                else:
                    # catch the victim with work ON ITS QUEUE — the
                    # work SIGKILL sheds and a planned drain serves:
                    # behind the slow relay the worker is inside a
                    # 25 ms+ launch round while later burst arrivals
                    # queue behind it
                    deadline = time.monotonic() + 30.0
                    while time.monotonic() < deadline \
                            and _victim.queued_depth() <= 0:
                        time.sleep(0.001)
                    _victim.kill()
                    _evidence["victim_stats"] = _victim.stats()

            actor = threading.Thread(target=act, daemon=True)
            actor.start()
            dispatched = [0]

            def submit(req, _router=router, _d=dispatched,
                       _fired=fired, _trig=trig):
                _d[0] += 1
                if _d[0] == _trig + 1:
                    _fired.set()
                return _router.submit(req)

            row = run_open_load(submit, plan, timeout_s=900)
            actor.join(timeout=120)
            # kill's shed counter lands when the engine stops; read
            # the victim's terminals AFTER the actor finished
            stats = evidence.get("victim_stats") or {}
            router.stop()
            ck.add({"key": mode, "clients": dk_clients,
                    "process": "bursty", **row,
                    "victim": victim.replica_id,
                    "victim_shed": int(stats.get("shed", 0)),
                    "victim_expired": int(stats.get("expired", 0)),
                    "reshard": evidence.get("reshard"),
                    "handoff_keys": len(evidence.get("handoff") or []),
                    "drain_rerouted":
                        router.stats.get("drain_rerouted", 0),
                    "rerouted": router.stats.get("rerouted", 0)})
            print(f"elastic {mode}: victim_shed={stats.get('shed', 0)} "
                  f"ok={row.get('ok')}", file=sys.stderr)
    finally:
        if relay is not None:
            relay.stop()
        if dk_relay is not None:
            dk_relay.stop()
    if ns.out:
        ck.finalize()
    artifact = {**meta, "rows": ck.rows}
    print(elastic_markdown(artifact))
    if ns.out:
        print(f"wrote {ns.out}")
    return 0


def recovery_markdown(artifact: dict) -> str:
    """The report.md section for the crash-recovery instrument
    (bench/regen.py folds it after the elastic fleet): per disruption
    scenario on ONE seeded idem-keyed workload, the MTTR / shed /
    duplicate-execution record of each."""
    lines = ["## crash-consistent control plane (kill-router vs "
             "kill-replica vs drain)", ""]
    meta = ", ".join(f"{k}={artifact[k]}"
                     for k in ("dtype", "methods", "requests",
                               "crash_after", "seed", "platform")
                     if artifact.get(k) is not None)
    if meta:
        lines += [f"config: {meta}", ""]
    rows = [r for r in artifact.get("rows", []) if isinstance(r, dict)]
    if rows:
        lines.append("| scenario | requests | ok | shed | duplicate "
                     "device execs | dedup hits | MTTR s | adopted "
                     "| reaped | other |")
        lines.append("|---|---|---|---|---|---|---|---|---|---|")
        order = {"kill_router": 0, "kill_replica": 1, "drain": 2}
        for r in sorted(rows, key=lambda r: order.get(r.get("key"), 9)):
            other = ", ".join(
                f"{k}:{v}" for k, v in sorted(r.get("by_status",
                                                    {}).items())
                if k != "ok") or "-"
            mttr = r.get("mttr_s")
            lines.append(
                f"| {r.get('key', '-')} | {r.get('requests', '-')} "
                f"| {r.get('ok', '-')} | {r.get('shed', '-')} "
                f"| {r.get('duplicates', '-')} "
                f"| {r.get('dedup_hits', '-')} "
                f"| {f'{mttr:.3f}' if isinstance(mttr, (int, float)) else '-'} "
                f"| {r.get('adopted', '-')} | {r.get('reaped', '-')} "
                f"| {other} |")
    kr = next((r for r in rows if r.get("key") == "kill_router"), None)
    if kr:
        lines += ["", "controller SIGKILL mid-burst: the restarted "
                      "router re-adopted "
                      f"{kr.get('adopted')} journaled replica(s) in "
                      f"{kr.get('adopt_wall_s')} s, every retried "
                      "request carried its idempotency key, and the "
                      "ledger shows "
                      f"{kr.get('duplicates')} duplicate device "
                      f"execution(s) ({kr.get('dedup_hits')} retried "
                      "key(s) answered from the dedup cache without "
                      "re-touching the device)"]
    return "\n".join(lines)


def _stamp_idem(plan: List[Tuple], prefix: str) -> List[Tuple]:
    """Stamp every planned request with a client-supplied idempotency
    key (the exactly-once contract's join key): scenario-prefixed so
    one shared ledger separates the three scenarios' executions."""
    import dataclasses
    return [(off, dataclasses.replace(req, idem_key=f"{prefix}{i}"))
            for i, (off, req) in enumerate(plan)]


def _recovery_evidence(ledger_path: Optional[str], prefix: str) -> dict:
    """The ledger-verified exactly-once record for one scenario's key
    prefix: serve.coalesce launch-membership rows carry the
    idempotency keys of every request they put on the device (request
    ids are per-engine and collide across replicas, so the audit
    counts keys, never rids) — per-key launches beyond the first are
    the duplicate device executions, serve.dedup rows are the retries
    the cache answered WITHOUT a launch, and adopt.done is the
    adoption/MTTR record when a recovery ran."""
    out: dict = {"duplicates": 0, "dedup_hits": 0, "executed_keys": 0}
    if not ledger_path or not os.path.exists(ledger_path):
        return out
    execs: Dict[str, int] = {}
    paths = [p for p in (ledger_path + ".1", ledger_path)
             if os.path.exists(p)]      # rotation-aware, oldest first
    for path in paths:
        try:
            with open(path) as f:
                for line in f:
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    name = ev.get("ev")
                    if name == "serve.coalesce":
                        for idem in ev.get("idems") or []:
                            if isinstance(idem, str) \
                                    and idem.startswith(prefix):
                                execs[idem] = execs.get(idem, 0) + 1
                    elif name == "serve.dedup":
                        idem = ev.get("idem")
                        if isinstance(idem, str) \
                                and idem.startswith(prefix):
                            out["dedup_hits"] += 1
                    elif name == "adopt.done":
                        out["adopted"] = ev.get("adopted")
                        out["reaped"] = ev.get("reaped")
                        out["adopt_wall_s"] = ev.get("wall_s")
        except OSError:
            continue
    out["executed_keys"] = len(execs)
    out["duplicates"] = sum(max(0, c - 1) for c in execs.values())
    return out


def _recovery_client(port_file: str, plan: List[Tuple], *,
                     clients: int = 4,
                     retry_window_s: float = 90.0) -> List[dict]:
    """The kill-router scenario's TCP clients: `clients` threads split
    the idem-keyed plan; a broken connection (the controller died
    mid-burst) re-reads --port-file and RETRIES the same spec with the
    SAME idempotency key against whichever router is listening —
    at-least-once transport under the engine-side exactly-once cache.
    Returns one record per request: key, terminal status, attempts,
    and the completion wall clock (monotonic)."""
    rows: List[dict] = []
    lock = threading.Lock()

    def _port() -> Optional[int]:
        try:
            with open(port_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _one(req) -> dict:
        spec = {"method": req.method, "type": req.dtype, "n": req.n,
                "seed": req.seed, "idem_key": req.idem_key}
        deadline = time.monotonic() + retry_window_s
        attempts = 0
        err = "no attempt"
        while time.monotonic() < deadline:
            port = _port()
            if port is None:
                time.sleep(0.05)
                continue
            attempts += 1
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=30) as sock:
                    sock.sendall((json.dumps(spec) + "\n").encode())
                    raw = sock.makefile("r").readline()
                if not raw:
                    raise ConnectionError("connection closed mid-request")
                d = json.loads(raw)
            except (OSError, ValueError) as e:
                err = f"{type(e).__name__}: {e}"
                time.sleep(0.05)
                continue
            return {"key": req.idem_key, "status": d.get("status"),
                    "attempts": attempts, "t_done": time.monotonic(),
                    "latency_s": d.get("latency_s")}
        return {"key": req.idem_key, "status": "client-error",
                "attempts": attempts, "t_done": time.monotonic(),
                "error": err}

    def _worker(slice_):
        for _, req in slice_:
            rec = _one(req)
            with lock:
                rows.append(rec)

    threads = [threading.Thread(target=_worker, args=(plan[c::clients],),
                                daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return rows


def _sweep_journal(jpath: str, grace_s: float = 10.0) -> None:
    """INT, then KILL after `grace_s`, every child pid the journal still
    records alive: the recovery scenario leaves no replica behind, and on
    the card no CUDA context, whatever happened to its routers."""
    import signal
    try:
        with open(jpath) as f:
            entries = json.load(f).get("replicas") or {}
    except (OSError, ValueError, AttributeError):
        return
    pids = [int(e["pid"]) for e in entries.values()
            if isinstance(e, dict) and e.get("pid")]

    def alive(pid):
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    for sig in (signal.SIGINT, signal.SIGKILL):
        live = [pid for pid in pids if alive(pid)]
        for pid in live:
            try:
                os.kill(pid, sig)
            except OSError:
                pass
        deadline = time.monotonic() + grace_s
        while live and time.monotonic() < deadline:
            live = [pid for pid in live if alive(pid)]
            time.sleep(0.05)


def _run_recovery(ns, methods: List[str]) -> int:
    """`--recovery`: the crash-recovery instrument. Three
    disruptions on ONE seeded idem-keyed workload shape:

      * kill_router — a REAL `serve.router --journal` subprocess over
        ProcessReplica children dies via the scripted `router.crash`
        os._exit mid-burst; the load generator restarts it on the same
        journal; TCP clients retry broken requests with their original
        idempotency keys. The committed claim: zero duplicate device
        executions (ledger-joined), replicas re-adopted not respawned,
        MTTR in seconds.
      * kill_replica — SIGKILL-equivalent on one in-process replica
        mid-burst: the router re-routes carrying the keys, but a
        victim that already executed and shed its response re-executes
        on a survivor (separate dedup cache) — the honest at-least-once
        contrast the journal/dedup pair exists to beat.
      * drain — the planned exit: zero shed, zero
        duplicates, on the same workload.
    """
    import subprocess

    from tpu_reductions_torch.bench.resume import Checkpoint
    from tpu_reductions_torch.obs import ledger
    from tpu_reductions_torch.serve.autoscale import drain_replica
    from tpu_reductions_torch.serve.executor import BatchExecutor
    from tpu_reductions_torch.serve.router import local_router

    meta = {"instrument": "serving_recovery",
            "dtype": DTYPE_ALIASES[ns.dtype],
            "methods": ",".join(methods), "n": ns.n,
            "requests": ns.recovery_requests,
            "crash_after": ns.crash_after, "seed": ns.seed,
            "platform": ns.platform}
    ck = Checkpoint(ns.out, meta, key_fn=lambda r: r.get("key"))
    ledger_path = None
    if ns.out:
        ledger_path = ledger.arm(ns.out + ".ledger.jsonl")
    n_choices = (max(1024, ns.n // 2), ns.n)

    def _plan(prefix: str):
        # same seed for every scenario: the three rows contrast the
        # EXIT, not the workload
        plan = plan_workload(
            ns.seed * 1_000_003 + 17, count=ns.recovery_requests,
            methods=methods, dtype=ns.dtype, n_choices=n_choices,
            rate_rps=8.0 * ns.recovery_requests, process="bursty",
            burst=ns.burst)
        return _stamp_idem(plan, prefix)

    def _reusable(r):
        return r.get("duplicates") is not None

    # -- kill_router: real subprocess controller, journaled fleet -----
    prior = ck.resume("kill_router", reusable=_reusable)
    if prior is not None:
        ck.add(prior)
    else:
        import shutil
        import tempfile
        workdir = tempfile.mkdtemp(prefix="recovery-")
        jpath = os.path.join(workdir, "fleet_journal.json")
        port_file = os.path.join(workdir, "port")
        env = dict(os.environ)
        if ledger_path:
            env["TPU_REDUCTIONS_LEDGER"] = ledger_path
        argv = [sys.executable, "-m", "tpu_reductions_torch.serve.router",
                "--replicas", "2", "--journal", jpath,
                "--port-file", port_file, "--max-seconds", "300"]
        if ns.platform:
            argv += ["--platform", ns.platform]
        # the scripted controller death: os._exit on the
        # (crash_after+1)-th routed submit — no drain, no atexit,
        # children orphaned with the journal as their only record
        crash_env = dict(env)
        crash_env["TPU_REDUCTIONS_FAULTS"] = json.dumps(
            {"router.crash": {"after": ns.crash_after,
                              "action": "exit", "code": 86}})
        plan = _plan("kr-")
        procs: List = []
        t_death = [None]

        def _spawn(e):
            if os.path.exists(port_file):
                os.unlink(port_file)
            # each router's stdout (its spawn seconds) to a log of its own
            # redlint: disable=RED010 -- a router's stdout log handed to Popen for the rehearsal's evidence; nothing replays it, so a torn file loses diagnostics only
            with open(os.path.join(workdir, f"router-{len(procs)}.log"),
                      "wb") as log:
                proc = subprocess.Popen(argv, env=e, stdout=log,
                                        stderr=subprocess.STDOUT)
            procs.append(proc)
            # the router publishes its port once its children serve: on
            # the card each child first creates a CUDA context
            deadline = time.monotonic() + 180
            while time.monotonic() < deadline:
                if os.path.exists(port_file):
                    return proc
                if proc.poll() is not None:
                    break
                time.sleep(0.05)
            raise RuntimeError("router subprocess never published "
                               f"its port (exit {proc.poll()})")

        rows: List[dict] = []
        try:
            proc1 = _spawn(crash_env)
            client = threading.Thread(
                target=lambda: rows.extend(
                    _recovery_client(port_file, plan)), daemon=True)
            client.start()
            # the load generator supervises: on the scripted death it
            # restarts the router on the same journal (fault disarmed)
            while client.is_alive():
                if t_death[0] is None and proc1.poll() is not None:
                    t_death[0] = time.monotonic()
                    _spawn(env)
                client.join(timeout=0.05)
            client.join()
            mttr = None
            if t_death[0] is not None:
                after = [r["t_done"] for r in rows
                         if r.get("status") == "ok"
                         and r["t_done"] > t_death[0]]
                if after:
                    mttr = round(min(after) - t_death[0], 6)
            lat = sorted(r["latency_s"] for r in rows
                         if r.get("status") == "ok"
                         and isinstance(r.get("latency_s"),
                                        (int, float)))
            by_status: Dict[str, int] = {}
            for r in rows:
                s = r.get("status") or "?"
                by_status[s] = by_status.get(s, 0) + 1
            row = {"key": "kill_router", "requests": len(rows),
                   "ok": by_status.get("ok", 0),
                   "by_status": by_status,
                   "retried": sum(1 for r in rows
                                  if r.get("attempts", 1) > 1),
                   "router_exit": 86, "shed": 0, "mttr_s": mttr}
            if lat:
                row["p50_ms"] = round(percentile(lat, 0.50) * 1e3, 3)
                row["p99_ms"] = round(percentile(lat, 0.99) * 1e3, 3)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.send_signal(2)     # SIGINT: drain, never wedge
            for proc in procs:
                if proc.poll() is None:
                    try:
                        proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        proc.kill()
            _sweep_journal(jpath)
            logs = []
            for i in range(len(procs)):
                try:
                    with open(os.path.join(workdir, f"router-{i}.log"),
                              errors="replace") as f:
                        logs += [ln.strip() for ln in f
                                 if ln.startswith("routing ")]
                except OSError:
                    pass
            shutil.rmtree(workdir, ignore_errors=True)
        row["routers"] = logs
        row.update(_recovery_evidence(ledger_path, "kr-"))
        ck.add(row)
        print(f"recovery kill_router: ok={row.get('ok')} "
              f"duplicates={row.get('duplicates')} "
              f"mttr_s={row.get('mttr_s')}", file=sys.stderr)

    # -- kill_replica / drain: in-process contrast pair ---------------
    executor = BatchExecutor(ns.platform, ranks=ns.num_devices or 1)
    for mode, prefix in (("kill_replica", "krep-"), ("drain", "dr-")):
        prior = ck.resume(mode, reusable=_reusable)
        if prior is not None:
            ck.add(prior)
            continue
        plan = _plan(prefix)
        router = local_router(3, engine_kwargs=dict(
            max_batch=ns.max_batch, coalesce_window_s=0.0,
            max_queue=max(2048, 2 * len(plan)),
            platform=ns.platform)).start()
        victim = router.replicas[-1]
        trig = max(1, len(plan) // 3)
        fired = threading.Event()
        t_disrupt = [None]

        def act(_mode=mode, _victim=victim, _fired=fired,
                _t=t_disrupt):
            _fired.wait(timeout=60)
            _t[0] = time.monotonic()
            if _mode == "drain":
                drain_replica(router, _victim, executor=executor)
            else:
                _victim.kill()

        actor = threading.Thread(target=act, daemon=True)
        actor.start()
        dispatched = [0]

        def submit(req, _router=router, _d=dispatched, _fired=fired,
                   _trig=trig):
            _d[0] += 1
            if _d[0] == _trig + 1:
                _fired.set()
            return _router.submit(req)

        row = run_open_load(submit, plan, timeout_s=300)
        actor.join(timeout=60)
        stats = victim.stats()
        router.stop()
        out_row = {"key": mode, **row,
                   "victim": victim.replica_id,
                   "shed": int(stats.get("shed", 0)),
                   "rerouted": router.stats.get("rerouted", 0),
                   "drain_rerouted":
                       router.stats.get("drain_rerouted", 0)}
        if t_disrupt[0] is not None:
            out_row["mttr_s"] = 0.0     # in-process re-route: no gap
        evidence = _recovery_evidence(ledger_path, prefix)
        for k in ("adopted", "reaped", "adopt_wall_s"):
            # the adoption record belongs to kill_router alone — the
            # shared ledger's adopt.done is not prefix-scoped
            evidence.pop(k, None)
        out_row.update(evidence)
        ck.add(out_row)
        print(f"recovery {mode}: ok={row.get('ok')} "
              f"shed={out_row['shed']} "
              f"duplicates={out_row.get('duplicates')}",
              file=sys.stderr)

    if ns.out:
        ck.finalize()
    artifact = {**meta, "rows": ck.rows}
    print(recovery_markdown(artifact))
    if ns.out:
        print(f"wrote {ns.out}")
    return 0


def _tcp_submit(addr: str):
    """A submit() against the TCP front end: one connection per client
    thread (thread-local), one JSON line per request/response."""
    host, _, port = addr.rpartition(":")
    local = threading.local()

    from tpu_reductions_torch.serve.request import ReduceResponse

    def submit(req):
        if getattr(local, "sock", None) is None:
            local.sock = socket.create_connection((host or "127.0.0.1",
                                                   int(port)), timeout=60)
            local.rfile = local.sock.makefile("r")
        line = json.dumps({"method": req.method, "type": req.dtype,
                           "n": req.n, "seed": req.seed,
                           "deadline_s": req.deadline_s,
                           # retries carry the key: the engine-side
                           # dedup cache makes the retry exactly-once
                           **({"idem_key": req.idem_key}
                              if req.idem_key else {})}) + "\n"
        local.sock.sendall(line.encode())
        raw = local.rfile.readline()
        if not raw:
            raise ConnectionError("server closed the connection")
        d = json.loads(raw)
        return ReduceResponse(
            d.get("request_id", "?"), d.get("status", "error"),
            d.get("method", req.method), d.get("dtype", req.dtype),
            d.get("n", req.n), result=d.get("result"),
            error=d.get("error"), latency_s=d.get("latency_s"),
            queue_s=d.get("queue_s"), batch_size=d.get("batch_size"))

    return submit


def _engine_row(ns, mode: str, methods: List[str]) -> dict:
    """One in-process mode: an engine on the platform's device, warmed
    for every key outside the measured window, then the closed loop;
    with the engine's and its executor's counts over that window."""
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.executor import BatchExecutor
    executor = BatchExecutor(ns.platform)
    engine = ServeEngine(
        max_queue=ns.max_queue,
        max_batch=(1 if mode == "sequential" else ns.max_batch),
        coalesce_window_s=(0.0 if mode == "sequential"
                           else ns.coalesce_window_ms / 1e3),
        device_window_s=ns.device_window_ms / 1e3,
        executor=executor, platform=ns.platform)
    engine.start()
    try:
        # every bucket warmed outside the measured window: both modes pay
        # their first calls once, and the curve measures serving
        for m in methods:
            engine.prewarm(m, ns.dtype, ns.n,
                           up_to_batch=(1 if mode == "sequential"
                                        else min(ns.clients, ns.max_batch)))
        executor.reset_counts()
        batches0 = engine.stats["batches"]

        def submit(req):
            return engine.submit(req).result(timeout=600)

        row = run_load(submit, clients=ns.clients, requests=ns.requests,
                       methods=methods, dtype=ns.dtype, n=ns.n,
                       deadline_s=ns.deadline_s, seed=ns.seed)
    finally:
        engine.stop()
    row["batches"] = int(engine.stats["batches"] - batches0)
    row["launches"] = int(sum(v for s, v in executor.launches.items()
                              if s.startswith("serve-bucket/")))
    row["seconds"] = {k: round(v, 6) for k, v in executor.seconds.items()}
    row["copy_route"] = executor.last_route
    return row


def main(argv=None) -> int:
    """Measure the serving curve, persist it, print the table."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.serve.loadgen",
        description="Closed-loop load generator for the serving engine "
                    "(requests/s + p50/p99 at N concurrent clients)")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=32,
                   help="requests per client (closed loop)")
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--type", dest="dtype", default="int")
    p.add_argument("--methods", default="SUM,MIN,MAX",
                   help="comma-separated mix; clients interleave it")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="per-request deadline (default: none)")
    p.add_argument("--coalesce-window-ms", type=float, default=0.0,
                   help="0 = continuous batching (batches form from "
                        "whatever queued while the previous launch ran); "
                        "a positive window suits bursty traffic at a "
                        "latency cost")
    p.add_argument("--device-window-ms", type=float, default=250.0)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-queue", type=int, default=1024,
                   help="admission bound (generous: the loadgen measures "
                        "latency, not rejection)")
    p.add_argument("--launch-latency-ms", type=float, default=0.0,
                   help="modeled round trip a launch, injected through a "
                        "local chaos relay in `slow` mode "
                        "(faults/relay.py) and the engine's transport "
                        "gate; a card has no tunnel, so the default is 0 "
                        "(no relay; the JAX CLI's is 2)")
    p.add_argument("--modes", default="coalesced,sequential",
                   help="which engine modes to measure")
    p.add_argument("--connect", default=None,
                   help="HOST:PORT of a running `python -m "
                        "tpu_reductions_torch.serve` or router (one "
                        "'remote' row instead of the in-process modes)")
    p.add_argument("--seed", type=int, default=0,
                   help="workload seed: same seed, same plan (arrival "
                        "offsets and request specs)")
    p.add_argument("--scale", action="store_true",
                   help="the open-loop scaling grid (sequential/"
                        "coalesced/routerN x --scale-clients x poisson "
                        "and bursty) and the sharded row; writes a "
                        "serving_scale.json-shaped artifact to --out")
    p.add_argument("--scale-clients", default="64,256,1024",
                   help="open-loop client counts for the scale grid")
    p.add_argument("--replicas", type=int, default=4,
                   help="router replica count for the routerN series")
    p.add_argument("--rate-factor", type=float, default=8.0,
                   help="open-loop arrival rate = factor x clients req/s")
    p.add_argument("--burst", type=int, default=32,
                   help="arrivals per burst epoch in the bursty process")
    p.add_argument("--sharded-n", type=int, default=160_000_000,
                   help="element count of the sharded row's oversized "
                        "request (default: 640 MB of int32, over the "
                        "512 MiB shard threshold)")
    p.add_argument("--skip-sharded", action="store_true",
                   help="omit the sharded row from --scale")
    p.add_argument("--elastic", action="store_true",
                   help="an autoscaled fleet tracking the --plan arrival "
                        "shape at each --scale-clients count, then the "
                        "drain-versus-kill pair; writes a "
                        "serving_elastic.json-shaped artifact to --out")
    p.add_argument("--plan", default="diurnal",
                   choices=("diurnal", "poisson", "bursty"),
                   help="arrival plan of the --elastic cells")
    p.add_argument("--elastic-seconds", type=float, default=8.0,
                   help="target wall-clock span of one elastic cell's "
                        "plan (the base arrival rate derives from it)")
    p.add_argument("--slo-s", type=float, default=5.0,
                   help="declared SLO deadline (class 'std') the "
                        "elastic cells must hold p99 inside")
    p.add_argument("--tick-s", type=float, default=0.05,
                   help="autoscaler control-loop interval (--elastic)")
    p.add_argument("--down-ticks", type=int, default=3,
                   help="consecutive calm ticks before a scale-down")
    p.add_argument("--autoscale-min", type=int, default=None,
                   help="fleet floor (default: "
                        "TPU_REDUCTIONS_AUTOSCALE_MIN or 1)")
    p.add_argument("--autoscale-max", type=int, default=None,
                   help="fleet ceiling (default: "
                        "TPU_REDUCTIONS_AUTOSCALE_MAX or 8)")
    p.add_argument("--autoscale-cooldown-s", type=float, default=None,
                   help="post-action cooldown (default: "
                        "TPU_REDUCTIONS_AUTOSCALE_COOLDOWN_S or 0.75)")
    p.add_argument("--recovery", action="store_true",
                   help="kill-router / kill-replica / drain on one seeded "
                        "idem-keyed workload: MTTR, shed count and "
                        "ledger-verified duplicate device executions; "
                        "writes a serving_recovery.json-shaped artifact "
                        "to --out")
    p.add_argument("--recovery-requests", type=int, default=48,
                   help="requests per --recovery scenario")
    p.add_argument("--crash-after", type=int, default=16,
                   help="routed submits before the scripted router.crash "
                        "os._exit (--recovery)")
    p.add_argument("--devices", dest="num_devices", type=int,
                   default=None,
                   help="ranks of the shard route and of the drains' "
                        "reshard: rows of one tensor on the device (the "
                        "sharded row needs > 1)")
    p.add_argument("--platform", default="gpu", choices=PLATFORMS)
    p.add_argument("--out", default=None)
    ns = p.parse_args(argv)
    methods = [m.strip().upper() for m in ns.methods.split(",")
               if m.strip()]
    if not methods or any(m not in METHODS for m in methods):
        p.error(f"--methods must name only {METHODS}, got {ns.methods!r}")
    if ns.dtype not in DTYPE_ALIASES:
        p.error(f"unknown --type {ns.dtype!r}")
    if ns.launch_latency_ms < 0:
        p.error("--launch-latency-ms must be >= 0")
    if ns.num_devices is not None and ns.num_devices < 1:
        p.error("--devices must be positive")
    # the fleet modes, in the JAX CLI's precedence and words
    fleet = next((f for f in ("scale", "elastic", "recovery")
                  if getattr(ns, f)), None)
    if fleet and ns.connect:
        p.error({"scale": "--scale drives in-process engines/routers; "
                          "--connect is the single-engine TCP mode",
                 "elastic": "--elastic drives in-process autoscaled "
                            "fleets; --connect is the single-engine TCP "
                            "mode",
                 "recovery": "--recovery drives its own router subprocess "
                             "and in-process fleets; --connect is the "
                             "single-engine TCP mode"}[fleet])

    if not ns.connect:
        from tpu_reductions_torch import device as device_mod
        device_mod.resolve(ns.platform)      # no card, no engine
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("serve.loadgen", argv=list(argv) if argv else sys.argv[1:])
    from tpu_reductions_torch.exec.core import maybe_arm
    maybe_arm(ns.platform)
    if fleet:
        return {"scale": _run_scale, "elastic": _run_elastic,
                "recovery": _run_recovery}[fleet](ns, methods)
    ns.dtype = DTYPE_ALIASES[ns.dtype]

    meta = {"dtype": ns.dtype, "n": ns.n,
            "methods": ",".join(methods), "clients": ns.clients,
            "requests_per_client": ns.requests,
            "launch_latency_ms": ns.launch_latency_ms,
            "seed": ns.seed, "platform": ns.platform}
    from tpu_reductions_torch.bench.resume import Checkpoint
    ck = Checkpoint(ns.out, meta, key_fn=lambda r: r.get("mode"))

    modes = ([m.strip() for m in ns.modes.split(",") if m.strip()]
             if not ns.connect else ["remote"])
    for mode in modes:
        # a prior row is reusable iff it measured something
        prior = ck.resume(mode, reusable=lambda r: bool(r.get("requests")))
        if prior is not None:
            print(f"loadgen {mode}: resumed from prior artifact",
                  file=sys.stderr)
            ck.add(prior)
            continue
        if ns.connect:
            row = run_load(_tcp_submit(ns.connect), clients=ns.clients,
                           requests=ns.requests, methods=methods,
                           dtype=ns.dtype, n=ns.n,
                           deadline_s=ns.deadline_s, seed=ns.seed)
        else:
            row = _engine_row(ns, mode, methods)
        ck.add({"mode": mode, **row})
    if ns.out:
        ck.finalize()
    artifact = {**meta, "rows": ck.rows}
    print(curve_markdown(artifact))
    for r in ck.rows:
        if r.get("seconds"):
            print(f"{r['mode']}: batches {r.get('batches')} launches "
                  f"{r.get('launches')} copy {r.get('copy_route')} "
                  "executor s " + " ".join(
                      f"{k} {v:.4f}" for k, v in r["seconds"].items()))
    if ns.out:
        print(f"wrote {ns.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
