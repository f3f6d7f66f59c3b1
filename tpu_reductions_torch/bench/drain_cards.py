"""The drain's reshard across the host's cards, held against one card.

No reference analog as a module: the JAX package's drain runs its
planner program on a mesh over the host's chips in one process
(tpu_reductions/serve/executor.py:666-687 over
tpu_reductions/reshard/primitives.py:144-150) and checks it against the
numpy oracle alone. The port's drain places the k ranks on min(k, C) of
the executor's cards, one host thread a card (serve/executor.
BatchExecutor.run_reshard, parallel/peer.py); this module runs it beside
its one-card twin (`cards=[the first card]`, the ranks as rows of one
tensor) and says where the two agree.

- `drain_rows` runs the reshard curve's programs (bench/reshard_curve.py
  PAIRS exact and QUANT_PAIRS quantized, its data draw) at each k through
  run_reshard over the cards and on the twin. A program that only moves
  data must give the twin's bits; one with a reduce_scatter adds the
  cards' partials in another order and must stay within the curve's
  bound of the twin and of the oracle. The step rows and the accounted
  memory factor must equal the twin's and stay within the declared one.
- `drain_fleet` retires one replica of a two-replica router by the drain
  protocol (serve/autoscale.drain_replica) with a given executor, after
  a few requests, and returns the evidence.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


def _program(plan) -> List[str]:
    return [s.primitive for s in plan.steps]


def _step_rows(res) -> list:
    return [(s["primitive"], s["algorithm"], s["buffer_bytes"],
             s["mem_factor"]) for s in res["steps"]]


def drain_rows(ranks: Sequence[int], n: int, rows: int, seed: int,
               cards: Sequence, *, platform: str = "gpu"
               ) -> Iterator[dict]:
    """Every (pair, wire, k) of the reshard curve (reshard_curve.
    curve_cells) through BatchExecutor(ranks=k, cards=cards).run_reshard
    and its one-card twin on cards[0], on the curve's data; yields one
    row each: {pair, wire, ranks, program, cards, copy_route, wall_s,
    twin_wall_s, device_mem_factor, twin_device_mem_factor,
    measured_mem_factor, mem_factor, same_bits, max_diff, bound,
    max_err, ok, why}. `ok` holds when both placements pass the oracle
    within the curve's bound, the cards give the twin's bits for a
    program that only moves data (else are within the bound of it), the
    step rows and accounted factors are the twin's and within the
    declared factor, and `cards` is min(k, C). No reference analog."""
    from tpu_reductions_torch.bench.reshard_curve import (PAIRS, _spec,
                                                          curve_cells)
    from tpu_reductions_torch.reshard import (plan_reshard,
                                              reshard_error_bound,
                                              verify_placement)
    from tpu_reductions_torch.serve.executor import BatchExecutor

    kinds = {name: (s, d) for name, s, d in PAIRS}
    shape = (rows, n // rows)
    drawn = carried = None
    for pair, wire, k in curve_cells(ranks):
        qb = int(wire[1:]) if wire.startswith("q") else None
        src, dst = (_spec(kind, k) for kind in kinds[pair])
        plan = plan_reshard(src, dst, shape, 4, quant_bits=qb)
        if drawn != (pair, k):
            # the curve's draw per (pair, k): both wires on the same data
            drawn = (pair, k)
            carried = np.random.default_rng([seed, k]).standard_normal(
                ((k,) if src.partial else ()) + shape).astype(np.float32)
        m_abs = float(np.abs(carried).max())
        bound = reshard_error_bound(plan.quant_steps, qb, m_abs)
        if src.partial:
            bound += float(k) * m_abs * 2.0 ** -22
        got = BatchExecutor(platform, ranks=k,
                            cards=cards).run_reshard(plan, carried)
        want = BatchExecutor(platform, ranks=k,
                             cards=cards[:1]).run_reshard(plan, carried)
        moves_only = "reduce_scatter" not in _program(plan)
        same = all(np.array_equal(a, b)
                   for a, b in zip(got["shards"], want["shards"]))
        diff = max(float(np.max(np.abs(a.astype(np.float64) - b)))
                   for a, b in zip(got["shards"], want["shards"]))
        verdicts = [verify_placement(carried, src, dst, r["shards"],
                                     atol=bound)
                    for r in (got, want)]
        why = []
        if not all(v["ok"] for v in verdicts):
            why.append("oracle")
        if not (same if moves_only else diff <= bound):
            why.append("bits" if moves_only else "twin bound")
        if _step_rows(got) != _step_rows(want) or \
                got["measured_mem_factor"] != want["measured_mem_factor"]:
            why.append("steps")
        if got["measured_mem_factor"] > plan.mem_factor + 1e-9:
            why.append("memory")
        if got["cards"] != min(k, len(cards)) or want["cards"] != 1:
            why.append("cards")
        yield {"pair": pair, "wire": wire, "ranks": k,
               "program": _program(plan), "cards": got["cards"],
               "copy_route": got["copy_route"],
               "wall_s": got["wall_s"], "twin_wall_s": want["wall_s"],
               "device_mem_factor": got["device_mem_factor"],
               "twin_device_mem_factor": want["device_mem_factor"],
               "measured_mem_factor": got["measured_mem_factor"],
               "mem_factor": plan.mem_factor, "same_bits": same,
               "max_diff": diff, "bound": bound,
               "max_err": max(v["max_err"] for v in verdicts),
               "ok": not why, "why": why}


# drain_fleet's traffic before the drain, the drain's seed, and how long
# a request or the drain may wait
FLEET_REQUESTS = 4
FLEET_N = 65536
FLEET_SEED = 3
FLEET_TIMEOUT_S = 120.0


def drain_fleet(executor, *, platform: str = "gpu") -> dict:
    """Two LocalReplicas behind a router on `platform`, FLEET_REQUESTS
    int32 SUM requests through it, then the drain of the second with
    `executor` as the drain's device seam (serve/autoscale.drain_replica,
    mem_bound 2.0); returns {statuses, reshard, shed, expired, drained,
    replicas}. No reference analog."""
    from tpu_reductions_torch.serve.autoscale import drain_replica
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.request import ReduceRequest
    from tpu_reductions_torch.serve.router import (LocalReplica,
                                                   ReplicaRouter)

    reps = [LocalReplica(rid, ServeEngine(coalesce_window_s=0.0,
                                          platform=platform))
            for rid in ("survivor", "victim")]
    router = ReplicaRouter(reps).start()
    try:
        pending = [router.submit(ReduceRequest(method="SUM",
                                               dtype="int32", n=FLEET_N,
                                               seed=i))
                   for i in range(FLEET_REQUESTS)]
        statuses = [p.result(FLEET_TIMEOUT_S).status for p in pending]
        ev = drain_replica(router, reps[1], executor=executor,
                           seed=FLEET_SEED, timeout_s=FLEET_TIMEOUT_S)
    finally:
        router.stop()
    stats = ev["victim_stats"]
    return {"statuses": statuses, "reshard": ev["reshard"],
            "drained": ev["drained"], "shed": int(stats.get("shed", 0)),
            "expired": int(stats.get("expired", 0)),
            "replicas": [r.replica_id for r in router.replicas]}


def summary(row: dict) -> str:
    """One drain row in words: its program, both placements' seconds and
    their ratio, the largest card's peak against the twin's, the copy
    routes and the verdict. No reference analog."""
    ratio = (row["wall_s"] / row["twin_wall_s"] if row["twin_wall_s"]
             else float("nan"))
    dev, twin = row["device_mem_factor"], row["twin_device_mem_factor"]
    peaks = ("not measured (no allocator)" if dev is None else
             f"{dev:.4f} (one card {twin:.4f})")
    bits = ("same bits as one card" if row["same_bits"] else
            f"max |diff| {row['max_diff']:.3e} vs one card (bound "
            f"{row['bound']:.3e})")
    routes = sorted(set(row["copy_route"].values())) or ["-"]
    return (f"{row['pair']} {row['wire']} k={row['ranks']} "
            f"{'+'.join(row['program'])} on {row['cards']} cards: "
            f"{row['wall_s']:.6f} s, one card {row['twin_wall_s']:.6f} s "
            f"(ratio {ratio:.3f}); device mem factor {peaks}; accounted "
            f"{row['measured_mem_factor']:.4f} <= {row['mem_factor']:.4f}; "
            f"{bits}; copies {','.join(routes)} "
            f"[{'PASSED' if row['ok'] else 'FAILED ' + ','.join(row['why'])}]")


def failures(rows: Sequence[dict]) -> List[tuple]:
    """(pair, wire, ranks, why) of every row that did not hold.
    No reference analog."""
    return [(r["pair"], r["wire"], r["ranks"], r["why"])
            for r in rows if not r["ok"]]


def check_drain(got: dict, cards: int,
                twin: Optional[dict] = None) -> List[str]:
    """What a drain_fleet run across `cards` cards fails of its contract:
    every request ok, the victim drained and gone, nothing shed or
    expired, the reshard ok within its memory bound on 8 ranks and
    `cards` cards (the twin's on one, with its program).
    No reference analog."""
    bad = []
    rs = got["reshard"] or {}
    if set(got["statuses"]) != {"ok"}:
        bad.append(f"statuses {got['statuses']}")
    if not got["drained"] or got["replicas"] != ["survivor"]:
        bad.append(f"drained {got['drained']} replicas {got['replicas']}")
    if got["shed"] or got["expired"]:
        bad.append(f"shed {got['shed']} expired {got['expired']}")
    if not (rs.get("ok") and rs.get("mem_ok") and rs.get("ranks") == 8
            and rs.get("cards") == cards):
        bad.append(f"reshard {rs}")
    if twin is not None and (twin["reshard"] or {}).get("program") != \
            rs.get("program"):
        bad.append(f"program {rs.get('program')} vs one card "
                   f"{(twin['reshard'] or {}).get('program')}")
    return bad
