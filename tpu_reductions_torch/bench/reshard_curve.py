"""The redistribution curve: reshard GB/s x ranks x spec pairs.

The counterpart of tpu_reductions/bench/reshard_curve.py:1, on the port's
reshard engine (tpu_reductions_torch/reshard/). For every (source,
target) spec pair and rank count, the planner picks the cheapest
primitive program under the memory bound, the executor runs it on the
rank axis with each primitive timed (a warm-up call, then the median
of reshard.primitives.STEP_REPEATS calls) and its buffers accounted, and
the numpy oracle verifies every rank's block. A row PASSES only when (a)
the placement is right (bit for bit on the exact wire, within the
declared bound on the quantized one), and (b) the accounted peak-memory
factor (`measured_mem_factor`, the JAX package's accounting from shapes)
is within the plan's declared factor; the curve also records the
planner's wire beside the naive all-gather-then-slice wire where one
exists. On the card a row also carries `device_mem_factor`, the
allocator's peak per rank (reshard.primitives.execute_plan), which is
reported and not gated: it counts the torch ops' temporaries, which the
declaration does not model.

On the card a rank is a row of one tensor, so a primitive's "wire" is a
copy inside the card's memory: the GB/s are redistribution rates of its
memory, not link rates.

Grid: 5 spec pairs x the rank ladder (2..64), exact wire, then the
quantized wire for the wire-heavy pairs. Every cell persists as it lands
and resumes (bench/resume.run_checkpointed_cells, keyed (pair, wire,
ranks)); the `reshard.cell` fault point fires before each cell's
launch, as in JAX.

CLI:
    python -m tpu_reductions_torch.bench.reshard_curve [--platform=cpu]
        [--n=1048576 --rows=256 --ranks=2,4,8,16,32,64 --seed=0]
        [--mem-bound=F] [--quant-bits=8] [--out=out/reshard_curve.json]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from tpu_reductions_torch.config import PLATFORMS
from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.utils.logging import BenchLogger

DEFAULT_RANKS = (2, 4, 8, 16, 32, 64)
DEFAULT_N = 1 << 20
DEFAULT_ROWS = 256
DEFAULT_OUT = "out/reshard_curve.json"

# the spec-pair menu: (name, src kind, dst kind) over a 2-D payload; S0/S1
# sharded on dim 0/1, R replicated, P partial per-rank addends.
# row_to_col / col_to_row are the pairs where the planner's
# collective_permute beats the naive all-gather-then-slice wire by k.
PAIRS = (
    ("row_to_col", "S0", "S1"),
    ("col_to_row", "S1", "S0"),
    ("shard_to_replicated", "S0", "R"),
    ("replicated_to_col", "R", "S1"),
    ("partial_to_row", "P", "S0"),
)
# pairs that move wire and block-align, measured again quantized
QUANT_PAIRS = ("row_to_col", "shard_to_replicated")


def _spec(kind: str, k: int):
    from tpu_reductions_torch.reshard import ShardingSpec
    if kind == "R":
        return ShardingSpec.replicated(k, 2)
    if kind == "P":
        return ShardingSpec.replicated(k, 2, partial=True)
    return ShardingSpec.sharded(k, 2, int(kind[1]))


def curve_cells(ranks=DEFAULT_RANKS, quant_bits: Optional[int] = 8
                ) -> List[tuple]:
    """The (pair, wire, ranks) grid in artifact order: the exact rows of
    every pair, then the quantized rows of the wire-heavy pairs, the
    rank ladder innermost.
    The counterpart of tpu_reductions/bench/reshard_curve.py:71."""
    cells = []
    for name, _, _ in PAIRS:
        for k in ranks:
            cells.append((name, "exact", k))
    if quant_bits is not None:
        for name in QUANT_PAIRS:
            for k in ranks:
                cells.append((name, f"q{quant_bits}", k))
    return cells


def measure_cell(pair: str, wire: str, k: int, n: int, rows: int,
                 seed: int, mem_bound: Optional[float] = None,
                 platform: str = "gpu", witness=None) -> Optional[dict]:
    """One curve cell: plan, execute on a k-rank mesh on `platform`,
    verify every rank against the oracle, account the memory. PASSED
    only when every rank's block is right within the declared bound and
    the accounted peak-memory factor is within the plan's. In a joined
    group the mesh lies on its processes in blocks, each process of the
    mesh verifies the gathered placement and measures its own card
    (execute_plan), and a process outside the mesh returns None.
    `witness` (bench/multicard.Witness) records every rank's block; a
    program with a reduce_scatter, which adds partials, need not keep
    one card's bits.
    The counterpart of tpu_reductions/bench/reshard_curve.py:89."""
    import numpy as np

    from tpu_reductions_torch.reshard import (execute_plan, make_mesh,
                                              naive_plan, plan_reshard,
                                              reshard_error_bound,
                                              verify_placement)

    if n % rows or n % (k * k):
        raise ValueError(f"--n={n} needs rows|n and k*k|n (k={k})")
    shape = (rows, n // rows)
    qb = int(wire[1:]) if wire.startswith("q") else None
    kinds = {name: (s, d) for name, s, d in PAIRS}
    src = _spec(kinds[pair][0], k)
    dst = _spec(kinds[pair][1], k)
    plan = plan_reshard(src, dst, shape, 4, mem_bound=mem_bound,
                        quant_bits=qb)
    naive = naive_plan(src, dst, shape, 4, quant_bits=qb)
    fault_point("reshard.cell")
    mesh = make_mesh(k, platform)
    if not mesh.member:
        return None         # a process outside the cell's mesh
    # the same draw per (pair, k) on either wire: exact and quantized
    # rows compare on the same data
    rng = np.random.default_rng([seed, k])
    if src.partial:
        carried = rng.standard_normal((k,) + shape).astype(np.float32)
    else:
        carried = rng.standard_normal(shape).astype(np.float32)
    m_abs = float(np.abs(carried).max())
    # quantized crossings round against the block max; the partial pair's
    # f32 sum adds k half-ulps at the summed magnitude
    bound = reshard_error_bound(plan.quant_steps, qb, m_abs)
    if src.partial:
        bound += float(k) * m_abs * 2.0 ** -22
    res = execute_plan(plan, carried, mesh)
    verdict = verify_placement(carried, src, dst, res["shards"],
                               atol=bound)
    g_bytes = int(np.prod(shape)) * 4
    wall_s = res["wall_s"]
    mem_ok = res["measured_mem_factor"] <= plan.mem_factor + 1e-9
    ok = bool(verdict["ok"]) and mem_ok
    if witness is not None:
        program = [s.primitive for s in plan.steps]
        witness.record(
            "reshard", (pair, wire, k),
            [np.concatenate([np.ravel(b) for b in res["shards"]])], mesh,
            exact="reduce_scatter" not in program, replicated=True,
            method="SUM", dtype="float32", n=n)
    return {"pair": pair, "wire": wire, "ranks": k, "n": int(n),
            "shape": list(shape),
            "src": src.to_json(), "dst": dst.to_json(),
            "program": [s.primitive for s in plan.steps],
            "algorithms": [s.algorithm for s in plan.steps],
            "plan_wire_bytes": plan.wire_bytes,
            "naive_wire_bytes": (naive.wire_bytes if naive is not None
                                 else None),
            "mem_factor": round(plan.mem_factor, 6),
            "measured_mem_factor": round(res["measured_mem_factor"], 6),
            "device_mem_factor": (None if res["device_mem_factor"] is None
                                  else round(res["device_mem_factor"], 6)),
            "gbps": (g_bytes / wall_s / 1e9 if wall_s > 0
                     else float("inf")),
            "wall_s": round(wall_s, 6),
            "steps": res["steps"],
            "max_err": verdict["max_err"], "bound": bound,
            "status": "PASSED" if ok else "FAILED"}


def run_curve(*, n: int, rows: int, seed: int, ranks=DEFAULT_RANKS,
              quant_bits: Optional[int] = 8,
              mem_bound: Optional[float] = None,
              out: Optional[str] = None, platform: str = "gpu",
              logger: Optional[BenchLogger] = None,
              witness=None) -> List[dict]:
    """The grid, each cell persisted as it lands and resumed from an
    interrupted `out` (bench/resume.run_checkpointed_cells). Returns the
    rows in grid order. In a joined group every process runs the grid
    (the cells a process is outside of add no row) and only rank 0
    writes `out` (bench/multicard.shared_checkpoint).
    The counterpart of tpu_reductions/bench/reshard_curve.py:160."""
    from tpu_reductions_torch.bench.multicard import shared_checkpoint
    from tpu_reductions_torch.bench.resume import run_checkpointed_cells
    logger = logger or BenchLogger(None, None)
    # the meta key is dim0, not "rows": that name is the artifact's rows
    ck = shared_checkpoint(out, {"n": n, "dim0": rows, "seed": seed,
                                 "mem_bound": mem_bound},
                           key_fn=lambda r: (r.get("pair"), r.get("wire"),
                                             r.get("ranks")))
    if ck.path is not None and ck._prior:
        print(f"reshard_curve: {len(ck._prior)} row(s) resumed from "
              f"prior artifact {ck.path}", file=sys.stderr)

    def measure(key):
        pair, wire, k = key
        return measure_cell(pair, wire, k, n, rows, seed, mem_bound,
                            platform, witness=witness)

    def on_row(key, row):
        beat = (f" naive={row['naive_wire_bytes']:.0f}B"
                if row.get("naive_wire_bytes") is not None else "")
        card = (f" card={row['device_mem_factor']:.3f}"
                if row.get("device_mem_factor") is not None else "")
        logger.log(f"reshard {row['pair']} {row['wire']} k={row['ranks']}"
                   f" [{'+'.join(row['program']) or 'identity'}]"
                   f" {row['gbps']:.3f} GB/s"
                   f" wire={row['plan_wire_bytes']:.0f}B{beat}"
                   f" mem={row['measured_mem_factor']:.3f}"
                   f"/{row['mem_factor']:.3f}{card}"
                   f" err={row['max_err']:.2e}"
                   f" {row['status']}")

    return run_checkpointed_cells(ck, curve_cells(ranks, quant_bits),
                                  measure, on_row)


def reshard_curve_markdown(data: dict) -> str:
    """The report fold (bench/regen.py): one row per (pair, wire) at its
    tallest rank rung: GB/s, the planner's wire against the naive one,
    and the accounted against the declared memory factor (the JAX
    package's table, word for word); rows from the card add a column,
    the allocator's peak factor with the ops' temporaries.
    The counterpart of tpu_reductions/bench/reshard_curve.py:204."""
    rows = [r for r in data.get("rows", []) if isinstance(r, dict)]
    if not rows:
        return ""
    tall = {}
    for r in rows:
        key = (r["pair"], r["wire"])
        if key not in tall or r["ranks"] > tall[key]["ranks"]:
            tall[key] = r
    ranks = sorted({r["ranks"] for r in rows})
    n_fail = sum(1 for r in rows if r.get("status") != "PASSED")
    card = any(r.get("device_mem_factor") is not None for r in rows)
    lines = [
        "### Redistribution curve (reshard engine)",
        "",
        f"{len(rows)} cells across ranks {ranks} at n={rows[0]['n']}"
        + (f" — **{n_fail} FAILED**" if n_fail else
           "; every cell oracle-verified within bound, every measured "
           "peak-memory factor within its plan's declared factor"),
        "",
        "| pair | wire | ranks | program | GB/s | plan wire | "
        "naive wire | mem (meas/decl) |" + (" card peak |" if card else ""),
        "|---|---|---|---|---|---|---|---|" + ("---|" if card else ""),
    ]
    for (pair, wire), r in sorted(tall.items()):
        naive = (f"{r['naive_wire_bytes']:.0f} B"
                 if r.get("naive_wire_bytes") is not None else "-")
        peak = r.get("device_mem_factor")
        lines.append(
            f"| {pair} | {wire} | {r['ranks']} "
            f"| {'+'.join(r['program']) or 'identity'} "
            f"| {r['gbps']:.3f} | {r['plan_wire_bytes']:.0f} B "
            f"| {naive} "
            f"| {r['measured_mem_factor']:.3f}/{r['mem_factor']:.3f} |"
            + ((f" {peak:.3f} |" if peak is not None else " - |")
               if card else ""))
    if card:
        lines += ["", "mem (meas/decl) is the JAX package's accounting, "
                  "computed from shapes; card peak is the allocator's "
                  "peak per rank during the step, over the global bytes, "
                  "the ops' temporaries included (not gated)."]
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the flags that
    tpu_reductions/bench/reshard_curve.py:244 parses in its main."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.reshard_curve",
        description="Redistribution GB/s x ranks x (source, target) "
                    "spec pairs: planner programs executed, "
                    "oracle-verified, memory-accounted",
    )
    p.add_argument("--n", type=int, default=DEFAULT_N,
                   help="Global element count of the 2-D payload; must "
                        "divide by --rows and by k*k for every rank "
                        "count (the permute piece grid)")
    p.add_argument("--rows", type=int, default=DEFAULT_ROWS,
                   help="Dim-0 extent; must divide by every rank count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ranks", type=str, default=None,
                   help="Comma-separated rank ladder "
                        f"(default {','.join(map(str, DEFAULT_RANKS))})")
    p.add_argument("--quant-bits", type=int, default=8,
                   choices=(0, 4, 8, 16),
                   help="Bit width of the quantized-wire rows "
                        "(0 disables them)")
    p.add_argument("--mem-bound", type=float, default=None,
                   help="Refuse plans whose declared peak-memory "
                        "factor exceeds this (reshard/planner.py)")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS,
                   help="gpu (default): the ranks are rows on the card; "
                        "cpu: on the host")
    p.add_argument("--out", type=str, default=DEFAULT_OUT)
    return p


def main(argv=None) -> int:
    """CLI: the spec-pair x rank-count redistribution sweep into one JSON
    artifact. Exit 0 when every cell PASSED, 1 otherwise, 2 on a usage
    error.
    The counterpart of tpu_reductions/bench/reshard_curve.py:244."""
    p = build_parser()
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.reshard_curve", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    try:
        ranks = (tuple(int(r) for r in ns.ranks.split(",") if r.strip())
                 if ns.ranks else DEFAULT_RANKS)
    except ValueError:
        p.error("--ranks must be comma-separated ints")
    if not ranks or any(k < 2 for k in ranks):
        p.error(f"--ranks must all be >= 2, got {ns.ranks!r}")
    if any(ns.n % (k * k) for k in ranks) or ns.n % ns.rows:
        p.error(f"--n={ns.n} must divide by --rows={ns.rows} and by "
                f"k*k for every rank count {ranks}")
    if any(ns.rows % k for k in ranks) \
            or any((ns.n // ns.rows) % k for k in ranks):
        p.error(f"--rows={ns.rows} and --n/--rows={ns.n // ns.rows} "
                f"must both divide by every rank count {ranks}")
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
    logger = BenchLogger(None, None, console=sys.stdout)
    rows = run_curve(n=ns.n, rows=ns.rows, seed=ns.seed, ranks=ranks,
                     quant_bits=ns.quant_bits or None,
                     mem_bound=ns.mem_bound, out=ns.out,
                     platform=ns.platform, logger=logger)
    if ns.out:
        print(f"wrote {ns.out}")
    bad = [r for r in rows if r["status"] != "PASSED"]
    for r in bad:
        print(f"FAILED: {r['pair']} {r['wire']} k={r['ranks']}: "
              f"err {r['max_err']:.3e} bound {r['bound']:.3e} "
              f"mem {r['measured_mem_factor']}/{r['mem_factor']}",
              file=sys.stderr)
    return 1 if bad or not rows else 0


if __name__ == "__main__":
    sys.exit(main())
