"""The accuracy-vs-bandwidth curve of the quantized collectives.

The counterpart of tpu_reductions/bench/quant_curve.py:1. The quantized
suite (collectives/quant.py, the EQuARX wire) trades wire bytes for a
bounded accumulation error; this instrument measures both sides of that
trade on one grid:

  * wire reduction: the declared wire factor of the selected quantized
    algorithm against the unquantized selection for the same geometry,
    both from the registry (collectives/algorithms.py);
  * accuracy: max |quantized - float64 host oracle| over every replica
    of a cell, beside the declared bound (quant.quant_error_bound). A
    cell whose error exceeds its bound FAILS; MIN/MAX travel as
    order-preserving keys and must be exact (bound 0).

Grid: SUM x {float32, bfloat16, float64} x bits {4, 8, 16} and MIN/MAX x
{float32, float64} x bits {8, 16}, each over the rank ladder (2..64 by
default). float64 rides the dd planes (ops/dd_reduce.py), on the card
too. Each (dtype, k) draws its payload from default_rng([seed, k]), the
JAX package's draw, so both packages' curves measure the same data.

Every cell persists as it lands and resumes (bench/resume.Checkpoint,
keyed (op, dtype, bits, ranks)); rows print in the
`DATATYPE OP BITS NODES WIREX MAXERR BOUND` grammar.

CLI:
    python -m tpu_reductions_torch.bench.quant_curve [--platform=cpu]
        [--n=1048576 --ranks=2,4,8,16,32,64 --seed=0] [--bits=8,16]
        [--out=out/quant_curve.json]
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path
from typing import List, Optional

from tpu_reductions_torch.config import PLATFORMS
from tpu_reductions_torch.obs import ledger, trace
from tpu_reductions_torch.utils import heartbeat
from tpu_reductions_torch.utils.logging import (QUANT_CURVE_HEADER,
                                                BenchLogger, quant_curve_row)

# the grid: every (op, dtype) the quantized suite supports, at every
# registered bit width (collectives/quant.QUANT_BITS/KEY_BITS)
SUM_DTYPES = ("float32", "bfloat16", "float64")
SUM_BITS = (4, 8, 16)
MINMAX_DTYPES = ("float32", "float64")
MINMAX_BITS = (8, 16)
DEFAULT_RANKS = (2, 4, 8, 16, 32, 64)
DEFAULT_OUT = "out/quant_curve.json"


def curve_cells(ranks=DEFAULT_RANKS, bits: Optional[tuple] = None
                ) -> List[tuple]:
    """The (method, dtype, bits, ranks) grid in artifact order: SUM
    first (its rows carry the bound story), then MIN and MAX; the rank
    ladder innermost, like submit_all.sh's node fan-out.
    The counterpart of tpu_reductions/bench/quant_curve.py:59."""
    cells = []
    for dtype in SUM_DTYPES:
        for b in (bits or SUM_BITS):
            if b not in SUM_BITS:
                continue
            for k in ranks:
                cells.append(("SUM", dtype, b, k))
    for method in ("MIN", "MAX"):
        for dtype in MINMAX_DTYPES:
            for b in (bits or MINMAX_BITS):
                if b not in MINMAX_BITS:
                    continue
                for k in ranks:
                    cells.append((method, dtype, b, k))
    return cells


@functools.lru_cache(maxsize=8)
def _normals(k: int, n: int, seed: int):
    """default_rng([seed, k])'s n standard normals, drawn once for every
    cell that shares them (read-only)."""
    import numpy as np
    x64 = np.random.default_rng([seed, k]).standard_normal(n)
    x64.setflags(write=False)
    return x64


@functools.lru_cache(maxsize=4)
def _planes(kind: str, k: int, n: int, seed: int):
    """The float64 draw's dd planes ("split") or order-key planes
    ("keys"), made once for the cells that share them."""
    from tpu_reductions_torch.ops.dd_reduce import host_key_encode, host_split
    return (host_split if kind == "split" else host_key_encode)(
        _normals(k, n, seed))


def _draw(dtype: str, k: int, n: int, seed: int):
    """The cell's payload, as the JAX package draws it: float64 from
    default_rng([seed, k]); float32 its cast; bfloat16 the float32 draw
    rounded to nearest even. Returns (payload tensor, its float64 view
    on the host, max |x|)."""
    import numpy as np
    import torch

    x64 = _normals(k, n, seed)
    if dtype == "float64":
        return torch.from_numpy(x64.copy()), x64, float(np.abs(x64).max())
    x = torch.from_numpy(x64.astype(np.float32))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    x64 = x.float().double().numpy()
    return x, x64, float(np.abs(x64).max())


def measure_cell(method: str, dtype: str, bits: int, k: int, n: int,
                 seed: int, platform: str = "gpu",
                 witness=None) -> Optional[dict]:
    """One curve cell: the selected quantized collective on a k-rank mesh
    on `platform`, its result against the float64 host oracle, the error
    beside the declared bound and the registry's wire accounting. SUM
    passes within its bound, MIN/MAX only when exact, and either only
    when every replica holds rank 0's bits (compared on the device).

    In a joined group the mesh lies on the processes in blocks
    (parallel/mesh.build_mesh): every replica is held against rank 0's
    row across them, each process of the mesh computes the error from
    its row (rank 0's bits, or the cell fails everywhere), and a process
    outside the mesh returns None. `witness` (bench/multicard.Witness)
    records rank 0's row.
    The counterpart of tpu_reductions/bench/quant_curve.py:83."""
    import numpy as np
    import torch

    from tpu_reductions_torch.collectives import (
        make_quant_key_minmax_all_reduce, make_quant_sum_all_reduce,
        quant_error_bound, select_algorithm, shard_payload)
    from tpu_reductions_torch.collectives.core import replicas_agree
    from tpu_reductions_torch.parallel.mesh import build_mesh

    if n % k:
        raise ValueError(f"--n={n} must divide by every rank count "
                         f"(got k={k})")
    per_rank = n // k
    dd = dtype == "float64"
    sel_q = select_algorithm(method, dtype, k, per_rank,
                             quantized=True, bits=bits, dd_planes=dd)
    sel_b = select_algorithm(method, dtype, k, per_rank, dd_planes=dd)
    ledger.emit("collective.select", algorithm=sel_q.algorithm,
                method=method, dtype=dtype, ranks=k, bits=bits,
                wire_factor=round(sel_q.wire_factor, 6),
                baseline=sel_b.algorithm,
                baseline_wire_factor=round(sel_b.wire_factor, 6),
                quantized=True)
    mesh = build_mesh(num_devices=k, platform=platform, local_ranks=k)
    if not mesh.member:
        return None         # a process outside the cell's mesh
    # one draw for every (bits, op) at a (dtype, k): the curve compares
    # bit widths on the same data
    x, x64, m_abs = _draw(dtype, k, n, seed)
    blocks = x64.reshape(k, -1)
    if method == "SUM":
        want = blocks.sum(axis=0)
    else:
        want = (np.minimum if method == "MIN"
                else np.maximum).reduce(blocks, axis=0)
    if dd:
        planes = _planes("split" if method == "SUM" else "keys", k, n, seed)
        staged = [shard_payload(p, mesh) for p in planes]
    else:
        staged = [shard_payload(x, mesh)]
    fn = (make_quant_sum_all_reduce(mesh, bits=bits, dtype=dtype)
          if method == "SUM" else
          make_quant_key_minmax_all_reduce(method, mesh, bits=bits,
                                           dtype=dtype))
    # one span per cell; its one device region under a heartbeat guard
    with trace.child():
        ledger.emit("collective.launch", algorithm=sel_q.algorithm,
                    method=method, dtype=dtype, ranks=k, n=int(n))
        t0 = time.perf_counter()
        # redlint: disable=RED025 -- one guard around a cell's heterogeneous device region (the quantized collective and its verify); the cell's resilience contract is checkpoint resume, not plan retry
        with heartbeat.guard("collective"):
            out = fn(*staged)
            out = out if isinstance(out, tuple) else (out,)
            replicas = replicas_agree(out, mesh)
            rank0 = [o[0].cpu() for o in out]
        ledger.emit("collective.done", algorithm=sel_q.algorithm,
                    method=method, dtype=dtype, ranks=k,
                    wall_s=round(time.perf_counter() - t0, 6), rows=1)
    if dd and method == "SUM":
        got = rank0[0].numpy().astype(np.float64) + rank0[1].numpy()
    elif dd:
        from tpu_reductions_torch.ops.dd_reduce import host_key_decode
        got = host_key_decode(rank0[0].numpy(), rank0[1].numpy())
    else:
        got = rank0[0].to(torch.float32).numpy().astype(np.float64)
    bound = quant_error_bound(method, dtype, bits, k, m_abs)
    max_err = float(np.abs(got - want).max())
    exact = bool(np.array_equal(got, want))
    ok = replicas and (exact if bound == 0.0 else max_err <= bound)
    if witness is not None:
        from tpu_reductions_torch.bench.collective_driver import \
            bits_required
        from tpu_reductions_torch.collectives.core import _host
        # the decoded row first (what a tolerance holds), then its
        # planes; the dd planes travel and add as float32
        witness.record("quant", (method, dtype, bits, k),
                       [got, *(_host(r) for r in rank0)], mesh,
                       exact=bits_required(method, dtype, sel_q.algorithm),
                       replicated=True, method=method,
                       dtype="float32" if dd else dtype, n=n)
    return {"method": method, "dtype": dtype, "bits": bits,
            "ranks": k, "n": int(n),
            "algorithm": sel_q.algorithm,
            "baseline_algorithm": sel_b.algorithm,
            "wire_factor": sel_q.wire_factor,
            "baseline_wire_factor": sel_b.wire_factor,
            "wire_reduction": sel_b.wire_factor / sel_q.wire_factor,
            "max_err": max_err, "bound": bound, "exact": exact,
            "status": "PASSED" if ok else "FAILED"}


def run_curve(*, n: int, seed: int, ranks=DEFAULT_RANKS,
              bits: Optional[tuple] = None, out: Optional[str] = None,
              platform: str = "gpu",
              logger: Optional[BenchLogger] = None,
              witness=None) -> List[dict]:
    """The grid, each cell persisted as it lands and resumed from an
    interrupted `out` (bench/resume.run_checkpointed_cells). Returns the
    rows in grid order. In a joined group every process runs the grid
    (the cells a process is outside of add no row) and only rank 0
    writes `out` (bench/multicard.shared_checkpoint).
    The counterpart of tpu_reductions/bench/quant_curve.py:208."""
    from tpu_reductions_torch.bench.multicard import shared_checkpoint
    from tpu_reductions_torch.bench.resume import run_checkpointed_cells
    logger = logger or BenchLogger(None, None)
    ck = shared_checkpoint(out, {"n": n, "seed": seed},
                           key_fn=lambda r: (r.get("method"),
                                             r.get("dtype"), r.get("bits"),
                                             r.get("ranks")))
    logger.log(QUANT_CURVE_HEADER)

    def measure(key):
        method, dtype, b, k = key
        return measure_cell(method, dtype, b, k, n, seed, platform,
                            witness=witness)

    def on_row(key, row):
        _, dtype, b, k = key
        logger.log(quant_curve_row(dtype, row["method"], b, k,
                                   row["wire_reduction"], row["max_err"],
                                   row["bound"]))

    try:
        return run_checkpointed_cells(ck, curve_cells(ranks, bits),
                                      measure, on_row)
    finally:
        # the draws a run shared among its cells: up to 1.5 GiB at 2^24
        _normals.cache_clear()
        _planes.cache_clear()


def quant_curve_markdown(data: dict) -> str:
    """The report fold (bench/regen.py): one row per (op, dtype, bits) at
    its worst rung. The wire factors are registry constants that both
    sides scale by (k-1)/k, so the rank axis only moves the error.
    The counterpart of tpu_reductions/bench/quant_curve.py:239."""
    rows = [r for r in data.get("rows", []) if isinstance(r, dict)]
    if not rows:
        return ""
    cells = {}
    for r in rows:
        key = (r["method"], r["dtype"], r["bits"])
        prev = cells.get(key)
        if prev is None or r["max_err"] > prev["max_err"]:
            cells[key] = r
    ranks = sorted({r["ranks"] for r in rows})
    n_fail = sum(1 for r in rows if r.get("status") != "PASSED")
    lines = [
        "### Accuracy vs bandwidth (quantized collectives)",
        "",
        f"{len(rows)} cells across ranks {ranks} at n={rows[0]['n']}"
        + (f" — **{n_fail} exceeded their declared bound**" if n_fail
           else "; every measured error within its declared bound"),
        "",
        "| op | dtype | bits | algorithm | wire reduction | "
        "worst max err | declared bound | exact |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (method, dtype, bits), r in sorted(cells.items()):
        lines.append(
            f"| {method} | {dtype} | {bits} | {r['algorithm']} "
            f"| {r['wire_reduction']:.3f}x | {r['max_err']:.3e} "
            f"| {r['bound']:.3e} "
            f"| {'yes' if r['exact'] else 'no'} |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the flags that
    tpu_reductions/bench/quant_curve.py:278 parses in its main."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.quant_curve",
        description="Accuracy-vs-bandwidth curve of the quantized "
                    "collective suite: wire reduction + measured error "
                    "vs declared bound, per (op, dtype, bits, ranks)",
    )
    p.add_argument("--n", type=int, default=1 << 20,
                   help="Global element count; must divide by every rank "
                        "count AND keep per-rank a multiple of "
                        "ranks*256 so the quantized ring engages "
                        "(collectives/quant.quant_ring_applies)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ranks", type=str, default=None,
                   help="Comma-separated rank ladder "
                        f"(default {','.join(map(str, DEFAULT_RANKS))})")
    p.add_argument("--bits", type=str, default=None,
                   help="Comma-separated bit widths to restrict the grid")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS,
                   help="gpu (default): the ranks are rows on the card; "
                        "cpu: on the host")
    p.add_argument("--out", type=str, default=DEFAULT_OUT)
    return p


def main(argv=None) -> int:
    """CLI: bits x rank count x op into one JSON artifact. Exit 0 when
    every cell PASSED, 1 otherwise, 2 on a usage error.
    The counterpart of tpu_reductions/bench/quant_curve.py:278."""
    p = build_parser()
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.quant_curve", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    try:
        ranks = (tuple(int(r) for r in ns.ranks.split(",") if r.strip())
                 if ns.ranks else DEFAULT_RANKS)
        bits = (tuple(int(b) for b in ns.bits.split(",") if b.strip())
                if ns.bits else None)
    except ValueError:
        p.error("--ranks/--bits must be comma-separated ints")
    if not ranks or any(k < 2 for k in ranks):
        p.error(f"--ranks must all be >= 2, got {ns.ranks!r}")
    if any(ns.n % k for k in ranks):
        p.error(f"--n={ns.n} must divide by every rank count {ranks}")
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
    logger = BenchLogger(None, None, console=sys.stdout)
    rows = run_curve(n=ns.n, seed=ns.seed, ranks=ranks, bits=bits,
                     out=ns.out, platform=ns.platform, logger=logger)
    if ns.out:
        print(f"wrote {ns.out}")
    bad = [r for r in rows if r["status"] != "PASSED"]
    for r in bad:
        print(f"FAILED: {r['method']} {r['dtype']} {r['bits']}b "
              f"k={r['ranks']}: err {r['max_err']:.3e} > bound "
              f"{r['bound']:.3e}", file=sys.stderr)
    return 1 if bad or not rows else 0


if __name__ == "__main__":
    sys.exit(main())
