"""The reduction family's spot grid: SCAN / SEG* / ARG* measured and
verified.

The counterpart of tpu_reductions/bench/family_spot.py:1. Every (method,
dtype, impl) cell is verified against the host oracle by a launch of its
own, one retried task of the execution core (exec/core.py), before any
time is taken: SCAN element by
element against the float64/int64 prefix (family.host_scan; int32
bit-exact through the mod-2^32 wrap), SEG* segment by segment against
host_segment_reduce (ragged random offsets, empty segments included),
ARG* index against numpy's first occurrence. Then a scalar digest of the
cell (SCAN's last element, the masked sum of the segments, the index)
is timed by the chain (ops/chain.py: on the card, one CUDA graph a trip),
whose only job is the data dependence; verification never reads it. The
chain's span is the JAX package's rate-model span, cut to about 6 ms of
the digest's measured time where a cell runs far below the memory rate
(the segmented cells). The SCAN cells race both implementations,
mxu-scan against xla-cumsum; their rates price the cost oracle's scan
axis (exec/cost.pick_scan). Then the three serving rows (SERVE_CELLS):
`--serve-n`-element requests of one method per family group through an
in-process serving engine (serve/), each of which must resolve `ok`.

Every cell persists the moment it lands and resumes (bench/resume,
keyed by (kind, method, dtype, impl)). Rows print in the
`DATATYPE OP IMPL N GBPS STATUS` grammar; bench/regen folds the table
into report.md.

CLI:
    python -m tpu_reductions_torch.bench.family_spot [--platform=cpu] \\
        [--n=1048576 --serve-n=16384 --segments=64 --seed=0 --reps=5] \\
        --out=family_spot.json

Exit 0 when every cell PASSED, else 1.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import PLATFORMS
from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils.staging import stage_flat
from tpu_reductions_torch.utils.logging import (FAMILY_HEADER, BenchLogger,
                                                family_row)

# the grid: every family method x dtype the family supports (no family
# f64), SCAN racing both implementations where legal
FAMILY_DTYPES = ("int32", "float32")
SEG_METHODS = ("SEGSUM", "SEGMIN", "SEGMAX")
ARG_METHODS = ("ARGMIN", "ARGMAX")
# the serving rows: one method per family group, served end to end
SERVE_CELLS = (("SCAN", "float32"), ("SEGSUM", "int32"),
               ("ARGMAX", "float32"))


def family_cells() -> List[tuple]:
    """The (kind, method, dtype, impl) grid in artifact order: scan, then
    the segmented group, then arg, then the serving rows.
    The counterpart of tpu_reductions/bench/family_spot.py:63."""
    from tpu_reductions_torch.ops.family import scan_impls
    cells = []
    for dtype in FAMILY_DTYPES:
        for impl in scan_impls(dtype):
            cells.append(("cell", "SCAN", dtype, impl))
    for method in SEG_METHODS:
        for dtype in FAMILY_DTYPES:
            cells.append(("cell", method, dtype, "seg"))
    for method in ARG_METHODS:
        for dtype in FAMILY_DTYPES:
            cells.append(("cell", method, dtype, "argk"))
    for method, dtype in SERVE_CELLS:
        cells.append(("serve", method, dtype, "serve"))
    return cells


def _verify(method: str, dtype: str, x: np.ndarray, got: np.ndarray,
            offsets) -> tuple:
    """(ok, max_err) of a verification launch's full result against the
    host oracle (module docstring)."""
    from tpu_reductions_torch.ops.family import (host_arg_reduce, host_scan,
                                                 host_segment_reduce)
    from tpu_reductions_torch.ops.registry import tolerance

    if method == "SCAN":
        want = host_scan(x)
        if dtype == "int32":
            return bool(np.array_equal(got, want)), float(
                np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
        err = float(np.abs(got.astype(np.float64) - want).max())
        return err <= tolerance("SUM", dtype, x.size), err
    if method in SEG_METHODS:
        want = host_segment_reduce(x, offsets, method)
        got64 = got.astype(np.float64)
        if method == "SEGSUM" and dtype != "int32":
            finite = np.isfinite(want)
            err = float(np.abs(got64[finite] - want[finite]).max())
            return err <= tolerance("SUM", dtype, x.size), err
        # int32 (exact through the wrap) and MIN/MAX (exact; the +-inf
        # identities of empty segments compare equal) match exactly
        eq = bool(np.array_equal(got64, want))
        with np.errstate(invalid="ignore"):
            err = float(np.nan_to_num(np.abs(got64 - want), nan=0.0,
                                      posinf=0.0).max())
        return eq, err
    want = host_arg_reduce(x, method)
    return int(got) == int(want), float(abs(int(got) - int(want)))


def _cell_fns(method: str, dtype: str, impl: str, x: torch.Tensor,
              segments: int, seed: int):
    """(full, core, offsets): the cell's whole result of a 1-D payload,
    its scalar digest of the (rows, 128) view, and the segment offsets
    (None outside SEG*)."""
    from tpu_reductions_torch.ops.family import (arg_reduce_fn,
                                                 random_offsets, scan_fn,
                                                 segment_ids_from_offsets,
                                                 segment_reduce_fn)

    n = x.numel()
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if method == "SCAN":
        fn = scan_fn(impl, dtype)
        return (lambda x1d: fn(x1d, zero),
                lambda xx: fn(xx.reshape(-1), zero)[-1], None)
    if method in SEG_METHODS:
        offsets = random_offsets(n, segments, seed)
        ids = stage_flat(torch.from_numpy(segment_ids_from_offsets(
            offsets)).to(torch.int64), x.device)
        mask = stage_flat(torch.from_numpy(np.diff(offsets) > 0), x.device)
        sfn = segment_reduce_fn(method, segments)

        def core(xx):
            # the digest masks the identities of empty segments (+-inf
            # for float MIN/MAX), so the scalar stays finite
            segs = sfn(xx.reshape(-1), ids)
            return torch.where(mask, segs, zero).sum(dtype=x.dtype)

        return (lambda x1d: sfn(x1d, ids)), core, offsets
    fn = arg_reduce_fn(method, dtype)
    return fn, (lambda xx: fn(xx.reshape(-1))), None


def _span(core, x2d: torch.Tensor, dtype: str, device: torch.device) -> int:
    """The chain's span: auto_chain_span's, cut to about SPAN_SIGNAL_S of
    the digest's own measured time where the cell runs below the memory
    rate that span assumes (a segmented reduce by atomics into 64
    segments does, by two orders of magnitude)."""
    from tpu_reductions_torch.ops.chain import (SPAN_MIN, SPAN_SIGNAL_S,
                                                auto_chain_span)
    core(x2d)                               # first-use costs
    device_mod.synchronize(device)
    # redlint: disable=RED002 -- sizes the chain's span from one digest's host seconds; the cell's time is the chained slope of utils/timing.py
    t0 = time.perf_counter()
    core(x2d)
    device_mod.synchronize(device)
    # redlint: disable=RED002 -- closes the span-sizing window of the line above
    seconds = time.perf_counter() - t0
    span = auto_chain_span(x2d.numel(), dtype,
                           platform="cpu" if device.type == "cpu" else "gpu")
    return max(SPAN_MIN, min(span, math.ceil(SPAN_SIGNAL_S
                                             / max(seconds, 1e-9))))


def measure_cell(method: str, dtype: str, impl: str, n: int, segments: int,
                 seed: int, reps: int, device: torch.device) -> dict:
    """One grid cell: a verification launch (the full result against the
    host oracle), then the chained slope of the scalar digest.
    The counterpart of tpu_reductions/bench/family_spot.py:125."""
    from tpu_reductions_torch.exec import core as exec_core
    from tpu_reductions_torch.exec.plan import device_task
    from tpu_reductions_torch.ops.chain import make_chained_reduce
    from tpu_reductions_torch.ops.family import family_surface
    from tpu_reductions_torch.ops.oracle import host_value
    from tpu_reductions_torch.ops.registry import get_op
    from tpu_reductions_torch.utils.rng import host_data
    from tpu_reductions_torch.utils.timing import time_chained

    fault_point("family.cell")           # one cell, one interruptible unit
    x_host = host_data(n, dtype, rank=0, seed=seed)
    x = stage_flat(x_host, device)
    full, core, offsets = _cell_fns(method, dtype, impl, x, segments, seed)
    got = host_value(exec_core.run(device_task(
        family_surface(method, impl if method == "SCAN" else None),
        lambda: full(x), method=method, dtype=dtype, n=n)))
    ok, max_err = _verify(method, dtype, x_host.numpy(), got, offsets)

    x2d = x.reshape(-1, 128)
    chained = make_chained_reduce(core, get_op(method))
    span = _span(core, x2d, dtype, device)
    try:
        sw = time_chained(chained, x2d, 1, 1 + span, reps=reps)
    finally:
        chained.close()
    per_iter = sw.median_s
    nbytes = n * x.element_size()
    gbps = (nbytes / per_iter / 1e9) if per_iter > 0 else 0.0
    row = {"kind": "cell", "method": method, "dtype": dtype, "impl": impl,
           "n": int(n),
           "segments": segments if offsets is not None else None,
           "span": span, "reps": reps, "per_iter_s": per_iter,
           "gbps": round(gbps, 4), "max_err": max_err,
           "status": "PASSED" if ok else "FAILED"}
    ledger.emit("family.cell", method=method, dtype=dtype, impl=impl,
                n=int(n), gbps=row["gbps"], status=row["status"])
    return row


def measure_serve(method: str, dtype: str, n: int, requests: int = 3,
                  platform: str = "gpu") -> dict:
    """One serving row: `requests` ReduceRequests submitted to an
    in-process ServeEngine on the platform's device, each of which must
    resolve `ok` through the coalescing path
    (serve/executor._run_family_batch).
    The counterpart of tpu_reductions/bench/family_spot.py:218."""
    from tpu_reductions_torch.serve.engine import ServeEngine
    from tpu_reductions_torch.serve.request import ReduceRequest

    fault_point("family.cell")           # serving rows resume like cells
    eng = ServeEngine(coalesce_window_s=0.0, platform=platform).start()
    try:
        t0 = time.perf_counter()
        pends = [eng.submit(ReduceRequest(method=method, dtype=dtype,
                                          n=n, seed=s))
                 for s in range(requests)]
        resps = [p.result(timeout=120.0) for p in pends]
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    ok_n = sum(1 for r in resps if r.status == "ok")
    row = {"kind": "serve", "method": method, "dtype": dtype,
           "impl": "serve", "n": int(n), "requests": requests,
           "ok_count": ok_n, "gbps": 0.0,
           "latency_s": round(wall, 6),
           "status": "PASSED" if ok_n == requests else "FAILED"}
    ledger.emit("family.cell", method=method, dtype=dtype, impl="serve",
                n=int(n), gbps=0.0, status=row["status"])
    return row


def run_family_spot(*, n: int, segments: int, seed: int, reps: int,
                    serve_n: int = 1 << 14,
                    out: Optional[str] = None, platform: str = "gpu",
                    logger: Optional[BenchLogger] = None) -> List[dict]:
    """The grid and the serving rows, persisted and resumed a cell at a
    time.
    The counterpart of tpu_reductions/bench/family_spot.py:256."""
    from tpu_reductions_torch.bench.resume import (Checkpoint,
                                                   run_checkpointed_cells)
    device = device_mod.resolve(platform)
    logger = logger or BenchLogger(None, None)
    ck = Checkpoint(out, {"n": n, "serve_n": serve_n,
                          "segments": segments, "seed": seed,
                          "reps": reps, "timing": "chained",
                          "stat": "median"},
                    key_fn=lambda r: (r.get("kind", "cell"), r.get("method"),
                                      r.get("dtype"), r.get("impl")))
    logger.log(FAMILY_HEADER)

    def measure(key):
        kind, method, dtype, impl = key
        if kind == "serve":
            return measure_serve(method, dtype, serve_n, platform=platform)
        return measure_cell(method, dtype, impl, n, segments, seed, reps,
                            device)

    def on_row(key, row):
        logger.log(family_row(row["dtype"], row["method"], row["impl"],
                              row["n"], row["gbps"], row["status"]))

    return run_checkpointed_cells(ck, family_cells(), measure, on_row)


def family_spot_markdown(data: dict) -> str:
    """The family grid as one report.md table (bench/regen.py): GB/s per
    (method, dtype, impl) with its verdict, then the serving rows. Empty
    when there are no rows.
    The counterpart of tpu_reductions/bench/family_spot.py:290."""
    rows = [r for r in data.get("rows", []) if isinstance(r, dict)]
    if not rows:
        return ""
    cells = [r for r in rows if r.get("kind") != "serve"]
    serves = [r for r in rows if r.get("kind") == "serve"]
    n_fail = sum(1 for r in rows if r.get("status") != "PASSED")
    lines = [
        "### Reduction family (SCAN / segmented / argmin-argmax)",
        "",
        f"{len(cells)} chained-verified cells at n={data.get('n')}"
        + (f" — **{n_fail} FAILED**" if n_fail
           else "; every cell oracle-verified")
        + " (`python -m tpu_reductions_torch.bench.family_spot`).",
        "",
        "| method | dtype | impl | GB/s | max err | status |",
        "|---|---|---|---|---|---|",
    ]
    for r in cells:
        lines.append(
            f"| {r['method']} | {r['dtype']} | {r['impl']} "
            f"| {r['gbps']:.3f} | {r.get('max_err', 0.0):.3e} "
            f"| {r['status']} |")
    if serves:
        lines += ["",
                  "| served method | dtype | n | requests ok | status |",
                  "|---|---|---|---|---|"]
        for r in serves:
            lines.append(
                f"| {r['method']} | {r['dtype']} | {r['n']} "
                f"| {r['ok_count']}/{r['requests']} | {r['status']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI: the family grid into one JSON artifact.
    The counterpart of tpu_reductions/bench/family_spot.py:333."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.family_spot",
        description="Reduction-family spot: SCAN (mxu-scan vs xla-cumsum), "
                    "segmented reduce, argmin/argmax; chained-timed, "
                    "oracle-verified")
    p.add_argument("--n", type=int, default=1 << 20,
                   help="Cell payload elements (a multiple of 128, for the "
                        "chained 2-D view)")
    p.add_argument("--serve-n", dest="serve_n", type=int,
                   default=1 << 14,
                   help="Per-request elements of the serving rows")
    p.add_argument("--segments", type=int, default=64,
                   help="Segment count of the SEG* cells (ragged random "
                        "offsets; empty segments occur)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=5,
                   help="Chained slope samples a cell (the median counts)")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS)
    p.add_argument("--out", type=str, default=None)
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.family_spot", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    if ns.n <= 0 or ns.n % 128:
        p.error(f"--n must be a positive multiple of 128, got {ns.n}")
    if ns.segments < 2 or ns.serve_n <= 0 or ns.reps < 1:
        p.error("--segments >= 2, --serve-n > 0, --reps >= 1 required")
    rows = run_family_spot(n=ns.n, segments=ns.segments, seed=ns.seed,
                           reps=ns.reps, serve_n=ns.serve_n, out=ns.out,
                           platform=ns.platform,
                           logger=BenchLogger(None, None,
                                              console=sys.stdout))
    if ns.out:
        print(f"wrote {ns.out}")
    bad = [r for r in rows if r.get("status") != "PASSED"]
    for r in bad:
        print(f"FAILED: {r['method']} {r['dtype']} {r.get('impl')} "
              f"(max_err {r.get('max_err')})", file=sys.stderr)
    return 1 if bad or not rows else 0


if __name__ == "__main__":
    sys.exit(main())
