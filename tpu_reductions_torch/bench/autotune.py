"""The kernel race: every live kernel and tile geometry of a grid, against
the torch comparator, ranked by verified GB/s.

The counterpart of tpu_reductions/bench/autotune.py:1, with the same grids
candidate for candidate. The geometry knobs are the tile rows (--threads
-> TM), the partial-block count (--maxblocks -> P, which only k7 reads)
and k10's pipeline depth (--streambuffers, the optional fourth element of
a grid entry). A candidate that FAILs verification ranks below every
PASSED one, so a wrong but fast kernel never wins; a candidate that raises
becomes a FAILED row and the race goes on.

Timing defaults to the chained slope mode (ops/chain.py), which cancels
the constant host costs of each call.

    python -m tpu_reductions_torch.bench.autotune --method=SUM --type=int \\
        --n=16777216 [--grid=default|fine|hbm|mxu] [--comparator] \\
        [--out=tune.json] [--platform=cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import List, Optional, Sequence, Tuple

from tpu_reductions_torch.bench.driver import (BenchResult, crash_result,
                                               run_benchmark,
                                               run_benchmark_batch)
from tpu_reductions_torch.bench.resume import Checkpoint, result_from_row
from tpu_reductions_torch.exec import core as exec_core
from tpu_reductions_torch.exec.plan import device_task
from tpu_reductions_torch.config import (DTYPE_ALIASES, KERNEL_ELEMENTWISE,
                                         KERNEL_MXU, KERNEL_SINGLE_PASS,
                                         KERNEL_STREAM, KERNEL_TWO_PASS,
                                         METHODS, PLATFORMS, TIMINGS,
                                         ReduceConfig)
from tpu_reductions_torch.utils.logging import BenchLogger

# (kernel, threads, max_blocks[, stream_buffers]): threads sweeps the tile
# height from one sublane group to the choose_tiling clamp of 2048;
# max_blocks matters only to k7, so the single-pass kernels pin it to 64.
DEFAULT_GRID: Tuple[Tuple[int, ...], ...] = tuple(
    [(KERNEL_SINGLE_PASS, t, 64) for t in (64, 128, 256, 512, 1024, 2048)]
    + [(KERNEL_ELEMENTWISE, t, 64) for t in (64, 128, 256, 512, 1024, 2048)]
    + [(KERNEL_TWO_PASS, t, mb) for t in (256, 1024) for mb in (64, 256)]
    # k9 races in float SUM; int/MIN/MAX races WAIVE it
    + [(KERNEL_MXU, t, 64) for t in (256, 512, 1024)]
    + [(KERNEL_STREAM, t, 64) for t in (256, 512)]
)

# A finer race around the k6 and k7 geometries.
FINE_GRID: Tuple[Tuple[int, ...], ...] = tuple(
    [(KERNEL_SINGLE_PASS, t, 64) for t in (320, 384, 448, 512, 640, 768)]
    + [(KERNEL_TWO_PASS, t, mb) for t in (128, 192, 256, 384, 512)
       for mb in (32, 64, 128)]
)

# The device-memory regime (run with --n >= 2^26): k10's depth race first
# (2, 4 and 8 stages), then large tiles for the other kernels.
HBM_GRID: Tuple[Tuple[int, ...], ...] = tuple(
    [(KERNEL_STREAM, 512, 64, d) for d in (4, 8, 2)]
    + [(KERNEL_TWO_PASS, 384, 64), (KERNEL_SINGLE_PASS, 512, 64)]
    + [(KERNEL_SINGLE_PASS, t, 64) for t in (1024, 2048)]
    + [(KERNEL_ELEMENTWISE, t, 64) for t in (1024, 2048)]
    + [(KERNEL_TWO_PASS, 384, 128), (KERNEL_TWO_PASS, 512, 64)]
    + [(KERNEL_STREAM, 1024, 64, d) for d in (2, 4, 8)]
    + [(KERNEL_STREAM, 256, 64, 4)]
)

# k9 against the other kernels, for float SUM.
MXU_GRID: Tuple[Tuple[int, ...], ...] = tuple(
    [(KERNEL_MXU, t, 64) for t in (256, 512, 1024)]
    + [(KERNEL_SINGLE_PASS, 512, 64), (KERNEL_TWO_PASS, 384, 64),
       (KERNEL_STREAM, 512, 64, 4)]
)

GRIDS = {"default": DEFAULT_GRID, "fine": FINE_GRID, "hbm": HBM_GRID,
         "mxu": MXU_GRID}


def candidate_configs(base: ReduceConfig,
                      grid: Sequence[Tuple[int, ...]] = DEFAULT_GRID,
                      comparator: bool = False) -> List[ReduceConfig]:
    """The grid's candidates, sharing base's op, dtype, n and timing. The
    optional fourth element sets k10's depth (base's otherwise).
    `comparator` puts one torch-backend row first, so that a cut race
    still holds the yardstick.
    The counterpart of tpu_reductions/bench/autotune.py:112."""
    cfgs = [dataclasses.replace(base, backend="cuda", kernel=g[0],
                                threads=g[1], max_blocks=g[2],
                                stream_buffers=(g[3] if len(g) > 3
                                                else base.stream_buffers))
            for g in grid]
    if comparator:
        cfgs.insert(0, dataclasses.replace(base, backend="torch",
                                           kernel=KERNEL_SINGLE_PASS,
                                           threads=256, max_blocks=64))
    return cfgs


def autotune(base: ReduceConfig,
             grid: Sequence[Tuple[int, ...]] = DEFAULT_GRID,
             logger: Optional[BenchLogger] = None,
             comparator: bool = False,
             on_result=None,
             resume=None) -> List[Tuple[ReduceConfig, BenchResult]]:
    """Race the grid; return (config, result) pairs, PASSED first, each
    group fastest first.

    `on_result(cfg, result)` fires as each candidate completes. Chained
    candidates run one at a time, and `resume(cfg)`, when given, returns a
    prior interrupted race's result for a candidate, which is then not
    raced again. The other timing modes run as one batch.
    The counterpart of tpu_reductions/bench/autotune.py:138."""
    logger = logger or BenchLogger(None, None)
    cfgs = candidate_configs(base, grid, comparator=comparator)
    if base.timing == "chained":
        results = []
        for cfg in cfgs:
            prior = resume(cfg) if resume is not None else None
            if prior is not None:
                logger.log(f"autotune kernel={cfg.kernel} "
                           f"threads={cfg.threads}: resumed from prior "
                           "race artifact")
                res = prior
            else:
                try:
                    res = exec_core.run(device_task(
                        f"autotune/k{cfg.kernel}",
                        lambda: run_benchmark(cfg, logger=logger),
                        retry_log=logger.log, method=cfg.method,
                        dtype=cfg.dtype, n=cfg.n, threads=cfg.threads,
                        max_blocks=cfg.max_blocks))
                except Exception as e:  # contained to this candidate's row
                    res = crash_result(cfg, e, logger)
            if on_result is not None:
                on_result(cfg, res)
            results.append(res)
    else:
        results = run_benchmark_batch(cfgs, logger=logger,
                                      on_result=on_result)
    pairs = list(zip(cfgs, results))
    pairs.sort(key=lambda cr: (not cr[1].passed, -cr[1].gbps))
    return pairs


def _row(cfg: ReduceConfig, res: BenchResult) -> dict:
    """One ranking row. The comparator has no geometry: null, not the
    values it was configured with. Non-finite GB/s is null (strict JSON
    has no Infinity or NaN)."""
    torch_row = cfg.backend == "torch"
    row = {"backend": cfg.backend,
           "kernel": None if torch_row else cfg.kernel,
           "threads": None if torch_row else cfg.threads,
           "max_blocks": None if torch_row else cfg.max_blocks,
           "gbps": (round(res.gbps, 4) if math.isfinite(res.gbps)
                    else None),
           "status": res.status.name}
    if not torch_row and cfg.kernel == KERNEL_STREAM:
        row["stream_buffers"] = cfg.stream_buffers
    return row


def _row_key(row: dict) -> tuple:
    """A row's identity in the artifact, the resume key."""
    return (row.get("backend"), row.get("kernel"), row.get("threads"),
            row.get("max_blocks"), row.get("stream_buffers"))


def _cfg_key(cfg: ReduceConfig) -> tuple:
    """The same key from a candidate: it must mirror _row, or resume would
    never match."""
    torch_row = cfg.backend == "torch"
    return (cfg.backend,
            None if torch_row else cfg.kernel,
            None if torch_row else cfg.threads,
            None if torch_row else cfg.max_blocks,
            cfg.stream_buffers if not torch_row
            and cfg.kernel == KERNEL_STREAM else None)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the flags that tpu_reductions/bench/autotune.py:253
    parses in its main."""
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.autotune",
        description="Race the kernels and tile geometries and report the "
                    "fastest verified configuration")
    p.add_argument("--method", type=str, default="SUM")
    p.add_argument("--type", dest="dtype", type=str, default="int")
    p.add_argument("--n", type=int, default=1 << 24)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--stat", type=str, default="median",
                   choices=("mean", "median"))
    p.add_argument("--timing", type=str, default="chained", choices=TIMINGS,
                   help="Sync discipline (default chained, ops/chain.py)")
    p.add_argument("--chainreps", dest="chain_reps", type=int, default=5)
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS,
                   help="gpu (default) or cpu, where the kernels' plain "
                        "PyTorch versions run")
    p.add_argument("--grid", type=str, default="default",
                   choices=sorted(GRIDS),
                   help="Candidate grid: 'default' spans the space, 'fine' "
                        "races around the k6/k7 geometries, 'hbm' the "
                        "device-memory regime (use --n >= 2^26), 'mxu' k9")
    p.add_argument("--comparator", action="store_true",
                   help="Add one torch-backend row to the race (the "
                        "baseline the kernels must beat)")
    p.add_argument("--out", type=str, default=None,
                   help="Write the ranked results as JSON to this path")
    return p


def main(argv=None) -> int:
    """CLI: race the grid, print the ranking and the best verified
    kernel row; exit 0 when there is one, 1 otherwise.
    The counterpart of tpu_reductions/bench/autotune.py:253."""
    p = build_parser()
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.autotune", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    if ns.dtype not in DTYPE_ALIASES:
        p.error(f"unknown --type {ns.dtype!r}")
    if ns.method.upper() not in METHODS:
        p.error(f"--method must be one of {METHODS}, got {ns.method!r}")
    if ns.n <= 0:
        p.error("--n must be positive")

    base = ReduceConfig(method=ns.method, dtype=ns.dtype, n=ns.n,
                        iterations=ns.iterations, warmup=ns.warmup,
                        stat=ns.stat, timing=ns.timing,
                        chain_reps=ns.chain_reps, platform=ns.platform,
                        log_file=None)
    logger = BenchLogger(None, None, console=sys.stderr)

    # the resume contract: a re-invocation reuses only rows raced under
    # the same op, dtype, n, grid and discipline
    meta = {"method": base.method, "dtype": base.dtype, "n": ns.n,
            "grid": ns.grid, "timing": ns.timing,
            "iterations": ns.iterations, "chain_reps": ns.chain_reps,
            "stat": ns.stat, "platform": ns.platform}
    ck = Checkpoint(ns.out, meta, rows_key="ranked", key_fn=_row_key,
                    sort_key=lambda r: (r["status"] != "PASSED",
                                        -(r["gbps"] or 0.0)))

    def persist(cfg, res):
        ck.add(_row(cfg, res), extra={"best": None})

    def resume_candidate(cfg):
        row = ck.resume(_cfg_key(cfg))
        return result_from_row(cfg, row) if row is not None else None

    pairs = autotune(base, grid=GRIDS[ns.grid], logger=logger,
                     comparator=ns.comparator, on_result=persist,
                     resume=(resume_candidate
                             if ns.timing == "chained" else None))
    rows = []
    for cfg, res in pairs:
        row = _row(cfg, res)
        rows.append(row)
        depth = (f" depth={cfg.stream_buffers}"
                 if row.get("stream_buffers") is not None else "")
        geom = ("(geometry n/a)          " if row["kernel"] is None else
                f"kernel={cfg.kernel} threads={cfg.threads:>5} "
                f"maxblocks={cfg.max_blocks:>4}{depth}")
        print(f"{cfg.backend:>6} {geom}  {res.gbps:10.2f} GB/s "
              f"[{res.status.name}]")
    # best: the fastest verified kernel row; the comparator is a fixed
    # yardstick, not a geometry to recommend, and must not hide a race in
    # which every kernel failed
    best = next((r for r, (cfg, res) in zip(rows, pairs)
                 if res.passed and cfg.backend == "cuda"), None)
    if best:
        bdepth = (f" depth={best['stream_buffers']}"
                  if best.get("stream_buffers") is not None else "")
        print(f"best: {best['backend']} kernel={best['kernel']} "
              f"threads={best['threads']} "
              f"maxblocks={best['max_blocks']}{bdepth} "
              f"-> {best['gbps']} GB/s")
    if ns.out:
        ck.finalize(extra={"best": best})
        print(f"wrote {ns.out}")
    return 0 if best else 1


if __name__ == "__main__":
    sys.exit(main())
