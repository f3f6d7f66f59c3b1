"""The size sweep (`--shmoo`): one verified row per n = 2^min..2^max.

The counterpart of `run_shmoo` and `_run_cells` in
tpu_reductions/bench/sweep.py, with the same sizes, iteration counts and
per-cell chained spans. The experiment sweep (`sweep_all`) and the rest of
that module are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from tpu_reductions_torch.bench.driver import (BenchResult, crash_result,
                                               resolved_timing, run_benchmark,
                                               run_benchmark_batch)
from tpu_reductions_torch.config import ReduceConfig
from tpu_reductions_torch.ops.chain import auto_chain_span
from tpu_reductions_torch.utils.logging import BenchLogger


def run_shmoo(cfg: ReduceConfig, *, min_pow: int = 10, max_pow: int = 24,
              skip_ns: Optional[set] = None, on_result=None,
              logger: Optional[BenchLogger] = None) -> List[BenchResult]:
    """cfg's (method, dtype) at n = 2^min_pow..2^max_pow, one row a size.

    `skip_ns`: sizes to leave out (the caller holds their rows already).
    `on_result(cfg, result)` fires as each cell completes. A chained cell's
    iterations are its span (ops/chain.auto_chain_span), bounded by an
    explicit --iterations; chained cells run one at a time, each one's
    crash contained to its row. The other timing modes run as one batch
    (driver.run_benchmark_batch), every timed loop before any result is
    fetched, with max(3, min(iterations, 2^28 // n)) iterations a cell.
    """
    logger = logger or BenchLogger(cfg.log_file, cfg.master_log)
    cfgs = []
    for p in range(min_pow, max_pow + 1):
        n = 1 << p
        if skip_ns and n in skip_ns:
            logger.log(f"shmoo n={n}: skipped (the caller holds its row)")
            continue
        if cfg.timing == "chained":
            # a default --iterations does not bound the span: 100 would
            # hold small payloads in the noise that sizing escapes
            iters = auto_chain_span(n, cfg.dtype, platform=cfg.platform)
            if cfg.iterations_explicit:
                iters = min(iters, max(cfg.iterations, 8))
            logger.log(f"shmoo n={n}: chained span {iters}")
        else:
            iters = max(3, min(cfg.iterations, (1 << 28) // n))
        cfgs.append(dataclasses.replace(cfg, n=n, iterations=iters))

    def log_row(sub, res):
        logger.log(f"shmoo {cfg.method} {cfg.dtype} n={sub.n} "
                   f"-> {res.gbps:.4f} GB/s [{res.status.name}]")

    # keyed on the discipline that runs: a chained request that falls
    # back to fetch (--cpufinal) keeps the batch's shared sync regime
    if resolved_timing(cfg) == "chained":
        return _run_cells(cfgs, logger, on_result, log_row)
    results = run_benchmark_batch(cfgs, logger=logger, on_result=on_result)
    for sub, res in zip(cfgs, results):
        log_row(sub, res)
    return results


def _run_cells(cfgs, logger, on_result, log_row) -> List[BenchResult]:
    """One cell at a time, a cell that raises becoming a FAILED row; so
    on_result fires, and can persist the row, after every cell.

    The JAX package runs each cell through its execution core, which
    retries a cell after a transient relay fault; the port has no
    execution core yet, so a cell is one plain call."""
    results = []
    for sub in cfgs:
        try:
            res = run_benchmark(sub, logger=logger)
        except Exception as e:  # contained to this cell's row
            res = crash_result(sub, e, logger)
        log_row(sub, res)
        if on_result is not None:
            on_result(sub, res)
        results.append(res)
    return results
