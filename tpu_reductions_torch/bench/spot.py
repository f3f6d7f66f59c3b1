"""Spot checks: several methods at one fixed kernel geometry, one JSON
artifact.

The counterpart of tpu_reductions/bench/spot.py:1: each method runs the
benchmark driver's chained, oracle-verified row at the same geometry, and
its row is persisted the moment it lands. It measures op effects (is MIN
slower than SUM at one geometry?) and gives the double scoreboard (f64
SUM/MIN/MAX at n = 2^24). Backends are the port's: `cuda` (`auto` picks
it) where the JAX package has `pallas`, `torch` where it has `xla`; f64
takes the driver's `--f64` route. A method whose run raises is a FAILED
row and the others still run. Each method is one retried task of the
execution core (exec/core.py), whose retry never fires on a card, which
is untunneled. A re-invocation against an interrupted artifact (`complete:
false`, the same meta) reuses its rows, keyed by method.

CLI:
    python -m tpu_reductions_torch.bench.spot --type=double \\
        --methods=SUM,MIN,MAX --n=16777216 [--kernel=6 --threads=512] \\
        [--f64=dd] [--platform=cpu] --out=double_spot.json

Exit 0 when every row is PASSED or WAIVED, else 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import List, Optional

from tpu_reductions_torch.config import (BACKENDS, DTYPE_ALIASES, F64_ROUTES,
                                         METHODS, PLATFORMS, ReduceConfig)
from tpu_reductions_torch.utils.logging import BenchLogger


def _row(cfg: ReduceConfig, res) -> dict:
    """One spot row: the BenchResult's fields and the geometry a reader
    needs to reproduce it."""
    row = res.to_dict()
    row["threads"] = cfg.threads
    row["max_blocks"] = cfg.max_blocks
    row["chain_reps"] = cfg.chain_reps
    return row


def run_spots(base: ReduceConfig, methods: List[str],
              logger: Optional[BenchLogger] = None,
              on_result=None, resume=None) -> List[dict]:
    """Run `methods` one after another at base's geometry; each row goes
    to on_result as soon as it verifies. `resume(method)`, when given,
    returns an interrupted run's reusable row, and the method is not
    measured again.
    The counterpart of tpu_reductions/bench/spot.py:50."""
    # imported here, so that tests can replace driver.run_benchmark
    from tpu_reductions_torch.bench.driver import crash_result, run_benchmark
    from tpu_reductions_torch.exec import core as exec_core
    from tpu_reductions_torch.exec.plan import device_task

    logger = logger or BenchLogger(None, None)
    rows = []
    for method in methods:
        prior = resume(method) if resume is not None else None
        if prior is not None:
            logger.log(f"spot {method}: resumed from the prior artifact "
                       "(interrupted run; row reused, not measured again)")
            rows.append(prior)
            if on_result is not None:
                on_result(prior)
            continue
        cfg = dataclasses.replace(base, method=method)
        try:
            res = exec_core.run(device_task(
                f"spot/{method.lower()}",
                lambda: run_benchmark(cfg, logger=logger),
                retry_log=logger.log, method=method, dtype=cfg.dtype,
                n=cfg.n))
        except Exception as e:  # contained to this method's row
            res = crash_result(cfg, e, logger)
        row = _row(cfg, res)
        rows.append(row)
        if on_result is not None:
            on_result(row)
    return rows


def main(argv=None) -> int:
    """CLI: several methods at one fixed geometry, chained and verified.
    The counterpart of tpu_reductions/bench/spot.py:105."""
    from tpu_reductions_torch.bench.resume import Checkpoint

    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.spot",
        description="Oracle-verified chained spot check: several methods "
                    "at one fixed kernel geometry, one JSON artifact")
    p.add_argument("--methods", type=str, default="SUM,MIN,MAX",
                   help="Comma-separated list (reference op order is "
                        "MAX,MIN,SUM)")
    p.add_argument("--type", dest="dtype", type=str, default="int")
    p.add_argument("--n", type=int, default=1 << 24)
    p.add_argument("--kernel", type=int, default=6)
    p.add_argument("--threads", type=int, default=512)
    p.add_argument("--maxblocks", dest="max_blocks", type=int, default=64)
    p.add_argument("--streambuffers", dest="stream_buffers", type=int,
                   default=4)
    p.add_argument("--backend", type=str, default="auto",
                   choices=list(BACKENDS),
                   help="cuda: the hand-written kernels (auto picks them); "
                        "torch: the comparator at the same discipline")
    p.add_argument("--f64", type=str, default="native", choices=F64_ROUTES,
                   help="float64's route, as the driver's --f64")
    p.add_argument("--iterations", type=int, default=256,
                   help="Chained span (k_hi = 1 + iterations)")
    p.add_argument("--chainreps", dest="chain_reps", type=int, default=7)
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS)
    p.add_argument("--out", type=str, default=None)
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.spot", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    methods = [m.strip().upper() for m in ns.methods.split(",") if m.strip()]
    if not methods or any(m not in METHODS for m in methods):
        p.error(f"--methods must name only {METHODS}, got {ns.methods!r}")
    if ns.dtype not in DTYPE_ALIASES:
        p.error(f"unknown --type {ns.dtype!r}")
    if ns.n <= 0:
        p.error("--n must be positive")

    base = ReduceConfig(method=methods[0], dtype=ns.dtype, n=ns.n,
                        backend=ns.backend, kernel=ns.kernel,
                        threads=ns.threads, max_blocks=ns.max_blocks,
                        stream_buffers=ns.stream_buffers,
                        iterations=ns.iterations, warmup=2,
                        timing="chained", chain_reps=ns.chain_reps,
                        stat="median", f64=ns.f64, platform=ns.platform,
                        log_file=None)
    logger = BenchLogger(None, None, console=sys.stderr)
    # the resume contract: an interrupted run's rows are reused only when
    # every key matches
    meta = {"dtype": DTYPE_ALIASES[ns.dtype], "n": ns.n,
            "kernel": ns.kernel, "threads": ns.threads,
            "timing": "chained", "stat": "median",
            "backend": ns.backend, "iterations": ns.iterations,
            "chain_reps": ns.chain_reps, "max_blocks": ns.max_blocks,
            "stream_buffers": ns.stream_buffers, "f64": ns.f64}
    ck = Checkpoint(ns.out, meta, key_fn=lambda r: r.get("method"))
    rows = run_spots(base, methods, logger=logger, on_result=ck.add,
                     resume=ck.resume)
    for r in rows:
        gbps = r["gbps"]
        shown = ("n/a" if gbps is None or not math.isfinite(gbps)
                 else format(gbps, "10.2f"))
        print(f"{r['dtype']:>9} {r['method']:>4} n={r['n']:>10} {shown} "
              f"GB/s [{r['status']}]")
    if ns.out:
        ck.finalize()
        print(f"wrote {ns.out}")
    # a by-design waiver is no failure; a FAILED row or an empty run is
    return 0 if rows and all(r["status"] in ("PASSED", "WAIVED")
                             for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
