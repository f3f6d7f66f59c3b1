"""Smoke test: one small verified run of every kernel surface the races
and the family would otherwise meet first.

The counterpart of tpu_reductions/bench/smoke.py:1. There it front-loads
the discovery of a Mosaic lowering failure; here each case builds (at the
first launch of its library) and runs one chained, oracle-verified row
of a kernel geometry the races use (k10 at depths 2, 4, 8; k9 on f32 and
bf16; k8's largest tile; the f64 pair kernel for SUM and MIN), and each
family case one verified run of a family surface. The manifest records a
verdict per case; a case that raises is a FAILED row and the rest still
run. Each case is one retried task of the execution core
(exec/core.py), whose retry never fires on a card, which is untunneled
(docs/PORT.md "Serving on one card").

The dd cases carry kernel=None, as in the JAX package, and run the f64
pair route (`--f64=dd`): float64 runs natively on the card by default,
and would never launch the pair kernel they exist for.

CLI:
    python -m tpu_reductions_torch.bench.smoke [--platform=cpu] \\
        [--n=1048576] [--out=smoke.json]

Exit 0 when at least one case verified (as the JAX CLI), else 1.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import (KERNEL_ELEMENTWISE, KERNEL_MXU,
                                         KERNEL_STREAM, PLATFORMS,
                                         ReduceConfig)
from tpu_reductions_torch.utils.logging import BenchLogger
from tpu_reductions_torch.utils.staging import stage_flat

# (name, dtype, method, kernel, threads, stream_buffers, surface): the
# JAX package's cases and surface ids. kernel None: the f64 pair route.
CASES: Tuple[Tuple[str, str, str, Optional[int], int, int, str], ...] = (
    ("k10 stream depth=2", "int32", "SUM", KERNEL_STREAM, 512, 2, "k10@2"),
    ("k10 stream depth=4", "int32", "SUM", KERNEL_STREAM, 512, 4, "k10@4"),
    ("k10 stream depth=8", "int32", "SUM", KERNEL_STREAM, 512, 8, "k10@8"),
    ("k9 mxu f32", "float32", "SUM", KERNEL_MXU, 256, 4, "k9"),
    ("k9 mxu bf16", "bfloat16", "SUM", KERNEL_MXU, 256, 4, "k9"),
    ("k8 big-tile t=2048", "int32", "SUM", KERNEL_ELEMENTWISE, 2048, 4,
     "k8"),
    ("dd f64 sum pair-tree", "float64", "SUM", None, 256, 4, "dd"),
    ("dd f64 min key-pair", "float64", "MIN", None, 256, 4, "dd"),
)

# the family's surfaces: (name, surface), ids shared with bench/warm.py
# and ops/family.family_surface
FAMILY_CASES: Tuple[Tuple[str, str], ...] = (
    ("family mxu-scan f32", "mxu-scan"),
    ("family cumsum i32", "xla-cumsum"),
    ("family seg reduce", "seg/segsum"),
    ("family argk", "argk/argmin"),
)


def _family_case(surface: str, n: int, device: torch.device) -> bool:
    """One verified run of a family surface against the host oracle."""
    from tpu_reductions_torch.ops import family as fam
    from tpu_reductions_torch.ops.oracle import host_value
    from tpu_reductions_torch.ops.registry import tolerance
    from tpu_reductions_torch.utils.rng import host_data

    if surface in ("mxu-scan", "xla-cumsum"):
        dtype = "float32" if surface == "mxu-scan" else "int32"
        x = host_data(n, dtype, rank=0, seed=0)
        xd = stage_flat(x, device)
        got = host_value(fam.scan_fn(surface, dtype)(
            xd, torch.zeros((), dtype=xd.dtype, device=device)))
        want = fam.host_scan(x.numpy())
        if dtype == "int32":
            return bool(np.array_equal(got, want))
        err = float(np.abs(got.astype(np.float64) - want).max())
        return err <= tolerance("SUM", dtype, n)
    if surface.startswith("seg/"):
        x = host_data(n, "int32", rank=0, seed=0)
        offsets = fam.random_offsets(n, 16, 0)
        ids = torch.from_numpy(fam.segment_ids_from_offsets(offsets))
        got = host_value(fam.segment_reduce_fn("SEGSUM", 16)(
            stage_flat(x, device), stage_flat(ids.to(torch.int64), device)))
        # byte-valued payloads stay far below the int32 wrap at these n,
        # so the float64 host digest compares exactly
        return bool(np.array_equal(got.astype(np.float64),
                                   fam.host_segment_reduce(
                                       x.numpy(), offsets, "SEGSUM")))
    x = host_data(n, "float32", rank=0, seed=0)
    got = int(fam.arg_reduce_fn("ARGMIN", "float32")(stage_flat(x, device)))
    return got == int(fam.host_arg_reduce(x.numpy(), "ARGMIN"))


def _case_row(name: str, surface: str, run) -> dict:
    """Run one case, `run(surface)`; its manifest row (a raise is a FAILED
    row)."""
    t0 = time.perf_counter()
    try:
        status = run(surface)
        row = {"name": name, "surface": surface, "status": status,
               "ok": status in ("PASSED", "WAIVED"), "error": None}
    except Exception as e:   # the manifest is the product
        row = {"name": name, "surface": surface, "status": "FAILED",
               "ok": False, "error": f"{type(e).__name__}: {e}"[:500]}
    row["seconds"] = round(time.perf_counter() - t0, 2)
    return row


def run_smoke(n: int = 1 << 20, logger: Optional[BenchLogger] = None,
              on_result=None, resume=None,
              platform: str = "gpu") -> List[dict]:
    """Each case once at n; the manifest rows, each passed to on_result
    as it lands. `resume(name)` gives an interrupted run's row, which is
    reused.
    The counterpart of tpu_reductions/bench/smoke.py:119."""
    # imported here, so that tests can replace driver.run_benchmark
    from tpu_reductions_torch.bench import driver
    from tpu_reductions_torch.exec import core as exec_core
    from tpu_reductions_torch.exec.plan import device_task

    logger = logger or BenchLogger(None, None)
    device = device_mod.resolve(platform)

    def classic(name, dtype, method, kernel, threads, depth):
        kw = dict(method=method, dtype=dtype, n=n, threads=threads,
                  stream_buffers=depth, iterations=8, warmup=1,
                  timing="chained", chain_reps=2, stat="median",
                  verify=True, log_file=None, platform=platform)
        if kernel is None:
            kw["f64"] = "dd"
        else:
            kw["backend"] = "cuda"
            kw["kernel"] = kernel
        return lambda surface: exec_core.run(device_task(
            surface,
            lambda: driver.run_benchmark(ReduceConfig(**kw),
                                         logger=logger),
            retry_log=logger.log, method=method,
            dtype=dtype)).status.name

    def family(name):
        return lambda surface: ("PASSED" if exec_core.run(device_task(
            surface, lambda: _family_case(surface, n, device),
            retry_log=logger.log, case=name)) else "FAILED")

    cases = [(c[0], c[6], classic(*c[:6])) for c in CASES]
    cases += [(name, surface, family(name))
              for name, surface in FAMILY_CASES]
    rows: List[dict] = []
    for name, surface, run in cases:
        row = resume(name) if resume is not None else None
        if row is not None:
            logger.log(f"smoke {name}: resumed from the prior manifest")
        else:
            row = _case_row(name, surface, run)
        rows.append(row)
        if on_result is not None:
            on_result(row)
    return rows


def main(argv=None) -> int:
    """CLI: every case at n, into a pass/fail manifest.
    The counterpart of tpu_reductions/bench/smoke.py:203."""
    from tpu_reductions_torch.bench.resume import Checkpoint

    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.smoke",
        description="Small verified run of every kernel surface the races "
                    "and the family meet; writes a pass/fail manifest")
    p.add_argument("--n", type=int, default=1 << 20,
                   help="Elements per case")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS)
    p.add_argument("--out", type=str, default=None,
                   help="Manifest JSON path (persisted per case)")
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.smoke", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    if ns.n <= 0:
        p.error("--n must be positive")
    # k10's deepest case needs threads*128*depth elements in flight
    if ns.n < 512 * 128 * 8:
        p.error(f"--n must be >= {512 * 128 * 8} so the deepest k10 "
                "pipeline has a full working set")
    logger = BenchLogger(None, None, console=sys.stderr)
    ck = Checkpoint(ns.out, {"n": ns.n}, rows_key="cases",
                    key_fn=lambda r: r.get("name"))

    def persist(row):
        ck.add(row)
        print(f"  smoke {row['name']:<22} {row['status']:<7} "
              f"{row['seconds']:6.1f}s"
              + (f"  {row['error']}" if row["error"] else ""))

    rows = run_smoke(n=ns.n, logger=logger, on_result=persist,
                     resume=ck.resume, platform=ns.platform)
    ok = sum(r["ok"] for r in rows)
    print(f"smoke: {ok}/{len(rows)} cases built and verified")
    if ns.out:
        ck.finalize()
        print(f"wrote {ns.out}")
    return 0 if rows and ok > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
