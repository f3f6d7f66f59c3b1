"""Step 0 of a session on the card: the first verified row, on disk fast.

The counterpart of tpu_reductions/bench/firstrow.py:1: the shortest path
from a fresh process to verified evidence on disk, in value order:

  1. the headline row: int32 SUM at n = 2^24 through the crowned
     candidate only (bench/headline.CANDIDATES[0]) with few slope reps,
     persisted to `--out` the moment it verifies, and, on the card at the
     headline n, snapshotted next to it (`<out>.snapshot.json`);
  2. the double scoreboard: f64 SUM/MIN/MAX through the pair kernel at
     the flagship grid's contract (headline.double_spots), into
     `<out>.doubles.json`, each row as it lands.

Nothing is written but `--out` and those two files beside it. Every stage
prints a `firstrow: T+x.xs <stage>` line to stderr, relative to
FIRSTROW_T0 (a session's start, from the environment) or else to the
module's import, and the timeline is persisted in the artifact. A
re-invocation against an interrupted artifact (`complete: false`, same
contract) reuses its verified row and goes on to the doubles.

CLI:
    python -m tpu_reductions_torch.bench.firstrow [--platform=cpu]
        [--n=16777216] [--iterations=256] [--chainreps=3]
        [--doubles-n=N --doubles-reps=K | --skip-doubles]
        [--out=out/FIRSTROW.json]

Exit 0 when the headline row PASSED, else 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# T0 before the heavy imports, so that their cost is on the timeline
_T0 = float(os.environ.get("FIRSTROW_T0", 0) or 0) or time.time()


def _mark(marks: list, label: str) -> None:
    t = time.time()
    marks.append({"label": label, "t_rel_s": round(t - _T0, 2)})
    print(f"firstrow: T+{t - _T0:6.1f}s {label}", file=sys.stderr, flush=True)
    from tpu_reductions_torch.obs import ledger
    ledger.emit("firstrow.mark", label=label, t_rel_s=round(t - _T0, 2))


def main(argv=None) -> int:
    """CLI: step 0 (module docstring).
    The counterpart of tpu_reductions/bench/firstrow.py:60."""
    from tpu_reductions_torch.config import PLATFORMS

    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.firstrow",
        description="First verified row of a session, value-ordered and "
                    "persisted per stage")
    p.add_argument("--n", type=int, default=1 << 24)
    p.add_argument("--iterations", type=int, default=256,
                   help="chained span")
    p.add_argument("--chainreps", dest="chain_reps", type=int, default=3,
                   help="slope reps, fewer than a race's: the first row "
                        "buys time to evidence")
    p.add_argument("--doubles-n", type=int, default=None,
                   help="override the doubles' n (rehearsal only)")
    p.add_argument("--doubles-reps", type=int, default=None)
    p.add_argument("--doubles-iterations", type=int, default=None,
                   help="override the doubles' chained span (rehearsal "
                        "only); unset, the flagship grid's. The headline "
                        "row's --iterations is not forwarded")
    p.add_argument("--skip-doubles", action="store_true")
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS)
    p.add_argument("--out", type=str, default="out/FIRSTROW.json")
    ns = p.parse_args(argv)
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.firstrow", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    if ns.n <= 0:
        p.error("--n must be positive")

    marks: list = []
    _mark(marks, "process start (argparse done)")

    from tpu_reductions_torch import device as device_mod
    from tpu_reductions_torch.bench import headline
    from tpu_reductions_torch.bench.driver import crash_result, run_benchmark
    from tpu_reductions_torch.bench.resume import (default_reusable,
                                                   prior_artifact,
                                                   result_from_row)
    from tpu_reductions_torch.config import ReduceConfig
    from tpu_reductions_torch.utils.jsonio import atomic_json_dump
    from tpu_reductions_torch.utils.logging import BenchLogger

    dev = device_mod.resolve(ns.platform)
    _mark(marks, f"torch ready ({device_mod.name(dev)}, "
                 f"{device_mod.count(ns.platform)} device(s))")

    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    backend, kernel, threads = headline.CANDIDATES[0]
    candidate = f"{backend} k{kernel} threads={threads}"
    cfg = ReduceConfig(method="SUM", dtype="int32", n=ns.n, backend=backend,
                       kernel=kernel, threads=threads,
                       iterations=ns.iterations, warmup=2, timing="chained",
                       chain_reps=ns.chain_reps, stat="median",
                       platform=ns.platform, log_file=None)
    logger = BenchLogger(None, None, console=sys.stderr)
    contract = {"candidate": candidate, "n": ns.n, "timing": "chained",
                "stat": "median", "chain_reps": ns.chain_reps}

    def persist(row_dict, complete):
        atomic_json_dump(ns.out, {
            "purpose": "first verified row of a session (step 0)",
            **contract, "t0": _T0, "timeline": marks, "row": row_dict,
            "complete": complete})

    prior_row = (prior_artifact(ns.out, contract) or {}).get("row")
    if isinstance(prior_row, dict) and default_reusable(prior_row):
        row = prior_row
        res = result_from_row(cfg, row)
        _mark(marks, f"int row resumed from interrupted {ns.out}: "
                     f"{row['gbps']} GB/s [{row['status']}]")
    else:
        from tpu_reductions_torch.exec import core as exec_core
        from tpu_reductions_torch.exec.plan import device_task
        try:
            res = exec_core.run(device_task(
                "firstrow",
                lambda: run_benchmark(cfg, logger=logger),
                retry_log=logger.log, method=cfg.method,
                dtype=cfg.dtype, n=cfg.n))
        except Exception as e:   # contained: a crash still leaves a row
            res = crash_result(cfg, e, logger)
        row = res.to_dict()
        row["threads"] = threads
        _mark(marks, f"int row done: {row['gbps']} GB/s [{row['status']}]")
    persist(row, complete=False)
    _mark(marks, f"int row persisted -> {ns.out}")
    persist(row, complete=False)   # again, with its own persistence mark

    if res.passed and headline.on_flagship_geometry(ns.n, ns.platform):
        label = f"2^{ns.n.bit_length() - 1}"
        headline.write_snapshot(ns.out + ".snapshot.json", {
            "metric": f"single-chip int32 SUM reduction bandwidth, "
                      f"n={label}",
            "value": round(res.gbps, 4), "unit": "GB/s",
            "vs_baseline": round(res.gbps / headline.BASELINE_GBPS, 4),
            "partial": True},   # one candidate, reduced reps
            {candidate: {"gbps": round(res.gbps, 1), "status": row["status"],
                         "note": f"firstrow: chain_reps={ns.chain_reps}"}},
            device_mod.name(dev))
        _mark(marks, f"snapshot written ({ns.out}.snapshot.json)")
        persist(row, complete=False)

    if not ns.skip_doubles:
        dpath = ns.out + ".doubles.json"
        try:
            headline.double_spots(dpath, n=ns.doubles_n,
                                  iterations=ns.doubles_iterations,
                                  reps=ns.doubles_reps, platform=ns.platform)
        except Exception as e:   # best-effort, as in the JAX package
            print(f"# doubles spot failed (non-fatal): "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
        _mark(marks, f"f64 scoreboard attempted ({dpath})")

    # the last mark before the last persist, so the artifact holds the
    # whole step's wall time
    _mark(marks, "firstrow complete")
    persist(row, complete=True)
    return 0 if res.passed else 1


if __name__ == "__main__":
    sys.exit(main())
