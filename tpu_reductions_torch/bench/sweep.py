"""The size sweeps (`--shmoo`), the experiment sweep (`sweep_all`) and
the collective sweeps.

The counterpart of tpu_reductions/bench/sweep.py:1, with the same sizes,
iteration counts, per-cell chained spans, cache files and resume rules.
`run_shmoo` gives one verified row per n = 2^min..2^max; `sweep_all` runs
{dtypes} x {methods} x `repeats` cells at one n and caches each verified
cell as `raw_output/run-{dtype}-{method}-{rep}.json` (the reference's
per-job stdout files, which its getAvgs.sh averaged; bench/aggregate.py
and bench/regen.py read them). `sweep_collective` climbs a rank ladder
of the collective benchmark (bench/collective_driver.py) into per-job
`raw_output/stdout-{mode}-{k}ranks.txt` files, resumable through
`collective_sweep.json`; `shmoo_collective` sweeps its payload size at
one rank count; `main` is the CLI over sweep_collective:

    python -m tpu_reductions_torch.bench.sweep --out-dir=DIR
        [--ranks=2,4,8] [--methods=MAX,MIN,SUM] [--types=int32,float64]
        [--n=1048576] [--retries=1] [--timing=periter|chained]
        [--chainspan=16] [--platform=gpu|cpu] [--cards=C]

The collective sweeps run across the host's cards as the JAX sweeps run
across its devices: `cards` (--cards) defaults to every card of the
host, one process a card with NCCL between them (bench/multicard.
run_ladder, spawned once for the whole ladder); each rung's k ranks lie
on min(k, C) of them in contiguous blocks, and rank 0 alone writes the
job files and the checkpoint. --cards=1 keeps every rung's ranks as
rows of one tensor on one card. On the CPU the default is one process;
--cards=C there runs C gloo processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import List, Optional

from tpu_reductions_torch.bench.driver import (BenchResult,
                                               _resolve_backend,
                                               crash_result,
                                               resolved_timing, run_benchmark,
                                               run_benchmark_batch)
from tpu_reductions_torch.bench.resume import load_cell, store_cell
from tpu_reductions_torch.config import KERNEL_SINGLE_PASS, ReduceConfig
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.ops.chain import auto_chain_span
from tpu_reductions_torch.utils.logging import BenchLogger

# The flagship single-chip grid (the JAX package's FLAGSHIP_GRID): the
# reference's n = 2^24 headline configuration (reduction.cpp:665), kernel
# 6, chained timing; float64 first, so its rows land first when a run is
# cut short. threads = 512 is the JAX package's crowned TPU tile, kept so
# that both packages' grids are the same cells; it is no H100 tuning. One
# definition, shared by bench/experiment.py, seed_cache.py and regen.py.
FLAGSHIP_GRID = dict(
    dtypes=("float64", "int32"), methods=("SUM", "MIN", "MAX"),
    n=1 << 24, repeats=3, iterations=256, backend="cuda",
    kernel=6, threads=512, timing="chained", chain_reps=5)


def cell_matches(row: dict, *, method: str, dtype: str, n: int,
                 backend: str, kernel: int, threads: int,
                 iterations: int, timing: str, chain_reps: int) -> bool:
    """Whether a cached cell is a verified measurement of exactly this
    sweep configuration: sweep_all's resume test, shared with seed_cache
    and regen. A cached row holds what ran (the resolved backend, never
    "auto"; the resolved discipline), so the probe is resolved the same
    way. Touches no device.
    The counterpart of tpu_reductions/bench/sweep.py:46."""
    probe = ReduceConfig(method=method, dtype=dtype, backend=backend,
                         timing=timing, chain_reps=chain_reps,
                         threads=threads, kernel=kernel)
    want_timing = resolved_timing(probe)
    return (row.get("status") == "PASSED"
            and row.get("method", method) == method
            and row.get("dtype", dtype) == dtype
            and row.get("n") == n
            and row.get("backend") == _resolve_backend(probe)
            and row.get("kernel") == probe.kernel
            and row.get("threads", 256) == threads
            and row.get("iterations") == iterations
            and row.get("timing", "periter") == want_timing
            and (want_timing != "chained"
                 or row.get("chain_reps") == chain_reps))


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
    The counterpart of tpu_reductions/bench/sweep.py:76.
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


def _run_cells(cfgs, logger, on_result,
               log_row=None) -> List[BenchResult]:
    """One cell at a time, a cell that raises becoming a FAILED row; so
    on_result fires, and can persist the row, after every cell. Each cell
    is one retried task of the execution core (exec/core.py); on a card,
    which is untunneled, an error re-raises at once into the row."""
    from tpu_reductions_torch.exec import core as exec_core
    from tpu_reductions_torch.exec.plan import device_task
    results = []
    for sub in cfgs:
        try:
            res = exec_core.run(device_task(
                "sweep-cell",
                lambda: run_benchmark(sub, logger=logger),
                retry_log=logger.log, method=sub.method,
                dtype=sub.dtype, n=sub.n))
        except Exception as e:  # contained to this cell's row
            res = crash_result(sub, e, logger)
        if log_row is not None:
            log_row(sub, res)
        if on_result is not None:
            on_result(sub, res)
        results.append(res)
    return results


def sweep_all(*, methods=("SUM", "MIN", "MAX"),
              dtypes=("int32", "float64"), n: int = 1 << 24,
              repeats: int = 5, iterations: int = 20,
              backend: str = "auto", threads: int = 256,
              kernel: int = KERNEL_SINGLE_PASS, timing: str = "periter",
              chain_reps: int = 5, platform: str = "gpu",
              out_dir: Optional[str] = None, resume: bool = True,
              logger: Optional[BenchLogger] = None) -> List[dict]:
    """The experiment grid: {dtypes} x {methods}, `repeats` runs each
    (the reference's RETRY_COUNT, mpi/constants.h:5), seed = the repeat,
    on `platform` (the card unless "cpu"). Each verified cell is cached in
    out_dir/raw_output as run-{dtype}-{method}-{rep}.json.

    With resume, a cached cell that cell_matches this configuration is
    reused; a truncated, failed or other-configuration one runs again, and
    a failure is never cached. An all-chained grid runs and caches one
    cell at a time, so a run cut short keeps every finished cell; other
    disciplines time the whole queue first (driver.run_benchmark_batch)
    and cache at the end. Returns the rows in grid order."""
    logger = logger or BenchLogger(None, None)
    raw_dir = Path(out_dir) / "raw_output" if out_dir else None
    if raw_dir:
        raw_dir.mkdir(parents=True, exist_ok=True)
    rows: List[Optional[dict]] = []
    queued = []  # (row index, rep, cache file, cfg)
    for dtype in dtypes:
        for method in methods:
            for rep in range(repeats):
                fname = (raw_dir / f"run-{dtype}-{method}-{rep}.json"
                         if raw_dir else None)
                if resume and fname and fname.exists():
                    row = load_cell(fname)
                    if cell_matches(row, method=method, dtype=dtype, n=n,
                                    backend=backend, kernel=kernel,
                                    threads=threads, iterations=iterations,
                                    timing=timing, chain_reps=chain_reps):
                        rows.append(row)
                        logger.log(f"sweep {dtype} {method} rep={rep} "
                                   f"-> resumed ({row['gbps']:.4f} GB/s "
                                   f"[{row['status']}])")
                        ledger.emit("sweep.cell", dtype=dtype,
                                    method=method, rep=rep,
                                    mode="resumed")
                        continue
                cfg = ReduceConfig(method=method, dtype=dtype, n=n,
                                   iterations=iterations, backend=backend,
                                   timing=timing, chain_reps=chain_reps,
                                   threads=threads, kernel=kernel,
                                   stat="median" if timing == "chained"
                                   else "mean",
                                   seed=rep, platform=platform,
                                   log_file=None)
                queued.append((len(rows), rep, fname, cfg))
                rows.append(None)   # filled as its cell finishes
    cells = iter(queued)

    def on_result(cfg, res):
        idx, rep, fname, _ = next(cells)
        row = res.to_dict()
        row["repeat"] = rep
        row["threads"] = cfg.threads     # resume key; not in BenchResult
        # the discipline that ran (chained may fall back to fetch), so a
        # cached row can never pass for another discipline's
        if row.get("timing") == "chained":
            row["chain_reps"] = cfg.chain_reps
        rows[idx] = row
        logger.log(f"sweep {cfg.dtype} {cfg.method} rep={rep} "
                   f"-> {res.gbps:.4f} GB/s [{res.status.name}]")
        ledger.emit("sweep.cell", dtype=cfg.dtype, method=cfg.method,
                    rep=rep, mode="fresh", status=res.status.name)
        if fname and res.passed:
            store_cell(fname, row)

    queued_cfgs = [cfg for _, _, _, cfg in queued]
    if queued_cfgs and all(resolved_timing(c) == "chained"
                           for c in queued_cfgs):
        _run_cells(queued_cfgs, logger, on_result)
    else:
        run_benchmark_batch(queued_cfgs, logger=logger, on_result=on_result)
    return rows


def sweep_collective(*, rank_counts=(2, 4, 8), methods=("MAX", "MIN", "SUM"),
                     dtypes=("int32", "float64"), n: int = 1 << 22,
                     retries: int = 5, rooted="none",
                     mode: str = "vn", mapping: str = "default",
                     timing: str = "periter", chain_span: int = 16,
                     platform: str = "gpu", out_dir: Optional[str] = None,
                     logger: Optional[BenchLogger] = None,
                     cards: Optional[int] = None,
                     witness=None) -> List[dict]:
    """Rank-count sweep of the collective benchmark, the submit_all.sh
    analog (sbatch --nodes {32,128,512}, mpi/submit_all.sh:3-4), in the
    reference's op order (MAX, MIN, SUM, reduce.c:73), `retries` repeats
    a cell, on `platform` (the card unless "cpu"). Writes the per-job
    row files `out_dir/raw_output/stdout-{mode}-{k}ranks.txt` (the
    stdout-vn-<jobid> analog) for aggregate.pipeline().

    With an out_dir every row persists to out_dir/collective_sweep.json
    as it lands (bench/resume.Checkpoint), and a run over an interrupted
    sweep reuses its rows per (ranks, dtype, method, repeat) instead of
    climbing the ladder again; a completed sweep measures afresh.

    Across `cards` (module docstring; default every card of the host)
    the ladder runs in that many processes (bench/multicard.run_ladder,
    its control files under out_dir/ladder) and returns rank 0's rows,
    each with its `cards` and busbw a card (on the card, `nvlink_share`
    against NVLink's 450 GB/s); only rank 0 writes the job files and the
    checkpoint, whose prior rows every process resumes alike. `witness`
    (bench/multicard.Witness) records every measured row's output."""
    from tpu_reductions_torch.bench import multicard
    from tpu_reductions_torch.bench.collective_driver import \
        run_collective_benchmark
    from tpu_reductions_torch.config import CollectiveConfig

    logger = logger or BenchLogger(None, None)
    cards = multicard.host_cards(platform, cards)
    if multicard.spawns(cards):
        return multicard.run_ladder(
            "tpu_reductions_torch.bench.sweep:sweep_collective",
            dict(rank_counts=list(rank_counts), methods=list(methods),
                 dtypes=list(dtypes), n=n, retries=retries, rooted=rooted,
                 mode=mode, mapping=mapping, timing=timing,
                 chain_span=chain_span, platform=platform,
                 out_dir=out_dir, cards=cards), cards,
            platform=platform,
            work_dir=Path(out_dir) / "ladder" if out_dir else None,
            logger=logger,
            evidence=witness.root if witness is not None else None)
    writer = multicard.reporting()
    raw_dir = Path(out_dir) / "raw_output" if out_dir and writer else None
    if raw_dir:
        raw_dir.mkdir(parents=True, exist_ok=True)
    ck = None
    if out_dir:
        # rank, dtype and method live in the row key, not the meta: a
        # sweep run again with another rank list reuses the rungs it
        # shares with the interrupted one
        ck = multicard.shared_checkpoint(
            Path(out_dir) / "collective_sweep.json",
            {"n": n, "retries": retries, "rooted": rooted, "mode": mode,
             "mapping": mapping, "timing": timing,
             "chain_span": chain_span},
            key_fn=lambda r: (r.get("ranks"), r.get("dtype"),
                              r.get("method"), r.get("repeat")))
    rows = []
    for k in rank_counts:
        ledger.emit("sweep.rank", ranks=k)   # how far up the ladder
        # the job file, truncated on open: the driver writes its header
        # and rows, reused rows included, so it always reads complete
        job_logger = BenchLogger(
            str(raw_dir / f"stdout-{mode}-{k}ranks.txt") if raw_dir
            else None, None, console=logger.console)
        for dtype in dtypes:
            for method in methods:
                cfg = CollectiveConfig(method=method, dtype=dtype, n=n,
                                       retries=retries, num_devices=k,
                                       rooted=rooted, mode=mode,
                                       mapping=mapping, timing=timing,
                                       chain_span=chain_span,
                                       platform=platform)
                results = run_collective_benchmark(
                    cfg, logger=job_logger, checkpoint=ck,
                    row_key=lambda rep, _k=k, _d=cfg.dtype,
                    _m=cfg.method: (_k, _d, _m, rep),
                    on_result=witness.keep if witness is not None
                    else None)
                if witness is not None:
                    witness.collective("sweep", (k, dtype, method),
                                       results)
                rows.extend(res.to_dict() for res in results)
        multicard.rung_done()
    if ck is not None:
        ck.finalize()
    return rows


def shmoo_collective(*, method: str = "SUM", dtype: str = "float64",
                     num_devices: Optional[int] = None,
                     min_pow: int = 10, max_pow: int = 24,
                     retries: int = 3, timing: str = "periter",
                     chain_span: int = 16, platform: str = "gpu",
                     logger: Optional[BenchLogger] = None,
                     cards: Optional[int] = None) -> List[dict]:
    """Payload-size sweep of the collective at one rank count, n =
    2^min_pow..2^max_pow: the bandwidth-vs-N axis the reference's MPI
    side never had (its payload was constants.h's fixed 2 GiB). Each row
    carries `gbps` (its reference GB/s) for plot_vs_n. Across `cards`
    as sweep_collective (rank 0's rows).
    The counterpart of tpu_reductions/bench/sweep.py:252."""
    from tpu_reductions_torch.bench import multicard
    from tpu_reductions_torch.bench.collective_driver import \
        run_collective_benchmark
    from tpu_reductions_torch.config import CollectiveConfig

    logger = logger or BenchLogger(None, None)
    cards = multicard.host_cards(platform, cards)
    if multicard.spawns(cards):
        return multicard.run_ladder(
            "tpu_reductions_torch.bench.sweep:shmoo_collective",
            dict(method=method, dtype=dtype, num_devices=num_devices,
                 min_pow=min_pow, max_pow=max_pow, retries=retries,
                 timing=timing, chain_span=chain_span, platform=platform,
                 cards=cards), cards, platform=platform, logger=logger)
    rows = []
    for p in range(min_pow, max_pow + 1):
        cfg = CollectiveConfig(method=method, dtype=dtype, n=1 << p,
                               retries=retries, num_devices=num_devices,
                               timing=timing, chain_span=chain_span,
                               platform=platform)
        for res in run_collective_benchmark(cfg, logger=logger):
            row = res.to_dict()
            row["gbps"] = row["reference_gbps"]
            rows.append(row)
    return rows


def main(argv=None) -> int:
    """CLI over sweep_collective: the submit_all.sh rank fan-out as one
    resumable process. Exit 0 when every row PASSED or WAIVED, 1
    otherwise or with no rows, 2 on a usage error.
    The counterpart of tpu_reductions/bench/sweep.py:389."""
    from tpu_reductions_torch.config import (DTYPE_ALIASES, METHODS,
                                             PLATFORMS)
    p = argparse.ArgumentParser(
        prog="tpu_reductions_torch.bench.sweep",
        description="Resumable rank-count sweep of the collective "
                    "benchmark (collective_sweep.json checkpoint)",
    )
    p.add_argument("--out-dir", dest="out_dir", type=str, required=True)
    p.add_argument("--ranks", type=str, default="2,4,8",
                   help="Comma-separated virtual rank counts")
    p.add_argument("--methods", type=str, default="MAX,MIN,SUM",
                   help="Reference op order (reduce.c:73)")
    p.add_argument("--types", dest="dtypes", type=str,
                   default="int32,float64")
    p.add_argument("--n", type=int, default=1 << 20)
    p.add_argument("--retries", type=int, default=1)
    p.add_argument("--timing", type=str, default="periter",
                   choices=("periter", "chained"))
    p.add_argument("--chainspan", dest="chain_span", type=int, default=16)
    p.add_argument("--platform", type=str, default="gpu", choices=PLATFORMS,
                   help="gpu (default): the ranks are rows on the card; "
                        "cpu: on the host")
    p.add_argument("--cards", type=int, default=None,
                   help="processes, one a card, that each rung's ranks "
                        "lie on (min(k, C) of them; NCCL between the "
                        "cards, gloo with --platform=cpu); default every "
                        "card of the host, one process on the CPU")
    ns = p.parse_args(argv)
    if ns.cards is not None and ns.cards < 1:
        p.error(f"--cards must be >= 1, got {ns.cards}")
    from tpu_reductions_torch.exec.core import maybe_arm
    from tpu_reductions_torch.obs.ledger import arm_session
    arm_session("bench.sweep", argv=list(argv) if argv else sys.argv[1:])
    maybe_arm(ns.platform)
    methods = tuple(m.strip().upper() for m in ns.methods.split(",")
                    if m.strip())
    if not methods or any(m not in METHODS for m in methods):
        p.error(f"--methods must name only {METHODS}, got {ns.methods!r}")
    dtypes = tuple(DTYPE_ALIASES[d.strip()] for d in ns.dtypes.split(",")
                   if d.strip() in DTYPE_ALIASES)
    if not dtypes or len(dtypes) != len(
            [d for d in ns.dtypes.split(",") if d.strip()]):
        p.error(f"--types must name only {sorted(DTYPE_ALIASES)}, "
                f"got {ns.dtypes!r}")
    try:
        rank_counts = tuple(int(r) for r in ns.ranks.split(",") if r.strip())
    except ValueError:
        p.error(f"--ranks must be comma-separated ints, got {ns.ranks!r}")
    if not rank_counts or any(k < 2 for k in rank_counts):
        p.error(f"--ranks must all be >= 2, got {ns.ranks!r}")
    from tpu_reductions_torch.bench.multicard import (LadderFailed,
                                                      host_cards)
    try:
        host_cards(ns.platform, ns.cards)
    except (RuntimeError, ValueError) as e:
        # cards this host cannot give: refused with the reason, no rung
        print(f"error: {e}", file=sys.stderr)
        return 1
    logger = BenchLogger(None, None, console=sys.stderr)
    try:
        rows = sweep_collective(rank_counts=rank_counts, methods=methods,
                                dtypes=dtypes, n=ns.n, retries=ns.retries,
                                timing=ns.timing, chain_span=ns.chain_span,
                                platform=ns.platform, out_dir=ns.out_dir,
                                logger=logger, cards=ns.cards)
    except LadderFailed as e:
        # a worker that died fails the ladder with its exit code
        print(f"error: {e}", file=sys.stderr)
        return e.code
    bad = [r for r in rows if r.get("status") not in ("PASSED", "WAIVED")]
    print(f"swept {len(rows)} rows across ranks={list(rank_counts)} "
          f"-> {ns.out_dir}/collective_sweep.json"
          + (f" ({len(bad)} FAILED)" if bad else ""))
    return 1 if bad or not rows else 0


if __name__ == "__main__":
    sys.exit(main())
