"""The self-verifying single-GPU reduction benchmark driver.

The counterpart of tpu_reductions/bench/driver.py:

  host payload -> stage to the device (padded (rows, 128), untimed)
  -> warm-up -> timed, synced iterations (or chained slope timing)
  -> GB/s from the per-iteration time -> verify against the host oracle
  -> PASSED / FAILED / WAIVED, which is also the exit code.

float64 runs natively on the card through the chosen kernel by default.
`--f64=dd` takes the JAX package's route for f64 on a chip without native
f64 (its driver.py:127-153, 201-216): two 32-bit planes through the pair
kernel (ops/dd_reduce.py), finished on the device to a scalar pair. That
route has the JAX driver's gates too (its :444-446, 459-475, 485-493):
kernel 9 WAIVEs float64, kernels 7, 8 and 10 WAIVE (the pair kernel has
kernel 6's structure, so their label would misname the measurement), and
so does --backend=torch.

The payload is the native filler's where the native oracle is in use, as
in the JAX driver (its :497-500), else utils/rng's (ops/oracle.payload).
`--check` holds the kernel, its plain version and the torch comparator to
the host oracle before staging, and a disagreement FAILS the row
(utils/debug.py); `--trace` captures the timed call with torch.profiler
after staging. `--stream` runs the streaming pipeline instead
(bench/stream.py), and `--shmoo` the size sweep (bench/sweep.py).

`main` arms the flight recorder (obs/ledger.arm_session) and the
watchdog (exec/core.maybe_arm: on the card its heartbeat half ends a
stalled run with exit 4). Each run passes the `bench.run` fault point
first; the untimed staging runs under a `compile` guard and ends with a
`staging.stage` event.
"""

from __future__ import annotations

import dataclasses
import io
import math
import sys
from typing import Optional

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import (KERNEL_MXU, KERNEL_SINGLE_PASS,
                                         LIVE_KERNELS, ReduceConfig,
                                         parse_single_chip)
from tpu_reductions_torch.faults.inject import fault_point
from tpu_reductions_torch.ops import dd_reduce, oracle
from tpu_reductions_torch.ops.chain import make_chained_reduce
from tpu_reductions_torch.ops.kernel_reduce import (choose_tiling,
                                                    make_staged_core,
                                                    make_staged_reduce,
                                                    stage_padded)
from tpu_reductions_torch.ops.oracle import host_reduce, host_value, verify
from tpu_reductions_torch.ops.registry import get_op, tolerance
from tpu_reductions_torch.ops.torch_reduce import make_torch_reduce
from tpu_reductions_torch.utils.debug import (consistency_check,
                                              trace_benchmark)
from tpu_reductions_torch.obs import ledger
from tpu_reductions_torch.utils import heartbeat
from tpu_reductions_torch.utils.logging import BenchLogger, throughput_line
from tpu_reductions_torch.utils.qa import QAStatus, qa_finish, qa_start
from tpu_reductions_torch.utils.timing import time_chained, time_fn

NAME = "tpu_reductions_torch"
# k9 runs these dtypes (SUM only). f64 is among them on the native route:
# the card has native f64, which is the JAX driver's off-TPU branch (its
# driver.py:444-446); the dd route loses it, as on the TPU.
MXU_DTYPES = ("float32", "bfloat16", "float64")


@dataclasses.dataclass
class BenchResult:
    """One benchmark outcome: the data behind the throughput row plus the
    QA status. The same fields as the JAX package's BenchResult.
    The counterpart of tpu_reductions/bench/driver.py:42."""

    method: str
    dtype: str
    n: int
    backend: str
    kernel: int
    gbps: float
    avg_s: float
    iterations: int
    status: QAStatus
    device_result: float
    oracle_result: float
    abs_diff: float
    waived_reason: Optional[str] = None
    timing: Optional[str] = None       # the discipline actually used
    slope_samples_s: Optional[list] = None   # chained mode's slopes

    @property
    def passed(self) -> bool:
        """Status == PASSED; the counterpart of
        tpu_reductions/bench/driver.py:75."""
        return self.status == QAStatus.PASSED

    def to_dict(self) -> dict:
        """JSON-ready row; status as its marker name, non-finite floats
        as null.
        The counterpart of tpu_reductions/bench/driver.py:79."""
        d = dataclasses.asdict(self)
        d["status"] = self.status.name
        for k, v in d.items():
            if isinstance(v, float) and not math.isfinite(v):
                d[k] = None
            elif isinstance(v, list):
                d[k] = [x if isinstance(x, (int, float))
                        and math.isfinite(x) else None for x in v]
        return d


def _unrun(cfg: ReduceConfig, status: QAStatus, reason: str,
           backend: Optional[str] = None, **fields) -> BenchResult:
    """A row for a configuration that produced no measurement."""
    nan = float("nan")
    row = dict(gbps=0.0, avg_s=0.0, iterations=0, device_result=nan,
               oracle_result=nan, abs_diff=nan, timing=cfg.timing)
    row.update(fields)
    return BenchResult(cfg.method, cfg.dtype, cfg.n, backend or cfg.backend,
                       cfg.kernel, status=status, waived_reason=reason, **row)


def _dd_route(cfg: ReduceConfig) -> bool:
    """Whether float64 takes the pair route (--f64=dd)."""
    return cfg.dtype == "float64" and cfg.f64 == "dd"


def _resolve_backend(cfg: ReduceConfig) -> str:
    # auto: the hand-written kernels; torch remains the comparator
    return "cuda" if cfg.backend == "auto" else cfg.backend


def _make_device_fn(cfg: ReduceConfig, backend: str, device: torch.device):
    """(stage_fn, reduce_fn) for the chosen backend."""
    if backend == "torch":
        op = get_op(cfg.method)
        tm, p, t = choose_tiling(cfg.n, dtype=cfg.dtype)

        def stage_fn(x):
            return stage_padded(x, tm, p, t, op, device)

        return stage_fn, make_torch_reduce(cfg.method)
    if _dd_route(cfg):
        # stage_fn gives (hi2d, lo2d, s); only the 8-byte scalar pair comes
        # to the host, unless --cpufinal finishes the accumulator there
        dd_args = dict(threads=cfg.threads, max_blocks=cfg.max_blocks,
                       device=device)
        if cfg.cpu_final:
            stage_fn, reduce_fn = dd_reduce.make_dd_staged_reduce(
                cfg.method, cfg.n, **dd_args)
            return stage_fn, lambda staged: reduce_fn(*staged)
        stage_fn, core, finish = dd_reduce.make_dd_device_reduce(
            cfg.method, cfg.n, **dd_args)
        return stage_fn, lambda staged: finish(*core(*staged[:2]),
                                               scale_exp=staged[2])
    return make_staged_reduce(
        cfg.method, cfg.n, cfg.dtype, threads=cfg.threads,
        max_blocks=cfg.max_blocks, kernel=cfg.kernel,
        cpu_final=cfg.cpu_final, cpu_thresh=cfg.cpu_thresh,
        stream_buffers=cfg.stream_buffers, device=device)


def _chain_supported(cfg: ReduceConfig) -> bool:
    """--cpufinal does host work inside the timed region by definition,
    so it cannot be chained on the device."""
    return not cfg.cpu_final


def resolved_timing(cfg: ReduceConfig) -> str:
    """The discipline a run of cfg actually uses: chained falls back to
    fetch when the reduce is not chainable.
    The counterpart of tpu_reductions/bench/driver.py:173."""
    if cfg.timing == "chained" and not _chain_supported(cfg):
        return "fetch"
    return cfg.timing


def _make_chained_fn(cfg: ReduceConfig, backend: str, device: torch.device):
    """`chained(x2d, k)` for slope timing, or None when cfg cannot chain."""
    if not _chain_supported(cfg):
        return None
    if backend == "torch":
        op = get_op(cfg.method)
        return make_chained_reduce(op.reduce, op)
    if _dd_route(cfg):
        # the pair chain over (hi2d, lo2d) (_chain_input); the scale is
        # host metadata
        _stage, core, _finish = dd_reduce.make_dd_device_reduce(
            cfg.method, cfg.n, threads=cfg.threads,
            max_blocks=cfg.max_blocks, device=device)
        return make_chained_reduce(core, get_op(cfg.method))
    op, _stage, core = make_staged_core(
        cfg.method, cfg.n, cfg.dtype, threads=cfg.threads,
        max_blocks=cfg.max_blocks, kernel=cfg.kernel,
        cpu_thresh=cfg.cpu_thresh, stream_buffers=cfg.stream_buffers,
        device=device)
    return make_chained_reduce(core, op)


def _chain_input(cfg: ReduceConfig, x_dev):
    """What the chain folds: the staged tensor, or the pair route's two
    planes."""
    return x_dev[:2] if _dd_route(cfg) else x_dev


def _make_logger(cfg: ReduceConfig) -> BenchLogger:
    """--qatest: markers and log files only, no console narrative."""
    return BenchLogger(cfg.log_file, cfg.master_log,
                       console=io.StringIO() if cfg.qatest else None)


def run_benchmark(cfg: ReduceConfig, logger: Optional[BenchLogger] = None,
                  defer: bool = False):
    """Run one self-verifying configuration on cfg.platform (the card
    unless it is "cpu"; with no card this raises). defer=True returns a
    _PendingResult whose device value is not fetched yet; its
    .finalize() gives the BenchResult.
    The counterpart of tpu_reductions/bench/driver.py:238."""
    fault_point("bench.run")
    if logger is None:
        logger = _make_logger(cfg)
    device_mod.resolve(cfg.platform)
    if cfg.device is not None:
        found = device_mod.count(cfg.platform)
        if not 0 <= cfg.device < found:
            return _unrun(cfg, QAStatus.WAIVED,
                          f"device {cfg.device} not present ({found} found)")
    device = device_mod.resolve(cfg.platform, cfg.device)
    return _run_benchmark_inner(cfg, logger, device, defer)


@dataclasses.dataclass
class _PendingResult:
    """A timed run whose device result has not been brought to the host
    yet; the host oracle's value is computed eagerly (it never touches the
    device)."""

    cfg: ReduceConfig
    backend: str
    gbps: float
    avg_s: float
    result: object         # 0-d device tensor, or a host scalar (--cpufinal)
    host_val_raw: object
    logger: BenchLogger
    timing: Optional[str] = None
    samples: Optional[list] = None

    def finalize(self) -> BenchResult:
        cfg = self.cfg
        status = QAStatus.PASSED
        dev_raw = (host_value(self.result)
                   if isinstance(self.result, torch.Tensor) else self.result)
        dev_val = float(np.asarray(dev_raw, dtype=np.float64))
        host_val = float("nan")
        diff = float("nan")
        if cfg.verify:
            passed, diff = verify(dev_raw, self.host_val_raw, cfg.method,
                                  cfg.dtype, cfg.n)
            host_val = float(np.asarray(self.host_val_raw, dtype=np.float64))
            status = QAStatus.PASSED if passed else QAStatus.FAILED
            tol = tolerance(cfg.method, cfg.dtype, cfg.n)
            self.logger.log(f"GPU result = {dev_val!r}")
            self.logger.log(f"CPU result = {host_val!r} (tolerance {tol:g})")
            self.logger.log(f"payload and oracle: {oracle.route(cfg.dtype)}")
        return BenchResult(cfg.method, cfg.dtype, cfg.n, self.backend,
                           cfg.kernel, self.gbps, self.avg_s,
                           cfg.iterations, status, dev_val, host_val, diff,
                           timing=self.timing or cfg.timing,
                           slope_samples_s=self.samples)


def run_benchmark_batch(cfgs, logger: Optional[BenchLogger] = None,
                        on_result=None) -> list:
    """Run several configurations in one process: every timed loop first,
    then every verification. A configuration that raises becomes a FAILED
    row and the rest still run. on_result(cfg, result), when given, is
    called right after each configuration is verified.
    The counterpart of tpu_reductions/bench/driver.py:343."""
    cfgs = list(cfgs)
    pendings = []
    for cfg in cfgs:
        try:
            pendings.append(run_benchmark(cfg, logger=logger, defer=True))
        except Exception as e:  # contained to this configuration's row
            pendings.append(crash_result(cfg, e, logger))
    results = []
    for cfg, p in zip(cfgs, pendings):
        try:
            res = p.finalize() if isinstance(p, _PendingResult) else p
        except Exception as e:  # contained to this configuration's row
            res = crash_result(cfg, e, logger)
        if on_result is not None:
            on_result(cfg, res)
        results.append(res)
    return results


def crash_result(cfg: ReduceConfig, exc: Exception,
                 logger: Optional[BenchLogger] = None) -> BenchResult:
    """A FAILED row for a configuration whose run raised; the error is
    logged and kept in the row's reason field.
    The counterpart of tpu_reductions/bench/driver.py:407."""
    if logger is not None:
        logger.log(f"config kernel={cfg.kernel} threads={cfg.threads} "
                   f"raised {type(exc).__name__}: {exc}")
    return _unrun(cfg, QAStatus.FAILED, f"{type(exc).__name__}: {exc}"[:200])


def _run_benchmark_inner(cfg: ReduceConfig, logger: BenchLogger,
                         device: torch.device, defer: bool = False):
    if cfg.kernel not in LIVE_KERNELS:
        # the reference emptied kernels 0-5: not an error, not provided
        return _unrun(cfg, QAStatus.WAIVED,
                      f"kernel {cfg.kernel} not live (live: {LIVE_KERNELS})")
    dd = _dd_route(cfg)
    mxu_dtypes = tuple(d for d in MXU_DTYPES if not (dd and d == "float64"))
    if (cfg.kernel == KERNEL_MXU and cfg.backend != "torch"
            and (cfg.method != "SUM" or cfg.dtype not in mxu_dtypes)):
        # MIN/MAX have no product form and integer products are not exact
        # on the float path: WAIVED, the incapable-hardware gate, not a
        # failure (the JAX driver's :447-457)
        return _unrun(cfg, QAStatus.WAIVED,
                      "kernel 9 (MXU) is SUM over float dtypes only")
    if dd and cfg.backend != "torch" and cfg.kernel != KERNEL_SINGLE_PASS:
        # the pair route ignores --kernel: any other label would misname
        # a pair-kernel measurement (the JAX driver's :459-475)
        return _unrun(cfg, QAStatus.WAIVED,
                      "f64 on the dd route runs the pair kernel (kernel-6 "
                      f"structure); a kernel-{cfg.kernel} label would be a "
                      "mislabeled dd measurement")

    backend = _resolve_backend(cfg)
    if dd and backend == "torch":
        # the JAX driver's :485-493: its comparator has no f64 there
        return _unrun(cfg, QAStatus.WAIVED,
                      "no native f64 on the dd route; use backend=cuda",
                      backend=backend)
    x_host = oracle.payload(cfg.n, cfg.dtype, rank=0, seed=cfg.seed)

    if cfg.check:
        # refuse to time a kernel that disagrees with its plain version,
        # the comparator or the oracle (the JAX driver's :502-518), at the
        # row's own finish and depth
        report = consistency_check(
            cfg.method, cfg.dtype, min(cfg.n, 1 << 20), threads=cfg.threads,
            max_blocks=cfg.max_blocks, kernel=cfg.kernel,
            cpu_final=cfg.cpu_final, cpu_thresh=cfg.cpu_thresh,
            stream_buffers=cfg.stream_buffers, seed=cfg.seed, f64=cfg.f64,
            platform=cfg.platform, device_index=cfg.device)
        logger.log(report.describe())
        if not report.ok:
            return _unrun(cfg, QAStatus.FAILED,
                          "consistency check: " + report.describe(),
                          backend=backend, device_result=report.kernel,
                          oracle_result=report.oracle,
                          abs_diff=abs(report.kernel - report.oracle))

    stage_fn, reduce_fn = _make_device_fn(cfg, backend, device)
    # host-to-device copy + pad, untimed; the compile phase's deadline
    # (a chunked stage ticks per chunk inside)
    # redlint: disable=RED025 -- inside the callers' device_task plans; re-labels the untimed staging edge compile-tolerant, narrower than the plan's phase
    with heartbeat.guard(heartbeat.PHASE_COMPILE):
        x_dev = stage_fn(x_host)
        device_mod.synchronize(device)
    ledger.emit("staging.stage",
                nbytes=int(x_host.numel() * x_host.element_size()),
                method=cfg.method, dtype=cfg.dtype, n=cfg.n)

    timing_mode = cfg.timing
    chained = (_make_chained_fn(cfg, backend, device)
               if timing_mode == "chained" else None)
    if timing_mode == "chained" and chained is None:
        logger.log("NOTE: timing=chained needs an all-device reduce "
                   "(--cpufinal finishes on host by definition); "
                   "falling back to timing=fetch")
        timing_mode = "fetch"

    if cfg.trace_dir:
        # the timed call: a chained row's trace replays its chain's graph
        # of 1 + iterations, which the timing then reuses
        traced, traced_x = ((lambda x: chained(x, 1 + cfg.iterations),
                             _chain_input(cfg, x_dev))
                            if chained is not None else (reduce_fn, x_dev))
        _, device_events, launches = trace_benchmark(
            traced, traced_x, trace_dir=cfg.trace_dir, device=device)
        logger.log(f"profiler trace written to {cfg.trace_dir} "
                   f"({device_events} device events, {launches} kernel "
                   "launches)")
        if device_events < launches:
            logger.log(f"WARNING: the trace in {cfg.trace_dir} misses "
                       f"kernels: {device_events} device events for "
                       f"{launches} launches")

    if chained is not None:
        try:
            sw = time_chained(chained, _chain_input(cfg, x_dev), k_lo=1,
                              k_hi=1 + cfg.iterations, reps=cfg.chain_reps)
        finally:
            chained.close()
        avg_s = sw.average_s if cfg.stat == "mean" else sw.median_s
        if avg_s <= 0:
            # noise swamped the slope: report no bandwidth from it
            return _unrun(cfg, QAStatus.WAIVED,
                          "chained timing slope non-positive (host noise)",
                          backend=backend, avg_s=avg_s,
                          iterations=cfg.iterations, timing="chained",
                          slope_samples_s=list(sw.samples))
        result = reduce_fn(x_dev)        # the verification value, untimed
    else:
        result, sw = time_fn(reduce_fn, x_dev,
                             sync=lambda: device_mod.synchronize(device),
                             iterations=cfg.iterations,
                             warmup=max(cfg.warmup, 1), mode=timing_mode)
        avg_s = sw.average_s if cfg.stat == "mean" else sw.median_s
    gbps = (cfg.nbytes / avg_s) / 1e9 if avg_s > 0 else float("inf")

    logger.log_master(throughput_line(gbps, avg_s, cfg.n,
                                      devices=1, workgroup=cfg.threads))

    host = host_reduce(x_host, cfg.method) if cfg.verify else None
    pending = _PendingResult(cfg, backend, gbps, avg_s, result, host, logger,
                             timing=("chained" if chained is not None
                                     else timing_mode),
                             samples=(list(sw.samples)
                                      if chained is not None else None))
    return pending if defer else pending.finalize()


def main(argv=None) -> int:
    """CLI entry: RUNNING marker, parse, run, terminal marker; returns the
    QA exit code.
    The counterpart of tpu_reductions/bench/driver.py:593."""
    qa_start(NAME, list(argv) if argv else sys.argv[1:])
    cfg, shmoo = parse_single_chip(argv)
    ledger.arm_session(NAME, argv=list(argv) if argv else sys.argv[1:])
    from tpu_reductions_torch.exec.core import maybe_arm
    maybe_arm(cfg.platform)
    logger = _make_logger(cfg)
    if cfg.stream:
        # the streaming pipeline replaces stage-then-reduce; the probe
        # CLI (bench/stream.py) shares this core. Imported here: it imports
        # bench/resume.py, which imports this module.
        from tpu_reductions_torch.bench.stream import run_stream_benchmark
        row = run_stream_benchmark(
            cfg.method, cfg.dtype, cfg.n, seed=cfg.seed,
            chunk_bytes=cfg.chunk_bytes, verify=cfg.verify,
            platform=cfg.platform, device_index=cfg.device, log=logger.log)
        logger.log_master(throughput_line(
            row["gbps_sustained"], row["stream_wall_s"], cfg.n,
            devices=1, workgroup=cfg.threads))
        logger.log(f"streamed {row['num_chunks']} chunk(s): "
                   f"{row['gbps_sustained']} GB/s sustained, "
                   f"{row['chunks_per_s']} chunks/s")
        return qa_finish(NAME, QAStatus[row["status"]])
    if shmoo:
        # imported here: bench/sweep.py imports this module
        from tpu_reductions_torch.bench.sweep import run_shmoo
        results = run_shmoo(cfg, min_pow=shmoo[0], max_pow=shmoo[1],
                            logger=logger)
        ok = all(r.passed or r.status == QAStatus.WAIVED for r in results)
        return qa_finish(NAME, QAStatus.PASSED if ok else QAStatus.FAILED)
    res = run_benchmark(cfg, logger=logger)
    return qa_finish(NAME, res.status)
