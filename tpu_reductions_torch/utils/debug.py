"""Diagnostics: the consistency gate of `--check` and the profiler capture
of `--trace`.

The counterpart of tpu_reductions/utils/debug.py. There the same payload
goes through the compiled Pallas kernel, the Pallas interpreter and XLA;
here through the roles' counterparts:
- the kernel the config names, on the card (compiled);
- its plain PyTorch version, on a CPU copy of the payload (interpret
  mode: a model of the kernel, never a stand-in for it);
- the torch comparator, ops/torch_reduce.py, on the card (XLA);
and all three against the host oracle. A spread between the first two is
a fault of the kernel or of its launch geometry.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.config import STREAM_BUFFERS
from tpu_reductions_torch.ops import dd_reduce
from tpu_reductions_torch.ops import oracle as oracle_mod
from tpu_reductions_torch.ops.kernel_reduce import kernel_reduce
from tpu_reductions_torch.ops.registry import tolerance
from tpu_reductions_torch.ops.torch_reduce import make_torch_reduce
from tpu_reductions_torch.utils.rng import host_data

TRACE_FILE = "trace.json"
TRACE_SESSIONS = 5


@dataclasses.dataclass
class ConsistencyReport:
    method: str
    dtype: str
    n: int
    kernel: float        # the hand-written kernel, on the card
    plain: float         # its plain version, on the CPU
    comparator: float    # the torch comparator, on the card
    oracle: float
    tol: float

    @property
    def ok(self) -> bool:
        vals = (self.kernel, self.plain, self.comparator)
        return all(abs(v - self.oracle) <= max(self.tol, 0.0) or
                   (self.tol == 0.0 and v == self.oracle) for v in vals)

    def describe(self) -> str:
        s = "OK" if self.ok else "MISMATCH"
        return (f"[{s}] {self.method}/{self.dtype} n={self.n}: "
                f"kernel={self.kernel!r} plain={self.plain!r} "
                f"comparator={self.comparator!r} oracle={self.oracle!r} "
                f"tol={self.tol:g}")


def _dd_value(x: torch.Tensor, method: str, threads: int, max_blocks: int,
              device: torch.device) -> float:
    """The f64 pair route's value: the pair kernel and its fused finish."""
    stage_fn, core, finish = dd_reduce.make_dd_device_reduce(
        method, x.numel(), threads=threads, max_blocks=max_blocks,
        device=device)
    hi2d, lo2d, scale_exp = stage_fn(x)
    return float(finish(*core(hi2d, lo2d), scale_exp=scale_exp))


def consistency_check(method: str, dtype: str, n: int, *,
                      threads: int = 256, max_blocks: int = 64,
                      kernel: int = 6, cpu_final: bool = False,
                      cpu_thresh: int = 1,
                      stream_buffers: int = STREAM_BUFFERS,
                      seed: int = 0, f64: str = "native",
                      platform: str = "gpu",
                      device_index: Optional[int] = None
                      ) -> ConsistencyReport:
    """The kernel at the given finish and depth (or, for float64 with
    f64="dd", the pair route), its plain version and the torch comparator
    against the host oracle, on utils/rng's payload of n elements."""
    x = host_data(n, dtype, rank=0, seed=seed)
    device = device_mod.resolve(platform, device_index)
    cpu = torch.device("cpu")
    if dtype == "float64" and f64 == "dd":
        compiled = _dd_value(x, method, threads, max_blocks, device)
        plain = _dd_value(x, method, threads, max_blocks, cpu)
    else:
        args = dict(threads=threads, max_blocks=max_blocks, kernel=kernel,
                    cpu_final=cpu_final, cpu_thresh=cpu_thresh,
                    stream_buffers=stream_buffers)
        compiled = float(kernel_reduce(x, method, device=device, **args))
        plain = float(kernel_reduce(x, method, device=cpu, **args))
    # redlint: disable=RED015 -- the consistency check's payload, capped at 2^20 elements by bench/driver.py
    comparator = float(make_torch_reduce(method)(x.to(device)))
    orc = float(np.asarray(oracle_mod.host_reduce(x, method),
                           dtype=np.float64))
    return ConsistencyReport(method, dtype, n, compiled, plain, comparator,
                             orc, tolerance(method, dtype, n))


def _device_events(prof) -> tuple[int, int]:
    """(device events, launches issued by the host) of a session: kernel
    launches, and graph launches, each of which runs at least one
    kernel."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    return (sum(e.device_type == cuda for e in events),
            sum(e.device_type != cuda and ("LaunchKernel" in e.name
                                           or "GraphLaunch" in e.name)
                for e in events))


def trace_benchmark(fn, *args, trace_dir: str, device: torch.device,
                    iterations: int = 3):
    """One warm call of fn(*args), then `iterations` calls under
    torch.profiler (CPU activity, and CUDA's on the card), each synced;
    the Chrome trace goes to `trace_dir`/trace.json. Returns (the last
    result, the device events in the written trace, the kernel launches
    the host issued in that session); fewer events than launches means
    the trace misses kernels.

    On an H100 after minutes of load the profiler was seen to leave some
    or all of a session's kernels out of its trace, in some sessions and
    not in others. So on the card a session that recorded fewer device
    events than the host launched kernels is repeated, up to
    TRACE_SESSIONS sessions, and the fullest one is written."""
    from torch.profiler import ProfilerActivity, profile

    result = fn(*args)              # first-call costs outside the trace
    device_mod.synchronize(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    best, best_counts = None, (-1, 0)
    for _ in range(TRACE_SESSIONS if device.type == "cuda" else 1):
        with profile(activities=activities) as prof:
            for _ in range(iterations):
                result = fn(*args)
                device_mod.synchronize(device)
        counts = _device_events(prof)
        if counts[0] > best_counts[0]:
            best, best_counts = prof, counts
        if counts[0] >= counts[1]:
            break
    path = Path(trace_dir)
    path.mkdir(parents=True, exist_ok=True)
    best.export_chrome_trace(str(path / TRACE_FILE))
    return (result, *best_counts)
