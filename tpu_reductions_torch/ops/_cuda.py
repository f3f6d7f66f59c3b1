"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use each source `csrc/<name>.cu` is compiled by `nvcc` for
`sm_90a` into `_build/lib<name>.so` (one `nvcc` per source, all started
together) and loaded with ctypes, each library by its own name:
`reduce` (k6, k7), `accumulate` (k8, k10), `mxu` (k9), `pair` (dd,
the f64 pair route) and `fault` (the spin kernel of the `spin` fault,
no ported kernel); they share `csrc/common.cuh`. The sources have a
plain C interface: pointers and the stream go in as `c_void_p`, and each
C function returns `cudaGetLastError()` after its launches, which the
wrappers here turn into an exception. Nothing is built or loaded at
import, so the CPU tests import this module without `nvcc`.

No reference analog: the JAX package compiles its kernels through Pallas;
each wrapper below names the TPU kernel it replaces.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

# No --use_fast_math and nvcc's default -ftz=false: csrc/pair.cu's
# error-free transformations need every addition rounded to nearest, and
# subnormal lo planes kept, which fast math would give up.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

OP_CODES = {"SUM": 0, "MIN": 1, "MAX": 2}
DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.float64: 2,
               torch.bfloat16: 3}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
# The C functions of each source's library, csrc/<name>.cu -> lib<name>.so.
_SIGNATURES = {
    "reduce": {
        # tr_k6_reduce(in, partials, out, rows, span, share, blocks, cluster,
        #              op, dtype, stream)
        "tr_k6_reduce": [_VP, _VP, _VP, _LL, _LL, _LL, _INT, _INT, _INT, _INT,
                         _VP],
        # tr_k7_reduce(in, out, rows, span, share, blocks, cluster, op, dtype,
        #              stream)
        "tr_k7_reduce": [_VP, _VP, _LL, _LL, _LL, _INT, _INT, _INT, _INT, _VP],
        # tr_span_active_clusters(cluster, op, dtype, &clusters)
        "tr_span_active_clusters": [_INT, _INT, _INT, ctypes.POINTER(_INT)],
    },
    "accumulate": {
        # tr_k8_reduce(in, partials, out, tickets, tiles, tm, splits, unroll,
        #              fused, op, dtype, stream)
        "tr_k8_reduce": [_VP, _VP, _VP, _VP, _LL, _LL, _INT, _INT, _INT,
                         _INT, _INT, _VP],
        # tr_k10_reduce(in, partials, out, tiles, tm, splits, depth, chunks,
        #               op, dtype, stream)
        "tr_k10_reduce": [_VP, _VP, _VP, _LL, _LL, _INT, _INT, _INT, _INT,
                          _INT, _VP],
    },
    "mxu": {
        # tr_k9_reduce(in, partials, out, rows, run, blocks, dtype, stream)
        "tr_k9_reduce": [_VP, _VP, _VP, _LL, _LL, _INT, _INT, _VP],
    },
    "pair": {
        # tr_dd_reduce(hi, lo, out, tickets, tiles, tm, splits, residues,
        #              scalar, op, stream)
        "tr_dd_reduce": [_VP, _VP, _VP, _VP, _LL, _LL, _INT, _INT, _INT,
                         _INT, _VP],
    },
    "fault": {
        # tr_spin_wait(ns, stream)
        "tr_spin_wait": [_LL, _VP],
    },
}

# The spin kernel's cap, SPIN_CAP_NS in csrc/fault.cu: a spin that the
# watchdog's exit leaves running frees the card by itself.
SPIN_CAP_S = 30.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _library_path(source: Path, build_dir: Path = BUILD) -> Path:
    return build_dir / f"lib{source.stem}.so"


def _stale(source: Path, newest_header: float, build_dir: Path) -> bool:
    lib = _library_path(source, build_dir)
    return (not lib.exists() or lib.stat().st_mtime
            < max(source.stat().st_mtime, newest_header))


def build(build_dir: Path = BUILD) -> tuple[float, str]:
    """Compile every stale source (older than its library, or than a
    header in csrc/), in parallel, into `build_dir` (the package's
    _build/; bench/warm.py times a build into an empty directory);
    return (seconds, the compilers' output, which holds `-Xptxas -v`'s
    register report). Raises RuntimeError, with the compiler's output,
    when a compile fails.
    No reference analog (the module docstring)."""
    build_dir = Path(build_dir)
    build_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    newest_header = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                        default=0.0)
    stale = [src for src in sorted(CSRC.glob("*.cu"))
             if _stale(src, newest_header, build_dir)]
    jobs = []
    for src in stale:
        tmp = build_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, cmd, proc))
    logs = []
    for src, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== nvcc {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed with exit "
                               f"{proc.returncode}:\n{out}")
        os.replace(tmp, _library_path(src, build_dir))
    return time.perf_counter() - t0, "".join(logs)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library of csrc/<name>.cu, built first if
    stale.
    No reference analog (the module docstring)."""
    build()
    lib = ctypes.CDLL(str(_library_path(CSRC / f"{name}.cu")))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.tr_error_string.argtypes = [ctypes.c_int]
    lib.tr_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.tr_error_string(err).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def k6_reduce(x2d: torch.Tensor, partials: torch.Tensor, out: torch.Tensor,
              plan, op_name: str) -> None:
    """Launch k6's two passes, laid out by `plan` (a kernel_reduce.SpanPlan),
    on x2d's device and current stream.
    Replaces tpu_reductions/ops/pallas_reduce.py:390."""
    lib = library("reduce")
    with torch.cuda.device(x2d.device):
        err = lib.tr_k6_reduce(x2d.data_ptr(), partials.data_ptr(),
                               out.data_ptr(), x2d.shape[0], plan.span,
                               plan.share, plan.blocks, plan.cluster,
                               OP_CODES[op_name], DTYPE_CODES[x2d.dtype],
                               _stream(x2d))
    _check(lib, err, "k6")


def k7_reduce(x2d: torch.Tensor, out: torch.Tensor, plan,
              op_name: str) -> None:
    """Launch one k7 pass, laid out by `plan`, on x2d's device and current
    stream.
    Replaces tpu_reductions/ops/pallas_reduce.py:404."""
    lib = library("reduce")
    with torch.cuda.device(x2d.device):
        err = lib.tr_k7_reduce(x2d.data_ptr(), out.data_ptr(), x2d.shape[0],
                               plan.span, plan.share, plan.blocks,
                               plan.cluster, OP_CODES[op_name],
                               DTYPE_CODES[x2d.dtype], _stream(x2d))
    _check(lib, err, "k7")


def span_active_clusters(device: torch.device, cluster: int, op_name: str,
                         dtype: torch.dtype) -> int:
    """cudaOccupancyMaxActiveClusters of k6's and k7's pass for `dtype`
    (the input's) and clusters of `cluster` CTAs: how many such clusters
    the device holds at once.
    No reference analog: a TPU grid has no clusters."""
    lib = library("reduce")
    clusters = _INT(0)
    with torch.cuda.device(device):
        err = lib.tr_span_active_clusters(cluster, OP_CODES[op_name],
                                          DTYPE_CODES[dtype],
                                          ctypes.byref(clusters))
    _check(lib, err, "the cluster occupancy query of k6/k7")
    return clusters.value


def k8_reduce(x2d: torch.Tensor, partials: torch.Tensor, out: torch.Tensor,
              tickets: torch.Tensor, tm: int, plan, op_name: str) -> None:
    """Launch k8, laid out by `plan` (a kernel_reduce.PeriodPlan), on
    x2d's device and current stream, with that stream's `tickets` (zero,
    and left zero): its pass, whose last CTA of each slot group folds the
    splits with `plan.fused`, and otherwise the fold of its partials.
    Replaces tpu_reductions/ops/pallas_reduce.py:227."""
    lib = library("accumulate")
    with torch.cuda.device(x2d.device):
        err = lib.tr_k8_reduce(x2d.data_ptr(), partials.data_ptr(),
                               out.data_ptr(), tickets.data_ptr(),
                               x2d.shape[0] // tm, tm, plan.splits,
                               plan.unroll, int(plan.fused),
                               OP_CODES[op_name], DTYPE_CODES[x2d.dtype],
                               _stream(x2d))
    _check(lib, err, "k8")


def k10_reduce(x2d: torch.Tensor, partials: torch.Tensor, out: torch.Tensor,
               tm: int, plan, op_name: str) -> None:
    """Launch k10's streamed pass, laid out by `plan` (a
    kernel_reduce.StreamPlan), and its fold on x2d's device and current
    stream.
    Replaces tpu_reductions/ops/pallas_reduce.py:338."""
    lib = library("accumulate")
    with torch.cuda.device(x2d.device):
        err = lib.tr_k10_reduce(x2d.data_ptr(), partials.data_ptr(),
                                out.data_ptr(), x2d.shape[0] // tm, tm,
                                plan.splits, plan.depth, plan.chunks,
                                OP_CODES[op_name], DTYPE_CODES[x2d.dtype],
                                _stream(x2d))
    _check(lib, err, "k10")


def k9_reduce(x2d: torch.Tensor, partials: torch.Tensor, out: torch.Tensor,
              plan) -> None:
    """Launch k9's tensor-core pass, laid out by `plan` (a
    kernel_reduce.MxuPlan), and its fold on x2d's device and current
    stream.
    Replaces tpu_reductions/ops/pallas_reduce.py:240."""
    lib = library("mxu")
    with torch.cuda.device(x2d.device):
        err = lib.tr_k9_reduce(x2d.data_ptr(), partials.data_ptr(),
                               out.data_ptr(), x2d.shape[0], plan.run,
                               plan.blocks, DTYPE_CODES[x2d.dtype],
                               _stream(x2d))
    _check(lib, err, "k9")


def dd_reduce(hi2d: torch.Tensor, lo2d: torch.Tensor, out: torch.Tensor,
              tickets: torch.Tensor, tm: int, plan, op_name: str,
              scalar: bool) -> None:
    """Launch the pair kernel, laid out by `plan` (a dd_reduce.DdPlan), on
    hi2d's device and current stream, with that stream's `tickets` (zero,
    and left zero): pass 1, the accumulator into `out`, and with `scalar`
    pass 2, the scalar pair, as a programmatic dependent launch.
    Replaces tpu_reductions/ops/dd_reduce.py:250."""
    lib = library("pair")
    with torch.cuda.device(hi2d.device):
        err = lib.tr_dd_reduce(hi2d.data_ptr(), lo2d.data_ptr(),
                               out.data_ptr(), tickets.data_ptr(),
                               hi2d.shape[0] // tm, tm, plan.splits,
                               plan.residues, int(scalar), OP_CODES[op_name],
                               _stream(hi2d))
    _check(lib, err, "dd")


def spin_ns(seconds: float) -> int:
    """The spin kernel's duration in nanoseconds: `seconds`, at least 0
    and at most SPIN_CAP_S.
    No reference analog: the cap of the card's stall (spin_wait)."""
    return int(min(max(float(seconds), 0.0), SPIN_CAP_S) * 1e9)


def spin_wait(seconds: float, device) -> None:
    """Launch the spin kernel (csrc/fault.cu) on `device`'s current
    stream: one thread that returns `seconds` (capped at SPIN_CAP_S)
    after it starts, so the stream's next work, and the host's next
    synchronize, waits that long. The launch returns at once. Counted in
    spin_wait.launches, apart from the six ported kernels. A stuck kernel
    is a card's fault: on any other device this raises, and nothing
    sleeps in its place.
    The card's form of the `stall` action of
    tpu_reductions/faults/inject.py:142."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"spin_wait needs a CUDA device, got {device}: "
                           "a stuck kernel has no host stand-in")
    ns = spin_ns(seconds)
    lib = library("fault")
    with torch.cuda.device(device):
        err = lib.tr_spin_wait(ns, torch.cuda.current_stream(device)
                               .cuda_stream)
    _check(lib, err, "the spin kernel")
    spin_wait.launches += 1


spin_wait.launches = 0
