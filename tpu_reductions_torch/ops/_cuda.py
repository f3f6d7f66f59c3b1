"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use each source `csrc/<name>.cu` is compiled by `nvcc` for
`sm_90a` into `_build/lib<name>.so` (one `nvcc` per source, all started
together) and loaded with ctypes. The sources have a plain C interface:
pointers and the stream go in as `c_void_p`, and each C function returns
`cudaGetLastError()` after its launches, which the wrappers here turn
into an exception. Nothing is built or loaded at import, so the CPU tests
import this module without `nvcc`.
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

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

OP_CODES = {"SUM": 0, "MIN": 1, "MAX": 2}
DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.float64: 2,
               torch.bfloat16: 3}

_VP = ctypes.c_void_p
_SIGNATURES = {
    # tr_k6_reduce(in, partials, out, rows, blocks, op, dtype, stream)
    "tr_k6_reduce": [_VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, _VP],
    # tr_k7_reduce(in, out, rows, span, blocks, op, dtype, stream)
    "tr_k7_reduce": [_VP, _VP, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _library_path(source: Path) -> Path:
    return BUILD / f"lib{source.stem}.so"


def build() -> tuple[float, str]:
    """Compile every stale source, in parallel; return (seconds, the
    compilers' output, which holds `-Xptxas -v`'s register report).
    Raises CalledProcessError when a compile fails."""
    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    stale = [src for src in sorted(CSRC.glob("*.cu"))
             if not _library_path(src).exists()
             or _library_path(src).stat().st_mtime < src.stat().st_mtime]
    jobs = []
    for src in stale:
        tmp = BUILD / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, cmd, proc))
    logs = []
    for src, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== nvcc {src.name}\n{out}")
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, cmd, out)
        os.replace(tmp, _library_path(src))
    return time.perf_counter() - t0, "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library of csrc/reduce.cu, built first if stale."""
    build()
    lib = ctypes.CDLL(str(_library_path(CSRC / "reduce.cu")))
    for fn, argtypes in _SIGNATURES.items():
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
              blocks: int, op_name: str) -> None:
    """Launch k6's two passes on x2d's device and current stream."""
    lib = library()
    with torch.cuda.device(x2d.device):
        err = lib.tr_k6_reduce(x2d.data_ptr(), partials.data_ptr(),
                               out.data_ptr(), x2d.shape[0], blocks,
                               OP_CODES[op_name], DTYPE_CODES[x2d.dtype],
                               _stream(x2d))
    _check(lib, err, "k6")


def k7_reduce(x2d: torch.Tensor, out: torch.Tensor, span: int, blocks: int,
              op_name: str) -> None:
    """Launch one k7 pass on x2d's device and current stream."""
    lib = library()
    with torch.cuda.device(x2d.device):
        err = lib.tr_k7_reduce(x2d.data_ptr(), out.data_ptr(), x2d.shape[0],
                               span, blocks, OP_CODES[op_name],
                               DTYPE_CODES[x2d.dtype], _stream(x2d))
    _check(lib, err, "k7")
