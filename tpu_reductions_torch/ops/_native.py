"""Build and load the native host oracle and filler (csrc/oracle.cpp).

At first use `csrc/oracle.cpp` is compiled by `g++` into
`_build/liboracle.so`, and again whenever the source is newer than the
library, then loaded with ctypes. It is host code: it needs `g++`, not
`nvcc`, so it builds wherever the CPU tests run.

The flags are the JAX package's csrc/Makefile's without `-march=native`:
a library built for one host's CPU must not be loaded on another, and the
results do not depend on it (the Kahan loops only add and subtract, and
nothing reassociates without `-ffast-math`, which stays off).

Each build writes a file of its own process and moves it into place with
`os.replace`, so processes that build at once (test workers) never load a
half-written library.

The counterpart of tpu_reductions/ops/oracle.py:35-93.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "oracle.cpp"
LIBRARY = _PKG / "_build" / "liboracle.so"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
# name: (restype, argtypes)
_SIGNATURES = {
    "oracle_kahan_sum_f32": (ctypes.c_double, [_F32P, _I64]),
    "oracle_kahan_sum_f64": (ctypes.c_double, [_F64P, _I64]),
    "oracle_kahan_sum_f32_mt": (ctypes.c_double, [_F32P, _I64, ctypes.c_int]),
    "oracle_kahan_sum_f64_mt": (ctypes.c_double, [_F64P, _I64, ctypes.c_int]),
    "oracle_hw_threads": (ctypes.c_int, []),
    "oracle_sum_i32": (ctypes.c_int32, [_I32P, _I64]),
    "oracle_min_i32": (ctypes.c_int32, [_I32P, _I64]),
    "oracle_max_i32": (ctypes.c_int32, [_I32P, _I64]),
    "oracle_min_f32": (ctypes.c_float, [_F32P, _I64]),
    "oracle_max_f32": (ctypes.c_float, [_F32P, _I64]),
    "oracle_min_f64": (ctypes.c_double, [_F64P, _I64]),
    "oracle_max_f64": (ctypes.c_double, [_F64P, _I64]),
    "oracle_fill_i32": (None, [_I32P, _I64, _U32, _U32]),
    "oracle_fill_f32": (None, [_F32P, _I64, _U32, _U32]),
    "oracle_fill_f64": (None, [_F64P, _I64, _U32, _U32]),
}


def build(library: Path = LIBRARY) -> Path:
    """Compile SOURCE into `library` unless the library is newer than the
    source. Raises RuntimeError, with the compiler's output, when g++
    fails.
    The counterpart of tpu_reductions/ops/oracle.py:35."""
    if library.exists() and \
            library.stat().st_mtime >= SOURCE.stat().st_mtime:
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed with exit "
                           f"{proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, library)
    return library


def load(library: Path = LIBRARY) -> ctypes.CDLL:
    """The native oracle library, built first if stale, with every entry
    point's argtypes and restype declared.
    The counterpart of tpu_reductions/ops/oracle.py:44."""
    lib = ctypes.CDLL(str(build(library)))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
