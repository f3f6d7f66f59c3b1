"""Host oracle: the CPU reference every device result is checked against,
and the benchmark payload.

The counterpart of tpu_reductions/ops/oracle.py:1, with its two routes:
- native: csrc/oracle.cpp, built by g++ at first use and loaded with
  ctypes (ops/_native.py): Kahan-compensated sums for reals (threaded from
  2^22 elements), a wrapping int32 sum, linear min/max scans, and the
  std::mt19937 payload filler;
- numpy, when the library does not build or TPU_REDUCTIONS_NO_NATIVE is
  set (read once, at the first load): exact int64-then-wrap for int32 SUM,
  float64 accumulation for reals (`math.fsum` for float64 below 2^22
  elements), numpy scans for MIN/MAX, and utils/rng's payload.
bfloat16 has no native route: its payload and oracle are numpy on both.
`IncrementalOracle` is the same oracle fed one chunk at a time, for the
streaming pipeline.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Union

import numpy as np
import torch

from tpu_reductions_torch.ops import _native
from tpu_reductions_torch.ops.registry import get_op, tolerance
from tpu_reductions_torch.utils.rng import host_data

_SUFFIX = {"int32": "i32", "float32": "f32", "float64": "f64"}
# from this many elements, real SUM runs the threaded Kahan sum
_MT_THRESHOLD = 1 << 22


@functools.cache
def _load():
    """The native library, or None: TPU_REDUCTIONS_NO_NATIVE is set, or it
    did not build or load. Tried once per process."""
    if os.environ.get("TPU_REDUCTIONS_NO_NATIVE"):
        return None
    try:
        return _native.load()
    except (RuntimeError, OSError):
        return None


def native_available() -> bool:
    """Whether the native oracle and filler are in use.
    The counterpart of tpu_reductions/ops/oracle.py:94."""
    return _load() is not None


def route(dtype: str) -> str:
    """`native` or `numpy`: the route of a dtype's payload and oracle.
    The counterpart of tpu_reductions/ops/oracle.py:94."""
    return "native" if native_available() and dtype in _SUFFIX else "numpy"


def native_fill(n: int, dtype: str, rank: int = 0, seed: int = 0
                ) -> Optional[np.ndarray]:
    """The payload from the native MT19937 filler, or None when the library
    is not in use or the dtype has no native filler (bfloat16).
    The counterpart of tpu_reductions/ops/oracle.py:165."""
    lib = _load()
    if lib is None or dtype not in _SUFFIX:
        return None
    out = np.empty(n, dtype=dtype)
    getattr(lib, f"oracle_fill_{_SUFFIX[dtype]}")(out, n, rank, seed)
    return out


def payload(n: int, dtype: str, rank: int = 0, seed: int = 0
            ) -> torch.Tensor:
    """The benchmark payload as a CPU tensor: the native filler's where it
    is in use, as the JAX CLI's, else utils/rng's.
    The counterpart of tpu_reductions/ops/oracle.py:165."""
    x = native_fill(n, dtype, rank=rank, seed=seed)
    if x is None:
        return host_data(n, dtype, rank=rank, seed=seed)
    return torch.from_numpy(x)


def host_value(x: torch.Tensor) -> np.ndarray:
    """A tensor (any device) as a numpy array on the host; bfloat16, which
    numpy lacks, widens exactly to float32.
    No reference analog: a jax.Array converts with np.asarray."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def host_reduce(x: Union[torch.Tensor, np.ndarray], method: str
                ) -> np.ndarray:
    """The oracle reduction of the payload `x` (a CPU tensor or a numpy
    array). SUM of int32 wraps modulo 2^32 (the device accumulator's
    width); SUM of reals is float64, Kahan-compensated on the native route;
    MIN/MAX return the input's value. SCAN's scalar digest is its last
    prefix element, the full SUM (its whole prefix: family.host_scan);
    ARGMIN/ARGMAX give numpy's first-occurrence index.
    The counterpart of tpu_reductions/ops/oracle.py:104."""
    method = method.upper()
    if method == "SCAN":
        return host_reduce(x, "SUM")
    if method in ("ARGMIN", "ARGMAX"):
        from tpu_reductions_torch.ops.family.argreduce import host_arg_reduce
        return host_arg_reduce(
            host_value(x) if isinstance(x, torch.Tensor) else x, method)
    if method not in ("SUM", "MIN", "MAX"):
        raise ValueError(f"unknown method {method!r}")
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        a = host_value(x)
        if method == "SUM":
            return np.float64(a.astype(np.float64).sum())
        return get_op(method).np_reduce(a)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.ascontiguousarray(x)
    dtype = str(x.dtype)
    lib = _load() if dtype in _SUFFIX else None
    if method != "SUM":
        if lib is not None:
            fn = getattr(lib, f"oracle_{method.lower()}_{_SUFFIX[dtype]}")
            return x.dtype.type(fn(x, x.size))
        return get_op(method).np_reduce(x)
    if dtype == "int32":
        if lib is not None:
            return np.int32(lib.oracle_sum_i32(x, x.size))
        return np.int64(x.sum(dtype=np.int64)).astype(np.int32)
    if lib is not None:
        suffix = _SUFFIX[dtype]
        if x.size >= _MT_THRESHOLD:
            fn = getattr(lib, f"oracle_kahan_sum_{suffix}_mt")
            return np.float64(fn(x, x.size, min(8, lib.oracle_hw_threads())))
        return np.float64(getattr(lib, f"oracle_kahan_sum_{suffix}")(
            x, x.size))
    if dtype == "float64":
        return np.float64(math.fsum(x.tolist()) if x.size < _MT_THRESHOLD
                          else x.sum(dtype=np.float64))
    return np.float64(x.sum(dtype=np.float64))


class IncrementalOracle:
    """The host oracle of a streamed reduction, fed one chunk at a time
    (ops/stream.py), so that a streamed payload is verified without a
    second whole copy. SUM/MIN/MAX, SCAN's digest (as SUM) and ARG*.

    Each update runs host_reduce on the chunk (native when the library is
    in use) and folds its value into the running state: int32 SUM wraps
    modulo 2^32 like the device accumulator; real SUM carries a Kahan
    pair (total, compensation) across chunk boundaries; MIN/MAX keep the
    running extreme; ARG* keep the extreme and its global index (the
    chunk's offset is `count`), a tie keeping the earlier, lower index.
    state() and from_state() round-trip through JSON, so a resumed stream
    verifies without reading the chunks it already folded.
    The counterpart of tpu_reductions/ops/oracle.py:180."""

    def __init__(self, method: str, dtype: str) -> None:
        self.method = method.upper()
        if self.method not in ("SUM", "MIN", "MAX", "SCAN", "ARGMIN",
                               "ARGMAX"):
            raise ValueError(f"unknown method {method!r}")
        self.dtype = str(dtype)
        self.count = 0
        self._int_total = 0          # int32 SUM: wrapped running total
        self._sum = 0.0              # real SUM: Kahan pair
        self._comp = 0.0
        self._extreme: Optional[float] = None   # MIN/MAX running value
        self._extreme_idx: Optional[int] = None   # ARG*: its global index

    def update(self, chunk: torch.Tensor) -> None:
        """Fold one host chunk (a CPU tensor) into the running state.
        The counterpart of tpu_reductions/ops/oracle.py:218."""
        if chunk.numel() == 0:
            return
        if self.method in ("ARGMIN", "ARGMAX"):
            a = host_value(chunk).reshape(-1)
            li = int(np.argmin(a) if self.method == "ARGMIN"
                     else np.argmax(a))
            v = float(a[li])
            if (self._extreme is None
                    or (v < self._extreme if self.method == "ARGMIN"
                        else v > self._extreme)):
                self._extreme = v
                self._extreme_idx = self.count + li
            self.count += int(chunk.numel())
            return
        h = host_reduce(chunk, self.method)
        self.count += int(chunk.numel())
        if self.method in ("SUM", "SCAN"):
            if self.dtype == "int32":
                # both addends wrap mod 2^32 already; so does their sum
                self._int_total = int(np.int64(self._int_total)
                                      + np.int64(np.int32(h))
                                      & np.int64(0xFFFFFFFF))
            else:
                y = float(h) - self._comp
                t = self._sum + y
                self._comp = (t - self._sum) - y
                self._sum = t
        else:
            v = float(h)
            if self._extreme is None:
                self._extreme = v
            elif self.method == "MIN":
                self._extreme = min(self._extreme, v)
            else:
                self._extreme = max(self._extreme, v)

    def value(self):
        """The oracle so far, as host_reduce gives it: np.int32 for int32
        SUM, np.float64 for real SUM, the input's value for MIN/MAX
        (bfloat16 as the exact float32, which numpy has), np.int64 for
        ARG*.
        The counterpart of tpu_reductions/ops/oracle.py:265."""
        if self.method in ("SUM", "SCAN"):
            if self.dtype == "int32":
                return np.int64(self._int_total).astype(np.int32)[()]
            return np.float64(self._sum)
        if self.method in ("ARGMIN", "ARGMAX"):
            if self._extreme_idx is None:
                raise ValueError("oracle saw no data")
            return np.int64(self._extreme_idx)
        if self._extreme is None:
            raise ValueError("oracle saw no data")
        dtype = "float32" if self.dtype == "bfloat16" else self.dtype
        return np.dtype(dtype).type(self._extreme)

    def state(self) -> dict:
        """A JSON-able snapshot for the stream's resume checkpoint.
        The counterpart of tpu_reductions/ops/oracle.py:284."""
        return {"method": self.method, "dtype": self.dtype,
                "count": self.count, "int_total": self._int_total,
                "sum": self._sum, "comp": self._comp,
                "extreme": self._extreme, "extreme_idx": self._extreme_idx}

    @classmethod
    def from_state(cls, state: dict) -> "IncrementalOracle":
        """The oracle an interrupted stream persisted.
        The counterpart of tpu_reductions/ops/oracle.py:294."""
        o = cls(state["method"], state["dtype"])
        o.count = int(state.get("count", 0))
        o._int_total = int(state.get("int_total", 0))
        o._sum = float(state.get("sum", 0.0))
        o._comp = float(state.get("comp", 0.0))
        o._extreme = state.get("extreme")
        idx = state.get("extreme_idx")
        o._extreme_idx = None if idx is None else int(idx)
        return o


def verify(device_result, host_result, method: str, dtype: str, n: int
           ) -> tuple[bool, float]:
    """Acceptance check: (passed, abs_diff). Ints and MIN/MAX exact;
    float SUM within registry.tolerance.
    The counterpart of tpu_reductions/ops/oracle.py:308."""
    tol = tolerance(method, dtype, n)
    diff = abs(float(np.asarray(device_result, dtype=np.float64))
               - float(np.asarray(host_result, dtype=np.float64)))
    if tol == 0.0:
        passed = np.asarray(device_result).astype(np.float64) == \
            np.asarray(host_result).astype(np.float64)
        return bool(passed), diff
    return diff <= tol, diff
