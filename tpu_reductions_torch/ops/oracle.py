"""Host oracle: the CPU reference every device result is checked against.

The numpy route of tpu_reductions/ops/oracle.py (`host_reduce`, `verify`):
exact int64-then-wrap for int32 SUM, float64 accumulation for reals
(`math.fsum` for float64 below 2^22 elements), linear scans for MIN/MAX.
The JAX package's native C++ oracle and filler (csrc/oracle.cpp) are not
ported yet, so the port always uses this route and utils/rng's payload.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_reductions_torch.ops.registry import get_op, tolerance


def host_value(x: torch.Tensor) -> np.ndarray:
    """A tensor (any device) as a numpy array on the host; bfloat16, which
    numpy lacks, widens exactly to float32."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def host_reduce(x: torch.Tensor, method: str) -> np.ndarray:
    """The oracle reduction of the payload `x`. SUM of int32 wraps modulo
    2^32 (the device accumulator's width); SUM of reals is float64;
    MIN/MAX return the input's value."""
    method = method.upper()
    if method == "SUM":
        if x.dtype == torch.bfloat16:
            return np.float64(host_value(x).astype(np.float64).sum())
        a = x.numpy()
        if a.dtype == np.int32:
            return np.int64(a.sum(dtype=np.int64)).astype(np.int32)
        if a.dtype == np.float32:
            return np.float64(a.sum(dtype=np.float64))
        return np.float64(math.fsum(a.tolist()) if a.size < (1 << 22)
                          else a.sum(dtype=np.float64))
    if method in ("MIN", "MAX"):
        return get_op(method).np_reduce(host_value(x))
    raise ValueError(f"unknown method {method!r}")


def verify(device_result, host_result, method: str, dtype: str, n: int
           ) -> tuple[bool, float]:
    """Acceptance check: (passed, abs_diff). Ints and MIN/MAX exact;
    float SUM within registry.tolerance."""
    tol = tolerance(method, dtype, n)
    diff = abs(float(np.asarray(device_result, dtype=np.float64))
               - float(np.asarray(host_result, dtype=np.float64)))
    if tol == 0.0:
        passed = np.asarray(device_result).astype(np.float64) == \
            np.asarray(host_result).astype(np.float64)
        return bool(passed), diff
    return diff <= tol, diff
