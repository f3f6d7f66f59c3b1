"""Host oracle: the CPU reference every device result is checked against.

The numpy route of tpu_reductions/ops/oracle.py (`host_reduce`, `verify`,
`IncrementalOracle`): exact int64-then-wrap for int32 SUM, float64
accumulation for reals (`math.fsum` for float64 below 2^22 elements),
linear scans for MIN/MAX; and the same oracle fed one chunk at a time, for
the streaming pipeline.
The JAX package's native C++ oracle and filler (csrc/oracle.cpp) are not
ported yet, so the port always uses this route and utils/rng's payload.
"""

from __future__ import annotations

import math
from typing import Optional

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


class IncrementalOracle:
    """The host oracle of a streamed reduction, fed one chunk at a time
    (ops/stream.py), so that a streamed payload is verified without a
    second whole copy. SUM/MIN/MAX; SCAN and ARG* are not ported.

    Each update runs host_reduce on the chunk and folds its value into the
    running state: int32 SUM wraps modulo 2^32 like the device
    accumulator; real SUM carries a Kahan pair (total, compensation)
    across chunk boundaries; MIN/MAX keep the running extreme. state() and
    from_state() round-trip through JSON, so a resumed stream verifies
    without reading the chunks it already folded."""

    def __init__(self, method: str, dtype: str) -> None:
        self.method = method.upper()
        if self.method not in ("SUM", "MIN", "MAX"):
            raise ValueError(f"unknown method {method!r}")
        self.dtype = str(dtype)
        self.count = 0
        self._int_total = 0          # int32 SUM: wrapped running total
        self._sum = 0.0              # real SUM: Kahan pair
        self._comp = 0.0
        self._extreme: Optional[float] = None   # MIN/MAX running value

    def update(self, chunk: torch.Tensor) -> None:
        """Fold one host chunk (a CPU tensor) into the running state."""
        if chunk.numel() == 0:
            return
        h = host_reduce(chunk, self.method)
        self.count += int(chunk.numel())
        if self.method == "SUM":
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
        (bfloat16 as the exact float32, which numpy has)."""
        if self.method == "SUM":
            if self.dtype == "int32":
                return np.int64(self._int_total).astype(np.int32)[()]
            return np.float64(self._sum)
        if self._extreme is None:
            raise ValueError("oracle saw no data")
        dtype = "float32" if self.dtype == "bfloat16" else self.dtype
        return np.dtype(dtype).type(self._extreme)

    def state(self) -> dict:
        """A JSON-able snapshot for the stream's resume checkpoint."""
        return {"method": self.method, "dtype": self.dtype,
                "count": self.count, "int_total": self._int_total,
                "sum": self._sum, "comp": self._comp,
                "extreme": self._extreme}

    @classmethod
    def from_state(cls, state: dict) -> "IncrementalOracle":
        """The oracle an interrupted stream persisted."""
        o = cls(state["method"], state["dtype"])
        o.count = int(state.get("count", 0))
        o._int_total = int(state.get("int_total", 0))
        o._sum = float(state.get("sum", 0.0))
        o._comp = float(state.get("comp", 0.0))
        o._extreme = state.get("extreme")
        return o


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
