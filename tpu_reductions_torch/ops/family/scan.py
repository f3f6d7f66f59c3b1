"""SCAN: inclusive prefix sum, the blocked matrix-product scan and the
cumsum baseline.

The counterpart of tpu_reductions/ops/family/scan.py:1. The inclusive prefix
of a row block x of width B is x @ U with U[i, j] = 1 iff i <= j (Carrasco
et al., arXiv:1811.09736); the blocks then add their predecessors' totals,
one cumsum over the block totals. Two implementations, under the JAX
package's surface ids, so that manifests join:

  xla-cumsum  `torch.cumsum(x, dtype=x.dtype)`, every dtype. The dtype is
              given: torch would widen int32 to int64, and lose the
              mod-2^32 wrap that the oracle and the JAX package have.
  mxu-scan    the blocked product on the tensor cores (float dtypes; an
              integer product has no tensor-core form here). JAX asks for
              precision="highest", so the product runs with TF32 and
              bf16's reduced-precision reduction off at the call.

Neither is a kernel of this repository: the JAX package computes both in
jnp, outside any Pallas kernel.

`StreamScanner` scans a payload of any size over the streaming chunk
plan (ops/stream.plan_chunks): per chunk, y = scan(chunk) + carry and
carry' = y[-1]. For int32 that is bit-identical to the one-shot scan
(modular addition is associative); floats reassociate across chunk
boundaries within SUM's tolerance.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from tpu_reductions_torch import device as device_mod
from tpu_reductions_torch.ops.oracle import host_value
from tpu_reductions_torch.ops.registry import torch_dtype
from tpu_reductions_torch.ops.stream import iter_chunks, plan_chunks

# the within-block scan width (the JAX package's matrix-unit tile)
_BLOCK = 128

SCAN_IMPLS = ("xla-cumsum", "mxu-scan")


def _is_float(dtype) -> bool:
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return dtype.is_floating_point


def scan_impls(dtype) -> tuple:
    """The implementations legal for `dtype`: mxu-scan is float-only.
    The counterpart of tpu_reductions/ops/family/scan.py:54."""
    return SCAN_IMPLS if _is_float(dtype) else ("xla-cumsum",)


@contextlib.contextmanager
def _highest_precision():
    """float32 products in full float32 and bf16 products reduced in
    float32, for the block: the JAX package's precision="highest"."""
    matmul = torch.backends.cuda.matmul
    saved = (torch.get_float32_matmul_precision(),
             matmul.allow_bf16_reduced_precision_reduction,
             matmul.allow_fp16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("highest")
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        matmul.allow_bf16_reduced_precision_reduction = saved[1]
        matmul.allow_fp16_reduced_precision_reduction = saved[2]


def _core(impl: str, dtype: str):
    """The inclusive prefix along the last axis, for one implementation."""
    if impl == "xla-cumsum":
        def core(x):
            return torch.cumsum(x, -1, dtype=x.dtype)
    elif impl == "mxu-scan":
        if not _is_float(dtype):
            raise ValueError(f"mxu-scan is float-only, got {dtype}")

        def core(x):
            n = x.shape[-1]
            nb = -(-n // _BLOCK)
            xp = torch.nn.functional.pad(x, (0, nb * _BLOCK - n))
            xp = xp.reshape(*x.shape[:-1], nb, _BLOCK)
            u = torch.triu(torch.ones((_BLOCK, _BLOCK), dtype=x.dtype,
                                      device=x.device))
            with _highest_precision():
                within = xp @ u
            # the carry level: the exclusive prefix of the block totals
            totals = within[..., -1]
            excl = torch.cumsum(totals, -1, dtype=x.dtype) - totals
            out = (within + excl[..., None]).reshape(*x.shape[:-1], -1)
            return out[..., :n]
    else:
        raise ValueError(f"unknown scan impl {impl!r}; one of {SCAN_IMPLS}")
    return core


@functools.cache
def scan_fn(impl: str, dtype: str):
    """(chunk, carry) -> its inclusive prefix plus carry: carry is the
    running total of everything before the chunk (0 for a one-shot
    scan), a 0-d tensor of the chunk's dtype on its device, so int32
    wraps in the device's own width.
    The counterpart of tpu_reductions/ops/family/scan.py:108."""
    core = _core(impl, dtype)
    return lambda x, carry: core(x) + carry


@functools.cache
def scan_rows_fn(impl: str, dtype: str):
    """(k, n) -> (k, n) per-row inclusive prefixes: k stacked SCAN
    requests in one call (the serving shape).
    The counterpart of tpu_reductions/ops/family/scan.py:123."""
    return _core(impl, dtype)


def host_scan(x) -> np.ndarray:
    """Host oracle: the full inclusive prefix in the device's conventions;
    int32 wraps modulo 2^32 (an exact int64 cumsum, truncated), floats
    accumulate in float64.
    The counterpart of tpu_reductions/ops/family/scan.py:135."""
    x = np.ravel(np.asarray(x))
    if x.dtype == np.int32:
        return np.cumsum(x.astype(np.int64)).astype(np.uint64).astype(
            np.uint32).view(np.int32)
    return np.cumsum(x.astype(np.float64))


class StreamScanner:
    """Chunk-carry prefix scan over the streaming chunk plan (module
    docstring): at most one chunk and its result on the device at a
    time, every chunk within `chunk_bytes`. Runs on `device`, the card
    unless the caller gives another.
    The counterpart of tpu_reductions/ops/family/scan.py:151."""

    def __init__(self, dtype: str, n: int, *, impl: str = "xla-cumsum",
                 chunk_bytes: Optional[int] = None,
                 device: Optional[torch.device] = None) -> None:
        self.dtype = str(dtype)
        self.impl = impl
        self.plan = plan_chunks(n, self.dtype, chunk_bytes)
        self.device = device_mod.resolve("gpu") if device is None else device
        self._fn = scan_fn(impl, self.dtype)
        self._carry = torch.zeros((), dtype=torch_dtype(self.dtype),
                                  device=self.device)

    @property
    def carry(self):
        """The running total of every element scanned so far.
        The counterpart of tpu_reductions/ops/family/scan.py:169."""
        return host_value(self._carry)[()]

    def scan(self, flat) -> np.ndarray:
        """The full inclusive prefix of `flat` (numpy or a CPU tensor),
        one bounded chunk at a time, as a numpy array.
        The counterpart of tpu_reductions/ops/family/scan.py:174."""
        flat = torch.as_tensor(flat).reshape(-1)
        if flat.dtype != torch_dtype(self.dtype):
            raise ValueError(f"expected {self.dtype}, got {flat.dtype}")
        out = None
        pos = 0
        for chunk in iter_chunks(flat, self.plan):
            # redlint: disable=RED015 -- one iter_chunks chunk, at most the plan's chunk bound (config.stage_chunk_bytes)
            y = self._fn(chunk.to(self.device), self._carry)
            self._carry = y[-1]
            host = host_value(y)
            if out is None:
                out = np.empty(flat.numel(), dtype=host.dtype)
            out[pos:pos + host.size] = host
            pos += host.size
        return out
