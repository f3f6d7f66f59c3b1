"""Reduction op registry: {SUM, MIN, MAX} over {int32, float32, float64,
bfloat16}, and the reduction family, in torch.

The counterpart of tpu_reductions/ops/registry.py:1 (`ReduceOpSpec`, `OPS`,
`FAMILY_OPS`, `accum_dtype`, `tolerance`): one table that the kernels'
wrappers, their plain versions, the comparator, the chain and the oracle
all key off.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

TORCH_DTYPES = {
    "int32": torch.int32,
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name (config.DTYPE_ALIASES values).
    No reference analog: the JAX package uses numpy's names."""
    return TORCH_DTYPES[name]


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype for SUM: f32 for sub-32-bit floats (bf16 stays
    2 B/element in memory but adds in f32), else the input dtype.
    The counterpart of tpu_reductions/ops/registry.py:55."""
    if dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return torch.float32
    return dtype


def _sum_identity(dt: torch.dtype):
    return 0


def _min_identity(dt: torch.dtype):
    # the padding value must never win: the largest value for MIN
    if dt.is_floating_point:
        return float("inf")
    return torch.iinfo(dt).max


def _max_identity(dt: torch.dtype):
    if dt.is_floating_point:
        return float("-inf")
    return torch.iinfo(dt).min


def _sum_same_dtype(x: torch.Tensor) -> torch.Tensor:
    """SUM in the accumulator dtype: int32 stays int32 and wraps modulo
    2^32 like the oracle (torch would promote to int64 without `dtype`)."""
    return torch.sum(x, dtype=accum_dtype(x.dtype))


@dataclasses.dataclass(frozen=True)
class ReduceOpSpec:
    """One reduction operator, described for every layer of the port.
    The counterpart of tpu_reductions/ops/registry.py:22."""

    name: str                       # SUM | MIN | MAX
    reduce: Callable                # full reduce to a 0-d tensor
    combine: Callable               # elementwise combine of two tensors
    np_reduce: Callable             # host finish (--cpufinal)
    monoid_identity: Callable       # torch dtype -> identity scalar

    def identity(self, dtype: torch.dtype):
        """Padding identity for `dtype`: what ragged tails are filled with,
        so padded slots cannot perturb the result.
        The counterpart of tpu_reductions/ops/registry.py:32."""
        return self.monoid_identity(dtype)

    def reduce_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Reduce along `dim`, SUM in the accumulator dtype.
        The reduce of tpu_reductions/ops/registry.py:22."""
        if self.name == "SUM":
            return torch.sum(x, dim=dim, dtype=accum_dtype(x.dtype))
        if self.name == "MIN":
            return torch.amin(x, dim=dim)
        return torch.amax(x, dim=dim)


OPS = {
    "SUM": ReduceOpSpec("SUM", _sum_same_dtype, torch.add, np.sum,
                        _sum_identity),
    "MIN": ReduceOpSpec("MIN", torch.amin, torch.minimum, np.min,
                        _min_identity),
    "MAX": ReduceOpSpec("MAX", torch.amax, torch.maximum, np.max,
                        _max_identity),
}


# The reduction family (config.FAMILY_METHODS, ops/family/): each entry
# describes the combine its partials obey, which is what the chain's fold
# and the padding use. SCAN and SEGSUM combine like SUM (a scan's scalar
# digest is its last prefix element, the full SUM), SEGMIN/SEGMAX like
# MIN/MAX, and ARGMIN/ARGMAX like MIN/MAX in the order-key domain
# (ops/family/argreduce.py).
FAMILY_OPS = {
    "SCAN": ReduceOpSpec("SCAN", _sum_same_dtype, torch.add, np.sum,
                         _sum_identity),
    "SEGSUM": ReduceOpSpec("SEGSUM", _sum_same_dtype, torch.add, np.sum,
                           _sum_identity),
    "SEGMIN": ReduceOpSpec("SEGMIN", torch.amin, torch.minimum, np.min,
                           _min_identity),
    "SEGMAX": ReduceOpSpec("SEGMAX", torch.amax, torch.maximum, np.max,
                           _max_identity),
    "ARGMIN": ReduceOpSpec("ARGMIN", torch.amin, torch.minimum, np.min,
                           _min_identity),
    "ARGMAX": ReduceOpSpec("ARGMAX", torch.amax, torch.maximum, np.max,
                           _max_identity),
}


def get_op(name: str) -> ReduceOpSpec:
    """Lookup by the CLI spelling (--method), the family's included.
    The counterpart of tpu_reductions/ops/registry.py:182."""
    key = name.upper()
    if key in OPS:
        return OPS[key]
    if key in FAMILY_OPS:
        return FAMILY_OPS[key]
    raise ValueError(f"unknown reduction {name!r}; expected one of "
                     f"{list(OPS) + list(FAMILY_OPS)}")


def tolerance(method: str, dtype: str, n: int) -> float:
    """Verification tolerance, the JAX package's table: ints exact;
    MIN/MAX and the family's extremes exact (arg indices are integers
    whatever the dtype); float32 SUM 1e-8*n; float64 SUM 1e-12; bfloat16
    SUM 1e-2*n.
    The counterpart of tpu_reductions/ops/registry.py:195."""
    if dtype in ("int32", "int64"):
        return 0.0
    if method.upper() in ("MIN", "MAX", "SEGMIN", "SEGMAX", "ARGMIN",
                          "ARGMAX"):
        return 0.0
    if dtype == "float64":
        return 1e-12
    if dtype == "bfloat16":
        return 1e-2 * n
    return 1e-8 * n
