"""ARGMIN / ARGMAX: index-carrying extremes through order-preserving keys.

The counterpart of tpu_reductions/ops/family/argreduce.py:1. For a float32
bit pattern b (`x.view(torch.int32)`), the key

    key = b ^ ((b >> 31) & 0x7FFFFFFF)

keeps non-negatives as they are and flips the magnitude bits of
negatives, so the signed int32 order of keys is float32's total order
(-0.0 below +0.0; NaN-free payloads); int32 values are their own key.
ARGMAX takes the complement ~key, which reverses int32 order exactly (no
negation overflow at INT32_MIN). The index is then the lowest one whose
key equals the least key: every tie goes to the lowest index by
construction, as in the JAX package. `torch.argmin` is not used: its
order on -0.0 and +0.0 is not the key's.

The host oracle is numpy's first-occurrence argmin/argmax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

ARG_METHODS = ("ARGMIN", "ARGMAX")


def order_key(x: np.ndarray) -> np.ndarray:
    """The host-side int32 order key of an int32 or float32 array.
    The counterpart of tpu_reductions/ops/family/argreduce.py:32."""
    x = np.ravel(np.asarray(x))
    if x.dtype == np.int32:
        return x
    if x.dtype != np.float32:
        raise ValueError(f"order_key supports int32/float32, got {x.dtype}")
    b = x.view(np.int32)
    return b ^ ((b >> np.int32(31)) & np.int32(0x7FFFFFFF))


def _method(method: str) -> str:
    m = method.upper()
    if m not in ARG_METHODS:
        raise ValueError(f"not an arg method: {method!r}")
    return m


def _keys(x: torch.Tensor, method: str) -> torch.Tensor:
    """The int32 keys of x whose least value marks the extreme."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
        key = b ^ ((b >> 31) & 0x7FFFFFFF)
    elif x.dtype == torch.int32:
        key = x
    else:
        raise ValueError(f"arg reductions take int32/float32, got {x.dtype}")
    return ~key if method == "ARGMAX" else key


@functools.cache
def arg_reduce_fn(method: str, dtype: str):
    """x (1-D) -> 0-d int32 index of the extreme, lowest index on ties.
    The counterpart of tpu_reductions/ops/family/argreduce.py:49."""
    m = _method(method)

    def argk(x: torch.Tensor) -> torch.Tensor:
        key = _keys(x, m)
        idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
        # non-ties masked to n, above every index
        return torch.where(key == key.min(), idx, x.shape[0]).min()

    return argk


@functools.cache
def arg_reduce_rows_fn(method: str, dtype: str):
    """(k, n) -> (k,) int32 per-row extreme indices: the serving shape,
    the same (key, index) rule row by row.
    The counterpart of tpu_reductions/ops/family/argreduce.py:84."""
    m = _method(method)

    def rows(x: torch.Tensor) -> torch.Tensor:
        key = _keys(x, m)
        idx = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        ext = key.amin(dim=1, keepdim=True)
        return torch.where(key == ext, idx[None, :], x.shape[1]).amin(dim=1)

    return rows


def host_arg_reduce(x: np.ndarray, method: str) -> np.int64:
    """Host oracle: numpy's first-occurrence argmin/argmax.
    The counterpart of tpu_reductions/ops/family/argreduce.py:115."""
    m = _method(method)
    x = np.ravel(np.asarray(x))
    return np.int64(np.argmin(x) if m == "ARGMIN" else np.argmax(x))
