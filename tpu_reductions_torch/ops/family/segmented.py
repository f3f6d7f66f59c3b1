"""Segmented reductions: SEGSUM / SEGMIN / SEGMAX over an offset vector.

The counterpart of tpu_reductions/ops/family/segmented.py:1: one flat
payload, a vector of segment offsets (ragged; segments may be empty), one
result per segment. The device side is `scatter_reduce` into an output
filled with the base op's identity, with the input's own values included,
so an empty segment comes back as the identity, as `jax.ops.segment_*`
gives it. int32 SEGSUM wraps modulo 2^32 per segment on the device and in
the oracle.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_reductions_torch.ops.registry import get_op, torch_dtype

# family method -> the classic op whose combine, identity and tolerance
# each segment follows
SEG_BASE = {"SEGSUM": "SUM", "SEGMIN": "MIN", "SEGMAX": "MAX"}
_SCATTER = {"SEGSUM": "sum", "SEGMIN": "amin", "SEGMAX": "amax"}


@functools.cache
def segment_reduce_fn(method: str, num_segments: int):
    """(x, segment_ids) -> (num_segments,) per-segment results. The ids
    are best given as int64 on x's device (scatter_reduce's index type);
    other integer ids are converted at every call.
    The counterpart of tpu_reductions/ops/family/segmented.py:38."""
    m = method.upper()
    reduce = _SCATTER[m]
    op = get_op(SEG_BASE[m])

    def seg(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        out = torch.full((num_segments,), op.identity(x.dtype),
                         dtype=x.dtype, device=x.device)
        return out.scatter_reduce(0, ids.to(torch.int64), x, reduce=reduce,
                                  include_self=True)

    return seg


def segment_ids_from_offsets(offsets: np.ndarray) -> np.ndarray:
    """Expand an offset vector (length S+1, offsets[0] = 0, offsets[-1] =
    n, monotone; equal neighbours are an empty segment) into the int32
    segment id of every element.
    The counterpart of tpu_reductions/ops/family/segmented.py:58."""
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.diff(offsets)
    if offsets[0] != 0 or (lengths < 0).any():
        raise ValueError("offsets must start at 0 and be monotone")
    return np.repeat(np.arange(lengths.size, dtype=np.int32), lengths)


def random_offsets(n: int, num_segments: int, seed: int) -> np.ndarray:
    """Ragged offsets for n elements: num_segments segments with uniformly
    random cut points, duplicates included, so empty segments occur. The
    JAX package's draws from `np.random.default_rng(seed)`.
    The counterpart of tpu_reductions/ops/family/segmented.py:72."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, n + 1, size=num_segments - 1))
    return np.concatenate(([0], cuts, [n])).astype(np.int64)


def host_segment_reduce(x, offsets: np.ndarray, method: str) -> np.ndarray:
    """Host oracle: each segment through host_reduce (int32 SEGSUM wraps
    modulo 2^32, float sums in float64, MIN/MAX exact); an empty segment
    is the base op's identity. float64, in which every family digest is
    compared (int32 values embed exactly).
    The counterpart of tpu_reductions/ops/family/segmented.py:85."""
    from tpu_reductions_torch.ops.oracle import host_reduce

    base = SEG_BASE[method.upper()]
    op = get_op(base)
    x = np.ravel(np.asarray(x))
    offsets = np.asarray(offsets, dtype=np.int64)
    out = np.empty(offsets.size - 1, dtype=np.float64)
    for i in range(offsets.size - 1):
        seg = x[offsets[i]:offsets[i + 1]]
        out[i] = (np.float64(op.identity(torch_dtype(str(x.dtype))))
                  if seg.size == 0 else np.float64(host_reduce(seg, base)))
    return out
