"""Data-dependent chained reduction, for slope timing.

The counterpart of tpu_reductions/ops/chain.py: `chained(x2d, k)` runs k
reductions, each folding its scalar into element [0, 0] of the next one's
input with the op's own combine, so no iteration can be skipped or
hoisted. The launches are queued eagerly with no host sync in between;
the caller materializes the last scalar once, which bounds the completion
of all k.

JAX's loop carry is a fresh array; here the fold is an in-place write.
So the chain runs on a clone of the staged tensor, and the caller's
tensor, which the driver verifies afterwards, stays as it was staged.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_reductions_torch.ops.registry import ReduceOpSpec


def make_chained_reduce(core: Callable, op: ReduceOpSpec):
    """Wrap `core(x2d) -> 0-d tensor` into `chained(x2d, k) -> 0-d tensor`
    running k data-dependent iterations (k >= 1)."""

    def chained(x2d: torch.Tensor, k: int) -> torch.Tensor:
        x = x2d.clone()
        last = None
        for _ in range(k):
            last = core(x)
            x[0, 0] = op.combine(x[0, 0], last.to(x.dtype))
        return last

    return chained
