"""Data-dependent chained reduction, for slope timing.

The counterpart of tpu_reductions/ops/chain.py: `chained(x2d, k)` runs k
reductions, each folding its scalar into element [0, 0] of the next one's
input with the op's own combine, so no iteration can be skipped or
hoisted. The launches are queued eagerly with no host sync in between;
the caller materializes the last scalar once, which bounds the completion
of all k.

`core` is `core(x2d) -> scalar`, or, on the f64 pair route, `core(hi2d,
lo2d) -> (s_hi, s_lo)` with `x2d` the tuple of the two planes: then the
first plane's scalar is folded into the first plane's [0, 0] and returned.

JAX's loop carry is a fresh array; here the fold is an in-place write.
So the chain runs on clones of the staged tensors, and the caller's
tensors, which the driver verifies afterwards, stay as they were staged.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from tpu_reductions_torch.ops.registry import ReduceOpSpec

Staged = Union[torch.Tensor, tuple]


def make_chained_reduce(core: Callable, op: ReduceOpSpec):
    """Wrap `core` into `chained(x2d, k) -> 0-d tensor` running k
    data-dependent iterations (k >= 1)."""

    def chained(x2d: Staged, k: int) -> torch.Tensor:
        pair = isinstance(x2d, tuple)
        planes = tuple(p.clone() for p in x2d) if pair else (x2d.clone(),)
        first = planes[0]
        last = None
        for _ in range(k):
            last = core(*planes)[0] if pair else core(first)
            first[0, 0] = op.combine(first[0, 0], last.to(first.dtype))
        return last

    return chained
