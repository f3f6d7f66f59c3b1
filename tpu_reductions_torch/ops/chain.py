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

`auto_chain_span` sizes the chain's span (the iterations between the
slope's two ends) for a chained shmoo cell.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

from tpu_reductions_torch.ops.registry import ReduceOpSpec, torch_dtype

Staged = Union[torch.Tensor, tuple]

# The rates a span is sized from: the card's device-memory rate (H100 SXM
# data sheet, 700 W), and the JAX package's host rate, so that the spans
# on the CPU equal its spans there. A span covers about SPAN_SIGNAL_S of
# work, within [SPAN_MIN, SPAN_MAX] iterations (the JAX package's values).
CARD_BYTES_PER_S = 3.35e12
CPU_BYTES_PER_S = 10e9
SPAN_SIGNAL_S = 6e-3
SPAN_MIN, SPAN_MAX = 8, 4096


def auto_chain_span(n: int, dtype: str, platform: str = "gpu") -> int:
    """The span for chained timing at payload size n: enough iterations
    for about SPAN_SIGNAL_S of work at the platform's rate (the card's
    memory rate, or the host's). A fixed span is noise-bound at small n
    and wastes minutes at large n."""
    rate = CPU_BYTES_PER_S if platform == "cpu" else CARD_BYTES_PER_S
    est_iter_s = n * torch_dtype(dtype).itemsize / rate
    return max(SPAN_MIN, min(SPAN_MAX, math.ceil(
        SPAN_SIGNAL_S / max(est_iter_s, 1e-9))))


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
