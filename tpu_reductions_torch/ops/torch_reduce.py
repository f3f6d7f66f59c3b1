"""The comparator, `--backend=torch`: one PyTorch reduction call.

The counterpart of tpu_reductions/ops/xla_reduce.py:1: `torch.sum` in the
accumulator dtype (int32 stays int32 and wraps), `torch.amin`,
`torch.amax`. It is the yardstick the hand-written kernels are measured
against, never the k6/k7 path.
"""

from __future__ import annotations

from tpu_reductions_torch.ops.registry import get_op


def make_torch_reduce(method: str):
    """`reduce(x) -> 0-d tensor` with PyTorch's own reduction, for the
    timed loop.
    The counterpart of tpu_reductions/ops/xla_reduce.py:32."""
    return get_op(method).reduce
