"""The reduction family: SCAN, segmented reductions, ARGMIN/ARGMAX.

The counterpart of tpu_reductions/ops/family/: the methods around the
three full reductions (config.FAMILY_METHODS), in plain torch, as the JAX
package computes them in jnp:

  SCAN            inclusive prefix sum: the blocked matrix-product scan
                  (mxu-scan) beside the cumsum baseline (xla-cumsum), and
                  a chunk-carry scanner over the streaming chunk plan
  SEGSUM/MIN/MAX  one result per segment of a ragged offset vector
  ARGMIN/ARGMAX   index-carrying extremes over order-preserving keys,
                  lowest index on ties

The surface ids (`family_surface`) are the JAX package's, so that the
smoke, warm and family-spot manifests of the two packages join.

The counterpart of tpu_reductions/ops/family/__init__.py:1.
"""

from __future__ import annotations

from tpu_reductions_torch.config import FAMILY_METHODS, SERVED_METHODS
from tpu_reductions_torch.ops.family.argreduce import (arg_reduce_fn,
                                                       arg_reduce_rows_fn,
                                                       host_arg_reduce,
                                                       order_key)
from tpu_reductions_torch.ops.family.scan import (SCAN_IMPLS, StreamScanner,
                                                  host_scan, scan_fn,
                                                  scan_impls, scan_rows_fn)
from tpu_reductions_torch.ops.family.segmented import (
    SEG_BASE, host_segment_reduce, random_offsets, segment_ids_from_offsets,
    segment_reduce_fn)

__all__ = [
    "FAMILY_METHODS", "SERVED_METHODS", "SCAN_IMPLS", "SEG_BASE",
    "is_family_method", "family_surface",
    "scan_fn", "scan_rows_fn", "scan_impls", "host_scan", "StreamScanner",
    "segment_reduce_fn", "host_segment_reduce", "segment_ids_from_offsets",
    "random_offsets",
    "arg_reduce_fn", "arg_reduce_rows_fn", "host_arg_reduce", "order_key",
]


def is_family_method(name: str) -> bool:
    """Whether `name` is a family method rather than SUM/MIN/MAX.
    The counterpart of tpu_reductions/ops/family/__init__.py:60."""
    return name.upper() in FAMILY_METHODS


def family_surface(method: str, impl: str | None = None) -> str:
    """The surface id of a family launch: mxu-scan or xla-cumsum for SCAN,
    seg/<method> and argk/<method> (the JAX package's spellings).
    The counterpart of tpu_reductions/ops/family/__init__.py:67."""
    m = method.upper()
    if m == "SCAN":
        return impl or "xla-cumsum"
    if m in SEG_BASE:
        return f"seg/{m.lower()}"
    if m in ("ARGMIN", "ARGMAX"):
        return f"argk/{m.lower()}"
    raise ValueError(f"not a family method: {method!r}")
