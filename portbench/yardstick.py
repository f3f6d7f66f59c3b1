"""The benchmark's arithmetic: the table of peaks, the bytes a reduction
needs, the percentile of a cell's latencies and the union of device
intervals.

Copied, not imported, from the program (the HBM roof of
tpu_reductions_torch/bench/roofline.py's MEMORY_MODEL), so that no later
change to the program moves the yardstick.
"""

from __future__ import annotations

import statistics
from typing import Iterable, Sequence

# The H100 SXM data sheet's HBM3 rate at the full 700 W power limit, by
# the name torch.cuda.get_device_name() gives. A run on another kind has
# no roof here, and a roofline reader then reports nothing.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

ITEMSIZE = {"int32": 4, "float64": 8}


def hbm_peak(kind: str):
    """The HBM roof in bytes a second of a device kind, or None."""
    return HBM_BYTES_PER_S.get(kind)


def reduction_bytes(n: int, dtype: str) -> int:
    """The least bytes one reduction of n elements to a scalar moves: each
    input element read once and the scalar written once."""
    return n * ITEMSIZE[dtype] + ITEMSIZE[dtype]


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value (statistics.quantiles, its
    default exclusive method; one value is its own percentile)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20)[18]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile, as a share of
    the median (statistics.quantiles, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals: Iterable[tuple], lo: float, hi: float) -> float:
    """The length of the union of (start, end) intervals, clipped to
    [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[tuple], lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out = []
    at = lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out
