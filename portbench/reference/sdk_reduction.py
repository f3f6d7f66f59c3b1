"""Plain reference of the sdk_reduction configuration: one payload
reduced to a scalar, as reduction.cpp's CPU check does, exactly.

It starts from the raw payload the benchmark drew, never from what the
program staged, and uses plain torch on whatever device the payload is:

  int32 SUM   the int64 sum, wrapped modulo 2^32 (the card's int32 adds);
  MIN, MAX    exact;
  float64 SUM the exact sum of the payload's values, rounded once: the
              distinct values and their counts, added as fractions.

`lowered` is the control: the same in the nearest precision below the
configuration's (float32 for float64; int32 has none below it that the
configuration names, and stays as it is).
"""

from __future__ import annotations

from fractions import Fraction

import torch


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def expected(method: str, x: torch.Tensor):
    """The exact answer of `method` over the flat payload x (a Python int
    or float)."""
    if method == "MIN":
        return x.min().item()
    if method == "MAX":
        return x.max().item()
    if x.dtype == torch.int32:
        return _wrap32(int(x.sum(dtype=torch.int64).item()))
    values, counts = torch.unique(x, return_counts=True)
    exact = sum((Fraction(v) * c for v, c in zip(values.tolist(),
                                                 counts.tolist())),
                Fraction(0))
    return float(exact)


def lowered(method: str, x: torch.Tensor) -> torch.Tensor:
    """The control's answer, a 0-d tensor: float64 payloads reduced in
    float32."""
    if x.dtype == torch.float64:
        x = x.float()
    if method == "MIN":
        return x.min()
    if method == "MAX":
        return x.max()
    return x.sum(dtype=x.dtype)


def checks(rows: list, limits: dict) -> tuple:
    """Compare every answer with the exact one.

    `rows`: (method, dtype, [(answer, expected), ...]) for each row.
    Returns ({name: [number, limit]}, the answers outside their limit):
    `exact_mismatch` counts the answers of int32 rows and of MIN/MAX that
    differ at all; `f64_sum_gap` is the widest |answer - exact| of the
    float64 SUM answers."""
    mismatch, gap, failed = 0, 0.0, 0
    for method, dtype, pairs in rows:
        for got, want in pairs:
            if dtype == "float64" and method == "SUM":
                d = abs(float(got) - want)
                gap = max(gap, d)
                failed += d > limits["f64_sum_gap"]
            elif got != want:
                mismatch += 1
                failed += 1
    return ({"exact_mismatch": [mismatch, limits["exact_mismatch"]],
             "f64_sum_gap": [gap, limits["f64_sum_gap"]]}, failed)


def control_entry(method: str, n: int, dtype: str, config: dict, device):
    """The control in the program's place: (stage_fn, reduce_fn) that keep
    the raw payload and answer with `lowered`."""
    return (lambda x: x), (lambda x: lowered(method, x))
