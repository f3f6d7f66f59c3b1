"""Plain reference of the mpi_reduce configuration: reduce.c's MPI_Reduce,
the elementwise op over every rank's block, rank by rank.

It draws each rank's raw block again from the benchmark's generator
(portbench/payload.py), never taking what the program placed or
computed, and combines them in plain torch on the process's device:

  int32 SUM   int64 partial sums, wrapped modulo 2^32 at the end;
  MIN, MAX    exact;
  float64 SUM a compensated (Neumaier) sum over the ranks in rank order,
              which for eight addends is the exact sum rounded once.

`lowered` is the control: float64 rows in float32.
"""

from __future__ import annotations

import torch

from portbench import payload


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def expected(dtype: str, seed: int, ranks: int, length: int,
             device: torch.device, lowered: bool = False) -> dict:
    """{method: (length,) tensor} of every method over the `ranks`
    blocks of `dtype` drawn from `seed`; with `lowered`, the control's
    float32 answers of a float64 payload."""
    acc = None
    for r in range(ranks):
        x = payload.draw(seed, payload.stream_of(dtype, r), length, dtype,
                         device)
        if lowered and dtype == "float64":
            x = x.float()
        if acc is None:
            acc = {"MIN": x.clone(), "MAX": x.clone()}
            if x.dtype == torch.int32:
                acc["SUM"] = x.to(torch.int64)
            else:
                acc["SUM"], acc["comp"] = x.clone(), torch.zeros_like(x)
            continue
        torch.minimum(acc["MIN"], x, out=acc["MIN"])
        torch.maximum(acc["MAX"], x, out=acc["MAX"])
        if x.dtype == torch.int32:
            acc["SUM"] += x
        else:
            s = acc["SUM"]
            t = s + x
            big = s.abs() >= x.abs()
            acc["comp"] += torch.where(big, (s - t) + x, (x - t) + s)
            acc["SUM"] = t
    if "comp" in acc:
        acc["SUM"] = acc["SUM"] + acc.pop("comp")
    else:
        acc["SUM"] = _wrap32(acc["SUM"])
    return acc


def compare(method: str, dtype: str, got: torch.Tensor,
            want: torch.Tensor) -> tuple:
    """(rank copies that differ at all, widest gap of a float64 SUM over
    the reference's largest magnitude) of one answer, whose every row is
    a rank's copy of the reduced array."""
    if dtype == "float64" and method == "SUM":
        scale = want.abs().max().item() or 1.0
        gap = (got.to(torch.float64) - want).abs().max().item() / scale
        return 0, gap
    return int((got != want).any(dim=1).sum().item()), 0.0


def control_entry(method: str, mesh, ctx):
    """The control in the program's place: every rank copy of this
    process answers with the reference worked out in `lowered` precision
    (drawn once, at set-up; it needs no exchange)."""
    want = expected(ctx.dtype, ctx.seed, ctx.config["ranks"], ctx.length,
                    mesh.device, lowered=True)[method]
    return lambda x: want.expand(x.shape[0], -1)
