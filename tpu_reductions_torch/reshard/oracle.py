"""The pure-numpy reshard reference: every executed plan is verified
against it, element by element, rank by rank.

The port's copy of tpu_reductions/reshard/oracle.py: the single-chip
bench's elementwise host oracle (reduction.cpp:232-239) lifted to
placements. The question is whether rank r holds exactly the block of
the logical global array its target spec assigns it. Nothing here
imports torch: the reference shares no code with the device path it
checks; the executor hands it numpy blocks
(reshard/primitives.collect_shards).

Value convention (reshard/spec.py): a non-partial spec's carried value
is the global array itself; a `partial` spec's carried value is a stack
of per-rank addends of shape (k, *global_shape) whose elementwise sum is
the logical global value.
"""

from __future__ import annotations

import numpy as np

from tpu_reductions_torch.reshard.spec import ShardingSpec, ShardingSpecError


def logical_global(carried: np.ndarray, spec: ShardingSpec
                   ) -> np.ndarray:
    """The logical global array a carried value denotes: itself, or the
    sum over the leading stacked rank axis when the spec is partial
    (module docstring)."""
    x = np.asarray(carried)
    if not spec.partial:
        return x
    k = spec.num_ranks
    if x.ndim != spec.ndim + 1 or x.shape[0] != k:
        raise ShardingSpecError(
            f"partial value must be a (k={k}, *shape) addend stack, "
            f"got shape {x.shape}")
    # accumulate wide so the reference is at least as accurate as the
    # device sum it judges
    return x.astype(np.float64, copy=False).sum(axis=0).astype(x.dtype) \
        if np.issubdtype(x.dtype, np.floating) else x.sum(axis=0)


def local_block(global_np: np.ndarray, spec: ShardingSpec, rank: int
                ) -> np.ndarray:
    """What rank `rank` of a 1-D mesh holds under `spec` (non-partial):
    the full array when replicated, else block `rank` of the single
    sharded dimension: the whole reshard semantics, which every device
    program must match."""
    if spec.partial:
        raise ShardingSpecError(
            "local_block describes settled placements; a partial "
            "spec's per-rank value is addend `rank` of the stack")
    if len(spec.mesh_axes) != 1:
        raise ShardingSpecError(
            f"oracle handles 1-D meshes, got {spec.mesh_axes}")
    d = spec.sharded_dim()
    if d is None:
        return np.asarray(global_np)
    k = spec.num_ranks
    size = global_np.shape[d] // k
    idx = [slice(None)] * global_np.ndim
    idx[d] = slice(rank * size, (rank + 1) * size)
    return np.asarray(global_np)[tuple(idx)]


def reshard_reference(carried: np.ndarray, src: ShardingSpec,
                      dst: ShardingSpec, rank: int) -> np.ndarray:
    """The numpy answer for rank `rank` after resharding `carried`
    (placed per `src`) into `dst` — logical_global then local_block."""
    return local_block(logical_global(carried, src), dst, rank)


def verify_placement(carried: np.ndarray, src: ShardingSpec,
                     dst: ShardingSpec, shards: list,
                     atol: float = 0.0) -> dict:
    """Element-wise verification of an executed plan: `shards[r]` is
    the numpy block rank r actually holds; every rank must match the
    reference within `atol` (0.0 = bit-exact; quantized wire passes
    the composed declared bound). Returns {ok, max_err, ranks}."""
    k = dst.num_ranks
    if len(shards) != k:
        raise ShardingSpecError(
            f"expected {k} rank shards, got {len(shards)}")
    max_err = 0.0
    ok = True
    # the logical value once, not once a rank: a partial source's sum
    # over its addend stack is the costly part
    logical = logical_global(carried, src)
    checked = []    # blocks already held against the whole logical value
    for r in range(k):
        want = local_block(logical, dst, r)
        got = np.asarray(shards[r])
        if want is logical:
            if any(got is c for c in checked):
                continue    # the same block against the same reference
            checked.append(got)
        if got.shape != want.shape:
            return {"ok": False, "max_err": float("inf"), "ranks": k,
                    "detail": f"rank {r} shape {got.shape} != "
                              f"{want.shape}"}
        if atol == 0.0:
            ok = ok and bool(np.array_equal(got, want))
            if not ok:
                max_err = max(max_err, float(
                    np.abs(got.astype(np.float64)
                           - want.astype(np.float64)).max()))
        else:
            err = float(np.abs(got.astype(np.float64)
                               - want.astype(np.float64)).max())
            max_err = max(max_err, err)
            ok = ok and err <= atol
    return {"ok": bool(ok), "max_err": max_err, "ranks": k}
