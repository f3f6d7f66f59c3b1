"""The reshard planner: the cheapest primitive program under a
peak-memory bound.

The port's copy of tpu_reductions/reshard/planner.py (Zhang et al.,
arXiv:2112.01075). Given a (source, target) ShardingSpec pair on one mesh
axis, the planner enumerates the candidate primitive programs
(reshard/primitives.py), prices each with the cost machinery every
collective is priced with (collectives/algorithms.algorithm_cost over the
reshard_* registry entries), attaches each plan's declared peak-memory
factor (the max over its steps' `declared_buffers` sums), and picks the
cheapest plan whose factor fits `mem_bound`. A bound that no candidate
fits is refused, with every candidate's factor in the message.

Candidate programs (k ranks, global payload G):

  src == dst                identity            0 wire
  partial -> sharded d      [reduce_scatter d]  (k-1)/k G
  partial -> replicated     [reduce_scatter 0, all_gather 0]
  replicated -> sharded d   [dynamic_slice d]   0 wire
  sharded d -> replicated   [all_gather d]      (k-1)/k G
  sharded a -> sharded b    [collective_permute a->b]    (k-1)/k**2 G
                         vs [all_gather a, dynamic_slice b]  "naive"

The permute beats the naive program by a factor k on wire but holds the
pieces beside its input and output (3/k + 2/k**2 against the naive's
1 + 1/k at the gathered intermediate), so at small k a tight --mem-bound
flips the choice. `naive_plan` is exported so that the curve can show
the margin.

The reference has no analog: its arrays lived whole on every rank
(reduce.c:30-36).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from tpu_reductions_torch.collectives.algorithms import (REGISTRY,
                                                         algorithm_cost)
from tpu_reductions_torch.reshard import primitives as prims
from tpu_reductions_torch.reshard.spec import ShardingSpec

# The JAX package's model parameters (choose_topology's defaults, which
# model its TPU links: tens of microseconds a hop, ~100 GB/s-class links),
# kept so that both planners choose the same programs; they describe no
# property of the card, where a hop is a copy inside its memory.
DEFAULT_ALPHA_S = 20e-6
DEFAULT_BETA_S_PER_BYTE = 1 / 100e9


class ReshardPlanError(ValueError):
    """No candidate program fits (unsupported spec pair, or every
    candidate exceeds the memory bound)."""


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One primitive application: which move, under which registry
    label (quantized wire changes the label, never the primitive),
    between which intermediate specs, with its declared costs."""

    primitive: str
    algorithm: str
    src: ShardingSpec
    dst: ShardingSpec
    dims: Tuple[int, ...]
    quant_bits: Optional[int]
    wire_bytes: float
    mem_factor: float

    def to_obj(self) -> dict:
        return {"primitive": self.primitive, "algorithm": self.algorithm,
                "dims": list(self.dims), "quant_bits": self.quant_bits,
                "wire_bytes": self.wire_bytes,
                "mem_factor": round(self.mem_factor, 6)}


@dataclasses.dataclass(frozen=True)
class Plan:
    """A priced primitive program. `mem_factor` is the max over steps
    (one step runs at a time; its declared buffers are the live set),
    `wire_bytes`/`cost_s` sum the registry-priced steps."""

    source: ShardingSpec
    target: ShardingSpec
    steps: Tuple[PlanStep, ...]
    cost_s: float
    wire_bytes: float
    mem_factor: float
    quant_steps: int = 0
    note: str = ""

    def to_obj(self) -> dict:
        return {"src": self.source.to_obj(), "dst": self.target.to_obj(),
                "steps": [s.to_obj() for s in self.steps],
                "cost_s": self.cost_s, "wire_bytes": self.wire_bytes,
                "mem_factor": round(self.mem_factor, 6),
                "quant_steps": self.quant_steps, "note": self.note}


def _check_pair(src: ShardingSpec, dst: ShardingSpec) -> int:
    if len(src.mesh_axes) != 1 or len(dst.mesh_axes) != 1:
        raise ReshardPlanError(
            f"planner handles 1-D meshes (the paper's per-mesh-axis "
            f"sub-problem); got {src.mesh_axes} -> {dst.mesh_axes}")
    if src.mesh_axes != dst.mesh_axes:
        raise ReshardPlanError(
            f"source and target meshes differ: {src.mesh_axes} vs "
            f"{dst.mesh_axes}")
    if src.ndim != dst.ndim:
        raise ReshardPlanError(
            f"rank mismatch: {src.ndim} vs {dst.ndim} dims")
    if dst.partial:
        raise ReshardPlanError("a partial TARGET is not a placement")
    return src.num_ranks


def _step(primitive: str, src: ShardingSpec, dst: ShardingSpec,
          dims: Tuple[int, ...], k: int, g_bytes: int, itemsize: int,
          quant_bits: Optional[int], n_for_quant: int) -> PlanStep:
    """Build one priced step; the quantized wire applies only when the
    step's wire chunks block-align (collectives/quant.QUANT_BLOCK), else
    the step stays exact (the quantized ring's own fallback,
    quant_ring_applies)."""
    qb = quant_bits
    if qb is not None and (primitive in ("identity", "dynamic_slice",
                                         "reduce_scatter")
                           or n_for_quant % prims.QUANT_BLOCK != 0):
        qb = None
    label = prims.step_label(primitive, qb)
    in_f = src.local_fraction()
    out_f = dst.local_fraction()
    return PlanStep(
        primitive, label, src, dst, dims, qb,
        wire_bytes=REGISTRY[label].wire_factor(k) * g_bytes,
        mem_factor=prims.declared_mem_factor(primitive, k, in_f, out_f,
                                             qb, itemsize))


def _price(src, dst, steps, k, alpha_s, beta, g_bytes, note=""):
    cost = sum(algorithm_cost(s.algorithm, k, g_bytes, alpha_s, beta)
               for s in steps)
    mem = max([s.mem_factor for s in steps],
              default=src.local_fraction())
    return Plan(src, dst, tuple(steps), cost,
                sum(s.wire_bytes for s in steps), mem,
                quant_steps=sum(1 for s in steps
                                if s.quant_bits is not None),
                note=note)


def _candidates(src: ShardingSpec, dst: ShardingSpec,
                global_shape: Tuple[int, ...], itemsize: int,
                quant_bits: Optional[int], alpha_s: float,
                beta: float) -> list:
    k = _check_pair(src, dst)
    import numpy as np
    n = int(np.prod(global_shape))
    g_bytes = n * itemsize
    dst.local_shape(global_shape)   # divisibility gates
    if not src.partial:
        src.local_shape(global_shape)
    sd = None if src.partial else src.sharded_dim()
    dd = dst.sharded_dim()

    def step(primitive, s, d, dims, n_q):
        return _step(primitive, s, d, dims, k, g_bytes, itemsize,
                     quant_bits, n_q)

    out = []
    if src.partial:
        if dd is not None:
            out.append(_price(src, dst,
                              [step("reduce_scatter", src, dst, (dd,),
                                    n)],
                              k, alpha_s, beta, g_bytes))
        else:
            d0 = 0 if src.ndim else None
            if d0 is None or global_shape[0] % k:
                raise ReshardPlanError(
                    f"partial -> replicated needs dim 0 extent "
                    f"divisible by k={k} for the scatter+gather "
                    f"program (shape {global_shape})")
            mid = ShardingSpec.sharded(k, src.ndim, 0)
            out.append(_price(src, dst,
                              [step("reduce_scatter", src, mid, (0,),
                                    n),
                               step("all_gather", mid, dst, (0,),
                                    n // k)],
                              k, alpha_s, beta, g_bytes))
        return out
    if sd == dd:
        out.append(_price(src, dst, [], k, alpha_s, beta, g_bytes,
                          note="identity: source already matches"))
        return out
    if sd is None:
        out.append(_price(src, dst,
                          [step("dynamic_slice", src, dst, (dd,), n)],
                          k, alpha_s, beta, g_bytes))
        return out
    if dd is None:
        out.append(_price(src, dst,
                          [step("all_gather", src, dst, (sd,), n // k)],
                          k, alpha_s, beta, g_bytes))
        return out
    # sharded -> sharded on a different dim: permute vs naive
    out.append(_price(src, dst,
                      [step("collective_permute", src, dst, (sd, dd),
                            n // (k * k))],
                      k, alpha_s, beta, g_bytes))
    out.append(_naive(src, dst, k, g_bytes, n, itemsize, quant_bits,
                      alpha_s, beta))
    return out


def _naive(src, dst, k, g_bytes, n, itemsize, quant_bits, alpha_s,
           beta):
    sd, dd = src.sharded_dim(), dst.sharded_dim()
    rep = ShardingSpec.replicated(k, src.ndim)
    steps = [_step("all_gather", src, rep, (sd,), k, g_bytes, itemsize,
                   quant_bits, n // k),
             _step("dynamic_slice", rep, dst, (dd,), k, g_bytes,
                   itemsize, quant_bits, n)]
    return _price(src, dst, steps, k, alpha_s, beta, g_bytes,
                  note="naive all-gather-then-slice")


def plan_reshard(src: ShardingSpec, dst: ShardingSpec,
                 global_shape: Tuple[int, ...], itemsize: int = 4, *,
                 mem_bound: Optional[float] = None,
                 quant_bits: Optional[int] = None,
                 alpha_s: float = DEFAULT_ALPHA_S,
                 beta_s_per_byte: float = DEFAULT_BETA_S_PER_BYTE
                 ) -> Plan:
    """The planner's entry point (module docstring): cheapest candidate
    under `mem_bound`, ties broken toward fewer steps. Refuses — with
    every candidate's declared factor — when nothing fits."""
    cands = _candidates(src, dst, global_shape, itemsize, quant_bits,
                        alpha_s, beta_s_per_byte)
    fits = [p for p in cands
            if mem_bound is None or p.mem_factor <= mem_bound]
    if not fits:
        detail = "; ".join(
            f"[{' + '.join(s.primitive for s in p.steps) or 'identity'}]"
            f" needs {p.mem_factor:.3f}" for p in cands)
        raise ReshardPlanError(
            f"no {src.describe()} -> {dst.describe()} program fits "
            f"mem-bound {mem_bound}: {detail}")
    return min(fits, key=lambda p: (p.cost_s, len(p.steps)))


def naive_plan(src: ShardingSpec, dst: ShardingSpec,
               global_shape: Tuple[int, ...], itemsize: int = 4, *,
               quant_bits: Optional[int] = None,
               alpha_s: float = DEFAULT_ALPHA_S,
               beta_s_per_byte: float = DEFAULT_BETA_S_PER_BYTE
               ) -> Optional[Plan]:
    """The all-gather-then-slice baseline for a sharded->sharded pair
    (None for pairs with no naive alternative): the curve's margin reads
    its wire_bytes."""
    k = _check_pair(src, dst)
    if src.partial or src.sharded_dim() is None \
            or dst.sharded_dim() is None \
            or src.sharded_dim() == dst.sharded_dim():
        return None
    import numpy as np
    n = int(np.prod(global_shape))
    return _naive(src, dst, k, n * itemsize, n, itemsize, quant_bits,
                  alpha_s, beta_s_per_byte)
