"""The reshard engine: array redistribution on the collectives registry,
on the port's rank axis.

The counterpart of tpu_reductions/reshard/ (Zhang et al. 2112.01075,
EQuARX 2506.17615):

  spec.py        ShardingSpec: validated, with a canonical JSON that is
                 byte-identical to the JAX package's
  primitives.py  the four redistribution moves as torch programs over the
                 rank axis, and the plan executor with its buffer
                 accounting
  planner.py     the cheapest primitive program under a peak-memory
                 bound, priced by collectives/algorithms.algorithm_cost
  oracle.py      the numpy reference every executed plan is verified
                 against, rank by rank

Instrument: bench/reshard_curve.py. The JAX `partition_spec` (a
jax.sharding PartitionSpec) has no counterpart: a placed value here is a
(k_local, *local_shape) tensor (primitives.place_spec).
"""

from tpu_reductions_torch.reshard.oracle import (local_block,
                                                 logical_global,
                                                 reshard_reference,
                                                 verify_placement)
from tpu_reductions_torch.reshard.planner import (Plan, PlanStep,
                                                  ReshardPlanError,
                                                  naive_plan, plan_reshard)
from tpu_reductions_torch.reshard.primitives import (PRIMITIVES, Primitive,
                                                     collect_shards,
                                                     declared_buffers,
                                                     declared_mem_factor,
                                                     execute_plan, make_mesh,
                                                     place_spec,
                                                     quant_compression,
                                                     reshard_error_bound,
                                                     step_label)
from tpu_reductions_torch.reshard.spec import ShardingSpec, ShardingSpecError

__all__ = [
    "Plan", "PlanStep", "PRIMITIVES", "Primitive", "ReshardPlanError",
    "ShardingSpec", "ShardingSpecError", "collect_shards",
    "declared_buffers", "declared_mem_factor", "execute_plan",
    "local_block", "logical_global", "make_mesh", "naive_plan",
    "place_spec", "plan_reshard", "quant_compression",
    "reshard_error_bound", "reshard_reference", "step_label",
    "verify_placement",
]
