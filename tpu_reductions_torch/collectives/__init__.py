"""The exact collective suite on the port's rank axis (parallel/mesh.py).

The counterpart of tpu_reductions/collectives/, the MPI_Reduce analog
(reduce.c:76,90) as a subsystem:

  rings.py       the one place hops are built: ppermute over the rank
                 axis, the ring RS+AG, the accumulate-around-the-ring,
                 the topology constructors (ring, bidir, torus2d, naive)
                 and the all-to-all of reshard
  algorithms.py  the registry of wire patterns with their declared cost
                 factors, and select_algorithm, the one place a label
                 and its wire cost come from
  core.py        the constructors (all-reduce, reduce-scatter, reduce-to-root,
                 the dd ring, the key-pair MIN/MAX, the chains) and the
                 host plumbing (sharding, views, the oracle)
  quant.py       the quantized wire: block-scaled 4/8/16-bit SUM rings
                 with error feedback over f32/bf16/dd, the exact
                 coarse-key MIN/MAX, and their declared error bounds

The names below are those of the JAX package's collectives/__init__.py
but its jax version shim `shard_map`.
"""

from tpu_reductions_torch.collectives.algorithms import (
    REGISTRY, ROOTED_MODES, WIRE_FACTORS, Algorithm, Selection,
    algorithm_cost, bandwidth_report, choose_topology,
    collective_algorithm, dd_ring_algorithm, normalize_rooted,
    q8_ring_algorithm, quant_ring_algorithm, select_algorithm,
    topology_supported)
from tpu_reductions_torch.collectives.core import (
    host_collective_oracle, local_view, local_view_and_selection,
    make_chained_collective, make_chained_pair_collective,
    make_collective_reduce, make_dd_sum_all_reduce,
    make_key_minmax_all_reduce, mesh_spans_processes, shard_payload)
from tpu_reductions_torch.collectives.quant import (
    KEY_BITS, MINMAX_DTYPES, Q8_BLOCK, QUANT_BITS, QUANT_BLOCK,
    SUM_DTYPES, block_decode, block_encode, levels,
    make_q8_sum_all_reduce, make_quant_key_minmax_all_reduce,
    make_quant_sum_all_reduce, quant_error_bound, quant_ring_applies,
    quant_support_error, quant_supported)
from tpu_reductions_torch.collectives.rings import (
    grid_factors, make_topology_all_reduce, naive_accumulate,
    ring_all_to_all, ring_perm, ring_rs_ag, ring_rs_ag_stateful)

__all__ = [
    "REGISTRY", "ROOTED_MODES", "WIRE_FACTORS", "Algorithm", "Selection",
    "algorithm_cost", "bandwidth_report", "choose_topology",
    "collective_algorithm", "dd_ring_algorithm", "normalize_rooted",
    "q8_ring_algorithm", "quant_ring_algorithm", "select_algorithm",
    "topology_supported",
    "host_collective_oracle", "local_view", "local_view_and_selection",
    "make_chained_collective", "make_chained_pair_collective",
    "make_collective_reduce", "make_dd_sum_all_reduce",
    "make_key_minmax_all_reduce", "mesh_spans_processes", "shard_payload",
    "KEY_BITS", "MINMAX_DTYPES", "Q8_BLOCK", "QUANT_BITS", "QUANT_BLOCK",
    "SUM_DTYPES", "block_decode", "block_encode", "levels",
    "make_q8_sum_all_reduce", "make_quant_key_minmax_all_reduce",
    "make_quant_sum_all_reduce", "quant_error_bound",
    "quant_ring_applies", "quant_support_error", "quant_supported",
    "grid_factors", "make_topology_all_reduce", "naive_accumulate",
    "ring_all_to_all", "ring_perm", "ring_rs_ag", "ring_rs_ag_stateful",
]
