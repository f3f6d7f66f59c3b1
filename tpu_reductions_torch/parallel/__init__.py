"""The distributed layer: the rank mesh and the collective reductions.

The counterpart of tpu_reductions/parallel/: MPI_Reduce over the Blue
Gene/L torus becomes the port's collectives over a rank axis
(parallel/mesh.py: k ranks as the rows of one tensor per process, gloo
between processes); the VN/CO modes and BGLMPI_MAPPING become `mode` and
`mapping`; mpirun becomes `initialize_distributed`. `Q8_BLOCK` and
`make_q8_sum_all_reduce` are here for the int8 ring's callers, as in the
JAX package.
"""

from tpu_reductions_torch.parallel.mesh import (build_mesh, device_inventory,
                                                initialize_distributed)
from tpu_reductions_torch.collectives import (Q8_BLOCK, bandwidth_report,
                                              make_collective_reduce,
                                              make_q8_sum_all_reduce,
                                              shard_payload)

__all__ = ["build_mesh", "device_inventory", "initialize_distributed",
           "make_collective_reduce", "shard_payload", "bandwidth_report",
           "Q8_BLOCK", "make_q8_sum_all_reduce"]
