"""One process of a two-process int32 SUM whose every sum overflows
int32: the all-reduce must wrap mod 2^32 as the host oracle does.

    python tests/multicard_overflow.py cpu|gpu PORT PROCESS_ID

Run by tests/test_torch_multicard.py (gloo, on the CPU) and by
tests/test_torch_cuda.py (NCCL, on two cards); prints `wrapped <largest
true sum> <first wrapped sum>` and exits 0 when the result is the
oracle's.
"""

import sys

import numpy as np

from tpu_reductions_torch.collectives import (
    host_collective_oracle, local_view, make_collective_reduce,
    shard_payload)
from tpu_reductions_torch.parallel.mesh import (
    build_mesh, initialize_distributed, leave_distributed)

platform, port, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
initialize_distributed(f"127.0.0.1:{port}", 2, pid, platform=platform)
mesh = build_mesh(num_devices=4, platform=platform, local_ranks=2)
rng = np.random.default_rng(7)
x = rng.integers(2**30, 2**31, size=4 * 4096).astype(np.int32)
coll = make_collective_reduce("SUM", mesh)
got = local_view(coll(shard_payload(x, mesh)), coll)
want = host_collective_oracle(x, 4, "SUM")
wide = x.astype(np.int64).reshape(4, -1).sum(0)
assert (wide > 2**31 - 1).all()
assert np.array_equal(got, want), (got[:4], want[:4])
print("wrapped", int(wide.max()), int(got[0]))
leave_distributed()
