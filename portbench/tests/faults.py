"""Faults planted in the timed path, for the tests that see `correct` come
out false. Each is an entry of the form the drivers take
("portbench.tests.faults:<name>"), wrapping the program's own."""

from __future__ import annotations

import torch

from portbench.drivers.collective import port_entry as collective_entry
from portbench.drivers.single_device import port_entry as single_entry


def sdk_stale(method, n, dtype, config, device):
    """A call that returns its first answer again: the state unchanged."""
    stage_fn, reduce_fn = single_entry(method, n, dtype, config, device)
    first = []

    def stale(x2d):
        if not first:
            first.append(reduce_fn(x2d))
        return first[0]
    return stage_fn, stale


def sdk_half(method, n, dtype, config, device):
    """Half of the payload left out."""
    stage_fn, reduce_fn = single_entry(method, n, dtype, config, device)
    return stage_fn, lambda x2d: reduce_fn(x2d[: x2d.shape[0] // 2])


def sdk_altered(method, n, dtype, config, device):
    """An answer in a hundred altered where it is produced."""
    stage_fn, reduce_fn = single_entry(method, n, dtype, config, device)
    calls = [0]

    def altered(x2d):
        out = reduce_fn(x2d)
        calls[0] += 1
        return out + 1 if calls[0] % 100 == 0 else out
    return stage_fn, altered


def mpi_no_exchange(method, mesh, ctx):
    """The exchange between processes left out: each combines its own
    ranks and calls that the answer."""
    from tpu_reductions_torch.ops.registry import get_op
    op = get_op(method)
    return lambda x: op.reduce_dim(x, 0).to(x.dtype).expand(x.shape[0], -1)


def mpi_unchanged(method, mesh, ctx):
    """The collective returns its input: the state unchanged."""
    return lambda x: x


def mpi_half(method, mesh, ctx):
    """Half of the ranks left out: each process's second rank replaced by
    the op's identity before the program's collective."""
    from tpu_reductions_torch.ops.registry import get_op
    coll = collective_entry(method, mesh, ctx)
    ident = get_op(method).identity(
        torch.int32 if ctx.dtype == "int32" else torch.float64)

    def half(x):
        y = x.clone()
        y[1:] = ident
        return coll(y)
    return half


def mpi_altered(method, mesh, ctx):
    """Every answer altered where it is produced: its first element."""
    coll = collective_entry(method, mesh, ctx)

    def altered(x):
        out = coll(x).clone()
        out[:, 0] += 1
        return out
    return altered
