"""Cross-rank collective reductions: the MPI_Reduce analog on the rank axis.

The counterpart of tpu_reductions/collectives/core.py. The reference
times `MPI_Reduce(sendbuf, recvbuf, count, dtype, op, 0, MPI_COMM_WORLD)`
(reduce.c:76,90): every rank holds N/commSize elements and the root
receives the elementwise op across ranks. The JAX package runs it as
`shard_map(psum/pmin/pmax)` over a device mesh; the port runs it over the
rank axis of parallel/mesh.py:

  per-rank sendbuf   ->  row r of a (k_local, L) tensor on this process's
                         device (`shard_payload`)
  psum/pmin/pmax     ->  the owned rows combined over axis 0, then
                         `dist.all_reduce` across processes (NCCL
                         between cards, gloo on the CPU)
  ppermute           ->  collectives/rings.ppermute: a gather along the
                         rank axis (a copy inside the device), one
                         batched send/receive a hop between processes
  recvbuf            ->  per-rank buffers: every constructor returns
                         (k_local, ...) tensors, one row per owned rank,
                         so an all-gather phase really runs and every
                         replica can be checked

The constructors return `Collective`s. `local_view_and_selection` gives what
the JAX function of the same name gives for the same mode: the whole
result for a replicated output or a single process, this process's
slices and their global positions otherwise.

Bandwidth accounting is the registry's (collectives/algorithms.py). On
one card the "wire" is the card's own memory: a row's GB/s is a
copy-and-combine rate inside HBM, and busbw is the registry's factor
applied to that time, not a link rate. With one process per card the
hops between processes cross NVLink (bench/collective_driver.py says
which).

No constructor writes into its input: the chain (ops/chain.py) folds into
its own copy, and the driver verifies the output of an earlier call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpu_reductions_torch.collectives.algorithms import (_halving_applies,
                                                         normalize_rooted)
from tpu_reductions_torch.collectives.rings import (axis_index,
                                                    naive_accumulate,
                                                    ppermute, ring_rs_ag)
from tpu_reductions_torch.ops.chain import ChainedReduce
from tpu_reductions_torch.ops.registry import get_op


@dataclasses.dataclass(frozen=True)
class Collective:
    """A built collective: `coll(*planes) -> out`, where out is a
    (k_local, ...) tensor, or a tuple of them for the pair paths.
    `replicated` says whether every rank holds the same result (all-reduce
    and reduce-to-root) or its own slice (reduce-scatter)."""

    fn: Callable
    mesh: object
    replicated: bool = True

    def __call__(self, *planes):
        return self.fn(*planes)


def _dist_op(method: str):
    import torch.distributed as dist
    return {"SUM": dist.ReduceOp.SUM, "MIN": dist.ReduceOp.MIN,
            "MAX": dist.ReduceOp.MAX}[method]


def reduce_ranks(x: torch.Tensor, method: str, mesh) -> torch.Tensor:
    """The elementwise op over every rank of the mesh: this process's
    rows combined over axis 0, then across processes, in the
    accumulation dtype, cast once at the end: int32 SUM wraps mod 2^32
    as the oracle does; bf16 SUM adds in float32 and rounds once, across
    processes too. Returns one (L,) tensor."""
    method = method.upper()
    red = get_op(method).reduce_dim(x, 0)
    if mesh.spans_processes:
        import torch.distributed as dist
        dist.all_reduce(red, op=_dist_op(method), group=mesh.group)
    return red.to(x.dtype)


def _replicate(red: torch.Tensor, mesh) -> torch.Tensor:
    """One copy of `red` for every owned rank: (k_local, L)."""
    return red.unsqueeze(0).expand(mesh.k_local, *red.shape).contiguous()


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """jax.lax.psum over the rank axis: every row holds the sum."""
    return _replicate(reduce_ranks(x, "SUM", mesh), mesh)


def pmin(x: torch.Tensor, mesh) -> torch.Tensor:
    """jax.lax.pmin over the rank axis."""
    return _replicate(reduce_ranks(x, "MIN", mesh), mesh)


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """jax.lax.pmax over the rank axis."""
    return _replicate(reduce_ranks(x, "MAX", mesh), mesh)


_COLLECTIVES = {"SUM": psum, "MIN": pmin, "MAX": pmax}


def _all_gather_rows(pieces: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's piece, in rank order: (k, c) from this process's
    (k_local, c), on its device. Each process of the mesh sends its rows
    padded to the largest share over the mesh's group (a subgroup where
    the mesh leaves processes out); a cached index puts the gathered rows
    in rank order, so a captured graph holds no host-to-device copy."""
    if not mesh.spans_processes:
        return pieces
    import torch.distributed as dist
    # the mesh's processes in the order of its group's ranks
    counts = [len(mesh.owned_by(p)) for p in mesh.members]
    pad = max(counts)
    mine = pieces.new_zeros((pad, *pieces.shape[1:]))
    mine[:pieces.shape[0]] = pieces
    got = [torch.empty_like(mine) for _ in counts]
    dist.all_gather(got, mine, group=mesh.group)

    def build():
        at = {r: j * pad + i for j, p in enumerate(mesh.members)
              for i, r in enumerate(mesh.owned_by(p))}
        # redlint: disable=RED020 -- k int64 row positions, made once per mesh
        return torch.tensor([at[r] for r in range(mesh.k)],
                            dtype=torch.long, device=pieces.device)
    return torch.cat(got).index_select(
        0, mesh.cached(("gather_rows", pad), build))


def replicas_agree(out: tuple, mesh) -> bool:
    """Whether every replica of a replicated output (a tuple of planes)
    holds rank 0's bits, compared on the device: this process's rows
    against its first, and across processes its first against rank 0's
    row, broadcast over the mesh's group as bytes; the verdict is then
    the group's (a MIN over its processes), so that every process of the
    mesh gives the same one."""
    same = all(torch.equal(o, o[:1].expand_as(o)) for o in out)
    if not mesh.spans_processes:
        return same
    import torch.distributed as dist

    from tpu_reductions_torch.collectives.rings import _bytes
    for o in out:
        head = o[0].contiguous()
        ref = head.clone()
        dist.broadcast(_bytes(ref), src=mesh.owners[0], group=mesh.group)
        same = same and torch.equal(head, ref)
    # redlint: disable=RED020 -- one int32, the replicas' verdict across the group
    flag = torch.tensor([int(same)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def mesh_spans_processes(mesh) -> bool:
    """True when other processes hold ranks of the mesh (the multi-host
    regime, reduce.c:32-34 across nodes)."""
    return mesh.spans_processes


def shard_payload(x_global, mesh) -> torch.Tensor:
    """Place a global (k*L,) payload on the rank axis: this process's
    (k_local, L) rows on its device, row i holding rank owned[i]'s
    contiguous L-element block (each MPI rank's sendbuf, reduce.c:43-57).
    Every process stages the same global payload (seeds derive from the
    global rank) and keeps its own rows."""
    x = torch.as_tensor(x_global).reshape(mesh.k, -1)
    if mesh.k_local != mesh.k:
        x = x[list(mesh.owned)]
    return x.to(mesh.device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (bfloat16, which numpy lacks, as float32)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def local_view(out, coll: Collective) -> np.ndarray:
    """local_view_and_selection without the selector."""
    return local_view_and_selection(out, coll)[0]


def local_view_and_selection(out, coll: Collective):
    """This process's view of a collective's result (an MPI rank reading
    its recvbuf), as the JAX function gives it for the same mode:

      view      the whole result, for a replicated output or a single
                process; else this process's slices concatenated in
                global-index order;
      selector  indexes the global result down to `view`: slice(None),
                or an integer index array, which need not be contiguous
                (an 'interleaved' mapping scatters one process's ranks
                across the global order).
    """
    mesh = coll.mesh
    if mesh.k_local == 0:
        raise RuntimeError(
            "mesh excludes this process: no addressable shards (the "
            "requested --devices count cut this process's devices out "
            "of the mesh; every participating process must own at "
            "least one mesh device)")
    if coll.replicated:
        return _host(out[0]), slice(None)
    view = _host(out.reshape(-1))
    if not mesh.spans_processes:
        return view, slice(None)
    c = out.shape[1]
    sel = np.concatenate([np.arange(r * c, (r + 1) * c)
                          for r in mesh.owned])
    return view, sel


def make_collective_reduce(method: str, mesh, rooted=False) -> Collective:
    """Build the collective: (k_local, L) rows -> reduced per-rank rows.

    rooted (collectives/algorithms.ROOTED_MODES; bools accepted):
      'none'    all-reduce; every rank holds the full reduced (L,).
      'scatter' reduce-scatter; rank r keeps slice r of the reduced
                array, (L/k,). SUM: the psum_scatter counterpart;
                MIN/MAX: the ppermute recursive-halving butterfly where
                `_halving_applies`; else reduce fully, then slice
                ('all_reduce_slice', which pays the all-reduce wire).
      'root'    reduce-to-root (MPI_Reduce recvbuf semantics): the
                scatter, then an all-gather of the pieces, so rank 0
                (and every rank) holds the full reduced array; the plain
                all-reduce where no scatter applies.

    `collective_algorithm(method, k, L, rooted)` names the path that
    runs for a per-rank length L."""
    method = method.upper()
    mode = normalize_rooted(rooted)
    op = get_op(method)
    k = mesh.k
    full_reduce = _COLLECTIVES[method]

    if mode == "none" or k == 1:
        return Collective(lambda x: full_reduce(x, mesh), mesh)

    def slice_fallback(x):
        # no scatter variant applies: reduce fully, keep each rank's
        # slice (full.shape // k elements, the tail dropped, as JAX does)
        full = reduce_ranks(x, method, mesh)
        piece = full.shape[0] // k
        return full[:k * piece].view(k, piece).index_select(0, axis_index(mesh))

    def bits(d: int) -> tuple:
        # each row's bit at butterfly distance d, and its complement
        def build():
            b = torch.div(axis_index(mesh), d, rounding_mode="floor") % 2
            return b, 1 - b
        return mesh.cached(("halving", d), build)

    def minmax_halving(x):
        # log2(k) butterfly rounds, each exchanging the half of the
        # working buffer the partner is responsible for and combining the
        # rest; rank r ends on slice r of the reduced vector
        buf = x
        size = x.shape[1]
        d = k // 2
        while d >= 1:
            size //= 2
            bit, other = bits(d)
            halves = buf.view(buf.shape[0], 2, size)
            keep = torch.gather(halves, 1, bit.view(-1, 1, 1).expand(
                -1, 1, size)).view(-1, size)
            send = torch.gather(halves, 1, other.view(-1, 1, 1).expand(
                -1, 1, size)).view(-1, size)
            recv = ppermute(send, [(i, i ^ d) for i in range(k)], mesh)
            buf = op.combine(keep, recv)
            d //= 2
        return buf

    def scatter_piece(x):
        # this rank's L/k slice of the reduced array, or None when no
        # scatter algorithm applies (the predicates of
        # collective_algorithm)
        if method == "SUM":
            if x.shape[1] % k == 0:
                red = reduce_ranks(x, method, mesh)
                return red.view(k, -1).index_select(0, axis_index(mesh))
            return None
        if _halving_applies(k, x.shape[1]):
            return minmax_halving(x)
        return None

    if mode == "scatter":
        def dispatch(x):
            piece = scatter_piece(x)
            return piece if piece is not None else slice_fallback(x)
        return Collective(dispatch, mesh, replicated=False)

    def dispatch_root(x):
        piece = scatter_piece(x)
        if piece is None:
            return full_reduce(x, mesh)    # all-reduce: root holds it all
        return _replicate(_all_gather_rows(piece, mesh).reshape(-1), mesh)
    return Collective(dispatch_root, mesh)


def make_chained_collective(method: str, mesh=None, rooted=False,
                            coll: Collective = None) -> ChainedReduce:
    """`chained(x, k) -> scalar`: k data-dependent collectives for slope
    timing, on ops/chain.ChainedReduce, so that on the card the k
    collectives are one CUDA graph a trip. Each step runs the collective,
    then folds element [0] of the first plane of rank 0's result into
    rank 0's element [0] with the op's own combine (the JAX chain's
    `x.at[0].set(...)`); only the process that holds rank 0 folds. `x`
    is one (k_local, L) plane or a tuple of planes (the pair paths).

    Pass `coll` to chain an already built collective (the one the caller
    verified); otherwise one is built from (method, mesh, rooted)."""
    op = get_op(method)
    if coll is None:
        coll = make_collective_reduce(method, mesh, rooted=rooted)

    def core(*planes):
        out = coll(*planes)
        if isinstance(out, tuple):
            return tuple(o[0, 0].clone() for o in out)
        # a copy: the fold writes into the input, which a k = 1
        # collective may hand back as its output
        return out[0, 0].clone()

    return ChainedReduce(core, op, fold=0 in coll.mesh.owned)


def make_chained_pair_collective(method: str,
                                 coll: Collective) -> ChainedReduce:
    """The pair-path spelling of make_chained_collective: `chained((hi,
    lo), k) -> scalar` for the two-plane collectives (dd SUM, key
    MIN/MAX)."""
    return make_chained_collective(method, coll=coll)


def make_dd_sum_all_reduce(mesh) -> Collective:
    """Elementwise f64-fidelity SUM across ranks carried as (hi, lo) f32
    pairs, with compensated (double-double) accumulation at every hop
    (ops/dd_reduce.dd_add). A plain sum of the planes would round at f32,
    missing the f64 threshold of 1e-12 (reduction.cpp:764).

    When the per-rank length divides by k: the ring (rings.ring_rs_ag),
    a reduce-scatter phase of k-1 hops of L/k chunks, each arrival
    dd-added into the matching local chunk, then an all-gather phase of
    k-1 hops; each chunk is reduced once and broadcast, so replicas are
    bit-identical, and their bits are the JAX ring's. Else the naive
    accumulate-around-the-ring (k-1 full-L hops)."""
    from tpu_reductions_torch.ops.dd_reduce import dd_add

    k = mesh.k

    def local(hi, lo):
        if k > 1 and hi.shape[1] % k == 0:
            return ring_rs_ag(
                mesh, k, (hi.clone(), lo.clone()),
                to_wire=lambda ch: ch,
                absorb=lambda tgt, rx: dd_add(tgt[0], tgt[1], rx[0], rx[1]),
                from_wire=lambda w: w)
        return naive_accumulate(
            mesh, k, (hi, lo),
            combine=lambda acc, rx: dd_add(acc[0], acc[1], rx[0], rx[1]))

    return Collective(local, mesh)


def make_key_minmax_all_reduce(method: str, mesh) -> Collective:
    """Exact f64 MIN/MAX across ranks on order-preserving int32 key pairs
    (dd_reduce.host_key_encode), in two phases:

      phase 1: m_hi = pmin/pmax(k_hi)
      phase 2: m_lo = pmin/pmax(k_lo where k_hi == m_hi, else sentinel)

    Ranks not tied at the high word are masked to the sentinel (the op's
    identity), so (m_hi, m_lo) is the exact lexicographic winner."""
    method = method.upper()
    if method not in ("MIN", "MAX"):
        raise ValueError(f"key-pair collectives are MIN/MAX, got {method}")
    sentinel = 2**31 - 1 if method == "MIN" else -2**31

    def local(k_hi, k_lo):
        m_hi = reduce_ranks(k_hi, method, mesh)
        cand = k_lo.masked_fill(k_hi != m_hi, sentinel)
        m_lo = reduce_ranks(cand, method, mesh)
        return _replicate(m_hi, mesh), _replicate(m_lo, mesh)

    return Collective(local, mesh)


def host_collective_oracle(x_global, k: int, method: str) -> np.ndarray:
    """Elementwise host oracle: reshape (k, L) and combine across ranks
    (the check reduce.c never had). int32 SUM wraps mod 2^32 as the
    device does; bfloat16 is combined in float32."""
    op = get_op(method)
    if isinstance(x_global, torch.Tensor):
        x_global = (x_global.float() if x_global.dtype == torch.bfloat16
                    else x_global).numpy()
    blocks = np.asarray(x_global).reshape(k, -1)
    if method.upper() == "SUM" and blocks.dtype == np.int32:
        return blocks.astype(np.int64).sum(axis=0).astype(np.int32)
    return op.np_reduce(blocks, axis=0)
