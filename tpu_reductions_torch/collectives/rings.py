"""Ring machinery of the collective suite: the one place hops are built.

The counterpart of tpu_reductions/collectives/rings.py (`ring_perm`,
`grid_factors`, `_chunk`/`_put`, `_rs_phase`, `_ag_phase`,
`ring_rs_ag_stateful`, `ring_rs_ag`, `naive_accumulate`,
`ring_all_to_all`, `make_topology_all_reduce`), over the port's rank axis
(parallel/mesh.py): a buffer is a `(k_local, L)` tensor whose rows are
this process's ranks.

- `ppermute(x, perm, mesh)` is `jax.lax.ppermute`: row `dst` of the
  result is row `src` of `x` for each `(src, dst)` pair, zeros where no
  pair names the row. Within a process it is one `index_select` along the
  rank axis with an index tensor made once per permutation (a copy inside
  the device); rows whose source lies in another process arrive by one
  `dist.batch_isend_irecv` a hop (NCCL between cards, over NVLink; gloo
  on the CPU), its sends and receives in the order of the permutation's
  pairs, which both ends derive from the permutation alone.
- `_chunk`/`_put` are vectorised: every row gathers (or writes) its own
  chunk index, which differs by rank, in one gather (or scatter) launch.
- Every combine keeps the JAX order: the target chunk first, the arrival
  second (`absorb(_chunk(bs, tgt, c), rx)`); the dd ring's bits depend
  on it.

`_put` writes in place: the ring constructors run on their own copies of the
caller's buffers (collectives/core.py). Every index tensor is made the
first time a (mesh, geometry) needs it, when the constructor first runs,
outside any CUDA graph capture.
"""

from __future__ import annotations

from typing import Optional

import torch


def ring_perm(k: int, sigma: int = 1) -> list:
    """The ppermute source -> dest pairs of a k-rank ring in direction
    sigma (+1 forwards, -1 backwards)."""
    return [(i, (i + sigma) % k) for i in range(k)]


def grid_factors(k: int) -> tuple:
    """(a, b) with a*b == k and a the largest divisor <= sqrt(k): the
    sub-ring sizes of the 2D-torus decomposition (a = 1 for primes)."""
    a = 1
    d = 1
    while d * d <= k:
        if k % d == 0:
            a = d
        d += 1
    return a, k // a


class _Hop:
    """One permutation's plan on a mesh: the rows this process fills from
    its own rows, and the rows it sends to and receives from others.

    The cross-process rows go as one `batch_isend_irecv` list: NCCL
    matches sends and receives by order between each pair of processes
    (it ignores tags) and creates no pair communicator mid-ring, so every
    process lists its operations in the order of the pairs `(s, d)` in
    `perm`, the order the other end lists them in too. A row travels as
    its bytes (NCCL takes no int16), into a buffer on the device."""

    def __init__(self, perm: tuple, mesh) -> None:
        src_of = {d: s for s, d in perm}
        self.mesh = mesh
        local_dst, local_src = [], []
        for i, r in enumerate(mesh.owned):
            s = src_of.get(r)
            if s is not None and mesh.owners[s] == mesh.process:
                local_dst.append(i)
                local_src.append(mesh.row(s))
        # (is_send, row, peer process, tag): the cross-process pairs, in
        # perm's order
        self.wire = []
        for s, d in perm:
            ps, pd = mesh.owners[s], mesh.owners[d]
            if ps == pd:
                continue
            if ps == mesh.process:
                self.wire.append((True, mesh.row(s), pd, d))
            elif pd == mesh.process:
                self.wire.append((False, mesh.row(d), ps, d))
        dev = mesh.device
        # every row filled locally, in order: one index_select
        self.full = local_dst == list(range(mesh.k_local))
        # redlint: disable=RED020 -- a hop's source rows, one int64 per local rank
        self.src = torch.tensor(local_src, dtype=torch.long, device=dev)
        # redlint: disable=RED020 -- a hop's destination rows, one int64 per local rank
        self.dst = torch.tensor(local_dst, dtype=torch.long, device=dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.full:
            return x.index_select(0, self.src)
        # contiguous, so that a received row's bytes land in `out` itself
        out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        if self.dst.numel():
            out.index_copy_(0, self.dst, x.index_select(0, self.src))
        if self.wire:
            import torch.distributed as dist
            group = self.mesh.group
            ops = [dist.P2POp(dist.isend if send else dist.irecv,
                              _bytes(x[row] if send else out[row]), peer,
                              group=group, tag=tag)
                   for send, row, peer, tag in self.wire]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


def _bytes(row: torch.Tensor) -> torch.Tensor:
    """A contiguous row's bytes, as one flat uint8 view."""
    return row.contiguous().reshape(-1).view(torch.uint8)


def hop_plan(perm, mesh) -> _Hop:
    """The mesh's cached plan of permutation `perm`."""
    key = ("hop", tuple(map(tuple, perm)))
    return mesh.cached(key, lambda: _Hop(key[1], mesh))


def ppermute(x: torch.Tensor, perm, mesh) -> torch.Tensor:
    """jax.lax.ppermute over the rank axis (module docstring)."""
    return hop_plan(perm, mesh)(x)


def axis_index(mesh) -> torch.Tensor:
    """This process's ranks, on its device: the rank of every row."""
    return mesh.index


def ring_steps(mesh, m: int, sigma: int = 1,
               stride: int = 1) -> torch.Tensor:
    """(m, k_local) chunk indices of an m-rank ring: row s holds
    (pos - sigma*s) % m for every row, where a rank r's position in its
    ring is pos = (r // stride) % m (stride 1: the ring over the whole
    rank axis, or a 2D torus's row ring; stride b: the torus's column
    ring). The RS phase sends chunk [s] and matches chunk [s + 1] at hop
    s; the AG phase stores chunk [s] at hop s."""
    def build():
        s = torch.arange(m, device=mesh.device).unsqueeze(1)
        pos = torch.remainder(torch.div(mesh.index, stride,
                                        rounding_mode="floor"), m)
        return torch.remainder(pos.unsqueeze(0) - sigma * s, m)
    return mesh.cached(("ring_steps", m, sigma, stride), build)


def _index(idx: torch.Tensor, c: int) -> torch.Tensor:
    return idx.view(-1, 1, 1).expand(-1, 1, c)


def _chunk(bs: tuple, idx: torch.Tensor, c: int) -> tuple:
    """Row i's chunk idx[i] of each buffer: (k_local, c) tensors."""
    return tuple(torch.gather(b.view(b.shape[0], -1, c), 1,
                              _index(idx, c)).view(b.shape[0], c)
                 for b in bs)


def _put(bs: tuple, pieces: tuple, idx: torch.Tensor, c: int) -> tuple:
    """Write row i's piece into chunk idx[i] of each buffer, in place."""
    for b, pc in zip(bs, pieces):
        b.view(b.shape[0], -1, c).scatter_(1, _index(idx, c),
                                           pc.view(b.shape[0], 1, c))
    return bs


def _rs_phase(mesh, m: int, perm: list, steps: torch.Tensor, bufs: tuple,
              to_wire, absorb, state):
    """Reduce-scatter half: m-1 hops around the ring named by `perm`;
    `steps` are ring_steps' chunk indices of its direction sigma. After
    the last hop the rank at position p owns the fully reduced chunk
    (p + sigma) % m = steps[m - 1]. Returns (bufs, state, own_idx)."""
    c = bufs[0].shape[1] // m
    for s in range(m - 1):
        send, tgt = steps[s], steps[s + 1]
        wire, state = to_wire(_chunk(bufs, send, c), state)
        rx = tuple(ppermute(w, perm, mesh) for w in wire)
        bufs = _put(bufs, absorb(_chunk(bufs, tgt, c), rx), tgt, c)
    return bufs, state, steps[m - 1]


def _ag_phase(mesh, m: int, perm: list, steps: torch.Tensor, bufs: tuple,
              from_wire, w0: tuple) -> tuple:
    """All-gather half: from the owned chunk's wire form `w0`, m-1 hops
    forwarding what arrived, so that every rank decodes the one encoding
    of each chunk (bit-identical replicas)."""
    c = bufs[0].shape[1] // m
    w = w0
    for s in range(m - 1):
        w = tuple(ppermute(x, perm, mesh) for x in w)
        bufs = _put(bufs, from_wire(w), steps[s], c)
    return bufs


def ring_rs_ag_stateful(mesh, k: int, bufs: tuple, to_wire, absorb,
                        from_wire, state, *, perm: Optional[list] = None,
                        sigma: int = 1, stride: int = 1) -> tuple:
    """The ring all-reduce (RS phase, the owned chunk re-encoded, AG
    phase) with wire state threaded through every encode:

      to_wire(chunks, state) -> (wire, state')   what crosses a hop
      absorb(tgt, wire)      -> chunk tuple      combine an arrival
      from_wire(wire)        -> chunk tuple      store in the AG phase

    bufs: (k_local, L) buffers sharing one chunking, L divisible by k
    (callers gate on it), written in place. `perm` and `stride` name a
    sub-ring of k ranks (the JAX `perm` and `pos`; ring_steps). Returns
    (bufs, state)."""
    if perm is None:
        perm = ring_perm(k, sigma)
    steps = ring_steps(mesh, k, sigma, stride)
    c = bufs[0].shape[1] // k
    bufs, state, own = _rs_phase(mesh, k, perm, steps, bufs, to_wire,
                                 absorb, state)
    w0, state = to_wire(_chunk(bufs, own, c), state)
    bufs = _put(bufs, from_wire(w0), own, c)
    bufs = _ag_phase(mesh, k, perm, steps, bufs, from_wire, w0)
    return bufs, state


def ring_rs_ag(mesh, k: int, bufs: tuple, to_wire, absorb,
               from_wire) -> tuple:
    """Stateless spelling of ring_rs_ag_stateful (the dd pair ring):
    to_wire takes only the chunk tuple."""
    bufs, _ = ring_rs_ag_stateful(
        mesh, k, bufs, to_wire=lambda ch, st: (to_wire(ch), st),
        absorb=absorb, from_wire=from_wire, state=None)
    return bufs


def naive_accumulate(mesh, k: int, bufs: tuple, combine,
                     sigma: int = 1) -> tuple:
    """Accumulate around the ring: k-1 hops of the full per-rank buffer
    (wire factor k-1, the only fit for lengths that do not divide by k).
    combine(acc_tuple, rx_tuple) -> tuple. Leaves `bufs` as they are."""
    perm = ring_perm(k, sigma)
    acc, cur = bufs, bufs
    for _ in range(k - 1):
        cur = tuple(ppermute(b, perm, mesh) for b in cur)
        acc = combine(acc, cur)
    return acc


def _hop_indices(mesh, k: int, t: int) -> tuple:
    """Hop t of ring_all_to_all: each row's piece to send, (r + t) % k,
    and the sender of what it receives, (r - t) % k."""
    def build():
        return (torch.remainder(mesh.index + t, k),
                torch.remainder(mesh.index - t, k))
    return mesh.cached(("all_to_all", k, t), build)


def _row_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row i's entry idx[i] along axis 1 of x: (k_local, *rest)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, idx]


def ring_all_to_all(mesh, k: int, x: torch.Tensor, *, split_axis: int,
                    concat_axis: int, to_wire=None,
                    from_wire=None) -> torch.Tensor:
    """The redistribution all-to-all on the ring (the collective-permute
    step of reshard): each rank's block is split into k pieces along
    `split_axis`; after k-1 rotation hops every rank holds the pieces
    matching its index along `split_axis`, concatenated along
    `concat_axis` in sender order. An array sharded on the concat dim
    becomes the same array sharded on the split dim, each rank sending
    k-1 pieces of 1/k^2 of the global payload.

    x is (k_local, *block): a rank's block is its row, and the axes name
    the block's dims. `to_wire(piece) -> tuple` / `from_wire(tuple) ->
    piece` make the hop payload pluggable (the quantized wire); the
    rank's own piece never crosses a hop and is stored exactly. Hop t is
    the rotation by t: sender s ships the piece for rank (s + t) % k
    straight to it, so every piece crosses exactly once."""
    if k == 1:
        return x
    block = x.shape[1:]
    # (k_local, k, *piece): piece j of each row
    pieces = x.unflatten(1 + split_axis, (k, block[split_axis] // k)
                         ).movedim(1 + split_axis, 1).contiguous()
    # (k_local, k, *piece): what arrived from each sender, in sender order
    got = torch.empty_like(pieces)
    rows = torch.arange(x.shape[0], device=x.device)
    got[rows, mesh.index] = pieces[rows, mesh.index]
    for t in range(1, k):
        send_idx, src_idx = _hop_indices(mesh, k, t)
        send = _row_select(pieces, send_idx)
        wire = to_wire(send) if to_wire is not None else (send,)
        perm = [(i, (i + t) % k) for i in range(k)]
        rx = tuple(ppermute(w, perm, mesh) for w in wire)
        got[rows, src_idx] = from_wire(rx) if from_wire is not None \
            else rx[0]
    out = list(pieces.shape[2:])
    out[concat_axis] *= k
    return got.movedim(1, 1 + concat_axis).reshape(x.shape[0], *out)


def make_topology_all_reduce(method: str, mesh, topology: str = "ring"):
    """The explicit-topology elementwise all-reduce for `method`
    (SUM/MIN/MAX), exact at every combine:

      ring      RS+AG single ring         2(k-1)/k wire, 2(k-1) hops
      bidir     both ring directions over disjoint halves, each hop
                moving L/2k a direction
      torus2d   row-ring RS, column all-reduce of the owned chunk,
                row-ring AG over an a x b grid (grid_factors), in
                2(a-1)+2(b-1) hops
      naive     accumulate-around-the-ring, k-1 full-L hops

    A topology whose divisibility does not hold
    (algorithms.topology_supported) falls back to the ring, else naive,
    as the selector reports. Returns a Collective over (k_local, L) rows
    whose every row holds the reduced (L,)."""
    from tpu_reductions_torch.collectives.algorithms import \
        topology_supported
    from tpu_reductions_torch.collectives.core import Collective
    from tpu_reductions_torch.ops.registry import get_op

    op = get_op(method)
    k = mesh.k

    def ident(ch):
        return ch

    def stateless(ch, st):
        return ch, st

    def absorb(tgt, rx):
        return tuple(op.combine(t, r) for t, r in zip(tgt, rx))

    def local(x):
        topo = topology
        if not topology_supported(topo, k, x.shape[1]):
            topo = ("ring" if topology_supported("ring", k, x.shape[1])
                    else "naive")
        if k == 1:
            return x.clone()
        if topo == "naive":
            (x,) = naive_accumulate(mesh, k, (x,), absorb)
            return x
        if topo == "bidir":
            half = x.shape[1] // 2
            (lo,) = ring_rs_ag(mesh, k, (x[:, :half].contiguous(),),
                               ident, absorb, ident)
            (hi,), _ = ring_rs_ag_stateful(
                mesh, k, (x[:, half:].contiguous(),), stateless, absorb,
                ident, None, sigma=-1)
            return torch.cat([lo, hi], dim=1)
        if topo == "torus2d":
            a, b = grid_factors(k)
            row_perm = [(q, (q // b) * b + ((q % b) + 1) % b)
                        for q in range(k)]
            col_perm = [(q, (((q // b) + 1) % a) * b + q % b)
                        for q in range(k)]
            c = x.shape[1] // b
            steps = ring_steps(mesh, b)
            # row reduce-scatter: rank (i, j) owns row-reduced chunk
            # (j + 1) % b
            (x,), _, own = _rs_phase(mesh, b, row_perm, steps,
                                     (x.clone(),), stateless, absorb,
                                     None)
            (piece,) = _chunk((x,), own, c)
            # column all-reduce of the owned chunk (every rank of a
            # column owns the same chunk index)
            (piece,), _ = ring_rs_ag_stateful(
                mesh, a, (piece,), stateless, absorb, ident, None,
                perm=col_perm, stride=b)
            (x,) = _put((x,), (piece,), own, c)
            # row all-gather circulates the fully reduced chunks
            (x,) = _ag_phase(mesh, b, row_perm, steps, (x,), ident,
                             (piece,))
            return x
        (x,) = ring_rs_ag(mesh, k, (x.clone(),), ident, absorb, ident)
        return x

    return Collective(local, mesh)
