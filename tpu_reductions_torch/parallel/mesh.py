"""The rank mesh: k ranks as the rows of one tensor per process.

The counterpart of tpu_reductions/parallel/mesh.py. The JAX package
places one rank on each device of a `jax.sharding.Mesh` and runs its rank
ladder on virtual CPU devices, up to 1024. torch has no virtual devices,
so the port's mesh is a rank axis inside each process: this process's
ranks are the rows of one `(k_local, L)` tensor on its device, and a hop
between two of them is a copy inside that device (collectives/rings.py).
The same code runs on the CPU and on the card.

Across processes (`initialize_distributed`) the rank axis is split, the
MPI model of reduce.c: a k-rank mesh lies on the processes in contiguous,
rank-ordered blocks (device.rank_blocks: process p holds block p; with
k < P the first k processes hold one rank each), and a hop between ranks
of two processes is a send and a receive between them. On the card every
process drives a card of its own (device.own_card: `cuda:<local rank>`)
and the processes join over NCCL, so such a hop crosses NVLink; on the
CPU they join over gloo. The join sets the process's card as its current
device. A mesh that leaves processes out runs its collectives in a
subgroup of the processes that hold its ranks (`RankMesh.group`), made
once per member set by every process of the group; a process outside it
holds no rank and enters none of the mesh's collectives.

In one process the same blocks can lie on several cards
(`peer_meshes`, the drain's reshard across the host's cards): one host
thread a card, each with a RankMesh of its own whose "process" is its
card, joined by a parallel/peer.PeerGroup in place of a process group.
`comm(mesh)` is the one place the rank axis's calls across processes or
cards choose between the two.

Reference mapping, as in the JAX package:
- MPI_Init / Comm_size (reduce.c:32-34): `device_inventory`, `build_mesh`;
- the Blue Gene VN/CO modes (ccni_vn.sh:6): `mode`; without chip
  topology, CO keeps every other rank, the JAX package's CPU simulation;
- BGLMPI_MAPPING (ccni_vn.sh:3): `mapping`, a permutation of which
  process places each rank;
- mpirun across nodes: `initialize_distributed`.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import math
import socket
from typing import Optional, Sequence

import torch

from tpu_reductions_torch import device as device_mod

DEFAULT_AXIS = "ranks"

MAPPINGS = ("default", "reversed", "interleaved")

# how long a process waits on a peer in one collective before it raises:
# a peer that died leaves the others waiting this long, not forever
DIST_TIMEOUT_S = 300

# the subgroups of the joined process group, by member tuple: made once
# each (every process of the group makes them, in the same order) and
# dropped with the group (leave_distributed)
_SUBGROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Place:
    """One virtual device: the process that holds it, and its index among
    that process's rows."""

    process: int
    local: int


def _world() -> tuple:
    """(this process's index, the number of processes)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device(platform: str) -> torch.device:
    """This process's device: the CPU, or on the card the one it drives
    (its own card when other processes joined)."""
    me, world = _world()
    return device_mod.resolve(platform, process_id=me, num_processes=world)


def device_inventory(platform: str = "gpu",
                     local_ranks: Optional[int] = None) -> dict:
    """What the mesh can place (the deviceQuery analog, and the
    MPI_Comm_size source): `num_devices` is the ranks every process
    provides together, `local_ranks` each (default 1: the one device a
    process drives, the CPU or its card). On the card `cards` lists every
    process's card, `host/cuda:i`, by process."""
    dev = _device(platform)
    me, world = _world()
    local = 1 if local_ranks is None else local_ranks
    inv = {
        "platform": platform,
        "num_devices": local * world,
        "num_processes": world,
        "process_index": me,
        "device_kinds": [device_mod.name(dev)],
    }
    if dev.type == "cuda":
        mine = (f"{socket.gethostname()}/{dev}", device_mod.name(dev))
        got = [mine]
        if world > 1:
            import torch.distributed as dist
            got = [None] * world
            # redlint: disable=RED016 -- the inventory's card names, once: metadata of the mesh, not a hop of the rank axis
            dist.all_gather_object(got, mine)
        inv["cards"] = [where for where, _ in got]
        inv["device_kinds"] = sorted({kind for _, kind in got})
    return inv


def _order_devices(devs: list, mapping: str) -> list:
    """Permute rank placement, the BGLMPI_MAPPING analog: which process
    holds which rank."""
    if mapping == "default":
        return devs
    if mapping == "reversed":
        return devs[::-1]
    if mapping == "interleaved":
        return devs[0::2] + devs[1::2]
    raise ValueError(f"unknown mapping {mapping!r}; one of {MAPPINGS}")


def coarsen_to_chips(devs: Sequence) -> list:
    """CO mode: one rank per chip. Virtual devices have no chip topology,
    so, as the JAX package's CPU branch does, CO keeps every other
    device: a simulation of the VN -> CO halving, not a granularity."""
    return list(devs[0::2]) if len(devs) > 1 else list(devs)


@dataclasses.dataclass
class RankMesh:
    """The mesh of one collective run, seen from this process.

    `devices` holds the mesh's virtual devices in mesh order (row-major
    over `mesh_shape`); rank r is the index along the first axis. `owned`
    are the ranks this process holds, ascending: the rows of its
    `(k_local, L)` tensors, in that order. `members` are the processes
    that hold ranks, ascending (the ranks of `group`, the subgroup the
    mesh's collectives run in); `num_processes` is the whole group's."""

    k: int
    axis_names: tuple
    mesh_shape: tuple
    devices: tuple
    process: int
    num_processes: int
    device: torch.device
    group: object = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        per_rank = len(self.devices) // self.k
        self.owners = tuple(self.devices[r * per_rank].process
                            for r in range(self.k))
        self.owned = tuple(r for r in range(self.k)
                           if self.owners[r] == self.process)
        self.members = tuple(sorted(set(self.owners)))
        self._row = {r: i for i, r in enumerate(self.owned)}
        # this process's ranks, on its device: axis_index's counterpart
        # redlint: disable=RED015 -- this process's rank indices, k int64 entries
        self.index = torch.tensor(self.owned, dtype=torch.long,
                                  device=self.device)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.mesh_shape))

    @property
    def k_local(self) -> int:
        return len(self.owned)

    @property
    def member(self) -> bool:
        """Whether this process holds a rank of the mesh (and so enters
        its collectives)."""
        return bool(self.owned)

    @property
    def spans_processes(self) -> bool:
        """Whether another process holds ranks of this mesh."""
        return any(p != self.process for p in self.owners)

    def row(self, rank: int) -> int:
        """The row of an owned rank in this process's tensors."""
        return self._row[rank]

    def owned_by(self, process: int) -> tuple:
        return tuple(r for r in range(self.k) if self.owners[r] == process)

    def cached(self, key, build):
        """`build()` once per key: the index tensors and hop plans of a
        collective, made when it first runs, so that a captured CUDA graph
        holds no host-to-device copy."""
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]


def build_mesh(num_devices: Optional[int] = None,
               mesh_shape: Optional[Sequence[int]] = None,
               axis_names: Optional[Sequence[str]] = None,
               mapping: str = "default",
               mode: str = "vn", *,
               platform: str = "gpu",
               local_ranks: Optional[int] = None,
               device: Optional[torch.device] = None) -> RankMesh:
    """Build the reduction mesh.

    In one process, the process provides `local_ranks` virtual devices
    (default 1: the one device it drives, the CPU or its own card; the
    collective CLI provisions --devices of them, twice that under
    mode=co, as the JAX CLI provisions virtual CPU devices), all on its
    device. Across processes a `num_devices`-rank mesh (twice that under
    mode=co) is placed in contiguous blocks (`placement`); without
    `num_devices` each process provides `local_ranks`. `num_devices` is
    the rank count (defaults to all after `mode` filtering);
    `mesh_shape`/`axis_names` allow a multi-axis mesh whose first axis is
    the rank axis. A mesh that leaves processes out gets the subgroup of
    the processes that hold its ranks (`subgroup`): every process of the
    group must build it, members or not. The refusals keep the JAX
    package's words."""
    me, world = _world()
    devs = placement(num_devices, world, mode, local_ranks)
    if mode == "co":
        devs = coarsen_to_chips(devs)
    elif mode != "vn":
        raise ValueError("mode must be 'vn' or 'co'")
    devs = _order_devices(devs, mapping)
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(f"requested {num_devices} devices, "
                             f"only {len(devs)} available in mode={mode!r}")
        devs = devs[:num_devices]
    if mesh_shape is None:
        mesh_shape = (len(devs),)
        axis_names = tuple(axis_names or (DEFAULT_AXIS,))
    else:
        mesh_shape = tuple(mesh_shape)
        if math.prod(mesh_shape) != len(devs):
            raise ValueError(f"mesh_shape {mesh_shape} != {len(devs)} devices")
        if axis_names is None:
            axis_names = ((DEFAULT_AXIS,) if len(mesh_shape) == 1
                          else tuple(f"ax{i}"
                                     for i in range(len(mesh_shape))))
        axis_names = tuple(axis_names)
        if len(axis_names) != len(mesh_shape):
            raise ValueError(f"{len(axis_names)} axis names for "
                             f"{len(mesh_shape)}-d mesh")
    if device is None:
        device = _device(platform)
    mesh = RankMesh(k=mesh_shape[0], axis_names=axis_names,
                    mesh_shape=mesh_shape, devices=tuple(devs), process=me,
                    num_processes=world, device=device)
    if world > 1:
        mesh.group = subgroup(mesh.members, device)
    return mesh


def placement(num_devices: Optional[int], world: int, mode: str = "vn",
              local_ranks: Optional[int] = None) -> list:
    """The virtual devices a mesh draws from, before `mode` and `mapping`:
    in one process (or without `num_devices`) `local_ranks` (default 1)
    per process; across processes `num_devices` ranks, twice that under
    mode='co', in device.rank_blocks' contiguous blocks over the
    processes (process p holds block p; with fewer ranks than processes
    the first ones hold one each)."""
    if world > 1 and num_devices is not None:
        want = num_devices * (2 if mode == "co" else 1)
        if want < 1:
            raise ValueError(f"requested {num_devices} devices")
        return [Place(p, i) for p, block in
                enumerate(device_mod.rank_blocks(want, world))
                for i in range(len(block))]
    local = 1 if local_ranks is None else local_ranks
    return [Place(p, i) for p in range(world) for i in range(local)]


def subgroup(members: tuple, device: torch.device):
    """The process group of a mesh whose ranks lie on the processes
    `members`: the whole group when it holds them all, else its subgroup
    of those processes, made once per member tuple. Every process of the
    group calls this in the same order (torch.distributed.new_group is a
    collective of the whole group; NCCL splits its communicator there,
    the processes outside taking no part of the new one); the members
    then warm the subgroup with one all-reduce, so that its first hop
    finds its communicator made. Returns torch's non-member placeholder
    to a process outside."""
    import torch.distributed as dist
    if len(members) == dist.get_world_size():
        return dist.group.WORLD
    if members not in _SUBGROUPS:
        group = dist.new_group(ranks=list(members))
        if dist.get_rank() in members:
            # redlint: disable=RED016 -- the subgroup's warm-up, one element that makes its communicator, not a hop of the rank axis
            dist.all_reduce(torch.zeros(1, device=device), group=group)
        _SUBGROUPS[members] = group
    return _SUBGROUPS[members]


def peer_meshes(k: int, cards) -> list:
    """A k-rank mesh on C' = min(k, C) of `cards` in one process: the
    ranks in device.rank_blocks' contiguous blocks, card c's block the
    rows of its own tensors, one RankMesh a card, as its host thread sees
    the mesh (`process` the card's index, `num_processes` C', `device`
    the card), all sharing one parallel/peer.PeerGroup as their `group`.
    C' = 1 is the one-tensor mesh on that card. No reference analog: the
    JAX drain's mesh spans the host's chips in one process
    (tpu_reductions/reshard/primitives.py:144-150)."""
    from tpu_reductions_torch.parallel.peer import PeerGroup
    blocks = device_mod.rank_blocks(k, len(cards))
    devs = tuple(Place(c, i) for c, block in enumerate(blocks)
                 for i in range(len(block)))
    group = PeerGroup(len(blocks)) if len(blocks) > 1 else None
    return [RankMesh(k=k, axis_names=(DEFAULT_AXIS,), mesh_shape=(k,),
                     devices=devs, process=c, num_processes=len(blocks),
                     device=torch.device(cards[c]), group=group)
            for c in range(len(blocks))]


class _ProcessComm:
    """The collectives of a process group, as torch.distributed runs
    them (NCCL between cards, gloo on the CPU); `comm`'s other kind is
    parallel/peer.PeerMember, with the same calls."""

    def __init__(self, group) -> None:
        self.group = group

    def all_reduce(self, t: torch.Tensor, method: str) -> None:
        import torch.distributed as dist
        op = {"SUM": dist.ReduceOp.SUM, "MIN": dist.ReduceOp.MIN,
              "MAX": dist.ReduceOp.MAX}[method]
        # redlint: disable=RED016 -- the process group's side of comm(), the one dispatch point of the collectives' and the reshard primitives' calls
        dist.all_reduce(t, op=op, group=self.group)

    def all_gather(self, got, mine: torch.Tensor) -> None:
        import torch.distributed as dist
        # redlint: disable=RED016 -- the process group's side of comm(), the one dispatch point of the collectives' and the reshard primitives' calls
        dist.all_gather(got, mine, group=self.group)

    def exchange(self, wire) -> None:
        """(is_send, tensor, peer process, tag) in the order both ends
        list them: one batch_isend_irecv, waited."""
        import torch.distributed as dist
        ops = [dist.P2POp(dist.isend if send else dist.irecv, t, peer,
                          group=self.group, tag=tag)
               for send, t, peer, tag in wire]
        # redlint: disable=RED016 -- the process group's side of comm(), the one dispatch point of the collectives' and the reshard primitives' calls
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def broadcast(self, t: torch.Tensor, src: int) -> None:
        import torch.distributed as dist
        # redlint: disable=RED016 -- the process group's side of comm(), the one dispatch point of the collectives' and the reshard primitives' calls
        dist.broadcast(t, src=src, group=self.group)

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)


def comm(mesh):
    """The collectives of the mesh's group, for a mesh that spans
    processes (or cards): its peer group's, seen from this thread's card
    (parallel/peer.py), or torch.distributed's over its process group.
    Every call site of the rank axis that crosses processes or cards goes
    through here: collectives/core.reduce_ranks, `_all_gather_rows` and
    `replicas_agree`, collectives/rings._Hop, and reshard/primitives'
    `_barrier` and `_largest`. No reference analog: JAX's collectives
    are XLA's over the mesh's devices."""
    from tpu_reductions_torch.parallel.peer import PeerGroup
    if isinstance(mesh.group, PeerGroup):
        return mesh.group.member(mesh.process)
    return _ProcessComm(mesh.group)


def _claim_card(store, card: torch.device, process_id: int,
                num_processes: int) -> None:
    """Publish this process's card (host and UUID) on the rendezvous
    store and read every other's; raises, in every process alike, when
    two processes drive one card, before NCCL sees them. Process 0, whose
    store the others read, waits until each has read them all."""
    props = torch.cuda.get_device_properties(card)
    mine = f"{socket.gethostname()}/{getattr(props, 'uuid', card.index)}"
    key = "tpu_reductions_torch/card"
    store.set(f"{key}/{process_id}", mine)
    seen: dict = {}
    clash = None
    for p in range(num_processes):
        who = store.get(f"{key}/{p}").decode()
        if who in seen and clash is None:
            clash = (seen[who], p, who)
        seen.setdefault(who, p)
    store.set(f"{key}/read/{process_id}", "1")
    if process_id == 0:
        store.wait([f"{key}/read/{p}" for p in range(1, num_processes)])
    if clash is not None:
        raise RuntimeError(
            f"processes {clash[0]} and {clash[1]} both drive card "
            f"{clash[2]}: two processes on one card is NCCL's duplicate "
            f"GPU failure; give each process its own card (LOCAL_RANK, or "
            f"--process-id on one host)")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           platform: str = "gpu") -> bool:
    """Join the processes of one run at `coordinator_address` (host:port
    of process 0): over NCCL on the card, each process on its own card
    (device.own_card), which no two processes may share, the communicator
    bound to it at once (`device_id`), so a failure shows here; over gloo
    on the CPU. A card run never joins over gloo. Every participating
    process calls this before build_mesh. Returns True when it joined,
    False when it did nothing (one process, or a group already exists)."""
    import torch.distributed as dist
    if num_processes in (None, 1):
        return False
    if dist.is_initialized():
        return False
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    url = f"tcp://{coordinator_address}"
    if platform == "cpu":
        dist.init_process_group("gloo", init_method=url,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
        return True
    if not torch.cuda.is_available():
        device_mod.resolve(platform)        # raises: no card, never gloo
    card = device_mod.own_card(process_id, num_processes)
    store, _, _ = next(dist.rendezvous(url, rank=process_id,
                                       world_size=num_processes,
                                       timeout=timeout))
    store.set_timeout(timeout)
    _claim_card(store, card, process_id, num_processes)
    dist.init_process_group("nccl", store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout,
                            device_id=card)
    return True


def leave_distributed() -> None:
    """Destroy the process group of `initialize_distributed`, with the
    garbage collected before and after: a run's meshes, hop plans and
    their works sit in reference cycles, and torch's group objects that
    the interpreter's finalization frees instead can abort the process
    after its rows are done (seen on the CPU after the pair rows)."""
    import torch.distributed as dist
    gc.collect()
    _SUBGROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()
