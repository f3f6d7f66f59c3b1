"""ShardingSpec: the value type of the reshard engine.

The port's copy of tpu_reductions/reshard/spec.py. A spec names a device
mesh (ordered (axis_name, size) pairs) and, per array dimension, which
mesh axes partition it: the portable sharding description of Zhang et
al.'s array-redistribution framework (arXiv:2112.01075), where every
transfer is a (source, target) pair of these. Specs are validated at
construction, immutable, and round-trip through a canonical JSON byte
for byte, the JAX package's bytes, because they live inside the curve's
artifacts and the resume contract compares them.

A `partial=True` spec carries pending-reduction state: each rank holds
one full-size addend and the logical global value is their elementwise
sum, the input reduce_scatter consumes (reshard/oracle.py spells the
semantics in numpy). The reference has no analog: its MPI arrays lived
whole on every rank (reduce.c:30-36).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


class ShardingSpecError(ValueError):
    """A spec that does not describe a placement (bad mesh axis, reused
    axis, unknown name...)."""


@dataclasses.dataclass(frozen=True)
class ShardingSpec:
    """mesh_axes: ordered ((name, size), ...) — the device mesh.
    dim_specs: per array dimension, the tuple of mesh axis names that
    partition it (() = replicated along that dim). partial: the value
    is a per-rank sum addend, not yet reduced (module docstring)."""

    mesh_axes: Tuple[Tuple[str, int], ...]
    dim_specs: Tuple[Tuple[str, ...], ...]
    partial: bool = False

    def __post_init__(self):
        mesh = tuple((str(n), int(s)) for n, s in self.mesh_axes)
        dims = tuple(tuple(str(a) for a in d) for d in self.dim_specs)
        object.__setattr__(self, "mesh_axes", mesh)
        object.__setattr__(self, "dim_specs", dims)
        object.__setattr__(self, "partial", bool(self.partial))
        names = [n for n, _ in mesh]
        if len(set(names)) != len(names):
            raise ShardingSpecError(f"duplicate mesh axis in {names}")
        for n, s in mesh:
            if not n.isidentifier():
                raise ShardingSpecError(f"mesh axis name {n!r} is not "
                                        f"an identifier")
            if s < 1:
                raise ShardingSpecError(f"mesh axis {n!r} has size {s}")
        used = []
        for d in dims:
            for a in d:
                if a not in names:
                    raise ShardingSpecError(
                        f"dim spec references unknown mesh axis {a!r} "
                        f"(mesh has {names})")
                used.append(a)
        if len(set(used)) != len(used):
            raise ShardingSpecError(
                f"mesh axis used on more than one array position: "
                f"{sorted(a for a in set(used) if used.count(a) > 1)}")

    # -- derived geometry --------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.dim_specs)

    @property
    def num_ranks(self) -> int:
        """Total device count of the mesh."""
        out = 1
        for _, s in self.mesh_axes:
            out *= s
        return out

    def axis_size(self, name: str) -> int:
        for n, s in self.mesh_axes:
            if n == name:
                return s
        raise ShardingSpecError(f"no mesh axis {name!r}")

    def partitions(self, dim: int) -> int:
        """How many ways array dimension `dim` is split."""
        out = 1
        for a in self.dim_specs[dim]:
            out *= self.axis_size(a)
        return out

    def sharded_dim(self):
        """The single partitioned array dimension, or None when fully
        replicated. Raises when more than one dim is partitioned (the
        single-axis planner's precondition; multi-dim specs are valid
        values but have no plan yet)."""
        dims = [i for i, d in enumerate(self.dim_specs)
                if d and self.partitions(i) > 1]
        if not dims:
            return None
        if len(dims) > 1:
            raise ShardingSpecError(
                f"spec partitions {len(dims)} dims; the planner handles "
                f"one per spec (dims {dims})")
        return dims[0]

    def local_shape(self, global_shape: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
        """Per-rank block shape for a given global shape; validates
        divisibility (partition counts must divide their extents)."""
        if len(global_shape) != self.ndim:
            raise ShardingSpecError(
                f"spec has {self.ndim} dims, array has "
                f"{len(global_shape)}")
        out = []
        for i, n in enumerate(global_shape):
            p = self.partitions(i)
            if n % p:
                raise ShardingSpecError(
                    f"dim {i} extent {n} does not divide into {p} "
                    f"partitions")
            out.append(n // p)
        return tuple(out)

    def local_fraction(self) -> float:
        """Per-rank resident fraction of the GLOBAL array bytes — the
        unit of the planner's peak-memory factors. Replication costs
        full copies; a partial spec's addend is full-size by
        definition."""
        f = 1.0
        for i in range(self.ndim):
            f /= self.partitions(i)
        return f

    # -- canonical JSON ----------------------------------------------------

    def to_obj(self) -> dict:
        return {"mesh": [[n, s] for n, s in self.mesh_axes],
                "dims": [list(d) for d in self.dim_specs],
                "partial": self.partial}

    def to_json(self) -> str:
        """Canonical compact encoding: sorted keys, no whitespace (the
        byte-identical round trip)."""
        return json.dumps(self.to_obj(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_obj(cls, obj: dict) -> "ShardingSpec":
        try:
            mesh = tuple((str(n), int(s)) for n, s in obj["mesh"])
            dims = tuple(tuple(str(a) for a in d) for d in obj["dims"])
            partial = bool(obj.get("partial", False))
        except (KeyError, TypeError, ValueError) as e:
            raise ShardingSpecError(f"malformed spec object: {e}")
        return cls(mesh, dims, partial)

    @classmethod
    def from_json(cls, text: str) -> "ShardingSpec":
        try:
            obj = json.loads(text)
        except ValueError as e:
            raise ShardingSpecError(f"spec is not JSON: {e}")
        if not isinstance(obj, dict):
            raise ShardingSpecError(f"spec must be a JSON object, got "
                                    f"{type(obj).__name__}")
        return cls.from_obj(obj)

    # -- constructors ------------------------------------------------------

    @classmethod
    def replicated(cls, k: int, ndim: int, *, axis: str = "ranks",
                   partial: bool = False) -> "ShardingSpec":
        """Fully replicated (or partial) spec on a 1-D k-device mesh."""
        return cls(((axis, k),), tuple(() for _ in range(ndim)),
                   partial)

    @classmethod
    def sharded(cls, k: int, ndim: int, dim: int, *,
                axis: str = "ranks") -> "ShardingSpec":
        """1-D mesh spec partitioning exactly array dimension `dim`."""
        return cls(((axis, k),),
                   tuple((axis,) if i == dim else ()
                         for i in range(ndim)))

    def describe(self) -> str:
        """Short human label ('S0@8', 'R@8', 'P@8') for logs/notes."""
        k = self.num_ranks
        if self.partial:
            return f"P@{k}"
        d = self.sharded_dim()
        return f"R@{k}" if d is None else f"S{d}@{k}"
