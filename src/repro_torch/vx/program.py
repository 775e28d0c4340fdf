"""The access-program IR — stage three of the vx pipeline.

Port of ``repro``'s ``vx/program.py``: a :class:`Program` is a tuple of
:class:`Txn` (op x spec keys x impl x placement), keyed into the plan
cache, and :func:`fuse` merges same-head single-transaction programs into
one wide transaction (the step scheduler's merge).  A placement is a
:class:`Shard` over a ``DeviceMesh``; its :meth:`Shard.layout`, mesh
included, is part of the key, so the same spec lowered against two
placements is two cached programs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

from repro_torch.vx.spec import AccessSpec


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """Operand placement: buffer axis ``axis`` is sharded over mesh
    ``axes`` (contiguous equal blocks, first axis major — the
    ``PartitionSpec`` split order).

    ``axis`` counts from the END (must be negative) so the annotation
    stays valid when a fusion pass stacks accesses along a new leading
    dim.  ``axis == -1`` shards the ACCESSED lane axis itself — strided
    programs then rebase offsets per shard; any other axis is elementwise
    for lane-permutation programs, which execute shard-locally with the
    unmodified plan.

    ``mesh`` (a ``DeviceMesh``) is excluded from dataclass equality and
    hashing but IS part of :meth:`layout` (the cache key): two meshes with
    the same axis names and shard count but other shapes must not share
    an executor, which holds its rank's shard index.  A ``DeviceMesh``
    hashes and compares by its rank layout and names, so equal meshes
    share one entry.
    """

    axes: tuple
    axis: int
    mesh: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple(self.axes))
        if not self.axes:
            raise ValueError("Shard needs at least one mesh axis")
        if self.axis >= 0:
            raise ValueError(
                f"Shard.axis counts from the end (negative), got "
                f"{self.axis} — a leading-axis index would silently point "
                f"at a different dim once a fusion pass stacks operands")
        if self.mesh is None:
            raise ValueError("Shard needs the executing mesh")

    @property
    def nshards(self) -> int:
        names = self.mesh.mesh_dim_names
        return math.prod(self.mesh.shape[names.index(a)] for a in self.axes)

    def layout(self) -> tuple:
        """The hashable placement key: (axis names, buffer axis, count,
        mesh)."""
        return (self.axes, self.axis, self.nshards, self.mesh)

    def divides(self, dim: int) -> bool:
        return dim % self.nshards == 0

    def index(self) -> int:
        """This rank's shard, the axes flattened first axis major."""
        from repro_torch.dist.sharding import axis_index
        return axis_index(self.mesh, self.axes)


def layout_of(shard: "Shard | None") -> tuple | None:
    return None if shard is None else shard.layout()


#: Ops a Txn may name.  ``*.plan`` ops run compiled shift plans;
#: ``bank.*`` dispatch a runtime stride over the plan bank; ``idx.*`` and
#: ``compact.*`` are the Indexed and Compact accesses.
OPS = ("gather.plan", "scatter.plan", "bank.gather", "bank.scatter",
       "seg.deint", "seg.int", "idx.gather", "idx.scatter", "compact.rows",
       "compact.ids", "compact.expand", "paged.gather", "paged.scatter")


@dataclasses.dataclass(frozen=True)
class Txn:
    """One routed transaction: op x specs x lowering x placement."""

    op: str
    specs: tuple                  # tuple of AccessSpec.key() tuples
    impl: str
    layout: tuple | None = None   # Shard.layout() | None (replicated)

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown txn op {self.op!r}")
        object.__setattr__(self, "specs", tuple(self.specs))

    @property
    def width(self) -> int:
        """Fused arity: how many accesses this transaction serves."""
        return len(self.specs)

    @property
    def homogeneous(self) -> bool:
        return len(set(self.specs)) == 1


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered access: the (usually singleton) transaction list."""

    txns: tuple

    def __post_init__(self):
        object.__setattr__(self, "txns", tuple(self.txns))
        if not self.txns:
            raise ValueError("empty program")

    def key(self) -> tuple:
        return ("prog", self.txns)

    @property
    def txn(self) -> Txn:
        if len(self.txns) != 1:
            raise ValueError(f"program has {len(self.txns)} txns")
        return self.txns[0]


def single(op: str, specs: Sequence[AccessSpec] | AccessSpec, impl: str,
           shard: "Shard | None" = None) -> Program:
    if isinstance(specs, AccessSpec):
        specs = (specs,)
    return Program((Txn(op, tuple(s.key() for s in specs), impl,
                        layout_of(shard)),))


def fuse(programs: Sequence[Program]) -> Program:
    """Merge single-transaction programs into ONE wide transaction (one
    kernel launch for the whole group).  Spec compatibility (one shared
    (n, vl) for strided, identical specs for segment) is the executor's
    contract, checked in ``vx/lower.py``."""
    txns = [p.txn for p in programs]
    heads = {(t.op, t.impl, t.layout) for t in txns}
    if len(heads) != 1:
        raise ValueError(f"cannot fuse mixed transactions: {heads}")
    op, impl, layout = heads.pop()
    return Program((Txn(op, tuple(s for t in txns for s in t.specs), impl,
                        layout),))
