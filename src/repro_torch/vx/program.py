"""The access-program IR — stage three of the vx pipeline.

Port of ``repro``'s ``vx/program.py`` restricted to replicated programs:
a :class:`Program` is a tuple of :class:`Txn` (op x spec keys x impl),
keyed into the plan cache, and :func:`fuse` merges same-head
single-transaction programs into one wide transaction (the step
scheduler's merge).  Placement (``Shard``, shard layouts) waits for the
distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.vx.spec import AccessSpec

#: Ops a Txn may name.  ``*.plan`` ops run compiled shift plans;
#: ``bank.*`` dispatch a runtime stride over the plan bank; ``idx.*`` and
#: ``compact.*`` are the Indexed and Compact accesses.
OPS = ("gather.plan", "scatter.plan", "bank.gather", "bank.scatter",
       "seg.deint", "seg.int", "idx.gather", "idx.scatter", "compact.rows",
       "compact.ids", "compact.expand", "paged.gather", "paged.scatter")


@dataclasses.dataclass(frozen=True)
class Txn:
    """One routed transaction: op x specs x lowering."""

    op: str
    specs: tuple                  # tuple of AccessSpec.key() tuples
    impl: str

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


def single(op: str, specs: Sequence[AccessSpec] | AccessSpec,
           impl: str) -> Program:
    if isinstance(specs, AccessSpec):
        specs = (specs,)
    return Program((Txn(op, tuple(s.key() for s in specs), impl),))


def fuse(programs: Sequence[Program]) -> Program:
    """Merge single-transaction programs into ONE wide transaction (one
    kernel launch for the whole group).  Spec compatibility (one shared
    (n, vl) for strided, identical specs for segment) is the executor's
    contract, checked in ``vx/lower.py``."""
    txns = [p.txn for p in programs]
    heads = {(t.op, t.impl) for t in txns}
    if len(heads) != 1:
        raise ValueError(f"cannot fuse mixed transactions: {sorted(heads)}")
    op, impl = heads.pop()
    return Program((Txn(op, tuple(s for t in txns for s in t.specs), impl),))
