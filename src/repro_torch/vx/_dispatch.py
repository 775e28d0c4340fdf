"""vx verbs — argument normalization over the spec -> plan -> program
pipeline (port of ``repro``'s ``vx/_dispatch.py``).

This slice ports ``transpose`` (Segment), ``gather`` / ``scatter``
(Paged, float pools), ``gather_many`` (Paged and Segment) and ``warm``.
``compact``, ``scatter_many``, the Strided/Indexed forms, quantized
``scales=`` and ``shard=`` wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.vx import lower as _lower
from repro_torch.vx import program as _program
from repro_torch.vx.policy import Policy, resolve
from repro_torch.vx.spec import AccessSpec, Paged, Segment


def gather(spec: AccessSpec, buf: torch.Tensor, *, table=None,
           policy: Policy | str | None = None) -> torch.Tensor:
    """Page-table gather over a ``(*lead, P, ps, *trail)`` pool:
    ``table=`` is the runtime ``(*batch, pages)`` int32 page table
    (entries ``< 0`` read as zeros); returns ``(*lead, *batch, pages*ps,
    *trail)``."""
    pol = resolve(policy)
    if not isinstance(spec, Paged):
        raise TypeError(f"gather does not accept {type(spec).__name__} "
                        f"specs in this slice")
    if table is None:
        raise ValueError("Paged gather needs the page table as table=")
    return _lower.run("paged.gather", spec.bind(buf.dtype), pol.impl, buf,
                      table)


def scatter(spec: AccessSpec, buf: torch.Tensor, values: torch.Tensor, *,
            table=None, pos=None, policy: Policy | str | None = None):
    """The decode append: one ``(*batch, *trail)`` beat per table row into
    pool ``buf`` at per-row position ``pos=`` through ``table=`` (rows
    with ``pos < 0`` or an unallocated page are dropped).  Updates the
    pool in place and returns it."""
    pol = resolve(policy)
    if not isinstance(spec, Paged):
        raise TypeError(f"scatter does not accept {type(spec).__name__} "
                        f"specs in this slice")
    if table is None or pos is None:
        raise ValueError("Paged scatter needs table= and pos=")
    return _lower.run("paged.scatter", spec.bind(buf.dtype), pol.impl,
                      buf, values, table, pos)


def transpose(spec: Segment, x, *, policy: Policy | str | None = None):
    """Segment transposition, direction inferred from the operand: one AoS
    array ``(..., n)`` -> ``fields`` SoA arrays (deinterleave), or a
    sequence of ``fields`` SoA arrays -> one AoS array (interleave)."""
    if not isinstance(spec, Segment):
        raise TypeError(f"transpose needs a Segment spec, got "
                        f"{type(spec).__name__}")
    pol = resolve(policy)
    if isinstance(x, (list, tuple)):
        parts = list(x)
        if len(parts) != spec.fields:
            raise ValueError(f"expected {spec.fields} fields, "
                             f"got {len(parts)}")
        return _lower.run("seg.int", spec.bind(parts[0].dtype), pol.impl,
                          parts)
    if x.shape[-1] != spec.n:
        raise ValueError(f"AoS beat has {x.shape[-1]} lanes, spec.n is "
                         f"{spec.n}")
    return _lower.run("seg.deint", spec.bind(x.dtype), pol.impl, x)


def gather_many(specs, bufs, *, table=None,
                policy: Policy | str | None = None):
    """Whole-step batched gather — ONE program for the whole group.

    * ``specs`` a single :class:`Paged`, ``bufs`` same-shape pools sharing
      one ``table=``: all pools stack and gather in one program.  Returns
      one gathered array per pool.
    * ``specs`` a single :class:`Segment`, ``bufs`` same-shape AoS arrays:
      the step-fused segment load (one kernel launch).  Returns one field
      list per input array.
    """
    pol = resolve(policy)
    bufs = list(bufs)
    if isinstance(specs, Paged):
        if table is None:
            raise ValueError("Paged gather_many needs table=")
        spec = specs.bind(bufs[0].dtype)
        prog = _program.fuse([_lower.lower("paged.gather", spec,
                                           pol.impl)] * len(bufs))
        stacked = bufs[0] if len(bufs) == 1 else torch.stack(bufs)
        out = _lower.executor(prog, (spec,) * len(bufs))(stacked, table)
        return [out] if len(bufs) == 1 else list(out.unbind(0))
    if isinstance(specs, Segment):
        spec = specs.bind(bufs[0].dtype)
        prog = _program.fuse([_lower.lower("seg.deint", spec,
                                           pol.impl)] * len(bufs))
        stacked = bufs[0] if len(bufs) == 1 else torch.stack(bufs)
        outs = _lower.executor(prog, (spec,) * len(bufs))(stacked)
        if len(bufs) == 1:
            return [list(outs)]
        return [[o[a] for o in outs] for a in range(len(bufs))]
    raise TypeError("gather_many needs one Paged or one Segment spec in "
                    "this slice")


def warm(n: int, *, fields: tuple = (2,),
         policy: Policy | str | None = None) -> None:
    """Precompile the segment plans for a beat width (one-time host cost,
    so the first step never pays plan compilation).  Skipped under
    ``impl="ref"``, which never consults them.  The runtime-stride bank
    slots of the reference's ``warm`` wait with the bank itself."""
    from repro_torch.core import accessfuse
    if resolve(policy).impl == "ref":
        return
    accessfuse.warm(n, fields=fields)
