"""vx verbs — argument normalization over the spec -> plan -> program
pipeline (port of ``repro``'s ``vx/_dispatch.py``).

The port has ``transpose`` (Segment), ``gather`` / ``scatter`` (Strided,
Indexed, Paged over float and quantized pools, and the Compact
expansion), ``compact`` (Compact), ``gather_many`` (Strided, Paged and
Segment), ``scatter_many`` (Segment) and ``warm``.  ``shard=`` (a
``vx.Shard``) lowers the access shard-locally (vx/lower.py); an op without
a sharded lowering raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import shiftplan
from repro_torch.dist import sharding as _sharding
from repro_torch.vx import lower as _lower
from repro_torch.vx import program as _program
from repro_torch.vx.policy import Policy, resolve
from repro_torch.vx.program import Shard
from repro_torch.vx.spec import (AccessSpec, Compact, Indexed, Paged,
                                 Segment, Strided, _dtype_str)


def _fold_routing(spec: Indexed, shift, valid) -> Indexed | None:
    """Promote a host-known (shift, valid) routing (numpy arrays, lists,
    tuples) into the spec, so the access compiles through the plan stage
    (constant take-masks memoized under the spec key).  Tensor operands
    return None (the dynamic network)."""
    if spec.routing is not None:
        if shift is not None or valid is not None:
            raise ValueError(
                f"{spec} already folds a static routing; do not also pass "
                f"shift=/valid=")
        return spec
    if shiftplan.host_counts(shift, valid):
        return dataclasses.replace(
            spec, routing=(tuple(np.asarray(shift, np.int64).tolist()),
                           tuple(np.asarray(valid, bool).tolist())))
    return None


def _static_strided(spec: Strided, stride) -> Strided | None:
    """The spec with a Python-int stride folded in, or None when the
    stride is runtime (a tensor: it goes through the plan bank)."""
    if not spec.runtime:
        if stride is not None:
            raise ValueError(
                f"stride= was passed but {spec} already pins stride="
                f"{spec.stride}; use stride=vx.BANK in the spec for "
                f"call-time strides")
        return spec
    if stride is None:
        raise ValueError(
            "spec has stride=vx.BANK: pass the runtime stride as stride=")
    if isinstance(stride, torch.Tensor):
        return None
    return dataclasses.replace(spec, stride=int(stride))


def _bind_scales(spec: Paged, scales):
    """Fold the runtime ``scales`` operand into a quantized spec: its
    dtype becomes ``spec.scale_dtype``, so the quantized program is a
    plan-cache entry of its own (spec fields are the cache key).  Checks
    presence both ways."""
    if scales is None:
        if spec.quantized:
            raise ValueError(f"{spec} is quantized: pass scales=")
        return spec
    if spec.scale_dtype is None:
        return dataclasses.replace(spec, scale_dtype=_dtype_str(scales.dtype))
    return spec


def gather(spec: AccessSpec, buf: torch.Tensor, *, stride=None, shift=None,
           valid=None, table=None, scales=None,
           policy: Policy | str | None = None,
           shard: Shard | None = None) -> torch.Tensor:
    """Dense read through the access described by ``spec``.

    * :class:`Strided` — ``(..., n) -> (..., vl)``.  A ``stride=vx.BANK``
      spec takes the stride as ``stride=``: a Python int folds into the
      spec (the compiled path, as a static stride); a 0-dim tensor is the
      runtime form, read on the host once (a sync) and dispatched over
      the plan bank (compiled plans for +-1..8, the dynamic-count network
      otherwise; either sign engages the Reverser).
    * :class:`Indexed` — DROM gather with per-lane ``shift`` and ``valid``
      operands, ``(..., n) -> (..., n)``.  Host-known routings
      (numpy/list/tuple, or a spec with ``routing=``) fold into the spec
      and run the plan stage (torch ops under every policy, as in the
      reference); tensor operands take the dynamic-count network (kernel
      B12 under either kernel policy).
    * :class:`Paged` — page-table gather over a ``(*lead, P, ps, *trail)``
      pool: ``table=`` is the runtime ``(*batch, pages)`` int32 page table
      (entries ``< 0`` read as zeros); returns ``(*lead, *batch,
      pages*ps, *trail)``.  ``shard=`` (on the pool's page axis,
      ``Shard.axis == -(trail+2)``) gathers shard-locally from the owned
      page block and psum-merges.  A QUANTIZED pool passes its per-page
      scale tensor as ``scales=`` and gets the dequantized float sequences
      back from the same one gather.

    For a Strided spec ``shard=`` marks ``buf``'s lane axis as sharded:
    each rank runs its offset-rebased sub-access and the disjoint lanes
    merge with one psum (a replicated result).
    """
    pol = resolve(policy)
    if isinstance(spec, Strided):
        spec = spec.bind(buf.dtype)
        static = _static_strided(spec, stride)
        if static is not None:
            return _lower.run("gather.plan", static, pol.impl, buf,
                              shard=shard)
        return _lower.run("bank.gather", spec, pol.impl, buf, stride,
                          shard=shard)
    if isinstance(spec, Indexed):
        spec = spec.bind(buf.dtype)
        static = _fold_routing(spec, shift, valid)
        if static is not None:
            return _lower.run("idx.gather", static, pol.impl, buf,
                              shard=shard)
        if shift is None or valid is None:
            raise ValueError("Indexed gather needs shift= and valid= "
                             "(or a spec with routing=)")
        return _lower.run("idx.gather", spec, pol.impl, buf, shift, valid,
                          shard=shard)
    if not isinstance(spec, Paged):
        raise TypeError(f"gather does not accept {type(spec).__name__} "
                        f"specs in this slice")
    if table is None:
        raise ValueError("Paged gather needs the page table as table=")
    spec = _bind_scales(spec.bind(buf.dtype), scales)
    if spec.quantized:
        return _lower.run("paged.gather", spec, pol.impl, buf, scales, table,
                          shard=shard)
    return _lower.run("paged.gather", spec, pol.impl, buf, table,
                      shard=shard)


def scatter(spec: AccessSpec, buf: torch.Tensor | None,
            values: torch.Tensor, *, stride=None, shift=None, valid=None,
            table=None, pos=None, scales=None,
            policy: Policy | str | None = None,
            shard: Shard | None = None):
    """Write/merge through the access described by ``spec``.

    * :class:`Strided` — merge dense ``values`` into the strided lanes of
      ``buf`` (read-modify-write, out of place); returns the new window.
      ``stride=`` as for :func:`gather`.  With ``shard=`` (the lane axis)
      each rank merges only its own lanes and the window stays sharded
      (a ``DTensor``); nothing is sent.
    * :class:`Paged` — the decode append: one ``(*batch, *trail)`` beat
      per table row into pool ``buf`` at per-row position ``pos=`` through
      ``table=`` (rows with ``pos < 0`` or an unallocated page are
      dropped).  Updates the pool in place and returns it.  A pool
      ``DTensor`` sharded on its page axis takes each beat only on the
      rank that owns its page (no ``shard=``: the placement is the
      pool's own).  A QUANTIZED
      pool passes ``scales=`` (updated in place too) and gets ``(pool,
      scales)`` back: the beat quantizes on write and the page scale only
      widens (see vx/lower.py).
    * :class:`Indexed` — raw DROM scatter of ``values`` (``buf`` is
      unused; pass None); returns ``(payload, occupancy)``.  Host counts
      run the compiled plan (kernel B13), tensor counts the dynamic-count
      network (kernel B14), under either kernel policy.
    * :class:`Compact` — expansion (the compaction inverse): ``buf`` is
      the boolean mask, ``values`` the packed rows; returns the rows
      scattered back to the mask positions, zeros elsewhere (kernel B10).
    """
    pol = resolve(policy)
    if isinstance(spec, Strided):
        spec = spec.bind(buf.dtype)
        static = _static_strided(spec, stride)
        if static is not None:
            return _lower.run("scatter.plan", static, pol.impl, buf, values,
                              shard=shard)
        return _lower.run("bank.scatter", spec, pol.impl, buf, values,
                          stride, shard=shard)
    if isinstance(spec, Indexed):
        if shift is None or valid is None:
            raise ValueError("Indexed scatter needs shift= and valid=")
        return _lower.run("idx.scatter", spec.bind(values.dtype), pol.impl,
                          values, shift, valid, shard=shard)
    if isinstance(spec, Compact):
        return _lower.run("compact.expand", spec.bind(values.dtype),
                          pol.impl, values, buf, shard=shard)
    if not isinstance(spec, Paged):
        raise TypeError(f"scatter does not accept {type(spec).__name__} "
                        f"specs in this slice")
    if table is None or pos is None:
        raise ValueError("Paged scatter needs table= and pos=")
    spec = _bind_scales(spec.bind(buf.dtype), scales)
    if spec.quantized:
        return _lower.run("paged.scatter", spec, pol.impl, buf, scales,
                          values, table, pos, shard=shard)
    return _lower.run("paged.scatter", spec, pol.impl, buf, values, table,
                      pos, shard=shard)


def transpose(spec: Segment, x, *, policy: Policy | str | None = None,
              shard: Shard | None = None):
    """Segment transposition, direction inferred from the operand: one AoS
    array ``(..., n)`` -> ``fields`` SoA arrays (deinterleave), or a
    sequence of ``fields`` SoA arrays -> one AoS array (interleave).
    ``shard=`` (an OUTER axis, ``Shard.axis <= -2``) runs the lane
    permutation on each rank's block; the result is placed like the
    operand."""
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
                          parts, shard=shard)
    if x.shape[-1] != spec.n:
        raise ValueError(f"AoS beat has {x.shape[-1]} lanes, spec.n is "
                         f"{spec.n}")
    return _lower.run("seg.deint", spec.bind(x.dtype), pol.impl, x,
                      shard=shard)


def compact(spec: Compact, mask: torch.Tensor,
            rows: torch.Tensor | None = None, *,
            policy: Policy | str | None = None):
    """Order-preserving masked compaction.

    With ``rows`` — pack the masked rows to the front; returns
    ``(packed_rows, packed_valid)``, truncated to ``spec.capacity`` rows
    when ``cap`` is set (kernel B10 under either kernel policy).  Without
    ``rows`` — the packed *indices* of the set mask bits (the first
    ``spec.capacity``), the MoE dispatch primitive: torch ops under every
    policy, as in the reference."""
    if not isinstance(spec, Compact):
        raise TypeError(f"compact needs a Compact spec, got "
                        f"{type(spec).__name__}")
    pol = resolve(policy)  # validate even on the impl-independent path
    if rows is None:
        return _lower.run("compact.ids", spec, pol.impl, mask)
    return _lower.run("compact.rows", spec.bind(rows.dtype), pol.impl,
                      rows, mask)


def gather_many(specs, bufs, *, table=None, scales=None,
                policy: Policy | str | None = None,
                shard: Shard | None = None):
    """Whole-step batched gather — ONE program for the whole group.

    * ``specs`` a sequence of :class:`Strided` sharing ``(n, vl)`` with
      per-access ``(stride, offset)``, ``bufs`` the matching windows (a
      sequence, or an already-stacked ``(A, ..., n)`` tensor): one launch
      of the fused gather (one shared plan when the specs are equal).
      Returns the stacked ``(A, ..., vl)``.
    * ``specs`` a single :class:`Paged`, ``bufs`` same-shape pools sharing
      one ``table=``: all pools stack and gather in one program.  Quantized
      pools pass their per-page scale tensors as ``scales=`` (stacked the
      same way); the dequant rides the same program.  ``shard=`` on the
      page axis.  Returns one gathered array per pool.
    * ``specs`` a single :class:`Segment`, ``bufs`` same-shape AoS arrays:
      the step-fused segment load (one kernel launch; ``shard=`` on an
      outer axis: the stacked group transposes shard-locally).  Returns
      one field list per input array.

    Operands placed as ``DTensor`` s stack block by block.
    """
    pol = resolve(policy)
    if not isinstance(specs, (Paged, Segment)):
        return _gather_many_strided(list(specs), bufs, pol, shard)
    bufs = list(bufs)
    if isinstance(specs, Paged):
        if table is None:
            raise ValueError("Paged gather_many needs table=")
        scl = None if scales is None else list(scales)
        spec = _bind_scales(specs.bind(bufs[0].dtype),
                            None if scl is None else scl[0])
        prog = _program.fuse([_lower.lower("paged.gather", spec, pol.impl,
                                           shard)] * len(bufs))
        stacked = bufs[0] if len(bufs) == 1 else _sharding.stack(bufs)
        exe = _lower.executor(prog, (spec,) * len(bufs), shard)
        if scl is None:
            out = exe(stacked, table)
        else:
            out = exe(stacked,
                      scl[0] if len(scl) == 1 else _sharding.stack(scl),
                      table)
        return [out] if len(bufs) == 1 else list(out.unbind(0))
    spec = specs.bind(bufs[0].dtype)
    prog = _program.fuse([_lower.lower("seg.deint", spec, pol.impl,
                                       shard)] * len(bufs))
    stacked = bufs[0] if len(bufs) == 1 else _sharding.stack(bufs)
    outs = _lower.executor(prog, (spec,) * len(bufs), shard)(stacked)
    if len(bufs) == 1:
        return [list(outs)]
    return [[_sharding.select(o, a) for o in outs] for a in range(len(bufs))]


def scatter_many(spec: Segment, groups, *,
                 policy: Policy | str | None = None,
                 shard: Shard | None = None) -> list[torch.Tensor]:
    """Step-fused segment store: same-shape SoA groups (each a sequence of
    ``spec.fields`` arrays ``(..., m)``) in ONE interleave (one B2 launch
    under ``kernel``, one B7 under ``kernel_dynamic``).  Returns one AoS
    array ``(..., fields * m)`` per group."""
    if not isinstance(spec, Segment):
        raise TypeError("scatter_many needs a Segment spec")
    pol = resolve(policy)
    groups = [list(g) for g in groups]
    spec = spec.bind(groups[0][0].dtype)
    prog = _program.fuse([_lower.lower("seg.int", spec, pol.impl,
                                       shard)] * len(groups))
    fn = _lower.executor(prog, (spec,) * len(groups), shard)
    if len(groups) == 1:
        return [fn(groups[0])]
    stacked = [_sharding.stack([g[f] for g in groups])
               for f in range(spec.fields)]
    out = fn(stacked)
    return [_sharding.select(out, a) for a in range(len(groups))]


def _gather_many_strided(specs: list, bufs, pol: Policy,
                         shard: Shard | None) -> torch.Tensor:
    if not specs or not all(isinstance(s, Strided) for s in specs):
        raise TypeError("gather_many needs Strided specs, one Paged or one "
                        "Segment spec")
    if len({s.vl for s in specs}) != 1 or len({s.n for s in specs}) != 1:
        raise ValueError("fused gather needs one shared (n, vl)")
    windows = bufs if isinstance(bufs, torch.Tensor) else \
        _sharding.stack(list(bufs))
    specs = tuple(s.bind(windows.dtype) for s in specs)
    prog = _program.fuse([_lower.lower("gather.plan", s, pol.impl, shard)
                          for s in specs])
    return _lower.executor(prog, specs, shard)(windows)


def warm(n: int, *, offset: int = 0, vl: int | None = None,
         strided: bool = True, fields: tuple | None = None,
         policy: Policy | str | None = None) -> None:
    """Precompile runtime-stride bank plans and segment plans for a window
    width (one-time host cost, so the first step never pays plan
    compilation).  ``strided=False`` skips the +-stride slots; segment
    plans are skipped under ``impl="ref"``, which never consults them.
    The bank runs under every policy, so its slots are warmed under every
    policy too.  ``kernel_dynamic`` warms what ``kernel`` warms, as the
    reference's ``pallas_dynamic`` does: its own kernels build their
    networks on the card and need no plan, but a group below the launch
    threshold and the bank still take the plan path."""
    from repro_torch.core import accessfuse
    from repro_torch.vx.policy import BANK_FIELDS
    fields = BANK_FIELDS if fields is None else fields
    if resolve(policy).impl == "ref":
        fields = ()
    accessfuse.warm(n, offset=offset, vl=vl, strided=strided, fields=fields)
