"""Lowering — stage transitions of the vx pipeline, and program execution.

Port of ``repro``'s ``vx/lower.py`` for the replicated builders of the
slices so far: ``gather.plan`` / ``scatter.plan`` (plain torch oracles
under ``ref``, CUDA kernels B3/B4/B5 under ``kernel``, B8/B9 under
``kernel_dynamic``; a negative static stride goes to the plan bank),
``bank.gather`` / ``bank.scatter`` (the runtime-stride plan bank, torch
ops under every policy, as in the reference), ``seg.deint`` / ``seg.int``
(oracles under ``ref``, kernels B1/B2 under ``kernel``, B6/B7 under
``kernel_dynamic``), ``idx.gather`` (a static routing: the plan stage,
torch ops under every policy; runtime counts: the GSN under ``ref``,
kernel B12 under both kernel policies), ``idx.scatter`` (the SSN under
``ref``; B13 for host counts and B14 for tensor counts under both kernel
policies), ``compact.rows`` / ``compact.expand`` (the oracles under
``ref``, kernel B10 otherwise), ``compact.ids``
(``accessfuse.compact_indices``, torch ops under every policy) and
``paged.gather`` / ``paged.scatter`` over float pools (plain torch ops:
the reference has no Pallas kernel for them either).  ``lower()`` builds a validated
:class:`~repro_torch.vx.program.Program`; ``executor()`` compiles it into
the callable that runs it, memoized in ``vx.PLANS`` under
``Program.key()`` (dtype and impl included).

Waiting for later slices: the quantized paged arm (``core/quant.py``)
and every sharded lowering.
"""
from __future__ import annotations

import torch

from repro_torch.vx import program as prg
from repro_torch.vx.cache import PLANS
from repro_torch.vx.spec import AccessSpec


def lower(op: str, specs, impl: str) -> prg.Program:
    """Build and validate the program for one access (width = len(specs))."""
    if isinstance(specs, AccessSpec):
        specs = (specs,)
    return prg.single(op, tuple(specs), impl)


def executor(program: prg.Program, specs):
    """The compiled callable for ``program`` (one entry per program key);
    ``specs`` are the live AccessSpec objects in transaction order."""
    if isinstance(specs, AccessSpec):
        specs = (specs,)
    txn = program.txn
    specs = tuple(specs)
    return PLANS.get(program.key(), lambda: _BUILDERS[txn.op](txn, specs))


def run(op: str, spec: AccessSpec, impl: str, *operands):
    """lower + compile + execute in one call (the verb tail)."""
    return executor(lower(op, spec, impl), spec)(*operands)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _gather_plan(txn: prg.Txn, specs: tuple):
    if txn.width > 1:
        return _gather_fused(txn, specs)
    spec, impl = specs[0], txn.impl
    s, o, vl = spec.stride, spec.offset, spec.vl
    if s < 0:
        from repro_torch.core import accessfuse
        return lambda w: accessfuse.bank_gather_strided(w, s, o, vl)
    if impl == "ref":
        from repro_torch.kernels import ref
        return lambda w: ref.gather_strided(w, s, o, vl)
    from repro_torch.kernels import strided
    return lambda w: strided.gather_strided(w, s, o, vl,
                                            compiled=impl == "kernel")


def _gather_fused(txn: prg.Txn, specs: tuple):
    """Width-N strided super-transaction over a stacked (N, ..., n) window:
    one shared plan when homogeneous, the fused kernel (B4) when
    heterogeneous, a stacked loop of oracles under ref.  The specs share
    (n, vl): ``vx.gather_many`` checks it, and the step scheduler groups
    by window shape and vl."""
    vl = specs[0].vl
    pairs = tuple((s.stride, s.offset) for s in specs)
    if txn.homogeneous:
        return _gather_plan(prg.Txn("gather.plan", txn.specs[:1], txn.impl),
                            specs[:1])
    if txn.impl == "ref":
        from repro_torch.kernels import ref

        def ref_many(windows):
            return torch.stack([ref.gather_strided(windows[a], s, o, vl)
                                for a, (s, o) in enumerate(pairs)])

        return ref_many
    from repro_torch.kernels import strided
    return lambda windows: strided.gather_strided_fused(
        windows, pairs, vl, compiled=txn.impl == "kernel")


def _scatter_plan(txn: prg.Txn, specs: tuple):
    spec, impl = specs[0], txn.impl
    s, o = spec.stride, spec.offset
    if s < 0:
        from repro_torch.core import accessfuse
        return lambda w, v: accessfuse.bank_scatter_strided(w, v, s, o)
    if impl == "ref":
        from repro_torch.kernels import ref
        return lambda w, v: ref.scatter_strided(w, v, s, o)
    from repro_torch.kernels import strided
    return lambda w, v: strided.scatter_strided(w, v, s, o,
                                                compiled=impl == "kernel")


def _bank_gather(txn: prg.Txn, specs: tuple):
    spec = specs[0]
    from repro_torch.core import accessfuse
    return lambda w, stride: accessfuse.bank_gather_strided(
        w, stride, spec.offset, spec.vl)


def _bank_scatter(txn: prg.Txn, specs: tuple):
    spec = specs[0]
    from repro_torch.core import accessfuse
    return lambda w, v, stride: accessfuse.bank_scatter_strided(
        w, v, stride, spec.offset)


def _seg_deint(txn: prg.Txn, specs: tuple):
    fields, impl = specs[0].fields, txn.impl
    if impl == "ref":
        from repro_torch.kernels import ref
        return lambda a: ref.deinterleave(a, fields)
    from repro_torch.kernels import segment
    return lambda a: segment.deinterleave(a, fields, fused=impl == "kernel")


def _seg_int(txn: prg.Txn, specs: tuple):
    impl = txn.impl
    if impl == "ref":
        from repro_torch.kernels import ref
        return lambda parts: ref.interleave(parts)
    from repro_torch.kernels import segment
    return lambda parts: segment.interleave(parts, fused=impl == "kernel")


def _idx_gather(txn: prg.Txn, specs: tuple):
    from repro_torch.kernels import shift_gather
    spec = specs[0]
    if spec.routing is not None:
        # Static routing: the plan stage.  The counts plan and its take-masks
        # are built ONCE here and the executor is memoized in vx.PLANS under
        # the spec key (routing included), so the payload pays one static
        # shift + one select per active layer, on every impl, as in the
        # reference (torch ops, no kernel: the masks are already constants).
        plan = shift_gather.host_plan(*spec.routing, gather=True)
        return lambda buf: shift_gather.shift_gather_static_plain(buf, plan)
    if txn.impl == "ref":
        # the GSN as torch ops on any device: the kernels' plain version
        return lambda buf, shift, valid: shift_gather.shift_gather_plain(
            buf, *shift_gather.device_counts(shift, valid, buf.shape[-1],
                                             buf.device))
    return shift_gather.shift_gather


def _idx_scatter(txn: prg.Txn, specs: tuple):
    from repro_torch.kernels import shift_scatter
    if txn.impl == "ref":
        # the SSN as torch ops on any device: the kernels' plain version
        from repro_torch.kernels.shift_gather import device_counts
        return lambda values, shift, valid: shift_scatter.shift_scatter_plain(
            values, *device_counts(shift, valid, values.shape[-1],
                                   values.device))
    return shift_scatter.shift_scatter


def _compact_rows(txn: prg.Txn, specs: tuple):
    cap = specs[0].capacity
    if txn.impl == "ref":
        from repro_torch.kernels import ref
        pack = ref.compact_rows
    else:
        from repro_torch.kernels import moe_compact
        pack = moe_compact.compact_rows

    def fn(rows, mask):
        packed, valid = pack(rows, mask)
        return packed[:cap], valid[:cap]

    return fn


def _compact_ids(txn: prg.Txn, specs: tuple):
    cap = specs[0].capacity
    from repro_torch.core import accessfuse
    return lambda mask: accessfuse.compact_indices(mask, cap)


def _compact_expand(txn: prg.Txn, specs: tuple):
    if txn.impl == "ref":
        from repro_torch.kernels import ref
        return ref.expand_rows
    from repro_torch.kernels import moe_compact
    return moe_compact.expand_rows


def _paged_gather(txn: prg.Txn, specs: tuple):
    """Page-table gather: ``out[.., j, ..] = pool[.., t[j//ps], j%ps, ..]``,
    entries ``< 0`` read as zeros.  Width-N fused transactions run on a
    stacked pool with ONE shared table — still a single gather (the page
    axis is found from the end)."""
    spec = specs[0]
    ps, pages, trail = spec.page_size, spec.pages, spec.trail

    def fn(pool, table):
        pa = spec.pool_axis(pool.ndim)
        if pool.shape[pa + 1] != ps:
            raise ValueError(
                f"pool axis {pa + 1} has {pool.shape[pa + 1]} lanes, "
                f"spec.page_size is {ps}")
        if table.shape[-1] != pages:
            raise ValueError(
                f"table has {table.shape[-1]} pages, spec.pages is {pages}")
        idx = table.clamp(min=0).reshape(-1).to(torch.int64)
        out = pool.index_select(pa, idx)
        out = out.reshape(pool.shape[:pa] + table.shape
                          + pool.shape[pa + 1:])
        # (*lead, *batch, pages, ps, *trail): zero unallocated pages
        vshape = (1,) * pa + tuple(table.shape) + (1,) + (1,) * trail
        out.masked_fill_((table < 0).reshape(vshape), 0)
        shape = (out.shape[:pa + table.ndim - 1] + (pages * ps,)
                 + out.shape[pa + table.ndim + 1:])
        return out.reshape(shape)

    return fn


def _paged_scatter(txn: prg.Txn, specs: tuple):
    """Decode append: one beat per table row, written through the page
    table at per-row position ``pos``.  Rows with ``pos < 0`` or an
    unallocated table entry are dropped.

    Updates the pool IN PLACE and returns it (the reference donates the
    cache to its jit'd step).  The reference drops rows with an
    out-of-bounds scatter; torch has no dropping scatter, so a dropped row
    rewrites the first kept row's (location, value) — or, when no row is
    kept, the value already at its own location — which leaves the pool
    exactly as the reference's and needs no host sync."""
    spec = specs[0]
    ps, trail = spec.page_size, spec.trail

    def fn(pool, values, table, pos):
        pa = spec.pool_axis(pool.ndim)
        P = pool.shape[pa]
        pos = pos.reshape(-1).to(torch.int64)
        nb = pos.shape[0]
        tab = table.reshape(nb, table.shape[-1]).to(torch.int64)
        vals = values.reshape((nb,) + tuple(values.shape[-trail:]
                                            if trail else ())).to(pool.dtype)
        oob = (pos < 0) | (pos >= spec.pages * ps)
        page = torch.where(oob, torch.zeros_like(pos), pos // ps)
        phys = torch.gather(tab, 1, page[:, None])[:, 0]
        keep = ~(oob | (phys < 0))
        ph = phys.clamp(0, P - 1)
        off = torch.where(keep, pos % ps, torch.zeros_like(pos))
        # index with a 1-element tensor, never a 0-dim one (that would
        # read the index back to the host)
        first = torch.argmax(keep.to(torch.int32)).reshape(1)
        any_keep = keep.any()
        tph = torch.where(keep, ph, torch.where(any_keep, ph[first], ph))
        toff = torch.where(keep, off, torch.where(any_keep, off[first], off))
        lead = (slice(None),) * pa
        current = pool[lead + (tph, toff)]          # (*lead, nb, *trail)
        kshape = (nb,) + (1,) * trail
        alt = torch.where(any_keep, vals[first].expand_as(vals), current)
        pool[lead + (tph, toff)] = torch.where(keep.reshape(kshape), vals,
                                               alt)
        return pool

    return fn


_BUILDERS = {
    "gather.plan": _gather_plan,
    "scatter.plan": _scatter_plan,
    "bank.gather": _bank_gather,
    "bank.scatter": _bank_scatter,
    "seg.deint": _seg_deint,
    "seg.int": _seg_int,
    "idx.gather": _idx_gather,
    "idx.scatter": _idx_scatter,
    "compact.rows": _compact_rows,
    "compact.ids": _compact_ids,
    "compact.expand": _compact_expand,
    "paged.gather": _paged_gather,
    "paged.scatter": _paged_scatter,
}
