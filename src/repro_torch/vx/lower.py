"""Lowering — stage transitions of the vx pipeline, and program execution.

Port of ``repro``'s ``vx/lower.py``.  The replicated builders:
``gather.plan`` / ``scatter.plan`` (plain torch oracles under ``ref``, CUDA
kernels B3/B4/B5 under ``kernel``, B8/B9 under ``kernel_dynamic``; a
negative static stride goes to the plan bank), ``bank.gather`` /
``bank.scatter`` (the runtime-stride plan bank, torch ops under every
policy, as in the reference), ``seg.deint`` / ``seg.int`` (oracles under
``ref``, kernels B1/B2 under ``kernel``, B6/B7 under ``kernel_dynamic``),
``idx.gather`` (a static routing: the plan stage, torch ops under every
policy; runtime counts: the GSN under ``ref``, kernel B12 under both
kernel policies), ``idx.scatter`` (the SSN under ``ref``; B13 for host
counts and B14 for tensor counts under both kernel policies),
``compact.rows`` / ``compact.expand`` (the oracles under ``ref``, kernel
B10 otherwise), ``compact.ids`` (``accessfuse.compact_indices``, torch ops
under every policy) and ``paged.gather`` / ``paged.scatter`` over float
and quantized pools (plain torch ops: the reference has no Pallas kernel
for them either).  ``lower()`` builds a validated
:class:`~repro_torch.vx.program.Program`; ``executor()`` compiles it into
the callable that runs it, memoized in ``vx.PLANS`` under
``Program.key()`` (dtype, impl and shard layout included).

Sharded programs (``shard=``, a :class:`~repro_torch.vx.program.Shard` over
a ``DeviceMesh``) run on each rank's block of the operand: a ``DTensor``
placed as the shard says, or a plain full tensor the rank slices (as
``shard_map`` slices an unsharded input).  The strided gather and scatter
(``Shard.axis == -1``) run the rank's offset-rebased sub-access from
``shiftplan.shard_strided_rows`` through the SAME pipeline (B3 / B5 under
``kernel``, B8 / B9 under ``kernel_dynamic``); the gather merges the
disjoint output lanes with one ``psum`` (a select: one nonzero term per
lane), the scatter keeps the window sharded and sends nothing.  The
segment transposition (an outer axis) runs the unmodified plan on the
block (B1 / B2, B6 / B7).  The paged gather (the page axis) rebases the
table into the rank's page block, gathers the owned pages and merges with
one ``psum``.  A gather returns the replicated value; a scatter or a
transposition returns a ``DTensor`` placed like its operand.  The sharded
leaf is never gathered whole.  A paged append into a pool ``DTensor``
sharded on its page axis writes each beat only on the rank that owns its
physical page, through the table rebased as the gather's, and sends
nothing (a quantized pool's scales widen on the owner too).

The hand-written kernels have no backward.  Each builder wraps its kernel
branch in :func:`_guard`: that executor raises when gradients are on and
an operand requires grad, before the kernel wrapper runs (so before a
wrapper's CPU route too).  The reference cannot differentiate its Pallas
path either, and a kernel's output would otherwise come back detached and
silently cut the gradient.  Training runs under ``ref``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quant
from repro_torch.dist import sharding
from repro_torch.vx import program as prg
from repro_torch.vx.cache import PLANS
from repro_torch.vx.spec import AccessSpec, Strided

#: Ops that accept a sharded placement, and where the shard axis may sit.
_SHARDABLE = {
    "gather.plan": "lane",      # Shard.axis == -1: offset-rebased plans
    "scatter.plan": "lane",
    "seg.deint": "outer",       # Shard.axis != -1: shard-local permutation
    "seg.int": "outer",
    "paged.gather": "pool",     # Shard.axis == -(trail+2): the page axis
}


def lower(op: str, specs, impl: str,
          shard: "prg.Shard | None" = None) -> prg.Program:
    """Build and validate the program for one access (width = len(specs))."""
    if isinstance(specs, AccessSpec):
        specs = (specs,)
    specs = tuple(specs)
    if shard is not None:
        where = _SHARDABLE.get(op)
        if where is None:
            raise NotImplementedError(
                f"{op} has no sharded lowering (got shard={shard})")
        if where == "lane":
            if shard.axis != -1:
                raise ValueError(
                    f"{op} shards the accessed lane axis: Shard.axis must "
                    f"be -1, got {shard.axis}")
            for s in specs:
                if s.runtime:
                    raise NotImplementedError(
                        "runtime-stride bank dispatch over a sharded "
                        "window is not lowered; pin the stride or gather "
                        "replicated")
                if not shard.divides(s.n):
                    raise ValueError(
                        f"window of {s.n} lanes does not split into "
                        f"{shard.nshards} equal shards")
            if len(specs) != 1:
                raise NotImplementedError(
                    "fused strided transactions have no sharded lowering")
        elif where == "pool":
            want = -(specs[0].trail + 2)
            if shard.axis != want:
                raise ValueError(
                    f"{op} shards the page-pool axis: Shard.axis must be "
                    f"{want} for trail={specs[0].trail}, got {shard.axis}")
            if len(set(specs)) != 1:
                raise NotImplementedError(
                    "heterogeneous fused paged transactions have no "
                    "sharded lowering")
        elif shard.axis == -1:
            raise ValueError(
                f"{op} permutes the lane axis; shard an outer axis "
                f"(Shard.axis <= -2), not the beat itself")
    return prg.single(op, specs, impl, shard)


def executor(program: prg.Program, specs,
             shard: "prg.Shard | None" = None):
    """The compiled callable for ``program`` (one entry per program key);
    ``specs`` are the live AccessSpec objects in transaction order,
    ``shard`` the live placement matching the transaction's layout."""
    if isinstance(specs, AccessSpec):
        specs = (specs,)
    txn = program.txn
    specs = tuple(specs)
    return PLANS.get(program.key(), lambda: _build(txn, specs, shard))


def _build(txn: prg.Txn, specs: tuple, shard):
    if txn.layout is not None:
        return _build_sharded(txn, specs, shard)
    return _BUILDERS[txn.op](txn, specs)


def _wants_grad(x) -> bool:
    if isinstance(x, (list, tuple)):
        return any(_wants_grad(t) for t in x)
    return isinstance(x, torch.Tensor) and x.requires_grad


def _guard(txn: prg.Txn, fn):
    """``fn``, a call into a hand-written kernel's wrapper, refusing an
    operand that requires grad while gradients are on."""
    def guarded(*operands):
        if torch.is_grad_enabled() and _wants_grad(operands):
            raise RuntimeError(
                f"vx {txn.op} under impl={txn.impl!r} reaches a "
                f"hand-written kernel, which has no backward: the "
                f"reference cannot differentiate its Pallas path either "
                f"(jax.grad raises 'Linearization failed'); train under "
                f"vx.use('ref') or a config with kernel_impl='ref'")
        return fn(*operands)

    return guarded


def run(op: str, spec: AccessSpec, impl: str, *operands,
        shard: "prg.Shard | None" = None):
    """lower + compile + execute in one call (the verb tail)."""
    return executor(lower(op, spec, impl, shard), spec, shard)(*operands)


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
    return _guard(txn, lambda w: strided.gather_strided(
        w, s, o, vl, compiled=impl == "kernel"))


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
    return _guard(txn, lambda windows: strided.gather_strided_fused(
        windows, pairs, vl, compiled=txn.impl == "kernel"))


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
    return _guard(txn, lambda w, v: strided.scatter_strided(
        w, v, s, o, compiled=impl == "kernel"))


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
    return _guard(txn, lambda a: segment.deinterleave(
        a, fields, fused=impl == "kernel"))


def _seg_int(txn: prg.Txn, specs: tuple):
    impl = txn.impl
    if impl == "ref":
        from repro_torch.kernels import ref
        return lambda parts: ref.interleave(parts)
    from repro_torch.kernels import segment
    return _guard(txn, lambda parts: segment.interleave(
        parts, fused=impl == "kernel"))


def _idx_gather(txn: prg.Txn, specs: tuple):
    from repro_torch.kernels import shift_gather
    spec = specs[0]
    if spec.routing is not None:
        # Static routing: the plan stage.  The counts plan is compiled ONCE
        # here and the executor memoized in vx.PLANS under the spec key
        # (routing included).  Its table where(valid, source, -1) names the
        # lane the reference's layer loop delivers to each output lane, for
        # any counts, colliding ones included, so the payload pays one take
        # and one select on every impl (torch ops, no kernel).  The table
        # moves to a payload's device once per device.
        from repro_torch.kernels import _indexed
        table = torch.from_numpy(_indexed.plan_table(
            shift_gather.host_plan(*spec.routing, gather=True)))
        on_device = {}

        def planned(buf):
            if buf.device not in on_device:
                t = table.to(buf.device)
                on_device[buf.device] = (t >= 0, t.clamp(min=0).long())
            keep, src = on_device[buf.device]
            return torch.where(keep, torch.gather(buf, -1,
                                                  src.expand(buf.shape)), 0)

        return planned
    if txn.impl == "ref":
        # the GSN as torch ops on any device: the kernels' plain version
        return lambda buf, shift, valid: shift_gather.shift_gather_plain(
            buf, *shift_gather.device_counts(shift, valid, buf.shape[-1],
                                             buf.device))
    return _guard(txn, shift_gather.shift_gather)


def _idx_scatter(txn: prg.Txn, specs: tuple):
    from repro_torch.kernels import shift_scatter
    if txn.impl == "ref":
        # the SSN as torch ops on any device: the kernels' plain version
        from repro_torch.kernels.shift_gather import device_counts
        return lambda values, shift, valid: shift_scatter.shift_scatter_plain(
            values, *device_counts(shift, valid, values.shape[-1],
                                   values.device))
    return _guard(txn, shift_scatter.shift_scatter)


def _compact_rows(txn: prg.Txn, specs: tuple):
    cap = specs[0].capacity
    if txn.impl == "ref":
        from repro_torch.kernels import ref
        pack = ref.compact_rows
    else:
        from repro_torch.kernels import moe_compact
        pack = _guard(txn, moe_compact.compact_rows)

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
    return _guard(txn, moe_compact.expand_rows)


def _put_kept(dst: torch.Tensor, lead: tuple, idx: tuple,
              rows: torch.Tensor, keep: torch.Tensor) -> None:
    """``dst[lead + idx] = rows`` for the kept rows only (``idx``: one
    ``(nb,)`` index per indexed axis, ``rows`` leading with ``nb``).  The
    reference drops rows with an out-of-bounds scatter; torch has no
    dropping scatter, so a dropped row rewrites the first kept row's
    (location, value) or, when no row is kept, the value already at its
    own location.  That leaves ``dst`` exactly as the reference's and
    needs no host sync."""
    # index with a 1-element tensor, never a 0-dim one (that would read
    # the index back to the host)
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    any_keep = keep.any()
    current = dst[lead + idx]
    idx = tuple(torch.where(keep, i, torch.where(any_keep, i[first], i))
                for i in idx)
    alt = torch.where(any_keep, rows[first].expand_as(rows), current)
    kshape = (keep.shape[0],) + (1,) * (rows.ndim - 1)
    dst[lead + idx] = torch.where(keep.reshape(kshape), rows, alt)


def _paged_gather(txn: prg.Txn, specs: tuple):
    """Page-table gather: ``out[.., j, ..] = pool[.., t[j//ps], j%ps, ..]``,
    entries ``< 0`` read as zeros.  Width-N fused transactions run on a
    stacked pool with ONE shared table — still a single gather (the page
    axis is found from the end).

    QUANTIZED specs (``scale_dtype`` set) take the per-page scale side
    tensor ``(*lead, P, *trail[:-1])`` as an extra operand and dequantize
    in the same program: the pages' values times each page's scale, and
    only then the validity mask, through ``where`` (never a multiply by
    the mask: garbage on a never-written fp8 page can be NaN, and ``0 *
    NaN`` leaks).  The reference looks the scale up with a one-hot
    contraction; the port takes it by index, through the same clamped
    table as the pages.  Both give the same bits, because the scales are
    finite and non-negative, so the contraction's one nonzero term is the
    page's scale."""
    spec = specs[0]
    ps, pages, trail = spec.page_size, spec.pages, spec.trail

    def check(pool, table):
        pa = spec.pool_axis(pool.ndim)
        if pool.shape[pa + 1] != ps:
            raise ValueError(
                f"pool axis {pa + 1} has {pool.shape[pa + 1]} lanes, "
                f"spec.page_size is {ps}")
        if table.shape[-1] != pages:
            raise ValueError(
                f"table has {table.shape[-1]} pages, spec.pages is {pages}")
        return pa

    def pages_of(t, pa, table):
        """``t``'s pages through the table: ``(*lead, *batch, pages,
        ...)``."""
        idx = table.clamp(min=0).reshape(-1).to(torch.int64)
        out = quant.raw(t).index_select(pa, idx).view(t.dtype)
        return out.reshape(t.shape[:pa] + table.shape + t.shape[pa + 1:])

    def merged(out, pa, table):
        vshape = (1,) * pa + tuple(table.shape) + (1,) + (1,) * trail
        out = torch.where((table >= 0).reshape(vshape), out, 0)
        shape = (out.shape[:pa + table.ndim - 1] + (pages * ps,)
                 + out.shape[pa + table.ndim + 1:])
        return out.reshape(shape)

    if spec.quantized:
        def qfn(pool, scales, table):
            pa = check(pool, table)
            want = pool.shape[:pa + 1] + pool.shape[pa + 2:-1]
            if tuple(scales.shape) != want:
                raise ValueError(
                    f"scales shape {tuple(scales.shape)} != {want} (per "
                    f"page, per trail dim except the last) for pool "
                    f"{tuple(pool.shape)}")
            s = pages_of(scales, pa, table).unsqueeze(pa + table.ndim)
            if trail:
                s = s.unsqueeze(-1)         # shared last trail dim
            return merged(pages_of(pool, pa, table).to(s.dtype) * s, pa,
                          table)

        return qfn

    def fn(pool, table):
        pa = check(pool, table)
        return merged(pages_of(pool, pa, table), pa, table)

    return fn


def _paged_scatter(txn: prg.Txn, specs: tuple):
    """Decode append: one beat per table row, written through the page
    table at per-row position ``pos``.  Rows with ``pos < 0``, with ``pos``
    past the end or on an unallocated page are dropped (``_put_kept``).

    Updates the pool IN PLACE and returns it (the reference donates the
    cache to its jit'd step).

    QUANTIZED specs append in three phases with a MONOTONE per-page scale
    (a page's scale only ever widens, so shared copy-on-write prefix
    pages are never rewritten):

    1. scatter-max the beat's max-abs scale into the page's scale row;
    2. rescale the page's RESIDENT values to the widened scale (``ratio =
       s_old / s_new <= 1``; a fresh page, ``s_old == 0``, zeroes whatever
       was resident).  Rows hitting the same physical page (a chunked
       prefill writes up to ``ps`` beats into one page in one scatter)
       write IDENTICAL content here: every read (``s_old``, the final
       scale, the resident page, each a copy) comes before the first
       write, so duplicate indices in one put are safe;
    3. quantize each beat at the final page scale and write it at its own
       ``(page, offset)``, as the float arm does.

    Updates pool and scales in place and returns ``(pool, scales)``."""
    spec = specs[0]
    ps, trail = spec.page_size, spec.trail

    def rows_of(pool, values, table, pos):
        """The pool's block this rank writes (the whole pool unless it is
        a ``DTensor`` sharded on its page axis) and the flattened rows:
        (nb, *trail) values, the page within the block (clamped into it),
        the in-page offset and the kept mask (a row whose page another
        rank owns is not kept)."""
        pa = spec.pool_axis(pool.ndim)
        local, base, nl = sharding.owned_block(pool, pa)
        pos = sharding.replicated(pos).reshape(-1).to(torch.int64)
        nb = pos.shape[0]
        table = sharding.replicated(table)
        tab = table.reshape(nb, table.shape[-1]).to(torch.int64)
        vals = sharding.replicated(values)
        vals = vals.reshape((nb,) + tuple(vals.shape[-trail:]
                                          if trail else ()))
        oob = (pos < 0) | (pos >= spec.pages * ps)
        page = torch.where(oob, 0, pos // ps)
        phys = torch.gather(tab, 1, page[:, None])[:, 0] - base
        keep = ~(oob | (phys < 0) | (phys >= nl))
        off = torch.where(keep, pos % ps, 0)
        return local, vals, phys.clamp(0, nl - 1), off, keep

    if spec.quantized:
        def qfn(pool, scales, values, table, pos):
            if spec.pool_axis(pool.ndim) != 0:
                raise NotImplementedError(
                    "quantized paged scatter wants the page axis leading "
                    "(no lead dims): per-lead beat scales have no "
                    "broadcast rule here")
            if trail < 1:
                raise NotImplementedError(
                    "quantized paged scatter needs >= 1 trailing dim "
                    "(the max-abs scale reduces over the last)")
            dst, vals, safe, off, keep = rows_of(pool, values, table, pos)
            scl, _, _ = sharding.owned_block(scales, 0)
            kb = keep.reshape((-1,) + (1,) * (trail - 1))
            # 1. widen: the beat's scale per (row, *trail[:-1]); a dropped
            # row takes its page's own scale, which leaves it as it was
            s_beat = quant.scale_for(vals, pool.dtype, axis=-1)
            s_old = scl[safe]
            wide = torch.where(kb, torch.maximum(s_old, s_beat), s_old)
            scl.scatter_reduce_(
                0, safe.reshape((-1,) + (1,) * (trail - 1)).expand_as(wide),
                wide, "amax")
            s_fin = scl[safe]
            # 2. rescale the resident values to the widened scale
            on = s_fin > 0
            ratio = torch.where(on, s_old / torch.where(on, s_fin, 1.0),
                                1.0)
            rb = ratio.unsqueeze(1).unsqueeze(-1)
            dst = quant.raw(dst)
            resident = dst[safe].view(pool.dtype).to(rb.dtype)
            _put_kept(dst, (), (safe,),
                      quant.raw(quant.requantize(resident * rb, pool.dtype)),
                      keep)
            # 3. quantize the beat at the final page scale (safe divide:
            # an all-zero beat on a fresh page keeps scale 0 and writes 0)
            _put_kept(dst, (), (safe, off),
                      quant.raw(quant.quantize(vals, s_fin.unsqueeze(-1),
                                          pool.dtype)), keep)
            return pool, scales

        return qfn

    def fn(pool, values, table, pos):
        dst, vals, ph, off, keep = rows_of(pool, values, table, pos)
        lead = (slice(None),) * spec.pool_axis(pool.ndim)
        _put_kept(dst, lead, (ph, off), vals.to(pool.dtype), keep)
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


# ---------------------------------------------------------------------------
# Sharded builders: each rank runs its block (module docstring)
# ---------------------------------------------------------------------------

def _axis_spec(ndim: int, ax: int, shard: prg.Shard) -> "sharding.P":
    return sharding.P(*[shard.axes if i == ax else None
                        for i in range(ndim)])


def _block(x, ax: int, shard: prg.Shard) -> torch.Tensor:
    """The rank's block of ``x`` sharded on dim ``ax`` over the shard."""
    return sharding.local_block(x, shard.mesh, _axis_spec(x.ndim, ax, shard))


def _sub_strided(op: str, spec: Strided, impl: str, stride: int, cnt: int,
                 loff: int, nl: int):
    """The shard-local executor: the SAME pipeline on the offset-rebased
    sub-spec (its program lands in vx.PLANS like any other).  ``stride``
    is the Reverser-normalized (positive) stride."""
    sub = dataclasses.replace(spec, n=nl, stride=stride, offset=loff,
                              vl=cnt)
    return executor(lower(op, sub, impl), sub)


def _rank_rows(txn: prg.Txn, spec: Strided, shard: prg.Shard, op: str):
    """(rev, lo, cnt, sub): the Reverser flag and this rank's rebased
    sub-access (``sub`` None where the access misses the rank's block)."""
    from repro_torch.core import shiftplan
    s, o, vl = spec.stride, spec.offset, spec.vl
    rev = s < 0
    if rev:                      # Reverser: plan on the flipped lane order
        o, s = o + (vl - 1) * s, -s
    R = shard.nshards
    nl = spec.n // R
    lo, cnt, loff = shiftplan.shard_strided_rows(spec.n, s, o, vl,
                                                 R)[shard.index()]
    sub = None if cnt == 0 else _sub_strided(op, spec, txn.impl, s, cnt,
                                             loff, nl)
    return rev, lo, cnt, sub


def _sharded_gather_plan(txn: prg.Txn, specs: tuple, shard: prg.Shard):
    spec = specs[0]
    vl = spec.vl
    rev, lo, cnt, sub = _rank_rows(txn, spec, shard, "gather.plan")

    def fn(w):
        x = _block(w, w.ndim - 1, shard)
        out = x.new_zeros(x.shape[:-1] + (vl,))
        if sub is not None:
            out[..., lo:lo + cnt] = sub(x)
        # output lanes are disjoint across shards: psum == select
        out = sharding.psum(out, shard.mesh, shard.axes)
        return torch.flip(out, dims=(-1,)) if rev else out

    return fn


def _sharded_scatter_plan(txn: prg.Txn, specs: tuple, shard: prg.Shard):
    spec = specs[0]
    rev, lo, cnt, sub = _rank_rows(txn, spec, shard, "scatter.plan")

    def fn(w, v):
        ax = w.ndim - 1
        x = _block(w, ax, shard)
        v = sharding.replicated(v)
        if rev:
            v = torch.flip(v, dims=(-1,))
        out = x.clone() if sub is None else sub(x, v[..., lo:lo + cnt])
        return sharding.from_local(out, shard.mesh,
                                   _axis_spec(w.ndim, ax, shard), w.shape)

    return fn


def _outer_axis(ndim: int, shard: prg.Shard, what: str) -> int:
    ax = ndim + shard.axis
    if ax < 0 or ax == ndim - 1:
        raise ValueError(f"shard axis {shard.axis} out of range for a "
                         f"rank-{ndim} {what} operand")
    return ax


def _sharded_seg_deint(txn: prg.Txn, specs: tuple, shard: prg.Shard):
    local = _seg_deint(txn, specs)

    def fn(aos):
        ax = _outer_axis(aos.ndim, shard, "AoS")
        if aos.shape[ax] % shard.nshards:
            raise ValueError(
                f"operand dim {aos.shape[ax]} does not split into "
                f"{shard.nshards} shards")
        outs = local(_block(aos, ax, shard))
        spec = _axis_spec(aos.ndim, ax, shard)
        shape = tuple(aos.shape[:-1]) + (outs[0].shape[-1],)
        return [sharding.from_local(o, shard.mesh, spec, shape)
                for o in outs]

    return fn


def _sharded_seg_int(txn: prg.Txn, specs: tuple, shard: prg.Shard):
    local = _seg_int(txn, specs)

    def fn(parts):
        parts = list(parts)
        ndim = parts[0].ndim
        ax = _outer_axis(ndim, shard, "SoA")
        out = local([_block(p, ax, shard) for p in parts])
        shape = tuple(parts[0].shape[:-1]) + (out.shape[-1],)
        return sharding.from_local(out, shard.mesh,
                                   _axis_spec(ndim, ax, shard), shape)

    return fn


def _sharded_paged_gather(txn: prg.Txn, specs: tuple, shard: prg.Shard):
    """Shard-local page gathers over a pool sharded on the page axis.

    Each rank owns a contiguous block of ``P // R`` physical pages; the
    (replicated) table is rebased into the local page-id space, entries
    owned elsewhere become ``-1`` (the replicated builder zeroes them),
    and ONE ``psum`` merges the disjoint per-rank contributions (every
    physical page has exactly one owner, so the psum is a select).
    Quantized pools shard the scale side tensor on the SAME page axis, so
    the inner quantized gather runs unchanged on the local page block with
    its local scales."""
    spec = specs[0]
    inner = _paged_gather(txn, specs)

    def fn(pool, *rest):
        scales, table = rest if spec.quantized else (None, rest[0])
        pa = spec.pool_axis(pool.ndim)
        P, R = pool.shape[pa], shard.nshards
        if P % R:
            raise ValueError(
                f"pool of {P} pages does not split into {R} equal shards")
        nl = P // R
        tb = sharding.replicated(table)
        local = tb - shard.index() * nl
        owned = (tb >= 0) & (local >= 0) & (local < nl)
        lt = torch.where(owned, local, -1)
        lp = _block(pool, pa, shard)
        if spec.quantized:
            out = inner(lp, _block(scales, pa, shard), lt)
        else:
            out = inner(lp, lt)
        return sharding.psum(out, shard.mesh, shard.axes)

    return fn


_SHARDED_BUILDERS = {
    "gather.plan": _sharded_gather_plan,
    "scatter.plan": _sharded_scatter_plan,
    "seg.deint": _sharded_seg_deint,
    "seg.int": _sharded_seg_int,
    "paged.gather": _sharded_paged_gather,
}


def _build_sharded(txn: prg.Txn, specs: tuple, shard):
    if shard is None or shard.layout() != txn.layout:
        raise ValueError(
            f"program was lowered for layout {txn.layout} but executor "
            f"got {None if shard is None else shard.layout()}")
    if txn.op in ("gather.plan", "scatter.plan", "paged.gather") \
            and not txn.homogeneous:
        # a fused heterogeneous group reaches here through program.fuse
        # (per-access lower() only sees width 1): the sharded builder
        # compiles ONE rebased plan, which would silently apply spec 0's
        # pattern to every stacked row
        raise NotImplementedError(
            "heterogeneous fused strided transactions have no sharded "
            "lowering; gather replicated or split the group")
    return _SHARDED_BUILDERS[txn.op](txn, specs, shard)
