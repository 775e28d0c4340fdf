"""Segment (AoS <-> SoA) access: wrappers for CUDA kernels B1, B2, B6
and B7.

Port of ``repro``'s ``kernels/segment.py``.  A segment access with
FIELDS=f over an n-lane beat is ONE lane permutation, routed through
compiled shift plans (core/shiftplan.py) either as one ``fused``
Benes/butterfly pass or as f ``per_field`` pruned passes; or, with
``fused=False`` (policy ``kernel_dynamic``), through f dynamic-count
networks whose counts come from ``core/scg.py``.

* :func:`deinterleave` (B1) and :func:`interleave` (B2) launch the
  hand-written kernels in ``csrc/segment.cu`` for CUDA tensors: one
  launch per call, whatever the field count or mode.  For CPU tensors they
  run the plain version, :func:`route_deinterleave` /
  :func:`route_interleave` (``shiftnet.apply_plan_operand``), which also
  serves as the kernels' yardstick on the card.
* B1 runs no plan layer on the card: a deinterleave plan's composed table
  (``ShiftPlan.source``: field f's lane j takes input lane f + j*fields)
  is known on the host, so each call is one permuted copy of the rows
  through it (``perm_copy_kernel``, ``csrc/perm_copy.cuh``).  The wrapper
  keeps the ``(fields, m)`` table (:func:`deinterleave_table`) in the plan
  cache, uploaded once per plan.
* B2 runs no plan layer either: an interleave plan's composed table
  (output lane f + j*fields takes lane j of field f) is known on the host,
  so each call is one interleave copy of the fields' rows through the
  ``(n,)`` table (:func:`interleave_table`; ``interleave_copy_kernel``,
  ``csrc/perm_copy.cuh``).  One plan-cache entry per ``(n, fields, plans,
  device)`` holds the uploaded table and what the launch needs, so a call
  pays one lookup and one short ctypes call.  B1 and B2 are launched
  without Programmatic Dependent Launch: the kernel before them wrote
  their input.
* ``fused=False`` hands the call to :func:`deinterleave_dynamic` (B6) and
  :func:`interleave_dynamic` (B7): one launch of the dynamic kernel for a
  CUDA tensor, or for a CPU tensor the plain version
  (:func:`deinterleave_dynamic_plain` / :func:`interleave_dynamic_plain`,
  the GSN / SSN of ``core/shiftnet.py`` per field).  Each launch is two
  CUDA kernels and counts as one: one derivation of the fields' source
  tables into a per-call workspace, then a table-driven copy under
  Programmatic Dependent Launch.  B6 takes B1's permuted copy; B7 takes
  B2's interleave copy, which merges the fields' ``(fields, n)`` tables as
  it loads them (a later field winning; the twin is
  :func:`interleave_dynamic_table`), with B2's host path: one cache entry
  per ``(n, fields, device)`` and one short ctypes call.

CUDA operands may be views: each wrapper reads a contiguous copy of a
non-contiguous one (``_common.check_cuda``).  Each wrapper counts
``calls`` (every entry, any device) and ``launches`` (kernel launches
only, counted where the kernel launched).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import scg, shiftnet, shiftplan
from repro_torch.kernels import _common
from repro_torch.vx.cache import PLANS

MAX_FIELDS = 16


# ---------------------------------------------------------------------------
# Plain versions (pure torch — the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def route_deinterleave(aos, masks, mode: str, plans, spans, fields: int):
    """(rows, n) AoS -> list of (rows, m) fields via compiled plans."""
    n = aos.shape[-1]
    m = n // fields
    if mode == "fused":
        plan = plans[0]
        x = aos if plan.n == n else torch.nn.functional.pad(
            aos, (0, plan.n - n))
        lo, hi = spans[0]
        routed = shiftnet.apply_plan_operand(x, masks[lo:hi], plan, axis=-1)
        return [routed[:, f * m:(f + 1) * m] for f in range(fields)]
    outs = []
    for f, plan in enumerate(plans):
        lo, hi = spans[f]
        routed = shiftnet.apply_plan_operand(aos, masks[lo:hi], plan,
                                             axis=-1)
        outs.append(routed[:, :m])
    return outs


def route_interleave(x, masks, valid, mode: str, plans, spans, fields: int):
    """(rows, n) concatenated SoA -> (rows, n) AoS beat."""
    rows, n = x.shape
    if mode == "fused":
        plan = plans[0]
        xp = x if plan.n == n else torch.nn.functional.pad(x, (0, plan.n - n))
        lo, hi = spans[0]
        routed = shiftnet.apply_plan_operand(xp, masks[lo:hi], plan, axis=-1)
        return routed[:, :n]
    m = n // fields
    acc = torch.zeros((rows, n), dtype=x.dtype, device=x.device)
    for f, plan in enumerate(plans):
        lo, hi = spans[f]
        padded = torch.nn.functional.pad(x[:, f * m:(f + 1) * m], (0, n - m))
        routed = shiftnet.apply_plan_operand(padded, masks[lo:hi], plan,
                                             axis=-1)
        acc = torch.where(valid[f][None, :], routed, acc)
    return acc


def deinterleave_plain(aos: torch.Tensor, fields: int, *,
                       plans: tuple | None = None) -> list[torch.Tensor]:
    """The plain version of kernel B1 on ``aos``'s own device: what
    :func:`deinterleave` computes, as torch ops."""
    n = aos.shape[-1]
    m = n // fields
    mode, pl = plans if plans is not None else \
        shiftplan.segment_deinterleave_plans(n, fields)
    flat, lead = _common.flatten_rows(aos)
    ops = _operands("deint", mode, pl, n, fields, aos.device)
    outs = route_deinterleave(flat, ops["masks"], mode, pl, ops["spans"],
                              fields)
    return [o.reshape(lead + (m,)) for o in outs]


def interleave_plain(soa: list[torch.Tensor], *,
                     plans: tuple | None = None) -> torch.Tensor:
    """The plain version of kernel B2 on the fields' own device."""
    fields = len(soa)
    m = soa[0].shape[-1]
    n = m * fields
    mode, pl = plans if plans is not None else \
        shiftplan.segment_interleave_plans(n, fields)
    lead = tuple(soa[0].shape[:-1])
    ops = _operands("int", mode, pl, n, fields, soa[0].device)
    out = route_interleave(torch.cat([t.reshape(-1, m) for t in soa],
                                     dim=-1), ops["masks"], ops["valid"],
                           mode, pl, ops["spans"], fields)
    return out.reshape(lead + (n,))


def deinterleave_dynamic_plain(aos: torch.Tensor,
                               fields: int) -> list[torch.Tensor]:
    """The plain version of kernel B6 on ``aos``'s own device: per field
    f, the GSN over ``scg.gather_counts(n, fields, f, m)``, lanes
    [0, m) of the routed beat (the reference's ``_deint_dyn_kernel``)."""
    n = aos.shape[-1]
    m = n // fields
    outs = []
    for f in range(fields):
        shift, valid = scg.gather_counts(n, fields, f, m, device=aos.device)
        res = shiftnet.gather_network(aos, shift, valid, axis=-1)
        outs.append(res.payload[..., :m].contiguous())
    return outs


def interleave_dynamic_plain(soa: list[torch.Tensor]) -> torch.Tensor:
    """The plain version of kernel B7 on the fields' own device: per field
    f, the zero-padded field through the SSN over ``scg.scatter_counts(n,
    fields, f, m)``, merged under the network's final occupancy into an
    accumulator that starts at 0 (the reference's ``_int_dyn_kernel``)."""
    fields = len(soa)
    m = soa[0].shape[-1]
    n = m * fields
    acc = soa[0].new_zeros(tuple(soa[0].shape[:-1]) + (n,))
    for f, part in enumerate(soa):
        padded = torch.nn.functional.pad(part, (0, n - m))
        shift, valid = scg.scatter_counts(n, fields, f, m,
                                          device=part.device)
        res = shiftnet.scatter_network(padded, shift, valid, axis=-1)
        acc = torch.where(res.valid, res.payload, acc)
    return acc


# ---------------------------------------------------------------------------
# Plan operands, uploaded once per (direction, mode, n, fields, device)
# ---------------------------------------------------------------------------

def _operands(direction: str, mode: str, plans, n: int, fields: int,
              device: torch.device) -> dict:
    key = ("seg.operands", direction, mode, n, fields, str(device))
    return PLANS.get(key, lambda: _build_operands(direction, mode, plans, n,
                                                  fields, device))


def deinterleave_table(mode: str, plans, n: int, fields: int) -> np.ndarray:
    """B1's table, composed from the host plans: ``(fields, m)`` int32,
    row f the input lane of each of field f's m output lanes
    (``plans[0].source[f*m + j]`` for the ``fused`` plan,
    ``plans[f].source[j]`` per field; ``f + j*fields`` for every
    deinterleave plan), -1 where a plan leaves the lane unoccupied or fills
    it from its zero padding (the copy writes 0 there)."""
    m = n // fields
    if mode == "fused":
        src = plans[0].source[:n].reshape(fields, m)
        valid = plans[0].valid[:n].reshape(fields, m)
    else:
        src = np.stack([p.source[:m] for p in plans])
        valid = np.stack([p.valid[:m] for p in plans])
    return np.where(valid & (src >= 0) & (src < n), src, -1).astype(np.int32)


def interleave_table(mode: str, plans, n: int, fields: int) -> np.ndarray:
    """B2's table, composed from the host plans: ``(n,)`` int32, entry c
    the lane of the concatenated fields, ``f*m + j``, that output lane c
    takes (``f*m + j`` at lane ``f + j*fields`` for every interleave
    plan).  For the ``fused`` plan, ``plans[0].source[:n]`` under
    ``.valid`` (the plan may be wider than n; a source in its zero
    padding, ``>= n``, is -1); per field, ``plans[f].source`` under
    ``.valid`` in field order, a later field winning, as
    :func:`route_interleave` merges (a source in field f's zero padding,
    ``>= m``, is -1).  -1 where no plan fills the lane (the copy writes 0
    there)."""
    m = n // fields
    if mode == "fused":
        src, valid = plans[0].source[:n], plans[0].valid[:n]
        return np.where(valid & (src >= 0) & (src < n), src,
                        -1).astype(np.int32)
    table = np.full(n, -1, np.int64)
    for f, p in enumerate(plans):
        src, valid = p.source[:n], p.valid[:n]
        table[valid] = np.where((src >= 0) & (src < m), f * m + src,
                                -1)[valid]
    return table.astype(np.int32)


def interleave_dynamic_table(n: int, fields: int) -> np.ndarray:
    """B7's merged table, the twin of what its interleave copy composes
    from the derive kernel's ``(fields, n)`` tables: ``(n,)`` int32, lane
    c taking lane ``f*m + src_f[c]`` of the concatenated fields from the
    last field f whose SSN source table on ``scg.scatter_counts(n, fields,
    f, m)`` (``_common.dyn_sources_plain``) occupies it, as
    :func:`interleave_dynamic_plain` merges; -1 where no field does."""
    m = n // fields
    table = np.full(n, -1, np.int64)
    for f in range(fields):
        src = _common.dyn_sources_plain(*scg.scatter_counts(n, fields, f, m),
                                        gsn=False).numpy()
        table = np.where((src >= 0) & (src < m), f * m + src, table)
    return table.astype(np.int32)


def _build_operands(direction: str, mode: str, plans, n: int, fields: int,
                    device: torch.device) -> dict:
    masks, spans = _common.stack_plan_masks(plans)
    valid = np.stack([p.valid for p in plans])
    ops = {"spans": spans,
           "masks": torch.from_numpy(masks != 0).to(device),
           "valid": torch.from_numpy(valid).to(device)}
    if device.type != "cuda":
        return ops
    if direction == "deint":
        # B1 copies each row through the plans' composed table
        ops["table"] = torch.from_numpy(
            deinterleave_table(mode, plans, n, fields)).to(device)
    return ops


def _interleave_launch(n: int, fields: int, plans,
                       device: torch.device) -> dict:
    """What B2's launch needs, one plan-cache entry per ``(n, fields,
    plans, device)`` (``plans`` None: the cost model's pick): the library
    and its bound entry point, the :func:`interleave_table` uploaded, the
    grid's block count and, filled as calls come, the tile height per
    (rows, element size).  The copy unit depends on the call's pointers,
    so the entry point picks it."""
    key = ("seg.interleave", n, fields, plans, device)
    return PLANS.get(key, lambda: _build_interleave_launch(n, fields, plans,
                                                           device))


def _build_interleave_launch(n: int, fields: int, plans,
                             device: torch.device) -> dict:
    mode, pl = plans if plans is not None else \
        shiftplan.segment_interleave_plans(n, fields)
    table = torch.from_numpy(interleave_table(mode, pl, n, fields)).to(device)
    lib = _lib()
    return {"lib": lib, "fn": lib.segment_interleave, "table": table,
            "table_ptr": table.data_ptr(),
            "blocks": _common.min_blocks(device), "rows": {}}


def _interleave_dyn_launch(n: int, fields: int,
                           device: torch.device) -> dict:
    """What B7's launch needs, one plan-cache entry per ``(n, fields,
    device)``: the library and its bound entry point, the grid's block
    count and, filled as calls come, the tile height per (rows, element
    size).  The fields' tables are derived per call into a workspace from
    the caching allocator (a cached one would be shared across streams)."""
    key = ("seg.interleave_dyn", n, fields, device)
    return PLANS.get(key, lambda: _build_interleave_dyn_launch(device))


def _build_interleave_dyn_launch(device: torch.device) -> dict:
    lib = _lib()
    return {"lib": lib, "fn": lib.segment_interleave_dyn,
            "blocks": _common.min_blocks(device), "rows": {}}


def _tile_rows(ent: dict, R: int, n: int, fields: int, elem: int) -> int:
    """The interleave copy's tile height for ``R`` rows of ``elem``-byte
    lanes, kept in the launch entry ``ent`` (B2's or B7's) once sized."""
    rows = ent["rows"].get((R, elem))
    if rows is None:
        rows = ent["rows"][R, elem] = _common.interleave_tile_rows(
            R, n, fields, elem, ent["blocks"])
    return rows


def _launch_interleave(ent: dict, what: str, soa: list, out: torch.Tensor,
                       R: int, m: int, table_ptr: int) -> None:
    """One ctypes call of ``ent``'s entry point (B2's or B7's): the fields'
    ``R`` rows of ``m`` lanes into ``out`` through the table at
    ``table_ptr`` (B2's upload, B7's workspace)."""
    fields = len(soa)
    elem = out.element_size()
    dense = [t.contiguous() for t in soa]
    status = ent["fn"](
        elem, (ctypes.c_void_p * fields)(*[t.data_ptr() for t in dense]),
        out.data_ptr(), fields, R, m, table_ptr,
        _tile_rows(ent, R, m * fields, fields, elem), ent["blocks"],
        _common.cuda_stream(out))
    _check(ent["lib"], status, what)


def _lib():
    lib = _common.library("segment")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segment_deinterleave.argtypes = [
            I, P, P, I, LL, I, I, P, I, I, I, P]
        lib.segment_deinterleave.restype = I
        lib.segment_interleave.argtypes = [I, P, P, I, LL, I, P, I, I, P]
        lib.segment_interleave.restype = I
        lib.segment_deinterleave_dyn.argtypes = [
            I, P, P, I, LL, I, I, P, I, I, I, P]
        lib.segment_deinterleave_dyn.restype = I
        lib.segment_deinterleave_sources.argtypes = [I, I, I, P, P]
        lib.segment_deinterleave_sources.restype = I
        lib.segment_interleave_dyn.argtypes = [I, P, P, I, LL, I, P, I, I, P]
        lib.segment_interleave_dyn.restype = I
        lib.segment_interleave_sources.argtypes = [I, I, I, P, P]
        lib.segment_interleave_sources.restype = I
        lib.segment_error_string.argtypes = [I]
        lib.segment_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.segment_error_string(status).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {status} "
                           f"({msg})")


def _copy_rows(entry: str, what: str, flat: torch.Tensor, outs: list,
               n: int, m: int, table: torch.Tensor) -> None:
    """One launch of ``entry`` for the wrapper ``what``: the permuted copy
    of the ``(R, n)`` rows of ``flat`` into the ``(R, m)`` ``outs`` through
    the ``(fields, m)`` int32 ``table``, B1's upload of the host plan
    (``segment_deinterleave``) or B6's workspace, which its derive kernel
    fills first (``segment_deinterleave_dyn``).  Tile height and copy unit
    as the copy's shared memory and the pointers allow."""
    lib = _lib()
    R, fields = flat.shape[0], len(outs)
    elem = flat.element_size()
    blocks = _common.min_blocks(flat.device)
    rows = _common.copy_tile_rows(R, n, n, fields, elem, blocks)
    unit = _common.copy_unit(m * elem, flat.data_ptr(),
                             *[o.data_ptr() for o in outs])
    ptrs = (ctypes.c_void_p * fields)(*[o.data_ptr() for o in outs])
    status = getattr(lib, entry)(
        elem, flat.data_ptr(), ptrs, fields, R, n, m, table.data_ptr(), rows,
        blocks, unit, _common.cuda_stream(flat))
    _check(lib, status, what)


# ---------------------------------------------------------------------------
# Deinterleave (segment load) — kernel B1
# ---------------------------------------------------------------------------

def deinterleave(aos: torch.Tensor, fields: int, *, fused: bool = True,
                 plans: tuple | None = None) -> list[torch.Tensor]:
    """(..., fields*m) -> fields x (..., m)   (segment load).

    Kernel B1: one permuted copy of the rows through the plans' composed
    table.  ``plans`` overrides the cost model's ``(mode, plans)`` pick
    (the card check forces the fused Benes plan, which the model never
    picks at penalty 6)."""
    deinterleave.calls += 1
    if not fused:
        return deinterleave_dynamic(aos, fields)
    n = aos.shape[-1]
    if fields < 1 or n % fields:
        raise ValueError(f"{n} lanes do not split into {fields} fields")
    m = n // fields
    if aos.device.type == "cpu":
        return deinterleave_plain(aos, fields, plans=plans)
    aos = _common.check_cuda(aos, "deinterleave")
    if fields > MAX_FIELDS:
        raise ValueError(f"deinterleave kernel takes <= {MAX_FIELDS} fields")
    mode, pl = plans if plans is not None else \
        shiftplan.segment_deinterleave_plans(n, fields)
    flat, lead = _common.flatten_rows(aos)
    ops = _operands("deint", mode, pl, n, fields, aos.device)
    R = flat.shape[0]
    outs = [torch.empty((R, m), dtype=aos.dtype, device=aos.device)
            for _ in range(fields)]
    if R and m:
        _copy_rows("segment_deinterleave", "deinterleave", flat, outs, n, m,
                   ops["table"])
        deinterleave.launches += 1
    return [o.reshape(lead + (m,)) for o in outs]


deinterleave.calls = 0
deinterleave.launches = 0


def deinterleave_dynamic(aos: torch.Tensor,
                         fields: int) -> list[torch.Tensor]:
    """(..., fields*m) -> fields x (..., m) through the dynamic-count
    networks (kernel B6, ``deinterleave(fused=False)``).  One launch per
    call, made of two CUDA kernels on the call's stream: one block per
    field derives that field's network from its counts and writes the
    source lane of each of its m output lanes into a small int32
    workspace; then a permuted copy moves every row through that table."""
    deinterleave_dynamic.calls += 1
    n = aos.shape[-1]
    if fields < 1 or n % fields:
        raise ValueError(f"{n} lanes do not split into {fields} fields")
    m = n // fields
    if aos.device.type == "cpu":
        return deinterleave_dynamic_plain(aos, fields)
    aos = _common.check_cuda(aos, "deinterleave_dynamic")
    if fields > MAX_FIELDS:
        raise ValueError(f"deinterleave kernel takes <= {MAX_FIELDS} fields")
    flat, lead = _common.flatten_rows(aos)
    R = flat.shape[0]
    outs = [torch.empty((R, m), dtype=aos.dtype, device=aos.device)
            for _ in range(fields)]
    if R and m:
        table = torch.empty((fields, m), dtype=torch.int32,
                            device=aos.device)
        _copy_rows("segment_deinterleave_dyn", "deinterleave_dynamic", flat,
                   outs, n, m, table)
        deinterleave_dynamic.launches += 1
    return [o.reshape(lead + (m,)) for o in outs]


deinterleave_dynamic.calls = 0
deinterleave_dynamic.launches = 0


def deinterleave_sources(n: int, fields: int, *,
                         device=None) -> torch.Tensor:
    """B6's derivation alone: the ``(fields, m)`` int32 source tables the
    derive kernel writes for an ``n``-lane beat (row f: the input lane of
    each of field f's m output lanes, -1 for a lane written as 0).  For
    checking the tables against ``_common.dyn_sources_plain``; not on any
    access path."""
    if fields < 1 or n % fields or not n:
        raise ValueError(f"{n} lanes do not split into {fields} fields")
    dev = torch.device("cuda") if device is None else torch.device(device)
    table = torch.empty((fields, n // fields), dtype=torch.int32,
                        device=dev)
    _common.check_cuda(table, "deinterleave_sources")
    lib = _lib()
    status = lib.segment_deinterleave_sources(n, n // fields, fields,
                                              table.data_ptr(),
                                              _common.cuda_stream(table))
    _check(lib, status, "deinterleave_sources")
    return table


def deinterleave_many(aos_list: list[torch.Tensor], fields: int, *,
                      fused: bool = True) -> list[list[torch.Tensor]]:
    """Step-fused segment load: A same-shape AoS arrays in ONE launch (the
    stack rides through :func:`deinterleave` as a new leading dim)."""
    outs = deinterleave(torch.stack(list(aos_list)), fields, fused=fused)
    return [[o[a] for o in outs] for a in range(len(aos_list))]


# ---------------------------------------------------------------------------
# Interleave (segment store) — kernel B2
# ---------------------------------------------------------------------------

def interleave(soa: list[torch.Tensor], *, fused: bool = True,
               plans: tuple | None = None) -> torch.Tensor:
    """fields x (..., m) -> (..., fields*m)   (segment store).

    Kernel B2: one interleave copy of the rows through the plans' composed
    table.  ``plans`` overrides the cost model's ``(mode, plans)`` pick
    (the card check forces the fused Benes plan)."""
    interleave.calls += 1
    if not fused:
        return interleave_dynamic(soa)
    soa = list(soa)
    fields = len(soa)
    x0 = _check_fields(soa)
    m = x0.shape[-1]
    n = m * fields
    dev = x0.device
    if dev.type == "cpu":
        return interleave_plain(soa, plans=plans)
    _common.check_cuda(x0, "interleave")
    if fields > MAX_FIELDS:
        raise ValueError(f"interleave kernel takes <= {MAX_FIELDS} fields")
    out = x0.new_empty(x0.shape[:-1] + (n,))
    R = x0.numel() // m if m else 0
    if R:
        ent = _interleave_launch(n, fields, plans, dev)
        _launch_interleave(ent, "interleave", soa, out, R, m,
                           ent["table_ptr"])
        interleave.launches += 1
    return out


interleave.calls = 0
interleave.launches = 0


def _check_fields(soa: list[torch.Tensor]) -> torch.Tensor:
    """The first field, once every field shares its shape, dtype and
    device (raises otherwise)."""
    x0 = soa[0]
    for t in soa[1:]:
        if t.shape != x0.shape or t.dtype != x0.dtype \
                or t.device != x0.device:
            raise ValueError("interleave fields must share shape, dtype "
                             "and device")
    return x0


def interleave_dynamic(soa: list[torch.Tensor]) -> torch.Tensor:
    """fields x (..., m) -> (..., fields*m) through the dynamic-count
    networks (kernel B7, ``interleave(fused=False)``).  One launch per
    call, made of two CUDA kernels on the call's stream: one block per
    field derives that field's SSN and writes the source lane of each of
    the n output lanes of its routed beat into a small int32 workspace;
    then B2's interleave copy merges those tables (a later field winning)
    and moves every row through them."""
    interleave_dynamic.calls += 1
    soa = list(soa)
    fields = len(soa)
    x0 = _check_fields(soa)
    m = x0.shape[-1]
    n = m * fields
    dev = x0.device
    if dev.type == "cpu":
        return interleave_dynamic_plain(soa)
    _common.check_cuda(x0, "interleave_dynamic")
    if fields > MAX_FIELDS:
        raise ValueError(f"interleave kernel takes <= {MAX_FIELDS} fields")
    out = x0.new_empty(x0.shape[:-1] + (n,))
    R = x0.numel() // m if m else 0
    if R:
        ent = _interleave_dyn_launch(n, fields, dev)
        table = torch.empty((fields, n), dtype=torch.int32, device=dev)
        _launch_interleave(ent, "interleave_dynamic", soa, out, R, m,
                           table.data_ptr())
        interleave_dynamic.launches += 1
    return out


interleave_dynamic.calls = 0
interleave_dynamic.launches = 0

def interleave_sources(n: int, fields: int, *, device=None) -> torch.Tensor:
    """B7's derivation alone: the ``(fields, n)`` int32 SSN source tables
    the derive kernel writes for an ``n``-lane beat (row f: the lane of
    field f's zero-padded beat that each output lane holds after its
    network, -1 where field f does not occupy the lane).  For checking the
    tables against ``_common.dyn_sources_plain`` and timing the
    derivation; not on any access path."""
    if fields < 1 or n % fields or not n:
        raise ValueError(f"{n} lanes do not split into {fields} fields")
    dev = torch.device("cuda") if device is None else torch.device(device)
    table = torch.empty((fields, n), dtype=torch.int32, device=dev)
    _common.check_cuda(table, "interleave_sources")
    lib = _lib()
    status = lib.segment_interleave_sources(n, n // fields, fields,
                                            table.data_ptr(),
                                            _common.cuda_stream(table))
    _check(lib, status, "interleave_sources")
    return table


KERNELS = (deinterleave, interleave)
DYNAMIC = (deinterleave_dynamic, interleave_dynamic)


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches``."""
    for fn in KERNELS + DYNAMIC:
        fn.calls = 0
        fn.launches = 0
