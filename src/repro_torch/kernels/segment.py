"""Segment (AoS <-> SoA) access: wrappers for CUDA kernels B1, B2, B6
and B7.

Port of ``repro``'s ``kernels/segment.py``.  A segment access with
FIELDS=f over an n-lane beat is ONE lane permutation, routed through
compiled shift plans (core/shiftplan.py) either as one ``fused``
Benes/butterfly pass or as f ``per_field`` pruned passes; or, with
``fused=False`` (policy ``kernel_dynamic``), through f dynamic-count
networks whose counts come from ``core/scg.py``.

* :func:`deinterleave` (B1) and :func:`interleave` (B2) launch the
  hand-written plan kernels in ``csrc/segment.cu`` for CUDA tensors: one
  launch per call, whatever the field count or mode.  For CPU tensors they
  run the plain version, :func:`route_deinterleave` /
  :func:`route_interleave` (``shiftnet.apply_plan_operand``), which also
  serves as the kernels' yardstick on the card.
* ``fused=False`` hands the call to :func:`deinterleave_dynamic` (B6) and
  :func:`interleave_dynamic` (B7): one launch of the dynamic kernel for a
  CUDA tensor, or for a CPU tensor the plain version
  (:func:`deinterleave_dynamic_plain` / :func:`interleave_dynamic_plain`,
  the GSN / SSN of ``core/shiftnet.py`` per field).

Each wrapper counts ``calls`` (every entry, any device) and ``launches``
(kernel launches only, counted where the kernel launched).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import scg, shiftnet, shiftplan
from repro_torch.kernels import _common
from repro_torch.vx.cache import PLANS

MAX_FIELDS = 16
# the tile sizing shared with the strided kernels (kernels/_common.py)
SMEM_BUDGET = _common.SMEM_BUDGET
rows_per_block = _common.rows_per_block


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
    return PLANS.get(key, lambda: _build_operands(mode, plans, device))


def _build_operands(mode: str, plans, device: torch.device) -> dict:
    masks, spans = _common.stack_plan_masks(plans)
    valid = np.stack([p.valid for p in plans])
    ops = {"spans": spans,
           "masks": torch.from_numpy(masks != 0).to(device),
           "valid": torch.from_numpy(valid).to(device)}
    if device.type != "cuda":
        return ops
    layers, plan_lo = _common.layer_table(plans, spans, relative=False)
    packed = _common.pack_bits(masks)
    ops.update(
        width=plans[0].n, S=packed.shape[0], words=packed.shape[1],
        nplans=len(plans),
        masks_bits=torch.from_numpy(packed.view(np.int32)).to(device),
        valid_bits=torch.from_numpy(
            _common.pack_bits(valid).view(np.int32)).to(device),
        layers=torch.tensor(layers, dtype=torch.int32, device=device),
        plan_lo=torch.tensor(plan_lo, dtype=torch.int32, device=device))
    return ops


def _lib():
    lib = _common.library("segment")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segment_deinterleave.argtypes = [
            I, P, P, I, LL, I, I, I, I, P, I, I, P, P, I, I, P]
        lib.segment_deinterleave.restype = I
        lib.segment_interleave.argtypes = [
            I, P, P, I, LL, I, I, I, I, P, I, I, P, P, I, P, I, P]
        lib.segment_interleave.restype = I
        lib.segment_deinterleave_dyn.argtypes = [I, P, P, I, LL, I, I, I, P]
        lib.segment_deinterleave_dyn.restype = I
        lib.segment_interleave_dyn.argtypes = [I, P, P, I, LL, I, I, I, P]
        lib.segment_interleave_dyn.restype = I
        lib.segment_error_string.argtypes = [I]
        lib.segment_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.segment_error_string(status).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {status} "
                           f"({msg})")


# ---------------------------------------------------------------------------
# Deinterleave (segment load) — kernel B1
# ---------------------------------------------------------------------------

def deinterleave(aos: torch.Tensor, fields: int, *, fused: bool = True,
                 plans: tuple | None = None) -> list[torch.Tensor]:
    """(..., fields*m) -> fields x (..., m)   (segment load).

    ``plans`` overrides the cost model's ``(mode, plans)`` pick (the card
    check forces the fused Benes plan, which the model never picks at
    penalty 6)."""
    deinterleave.calls += 1
    if not fused:
        return deinterleave_dynamic(aos, fields)
    n = aos.shape[-1]
    if fields < 1 or n % fields:
        raise ValueError(f"{n} lanes do not split into {fields} fields")
    m = n // fields
    if aos.device.type == "cpu":
        return deinterleave_plain(aos, fields, plans=plans)
    _common.check_cuda(aos, "deinterleave")
    mode, pl = plans if plans is not None else \
        shiftplan.segment_deinterleave_plans(n, fields)
    flat, lead = _common.flatten_rows(aos)
    ops = _operands("deint", mode, pl, n, fields, aos.device)
    if fields > MAX_FIELDS:
        raise ValueError(f"deinterleave kernel takes <= {MAX_FIELDS} fields")
    R = flat.shape[0]
    outs = [torch.empty((R, m), dtype=aos.dtype, device=aos.device)
            for _ in range(fields)]
    if R:
        lib = _lib()
        elem = aos.element_size()
        rows = rows_per_block(R, ops["width"], elem,
                              ops["S"] * ops["words"] * 4,
                              _common.min_blocks(aos.device))
        ptrs = (ctypes.c_void_p * fields)(*[o.data_ptr() for o in outs])
        status = lib.segment_deinterleave(
            elem, flat.data_ptr(), ptrs, fields, R, n, m, ops["width"],
            int(mode == "fused"), ops["masks_bits"].data_ptr(), ops["S"],
            ops["words"], ops["layers"].data_ptr(),
            ops["plan_lo"].data_ptr(), ops["nplans"], rows,
            _common.cuda_stream(aos))
        _check(lib, status, "deinterleave")
        deinterleave.launches += 1
    return [o.reshape(lead + (m,)) for o in outs]


deinterleave.calls = 0
deinterleave.launches = 0


def deinterleave_dynamic(aos: torch.Tensor,
                         fields: int) -> list[torch.Tensor]:
    """(..., fields*m) -> fields x (..., m) through the dynamic-count
    networks (kernel B6, ``deinterleave(fused=False)``): one launch per
    call, each block deriving every field's network from its counts."""
    deinterleave_dynamic.calls += 1
    n = aos.shape[-1]
    if fields < 1 or n % fields:
        raise ValueError(f"{n} lanes do not split into {fields} fields")
    m = n // fields
    if aos.device.type == "cpu":
        return deinterleave_dynamic_plain(aos, fields)
    _common.check_cuda(aos, "deinterleave_dynamic")
    if fields > MAX_FIELDS:
        raise ValueError(f"deinterleave kernel takes <= {MAX_FIELDS} fields")
    flat, lead = _common.flatten_rows(aos)
    R = flat.shape[0]
    outs = [torch.empty((R, m), dtype=aos.dtype, device=aos.device)
            for _ in range(fields)]
    if R:
        lib = _lib()
        elem = aos.element_size()
        rows = rows_per_block(R, n, elem, _common.dyn_net_bytes(n),
                              _common.min_blocks(aos.device))
        ptrs = (ctypes.c_void_p * fields)(*[o.data_ptr() for o in outs])
        status = lib.segment_deinterleave_dyn(
            elem, flat.data_ptr(), ptrs, fields, R, n, m, rows,
            _common.cuda_stream(aos))
        _check(lib, status, "deinterleave_dynamic")
        deinterleave_dynamic.launches += 1
    return [o.reshape(lead + (m,)) for o in outs]


deinterleave_dynamic.calls = 0
deinterleave_dynamic.launches = 0


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
    """fields x (..., m) -> (..., fields*m)   (segment store)."""
    interleave.calls += 1
    if not fused:
        return interleave_dynamic(soa)
    soa = list(soa)
    fields = len(soa)
    x0 = _check_fields(soa)
    m = x0.shape[-1]
    n = m * fields
    if x0.device.type == "cpu":
        return interleave_plain(soa, plans=plans)
    for t in soa:
        _common.check_cuda(t, "interleave")
    mode, pl = plans if plans is not None else \
        shiftplan.segment_interleave_plans(n, fields)
    lead = tuple(x0.shape[:-1])
    flats = [t.reshape(-1, m) for t in soa]
    ops = _operands("int", mode, pl, n, fields, x0.device)
    if fields > MAX_FIELDS:
        raise ValueError(f"interleave kernel takes <= {MAX_FIELDS} fields")
    R = flats[0].shape[0]
    out = torch.empty((R, n), dtype=x0.dtype, device=x0.device)
    if R:
        lib = _lib()
        elem = x0.element_size()
        vrows = 0 if mode == "fused" else ops["nplans"]
        rows = rows_per_block(R, ops["width"], elem,
                              (ops["S"] + vrows) * ops["words"] * 4,
                              _common.min_blocks(x0.device))
        ptrs = (ctypes.c_void_p * fields)(*[f.data_ptr() for f in flats])
        status = lib.segment_interleave(
            elem, ptrs, out.data_ptr(), fields, R, n, m, ops["width"],
            int(mode == "fused"), ops["masks_bits"].data_ptr(), ops["S"],
            ops["words"], ops["layers"].data_ptr(),
            ops["plan_lo"].data_ptr(), ops["nplans"],
            ops["valid_bits"].data_ptr(), rows, _common.cuda_stream(x0))
        _check(lib, status, "interleave")
        interleave.launches += 1
    return out.reshape(lead + (n,))


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
    networks (kernel B7, ``interleave(fused=False)``): one launch per
    call."""
    interleave_dynamic.calls += 1
    soa = list(soa)
    fields = len(soa)
    x0 = _check_fields(soa)
    m = x0.shape[-1]
    n = m * fields
    if x0.device.type == "cpu":
        return interleave_dynamic_plain(soa)
    for t in soa:
        _common.check_cuda(t, "interleave_dynamic")
    if fields > MAX_FIELDS:
        raise ValueError(f"interleave kernel takes <= {MAX_FIELDS} fields")
    lead = tuple(x0.shape[:-1])
    flats = [t.reshape(-1, m) for t in soa]
    R = flats[0].shape[0]
    out = torch.empty((R, n), dtype=x0.dtype, device=x0.device)
    if R:
        lib = _lib()
        elem = x0.element_size()
        # the dynamic network plus one packed row: the fields' occupancy
        fixed = _common.dyn_net_bytes(n) + -(-n // 128) * 16
        rows = rows_per_block(R, n, elem, fixed,
                              _common.min_blocks(x0.device), buffers=2)
        ptrs = (ctypes.c_void_p * fields)(*[f.data_ptr() for f in flats])
        status = lib.segment_interleave_dyn(
            elem, ptrs, out.data_ptr(), fields, R, n, m, rows,
            _common.cuda_stream(x0))
        _check(lib, status, "interleave_dynamic")
        interleave_dynamic.launches += 1
    return out.reshape(lead + (n,))


interleave_dynamic.calls = 0
interleave_dynamic.launches = 0

KERNELS = (deinterleave, interleave)
DYNAMIC = (deinterleave_dynamic, interleave_dynamic)


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches``."""
    for fn in KERNELS + DYNAMIC:
        fn.calls = 0
        fn.launches = 0
