"""Shared by kernels/moe_compact.py, kernels/shift_gather.py and
kernels/shift_scatter.py: the ctypes binding of ``csrc/indexed.cu``
(kernels B10-B14), built on first use (``_common.library``; a failed
build or a launch that returns a CUDA error raises), the plain versions'
operands of a compiled counts plan, and the launches of the raw networks:
:func:`launch_dyn` (B12 and B14: one derive kernel into a per-call
workspace, then a staged copy that reads only the input units holding a
source lane, and for B14 also writes the occupancy) and
:func:`launch_plan_copy` (B11 and B13: the same staged copy, for B13 with
the occupancy, through operands composed on the host from the plan's
table, :func:`plan_staged`, uploaded once per plan, device, staging unit
and element size by :func:`plan_staged_operands`).  :func:`dyn_sources`
runs the derive kernel alone, and :func:`staged_units_plain` is the twin
of the unit list it composes."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _common
from repro_torch.vx.cache import PLANS


def lib() -> ctypes.CDLL:
    lib = _common.library("indexed")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.route_rows.argtypes = [I, P, P, P, P, I, I, I, I, I, I, P]
        lib.route_rows.restype = I
        lib.shift_dyn.argtypes = [I, I, P, P, P, LL, I, P, P, P, I, I, P]
        lib.shift_dyn.restype = I
        lib.shift_table_copy.argtypes = [I, P, P, P, LL, I, P, P, P, I, I,
                                         I, I, I, P]
        lib.shift_table_copy.restype = I
        lib.shift_sources.argtypes = [I, I, P, P, I, I, P, P]
        lib.shift_sources.restype = I
        lib.indexed_error_string.argtypes = [I]
        lib.indexed_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        msg = lib.indexed_error_string(status).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {status} "
                           f"({msg})")


def plan_operands(plan, device: torch.device) -> dict:
    """A compiled plan's operands for the plain versions on ``device``,
    uploaded once per (plan, device): bool ``masks`` (S, n) and ``valid``
    (n,).  The key holds the plan itself (plans compare by identity and
    the counts-keyed plan cache returns the same object)."""
    def build():
        masks, valid, _ = _common.plan_operands(plan)
        return {"masks": torch.from_numpy(masks != 0).to(device),
                "valid": torch.from_numpy(valid[0] != 0).to(device)}

    return PLANS.get(("indexed.operands", plan, str(device)), build)


def _launch(x: torch.Tensor, wrapper, occupancy: bool, call):
    """Flatten CUDA ``x`` (contiguous, ``_common.check_cuda``) to (R, n)
    rows, allocate the payload (and with ``occupancy`` a bool occupancy
    of the same shape), launch through ``call(lib, flat, out, occ_ptr, R,
    n)`` and count it on ``wrapper``; no launch for an empty ``x``."""
    what = wrapper.__name__
    flat, _ = _common.flatten_rows(_common.check_cuda(x, what))
    R, n = flat.shape
    out = torch.empty_like(flat)
    occ = torch.empty(flat.shape, dtype=torch.bool, device=x.device) \
        if occupancy else None
    if R and n:
        lib_ = lib()
        check(lib_, call(lib_, flat, out, None if occ is None
                         else occ.data_ptr(), R, n), what)
        wrapper.launches += 1
    if occ is None:
        return out.reshape(x.shape)
    return out.reshape(x.shape), occ.reshape(x.shape)


def launch_dyn(x: torch.Tensor, shift: torch.Tensor, valid: torch.Tensor,
               wrapper, *, gsn: bool):
    """``x`` through the GSN (``gsn``, B12) or the SSN (B14, which also
    returns the occupancy) on the (n,) int32 count operands on the card:
    one derive kernel writes the ``(n,)`` source table
    (``_common.dyn_sources_plain``'s twin) and the staged copy's operands
    (:func:`staged_units_plain`'s twin) into a workspace from the caching
    allocator, then a staged copy reads only the listed units of every row
    and moves the rows through the remapped table, 0 where it holds -1
    (B14: and writes the occupancy in the same pass).  The tile is sized
    for the whole row: the list is known only on the card."""

    def call(lib_, flat, out, occ, R, n):
        elem = flat.element_size()
        blocks = _common.min_blocks(x.device)
        rows = _common.copy_tile_rows(R, n, n, 1, elem, blocks, units=n,
                                      occupancy=not gsn)
        work = torch.empty((3 * n + 1,), dtype=torch.int32, device=x.device)
        return lib_.shift_dyn(
            int(gsn), elem, flat.data_ptr(), out.data_ptr(), occ, R, n,
            shift.data_ptr(), valid.data_ptr(), work.data_ptr(), rows,
            blocks, _common.cuda_stream(x))

    return _launch(x, wrapper, not gsn, call)


def plan_table(plan) -> np.ndarray:
    """``where(plan.valid, plan.source, -1)`` as an (n,) int32 numpy array:
    for an occupied lane the plan's source is exactly the lane the routed
    network delivers there, conflicts included (the plan simulates the
    network's layer loop), and -1 where it leaves a lane unoccupied."""
    n = plan.n
    return np.where(np.asarray(plan.valid).reshape(n),
                    np.asarray(plan.source).reshape(n), -1).astype(np.int32)


def plan_staged(plan, per_unit: int, elem: int) -> dict:
    """B11's and B13's staged-copy operands, composed on the host from a
    compiled counts plan for rows of ``elem``-byte lanes staged in units of
    ``per_unit`` lanes: ``table``, :func:`plan_table`; from it, as
    :func:`staged_units_plain` composes them, the unit list ``units``
    ``(kmax,)`` (zero past its ``nunits[0]`` entries; ``kmax`` is at least
    1, so a plan that occupies no lane lists none and still launches) and
    the remapped table ``pos`` ``(n,)``, -1 where the plan leaves a lane
    unoccupied.  All int32 numpy arrays."""
    n = plan.n
    table = plan_table(plan)
    units, pos = staged_units_plain(table, n, per_unit, elem)
    kmax = max(len(units), 1)
    padded = np.zeros(kmax, np.int32)
    padded[:len(units)] = units
    return {"table": table, "units": padded, "kmax": kmax, "pos": pos,
            "nunits": np.array([len(units)], np.int32)}


def plan_staged_operands(plan, device: torch.device, per_unit: int,
                         elem: int) -> dict:
    """:func:`plan_staged` on ``device``: ``kmax`` and the int32 tensors
    ``units``, ``nunits`` and ``pos``, uploaded once per (plan, device,
    staging unit, element size) through the plan cache."""
    def build():
        host = plan_staged(plan, per_unit, elem)
        return {"kmax": host["kmax"], **{
            k: torch.from_numpy(host[k]).to(device)
            for k in ("units", "nunits", "pos")}}

    return PLANS.get(("indexed.staged", plan, str(device), per_unit, elem),
                     build)


def launch_plan_copy(x: torch.Tensor, plan, wrapper, *, occupancy: bool):
    """``x`` through compiled counts ``plan`` on the card: B11 (the
    gather plan) or, with ``occupancy``, B13 (the scatter plan, which also
    returns the occupancy).  One staged copy through the host-composed
    operands of :func:`plan_staged_operands`, launched plainly (no derive
    kernel, so nothing to wait for but ``x``'s writer, which the stream
    orders)."""

    def call(lib_, flat, out, occ, R, n):
        elem = flat.element_size()
        sunit = _common.copy_unit(n * elem, flat.data_ptr())
        ounit = _common.copy_unit(n * elem, out.data_ptr())
        st = plan_staged_operands(plan, x.device, sunit // elem, elem)
        blocks = _common.min_blocks(x.device)
        rows = _common.copy_tile_rows(R, st["kmax"] * sunit // elem, n, 1,
                                      elem, blocks, units=st["kmax"],
                                      occupancy=occupancy)
        return lib_.shift_table_copy(
            elem, flat.data_ptr(), out.data_ptr(), occ, R, n,
            st["pos"].data_ptr(), st["units"].data_ptr(),
            st["nunits"].data_ptr(), st["kmax"], rows, blocks, sunit, ounit,
            _common.cuda_stream(x))

    return _launch(x, wrapper, occupancy, call)


def staged_units_plain(table, n: int, per_unit: int,
                       elem: int) -> tuple[np.ndarray, np.ndarray]:
    """The staged copy's operands for an ``(n,)`` source table with -1 in
    unoccupied lanes, as B12's and B14's derive kernel composes them on
    the card (``dyn_staged_units`` in ``csrc/route_dyn.cuh``) and B11's
    and B13's wrappers on the host (:func:`plan_staged`):
    ``_common.staged_units`` of the occupied lanes' sources (every unit of
    the row when those touch every 32-byte sector), and the remapped table
    with -1 where ``table`` has it.  Both int32; no unit and all -1 where
    no lane is occupied."""
    src = np.asarray(table, np.int64)
    keep = src >= 0
    pos = np.full(n, -1, np.int32)
    if not keep.any():
        return np.zeros(0, np.int32), pos
    units, pos[keep] = _common.staged_units(src[keep], n, per_unit, elem)
    return units, pos


def dyn_sources(shift: torch.Tensor, valid: torch.Tensor, *, gsn: bool,
                elem: int, unit: int):
    """The derive kernel alone on the (n,) int32 count operands on the
    card, ``(table, pos, units)``: the ``(n,)`` int32 source table of the
    GSN (``gsn``, B12's) or the SSN (B14's), -1 where the routed validity
    is clear, and as their copy takes them for rows of ``elem``-byte lanes
    staged in ``unit``-byte units, the remapped table ``(n,)`` and the unit
    list ``(1 + n*elem/unit,)``: the count K, then K units, the rest
    unwritten.  Nothing is read back, so a CUDA graph can capture it.  For
    checking them against ``_common.dyn_sources_plain`` /
    :func:`staged_units_plain` and timing the derivation; not on any access
    path."""
    for t, what in ((shift, "shift"), (valid, "valid")):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device.type != "cuda":
            raise ValueError(f"dyn_sources: {what} must be (n,) int32 on a "
                             f"card")
    n = shift.shape[0]
    work = torch.empty((3 * n + 1,), dtype=torch.int32, device=shift.device)
    lib_ = lib()
    check(lib_, lib_.shift_sources(int(gsn), n, shift.contiguous().data_ptr(),
                                   valid.contiguous().data_ptr(), elem, unit,
                                   work.data_ptr(),
                                   _common.cuda_stream(work)),
          "dyn_sources")
    return work[:n], work[n:2 * n], work[2 * n:2 * n + 1 + n * elem // unit]
