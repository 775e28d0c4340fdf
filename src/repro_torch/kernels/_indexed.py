"""Shared by kernels/moe_compact.py, kernels/shift_gather.py and
kernels/shift_scatter.py: the ctypes binding of ``csrc/indexed.cu``
(kernels B10-B14), built on first use (``_common.library``; a failed
build or a launch that returns a CUDA error raises), the device operands
of a compiled counts plan, and the launches of the raw networks:
:func:`launch_plan` (B11 / B13) and :func:`launch_dyn` (B12 / B14)."""
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
        lib.shift_plan.argtypes = [I, P, P, P, LL, I, P, I, I, P, I, P, I, P]
        lib.shift_plan.restype = I
        lib.shift_dyn.argtypes = [I, P, P, P, LL, I, P, P, I, I, P]
        lib.shift_dyn.restype = I
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
    """A compiled plan's operands on ``device``, uploaded once per (plan,
    device): bool ``masks`` (S, n) and ``valid`` (n,) for the plain
    versions, and on a card the packed bit rows and layer records of the
    B11 / B13 launch.  The key holds the plan itself (plans compare by
    identity and the counts-keyed plan cache returns the same object)."""
    return PLANS.get(("indexed.operands", plan, str(device)),
                     lambda: _build_plan_operands(plan, device))


def _build_plan_operands(plan, device: torch.device) -> dict:
    masks, valid, S = _common.plan_operands(plan)
    ops = {"masks": torch.from_numpy(masks != 0).to(device),
           "valid": torch.from_numpy(valid[0] != 0).to(device)}
    if device.type != "cuda":
        return ops
    layers, plan_lo = _common.layer_table([plan], [(0, S)], relative=False)
    packed = _common.pack_bits(masks)
    ops.update(
        S=S, words=packed.shape[1], nlayers=plan_lo[-1],
        masks_bits=torch.from_numpy(packed.view(np.int32)).to(device),
        valid_bits=torch.from_numpy(
            _common.pack_bits(valid).view(np.int32)).to(device),
        layers=torch.tensor(layers, dtype=torch.int32, device=device))
    return ops


def _launch(x: torch.Tensor, wrapper, occupancy: bool, call):
    """Flatten CUDA ``x`` to (R, n) rows, allocate the payload (and with
    ``occupancy`` a bool occupancy of the same shape), launch through
    ``call(lib, flat, out, occ_ptr, R, n)`` and count it on ``wrapper``;
    no launch for an empty ``x``."""
    what = wrapper.__name__
    _common.check_cuda(x, what)
    flat, _ = _common.flatten_rows(x)
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


def launch_plan(x: torch.Tensor, plan, wrapper, *, occupancy: bool):
    """``x`` through compiled ``plan`` on the card: B11, or with
    ``occupancy`` B13 (which also returns the occupancy)."""
    ops = plan_operands(plan, x.device)

    def call(lib_, flat, out, occ, R, n):
        elem = flat.element_size()
        rows = _common.rows_per_block(
            R, n, elem, (ops["S"] + 1) * ops["words"] * 4,
            _common.min_blocks(x.device), buffers=2)
        return lib_.shift_plan(
            elem, flat.data_ptr(), out.data_ptr(), occ, R, n,
            ops["masks_bits"].data_ptr(), ops["S"], ops["words"],
            ops["layers"].data_ptr(), ops["nlayers"],
            ops["valid_bits"].data_ptr(), rows, _common.cuda_stream(x))

    return _launch(x, wrapper, occupancy, call)


def launch_dyn(x: torch.Tensor, shift: torch.Tensor, valid: torch.Tensor,
               wrapper, *, gsn: bool, occupancy: bool):
    """``x`` through the dynamic-count network on the (n,) int32 count
    operands on the card: the GSN (``gsn``, B12) or the SSN (B14, with
    ``occupancy``)."""

    def call(lib_, flat, out, occ, R, n):
        elem = flat.element_size()
        rows = _common.rows_per_block(R, n, elem, _common.dyn_net_bytes(n),
                                      _common.min_blocks(x.device),
                                      buffers=2)
        return lib_.shift_dyn(elem, flat.data_ptr(), out.data_ptr(), occ,
                              R, n, shift.data_ptr(), valid.data_ptr(),
                              int(gsn), rows, _common.cuda_stream(x))

    return _launch(x, wrapper, occupancy, call)
