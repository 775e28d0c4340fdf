"""LSDO strided load/store: wrappers for CUDA kernels B3, B4, B5, B8 and
B9.

Port of ``repro``'s ``kernels/strided.py``.  The coalesced ``n``-lane
window is the memory transaction; the in-tile reorganization is a
ShiftPlan from core/shiftplan.py (pruned layers, constant take-masks, one
static shift + one select per layer), or, with ``compiled=False`` (policy
``kernel_dynamic``), the dynamic-count network on ``core/scg.py`` counts.

* :func:`gather_strided` (B3), :func:`gather_strided_fused` (B4) and
  :func:`scatter_strided` (B5) launch the hand-written kernels in
  ``csrc/strided.cu`` for CUDA tensors, one launch per call.  For CPU
  tensors they run the plain version (``*_plain``: the plan as torch ops
  through ``shiftnet.apply_plan_operand``, plus a slice, or a pad and a
  select), which is also the kernels' yardstick on the card.
* ``compiled=False`` hands the call to :func:`gather_strided_dynamic`
  (B8) and :func:`scatter_strided_dynamic` (B9): one launch of the dynamic
  kernel per access (A launches for a fused gather of A windows, as the
  reference loops), or for CPU tensors their plain versions on the GSN /
  SSN of ``core/shiftnet.py``.

A window the access does not fit (``offset + (vl-1)*stride >= n``, a
negative offset or a stride below 1) raises ``ValueError``.  Each wrapper
counts ``calls`` (every entry, any device) and ``launches`` (kernel
launches only, counted where the kernel launched).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import scg, shiftnet, shiftplan
from repro_torch.kernels import _common
from repro_torch.vx.cache import PLANS


def check_fits(n: int, stride: int, offset: int, vl: int) -> None:
    """Raise ValueError unless lanes ``offset + i*stride`` (i < vl) lie in
    an ``n``-lane window with a positive stride."""
    if stride < 1 or offset < 0 or (vl > 0 and offset + (vl - 1) * stride
                                    >= n):
        raise ValueError(f"strided access (stride={stride}, offset={offset}, "
                         f"vl={vl}) does not fit an {n}-lane window")


# ---------------------------------------------------------------------------
# Plan operands, uploaded once per (kind, plans, device)
# ---------------------------------------------------------------------------

def _operands(kind: str, n: int, pairs: tuple, vl: int,
              device: torch.device) -> dict:
    key = ("strided.operands", kind, n, pairs, vl, str(device))
    return PLANS.get(key, lambda: _build_operands(kind, n, pairs, vl, device))


def _build_operands(kind: str, n: int, pairs: tuple, vl: int,
                    device: torch.device) -> dict:
    make = shiftplan.gather_plan if kind == "gather" else \
        shiftplan.scatter_plan
    plans = tuple(make(n, s, o, vl) for s, o in pairs)
    masks, spans = _common.stack_plan_masks(plans)
    ops = {"plans": plans, "spans": spans,
           "masks": torch.from_numpy(masks != 0).to(device),
           "valid": torch.from_numpy(plans[0].valid).to(device)}
    if device.type != "cuda":
        return ops
    layers, plan_lo = _common.layer_table(plans, spans, relative=True)
    packed = _common.pack_bits(masks)
    mask_lo = [lo for lo, _ in spans] + [spans[-1][1]]
    ops.update(
        words=packed.shape[1], S=packed.shape[0],
        mask_rows=max(1, max(hi - lo for lo, hi in spans)),
        nlayers=plan_lo[-1],
        masks_bits=torch.from_numpy(packed.view(np.int32)).to(device),
        valid_bits=torch.from_numpy(_common.pack_bits(
            plans[0].valid.reshape(1, n)).view(np.int32)).to(device),
        layers=torch.tensor(layers, dtype=torch.int32, device=device),
        plan_lo=torch.tensor(plan_lo, dtype=torch.int32, device=device),
        mask_lo=torch.tensor(mask_lo, dtype=torch.int32, device=device))
    return ops


def _lib():
    lib = _common.library("strided")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.strided_gather.argtypes = [
            I, P, P, I, LL, I, I, P, I, P, P, P, I, I, P]
        lib.strided_gather.restype = I
        lib.strided_scatter.argtypes = [
            I, P, P, P, LL, I, I, P, I, I, P, I, P, I, P]
        lib.strided_scatter.restype = I
        lib.strided_gather_dyn.argtypes = [I, P, P, LL, I, I, I, I, I, P]
        lib.strided_gather_dyn.restype = I
        lib.strided_scatter_dyn.argtypes = [I, P, P, P, LL, I, I, I, I, I, P]
        lib.strided_scatter_dyn.restype = I
        lib.route_dyn_masks.argtypes = [I, I, I, I, I, P, P, I, P]
        lib.route_dyn_masks.restype = I
        lib.strided_error_string.argtypes = [I]
        lib.strided_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.strided_error_string(status).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {status} "
                           f"({msg})")


def _launch_gather(flat: torch.Tensor, A: int, R: int, n: int, vl: int,
                   ops: dict) -> torch.Tensor:
    """(A*R, n) windows -> (A*R, vl) through ``strided_gather`` (B3 for
    A == 1, B4 otherwise)."""
    out = torch.empty((A * R, vl), dtype=flat.dtype, device=flat.device)
    lib = _lib()
    elem = flat.element_size()
    rows = _common.rows_per_block(
        R, n, elem, ops["mask_rows"] * ops["words"] * 4,
        -(-_common.min_blocks(flat.device) // A), buffers=2)
    status = lib.strided_gather(
        elem, flat.data_ptr(), out.data_ptr(), A, R, n, vl,
        ops["masks_bits"].data_ptr(), ops["words"], ops["layers"].data_ptr(),
        ops["plan_lo"].data_ptr(), ops["mask_lo"].data_ptr(),
        ops["mask_rows"], rows, _common.cuda_stream(flat))
    _check(lib, status, "gather_strided" if A == 1 else
           "gather_strided_fused")
    return out


# ---------------------------------------------------------------------------
# Plain versions (pure torch — the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def gather_strided_plain(window: torch.Tensor, stride: int, offset: int,
                         vl: int) -> torch.Tensor:
    """The plain version of kernel B3 on ``window``'s own device."""
    n = window.shape[-1]
    ops = _operands("gather", n, ((stride, offset),), vl, window.device)
    routed = shiftnet.apply_plan_operand(window, ops["masks"],
                                         ops["plans"][0], axis=-1)
    return routed[..., :vl].contiguous()


def gather_strided_fused_plain(windows: torch.Tensor, specs,
                               vl: int) -> torch.Tensor:
    """The plain version of kernel B4: ``(A, ..., n) -> (A, ..., vl)``."""
    pairs = tuple((int(s), int(o)) for s, o in specs)
    n = windows.shape[-1]
    ops = _operands("gather", n, pairs, vl, windows.device)
    outs = []
    for a, plan in enumerate(ops["plans"]):
        lo, hi = ops["spans"][a]
        routed = shiftnet.apply_plan_operand(windows[a], ops["masks"][lo:hi],
                                             plan, axis=-1)
        outs.append(routed[..., :vl])
    return torch.stack(outs)


def scatter_strided_plain(window: torch.Tensor, values: torch.Tensor,
                          stride: int, offset: int) -> torch.Tensor:
    """The plain version of kernel B5 on ``window``'s own device."""
    n, vl = window.shape[-1], values.shape[-1]
    ops = _operands("scatter", n, ((stride, offset),), vl, window.device)
    padded = torch.nn.functional.pad(values, (0, n - vl))
    routed = shiftnet.apply_plan_operand(padded, ops["masks"],
                                         ops["plans"][0], axis=-1)
    return torch.where(ops["valid"], routed, window)


def gather_strided_dynamic_plain(window: torch.Tensor, stride: int,
                                 offset: int, vl: int) -> torch.Tensor:
    """The plain version of kernel B8 on ``window``'s own device: the GSN
    over ``scg.gather_counts(n, stride, offset, vl)``, lanes [0, vl) (the
    reference's ``_gather_dyn_kernel``)."""
    n = window.shape[-1]
    shift, valid = scg.gather_counts(n, stride, offset, vl,
                                     device=window.device)
    res = shiftnet.gather_network(window, shift, valid, axis=-1)
    return res.payload[..., :vl].contiguous()


def scatter_strided_dynamic_plain(window: torch.Tensor, values: torch.Tensor,
                                  stride: int, offset: int) -> torch.Tensor:
    """The plain version of kernel B9 on ``window``'s own device: the
    zero-padded values through the SSN over ``scg.scatter_counts``, merged
    into the window under the network's final occupancy (the reference's
    ``_scatter_dyn_kernel``)."""
    n, vl = window.shape[-1], values.shape[-1]
    shift, valid = scg.scatter_counts(n, stride, offset, vl,
                                      device=window.device)
    res = shiftnet.scatter_network(
        torch.nn.functional.pad(values, (0, n - vl)), shift, valid, axis=-1)
    return torch.where(res.valid, res.payload, window)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def gather_strided(window: torch.Tensor, stride: int, offset: int, vl: int,
                   *, compiled: bool = True) -> torch.Tensor:
    """(..., n) -> (..., vl): out[..., i] = window[..., offset + i*stride]
    (kernel B3)."""
    gather_strided.calls += 1
    if not compiled:
        return gather_strided_dynamic(window, stride, offset, vl)
    n = window.shape[-1]
    check_fits(n, stride, offset, vl)
    if window.device.type == "cpu":
        return gather_strided_plain(window, stride, offset, vl)
    _common.check_cuda(window, "gather_strided")
    flat, lead = _common.flatten_rows(window)
    R = flat.shape[0]
    if not (R and vl):
        return window.new_empty(lead + (vl,))
    ops = _operands("gather", n, ((stride, offset),), vl, window.device)
    out = _launch_gather(flat, 1, R, n, vl, ops)
    gather_strided.launches += 1
    return out.reshape(lead + (vl,))


gather_strided.calls = 0
gather_strided.launches = 0


def gather_strided_fused(windows: torch.Tensor, specs, vl: int, *,
                         compiled: bool = True) -> torch.Tensor:
    """Whole-step fused gather (kernel B4): A same-shape windows, each with
    its own ``(stride, offset)``, in ONE launch whose mask operand
    concatenates every access's plan.  ``windows`` is ``(A, ..., n)``;
    returns ``(A, ..., vl)``."""
    gather_strided_fused.calls += 1
    pairs = tuple((int(s), int(o)) for s, o in specs)
    A, n = windows.shape[0], windows.shape[-1]
    if A != len(pairs):
        raise ValueError(f"{A} windows for {len(pairs)} specs")
    for s, o in pairs:
        check_fits(n, s, o, vl)
    if not compiled:
        # the reference's structure: one dynamic gather per access
        return torch.stack([gather_strided_dynamic(windows[a], s, o, vl)
                            for a, (s, o) in enumerate(pairs)])
    if windows.device.type == "cpu":
        return gather_strided_fused_plain(windows, pairs, vl)
    _common.check_cuda(windows, "gather_strided_fused")
    lead = tuple(windows.shape[1:-1])
    R = windows[0].numel() // n if n else 0
    if not (R and vl):
        return windows.new_empty((A,) + lead + (vl,))
    ops = _operands("gather", n, pairs, vl, windows.device)
    out = _launch_gather(windows.reshape(A * R, n), A, R, n, vl, ops)
    gather_strided_fused.launches += 1
    return out.reshape((A,) + lead + (vl,))


gather_strided_fused.calls = 0
gather_strided_fused.launches = 0


def scatter_strided(window: torch.Tensor, values: torch.Tensor, stride: int,
                    offset: int, *, compiled: bool = True) -> torch.Tensor:
    """Merge dense ``values`` (..., vl) into the strided lanes of
    ``window`` (..., n), out of place (kernel B5, the read-modify-write
    store)."""
    scatter_strided.calls += 1
    if not compiled:
        return scatter_strided_dynamic(window, values, stride, offset)
    n, vl = window.shape[-1], values.shape[-1]
    check_fits(n, stride, offset, vl)
    _check_values(window, values)
    if window.device.type == "cpu":
        return scatter_strided_plain(window, values, stride, offset)
    _common.check_cuda(window, "scatter_strided")
    _common.check_cuda(values, "scatter_strided")
    fw, lead = _common.flatten_rows(window)
    R = fw.shape[0]
    if not (R and vl):
        return window.clone()
    ops = _operands("scatter", n, ((stride, offset),), vl, window.device)
    out = torch.empty_like(fw)
    lib = _lib()
    elem = fw.element_size()
    rows = _common.rows_per_block(
        R, n, elem, (ops["S"] + 1) * ops["words"] * 4,
        _common.min_blocks(window.device), buffers=2)
    status = lib.strided_scatter(
        elem, values.data_ptr(), fw.data_ptr(), out.data_ptr(), R, n, vl,
        ops["masks_bits"].data_ptr(), ops["S"], ops["words"],
        ops["layers"].data_ptr(), ops["nlayers"],
        ops["valid_bits"].data_ptr(), rows, _common.cuda_stream(window))
    _check(lib, status, "scatter_strided")
    scatter_strided.launches += 1
    return out.reshape(lead + (n,))


scatter_strided.calls = 0
scatter_strided.launches = 0


def _check_values(window: torch.Tensor, values: torch.Tensor) -> None:
    if values.shape[:-1] != window.shape[:-1] or \
            values.dtype != window.dtype or values.device != window.device:
        raise ValueError("scatter_strided: values must match the window's "
                         "leading shape, dtype and device")


def gather_strided_dynamic(window: torch.Tensor, stride: int, offset: int,
                           vl: int) -> torch.Tensor:
    """(..., n) -> (..., vl) through the dynamic-count GSN (kernel B8,
    ``gather_strided(compiled=False)``): one launch per call, each block
    deriving the network from the counts of (n, stride, offset, vl)."""
    gather_strided_dynamic.calls += 1
    n = window.shape[-1]
    check_fits(n, stride, offset, vl)
    if window.device.type == "cpu":
        return gather_strided_dynamic_plain(window, stride, offset, vl)
    _common.check_cuda(window, "gather_strided_dynamic")
    flat, lead = _common.flatten_rows(window)
    R = flat.shape[0]
    if not (R and vl):
        return window.new_empty(lead + (vl,))
    out = torch.empty((R, vl), dtype=window.dtype, device=window.device)
    lib = _lib()
    elem = flat.element_size()
    rows = _common.rows_per_block(R, n, elem, _common.dyn_net_bytes(n),
                                  _common.min_blocks(window.device),
                                  buffers=2)
    status = lib.strided_gather_dyn(
        elem, flat.data_ptr(), out.data_ptr(), R, n, vl, stride, offset,
        rows, _common.cuda_stream(window))
    _check(lib, status, "gather_strided_dynamic")
    gather_strided_dynamic.launches += 1
    return out.reshape(lead + (vl,))


gather_strided_dynamic.calls = 0
gather_strided_dynamic.launches = 0


def scatter_strided_dynamic(window: torch.Tensor, values: torch.Tensor,
                            stride: int, offset: int) -> torch.Tensor:
    """Merge dense ``values`` into the strided lanes of ``window`` through
    the dynamic-count SSN, out of place (kernel B9,
    ``scatter_strided(compiled=False)``)."""
    scatter_strided_dynamic.calls += 1
    n, vl = window.shape[-1], values.shape[-1]
    check_fits(n, stride, offset, vl)
    _check_values(window, values)
    if window.device.type == "cpu":
        return scatter_strided_dynamic_plain(window, values, stride, offset)
    _common.check_cuda(window, "scatter_strided_dynamic")
    _common.check_cuda(values, "scatter_strided_dynamic")
    fw, lead = _common.flatten_rows(window)
    R = fw.shape[0]
    if not (R and vl):
        return window.clone()
    out = torch.empty_like(fw)
    lib = _lib()
    elem = fw.element_size()
    rows = _common.rows_per_block(R, n, elem, _common.dyn_net_bytes(n),
                                  _common.min_blocks(window.device),
                                  buffers=2)
    status = lib.strided_scatter_dyn(
        elem, values.data_ptr(), fw.data_ptr(), out.data_ptr(), R, n, vl,
        stride, offset, rows, _common.cuda_stream(window))
    _check(lib, status, "scatter_strided_dynamic")
    scatter_strided_dynamic.launches += 1
    return out.reshape(lead + (n,))


scatter_strided_dynamic.calls = 0
scatter_strided_dynamic.launches = 0


def dynamic_masks(n: int, stride: int, offset: int, vl: int, *,
                  gather: bool = True, blocks: int = 1,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The device derivation of B8 (``gather``) or B9 alone: ``blocks``
    blocks each derive the network of (n, stride, offset, vl); returns
    block 0's packed take-masks ``(L, words)`` and final occupancy
    ``(words,)`` as int32 bit words (``_common.pack_bits``'s layout).  For
    checking the derivation against ``shiftnet.layer_masks`` and timing it
    apart from the row loop; not on any access path."""
    words = -(-n // 32)
    layers = shiftnet._num_layers(n)
    dev = torch.device("cuda") if device is None else torch.device(device)
    masks = torch.zeros((max(layers, 1), words), dtype=torch.int32,
                        device=dev)
    occ = torch.zeros((words,), dtype=torch.int32, device=dev)
    _common.check_cuda(masks, "dynamic_masks")
    lib = _lib()
    status = lib.route_dyn_masks(int(gather), n, stride, offset, vl,
                                 masks.data_ptr(), occ.data_ptr(), blocks,
                                 _common.cuda_stream(masks))
    _check(lib, status, "dynamic_masks")
    return masks[:layers], occ


KERNELS = (gather_strided, gather_strided_fused, scatter_strided)
DYNAMIC = (gather_strided_dynamic, scatter_strided_dynamic)


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches``."""
    for fn in KERNELS + DYNAMIC:
        fn.calls = 0
        fn.launches = 0
