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
* B3 and B4 do not run the plan's layers on the card: a gather plan's
  composed table (``ShiftPlan.source``, the input lane of each output
  lane) is known on the host, so each call is one staged copy of the rows
  through it (``staged_copy_kernel``, ``csrc/perm_copy.cuh``).  For the
  copy unit the call's row width and pointer allow, the wrapper keeps per
  access the staged-unit list (the units of a row that hold a source
  lane, or the whole row where those touch every 32-byte sector) and the
  table remapped into the row compacted to those units
  (:func:`staged_operands`), uploaded once per plan-cache entry; the
  kernel stages only those units.
* B5 runs no plan layer either: a scatter plan's table gives, on the host,
  the list of the lanes it occupies beside the values lane each takes
  (:func:`scatter_pairs`, ``_common.merge_pairs`` on the plan's table),
  uploaded once per plan-cache entry in B9's list format.  Each call is
  one merge copy (``merge_copy_kernel``, ``csrc/perm_copy.cuh``), B9's
  copy without its derive kernel, launched without Programmatic Dependent
  Launch: the kernel before it wrote the window or the values.
* ``compiled=False`` hands the call to :func:`gather_strided_dynamic`
  (B8) and :func:`scatter_strided_dynamic` (B9): one launch of the dynamic
  kernel per access (A launches for a fused gather of A windows, as the
  reference loops), or for CPU tensors their plain versions on the GSN /
  SSN of ``core/shiftnet.py``.  Each launch is two CUDA kernels and counts
  as one: one derivation of the network into a source table, then a copy
  of the rows through it.  B8's copy permutes the window's rows into the
  vl output lanes; B9's is B5's merge copy, its derive kernel compacting
  the table into the list of occupied lanes and their values lanes (vl
  pairs, :func:`dynamic_merge_list`).

CUDA operands may be views: each wrapper reads a contiguous copy of a
non-contiguous one (``_common.check_cuda``).  A window the access does not
fit (``offset + (vl-1)*stride >= n``, a
negative offset or a stride below 1) raises ``ValueError``.  Each wrapper
counts ``calls`` (every entry, any device) and ``launches`` (kernel
launches only, counted where the kernel launched).
"""
from __future__ import annotations

import ctypes
import math

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
    if kind == "gather":
        # B3 / B4 copy each row through the plans' composed tables; the
        # staged-unit lists depend on the copy unit and the element size,
        # so _staged adds them to this entry at the first such call
        source = np.stack([p.source[:vl] for p in plans]).astype(np.int32)
        ops.update(source_np=source, staged={},
                   source=torch.from_numpy(source).to(device))
        return ops
    # B5 merges the values through the list of the plan's occupied lanes,
    # in B9's format {K, lane_0, src_0, ...}
    pairs = scatter_pairs(plans[0], vl)
    ops.update(kmax=pairs.shape[0], list=torch.cat([
        torch.tensor([pairs.shape[0]], dtype=torch.int32),
        pairs.reshape(-1)]).to(device))
    return ops


def scatter_pairs(plan, vl: int) -> torch.Tensor:
    """B5's list, composed from the host scatter plan: ``(K, 2)`` int32,
    the lanes the plan occupies in lane order beside the values lane each
    takes (``_common.merge_pairs`` on ``ShiftPlan.source`` under
    ``.valid``; for an access that fits, K = vl).  Raises if a listed
    source lies outside ``[0, vl)``: the merge copy reads only the vl
    values, never their zero padding."""
    pairs = _common.merge_pairs(torch.from_numpy(
        np.where(plan.valid, plan.source, -1)))
    src = pairs[:, 1]
    if src.numel() and not (int(src.min()) >= 0 and int(src.max()) < vl):
        raise ValueError(f"scatter plan sources {src.tolist()} outside "
                         f"[0, {vl})")
    return pairs


def staged_operands(source, n: int, per_unit: int, elem: int) -> dict:
    """The staged copy's host operands for ``n``-lane rows of
    ``elem``-byte lanes and copy units of ``per_unit`` lanes, from the
    ``(A, vl)`` source table (one row per access): the staged-unit lists
    ``units`` ``(A, kmax)``, padded with 0 past each access's ``nunits``,
    and the tables remapped into the compacted rows, ``pos`` ``(A, vl)``;
    all int32 (``_common.staged_units`` per access)."""
    lists = [_common.staged_units(src, n, per_unit, elem) for src in source]
    kmax = max(len(u) for u, _ in lists)
    units = np.zeros((len(lists), kmax), np.int32)
    for a, (u, _) in enumerate(lists):
        units[a, :len(u)] = u
    return {"kmax": kmax, "units": units,
            "nunits": np.array([len(u) for u, _ in lists], np.int32),
            "pos": np.stack([p for _, p in lists])}


def _staged(ops: dict, n: int, per_unit: int, elem: int,
            device: torch.device) -> dict:
    """:func:`staged_operands` on the card, uploaded once per plan-cache
    entry, copy unit and element size."""
    st = ops["staged"].get((per_unit, elem))
    if st is None:
        host = staged_operands(ops["source_np"], n, per_unit, elem)
        st = ops["staged"][per_unit, elem] = {"kmax": host["kmax"], **{
            k: torch.from_numpy(host[k]).to(device)
            for k in ("units", "nunits", "pos")}}
    return st


def _lib():
    lib = _common.library("strided")
    if not getattr(lib, "_typed", False):
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.strided_gather.argtypes = [
            I, P, P, I, LL, I, I, P, P, P, I, I, I, I, I, P]
        lib.strided_gather.restype = I
        lib.strided_scatter.argtypes = [
            I, P, P, P, LL, I, I, P, I, I, I, I, I, P]
        lib.strided_scatter.restype = I
        lib.strided_gather_dyn.argtypes = [
            I, P, P, LL, I, I, I, I, P, I, I, I, P]
        lib.strided_gather_dyn.restype = I
        lib.strided_scatter_dyn.argtypes = [
            I, P, P, P, LL, I, I, I, I, P, I, I, I, I, P]
        lib.strided_scatter_dyn.restype = I
        lib.route_dyn_masks.argtypes = [I, I, I, I, I, P, P, I, P]
        lib.route_dyn_masks.restype = I
        lib.route_dyn_sources.argtypes = [I, I, I, I, I, P, P, P]
        lib.route_dyn_sources.restype = I
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
    """(A*R, n) windows -> (A*R, vl) through ``strided_gather``: one
    staged copy (B3 for A == 1, B4 otherwise)."""
    out = torch.empty((A * R, vl), dtype=flat.dtype, device=flat.device)
    lib = _lib()
    elem = flat.element_size()
    sunit = _common.copy_unit(n * elem, flat.data_ptr())
    ounit = _common.copy_unit(vl * elem, out.data_ptr())
    st = _staged(ops, n, sunit // elem, elem, flat.device)
    blocks = -(-_common.min_blocks(flat.device) // A)
    rows = _common.copy_tile_rows(R, st["kmax"] * sunit // elem, vl, 1, elem,
                                  blocks, units=st["kmax"])
    status = lib.strided_gather(
        elem, flat.data_ptr(), out.data_ptr(), A, R, n, vl,
        st["pos"].data_ptr(), st["units"].data_ptr(),
        st["nunits"].data_ptr(), st["kmax"], rows, blocks, sunit, ounit,
        _common.cuda_stream(flat))
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
    (kernel B3: one staged copy of the rows through the plan's table)."""
    gather_strided.calls += 1
    if not compiled:
        return gather_strided_dynamic(window, stride, offset, vl)
    n = window.shape[-1]
    check_fits(n, stride, offset, vl)
    if window.device.type == "cpu":
        return gather_strided_plain(window, stride, offset, vl)
    window = _common.check_cuda(window, "gather_strided")
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
    its own ``(stride, offset)``, in ONE launch of the staged copy, each
    block on one access with that access's table and staged-unit list.
    ``windows`` is ``(A, ..., n)``; returns ``(A, ..., vl)``."""
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
    windows = _common.check_cuda(windows, "gather_strided_fused")
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
    store: one merge copy of the rows through the list of the plan's
    occupied lanes)."""
    scatter_strided.calls += 1
    if not compiled:
        return scatter_strided_dynamic(window, values, stride, offset)
    n, vl = window.shape[-1], values.shape[-1]
    check_fits(n, stride, offset, vl)
    _check_values(window, values)
    if window.device.type == "cpu":
        return scatter_strided_plain(window, values, stride, offset)
    window = _common.check_cuda(window, "scatter_strided")
    values = _common.check_cuda(values, "scatter_strided")
    fw, lead = _common.flatten_rows(window)
    R = fw.shape[0]
    if not (R and vl):
        return window.clone()
    ops = _operands("scatter", n, ((stride, offset),), vl, window.device)
    out = torch.empty_like(fw)
    lib = _lib()
    elem = fw.element_size()
    blocks = _common.min_blocks(window.device)
    rows = _common.merge_tile_rows(R, n, vl, ops["kmax"], elem, blocks)
    wunit = _common.copy_unit(n * elem, fw.data_ptr(), out.data_ptr())
    vunit = _common.copy_unit(vl * elem, values.data_ptr())
    status = lib.strided_scatter(
        elem, values.data_ptr(), fw.data_ptr(), out.data_ptr(), R, n, vl,
        ops["list"].data_ptr(), ops["kmax"], rows, blocks, wunit, vunit,
        _common.cuda_stream(window))
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
    ``gather_strided(compiled=False)``).  One launch per call, made of two
    CUDA kernels on the call's stream: one block derives the network from
    the counts of (n, stride, offset, vl) and writes the source lane of
    each of the vl output lanes into a small int32 workspace; then a
    permuted copy moves every window row through that table."""
    gather_strided_dynamic.calls += 1
    n = window.shape[-1]
    check_fits(n, stride, offset, vl)
    if window.device.type == "cpu":
        return gather_strided_dynamic_plain(window, stride, offset, vl)
    window = _common.check_cuda(window, "gather_strided_dynamic")
    flat, lead = _common.flatten_rows(window)
    R = flat.shape[0]
    if not (R and vl):
        return window.new_empty(lead + (vl,))
    out = torch.empty((R, vl), dtype=window.dtype, device=window.device)
    lib = _lib()
    elem = flat.element_size()
    blocks = _common.min_blocks(window.device)
    rows = _common.copy_tile_rows(R, n, vl, 1, elem, blocks)
    unit = _common.copy_unit(math.gcd(n, vl) * elem, flat.data_ptr(),
                             out.data_ptr())
    table = torch.empty((vl,), dtype=torch.int32, device=window.device)
    status = lib.strided_gather_dyn(
        elem, flat.data_ptr(), out.data_ptr(), R, n, vl, stride, offset,
        table.data_ptr(), rows, blocks, unit, _common.cuda_stream(window))
    _check(lib, status, "gather_strided_dynamic")
    gather_strided_dynamic.launches += 1
    return out.reshape(lead + (vl,))


gather_strided_dynamic.calls = 0
gather_strided_dynamic.launches = 0


def scatter_strided_dynamic(window: torch.Tensor, values: torch.Tensor,
                            stride: int, offset: int) -> torch.Tensor:
    """Merge dense ``values`` into the strided lanes of ``window`` through
    the dynamic-count SSN, out of place (kernel B9,
    ``scatter_strided(compiled=False)``).  One launch per call, made of two
    CUDA kernels on the call's stream: one block derives the SSN from the
    counts of (n, stride, offset, vl), composes it into the values lane of
    each window lane and compacts the occupied lanes into a list of (lane,
    values lane) pairs, in a small int32 workspace; then a merge copy
    stages every window row and its values, writes the listed lanes and
    stores the whole row."""
    scatter_strided_dynamic.calls += 1
    n, vl = window.shape[-1], values.shape[-1]
    check_fits(n, stride, offset, vl)
    _check_values(window, values)
    if window.device.type == "cpu":
        return scatter_strided_dynamic_plain(window, values, stride, offset)
    window = _common.check_cuda(window, "scatter_strided_dynamic")
    values = _common.check_cuda(values, "scatter_strided_dynamic")
    fw, lead = _common.flatten_rows(window)
    R = fw.shape[0]
    if not (R and vl):
        return window.clone()
    out = torch.empty_like(fw)
    lib = _lib()
    elem = fw.element_size()
    blocks = _common.min_blocks(window.device)
    rows = _common.merge_tile_rows(R, n, vl, vl, elem, blocks)
    wunit = _common.copy_unit(n * elem, fw.data_ptr(), out.data_ptr())
    vunit = _common.copy_unit(vl * elem, values.data_ptr())
    # the n-entry table, then {K, lane, values lane, ...}: K <= vl pairs
    work = torch.empty((n + 1 + 2 * vl,), dtype=torch.int32,
                       device=window.device)
    status = lib.strided_scatter_dyn(
        elem, values.data_ptr(), fw.data_ptr(), out.data_ptr(), R, n, vl,
        stride, offset, work.data_ptr(), rows, blocks, wunit, vunit,
        _common.cuda_stream(window))
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


def dynamic_sources(n: int, stride: int, offset: int, vl: int, *,
                    gather: bool = True, device=None) -> torch.Tensor:
    """One derivation per launch, alone: the int32 source table the derive
    kernel writes for (n, stride, offset, vl).  ``gather``: B8's table,
    ``(vl,)``, on ``scg.gather_counts`` through the GSN; else ``(n,)`` on
    ``scg.scatter_counts`` through the SSN.  Entry j is the input lane
    whose bits the network leaves in lane j, -1 where the final occupancy
    is clear.  For checking the table against
    ``_common.dyn_sources_plain`` and timing the derivation; not on any
    access path."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    table = torch.empty((vl if gather else n,), dtype=torch.int32,
                        device=dev)
    _common.check_cuda(table, "dynamic_sources")
    lib = _lib()
    status = lib.route_dyn_sources(int(gather), n, stride, offset, vl,
                                   table.data_ptr(), None,
                                   _common.cuda_stream(table))
    _check(lib, status, "dynamic_sources")
    return table


def dynamic_merge_list(n: int, stride: int, offset: int, vl: int, *,
                       device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """B9's derivation alone, as its derive kernel runs it: the SSN's
    ``(n,)`` int32 source table on ``scg.scatter_counts(n, stride, offset,
    vl)`` (as :func:`dynamic_sources` with ``gather=False``) and the merge
    copy's list, ``(1 + 2*vl,)`` int32: the count K, then K (lane, values
    lane) pairs in lane order, the rest unwritten.  For checking the list
    against ``_common.merge_pairs`` and timing the derivation; not on any
    access path."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    table = torch.empty((n,), dtype=torch.int32, device=dev)
    pairs = torch.empty((1 + 2 * vl,), dtype=torch.int32, device=dev)
    _common.check_cuda(table, "dynamic_merge_list")
    lib = _lib()
    status = lib.route_dyn_sources(0, n, stride, offset, vl,
                                   table.data_ptr(), pairs.data_ptr(),
                                   _common.cuda_stream(table))
    _check(lib, status, "dynamic_merge_list")
    return table, pairs


KERNELS = (gather_strided, gather_strided_fused, scatter_strided)
DYNAMIC = (gather_strided_dynamic, scatter_strided_dynamic)


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches``."""
    for fn in KERNELS + DYNAMIC:
        fn.calls = 0
        fn.launches = 0
