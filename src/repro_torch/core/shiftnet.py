"""EARTH shift networks (GSN / SSN) as torch ops.

Port of ``repro``'s ``core/shiftnet.py``.  A network routes lanes through
``log2(n)`` layers, each a static shift by ``2**l`` plus a select.

* The compiled-plan half (``shift_static``, ``apply_plan``,
  ``apply_plan_operand``, ``plan_mask_stack``) runs a
  ``core/shiftplan.ShiftPlan``: constant take-masks, pruned layers.
  :func:`apply_plan_operand` is the plain version of the segment and
  strided kernels (kernels/segment.py, kernels/strided.py).
* The dynamic half (``_route``, ``gather_network``, ``scatter_network``,
  ``layer_masks``, ``apply_layer_masks``) takes runtime shift counts: the
  runtime-stride bank's fallback and the LSDO loop oracle.

Conventions as in the reference: the GSN moves lanes toward LOWER indices
consuming count bits LSB first; the SSN moves them toward HIGHER indices,
MSB first; shifts never wrap.  Row routing (``gather_rows`` /
``scatter_rows``) moves whole rows along axis 0 (MoE token compaction).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _num_layers(n: int) -> int:
    """Layers needed so any shift in [0, n-1] is representable."""
    if n <= 1:
        return 0
    return max(1, math.ceil(math.log2(n)))


def shift_static(x: torch.Tensor, k: int, axis: int, *,
                 fill=0) -> torch.Tensor:
    """Non-circular static shift: result[i] = x[i + k] (k may be negative).

    Vacated slots are filled with ``fill``."""
    if k == 0:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    if abs(k) >= n:
        return out
    if k > 0:               # pull from higher indices
        out.narrow(axis, 0, n - k).copy_(x.narrow(axis, k, n - k))
    else:                   # pull from lower indices
        out.narrow(axis, -k, n + k).copy_(x.narrow(axis, 0, n + k))
    return out


def _apply_layer(x: torch.Tensor, shifts, masks, axis: int) -> torch.Tensor:
    """One plan layer: all (shift, mask) pairs read the same snapshot.

    A two-shift (exchange) layer is ``select_n(m0 + 2*m1, x, shift(x, s0),
    shift(x, s1))``; the two masks are disjoint."""
    if len(shifts) == 2:
        y = torch.where(masks[0], shift_static(x, shifts[0], axis), x)
        return torch.where(masks[1], shift_static(x, shifts[1], axis), y)
    y = x
    for s, m in zip(shifts, masks):
        y = torch.where(m, shift_static(x, s, axis), y)
    return y


def _broadcast_const(mask: np.ndarray, x: torch.Tensor, axis: int
                     ) -> torch.Tensor:
    """Lift a host (n,) or (..., n) plan mask to x's rank along axis."""
    m = torch.from_numpy(np.ascontiguousarray(mask, bool)).to(x.device)
    axis = axis % x.ndim
    if m.ndim == 1:
        shape = [1] * x.ndim
        shape[axis] = m.shape[0]
        return m.reshape(shape)
    # stacked (T, n) masks: align trailing dims against (..., T, n)
    return m.reshape([1] * (x.ndim - m.ndim) + list(m.shape))


def apply_plan(x: torch.Tensor, plan, *, axis: int = -1) -> torch.Tensor:
    """Run a compiled ShiftPlan with its host masks (uploaded per call):
    each active layer selects between the input snapshot and statically
    shifted copies under constant masks."""
    assert not plan.conflict, "conflicting plan (illegal mapping)"
    axis = axis % x.ndim
    assert x.shape[axis] == plan.n, (x.shape, axis, plan.n)
    for layer in plan.layers:
        masks = [_broadcast_const(m, x, axis) for m in layer.masks]
        x = _apply_layer(x, layer.shifts, masks, axis)
    return x


def plan_mask_stack(plan) -> np.ndarray:
    """Stack a plan's take-masks into one (S, n) host array."""
    rows = [m for layer in plan.layers for m in layer.masks]
    if not rows:
        return np.zeros((0, plan.n), bool)
    return np.stack(rows)


def apply_plan_operand(x: torch.Tensor, masks: torch.Tensor, plan, *,
                       axis: int = -1) -> torch.Tensor:
    """Run a compiled ShiftPlan with its masks as an (S, n) operand."""
    assert not plan.conflict, "conflicting plan (illegal mapping)"
    axis = axis % x.ndim
    assert x.shape[axis] == plan.n, (x.shape, axis, plan.n)
    shape = [1] * x.ndim
    shape[axis] = plan.n
    if masks.dtype != torch.bool:
        masks = masks != 0
    i = 0
    for layer in plan.layers:
        rows = [masks[i + j].reshape(shape)
                for j in range(len(layer.shifts))]
        i += len(layer.shifts)
        x = _apply_layer(x, layer.shifts, rows, axis)
    return x


# ---------------------------------------------------------------------------
# Dynamic counts: the runtime-count networks
# ---------------------------------------------------------------------------

class RouteResult(NamedTuple):
    payload: torch.Tensor
    valid: torch.Tensor
    conflict: torch.Tensor  # 0-dim bool: any slot collision or element loss


def _route(payload: torch.Tensor, shiftcnt: torch.Tensor,
           valid: torch.Tensor, *, axis: int, toward_zero: bool,
           lsb_first: bool) -> RouteResult:
    """Shared GSN/SSN layer loop.  ``shiftcnt`` (int) and ``valid`` (bool)
    broadcast against ``payload`` along ``axis``."""
    n = payload.shape[axis]
    layers = _num_layers(n)
    order = range(layers) if lsb_first else range(layers - 1, -1, -1)
    direction = 1 if toward_zero else -1
    shiftcnt = shiftcnt.to(torch.int32)
    valid = valid.to(torch.bool)
    conflict = torch.zeros((), dtype=torch.bool, device=payload.device)
    n_valid0 = valid.to(torch.int32).sum()
    for l in order:
        k = 1 << l
        stay = valid & (((shiftcnt >> l) & 1) == 0)
        cand_payload = shift_static(payload, direction * k, axis)
        cand_shift = shift_static(shiftcnt, direction * k, axis)
        cand_valid = (shift_static(valid, direction * k, axis, fill=False)
                      & (((cand_shift >> l) & 1) == 1))
        conflict = conflict | (cand_valid & stay).any()
        payload = torch.where(cand_valid, cand_payload, payload)
        shiftcnt = torch.where(cand_valid, cand_shift, shiftcnt)
        valid = cand_valid | stay
    # element loss (shifted off the edge) shows up as a count drop
    conflict = conflict | (valid.to(torch.int32).sum() != n_valid0)
    return RouteResult(payload, valid, conflict)


def layer_masks(shiftcnt: torch.Tensor, valid: torch.Tensor, *,
                toward_zero: bool, lsb_first: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, n) bool take-masks + final (n,) occupancy for runtime counts."""
    n = shiftcnt.shape[-1]
    layers = _num_layers(n)
    order = range(layers) if lsb_first else range(layers - 1, -1, -1)
    direction = 1 if toward_zero else -1
    sc = shiftcnt.to(torch.int32)
    val = valid.to(torch.bool)
    masks = []
    for l in order:
        k = 1 << l
        stay = val & (((sc >> l) & 1) == 0)
        cand_shift = shift_static(sc, direction * k, -1)
        cand_valid = (shift_static(val, direction * k, -1, fill=False)
                      & (((cand_shift >> l) & 1) == 1))
        masks.append(cand_valid)
        sc = torch.where(cand_valid, cand_shift, sc)
        val = cand_valid | stay
    if not masks:
        return torch.zeros((0, n), dtype=torch.bool,
                           device=shiftcnt.device), val
    return torch.stack(masks), val


def apply_layer_masks(x: torch.Tensor, masks: torch.Tensor, *, axis: int,
                      toward_zero: bool, lsb_first: bool) -> torch.Tensor:
    """Route a wide payload with masks from :func:`layer_masks`: one
    static shift + one select per layer."""
    axis = axis % x.ndim
    n = x.shape[axis]
    layers = _num_layers(n)
    order = range(layers) if lsb_first else range(layers - 1, -1, -1)
    direction = 1 if toward_zero else -1
    shape = [1] * x.ndim
    shape[axis] = n
    for i, l in enumerate(order):
        x = torch.where(masks[i].reshape(shape),
                        shift_static(x, direction * (1 << l), axis), x)
    return x


def gather_network(payload, shiftcnt, valid, *, axis: int = -1
                   ) -> RouteResult:
    """GSN: move valid elements toward lower indices by ``shiftcnt``
    slots (conflict-free iff order-preserving and separation
    non-increasing, EARTH §4.1.4)."""
    return _route(payload, shiftcnt, valid, axis=axis, toward_zero=True,
                  lsb_first=True)


def scatter_network(payload, shiftcnt, valid, *, axis: int = -1
                    ) -> RouteResult:
    """SSN: move valid elements toward higher indices by ``shiftcnt``
    slots; bits are consumed MSB first (LSB first would collide)."""
    return _route(payload, shiftcnt, valid, axis=axis, toward_zero=False,
                  lsb_first=False)


# ---------------------------------------------------------------------------
# Row routing: (n, d...) rows move as units along axis 0 (MoE tokens)
# ---------------------------------------------------------------------------

def _route_rows(rows: torch.Tensor, shiftcnt: torch.Tensor,
                valid: torch.Tensor, *, toward_zero: bool) -> RouteResult:
    tail = (1,) * (rows.ndim - 1)
    sc = shiftcnt.reshape(tuple(shiftcnt.shape) + tail).expand(rows.shape)
    vd = valid.reshape(tuple(valid.shape) + tail).expand(rows.shape)
    out = _route(rows, sc, vd, axis=0, toward_zero=toward_zero,
                 lsb_first=toward_zero)
    v = out.valid[..., 0] if out.valid.ndim > 1 else out.valid
    return RouteResult(out.payload, v, out.conflict)


def gather_rows(rows: torch.Tensor, shiftcnt: torch.Tensor,
                valid: torch.Tensor) -> RouteResult:
    """Route (n, d) rows toward index 0; shiftcnt/valid are (n,)."""
    return _route_rows(rows, shiftcnt, valid, toward_zero=True)


def scatter_rows(rows: torch.Tensor, shiftcnt: torch.Tensor,
                 valid: torch.Tensor) -> RouteResult:
    """Route (n, d) rows toward higher indices; shiftcnt/valid are (n,)."""
    return _route_rows(rows, shiftcnt, valid, toward_zero=False)
