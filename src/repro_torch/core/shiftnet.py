"""Compiled-plan shift network as torch ops.

Port of the compiled-plan half of ``repro``'s ``core/shiftnet.py``:
``shift_static``, ``_apply_layer``, ``plan_mask_stack`` and
``apply_plan_operand``.  :func:`apply_plan_operand` is the plain version
of both segment kernels (kernels/segment.py).  The dynamic-count networks
(``gather_network``/``scatter_network``, ``layer_masks``, row routing)
wait for the slice that ports the ``kernel_dynamic`` bodies and MoE.
"""
from __future__ import annotations

import numpy as np
import torch


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
