"""The raw DROM gather (GSN): wrappers for CUDA kernels B11 and B12.

Port of ``repro``'s ``kernels/shift_gather.py``.  Callers give per-lane
shift counts and a validity mask (the SCG output), one routing program
shared by every row: lanes move toward lower indices by their count, and
lanes the routing leaves invalid come out 0.

* :func:`shift_gather_static` (B11) routes through a compiled ShiftPlan;
  :func:`shift_gather` with HOST counts (numpy arrays, tuples, lists)
  compiles them to a ``shiftplan.counts_plan`` plan and takes the same
  kernel.  A plan with conflicts is refused (``AssertionError``, as the
  reference's plan body refuses it) on every device.  The network is
  static, so the whole function is the plan's table ``where(plan.valid,
  plan.source, -1)``: the staged copy's operands are composed from it on
  the host (``_indexed.plan_staged``) and uploaded once per plan, staging
  unit and element size, and one staged copy reads only the input units
  that hold a source lane and moves the rows through the table, 0 where
  it holds -1 (B13's copy without the occupancy).
* :func:`shift_gather` with tensor counts (B12) runs the dynamic-count
  network on int32 count operands cast on the card (no host sync): one
  derive kernel composes the GSN into an ``(n,)`` source table (its twin
  is ``_common.dyn_sources_plain(shift, valid, gsn=True)``) and lists the
  input units that hold a source lane (``_indexed.staged_units_plain``),
  then one staged copy reads only those units of each row and moves the
  rows through the table, 0 where it holds -1; the two count as one
  launch.

For CUDA tensors each wrapper launches its kernel in ``csrc/indexed.cu``,
one launch per call; for CPU tensors it runs the plain version
(:func:`shift_gather_static_plain`, :func:`shift_gather_plain`), which is
also the kernels' yardstick on the card.  Each wrapper counts ``calls``
(every entry) and ``launches`` (kernel launches only).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import shiftnet, shiftplan
from repro_torch.kernels import _indexed


def host_plan(shift, valid, *, gather: bool):
    """The compiled counts plan of host ``(shift, valid)``."""
    return shiftplan.counts_plan(
        tuple(int(s) for s in np.asarray(shift).reshape(-1)),
        tuple(bool(v) for v in np.asarray(valid).reshape(-1)),
        gather=gather)


def device_counts(shift, valid, n: int, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(shift, valid)`` as (n,) int32 tensors on ``device`` (cast on the
    device: a tensor already there is never read back)."""
    s = torch.as_tensor(shift, device=device).reshape(n).to(torch.int32)
    v = torch.as_tensor(valid, device=device).reshape(n).to(torch.int32)
    return s.contiguous(), v.contiguous()


# ---------------------------------------------------------------------------
# Plain versions (pure torch — the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def shift_gather_static_plain(x: torch.Tensor, plan) -> torch.Tensor:
    """The plain version of kernel B11 on ``x``'s own device."""
    ops = _indexed.plan_operands(plan, x.device)
    routed = shiftnet.apply_plan_operand(x, ops["masks"], plan, axis=-1)
    return torch.where(ops["valid"], routed, torch.zeros_like(routed))


def shift_gather_plain(x: torch.Tensor, shift: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel B12: the GSN over the (n,) counts, zero
    where the routed validity is false (the reference's ``_kernel``)."""
    res = shiftnet.gather_network(x, shift, valid.to(torch.int32) != 0,
                                  axis=-1)
    return torch.where(res.valid, res.payload,
                       torch.zeros_like(res.payload))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def shift_gather_static(x: torch.Tensor, plan) -> torch.Tensor:
    """Route (..., n) lanes through a compiled ShiftPlan (kernel B11)."""
    shift_gather_static.calls += 1
    n = x.shape[-1]
    assert plan.n == n, (plan.n, n)
    assert not plan.conflict, "conflicting plan (illegal mapping)"
    if x.device.type == "cpu":
        return shift_gather_static_plain(x, plan)
    return _indexed.launch_plan_copy(x, plan, shift_gather_static,
                                     occupancy=False)


shift_gather_static.calls = 0
shift_gather_static.launches = 0


def shift_gather(x: torch.Tensor, shift, valid) -> torch.Tensor:
    """Route (..., n) lanes down by ``shift`` where ``valid``; zero
    elsewhere.  ``shift``, ``valid``: (n,), one routing program for every
    row.  Host counts compile to a pruned plan (kernel B11); tensor counts
    take the dynamic-count network (kernel B12)."""
    shift_gather.calls += 1
    if shiftplan.host_counts(shift, valid):
        return shift_gather_static(x, host_plan(shift, valid, gather=True))
    n = x.shape[-1]
    shift, valid = device_counts(shift, valid, n, x.device)
    if x.device.type == "cpu":
        return shift_gather_plain(x, shift, valid)
    return _indexed.launch_dyn(x, shift, valid, shift_gather, gsn=True)


shift_gather.calls = 0
shift_gather.launches = 0

KERNELS = (shift_gather_static, shift_gather)


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches``."""
    for fn in KERNELS:
        fn.calls = 0
        fn.launches = 0
