"""The raw DROM scatter (SSN): wrappers for CUDA kernels B13 and B14.

Port of ``repro``'s ``kernels/shift_scatter.py``, the mirror of
kernels/shift_gather.py: lanes move toward HIGHER indices (count bits
consumed MSB first).  Both wrappers return ``(payload, occupancy)``: the
routed payload with 0 in unoccupied lanes, and the occupancy as a bool
tensor of the payload's shape, so a caller can merge into an existing
buffer (the store path of LSDO).

* :func:`shift_scatter_static` (B13) routes through a compiled ShiftPlan;
  :func:`shift_scatter` with HOST counts compiles them to a
  ``shiftplan.counts_plan`` plan and takes the same kernel.  The plan is
  static, so its table ``where(plan.valid, plan.source, -1)`` and the
  staged copy's operands are composed on the host
  (``_indexed.plan_staged``) and uploaded once per plan, staging
  unit and element size; one staged copy reads only the input units that
  hold a source lane and writes payload and occupancy in one pass.
* :func:`shift_scatter` with tensor counts (B14) runs the dynamic-count
  network on int32 count operands cast on the card: one derive kernel
  composes the SSN into an ``(n,)`` source table (its twin is
  ``_common.dyn_sources_plain(shift, valid, gsn=False)``) and lists the
  input units that hold a source lane (``_indexed.staged_units_plain``),
  then the same staged copy as B13's, which waits for that list; the two
  count as one launch.

For CUDA tensors each wrapper launches its kernel in ``csrc/indexed.cu``
(one launch writes payload and occupancy); for CPU tensors it runs the
plain version (:func:`shift_scatter_static_plain`,
:func:`shift_scatter_plain`).  Each wrapper counts ``calls`` and
``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core import shiftnet, shiftplan
from repro_torch.kernels import _indexed
from repro_torch.kernels.shift_gather import device_counts, host_plan


# ---------------------------------------------------------------------------
# Plain versions (pure torch — the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def shift_scatter_static_plain(x: torch.Tensor, plan
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel B13 on ``x``'s own device."""
    ops = _indexed.plan_operands(plan, x.device)
    routed = shiftnet.apply_plan_operand(x, ops["masks"], plan, axis=-1)
    keep = ops["valid"]
    return (torch.where(keep, routed, torch.zeros_like(routed)),
            keep.expand(x.shape).contiguous())


def shift_scatter_plain(x: torch.Tensor, shift: torch.Tensor,
                        valid: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel B14: the SSN over the (n,) counts;
    payload zero and occupancy false where the routed validity is false
    (the reference's ``_kernel``)."""
    res = shiftnet.scatter_network(x, shift, valid.to(torch.int32) != 0,
                                   axis=-1)
    return (torch.where(res.valid, res.payload,
                        torch.zeros_like(res.payload)),
            res.valid.expand(x.shape).contiguous())


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def shift_scatter_static(x: torch.Tensor, plan
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compiled-plan SSN (kernel B13): ``(payload, occupancy)``."""
    shift_scatter_static.calls += 1
    assert plan.n == x.shape[-1], (plan.n, x.shape[-1])
    if x.device.type == "cpu":
        return shift_scatter_static_plain(x, plan)
    return _indexed.launch_plan_copy(x, plan, shift_scatter_static,
                                     occupancy=True)


shift_scatter_static.calls = 0
shift_scatter_static.launches = 0


def shift_scatter(x: torch.Tensor, shift, valid
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route (..., n) lanes up by ``shift`` where ``valid``.  Returns
    ``(payload, occupancy)`` with 0 / False in unoccupied lanes.  Host
    counts compile to a pruned plan (kernel B13); tensor counts take the
    dynamic-count network (kernel B14)."""
    shift_scatter.calls += 1
    if shiftplan.host_counts(shift, valid):
        return shift_scatter_static(x, host_plan(shift, valid, gather=False))
    n = x.shape[-1]
    shift, valid = device_counts(shift, valid, n, x.device)
    if x.device.type == "cpu":
        return shift_scatter_plain(x, shift, valid)
    return _indexed.launch_dyn(x, shift, valid, shift_scatter, gsn=False)


shift_scatter.calls = 0
shift_scatter.launches = 0

KERNELS = (shift_scatter_static, shift_scatter)


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches``."""
    for fn in KERNELS:
        fn.calls = 0
        fn.launches = 0
