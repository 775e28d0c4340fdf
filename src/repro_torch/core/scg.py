"""Shift Count Generation (EARTH §4.2), element granularity, as torch ops.

Port of ``repro``'s ``core/scg.py``: the strided and segment counts.  A
strided access over a coalesced window of ``n`` elements has two views:

* gather (strided LOAD): input position ``p`` holds output element
  ``(p - offset) / stride`` when it divides exactly; its GSN shift count is
  ``p - dest(p)``.
* scatter (strided STORE): dense input element ``i`` must land at
  ``offset + i*stride``; its SSN shift count is ``offset + i*(stride-1)``.

``stride`` and ``offset`` may be Python ints or 0-dim integer tensors
(int32 arithmetic, floor division as in the reference); ``n`` and ``vl``
are Python ints.  The counts come back as int32 shift and bool valid
tensors on ``device``.

The compaction counts (:func:`compaction_counts`,
:func:`expansion_counts`) are the routing of MoE dispatch: computed on
the mask's device with int32 torch ops, no host sync.
"""
from __future__ import annotations

import torch


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def gather_counts(n: int, stride, offset, vl, *, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(shiftcnt, valid) over input window positions 0..n-1 for a strided
    load; valid[p] marks positions that hold one of the ``vl`` elements."""
    p = torch.arange(n, dtype=torch.int32, device=device)
    step = torch.clamp(_int32(stride, device), min=1)
    rel = p - _int32(offset, device)
    dest = rel // step
    valid = (rel >= 0) & (rel % step == 0) & (dest < vl)
    shift = torch.where(valid, p - dest, torch.zeros_like(p))
    return shift, valid


def scatter_counts(n: int, stride, offset, vl, *, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(shiftcnt, valid) over dense input positions 0..n-1 for a strided
    store."""
    i = torch.arange(n, dtype=torch.int32, device=device)
    valid = i < vl
    shift = torch.where(valid, _int32(offset, device)
                        + i * (_int32(stride, device) - 1),
                        torch.zeros_like(i))
    return shift, valid


def segment_gather_counts(n: int, fields, field, vl, *, device=None):
    """Field-wise segment load (EARTH §5.2): field ``field`` of an AoS
    window is a strided gather with stride=fields, offset=field."""
    return gather_counts(n, fields, field, vl, device=device)


def segment_scatter_counts(n: int, fields, field, vl, *, device=None):
    return scatter_counts(n, fields, field, vl, device=device)


def column_access_counts(n: int, emul_elen_elems, vl, *, device=None):
    """RCVRF column access (EARTH §4.5.2): after the block rotate,
    collecting element j of registers V0..V7 is a constant-stride gather
    with stride = EMUL*ELEN expressed in elements."""
    return gather_counts(n, emul_elen_elems, 0, vl, device=device)


def compaction_counts(mask: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """SCG for mask compaction (the routing of MoE dispatch): selected
    position ``p`` moves to ``rank(p) = #selected before p``, an
    order-preserving, separation-non-increasing map, hence GSN-safe."""
    mask = mask.to(torch.bool)
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    shift = torch.where(mask, pos - rank, torch.zeros_like(pos))
    return shift, mask


def expansion_counts(mask: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SCG for the inverse: packed element k lands at the k-th set
    position of ``mask``; its SSN count is ``target(k) - k``
    (order-preserving, separation-non-decreasing, hence SSN-safe).

    ``target`` places each set position p at slot rank(p) of an ``n + 1``
    buffer whose last slot takes every unset position and is dropped (the
    reference's drop-mode scatter)."""
    mask = mask.to(torch.bool)
    n = mask.shape[0]
    total = mask.to(torch.int32).sum()
    pos = torch.arange(n, dtype=torch.int32, device=mask.device)
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(mask, rank, torch.full_like(rank, n)).to(torch.int64)
    targets = torch.zeros((n + 1,), dtype=torch.int32, device=mask.device)
    targets.scatter_(0, slot, torch.where(mask, pos, torch.zeros_like(pos)))
    valid = pos < total
    shift = torch.where(valid, targets[:n] - pos, torch.zeros_like(pos))
    return shift, valid
