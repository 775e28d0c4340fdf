"""MoE token compaction through the EARTH gather network (row routing):
the wrapper for CUDA kernel B10.

Port of ``repro``'s ``kernels/moe_compact.py``.  Packing the tokens routed
to an expert to the front of a block is an order-preserving,
separation-non-increasing map, the GSN-safe class; its shift counts are a
prefix sum of the routing mask (``scg.compaction_counts``).  The inverse
(expansion) scatters packed rows back to the token slots through the SSN.

The per-layer take-masks depend only on the (n,) counts, so
:func:`_route_rows` derives them once outside the kernel
(``shiftnet.layer_masks``, torch ops on the card) and hands the (L, n)
stack to :func:`route_rows`, which launches kernel B10 in
``csrc/indexed.cu`` for CUDA tensors (one launch per call) and runs the
plain version :func:`route_rows_plain` (``shiftnet.apply_layer_masks``
plus a select) for CPU tensors.  With ``n <= 1`` there is no layer and no
launch, only the select, as in the reference.  :func:`route_rows` counts
``calls`` and ``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core import scg, shiftnet
from repro_torch.kernels import _common, _indexed

#: Rows a B10 block copies at most (their source indices sit in shared
#: memory).  Below that the wrapper sizes the grid at eight blocks per SM,
#: so enough 16-byte copies are in flight to cover the memory latency.
MAX_ROWS_PER_BLOCK = 64


def _keep(out_valid: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return out_valid.to(torch.bool).reshape(
        (rows.shape[0],) + (1,) * (rows.ndim - 1))


def route_rows_plain(rows: torch.Tensor, masks: torch.Tensor,
                     out_valid: torch.Tensor, *, toward_zero: bool,
                     lsb_first: bool) -> torch.Tensor:
    """The plain version of kernel B10 (the reference's ``_route_kernel``):
    ``rows`` (n, ...) through the (L, n) take-masks along axis 0, then
    zero outside ``out_valid``."""
    routed = shiftnet.apply_layer_masks(rows, masks.to(torch.bool), axis=0,
                                        toward_zero=toward_zero,
                                        lsb_first=lsb_first)
    return torch.where(_keep(out_valid, rows), routed,
                       torch.zeros_like(routed))


def _unit(nbytes: int, *ptrs: int) -> int:
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) that divides a row of
    ``nbytes`` and every pointer."""
    for u in (16, 8, 4, 2):
        if nbytes % u == 0 and all(p % u == 0 for p in ptrs):
            return u
    return 1


def route_rows(rows: torch.Tensor, masks: torch.Tensor,
               out_valid: torch.Tensor, *, toward_zero: bool,
               lsb_first: bool) -> torch.Tensor:
    """Route ``rows`` (n, ...) as units along axis 0 through precomputed
    (L, n) take-masks, zero outside ``out_valid`` (n,) (kernel B10)."""
    route_rows.calls += 1
    n = rows.shape[0]
    L = masks.shape[0]
    if masks.shape[-1] != n or out_valid.shape[0] != n:
        raise ValueError(f"masks {tuple(masks.shape)} / out_valid "
                         f"{tuple(out_valid.shape)} do not match {n} rows")
    if rows.device.type == "cpu":
        return route_rows_plain(rows, masks, out_valid,
                                toward_zero=toward_zero, lsb_first=lsb_first)
    _common.check_cuda(rows, "route_rows")
    out = torch.empty_like(rows)
    row_bytes = rows[0].numel() * rows.element_size() if n else 0
    if not row_bytes:
        return out
    m = masks.to(rows.device, torch.bool).contiguous()
    keep = out_valid.to(rows.device, torch.bool).contiguous()
    unit = _unit(row_bytes, rows.data_ptr(), out.data_ptr())
    per_block = max(1, min(MAX_ROWS_PER_BLOCK,
                           -(-n // (4 * _common.min_blocks(rows.device)))))
    lib = _indexed.lib()
    status = lib.route_rows(unit, rows.data_ptr(), out.data_ptr(),
                            m.data_ptr(), keep.data_ptr(), n,
                            row_bytes // unit, L, int(toward_zero),
                            int(lsb_first), per_block,
                            _common.cuda_stream(rows))
    _indexed.check(lib, status, "route_rows")
    route_rows.launches += 1
    return out


route_rows.calls = 0
route_rows.launches = 0


def _route_rows(rows: torch.Tensor, shift: torch.Tensor, valid: torch.Tensor,
                out_valid: torch.Tensor, *, toward_zero: bool,
                lsb_first: bool) -> torch.Tensor:
    """Shared compact/expand path: derive the (L, n) masks, then one
    kernel launch (none for n <= 1: nothing can move)."""
    masks, _ = shiftnet.layer_masks(shift, valid, toward_zero=toward_zero,
                                    lsb_first=lsb_first)
    if masks.shape[0] == 0:
        return torch.where(_keep(out_valid, rows), rows,
                           torch.zeros_like(rows))
    return route_rows(rows, masks, out_valid, toward_zero=toward_zero,
                      lsb_first=lsb_first)


def compact_rows(rows: torch.Tensor, mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack masked (n, d) rows to the front (stable).  Returns
    ``(packed, valid)``."""
    n = rows.shape[0]
    shift, valid = scg.compaction_counts(mask)
    packed_valid = torch.arange(n, device=mask.device) < \
        mask.to(torch.int32).sum()
    out = _route_rows(rows, shift, valid, packed_valid, toward_zero=True,
                      lsb_first=True)
    return out, packed_valid


def expand_rows(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scatter packed rows back to the set positions of ``mask`` (zeros
    elsewhere)."""
    shift, valid = scg.expansion_counts(mask)
    return _route_rows(packed, shift, valid, mask.to(torch.bool),
                       toward_zero=False, lsb_first=False)


KERNELS = (route_rows,)


def reset_counts() -> None:
    """Zero the wrapper's ``calls`` and ``launches``."""
    for fn in KERNELS:
        fn.calls = 0
        fn.launches = 0
