"""Plain PyTorch oracles for every kernel of the reference package.

Port of ``repro``'s ``kernels/ref.py``: all eight oracles, as torch ops.
They define the semantics every kernel must match (DESIGN.md §4) and are
the ``ref`` lowering of the vx layer.  Nothing here waits for a later
slice.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Strided access (LSDO semantics)
# ---------------------------------------------------------------------------

def gather_strided(window: torch.Tensor, stride: int, offset: int,
                   vl: int) -> torch.Tensor:
    """(..., n) -> (..., vl): out[..., i] = window[..., offset + i*stride]."""
    n = window.shape[-1]
    limit = offset + (vl - 1) * stride + 1
    assert limit <= n, f"strided read past window: {limit} > {n}"
    return window[..., offset:limit:stride].contiguous()


def scatter_strided(window: torch.Tensor, values: torch.Tensor, stride: int,
                    offset: int) -> torch.Tensor:
    """Inverse of gather_strided: place values at strided positions."""
    vl = values.shape[-1]
    limit = offset + (vl - 1) * stride + 1
    assert limit <= window.shape[-1]
    out = window.clone()
    out[..., offset:limit:stride] = values
    return out


# ---------------------------------------------------------------------------
# Segment access (RCVRF semantics): AoS <-> SoA
# ---------------------------------------------------------------------------

def deinterleave(aos: torch.Tensor, fields: int) -> list[torch.Tensor]:
    """(..., fields*m) AoS -> fields tensors (..., m)."""
    assert aos.shape[-1] % fields == 0
    m = aos.shape[-1] // fields
    r = aos.reshape(aos.shape[:-1] + (m, fields))
    return [r[..., f] for f in range(fields)]


def interleave(soa: list[torch.Tensor]) -> torch.Tensor:
    """fields tensors (..., m) -> (..., fields*m) AoS."""
    stacked = torch.stack(list(soa), dim=-1)      # (..., m, fields)
    return stacked.reshape(stacked.shape[:-2] + (-1,))


# ---------------------------------------------------------------------------
# Row compaction / expansion (MoE dispatch semantics)
# ---------------------------------------------------------------------------

def compact_rows(rows: torch.Tensor, mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack rows where mask is set to the front (stable); zero-fill the rest.

    rows: (n, d...); mask: (n,) bool. Returns (packed, packed_valid)."""
    n = rows.shape[0]
    mask = mask.to(torch.bool)
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    packed = rows[order]
    total = mask.to(torch.int32).sum()
    packed_valid = torch.arange(n, device=rows.device) < total
    keep = packed_valid.reshape((n,) + (1,) * (rows.ndim - 1))
    return torch.where(keep, packed, torch.zeros_like(packed)), packed_valid


def expand_rows(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Inverse of compact_rows: packed[k] -> position of k-th set bit."""
    n = packed.shape[0]
    mask = mask.to(torch.bool)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    src = torch.where(mask, rank, torch.full_like(rank, n))  # n -> zero row
    padded = torch.cat([packed, torch.zeros_like(packed[:1])], dim=0)
    got = padded[src]
    keep = mask.reshape((n,) + (1,) * (packed.ndim - 1))
    return torch.where(keep, got, torch.zeros_like(got))


# ---------------------------------------------------------------------------
# Interleaved KV cache (segment FIELD=2 over the feature dim)
# ---------------------------------------------------------------------------

def kv_interleave(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., d), (..., d) -> (..., 2d) with [k0, v0, k1, v1, ...] layout."""
    return interleave([k, v])


def kv_split(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    k, v = deinterleave(kv, 2)
    return k, v
