"""Interleaved (AoS) KV-cache ops — EARTH segment access applied to serving.

Port of ``repro``'s ``kernels/kv_interleaved.py``: ``interleave_kv``,
``split_kv``, ``split_kv_step``, ``gather_paged_kv``,
``append_paged_token`` over float pools, and the dense-cache
``append_token``.  Layout: ``cache[..., t, 2*d]`` holds ``[k0, v0, k1, v1,
...]`` per token — K and V of a token are one contiguous beat, and the
attention-time split is a FIELD=2 segment load.  Quantized ``scales=``
and ``shard=`` wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch import vx


def _spec(n: int) -> vx.Segment:
    return vx.Segment(n=n, fields=2)


def interleave_kv(k: torch.Tensor, v: torch.Tensor, *,
                  policy=None) -> torch.Tensor:
    """(..., d) x2 -> (..., 2d) AoS beat."""
    return vx.transpose(_spec(2 * k.shape[-1]), [k, v], policy=policy)


def split_kv(kv: torch.Tensor, *, policy=None):
    """(..., 2d) -> (k, v)."""
    k, v = vx.transpose(_spec(kv.shape[-1]), kv, policy=policy)
    return k, v


def split_kv_step(kvs: list[torch.Tensor], *, policy=None):
    """Whole-step KV split: EVERY layer's (…, 2d) cache in one fused FIELD=2
    segment load — one kernel launch per decode step instead of one per
    layer (core/accessfuse.py groups same-shape caches)."""
    from repro_torch.core import accessfuse
    return accessfuse.fuse_split_kv(kvs, policy=vx.resolve(policy))


def gather_paged_kv(pools: list[torch.Tensor], table: torch.Tensor,
                    page_size: int, *, policy=None,
                    fused: bool = True) -> list[torch.Tensor]:
    """Whole-step paged KV read: every layer's ``(NS, P, page_size, K, 2d)``
    pool gathered through ONE shared page table.  ``fused=True`` stacks
    the pools and runs one page-granular gather.  Returns the gathered
    interleaved ``(NS, B, pages*page_size, K, 2d)`` sequences."""
    spec = vx.Paged(page_size=page_size, pages=table.shape[-1], trail=2)
    if fused:
        return vx.gather_many(spec, pools, table=table, policy=policy)
    return [vx.gather(spec, p, table=table, policy=policy) for p in pools]


def append_paged_token(pool: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       table: torch.Tensor, pos, *, policy=None):
    """Write one token's interleaved KV beat through the page table.

    pool: (..., P, page_size, H, 2d); k, v: (B, H, d); pos: (B,) per-slot
    positions (rows with ``pos < 0`` or an unallocated page are dropped).
    Updates the pool in place and returns it."""
    beat = interleave_kv(k, v, policy=policy)             # (B, H, 2d)
    spec = vx.Paged(page_size=pool.shape[-3], pages=table.shape[-1],
                    trail=2)
    return vx.scatter(spec, pool, beat, table=table, pos=pos, policy=policy)


def append_token(cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 *, policy=None) -> torch.Tensor:
    """Write one token's interleaved KV beat at position ``pos``.

    cache: (B, S, H, 2d); k, v: (B, H, d); pos: one position for the whole
    batch (an int or a 0-dim tensor), taken as the reference's
    ``dynamic_update_slice`` takes it: a negative one counts from the end,
    then it is clamped into ``[0, S)``.  One beat write per layer instead
    of two (K and V).  Returns a new cache."""
    beat = interleave_kv(k, v, policy=policy)             # (B, H, 2d)
    S = cache.shape[1]
    pos = torch.as_tensor(pos, device=cache.device)
    slot = torch.clamp(torch.where(pos < 0, pos + S, pos), 0,
                       S - 1).reshape(1).long()
    return cache.index_copy(1, slot, beat[:, None].to(cache.dtype))
