"""Attention: GQA/MQA + RoPE + optional qk-norm + sliding window, as torch
ops.

Port of ``repro``'s ``models/attention.py``: ``qkv_project``,
``decode_attention`` and ``chunk_attention``.  The reference writes these
in plain jnp (no Pallas kernel), so the port uses ``torch.matmul`` and
``einsum``.  Scores and the softmax run in float32 (the reference's
``preferred_element_type=float32``).  ``flash_attention`` (training and
dense prefill), cross-attention and the encoder projections wait for a
later slice.

EARTH integration: the fused KV projection emits each head's K/V
interleaved along features — one contiguous beat per token, written to
the interleaved KV cache in one transaction and split with the FIELD=2
segment kernel.
"""
from __future__ import annotations

import torch

from repro_torch import vx
from repro_torch.models import layers

NEG_INF = -1e30


def qkv_project(params, x: torch.Tensor, n_heads: int, n_kv: int,
                head_dim: int, positions: torch.Tensor, rope_theta: float,
                *, policy=None):
    """x: (B, S, d) -> q (B,S,H,D), k, v (B,S,K,D), and the interleaved
    post-RoPE kv beat (B,S,K,2D)."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    kv = (x @ params["wkv"]).reshape(B, S, n_kv, 2 * head_dim)
    k, v = vx.transpose(vx.Segment(n=kv.shape[-1], fields=2), kv,
                        policy=policy)
    if params.get("q_norm") is not None:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    q = layers.rope(q, positions, rope_theta)
    k = layers.rope(k, positions, rope_theta)
    kv = vx.transpose(vx.Segment(n=kv.shape[-1], fields=2),
                      [k.contiguous(), v.contiguous()],
                      policy=policy)              # re-pack post-RoPE beat
    return q, k, v, kv


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum(eq, p / torch.clamp(l, min=1e-30), v.float())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-token decode. q: (B, H, D); caches: (B, S, K, D).  Masks
    positions >= cache_len (a scalar or (B, 1)) and outside the window."""
    B, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qt = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qt.float(),
                     k_cache.to(q.dtype).float()) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device)
    mask = pos[None, :] < cache_len
    if window is not None:
        mask = mask & (pos[None, :] >= (cache_len - window))
    mask = mask[:, None, None, :] if mask.ndim == 2 \
        else mask[None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    out = _softmax_pv(s, v_cache.to(q.dtype), "bkgs,bskd->bkgd")
    return out.reshape(B, H, D).to(q.dtype)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, q_pos: torch.Tensor, *,
                    window: int | None = None) -> torch.Tensor:
    """C-query prefill-chunk attention.  q: (B, C, H, D); caches:
    (B, S, K, D); ``q_pos``: (C,) absolute query positions, or (B, C).
    Query ``i`` attends to cache positions ``j <= q_pos[i]`` (and, for
    windowed layers, ``q_pos[i] - j < window``)."""
    B, C, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qt = q.reshape(B, C, K, G, D)
    s = torch.einsum("bckgd,bskd->bkgcs", qt.float(),
                     k_cache.to(q.dtype).float()) * D ** -0.5
    j = torch.arange(S, device=q.device)
    if q_pos.ndim == 2:                              # (B, C) per-row offsets
        mask = j[None, None, :] <= q_pos[:, :, None]
        if window is not None:
            mask = mask & ((q_pos[:, :, None] - j[None, None, :]) < window)
        mask = mask[:, None, None]
    else:
        mask = j[None, :] <= q_pos[:, None]          # (C, S)
        if window is not None:
            mask = mask & ((q_pos[:, None] - j[None, :]) < window)
        mask = mask[None, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    out = _softmax_pv(s, v_cache.to(q.dtype), "bkgcs,bskd->bkgcd")
    return torch.movedim(out, 3, 1).reshape(B, C, H, D).to(q.dtype)
