"""Attention: GQA/MQA + RoPE + optional qk-norm + sliding window, as torch
ops.

Port of ``repro``'s ``models/attention.py``: ``qkv_project``,
``flash_attention`` (the forward), ``decode_attention`` and
``chunk_attention``.  The reference writes these in plain jnp (no Pallas
kernel), so the port uses ``torch.matmul`` and ``einsum``.  Scores and the
softmax run in float32 (the reference's ``preferred_element_type=float32``).
Waiting for later slices: ``flash_attention``'s backward (``_flash_bwd``,
with training), its sharding constraints (with ``dist``), cross-attention
and the encoder projections.

EARTH integration: the fused KV projection emits each head's K/V
interleaved along features — one contiguous beat per token, written to
the interleaved KV cache in one transaction and split with the FIELD=2
segment kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import vx
from repro_torch.device import refuse_mesh
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


def _flash_body(q, k, *, q_pos, kv_pos, causal, window, scale, kv_len):
    """One (Q-chunk x KV-chunk) score tile. q: (B,K,G,Qc,D); k: (B,Kc,K,D).
    Masking is an ADDITIVE (Qc, Kc) float32 bias, as in the reference."""
    s = torch.einsum("bkgqd,bskd->bkgqs", q.float(), k.float()) * scale
    dq = q_pos[:, None]
    dk = kv_pos[None, :]
    mask = dk < kv_len                    # padded KV tail is invalid
    if causal:
        mask = mask & (dq >= dk)
    if window is not None:
        mask = mask & ((dq - dk) < window)
    bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)   # (Qc, Kc)
    return s + bias[None, None, None]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 512, ctx=None) -> torch.Tensor:
    """Chunked flash attention, forward only.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H = K*G.  Returns
    (B, Sq, H, D) in ``q``'s dtype.  The reference's algorithm: an online
    softmax over KV chunks for each Q chunk, so the S x S score matrix is
    never materialized; ragged sequences pad to chunk multiples (padded KV
    masked by the true length, padded Q rows sliced off); sliding-window
    layers visit only the diagonal band of KV chunks.  The backward (the
    reference's ``_flash_bwd``) waits for the training slice; a ``ctx``
    with a mesh waits for ``dist``."""
    refuse_mesh(ctx)
    Sq0, Sk0 = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, Sq0)
    kv_chunk = min(kv_chunk, Sk0)
    pad_q = (-Sq0) % q_chunk
    pad_k = (-Sk0) % kv_chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    return _flash_fwd(q, k, v, causal, window, q_offset, q_chunk, kv_chunk,
                      Sk0)[:, :Sq0]


def _flash_fwd(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, Sk0):
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    qr = q.reshape(B, Sq // q_chunk, q_chunk, K, G, D)
    dev = q.device
    banded = window is not None and Sk > window + q_chunk
    if banded:
        band = min(-(-(window + q_chunk) // kv_chunk) * kv_chunk, Sk)
    outs = []
    for qi in range(Sq // q_chunk):
        qt = qr[:, qi].permute(0, 2, 3, 1, 4)           # (B, K, G, Qc, D)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        if banded:
            start = min(max(q_offset + qi * q_chunk + q_chunk - band, 0),
                        Sk - band)
            kb, vb = k[:, start:start + band], v[:, start:start + band]
            kv_pos0, n_kv_chunks = start, band // kv_chunk
        else:
            kb, vb, kv_pos0, n_kv_chunks = k, v, 0, Sk // kv_chunk
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for si in range(n_kv_chunks):
            lo = si * kv_chunk
            ks, vs = kb[:, lo:lo + kv_chunk], vb[:, lo:lo + kv_chunk]
            kv_pos = kv_pos0 + lo + torch.arange(kv_chunk, device=dev)
            s = _flash_body(qt, ks, q_pos=q_pos, kv_pos=kv_pos,
                            causal=causal, window=window, scale=scale,
                            kv_len=Sk0)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, vs.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(torch.movedim(out.reshape(B, H, q_chunk, D), 1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


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
