"""Attention: GQA/MQA + RoPE + optional qk-norm + sliding window + cross,
as torch ops.

Port of ``repro``'s ``models/attention.py``: ``qkv_project``,
``flash_attention`` (forward and backward), ``decode_attention``,
``chunk_attention`` and whisper's ``cross_attention``,
``init_cross_attention`` and ``encoder_kv``.  The reference writes these
in plain jnp (no Pallas kernel), so the port uses ``torch.matmul`` and
``einsum``.  Scores and the softmax run in float32 (the reference's
``preferred_element_type=float32``).  ``flash_attention``'s backward is
the reference's ``_flash_bwd`` (its ``custom_vjp``) as a
``torch.autograd.Function``: it recomputes each score tile from the saved
``q``, ``k``, ``v``, ``out`` and log-sum-exp and accumulates ``dq``,
``dk`` and ``dv`` in float32.  ``decode_attention`` also runs over a
sequence-sharded cache (``shard=``) as a distributed softmax;
``flash_attention`` under a mesh attends each rank's batch block (the
reference's sharding constraints are placement hints).  Under tensor
parallelism :func:`qkv_project_tp` runs on a rank's blocks (``wq``
columns, ``wkv`` rows, ``wo`` rows; its pieces :func:`tp_own`,
:func:`tp_q`, :func:`tp_beat` and :func:`tp_rows` also serve whisper's
encoder) and :func:`cross_attention_tp` on its column blocks of the
cross-attention tree.

EARTH integration: the fused KV projection emits each head's K/V
interleaved along features — one contiguous beat per token, written to
the interleaved KV cache in one transaction and split with the FIELD=2
segment kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import vx
from repro_torch.models import layers

NEG_INF = -1e30


def init_attention(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   g: torch.Generator, *, qk_norm: bool, dtype,
                   device) -> dict:
    """The reference's attention tree: ``wq``, the interleaved ``wkv``
    (K/V output features stacked per head -> one coalesced beat per head),
    ``wo`` and, with ``qk_norm``, the q / k norm scales; seeded."""
    s = d_model ** -0.5
    wq = layers.normal((d_model, n_heads * head_dim), s, g, dtype, device)
    wk = layers.normal((d_model, n_kv, head_dim), s, g, dtype, device)
    wv = layers.normal((d_model, n_kv, head_dim), s, g, dtype, device)
    p = {"wq": wq,
         "wkv": torch.stack([wk, wv], dim=-1).reshape(
             d_model, n_kv * 2 * head_dim),
         "wo": layers.normal((n_heads * head_dim, d_model),
                             (n_heads * head_dim) ** -0.5, g, dtype, device)}
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
    return p


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


def tp_own(n_heads: int, n_kv: int, rl, all_heads: bool = False) -> bool:
    """Whether this rank's query heads are its own block of them (``m``,
    the model axis's size, divides the heads, and they attend one block
    of KV heads or one KV head), else every head (the query columns
    gathered)."""
    m, g = rl.tp_size, n_heads // n_kv
    return not all_heads and n_heads % m == 0 and (
        n_kv % m == 0 or g % (n_heads // m) == 0)


def tp_q(params, x: torch.Tensor, head_dim: int, rl,
         own: bool) -> torch.Tensor:
    """``q`` (B, S, Hq, D) from this rank's ``wq`` columns: its own heads,
    or every head (the columns gathered over the model axis)."""
    from repro_torch.dist import sharding
    B, S = x.shape[:2]
    q = x @ params["wq"]
    if not own:
        q = sharding.gather_seq(q, rl.tp.mesh, rl.tp_axis, -1)
    return q.reshape(B, S, q.shape[-1] // head_dim, head_dim)


def tp_beat(params, x: torch.Tensor, n_kv: int, head_dim: int, rl,
            own: bool) -> torch.Tensor:
    """The kv beat (B, S, K', 2D) of ``x``: on a row block of ``wkv`` the
    rank's slice of ``x``'s features makes a partial beat, summed over
    the model axis before any split (for one position in float32,
    rounded once to ``x``'s dtype, as the one-device product rounds);
    cut to the rank's block of KV heads where its query heads are its
    own and ``m`` divides the KV heads, else every KV head."""
    from repro_torch.dist import sharding
    mesh, axis, m, r = rl.tp.mesh, rl.tp_axis, rl.tp_size, rl.tp_index
    B, S, d = x.shape
    wkv = params["wkv"]
    if wkv.shape[0] != d:
        n = wkv.shape[0]
        xr = x[..., r * n:(r + 1) * n]
        if S == 1:   # one position: the parts in float32, rounded once
            kv = sharding.all_sum(xr.float() @ wkv.float(), mesh,
                                  axis).to(x.dtype)
        else:
            kv = sharding.all_sum(xr @ wkv, mesh, axis)
    else:
        kv = x @ wkv
    kv = kv.reshape(B, S, n_kv, 2 * head_dim)
    if own and n_kv % m == 0:
        kv = kv[:, :, r * (n_kv // m):(r + 1) * (n_kv // m)]
    return kv


def _group_head(k, v, n_heads: int, n_kv: int, rl, own: bool):
    """Where the rank's own query heads lie in one GQA group of KV heads
    the axis does not split: that one KV head's k and v."""
    if own and n_kv % rl.tp_size:
        j = rl.tp_index * (n_heads // rl.tp_size) // (n_heads // n_kv)
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    return k, v


def qkv_project_tp(params, x: torch.Tensor, n_heads: int, n_kv: int,
                   head_dim: int, positions: torch.Tensor, rope_theta: float,
                   rl, *, policy=None, all_heads: bool = False):
    """:func:`qkv_project` on this rank's tensor-parallel blocks (``rl`` a
    ``RankLocal`` with ``tp``, of ``m`` ranks, this one ``r``): ``wq``
    its block of columns, ``wkv`` its block of rows (or whole).

    The rank's query heads are its columns of ``wq`` where ``m`` divides
    the heads and they attend one block of KV heads (``m`` divides the KV
    heads) or one KV head (they lie in one GQA group); else, or with
    ``all_heads``, every head, the columns gathered (:func:`tp_own`,
    :func:`tp_q`).  The kv beat is whole: on a row block of ``wkv`` a
    partial beat summed before the split (:func:`tp_beat`).  Returns
    ``q`` (B, S, Hq, D), the ``k`` / ``v`` its query heads attend, and
    the post-RoPE beat of the KV heads it keeps (its block where ``m``
    divides them and its query heads are its own, else every KV
    head)."""
    own = tp_own(n_heads, n_kv, rl, all_heads)
    q = tp_q(params, x, head_dim, rl, own)
    kv = tp_beat(params, x, n_kv, head_dim, rl, own)
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
    k, v = _group_head(k, v, n_heads, n_kv, rl, own)
    return q, k, v, kv


def tp_rows(o: torch.Tensor, wo: torch.Tensor, rl) -> torch.Tensor:
    """The heads' output ``o`` (..., Hq D) cut to the rows of this rank's
    block of ``wo`` where the rank attended every head."""
    n = wo.shape[0]
    if o.shape[-1] == n:
        return o
    return o[..., rl.tp_index * n:(rl.tp_index + 1) * n]


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
    """Chunked flash attention with the reference's memory-safe backward.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H = K*G.  Returns
    (B, Sq, H, D) in ``q``'s dtype.  The reference's algorithm: an online
    softmax over KV chunks for each Q chunk, so the S x S score matrix is
    never materialized; ragged sequences pad to chunk multiples (padded KV
    masked by the true length, padded Q rows sliced off; the pad and the
    slice differentiate exactly); sliding-window layers visit only the
    diagonal band of KV chunks.  A causal Q chunk stops at the last KV
    chunk it can see: the tiles after it are wholly masked and add exactly
    nothing (their ``p`` is 0 and their correction 1).  The backward saves
    only ``(q, k, v, out, lse)`` and recomputes one score tile at a time.

    Under a ``ctx`` with a mesh (the reference's placement hints, which
    change no value) rows are independent: plain operands are attended as
    given, and ``DTensor`` operands placed on the batch over the data
    axes are attended block by block, the output placed alike."""
    from repro_torch.dist import sharding
    if sharding.meshed(ctx) and sharding.is_dtensor(q):
        spec = sharding.P(*ctx.batch_spec())
        out = flash_attention(
            *(sharding.local_block(t, ctx.mesh, spec) for t in (q, k, v)),
            causal=causal, window=window, q_offset=q_offset,
            q_chunk=q_chunk, kv_chunk=kv_chunk)
        return sharding.from_local(out, ctx.mesh, spec)
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
    out = _Flash.apply(q, k, v, causal, window, q_offset, q_chunk, kv_chunk,
                       Sk0)
    return out[:, :Sq0]


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward ``_flash_fwd``,
    backward ``_flash_bwd``; the chunking arguments are not
    differentiated."""

    @staticmethod
    def forward(fctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk,
                Sk0):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, q_chunk,
                              kv_chunk, Sk0)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.args = (causal, window, q_offset, q_chunk, kv_chunk, Sk0)
        return out

    @staticmethod
    def backward(fctx, g):
        dq, dk, dv = _flash_bwd(*fctx.args, *fctx.saved_tensors, g)
        return (dq, dk, dv) + (None,) * 6


def _flash_fwd(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, Sk0):
    """(out (B, Sq, H, D) in q's dtype, lse (B, K, G, Sq) float32)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    qr = q.reshape(B, Sq // q_chunk, q_chunk, K, G, D)
    dev = q.device
    banded = window is not None and Sk > window + q_chunk
    if banded:
        band = min(-(-(window + q_chunk) // kv_chunk) * kv_chunk, Sk)
    outs, lses = [], []
    for qi in range(Sq // q_chunk):
        qt = qr[:, qi].permute(0, 2, 3, 1, 4)           # (B, K, G, Qc, D)
        q_lo = q_offset + qi * q_chunk
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        if banded:
            start = min(max(q_lo + q_chunk - band, 0), Sk - band)
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
            if causal and kv_pos0 + lo > q_lo + q_chunk - 1:
                break                     # wholly masked from here on
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
        l_safe = torch.clamp(l, min=1e-30)
        out = acc / l_safe[..., None]
        outs.append(torch.movedim(out.reshape(B, H, q_chunk, D), 1, 2))
        lses.append(m + torch.log(l_safe))              # (B, K, G, Qc)
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=-1)


def _flash_bwd(causal, window, q_offset, q_chunk, kv_chunk, Sk0, q, k, v,
               out, lse, g):
    """The reference's tile-recomputing backward: per Q chunk, ``dq``
    accumulated over KV chunks, ``dk`` / ``dv`` accumulated across Q
    chunks, all in float32.  A tile wholly masked (causal, or outside the
    window) has ``p == 0`` and is skipped: it adds exactly zero."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    dev = q.device

    def bkgsd(t):
        return t.reshape(B, Sq, K, G, D).permute(0, 2, 3, 1, 4)

    qt = bkgsd(q)
    gt = bkgsd(g).float()
    ot = bkgsd(out).float()
    delta = torch.sum(gt * ot, dim=-1)                  # (B, K, G, Sq)
    dk = torch.zeros((B, Sk, K, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, K, D), dtype=torch.float32, device=dev)
    dq_chunks = []
    for qi in range(Sq // q_chunk):
        sl = slice(qi * q_chunk, (qi + 1) * q_chunk)
        q_i = qt[:, :, :, sl].float()
        g_i = gt[:, :, :, sl]
        lse_i, delta_i = lse[..., sl], delta[..., sl]
        q_lo = q_offset + qi * q_chunk
        q_hi = q_lo + q_chunk - 1
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        dq_i = torch.zeros((B, K, G, q_chunk, D), dtype=torch.float32,
                           device=dev)
        for si in range(Sk // kv_chunk):
            lo = si * kv_chunk
            if (causal and lo > q_hi) or \
                    (window is not None and q_lo - (lo + kv_chunk - 1)
                     >= window):
                continue
            ks = k[:, lo:lo + kv_chunk].float()
            vs = v[:, lo:lo + kv_chunk].float()
            kv_pos = lo + torch.arange(kv_chunk, device=dev)
            s = _flash_body(q_i, ks, q_pos=q_pos, kv_pos=kv_pos,
                            causal=causal, window=window, scale=scale,
                            kv_len=Sk0)
            p = torch.exp(s - lse_i[..., None])          # (B,K,G,Qc,Kc)
            dv_c = torch.einsum("bkgqs,bkgqd->bskd", p, g_i)
            dp = torch.einsum("bkgqd,bskd->bkgqs", g_i, vs)
            ds = p * (dp - delta_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bkgqs,bskd->bkgqd", ds, ks)
            dk_c = torch.einsum("bkgqs,bkgqd->bskd", ds, q_i)
            dk[:, lo:lo + kv_chunk] += dk_c
            dv[:, lo:lo + kv_chunk] += dv_c
        dq_chunks.append(dq_i)
    dq = torch.cat(dq_chunks, dim=3)                    # (B, K, G, Sq, D)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum(eq, p / torch.clamp(l, min=1e-30), v.float())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None, shard=None) -> torch.Tensor:
    """Single-token decode. q: (B, H, D); caches: (B, S, K, D).  Masks
    positions >= cache_len (a scalar or (B, 1)) and outside the window.

    ``shard`` (a ``vx.Shard`` on the caches' sequence axis, -3) takes
    caches sharded over its mesh axes (``DTensor`` s so placed, or plain
    full caches each rank slices): each rank scores its block at its
    global positions, and the softmax merges across ranks, the max with
    one ``pmax``, the sum and the weighted values with one ``psum`` of
    both.
    A rank whose positions are all masked adds ``exp(NEG_INF - m) = 0``.
    Every rank returns the whole result."""
    B, H, D = q.shape
    k_cache, v_cache, base = _seq_blocks(k_cache, v_cache, shard)
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qt = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qt.float(),
                     k_cache.to(q.dtype).float()) * D ** -0.5
    pos = torch.arange(S, device=q.device) + base
    cache_len = torch.as_tensor(cache_len, device=q.device)
    mask = pos[None, :] < cache_len
    if window is not None:
        mask = mask & (pos[None, :] >= (cache_len - window))
    mask = mask[:, None, None, :] if mask.ndim == 2 \
        else mask[None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if shard is None:
        out = _softmax_pv(s, v_cache.to(q.dtype), "bkgs,bskd->bkgd")
    else:
        from repro_torch.dist import sharding
        mesh, axes = shard.mesh, shard.axes
        m = sharding.pmax(torch.amax(s, dim=-1, keepdim=True), mesh, axes)
        p = torch.exp(s - m)
        # the partial sums and the unnormalized values in one psum; the
        # division by the whole sum after it
        lo = sharding.psum(torch.cat(
            [torch.sum(p, dim=-1, keepdim=True),
             torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(q.dtype).float())],
            dim=-1), mesh, axes)
        out = lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def _seq_blocks(k_cache, v_cache, shard):
    """The rank's blocks of caches sharded on their sequence axis, and the
    global position of the blocks' first slot (0 unsharded)."""
    if shard is None:
        return k_cache, v_cache, 0
    from repro_torch.dist import sharding
    if shard.axis != -3:
        raise ValueError(f"decode attention shards the cache's sequence "
                         f"axis: Shard.axis must be -3, got {shard.axis}")
    spec = sharding.P(None, shard.axes)
    k = sharding.local_block(k_cache, shard.mesh, spec)
    v = sharding.local_block(v_cache, shard.mesh, spec)
    return k, v, shard.index() * k.shape[1]


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


def cross_attention(params, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, n_heads: int, n_kv: int,
                    head_dim: int, ctx=None) -> torch.Tensor:
    """Decoder cross-attention over the encoder output (whisper): no RoPE,
    no mask, over every encoder frame."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    out = flash_attention(q, enc_k, enc_v, causal=False, window=None,
                          q_chunk=min(512, S),
                          kv_chunk=min(512, enc_k.shape[1]), ctx=ctx)
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"]


def cross_attention_tp(params, x: torch.Tensor, enc_out: torch.Tensor,
                       n_heads: int, n_kv: int, head_dim: int, rl, *,
                       policy=None) -> tuple:
    """:func:`cross_attention` on this rank's blocks of the
    cross-attention tree over the whole encoder output ``enc_out``:
    ``wq`` on its columns, ``wkv`` on its columns (whole KV heads' beats
    where the model axis divides the KV heads), its rows (a partial beat
    summed before the split, :func:`tp_beat`) or whole, ``wo`` on its
    columns or its rows, as the reference's rules place whisper's stacked
    cross leaves.  Where the axis divides the heads and the KV heads the
    rank attends its own heads, else every head (the query columns and a
    column block's beats gathered); the FIELD=2 split runs under
    ``policy``.  Returns ``(y, partial)``: on ``wo``'s rows the rank's
    partial sum (``partial`` True), on its columns the whole output (the
    heads' outputs gathered, the rank's output features gathered in
    turn)."""
    from repro_torch.dist import sharding
    mesh, axis, m = rl.tp.mesh, rl.tp_axis, rl.tp_size
    own = tp_own(n_heads, n_kv, rl) and n_kv % m == 0
    q = tp_q(params, x, head_dim, rl, own)
    B, S = x.shape[:2]
    F = enc_out.shape[1]
    wkv, wo = params["wkv"], params["wo"]
    if wkv.shape[1] != n_kv * 2 * head_dim:
        kv = enc_out @ wkv                    # its column block of beats
        if not own:
            kv = sharding.gather_seq(kv, mesh, axis, -1)
        kv = kv.reshape(B, F, -1, 2 * head_dim)
    else:
        kv = tp_beat(params, enc_out, n_kv, head_dim, rl, own)
    k, v = vx.transpose(vx.Segment(n=kv.shape[-1], fields=2), kv,
                        policy=policy)
    out = flash_attention(q, k, v, causal=False, window=None,
                          q_chunk=min(512, S), kv_chunk=min(512, F))
    o = out.reshape(B, S, -1)
    if wo.shape[0] != n_heads * head_dim:
        return tp_rows(o, wo, rl) @ wo, True
    if own:
        o = sharding.gather_seq(o, mesh, axis, -1)
    return sharding.gather_seq(o @ wo, mesh, axis, -1), False


def init_cross_attention(d_model: int, n_heads: int, n_kv: int,
                         head_dim: int, g: torch.Generator, dtype,
                         device) -> dict:
    """The reference's cross-attention tree: ``wq``, the interleaved
    ``wkv`` and ``wo`` (no qk norms), seeded."""
    return init_attention(d_model, n_heads, n_kv, head_dim, g,
                          qk_norm=False, dtype=dtype, device=device)


def encoder_kv(params, enc_out: torch.Tensor, n_kv: int, head_dim: int,
               *, policy=None):
    """Project the encoder output to (k, v) (B, F, K, D): one interleaved
    beat per frame, split by the FIELD=2 segment load."""
    B, S, _ = enc_out.shape
    kv = (enc_out @ params["wkv"]).reshape(B, S, n_kv, 2 * head_dim)
    return vx.transpose(vx.Segment(n=kv.shape[-1], fields=2), kv,
                        policy=policy)
