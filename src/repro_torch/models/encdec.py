"""Whisper-style encoder-decoder backbone, as torch ops.

Port of ``repro``'s ``models/encdec.py``.  The conv/mel frontend is a stub,
as in the reference: the batch carries precomputed frame embeddings
``audio_frames`` (B, F, d_model).  The encoder is a bidirectional
transformer with sinusoidal positions; the decoder adds causal
self-attention over an interleaved KV cache and cross-attention over the
encoder's K/V.  The reference's quirks are kept: RoPE is applied in
``qkv_project`` on top of the decoder's sinusoid, the self-attention cache
is a ring written at ``pos % Sc``, and cross-attention runs over every
encoder frame.

Kernels: ``encode``'s FIELD=2 split of each layer's kv beat, ``encoder_kv``
once per decoder layer in :func:`forward`, and ``qkv_project``'s split
and re-pack go through ``cfg.vx_policy`` (B1 / B2 under ``kernel``, B6 /
B7 under ``kernel_dynamic``); :func:`decode_step` pins its cache splits to
``ref``, as the reference does.  Superblocks run in a Python loop; with
``cfg.remat != "none"`` and gradients on, each decoder layer runs under
``torch.utils.checkpoint``.  :func:`decode_step` writes the self-attention
ring in place (a step consumes the cache it is given), as the dense
decoder step does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import vx
from repro_torch.device import resolve as resolve_device
from repro_torch.models import attention, layers

I32 = torch.int32


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (log_base / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_encoder(cfg, g: torch.Generator, device) -> dict:
    """Stacked encoder blocks (self-attention + GELU MLP) and the final
    norm, seeded; leaves ``(n_layers, ...)``."""
    from repro_torch.models.transformer import _stack
    dt, d = cfg.pdtype, cfg.d_model

    def one():
        return {
            "ln1": torch.ones((d,), dtype=dt, device=device),
            "attn": attention.init_attention(
                d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, g, qk_norm=False,
                dtype=dt, device=device),
            "ln2": torch.ones((d,), dtype=dt, device=device),
            "mlp": layers.init_mlp(d, cfg.d_ff, g, dt, device),
        }

    return {"blocks": _stack([one() for _ in range(cfg.encoder.n_layers)]),
            "final_norm": torch.ones((d,), dtype=dt, device=device)}


def init_cross_stack(cfg, g: torch.Generator, device) -> dict:
    """Per-decoder-layer cross-attention params, stacked like blocks."""
    from repro_torch.models.transformer import _stack
    dt, d = cfg.pdtype, cfg.d_model
    return _stack([{"ln": torch.ones((d,), dtype=dt, device=device),
                    "xattn": attention.init_cross_attention(
                        d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, g, dt,
                        device)}
                   for _ in range(cfg.n_superblocks)])


def encode(params, frames: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder output (B, F, d)."""
    from repro_torch.models.transformer import superblock
    B, F, _ = frames.shape
    x = frames.to(cfg.cdtype) + _sinusoid(
        torch.arange(F, device=frames.device), cfg.d_model).to(cfg.cdtype)
    for li in range(cfg.encoder.n_layers):
        blk = superblock(params["encoder"]["blocks"], li)
        h = layers.rms_norm(x, blk["ln1"], cfg.norm_eps)
        q = (h @ blk["attn"]["wq"]).reshape(B, F, cfg.n_heads, cfg.hd)
        kv = (h @ blk["attn"]["wkv"]).reshape(B, F, cfg.n_kv_heads,
                                              2 * cfg.hd)
        k, v = vx.transpose(vx.Segment(n=kv.shape[-1], fields=2), kv,
                            policy=cfg.vx_policy)
        out = attention.flash_attention(q, k, v, causal=False, window=None,
                                        q_chunk=min(512, F),
                                        kv_chunk=min(512, F), ctx=ctx)
        x = x + out.reshape(B, F, -1) @ blk["attn"]["wo"]
        h2 = layers.rms_norm(x, blk["ln2"], cfg.norm_eps)
        x = x + layers.mlp_ffn(blk["mlp"], h2)
    return layers.rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _decoder_self_and_cross(sb_p, cross_p, x, cfg, ctx, positions, enc_kv,
                            mode: str):
    """One decoder superblock position (self-attn + cross + mlp)."""
    from repro_torch.models.transformer import _ffn_apply
    p = sb_p["pos0"]
    B, S = x.shape[:2]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v, kv = attention.qkv_project(p["attn"], h, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, positions,
                                        cfg.rope_theta,
                                        policy=cfg.vx_policy)
    out = attention.flash_attention(q, k, v, causal=True, window=None,
                                    q_chunk=min(512, S),
                                    kv_chunk=min(512, S), ctx=ctx)
    x = x + out.reshape(B, S, -1) @ p["attn"]["wo"]
    # cross attention over encoder K/V
    ck, cv = enc_kv
    hx = layers.rms_norm(x, cross_p["ln"], cfg.norm_eps)
    x = x + attention.cross_attention(cross_p["xattn"], hx, ck, cv,
                                      cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      ctx=ctx)
    x, _ = _ffn_apply(p, x, cfg, ctx, 0)
    return x, (kv if mode == "prefill" else None)


def _decoder_layer(sb_p, cross_p, x, enc_out, positions, *, cfg, ctx,
                   mode: str):
    ck, cv = attention.encoder_kv(cross_p["xattn"], enc_out, cfg.n_kv_heads,
                                  cfg.hd, policy=cfg.vx_policy)
    return _decoder_self_and_cross(sb_p, cross_p, x, cfg, ctx, positions,
                                   (ck, cv), mode)


def forward(params, batch, cfg, ctx=None, *, mode: str = "train"):
    """batch: tokens (B, S) + audio_frames (B, F, d).  Returns (logits,
    aux, cache_states); ``params`` already in the compute dtype
    (``transformer.forward`` casts before it dispatches here).  Prefill
    returns the last position's logits and ``{"pos0": (NS, B, S, K, 2D),
    "enc_out": (B, F, d)}``; ``hidden`` the final-normed hidden states."""
    from repro_torch.models.transformer import superblock
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(params, batch["audio_frames"], cfg, ctx)
    x = layers.embed(tokens, params["embed"]).to(cfg.cdtype)
    x = x + _sinusoid(torch.arange(S, device=x.device),
                      cfg.d_model).to(cfg.cdtype)
    positions = torch.arange(S, device=x.device).expand(B, S)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    kv_list = []
    for li in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], li)
        cross_p = superblock(params["cross"], li)
        if remat:
            x, kv = checkpoint(_decoder_layer, sb_p, cross_p, x, enc_out,
                               positions, cfg=cfg, ctx=ctx, mode=mode,
                               use_reentrant=False)
        else:
            x, kv = _decoder_layer(sb_p, cross_p, x, enc_out, positions,
                                   cfg=cfg, ctx=ctx, mode=mode)
        kv_list.append(kv)
    if mode == "prefill":
        x = x[:, -1:]  # serving prefill only needs next-token logits
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache_states = ({"pos0": torch.stack(kv_list), "enc_out": enc_out}
                    if mode == "prefill" else {})
    if mode == "hidden":
        return x, aux, cache_states
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))
    return logits, aux, cache_states


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32, *,
               device=None) -> dict:
    """Empty decode cache: ``len``, the self-attention ring ``blocks/pos0``
    (NS, B, max_len, K, 2D) and the interleaved encoder K/V ``enc_kv``
    (NS, B, F, K, 2D), zeros until :func:`precompute_enc_kv` fills it."""
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    ns, K, D = cfg.n_superblocks, cfg.n_kv_heads, cfg.hd
    return {
        "len": torch.zeros((), dtype=I32, device=device),
        "blocks": {"pos0": torch.zeros((ns, batch, max_len, K, 2 * D),
                                       dtype=dtype, device=device)},
        "enc_kv": torch.zeros((ns, batch, cfg.encoder.context, K, 2 * D),
                              dtype=dtype, device=device),
    }


def precompute_enc_kv(params, frames: torch.Tensor, cfg,
                      ctx=None) -> torch.Tensor:
    """(NS, B, F, K, 2D) interleaved encoder K/V for decode: ``encode``
    once, then each decoder layer's ``wkv`` projection (no split).
    Computes in ``cfg.compute_dtype`` (the params are cast as the step
    casts them; the reference promotes bf16 activations against float32
    weights where it is handed uncast ones)."""
    from repro_torch.models.transformer import cast_params
    params = cast_params(params, cfg)
    enc_out = encode(params, frames, cfg, ctx)
    B, F = enc_out.shape[:2]
    wkv = params["cross"]["xattn"]["wkv"]
    return torch.stack([(enc_out @ wkv[li]).reshape(
        B, F, cfg.n_kv_heads, 2 * cfg.hd) for li in range(wkv.shape[0])])


def _seq_sharded(leaf, shard):
    """``leaf`` (an ``(NS, B, S, K, 2D)`` cache leaf) placed on its
    sequence axis over ``shard``'s axes when ``shard`` divides it (a
    ``DTensor`` placed so is kept), else None (it stays replicated)."""
    from repro_torch.dist import sharding
    if shard is None or not shard.divides(leaf.shape[-3]):
        return None
    return sharding.place(leaf, sharding.Sharding(
        shard.mesh, sharding.P(None, None, shard.axes)))


def _attend(q, leaf, li: int, n: int, shard, heads):
    """Decode attention of ``q`` (B, H or this rank's heads, D) over layer
    ``li`` of ``leaf`` (the ring or ``enc_kv``), its first ``n`` positions:
    split with ``policy="ref"`` (a sequence-sharded leaf on each rank's
    block, attended by the distributed softmax over ``shard``), the
    heads' outputs gathered over ``heads``' axes.  Returns (B, H, D)."""
    from repro_torch.dist import sharding
    lay = sharding.select(leaf, li) if shard is not None else leaf[li]
    k_all, v_all = vx.transpose(vx.Segment(n=lay.shape[-1], fields=2), lay,
                                policy="ref", shard=shard)
    out = attention.decode_attention(q, k_all, v_all, n, shard=shard)
    if heads is not None:
        out = sharding.all_gather(out, heads.mesh, heads.axes, 1)
    return out


def decode_step(params, cache: dict, token: torch.Tensor, cfg, ctx=None, *,
                kv_shard=None, head_shard=None):
    """token: (B,) int.  Returns (logits (B, V), updated cache).  The
    token's beat is written into the self-attention ring at ``len % Sc``
    in place; the ring and ``enc_kv`` are split with ``policy="ref"`` (as
    in the reference), so only ``qkv_project``'s split and re-pack reach
    ``cfg.vx_policy``.

    On a mesh (one SPMD program, as :func:`models.decode.decode_step`
    runs it): weights placed as ``DTensor`` s are gathered a layer at a
    time.  ``kv_shard`` (a ``vx.Shard`` on the caches' sequence axis,
    -3) places the ring and ``enc_kv`` each on its sequence when the
    shard divides it (else it stays replicated): the token's beat is
    written by the rank whose block holds its slot, and self- and
    cross-attention are the distributed softmax.  ``head_shard`` (a
    ``vx.Shard`` on the KV-head axis, -2) marks both leaves as this
    rank's block of the heads: the rank keeps its block of the beat and
    of the query heads, attends locally and gathers the heads' outputs
    before ``wo``."""
    from repro_torch.dist import sharding
    from repro_torch.models.decode import _head_block, _owner_write
    from repro_torch.models.transformer import (_ffn_apply, cast_params,
                                                superblock)
    params = cast_params(params, cfg)
    top = {k: sharding.full_tensor(params[k])
           for k in ("embed", "final_norm", "lm_head") if k in params}
    B = token.shape[0]
    pos = cache["len"]
    x = layers.embed(token, top["embed"]).to(cfg.cdtype)
    x = x + _sinusoid(pos[None], cfg.d_model).to(cfg.cdtype)[0]
    positions = pos.expand(B, 1)
    if kv_shard is not None and kv_shard.axis != -3:
        raise ValueError(f"kv_shard shards the cache's sequence axis: "
                         f"Shard.axis must be -3, got {kv_shard.axis}")
    ring, enc_kv = cache["blocks"]["pos0"], cache["enc_kv"]
    placed = _seq_sharded(ring, kv_shard)
    ring_shard = None if placed is None else kv_shard
    ring = ring if placed is None else placed
    placed = _seq_sharded(enc_kv, kv_shard)
    enc_shard = None if placed is None else kv_shard
    enc_kv = enc_kv if placed is None else placed
    sc = ring.shape[2]
    H, K = cfg.n_heads, cfg.n_kv_heads
    for li in range(cfg.n_superblocks):
        p = superblock(params["blocks"], li, ctx)["pos0"]
        cross_p = superblock(params["cross"], li, ctx)
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, _, _, kv = attention.qkv_project(p["attn"], h[:, None], H, K,
                                            cfg.hd, positions,
                                            cfg.rope_theta,
                                            policy=cfg.vx_policy)
        q = _head_block(q, head_shard, H)
        kv = _head_block(kv, head_shard, K)
        if ring_shard is not None:
            kvc, base, _ = sharding.owned_block(sharding.select(ring, li), 1)
            _owner_write(kvc, torch.remainder(pos, sc) - base, kv)
        else:
            slot = torch.remainder(pos, sc).reshape(1).long()
            ring[li].index_copy_(1, slot, kv.to(ring.dtype))
        out = _attend(q[:, 0], ring, li, torch.clamp(pos + 1, max=sc),
                      ring_shard, head_shard)
        x = x + (out.reshape(B, -1) @ p["attn"]["wo"]).to(x.dtype)
        # cross attention against the cached encoder K/V
        hx = layers.rms_norm(x, cross_p["ln"], cfg.norm_eps)
        qx = _head_block((hx @ cross_p["xattn"]["wq"]).reshape(
            B, 1, H, cfg.hd), head_shard, H)[:, 0]
        xo = _attend(qx, enc_kv, li, enc_kv.shape[2], enc_shard, head_shard)
        x = x + (xo.reshape(B, -1) @ cross_p["xattn"]["wo"]).to(x.dtype)
        x2, _ = _ffn_apply(p, x[:, None], cfg, ctx, 0)
        x = x2[:, 0]
    x = layers.rms_norm(x, top["final_norm"], cfg.norm_eps)
    head = top["embed"] if cfg.tie_embeddings else top["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))
    return logits, {"len": pos + 1, "blocks": {"pos0": ring},
                    "enc_kv": enc_kv}
