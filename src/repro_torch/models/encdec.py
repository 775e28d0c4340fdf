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


def decode_step(params, cache: dict, token: torch.Tensor, cfg, ctx=None):
    """token: (B,) int.  Returns (logits (B, V), updated cache).  The
    token's beat is written into the self-attention ring at ``len % Sc``
    in place; the ring and ``enc_kv`` are split with ``policy="ref"`` (as
    in the reference), so only ``qkv_project``'s split and re-pack reach
    ``cfg.vx_policy``."""
    from repro_torch.models.transformer import (_ffn_apply, cast_params,
                                                superblock)
    params = cast_params(params, cfg)
    B = token.shape[0]
    pos = cache["len"]
    x = layers.embed(token, params["embed"]).to(cfg.cdtype)
    x = x + _sinusoid(pos[None], cfg.d_model).to(cfg.cdtype)[0]
    positions = pos.expand(B, 1)
    ring = cache["blocks"]["pos0"]
    for li in range(cfg.n_superblocks):
        p = superblock(params["blocks"], li)["pos0"]
        cross_p = superblock(params["cross"], li)
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, _, _, kv = attention.qkv_project(p["attn"], h[:, None],
                                            cfg.n_heads, cfg.n_kv_heads,
                                            cfg.hd, positions,
                                            cfg.rope_theta,
                                            policy=cfg.vx_policy)
        kvc = ring[li]                                   # (B, Sc, K, 2D)
        sc = kvc.shape[1]
        slot = torch.remainder(pos, sc).reshape(1).long()
        kvc.index_copy_(1, slot, kv.to(kvc.dtype))
        k_all, v_all = vx.transpose(vx.Segment(n=kvc.shape[-1], fields=2),
                                    kvc, policy="ref")
        out = attention.decode_attention(q[:, 0], k_all, v_all,
                                         torch.clamp(pos + 1, max=sc))
        x = x + (out.reshape(B, -1) @ p["attn"]["wo"]).to(x.dtype)
        # cross attention against the cached encoder K/V
        enc_kv = cache["enc_kv"][li]
        ek, ev = vx.transpose(vx.Segment(n=enc_kv.shape[-1], fields=2),
                              enc_kv, policy="ref")
        hx = layers.rms_norm(x, cross_p["ln"], cfg.norm_eps)
        qx = (hx @ cross_p["xattn"]["wq"]).reshape(B, cfg.n_heads, cfg.hd)
        xo = attention.decode_attention(qx, ek, ev, ek.shape[1])
        x = x + (xo.reshape(B, -1) @ cross_p["xattn"]["wo"]).to(x.dtype)
        x2, _ = _ffn_apply(p, x[:, None], cfg, ctx, 0)
        x = x2[:, 0]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))
    return logits, {"len": pos + 1, "blocks": {"pos0": ring},
                    "enc_kv": cache["enc_kv"]}
