"""Shared neural-net layers as torch ops: norms, RoPE, embeddings, MLP/GLU
with the EARTH interleaved fused projection option.

Port of ``repro``'s ``models/layers.py``: ``rms_norm`` and
``layer_norm`` (both computed in float32, or float64 for float64
operands: :func:`wide`), ``rope``, ``embed``,
``unembed``, ``glu_ffn`` (fused and unfused), the GELU ``mlp_ffn`` and the
seeded ``init_glu`` / ``init_mlp`` (the reference's shapes and scales,
drawn from a ``torch.Generator``).

Tensor parallelism (``models/transformer.py``) hands these layers a
rank's blocks as they are: ``glu_ffn`` / ``mlp_ffn`` on a block of ``wi``
(or ``wg`` / ``wu``) columns and the matching ``wo`` rows compute their
part of the output (the fused ``wi`` interleaves gate and up column by
column, so a block of an even count of columns holds whole pairs and its
FIELD=2 split runs on the block), ``unembed`` on a block of vocab rows
that block of the logits; :func:`embed_block` looks up a block of the
vocab.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import vx


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the reference computes a narrower one in:
    float32 for bf16 / fp16 / float32, float64 left as it is (a float64
    run then carries no float32 rounding)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = wide(x)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(x.dtype)).to(dtype)


def rms_norm_block(x: torch.Tensor, scale: torch.Tensor, index: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """Block ``index`` of :func:`rms_norm`'s output features, ``scale``
    that block's gains (``x`` whole): the same elementwise arithmetic on
    the block's features."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    n = scale.shape[0]
    xb = x[..., index * n:(index + 1) * n]
    return ((xb * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    # a 0-dim CPU scalar: no host-to-device copy (and no sync) per call
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) * (log_theta / half))
    ang = positions.float()[..., None] * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def embed_block(tokens: torch.Tensor, table: torch.Tensor,
                base: int) -> torch.Tensor:
    """The lookup on a block of the vocab: ``table`` holds rows ``[base,
    base + n)``; a token outside them looks up zeros (a partial of the
    whole lookup, which a sum over the blocks completes exactly)."""
    idx = tokens.long() - base
    hit = (idx >= 0) & (idx < table.shape[0])
    return torch.where(hit[..., None], table[idx.clamp(0, table.shape[0] - 1)],
                       0)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits = x @ table^T (tied or untied head); on a block of the
    vocab's rows, that block of the logits."""
    return x @ table.transpose(0, 1)


def _out(h: torch.Tensor, wo: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype is None:
        return h @ wo
    return h.to(out_dtype) @ wo.to(out_dtype)


def glu_ffn(params, x: torch.Tensor, *, fused: bool = False,
            policy=None, out_dtype=None) -> torch.Tensor:
    """SwiGLU. params: {'wi': (d, 2f) or {'wg','wu'}: (d, f), 'wo': (f, d)}.

    The fused path emits gate/up interleaved along the feature dim from a
    single matmul and splits them with the FIELD=2 segment load.
    ``out_dtype`` computes the ``wo`` product in that dtype (a partial
    sum's part, left unrounded)."""
    if fused:
        gu = x @ params["wi"]               # (..., 2f) interleaved AoS
        gate, up = vx.transpose(vx.Segment(n=gu.shape[-1], fields=2), gu,
                                policy=policy)
    else:
        gate = x @ params["wg"]
        up = x @ params["wu"]
    return _out(F.silu(gate) * up, params["wo"], out_dtype)


def mlp_ffn(params, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """2-matmul GELU MLP (GPT-BigCode / whisper style); the tanh form, as
    the reference's ``jax.nn.gelu(approximate=True)``."""
    return _out(F.gelu(x @ params["wi"], approximate="tanh"), params["wo"],
                out_dtype)


def init_glu(d: int, f: int, g: torch.Generator, *, fused: bool, dtype,
             device) -> dict:
    wg = normal((d, f), d ** -0.5, g, dtype, device)
    wu = normal((d, f), d ** -0.5, g, dtype, device)
    wo = normal((f, d), f ** -0.5, g, dtype, device)
    if fused:
        # interleave columns -> [g0,u0,g1,u1,...]
        return {"wi": torch.stack([wg, wu], dim=-1).reshape(d, 2 * f),
                "wo": wo}
    return {"wg": wg, "wu": wu, "wo": wo}


def init_mlp(d: int, f: int, g: torch.Generator, dtype, device) -> dict:
    return {"wi": normal((d, f), d ** -0.5, g, dtype, device),
            "wo": normal((f, d), f ** -0.5, g, dtype, device)}


def normal(shape, scale: float, generator: torch.Generator, dtype,
           device) -> torch.Tensor:
    """Seeded N(0, 1) * scale, drawn on the generator's device."""
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (t * scale).to(dtype=dtype, device=device)

