"""Shared neural-net layers as torch ops: norms, RoPE, embeddings, MLP/GLU
with the EARTH interleaved fused projection option.

Port of ``repro``'s ``models/layers.py``: ``rms_norm`` (computed in
float32), ``rope``, ``embed``, ``unembed`` and ``glu_ffn`` (fused and
unfused).  ``mlp_ffn``, ``layer_norm`` and the ``init_*``
helpers wait for the model families that need them (the port's init
lives in models/transformer.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import vx


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


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


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits = x @ table^T (tied or untied head)."""
    return x @ table.transpose(0, 1)


def glu_ffn(params, x: torch.Tensor, *, fused: bool = False,
            policy=None) -> torch.Tensor:
    """SwiGLU. params: {'wi': (d, 2f) or {'wg','wu'}: (d, f), 'wo': (f, d)}.

    The fused path emits gate/up interleaved along the feature dim from a
    single matmul and splits them with the FIELD=2 segment load."""
    if fused:
        gu = x @ params["wi"]               # (..., 2f) interleaved AoS
        gate, up = vx.transpose(vx.Segment(n=gu.shape[-1], fields=2), gu,
                                policy=policy)
    else:
        gate = x @ params["wg"]
        up = x @ params["wu"]
    return (F.silu(gate) * up) @ params["wo"]


def normal(shape, scale: float, generator: torch.Generator, dtype,
           device) -> torch.Tensor:
    """Seeded N(0, 1) * scale, drawn on the generator's device."""
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (t * scale).to(dtype=dtype, device=device)

