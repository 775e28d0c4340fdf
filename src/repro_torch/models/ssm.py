"""Mamba (selective SSM) block — the state-space half of Jamba.

Port of ``repro``'s ``models/ssm.py``: :class:`MambaSpec`, a seeded
:func:`init_mamba` with the reference's layout and scales, the depthwise
causal conv, the input projections, :func:`selective_scan`,
:func:`mamba_forward` (train / prefill), :class:`MambaCache` and
:func:`mamba_decode_step`.

The reference scans time in ``jax.checkpoint``'d chunks, a memory device
of its backward.  The port has no backward: :func:`selective_scan` keeps
the ``chunk`` argument for parity and runs one Python loop over time with
the reference's per-step arithmetic (``dt`` and the state in float32).  The
recurrence is torch ops; no kernel is involved, as in the reference.

Decode carries ``(conv window, h)`` in the cache: O(1) per token.

Tensor parallelism (``tp``, a ``dist.sharding.RankLocal`` with ``tp``):
the reference shards ``ed`` over the model axis, and so does the port.
:func:`mamba_forward` and :func:`mamba_decode_step` then take this rank's
blocks of the six matrices on ``ed`` (``in_proj`` ``(d, 2 ed/m)`` in its
matmul shape, ``conv_w``, ``x_proj``'s rows, ``dt_proj``'s columns,
``A_log``'s rows, ``out_proj``'s rows) and cut the replicated vectors
``conv_b``, ``dt_bias`` and ``D`` to the block.  The conv and the scan
run on the rank's ``ed/m`` channels; ``x_proj``'s partial product is
summed over the model axis once, in float32 and rounded once, so that
``dt_in``, ``B`` and ``C`` come whole; the output is ``out_proj``'s
partial sum, which the caller sums (``sharding.tp_leave``).  A single
position's partial products (the decode step's) are computed by
``sharding.wide_matmul``: float32 for bf16 (on the card one GEMM with a
float32 output, the weight block read as it is), float64 for float32,
whose parts would otherwise each carry a float32 accumulation's
rounding.  The state
is the rank's block: ``conv`` ``(B, W-1, ed/m)``, ``h`` ``(B, ed/m,
N)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.models import layers


class MambaSpec(NamedTuple):
    d_model: int
    expand: int = 2
    state_dim: int = 16
    conv_width: int = 4
    dt_rank: int = 0  # 0 -> d_model // 16

    @property
    def ed(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: no linear branch
    above a threshold (``F.softplus`` switches to ``x`` above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def time_scan(step, state, xs: tuple):
    """``lax.scan`` over axis 1 of every input, one Python step a token:
    (final state, outputs stacked on axis 1)."""
    ys = []
    for t in range(xs[0].shape[1]):
        state, y = step(state, tuple(a[:, t] for a in xs))
        ys.append(y)
    return state, torch.stack(ys, dim=1)


def init_mamba(spec: MambaSpec, g: torch.Generator, dtype, device) -> dict:
    """The reference's leaves, shapes and scales.  ``A_log`` is
    ``log(1..N)`` correctly rounded to float32 (computed in float64), ``D``
    ones, ``dt_bias`` the inverse softplus of ``U(1e-3, 1e-1)``."""
    d, ed, N, r = spec.d_model, spec.ed, spec.state_dim, spec.rank
    u = torch.rand((ed,), generator=g, dtype=torch.float32,
                   device=g.device) * (1e-1 - 1e-3) + 1e-3
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float64))
    return {
        "in_proj": layers.normal((d, 2 * ed), d ** -0.5, g, dtype, device),
        "conv_w": layers.normal((spec.conv_width, ed), 0.1, g, dtype,
                                device),
        "conv_b": torch.zeros((ed,), dtype=dtype, device=device),
        "x_proj": layers.normal((ed, r + 2 * N), ed ** -0.5, g, dtype,
                                device),
        "dt_proj": layers.normal((r, ed), r ** -0.5, g, dtype, device),
        "dt_bias": torch.log(torch.expm1(u)).to(dtype=dtype, device=device),
        "A_log": a_log.to(torch.float32).expand(ed, N).to(
            dtype=dtype, device=device),
        "D": torch.ones((ed,), dtype=dtype, device=device),
        "out_proj": layers.normal((ed, d), ed ** -0.5, g, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via static shifts.  x: (B,S,ed); w: (W,ed)."""
    W, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(W):  # tap i sees x shifted back by (W-1-i)
        lag = W - 1 - i
        shifted = F.pad(x, (0, 0, lag, 0))[:, :S]
        out = out + shifted * w[i]
    return out + b


def _vectors(params, tp) -> tuple:
    """``conv_b``, ``dt_bias`` and ``D``: under ``tp`` this rank's block
    of each."""
    vs = tuple(params[k] for k in ("conv_b", "dt_bias", "D"))
    if tp is None:
        return vs
    return tuple(sharding.tp_block(v, tp) for v in vs)


def _ssm_inputs(params, x: torch.Tensor, spec: MambaSpec, dt_bias,
                tp=None):
    """Common projections.  x: (B,S,ed) post-conv.  Returns dt (B,S,ed)
    float32, B and C (B,S,N) in x's dtype.  Under ``tp`` x holds this
    rank's channels: ``x_proj``'s partial product is summed over the
    model axis in float32 (a single position's by
    ``sharding.wide_matmul``) and rounded once to x's dtype."""
    N, r = spec.state_dim, spec.rank
    if tp is None:
        proj = x @ params["x_proj"]
    else:
        part = sharding.wide_matmul(x, params["x_proj"]) \
            if x.shape[1] == 1 else x.float() @ params["x_proj"].float()
        proj = sharding.all_sum(part, tp.tp.mesh, tp.tp_axis).to(x.dtype)
    dt_in, Bmat, Cmat = torch.split(proj, [r, N, N], dim=-1)
    dt = softplus(dt_in @ params["dt_proj"] + dt_bias.float())
    return dt, Bmat, Cmat


def selective_scan(dt, Bm, Cm, x, A, D, h0, *, chunk: int = 128):
    """h_t = exp(dt*A) h_{t-1} + dt*B_t x_t ; y_t = C_t.h_t + D x_t.

    dt, x: (B,S,ed); Bm, Cm: (B,S,N); A: (ed,N); h0: (B,ed,N) float32.
    Returns (y (B,S,ed), h_final).  ``chunk`` is the reference's remat
    unit; without a backward the port runs one loop over time."""
    def step(h, inp):
        dt_t, dtx_t, B_t, C_t = inp          # (B,ed),(B,ed),(B,N),(B,N)
        da = torch.exp(dt_t[..., None] * A)  # (B,ed,N)
        h = da * h + dtx_t[..., None] * B_t[:, None, :]
        return h, torch.einsum("ben,bn->be", h, C_t)

    h, y = time_scan(step, h0.float(), (dt, dt * x, Bm, Cm))
    return (y + x * D).to(x.dtype), h


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, ed) last inputs
    h: torch.Tensor      # (B, ed, N) float32 SSM state


def mamba_forward(params, x: torch.Tensor, spec: MambaSpec, *,
                  chunk: int = 128, tp=None) -> tuple[torch.Tensor,
                                                      MambaCache]:
    """Full block forward (train / prefill).  x: (B,S,d) -> ((B,S,d),
    cache): the final conv window and SSM state.  Under ``tp`` (the
    params this rank's blocks on ``ed``) the output is this rank's
    partial sum and the cache its block of the channels."""
    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_b, dt_bias, D = _vectors(params, tp)
    xc = F.silu(_causal_conv(xin, params["conv_w"], conv_b))
    dt, Bm, Cm = _ssm_inputs(params, xc, spec, dt_bias, tp)
    A = -torch.exp(params["A_log"].float())
    h0 = torch.zeros((x.shape[0], xin.shape[-1], spec.state_dim),
                     dtype=torch.float32, device=x.device)
    y, hf = selective_scan(dt.float(), Bm.float(), Cm.float(), xc.float(),
                           A, D.float(), h0, chunk=chunk)
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    W, S = spec.conv_width, x.shape[1]
    conv = (xin[:, S - (W - 1):] if S >= W - 1
            else F.pad(xin, (0, 0, W - 1 - S, 0)))
    return out, MambaCache(conv=conv, h=hf)


def init_mamba_cache(batch: int, spec: MambaSpec, dtype,
                     device=None) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, spec.conv_width - 1, spec.ed), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, spec.ed, spec.state_dim), dtype=torch.float32,
                      device=device))


def mamba_decode_step(params, x_t: torch.Tensor, cache: MambaCache,
                      spec: MambaSpec, tp=None) -> tuple[torch.Tensor,
                                                         MambaCache]:
    """One-token step.  x_t: (B, d).  O(1) state update.  Under ``tp``
    the cache is this rank's block of the channels and the output its
    partial sum, wider than x's dtype (``sharding.wide_matmul``)."""
    xz = x_t @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)                        # (B, ed)
    conv_b, dt_bias, D = _vectors(params, tp)
    # jnp.concatenate / einsum promote a narrower cache window
    window = torch.cat([cache.conv, xin[:, None]], dim=1)      # (B,W,ed)
    wt = torch.promote_types(window.dtype, params["conv_w"].dtype)
    xc = torch.einsum("bwe,we->be", window.to(wt),
                      params["conv_w"].to(wt)) + conv_b
    xc = F.silu(xc)
    dt, Bm, Cm = _ssm_inputs(params, xc[:, None], spec, dt_bias, tp)
    dt, Bm, Cm = dt[:, 0], Bm[:, 0], Cm[:, 0]
    A = -torch.exp(params["A_log"].float())
    da = torch.exp(dt.float()[..., None] * A)
    h = da * cache.h + (dt * xc).float()[..., None] \
        * Bm.float()[:, None, :]
    y = torch.einsum("ben,bn->be", h, Cm.float())
    y = (y + xc.float() * D).to(x_t.dtype)
    if tp is not None:
        out = sharding.wide_matmul(y * F.silu(z), params["out_proj"])
    else:
        out = (y * F.silu(z)) @ params["out_proj"]
    return out, MambaCache(conv=window[:, 1:], h=h)
