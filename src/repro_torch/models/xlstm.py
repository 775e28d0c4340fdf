"""xLSTM blocks (mLSTM matrix-memory + sLSTM scalar-memory), arXiv:2405.04517.

Port of ``repro``'s ``models/xlstm.py``: :class:`XLSTMSpec`, seeded
:func:`init_mlstm` / :func:`init_slstm` with the reference's layouts and
scales, the states :class:`MLSTMState` ``(C, n, m)`` and
:class:`SLSTMState` ``(c, n, m, h)`` (float32, the stabiliser ``m``
starting at ``-1e30``), the steps ``_mlstm_step`` / ``_slstm_step`` (the
sLSTM's block-diagonal recurrent ``r``), the forwards (the sLSTM's with its
tanh-GELU gated FFN) and the decode steps.

Both use exponential gating with the max-stabiliser.  The reference scans
time in ``jax.checkpoint``'d chunks, a memory device of its backward; the
port keeps the ``chunk`` argument for parity and runs one Python loop over
time with the reference's per-step arithmetic.  Torch ops throughout; no
kernel is involved, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.ssm import softplus, time_scan

F32 = torch.float32


class XLSTMSpec(NamedTuple):
    d_model: int
    n_heads: int
    m_proj_factor: float = 2.0   # mLSTM up-projection
    s_ffn_factor: float = 4.0 / 3.0

    @property
    def m_inner(self) -> int:
        return int(self.d_model * self.m_proj_factor)

    @property
    def m_head(self) -> int:
        return self.m_inner // self.n_heads

    @property
    def s_head(self) -> int:
        return self.d_model // self.n_heads


def _logsig(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(spec: XLSTMSpec, g: torch.Generator, dtype, device) -> dict:
    d, ed, H = spec.d_model, spec.m_inner, spec.n_heads
    s, si = d ** -0.5, ed ** -0.5
    return {
        "up": layers.normal((d, 2 * ed), s, g, dtype, device),
        "wq": layers.normal((ed, ed), si, g, dtype, device),
        "wk": layers.normal((ed, ed), si, g, dtype, device),
        "wv": layers.normal((ed, ed), si, g, dtype, device),
        "wi": layers.normal((ed, H), si, g, dtype, device),
        "wf": layers.normal((ed, H), si, g, dtype, device),
        # forget bias -> long memory at init
        "fb": torch.full((H,), 3.0, dtype=dtype, device=device),
        "down": layers.normal((ed, d), si, g, dtype, device),
        "ogate": layers.normal((d, ed), s, g, dtype, device),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, dh, dh) float32
    n: torch.Tensor   # (B, H, dh) float32
    m: torch.Tensor   # (B, H) float32


def init_mlstm_state(batch: int, spec: XLSTMSpec,
                     device=None) -> MLSTMState:
    H, dh = spec.n_heads, spec.m_head
    return MLSTMState(
        C=torch.zeros((batch, H, dh, dh), dtype=F32, device=device),
        n=torch.zeros((batch, H, dh), dtype=F32, device=device),
        m=torch.full((batch, H), -1e30, dtype=F32, device=device))


def _mlstm_step(state: MLSTMState, qkvif):
    q, k, v, i, f = qkvif  # (B,H,dh) x3, (B,H) x2, all float32
    dh = q.shape[-1]
    ft = _logsig(f)
    m_new = torch.maximum(ft + state.m, i)
    fg = torch.exp(ft + state.m - m_new)
    ig = torch.exp(i - m_new)
    C = fg[..., None, None] * state.C + ig[..., None, None] \
        * (v[..., :, None] * k[..., None, :])
    n = fg[..., None] * state.n + ig[..., None] * k
    qs = q * dh ** -0.5
    num = torch.einsum("bhij,bhj->bhi", C, qs)
    den = torch.maximum(torch.einsum("bhj,bhj->bh", n, qs).abs(),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return MLSTMState(C, n, m_new), h


def _mlstm_inputs(params, x: torch.Tensor, spec: XLSTMSpec):
    """(q, k, v, i, f) float32 and the gates ``og``, ``z`` for x (..., d)."""
    H, dh = spec.n_heads, spec.m_head
    lead = x.shape[:-1]
    xu, z = torch.chunk(x @ params["up"], 2, dim=-1)
    og = torch.sigmoid(x @ params["ogate"])
    q, k, v = ((xu @ params[w]).reshape(*lead, H, dh).float()
               for w in ("wq", "wk", "wv"))
    i = (xu @ params["wi"]).float()
    f = (xu @ params["wf"] + params["fb"]).float()
    return (q, k, v, i, f), og, z


def mlstm_forward(params, x: torch.Tensor, spec: XLSTMSpec, *,
                  chunk: int = 64) -> tuple[torch.Tensor, MLSTMState]:
    """x: (B, S, d) -> ((B, S, d), final state)."""
    B, S, _ = x.shape
    qkvif, og, z = _mlstm_inputs(params, x, spec)
    state, hs = time_scan(_mlstm_step,
                          init_mlstm_state(B, spec, x.device), qkvif)
    h = hs.reshape(B, S, spec.n_heads * spec.m_head)
    out = (h.to(x.dtype) * og * F.silu(z)) @ params["down"]
    return out, state


def mlstm_decode_step(params, x_t: torch.Tensor, state: MLSTMState,
                      spec: XLSTMSpec) -> tuple[torch.Tensor, MLSTMState]:
    """x_t: (B, d)."""
    B = x_t.shape[0]
    qkvif, og, z = _mlstm_inputs(params, x_t, spec)
    state, h = _mlstm_step(state, qkvif)
    out = (h.reshape(B, spec.n_heads * spec.m_head).to(x_t.dtype) * og
           * F.silu(z)) @ params["down"]
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(spec: XLSTMSpec, g: torch.Generator, dtype, device) -> dict:
    d, H, dh = spec.d_model, spec.n_heads, spec.s_head
    f = int(spec.d_model * spec.s_ffn_factor)
    return {
        "wx": layers.normal((d, 4 * d), d ** -0.5, g, dtype, device),
        # recurrent R: block-diagonal per head, stored (H, dh, 4*dh)
        "r": layers.normal((H, dh, 4 * dh), dh ** -0.5, g, dtype, device),
        "fb": torch.full((d,), 3.0, dtype=dtype, device=device),
        "ffn_wi": layers.normal((d, 2 * f), d ** -0.5, g, dtype, device),
        "ffn_wo": layers.normal((f, d), f ** -0.5, g, dtype, device),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) float32
    n: torch.Tensor   # (B, d) float32
    m: torch.Tensor   # (B, d) float32
    h: torch.Tensor   # (B, d) float32


def init_slstm_state(batch: int, spec: XLSTMSpec,
                     device=None) -> SLSTMState:
    d = spec.d_model

    def z():
        return torch.zeros((batch, d), dtype=F32, device=device)
    return SLSTMState(c=z(), n=z(),
                      m=torch.full((batch, d), -1e30, dtype=F32,
                                   device=device), h=z())


def _slstm_step(params, spec: XLSTMSpec, state: SLSTMState, wx_t):
    """wx_t: (B, 4d) precomputed input projection for step t."""
    B = wx_t.shape[0]
    H, dh = spec.n_heads, spec.s_head
    hr = state.h.reshape(B, H, dh)
    rec = torch.einsum("bhi,hij->bhj", hr,
                       params["r"].float()).reshape(B, 4 * H * dh)
    pre = wx_t + rec
    zi, ii, fi, oi = torch.chunk(pre, 4, dim=-1)
    fb = params["fb"].float()
    ft = _logsig(fi + fb)
    m_new = torch.maximum(ft + state.m, ii)
    fg = torch.exp(ft + state.m - m_new)
    ig = torch.exp(ii - m_new)
    c = fg * state.c + ig * torch.tanh(zi)
    n = fg * state.n + ig
    h = torch.sigmoid(oi) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, m_new, h), h


def _slstm_ffn(params, h: torch.Tensor) -> torch.Tensor:
    """The gated FFN after the sLSTM (pf 4/3): tanh-GELU gate."""
    g, u = torch.chunk(h @ params["ffn_wi"], 2, dim=-1)
    return F.gelu(g, approximate="tanh") * u @ params["ffn_wo"]


def slstm_forward(params, x: torch.Tensor, spec: XLSTMSpec, *,
                  chunk: int = 64) -> tuple[torch.Tensor, SLSTMState]:
    B = x.shape[0]
    wx = (x @ params["wx"]).float()  # (B,S,4d)
    state, hs = time_scan(lambda s, i: _slstm_step(params, spec, s, i[0]),
                          init_slstm_state(B, spec, x.device), (wx,))
    return _slstm_ffn(params, hs.to(x.dtype)), state


def slstm_decode_step(params, x_t: torch.Tensor, state: SLSTMState,
                      spec: XLSTMSpec) -> tuple[torch.Tensor, SLSTMState]:
    wx = (x_t @ params["wx"]).float()
    state, h = _slstm_step(params, spec, state, wx)
    return _slstm_ffn(params, h.to(x_t.dtype)), state
