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
kernel is involved, as in the reference.  The recurrences run in float32,
as the reference's do, or in float64 when the compute dtype is float64
(``layers.wide``).

Tensor parallelism (``tp``: the ``RankLocal`` of the mesh forward or of
a sharded decode step, the weights this rank's model-axis blocks as the
parameter rules place them; ``models/transformer.tp_specs``).  Each rank
runs the recurrence on its block of the heads (the sLSTM: of the
channels) and keeps that block of the state, which is where
``serve/engine.cache_specs`` places it:

* mLSTM: ``up``'s x and z halves and ``ogate`` on their ``m_inner``
  columns, ``wq`` / ``wk`` / ``wv`` on their columns (the rank's heads),
  ``wi`` / ``wf`` / ``down`` on their rows.  ``xu`` is gathered over
  ``m_inner`` once for the q / k / v products, the ``(.., 2H)`` partials
  of ``i`` and ``f`` are summed (in float32 at least) and each rank keeps
  its heads; ``down``'s product is the rank's partial of the output.
* sLSTM, with 4 heads (xlstm's): the recurrent product ``h @ r`` is
  laid out per head, ``(H, 4 dh)``, and split into the four gates as
  ``(4, d)``, so with 4 heads gate ``c`` of every channel reads head
  ``c``'s ``h`` through ``r[c]``.  A rank steps its block of the channels
  (of ``d``: the block ``cache_specs`` places), all four gates: it needs
  every head's ``h``, gathered each step (one ``all_gather`` of ``(B,
  d/m)``), and ``r``'s columns of its channels, which is the block the
  rules place on it (``r`` on its ``4 dh = d`` columns).  ``wx`` sits on
  its gate columns (with a model axis of ``m`` dividing 4, rank ``i``
  holds gates ``[4i/m, 4(i+1)/m)`` of every channel); its product goes
  through one ``all_to_all`` into the rank's channels, all four gates.
  The FFN runs on the blocks the rules give it (:func:`_slstm_ffn`):
  xlstm-125m's ``ffn_wi`` on its columns (``h`` gathered over ``d``, the
  product gathered so that ``g`` and ``u`` pair) and ``ffn_wo`` on its
  rows (a partial of the output); the smoke widths' odd FFN on ``ffn_wi``
  rows or columns and ``ffn_wo`` columns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.models import layers
from repro_torch.models.layers import wide
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


def init_mlstm_state(batch: int, spec: XLSTMSpec, device=None, *,
                     heads: int | None = None) -> MLSTMState:
    """The initial state of ``heads`` heads (default: all of them)."""
    H, dh = heads or spec.n_heads, spec.m_head
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


def _mlstm_inputs(params, x: torch.Tensor, spec: XLSTMSpec, tp=None):
    """(q, k, v, i, f) float32 and the gates ``og``, ``z`` for x (..., d);
    under ``tp`` this rank's heads and channels."""
    dh = spec.m_head
    lead = x.shape[:-1]
    xu, z = torch.chunk(x @ params["up"], 2, dim=-1)
    og = torch.sigmoid(x @ params["ogate"])
    xw = xu if tp is None else sharding.gather_seq(xu, tp.tp.mesh,
                                                   tp.tp_axis, -1)
    q, k, v = (wide((xw @ params[w]).reshape(*lead, -1, dh))
               for w in ("wq", "wk", "wv"))
    if tp is None:
        i, f = xu @ params["wi"], xu @ params["wf"]
    else:
        # the rows' partials of i and f in one (.., 2H) sum, rounded once
        xt = wide(xu)
        w = torch.cat([params["wi"], params["wf"]], dim=-1).to(xt.dtype)
        i, f = sharding.all_sum(xt @ w, tp.tp.mesh,
                                tp.tp_axis).to(x.dtype).chunk(2, dim=-1)
    f = f + params["fb"]
    if tp is not None:
        i, f = sharding.tp_block(i, tp, -1), sharding.tp_block(f, tp, -1)
    return (q, k, v, wide(i), wide(f)), og, z


def mlstm_forward(params, x: torch.Tensor, spec: XLSTMSpec, *,
                  chunk: int = 64, tp=None) -> tuple[torch.Tensor,
                                                     MLSTMState]:
    """x: (B, S, d) -> ((B, S, d), final state); under ``tp`` the rank's
    partial output and its heads' state."""
    B, S, _ = x.shape
    qkvif, og, z = _mlstm_inputs(params, x, spec, tp)
    state, hs = time_scan(_mlstm_step, init_mlstm_state(
        B, spec, x.device, heads=qkvif[0].shape[-2]), qkvif)
    h = hs.reshape(B, S, -1)
    out = (h.to(x.dtype) * og * F.silu(z)) @ params["down"]
    return out, state


def mlstm_decode_step(params, x_t: torch.Tensor, state: MLSTMState,
                      spec: XLSTMSpec, tp=None) -> tuple[torch.Tensor,
                                                         MLSTMState]:
    """x_t: (B, d).  Under ``tp`` the state is the rank's heads' and the
    output its partial sum, wider than x's dtype
    (``sharding.wide_matmul``)."""
    B = x_t.shape[0]
    qkvif, og, z = _mlstm_inputs(params, x_t, spec, tp)
    state, h = _mlstm_step(state, qkvif)
    g = h.reshape(B, -1).to(x_t.dtype) * og * F.silu(z)
    if tp is not None:
        return sharding.wide_matmul(g, params["down"]), state
    return g @ params["down"], state


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


def init_slstm_state(batch: int, spec: XLSTMSpec, device=None, *,
                     width: int | None = None) -> SLSTMState:
    """The initial state of ``width`` channels (default: ``d_model``)."""
    d = width or spec.d_model

    def z():
        return torch.zeros((batch, d), dtype=F32, device=device)
    return SLSTMState(c=z(), n=z(),
                      m=torch.full((batch, d), -1e30, dtype=F32,
                                   device=device), h=z())


def _slstm_step(params, spec: XLSTMSpec, state: SLSTMState, wx_t,
                tp=None):
    """wx_t: (B, 4d) precomputed input projection for step t.  Under
    ``tp`` (:func:`_slstm_channels`) the state, ``wx_t``, ``r`` and
    ``fb`` are this rank's channel blocks, and ``h`` is gathered whole for
    the recurrent product."""
    B = wx_t.shape[0]
    dh = spec.s_head
    h = state.h if tp is None else sharding.gather_seq(
        state.h, tp.tp.mesh, tp.tp_axis, -1)
    hr = h.reshape(B, -1, dh).to(wx_t.dtype)
    r = params["r"].to(wx_t.dtype)
    rec = torch.einsum("bhi,hij->bhj", hr, r).reshape(B, -1)
    pre = wx_t + rec
    zi, ii, fi, oi = torch.chunk(pre, 4, dim=-1)
    fb = params["fb"].to(wx_t.dtype)
    ft = _logsig(fi + fb)
    m_new = torch.maximum(ft + state.m, ii)
    fg = torch.exp(ft + state.m - m_new)
    ig = torch.exp(ii - m_new)
    c = fg * state.c + ig * torch.tanh(zi)
    n = fg * state.n + ig
    h = torch.sigmoid(oi) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, m_new, h), h


def _slstm_ffn(params, h: torch.Tensor, spec: XLSTMSpec,
               tp=None) -> torch.Tensor:
    """The gated FFN after the sLSTM (pf 4/3): tanh-GELU gate.  Under
    ``tp`` ``h`` is the rank's block of the channels and each of
    ``ffn_wi`` / ``ffn_wo`` a rank's block as the rules place it (or
    whole): ``ffn_wi``'s rows take the rank's channels and their partial
    product is summed (in float32 at least), its columns take ``h``
    gathered and their product is gathered so that ``g`` and ``u`` pair;
    ``ffn_wo``'s rows take the rank's block of the activation and give its
    partial of the output (:func:`ffn_partial`; a single position's wider
    than h's dtype, ``sharding.wide_matmul``), its columns give a block of
    the output, gathered whole."""
    wi, wo = params["ffn_wi"], params["ffn_wo"]
    d, f = spec.d_model, int(spec.d_model * spec.s_ffn_factor)
    if tp is not None:
        mesh, axis = tp.tp.mesh, tp.tp_axis
        if wi.shape[0] != d:
            t = wide(h).dtype
            gu = sharding.all_sum(h.to(t) @ wi.to(t), mesh, axis).to(h.dtype)
        else:
            h = sharding.gather_seq(h, mesh, axis, -1)
            gu = h @ wi
            if wi.shape[1] != 2 * f:
                gu = sharding.gather_seq(gu, mesh, axis, -1)
    else:
        gu = h @ wi
    g, u = torch.chunk(gu, 2, dim=-1)
    act = F.gelu(g, approximate="tanh") * u
    if tp is None:
        return act @ wo
    if ffn_partial(params, spec):
        act = sharding.tp_block(act, tp, -1)
        return sharding.wide_matmul(act, wo) if act.ndim == 2 else act @ wo
    y = act @ wo
    if wo.shape[1] != d:
        y = sharding.gather_seq(y, mesh, axis, -1)
    return y


def ffn_partial(params, spec: XLSTMSpec) -> bool:
    """Whether an sLSTM's ``ffn_wo`` is a rank's block of its rows: the
    FFN's output is then the rank's partial sum."""
    return params["ffn_wo"].shape[0] != int(spec.d_model * spec.s_ffn_factor)


def _slstm_channels(params, wx: torch.Tensor, tp):
    """``(r and fb, wx)`` of the channels this rank steps: under ``tp``
    its product on its gate columns (.., 4d/m) exchanged into its block of
    the channels, all four gates (.., 4d/m), ``fb`` cut to that block;
    ``r`` is already the rank's block of its gate columns."""
    if tp is None:
        return params, wx
    m = tp.tp_size
    lead = wx.shape[:-1]
    # (.., this rank's gates, channel blocks, width): block j to rank j;
    # what comes back is (.., its gates, source rank, width), the gates in
    # order once the source rank leads
    y = sharding.all_to_all(wx.reshape(*lead, 4 // m, m, -1), tp.tp.mesh,
                            tp.tp_axis, -2)
    own = {"r": params["r"], "fb": sharding.tp_block(params["fb"], tp, 0)}
    return own, y.transpose(-3, -2).reshape(*lead, -1)


def slstm_forward(params, x: torch.Tensor, spec: XLSTMSpec, *,
                  chunk: int = 64, tp=None) -> tuple[torch.Tensor,
                                                     SLSTMState]:
    """x: (B, S, d) -> ((B, S, d), final state); under ``tp`` the rank's
    channels' state and :func:`_slstm_ffn`'s output."""
    B = x.shape[0]
    own, wx = _slstm_channels(params, wide(x @ params["wx"]), tp)
    state, hs = time_scan(lambda s, i: _slstm_step(own, spec, s, i[0], tp),
                          init_slstm_state(B, spec, x.device,
                                           width=wx.shape[-1] // 4), (wx,))
    return _slstm_ffn(params, hs.to(x.dtype), spec, tp), state


def slstm_decode_step(params, x_t: torch.Tensor, state: SLSTMState,
                      spec: XLSTMSpec, tp=None) -> tuple[torch.Tensor,
                                                         SLSTMState]:
    """x_t: (B, d).  Under ``tp`` the state is the rank's channels'."""
    own, wx = _slstm_channels(params, wide(x_t @ params["wx"]), tp)
    state, h = _slstm_step(own, spec, state, wx, tp)
    return _slstm_ffn(params, h.to(x_t.dtype), spec, tp), state
