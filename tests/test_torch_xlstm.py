"""Port parity for ``models/xlstm.py`` (mLSTM and sLSTM) against
``repro.models.xlstm`` on the CPU, with the reference's weights and
numpy-seeded inputs.

- ``init_mlstm`` / ``init_slstm``: the reference's trees (leaves, shapes,
  dtypes), the forget biases (3.0) bit for bit; the initial states equal
  the reference's bit for bit, the stabiliser ``m`` at ``-1e30``.
- ``_mlstm_step`` / ``_slstm_step`` from the initial state (the ``-1e30``
  stabiliser meets the first token) and from a random state; the
  forwards over ragged lengths (``S % chunk != 0``) and the decode steps:
  outputs and states within rtol = atol = 2e-5 in float32 (XLA's ``exp``,
  ``log1p`` and ``tanh`` differ from torch's by ulps).
- forward then decode steps against decode steps from zero over the same
  tokens: the same outputs and state within 2e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, to_np, to_torch
from repro.models import xlstm as jxl
from repro_torch.models import xlstm

RTOL = ATOL = 2e-5
D_MODEL, HEADS = 32, 4


@functools.lru_cache(maxsize=None)
def _jparams(kind):
    spec = jxl.XLSTMSpec(d_model=D_MODEL, n_heads=HEADS)
    init = jxl.init_mlstm if kind == "mlstm" else jxl.init_slstm
    return spec, init(jax.random.key(0), spec, jnp.float32)


def _pair(kind):
    spec, jp = _jparams(kind)
    return spec, jp, xlstm.XLSTMSpec(d_model=D_MODEL, n_heads=HEADS), \
        {k: to_torch(v) for k, v in jp.items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _states_close(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, b)


def _random_state(kind, spec, B, seed):
    rng = np.random.default_rng(seed)
    if kind == "mlstm":
        H, dh = spec.n_heads, spec.m_head
        return (rng.normal(size=(B, H, dh, dh)), rng.normal(size=(B, H, dh)),
                rng.normal(size=(B, H)))
    return tuple(rng.normal(size=(B, spec.d_model)) for _ in range(4))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_tree_and_state_match_reference(kind):
    spec, jp, tspec, _ = _pair(kind)
    init = xlstm.init_mlstm if kind == "mlstm" else xlstm.init_slstm
    mine = init(tspec, torch.Generator().manual_seed(0), torch.float32,
                "cpu")
    assert sorted(mine) == sorted(jp)
    for k, v in jp.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert mine[k].dtype == torch.float32, k
    assert_bits_equal(mine["fb"], jp["fb"])
    jst = (jxl.init_mlstm_state if kind == "mlstm"
           else jxl.init_slstm_state)(3, spec)
    st = (xlstm.init_mlstm_state if kind == "mlstm"
          else xlstm.init_slstm_state)(3, tspec)
    assert st._fields == jst._fields
    for a, b in zip(st, jst):
        assert_bits_equal(a, b)
    assert float(st.m.max()) == float(np.float32(-1e30))


@pytest.mark.parametrize("start", ["init", "random"])
def test_mlstm_step_matches_reference(start):
    spec, _, tspec, _ = _pair("mlstm")
    B, H, dh = 3, spec.n_heads, spec.m_head
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, H, dh)).astype(np.float32)
               for _ in range(3))
    i, f = (rng.normal(size=(B, H)).astype(np.float32) * 3
            for _ in range(2))
    if start == "init":
        jst, st = jxl.init_mlstm_state(B, spec), xlstm.init_mlstm_state(
            B, tspec)
    else:
        parts = [a.astype(np.float32) for a in _random_state("mlstm", spec,
                                                             B, 2)]
        parts[0] = parts[0] * 10
        jst = jxl.MLSTMState(*map(jnp.asarray, parts))
        st = xlstm.MLSTMState(*map(torch.from_numpy, parts))
    ins = (q, k, v, i, f)
    jnew, jh = jax.jit(jxl._mlstm_step)(jst, tuple(map(jnp.asarray, ins)))
    new, h = xlstm._mlstm_step(st, tuple(map(torch.from_numpy, ins)))
    _close(h, jh)
    _states_close(new, jnew)


@pytest.mark.parametrize("start", ["init", "random"])
def test_slstm_step_matches_reference(start):
    spec, jp, tspec, tp = _pair("slstm")
    B = 3
    wx = _x((B, 4 * D_MODEL), seed=3) * 2
    if start == "init":
        jst, st = jxl.init_slstm_state(B, spec), xlstm.init_slstm_state(
            B, tspec)
    else:
        parts = [a.astype(np.float32) for a in _random_state("slstm", spec,
                                                             B, 4)]
        parts[1] = np.abs(parts[1]) + 0.5          # a live normaliser
        jst = jxl.SLSTMState(*map(jnp.asarray, parts))
        st = xlstm.SLSTMState(*map(torch.from_numpy, parts))
    jnew, jh = jax.jit(lambda p, s, w: jxl._slstm_step(p, spec, s, w))(
        jp, jst, jnp.asarray(wx))
    new, h = xlstm._slstm_step(tp, tspec, st, torch.from_numpy(wx))
    _close(h, jh)
    _states_close(new, jnew)


@pytest.mark.parametrize("S", [1, 21])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_forward_matches_reference(kind, S):
    """S = 21 with the reference's chunk 8: two whole chunks and a ragged
    tail of 5; S = 1 a tail alone."""
    spec, jp, tspec, tp = _pair(kind)
    jfwd = jxl.mlstm_forward if kind == "mlstm" else jxl.slstm_forward
    fwd = xlstm.mlstm_forward if kind == "mlstm" else xlstm.slstm_forward
    x = _x((2, S, D_MODEL), seed=S)
    jo, jst = jax.jit(lambda p, x: jfwd(p, x, spec, chunk=8))(
        jp, jnp.asarray(x))
    o, st = fwd(tp, torch.from_numpy(x), tspec, chunk=8)
    _close(o, jo)
    _states_close(st, jst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_matches_reference(kind):
    spec, jp, tspec, tp = _pair(kind)
    jstep = (jxl.mlstm_decode_step if kind == "mlstm"
             else jxl.slstm_decode_step)
    step = (xlstm.mlstm_decode_step if kind == "mlstm"
            else xlstm.slstm_decode_step)
    parts = [a.astype(np.float32) for a in _random_state(kind, spec, 3, 7)]
    if kind == "slstm":
        parts[1] = np.abs(parts[1]) + 0.5
    JS = jxl.MLSTMState if kind == "mlstm" else jxl.SLSTMState
    TS = xlstm.MLSTMState if kind == "mlstm" else xlstm.SLSTMState
    x = _x((3, D_MODEL), seed=8)
    jo, jst = jax.jit(lambda p, x, s: jstep(p, x, s, spec))(
        jp, jnp.asarray(x), JS(*map(jnp.asarray, parts)))
    o, st = step(tp, torch.from_numpy(x), TS(*map(torch.from_numpy, parts)),
                 tspec)
    _close(o, jo)
    _states_close(st, jst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_forward_then_decode_matches_decode_only(kind):
    _, _, tspec, tp = _pair(kind)
    fwd = xlstm.mlstm_forward if kind == "mlstm" else xlstm.slstm_forward
    step = (xlstm.mlstm_decode_step if kind == "mlstm"
            else xlstm.slstm_decode_step)
    init = (xlstm.init_mlstm_state if kind == "mlstm"
            else xlstm.init_slstm_state)
    S, n = 11, 4
    x = torch.from_numpy(_x((2, S + n, D_MODEL), seed=12))
    out, st = fwd(tp, x[:, :S], tspec)
    outs = [out]
    for t in range(S, S + n):
        y, st = step(tp, x[:, t], st, tspec)
        outs.append(y[:, None])
    ref_st, ref = init(2, tspec), []
    for t in range(S + n):
        y, ref_st = step(tp, x[:, t], ref_st, tspec)
        ref.append(y[:, None])
    _close(torch.cat(outs, 1), torch.cat(ref, 1).numpy())
    for a, b in zip(st, ref_st):
        _close(a, b.numpy())
