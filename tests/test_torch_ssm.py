"""Port parity for ``models/ssm.py`` (the Mamba block) against
``repro.models.ssm`` on the CPU, with the reference's weights and
numpy-seeded inputs.

- ``init_mamba``: the reference's tree (leaves, shapes, dtypes); ``D``
  and ``conv_b`` bit for bit; ``A_log`` is ``log(1..N)`` correctly rounded
  to float32 bit for bit, within one ulp of the reference's (XLA's CPU
  ``log`` is not correctly rounded: a few of ``log(1..64)`` sit one ulp
  off); ``dt_bias`` the inverse softplus of a draw in ``[1e-3, 1e-1]``.
- ``softplus`` against ``jax.nn.softplus``, far into both tails.
- ``_causal_conv``, ``selective_scan`` with a ragged tail (``S % chunk !=
  0``), ``mamba_forward`` (also shorter than the conv window) and
  ``mamba_decode_step``: outputs and states within rtol = atol = 2e-5 in
  float32 (XLA's ``exp`` / ``log1p`` differ from torch's by ulps); in
  bfloat16 the conv window keeps the cache dtype and ``h`` stays float32,
  as in the reference.
- ``mamba_forward`` then decode steps against decode steps from zero over
  the same tokens: the same outputs and state within 2e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, to_np, to_torch
from repro.models import ssm as jssm
from repro_torch.models import ssm

RTOL = ATOL = 2e-5
SPEC = dict(d_model=32, expand=2, state_dim=8, conv_width=4)


@functools.lru_cache(maxsize=None)
def _jparams(dtype="float32"):
    spec = jssm.MambaSpec(**SPEC)
    return spec, jssm.init_mamba(jax.random.key(0), spec, jnp.dtype(dtype))


def _pair(dtype="float32"):
    spec, jp = _jparams(dtype)
    return spec, jp, ssm.MambaSpec(**SPEC), {k: to_torch(v)
                                             for k, v in jp.items()}


def _x(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(to_np(got).astype(np.float32), want,
                               rtol=rtol, atol=atol)


def test_init_mamba_tree_matches_reference():
    spec, jp, tspec, _ = _pair()
    g = torch.Generator().manual_seed(0)
    mine = ssm.init_mamba(tspec, g, torch.float32, "cpu")
    assert sorted(mine) == sorted(jp)
    for k, v in jp.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert mine[k].dtype == torch.float32, k
    assert_bits_equal(mine["D"], jp["D"])
    assert_bits_equal(mine["conv_b"], jp["conv_b"])
    N = spec.state_dim
    want = np.log(np.arange(1, N + 1, dtype=np.float64)).astype(np.float32)
    assert_bits_equal(mine["A_log"], np.broadcast_to(want, (spec.ed, N)))
    ulps = np.abs(to_np(mine["A_log"]).view(np.int32).astype(np.int64)
                  - np.asarray(jp["A_log"]).view(np.int32))
    assert ulps.max() <= 1
    u = np.log1p(np.exp(to_np(mine["dt_bias"]).astype(np.float64)))
    assert u.min() >= 1e-3 * (1 - 1e-5) and u.max() <= 1e-1 * (1 + 1e-5)
    bf = ssm.init_mamba(tspec, torch.Generator().manual_seed(0),
                        torch.bfloat16, "cpu")
    assert {v.dtype for v in bf.values()} == {torch.bfloat16}


def test_softplus_matches_jax():
    x = np.concatenate([_x((4096,)) * 30, [-200.0, -30.0, 0.0, 30.0,
                                           200.0]]).astype(np.float32)
    _close(ssm.softplus(torch.from_numpy(x)), jax.nn.softplus(x),
           rtol=1e-6, atol=1e-7)


def test_causal_conv_matches_reference():
    _, jp, _, tp = _pair()
    x = _x((2, 11, 64))
    _close(ssm._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"]),
           jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"]))


@pytest.mark.parametrize("S,chunk", [(37, 16), (16, 16), (5, 128)])
def test_selective_scan_matches_reference(S, chunk):
    """Ragged tails included: the port's one loop over time takes the
    reference's chunks and its short last chunk to the same values."""
    B, ed, N = 2, 16, 8
    rng = np.random.default_rng(S)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, ed)))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32)
              for _ in range(2))
    x = rng.normal(size=(B, S, ed)).astype(np.float32)
    A = -np.exp(rng.normal(size=(ed, N))).astype(np.float32)
    D = rng.normal(size=(ed,)).astype(np.float32)
    h0 = rng.normal(size=(B, ed, N)).astype(np.float32)
    args = (dt, Bm, Cm, x, A, D, h0)
    jy, jh = jax.jit(lambda *a: jssm.selective_scan(*a, chunk=chunk))(
        *map(jnp.asarray, args))
    y, h = ssm.selective_scan(*map(torch.from_numpy, args), chunk=chunk)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("S", [2, 37])
def test_mamba_forward_matches_reference(S):
    """Output, final conv window and state; S = 2 is shorter than the
    conv window (the window is left-padded with zeros)."""
    spec, jp, tspec, tp = _pair()
    x = _x((2, S, SPEC["d_model"]), seed=S)
    jo, jc = jax.jit(lambda p, x: jssm.mamba_forward(p, x, spec, chunk=16))(
        jp, jnp.asarray(x))
    o, c = ssm.mamba_forward(tp, torch.from_numpy(x), tspec, chunk=16)
    assert isinstance(c, ssm.MambaCache)
    _close(o, jo)
    _close(c.conv, jc.conv)
    _close(c.h, jc.h)
    assert c.h.dtype == torch.float32


def test_mamba_decode_step_matches_reference():
    spec, jp, tspec, tp = _pair()
    rng = np.random.default_rng(5)
    conv = rng.normal(size=(3, 3, spec.ed)).astype(np.float32)
    h = rng.normal(size=(3, spec.ed, spec.state_dim)).astype(np.float32)
    x = _x((3, SPEC["d_model"]), seed=6)
    jo, jc = jax.jit(lambda p, x, c: jssm.mamba_decode_step(p, x, c, spec))(
        jp, jnp.asarray(x), jssm.MambaCache(jnp.asarray(conv),
                                            jnp.asarray(h)))
    o, c = ssm.mamba_decode_step(tp, torch.from_numpy(x), ssm.MambaCache(
        torch.from_numpy(conv), torch.from_numpy(h)), tspec)
    _close(o, jo)
    _close(c.conv, jc.conv)
    _close(c.h, jc.h)


def test_mamba_bf16_dtypes_match_reference():
    """bfloat16 weights and cache: the conv window stays in the cache
    dtype and the state float32 through the forward and a decode step,
    the reference's dtypes; values within bf16 rounding of the
    reference's."""
    spec, jp, tspec, tp = _pair("bfloat16")
    x = _x((2, 9, SPEC["d_model"]), seed=2)
    jo, jc = jax.jit(lambda p, x: jssm.mamba_forward(p, x, spec))(
        jp, jnp.asarray(x, jnp.bfloat16))
    o, c = ssm.mamba_forward(tp, to_torch(jnp.asarray(x, jnp.bfloat16)),
                             tspec)
    jo2, jc2 = jssm.mamba_decode_step(jp, jo[:, -1], jc, spec)
    o2, c2 = ssm.mamba_decode_step(tp, o[:, -1], c, tspec)
    for got, want in ((o, jo), (c.conv, jc.conv), (c.h, jc.h), (o2, jo2),
                      (c2.conv, jc2.conv), (c2.h, jc2.h)):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        _close(got, want, rtol=2e-2, atol=2e-2)
    ini = ssm.init_mamba_cache(2, tspec, torch.bfloat16)
    jini = jssm.init_mamba_cache(2, spec, jnp.bfloat16)
    for a, b in zip(ini, jini):
        assert_bits_equal(a, b)


def test_forward_then_decode_matches_decode_only():
    """The forward's cache carries on: forward over S tokens then n
    decode steps equals n + S decode steps from zero, outputs and state."""
    _, _, tspec, tp = _pair()
    S, n = 13, 5
    x = torch.from_numpy(_x((2, S + n, SPEC["d_model"]), seed=9))
    out, cache = ssm.mamba_forward(tp, x[:, :S], tspec)
    outs = [out]
    for t in range(S, S + n):
        y, cache = ssm.mamba_decode_step(tp, x[:, t], cache, tspec)
        outs.append(y[:, None])
    c = ssm.init_mamba_cache(2, tspec, torch.float32)
    ref = []
    for t in range(S + n):
        y, c = ssm.mamba_decode_step(tp, x[:, t], c, tspec)
        ref.append(y[:, None])
    _close(torch.cat(outs, 1), torch.cat(ref, 1).numpy())
    _close(cache.conv, c.conv.numpy())
    _close(cache.h, c.h.numpy())
