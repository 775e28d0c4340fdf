"""Port parity for the dense forward pass: attention.flash_attention (the
forward) and transformer.forward in the modes train, prefill and hidden,
against repro's, on numpy-seeded inputs with the reference's weights.

Tolerances: float32 outputs agree within rtol 1e-5 / atol 1e-5 (XLA and
torch sum the float32 matmuls and the online softmax in different orders,
so a few ULPs differ); bfloat16 flash outputs within rtol 1e-2 / atol
1e-2 (both compute in float32 and round once to bfloat16 at the end, so a
last-place difference before the rounding can flip one bfloat16 ULP,
about 4e-3 of the value); bfloat16 logits of the whole forward within four
bfloat16 ULPs of the largest logit, with equal greedy tokens.  Inside the port, ``scan_layers`` True and False
give the same bits, and the ``kernel`` policies on the CPU (the wrappers'
plain versions) agree with ``ref`` within the float32 tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, jax_tree_to_np, to_np, to_torch
from repro.configs import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs.base import get_arch
from repro_torch.models import attention, transformer
from repro_torch.models.transformer import (ModelConfig, forward,
                                            params_from_jax)

RTOL = ATOL = 1e-5
BF16_TOL = 1e-2

# (B, Sq, Sk, H, K, D, causal, window, q_offset, q_chunk, kv_chunk)
FLASH_CASES = {
    "causal": (2, 32, 32, 4, 2, 16, True, None, 0, 16, 16),
    "not-causal-ragged": (1, 37, 53, 6, 2, 8, False, None, 0, 16, 16),
    "causal-ragged-q": (2, 45, 45, 4, 4, 8, True, None, 0, 16, 32),
    "gqa-g4": (1, 24, 24, 8, 2, 16, True, None, 0, 8, 8),
    "banded": (2, 64, 64, 4, 2, 8, True, 8, 0, 16, 16),
    "banded-ragged": (1, 70, 70, 2, 1, 8, True, 5, 0, 16, 8),
    "window-unbanded": (1, 20, 20, 2, 1, 8, True, 12, 0, 16, 16),
    "q-offset": (2, 16, 40, 4, 2, 8, True, None, 24, 8, 16),
    "q-offset-banded": (1, 24, 80, 2, 2, 8, True, 10, 56, 8, 16),
    "one-chunk": (2, 9, 9, 4, 2, 8, True, None, 0, 512, 512),
}


def _qkv(case, dtype):
    B, Sq, Sk, H, K, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return j, [to_torch(np.asarray(a)) for a in j]


def _flash_kw(case):
    causal, window, q_offset, q_chunk, kv_chunk = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                q_chunk=q_chunk, kv_chunk=kv_chunk)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_matches_reference(name):
    case = FLASH_CASES[name]
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, jnp.float32)
    want = np.asarray(jattn.flash_attention(jq, jk, jv, **_flash_kw(case)))
    got = attention.flash_attention(tq, tk, tv, **_flash_kw(case))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["causal", "banded", "q-offset"])
def test_flash_attention_bf16_matches_reference(name):
    case = FLASH_CASES[name]
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, jnp.bfloat16)
    want = np.asarray(jattn.flash_attention(jq, jk, jv, **_flash_kw(case)),
                      np.float32)
    got = attention.flash_attention(tq, tk, tv, **_flash_kw(case))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_flash_attention_refuses_a_mesh():
    class Ctx:
        mesh = object()
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="dist"):
        attention.flash_attention(q, q, q, ctx=Ctx())


# ---------------------------------------------------------------------------
# transformer.forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(key: int = 0, windowed: bool = False):
    cfg = _windowed_cfg() if windowed else jget_arch("qwen3-0.6b").smoke
    return cfg, jtf.init_params(cfg, jax.random.key(key))


def _windowed_cfg(cls=jtf.ModelConfig, **kw):
    """Two positions per superblock, the second windowed (ring-trimmed
    prefill states), untied head, unfused GLU."""
    return cls(name="fwd-windowed", d_model=64, n_layers=4, n_heads=4,
               n_kv_heads=2, head_dim=16, d_ff=96, vocab=101,
               block_pattern=("attn", "attn"), window_pattern=(None, 4),
               moe_pattern=(False, False), qk_norm=True, fused_glu=False,
               tie_embeddings=False, remat="none", **kw)


def _port(windowed=False, **kw):
    jcfg, jparams = _jax_params(windowed=windowed)
    base = (_windowed_cfg(ModelConfig) if windowed
            else get_arch("qwen3-0.6b").smoke)
    cfg = dataclasses.replace(base, **{"kernel_impl": "ref", **kw})
    return jcfg, jparams, cfg, params_from_jax(jax_tree_to_np(jparams), cfg,
                                               device="cpu")


def _tokens(B=2, S=12, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("mode", ["train", "prefill", "hidden"])
def test_forward_matches_reference(mode, windowed):
    jcfg, jparams, cfg, params = _port(windowed)
    toks = _tokens(S=10 if windowed else 12, vocab=cfg.vocab)
    want, _, wstates = jax.jit(lambda p, b: jtf.forward(
        p, b, jcfg, None, mode=mode))(jparams, {"tokens": jnp.asarray(toks)})
    got, aux, states = forward(params, {"tokens": torch.from_numpy(toks)},
                               cfg, None, mode=mode)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(aux) == 0.0
    if mode != "prefill":
        assert states == {}
        return
    assert sorted(states) == sorted(wstates)
    for k, w in wstates.items():
        assert tuple(states[k].shape) == w.shape, k
        np.testing.assert_allclose(states[k].numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_forward_scan_layers_and_kernel_policies_agree():
    _, _, cfg, params = _port()
    batch = {"tokens": torch.from_numpy(_tokens(seed=1))}
    base, _, bstates = forward(params, batch, cfg, mode="prefill")
    got, _, states = forward(params, batch,
                             dataclasses.replace(cfg, scan_layers=False),
                             mode="prefill")
    assert_bits_equal(got, base)
    assert_bits_equal(states["pos0"], bstates["pos0"])
    # the kernels' plain versions return contiguous tensors where ``ref``
    # returns strided views, and torch's CPU matmuls sum those in another
    # order: the float32 tolerance, not bits
    for impl in ("kernel", "kernel_dynamic"):
        got, _, states = forward(params, batch,
                                 dataclasses.replace(cfg, kernel_impl=impl),
                                 mode="prefill")
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(states["pos0"].numpy(),
                                   bstates["pos0"].numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_forward_bf16_compute_matches_reference():
    jcfg, jparams, cfg, params = _port(compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    toks = _tokens(seed=2)
    want, _, _ = jax.jit(lambda p, b: jtf.forward(p, b, jcfg, None))(
        jparams, {"tokens": jnp.asarray(toks)})
    got, _, _ = forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    g = to_np(got).astype(np.float32)
    # bf16 activations through two layers round differently in each
    # package: within four bfloat16 ULPs (eps 2**-7) of the largest logit,
    # and the greedy tokens equal
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=4 * 2.0 ** -7 * np.abs(w).max())
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_param_count_and_ring_trim_match_reference():
    jcfg, jparams, cfg, params = _port(windowed=True)
    assert transformer.param_count(params) == jtf.param_count(jparams)
    kv = np.random.default_rng(3).normal(size=(2, 11, 2, 8)).astype(
        np.float32)
    for window in (None, 4, 11, 16):
        assert_bits_equal(transformer._ring_trim(to_torch(kv), window),
                          jtf._ring_trim(jnp.asarray(kv), window))


def test_forward_refuses_what_waits():
    _, _, cfg, params = _port()
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="mode"):
        forward(params, batch, cfg, mode="decode")

    class Ctx:
        mesh = object()
    with pytest.raises(NotImplementedError, match="dist"):
        forward(params, batch, cfg, Ctx())
    with pytest.raises(NotImplementedError):
        forward(params, batch, dataclasses.replace(
            cfg, block_pattern=("mamba",)))
