"""Port parity for the dense decode cache: init_cache, cache_from_prefill
(pad and trim), kv_interleaved.append_token and decode_step (fused and
per-access) against repro's; then the port's paged step against its own
dense step (the ported tests/test_paged.py oracle) and prefill-then-decode
against the teacher-forced forward (the ported
tests/test_smoke_archs.py::test_prefill_then_decode_matches_forward).

Tolerances: cache construction and the one-beat append are lane copies,
bit for bit.  decode_step logits agree with the reference's within rtol
1e-5 / atol 1e-5 (float32 matmuls summed in another order), and the greedy
tokens are equal.  Inside the port, the paged step equals the dense step
bit for bit on windowless layers (the page gather rebuilds the dense
cache's (B, S, K, 2D) array and everything after is the same
computation); windowed layers (the dense ring buffer against the paged
attention-time mask: same attended set, another storage order) agree
within rtol 2e-5 / atol 2e-5, and decode after prefill agrees with the
teacher-forced forward within the reference's rtol 2e-2 / atol 2e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, jax_tree_to_np, to_torch
from repro.configs import get_arch as jget_arch
from repro.kernels import kv_interleaved as jkv
from repro.models import decode as jdec
from repro.models import transformer as jtf
from repro_torch.configs.base import get_arch
from repro_torch.kernels import kv_interleaved
from repro_torch.models import decode as dec
from repro_torch.models.transformer import (ModelConfig, forward,
                                            init_params, params_from_jax)

RTOL = ATOL = 1e-5


def _cfg(layers=2, hd=16, scan=False, impl="ref", positions=1, window=None,
         d_ff=64):
    """tests/test_paged.py's ``_cfg``, for the port's ModelConfig."""
    return ModelConfig(
        name="paged-test", d_model=2 * hd, n_layers=layers, n_heads=2,
        n_kv_heads=2, d_ff=d_ff, vocab=97, head_dim=hd, mlp="swiglu",
        block_pattern=("attn",) * positions,
        window_pattern=(window,) * positions,
        moe_pattern=(False,) * positions,
        scan_layers=scan, kernel_impl=impl, remat="none")


@functools.lru_cache(maxsize=None)
def _jax_smoke():
    cfg = jget_arch("qwen3-0.6b").smoke
    return cfg, jtf.init_params(cfg, jax.random.key(0))


def _smoke(impl="ref"):
    jcfg, jparams = _jax_smoke()
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl=impl)
    return jcfg, jparams, cfg, params_from_jax(jax_tree_to_np(jparams), cfg,
                                               device="cpu")


# ---------------------------------------------------------------------------
# The dense cache against the reference
# ---------------------------------------------------------------------------

WINDOWS = {"global": (None, None), "ring": (None, 8), "wide-window": (40, 8)}


def _assert_len(got, want):
    assert got["len"].dtype == torch.int32 and got["len"].dim() == 0
    assert int(got["len"]) == int(want["len"])


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_init_cache_matches_reference(name):
    kw = dict(name="cache-test", d_model=32, n_layers=4, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=97, head_dim=16,
              block_pattern=("attn", "attn"), window_pattern=WINDOWS[name],
              moe_pattern=(False, False))
    jcfg, cfg = jtf.ModelConfig(**kw), ModelConfig(**kw)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = dec.init_cache(cfg, 3, 32, dtype, device="cpu")
        want = jdec.init_cache(jcfg, 3, 32, jdtype)
        _assert_len(got, want)
        assert sorted(got["blocks"]) == sorted(want["blocks"])
        for k, w in want["blocks"].items():
            assert got["blocks"][k].dtype == dtype
            assert_bits_equal(got["blocks"][k], w)
        for i in range(2):
            assert dec.cache_len_for_pos(cfg, i, 32) == \
                jdec.cache_len_for_pos(jcfg, i, 32)


@pytest.mark.parametrize("seq_len,max_len", [(6, 16), (16, 16), (20, 12)],
                         ids=["pad", "exact", "trim"])
def test_cache_from_prefill_matches_reference(seq_len, max_len):
    kw = dict(name="cache-test", d_model=32, n_layers=4, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=97, head_dim=16,
              block_pattern=("attn", "attn"), window_pattern=(None, 4),
              moe_pattern=(False, False))
    jcfg, cfg = jtf.ModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(seq_len)
    states = {"pos0": rng.normal(size=(2, 3, seq_len, 2, 32)),
              "pos1": rng.normal(size=(2, 3, min(seq_len, 4), 2, 32))}
    states = {k: v.astype(np.float32) for k, v in states.items()}
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        tstates = {k: to_torch(v) for k, v in states.items()}
        got = dec.cache_from_prefill(cfg, tstates, seq_len, max_len, dtype)
        want = jdec.cache_from_prefill(
            jcfg, {k: jnp.asarray(v) for k, v in states.items()}, seq_len,
            max_len, jdtype)
        _assert_len(got, want)
        for k, w in want["blocks"].items():
            assert_bits_equal(got["blocks"][k], w)
            # a fresh cache: decode writes it in place
            assert got["blocks"][k].data_ptr() != tstates[k].data_ptr()


@pytest.mark.parametrize("pos", [0, 5, 15, 21, -3, -30])
def test_append_token_matches_reference(pos):
    rng = np.random.default_rng(abs(pos))
    cache = rng.normal(size=(2, 16, 3, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 3, 4)).astype(np.float32) for _ in range(2))
    want = jkv.append_token(jnp.asarray(cache), jnp.asarray(k),
                            jnp.asarray(v), pos)
    for policy in ("ref", "kernel"):
        for p in (pos, torch.tensor(pos, dtype=torch.int32)):
            got = kv_interleaved.append_token(to_torch(cache), to_torch(k),
                                              to_torch(v), p, policy=policy)
            assert_bits_equal(got, want)
    bf = kv_interleaved.append_token(to_torch(cache).bfloat16(),
                                     to_torch(k), to_torch(v), pos)
    assert_bits_equal(bf, jkv.append_token(
        jnp.asarray(cache, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
        pos))


@pytest.mark.parametrize("fuse", [True, False])
def test_decode_step_matches_reference(fuse):
    """Prefill 12 tokens (the reference's states, bit for bit into both
    caches), then 6 greedy steps: logits within the tolerance, the greedy
    tokens equal, the caches' beats within the tolerance."""
    jcfg, jparams, cfg, params = _smoke()
    toks = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(
        np.int32)
    logits, _, states = jax.jit(lambda p, b: jtf.forward(
        p, b, jcfg, None, mode="prefill"))(jparams,
                                           {"tokens": jnp.asarray(toks)})
    jc = jdec.cache_from_prefill(jcfg, states, 12, 20, jnp.float32)
    tc = dec.cache_from_prefill(
        cfg, {k: to_torch(v) for k, v in states.items()}, 12, 20)
    step = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, jcfg, None,
                                                    fuse=fuse))
    tok = np.argmax(np.asarray(logits)[:, -1], -1).astype(np.int32)
    for _ in range(6):
        want, jc = step(jparams, jc, jnp.asarray(tok))
        got, tc = dec.decode_step(params, tc, torch.from_numpy(tok), cfg,
                                  fuse=fuse)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), nxt)
        tok = nxt
    assert int(tc["len"]) == int(jc["len"]) == 18
    np.testing.assert_allclose(tc["blocks"]["pos0"].numpy(),
                               np.asarray(jc["blocks"]["pos0"]), rtol=RTOL,
                               atol=ATOL)


def test_decode_step_ring_buffer_matches_reference():
    """A windowed layer's ring buffer wraps (window 4, 9 steps)."""
    kw = dict(name="ring", d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab=97, head_dim=16, window_pattern=(4,),
              remat="none")
    jcfg, cfg = jtf.ModelConfig(**kw), ModelConfig(**kw, kernel_impl="ref")
    jparams = jtf.init_params(jcfg, jax.random.key(5))
    params = params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")
    jc = jdec.init_cache(jcfg, 2, 16, jnp.float32)
    tc = dec.init_cache(cfg, 2, 16, device="cpu")
    step = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, jcfg, None))
    tok = np.asarray([3, 9], np.int32)
    for _ in range(9):
        want, jc = step(jparams, jc, jnp.asarray(tok))
        got, tc = dec.decode_step(params, tc, torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), tok)


def test_decode_step_refuses_what_waits():
    """``kv_shard`` no longer waits (the sequence-sharded step, item 9h's
    serving half; 8 ranks in tests/test_torch_dist.py): on a one-rank
    mesh the fused and per-access steps agree bit for bit and track the
    unsharded step within the file's tolerance (the distributed softmax
    divides after its merge), and return their KV leaves placed, equal to
    the unsharded cache; a shard on another axis than the cache's
    sequence is refused."""
    from _torch_dist_run import one_rank_group
    from repro_torch import vx
    from repro_torch.dist import sharding
    _, _, cfg, params = _smoke()
    with one_rank_group():
        mesh = sharding.make_mesh((1,), ("s",), device="cpu")
        shard = vx.Shard(axes=("s",), axis=-3, mesh=mesh)
        caches = {k: dec.init_cache(cfg, 1, 8, device="cpu")
                  for k in ("plain", True, False)}
        tok = torch.tensor([3], dtype=torch.int32)
        for _ in range(3):
            want, caches["plain"] = dec.decode_step(params, caches["plain"],
                                                    tok, cfg)
            got = {}
            for fuse in (True, False):
                got[fuse], caches[fuse] = dec.decode_step(
                    params, caches[fuse], tok, cfg, fuse=fuse,
                    kv_shard=shard)
            assert_bits_equal(got[True], got[False])
            np.testing.assert_allclose(got[True].numpy(), want.numpy(),
                                       rtol=RTOL, atol=ATOL)
            tok = want.argmax(-1).to(torch.int32)
        for fuse in (True, False):
            for k, leaf in caches[fuse]["blocks"].items():
                assert sharding.is_dtensor(leaf)
                np.testing.assert_allclose(
                    sharding.full_tensor(leaf).numpy(),
                    caches["plain"]["blocks"][k].numpy(), rtol=RTOL,
                    atol=ATOL)
        with pytest.raises(ValueError, match="sequence axis"):
            dec.decode_step(params, dec.init_cache(cfg, 1, 8, device="cpu"),
                            tok, cfg, kv_shard=vx.Shard(axes=("s",), axis=-1,
                                                        mesh=mesh))


# ---------------------------------------------------------------------------
# The port's paged step against its own dense step (tests/test_paged.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", (4, 8, 16))
@pytest.mark.parametrize("slots", (1, 3))
def test_paged_decode_bit_exact_vs_dense_sweep(page_size, slots):
    """Fused AND per-access paged decode reproduce the dense decode step
    bit for bit, step by step, over (page_size, slots)."""
    cfg = _cfg(layers=2, hd=16, scan=True)
    params = init_params(cfg, 0, device="cpu")
    max_len = 16
    dense = dec.init_cache(cfg, slots, max_len, device="cpu")
    pf = dec.init_paged_cache(cfg, slots, max_len, page_size, device="cpu")
    pu = dec.init_paged_cache(cfg, slots, max_len, page_size, device="cpu")
    top = int(pf["free_top"])
    tok = (torch.arange(slots, dtype=torch.int32) * 7 + 3) % cfg.vocab
    for _ in range(6):
        ld, dense = dec.decode_step(params, dense, tok, cfg, fuse=False)
        lf, pf = dec.paged_decode_step(params, pf, tok, cfg, fuse=True)
        lu, pu = dec.paged_decode_step(params, pu, tok, cfg, fuse=False)
        assert_bits_equal(lu, ld)
        assert_bits_equal(lf, ld)
        tok = torch.argmax(ld.float(), dim=-1).to(torch.int32)
    # memory accounting: pages allocated == ceil(tokens/page) per slot
    assert top - int(pf["free_top"]) == slots * -(-6 // page_size)


def test_paged_heterogeneous_lengths_match_solo_dense():
    """Mixed request lengths in one paged batch (a late joiner through the
    active mask): every active slot's logits equal, bit for bit, a dense
    decode of the same forced token stream run fresh in that slot."""
    cfg = _cfg(layers=2, hd=16, scan=False)
    params = init_params(cfg, 1, device="cpu")
    max_len, ps = 16, 4
    paged = dec.init_paged_cache(cfg, 2, max_len, ps, device="cpu")
    streams = {0: [5], 1: [11]}        # slot 1 joins at step 2
    joins = {0: 0, 1: 2}
    paged_logits = {0: [], 1: []}
    for step in range(6):
        act = torch.tensor([joins[s] <= step for s in (0, 1)])
        tok = torch.tensor([streams[s][-1] if joins[s] <= step else 0
                            for s in (0, 1)], dtype=torch.int32)
        lg, paged = dec.paged_decode_step(params, paged, tok, cfg,
                                          active=act)
        for s in (0, 1):
            if joins[s] <= step:
                paged_logits[s].append(lg[s].clone())
                streams[s].append(int(torch.argmax(lg[s].float())))
    for s in (0, 1):
        solo = dec.init_cache(cfg, 2, max_len, device="cpu")
        toks = [[5, 11][s]]
        for want in paged_logits[s]:
            cur = [0, 0]
            cur[s] = toks[-1]
            lg, solo = dec.decode_step(params, solo,
                                       torch.tensor(cur, dtype=torch.int32),
                                       cfg)
            assert_bits_equal(lg[s], want)
            toks.append(int(torch.argmax(lg[s].float())))


def test_paged_windowed_layers_allclose_vs_dense_ring():
    """Sliding-window layers: paged full length + attention-time mask
    against the dense ring buffer — same attended set, another storage
    order."""
    cfg = _cfg(layers=2, hd=16, scan=True, window=8)
    params = init_params(cfg, 2, device="cpu")
    dense = dec.init_cache(cfg, 2, 32, device="cpu")
    paged = dec.init_paged_cache(cfg, 2, 32, 4, device="cpu")
    tok = torch.tensor([3, 9], dtype=torch.int32)
    for _ in range(12):                # crosses the window boundary at 8
        ld, dense = dec.decode_step(params, dense, tok, cfg)
        lp, paged = dec.paged_decode_step(params, paged, tok, cfg)
        np.testing.assert_allclose(ld.numpy(), lp.numpy(), rtol=2e-5,
                                   atol=2e-5)
        tok = torch.argmax(ld.float(), dim=-1).to(torch.int32)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_prefill_then_decode_matches_forward(impl):
    """Decode after prefill agrees with the teacher-forced forward
    (qwen3 smoke, the reference's weights; tests/test_smoke_archs.py)."""
    _, _, cfg, params = _smoke(impl)
    S, B = 32, 2
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    logits_all, _, states = forward(params, {"tokens": toks}, cfg,
                                    mode="prefill")
    cache = dec.cache_from_prefill(cfg, states, S, S + 4)
    nxt = torch.argmax(logits_all[:, -1].float(), dim=-1).to(torch.int32)
    logits_dec, _ = dec.decode_step(params, cache, nxt, cfg)
    logits2, _, _ = forward(params, {"tokens": torch.cat(
        [toks, nxt[:, None]], dim=1)}, cfg)
    np.testing.assert_allclose(logits_dec.float().numpy(),
                               logits2[:, -1].float().numpy(), rtol=2e-2,
                               atol=2e-2)
