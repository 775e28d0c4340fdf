"""Port parity for the recurrent and hybrid models through the forward, the
dense cache and the paged cache: jamba-smoke (Mamba and attention, MoE)
and xlstm-smoke (mLSTM and sLSTM, no attention), against ``repro`` with
the reference's weights, on the CPU (the scheduler, the cache bytes and
the CLI: tests/test_torch_recurrent_sched.py).

- ``init_params``: the reference's tree (``in_proj`` as ``(d, 2, ed)``,
  ``up`` as ``(d, 2, m_inner)``) and parameter count.
- ``forward`` in the modes train and prefill: logits and the prefill
  states (KV beats and the recurrent NamedTuples) against the reference's.
  jamba within rtol = atol = 2e-5.  xlstm within 2e-3: each mLSTM block
  holds 2e-5 on its own (tests/test_torch_xlstm.py), but the stack
  amplifies ulp-level differences of XLA's and torch's ``exp`` / ``log1p``
  some fiftyfold; one ulp moved in one weight of the reference moves its
  own logits by 3.2e-4.
- The dense cache: ``init_cache`` bit for bit, then ``cache_from_prefill``
  and forced-token ``decode_step``s, logits and states as the forward.
- The paged cache: ``init_paged_cache`` leaves bit for bit (int8 pools
  too); chunked prefill with pad tokens and decode steps with idle slots
  in lockstep with the reference: page state exact, recurrent leaves and
  logits as the forward; ``paged_release_slot`` resets the slot's
  recurrent leaves to the reference's bit for bit.
- Prompt prefill on a hybrid stack through the scheduler (the reference's
  ``test_prompt_prefill_hybrid_recurrent_layers``: pad tokens do not
  leak) within its 2e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, jax_tree_to_np
from repro.configs import base as jbase
from repro.models import decode as jdec
from repro.models import transformer as jtf
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.configs import base
from repro_torch.kernels._common import tree_leaves
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tf
from repro_torch.serve.scheduler import Scheduler

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
ARCHS = (JAMBA, XLSTM)
TOL = {JAMBA: 2e-5, XLSTM: 2e-3}
STATE = ("table", "free", "free_top", "ref", "pos")
PAGE = 4


@functools.lru_cache(maxsize=None)
def _jax(name):
    cfg = jbase.get_arch(name).smoke
    return cfg, jtf.init_params(cfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port(name, impl="ref"):
    _, jparams = _jax(name)
    cfg = dataclasses.replace(base.get_arch(name).smoke, kernel_impl=impl)
    return cfg, tf.params_from_jax(jax_tree_to_np(jparams), cfg,
                                   device="cpu")


def _close(got, want, name):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=TOL[name], atol=TOL[name])


def _tree_check(got, want, leaf_check):
    """Leaf by leaf (dicts by key, the recurrent NamedTuples by their
    fields): equal dtypes, then ``leaf_check``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_check(got[k], want[k], leaf_check)
    elif isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__
        for a, b in zip(got, want):
            _tree_check(a, b, leaf_check)
    else:
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        leaf_check(got, want)


def _tree_close(got, want, name):
    _tree_check(got, want, lambda a, b: _close(a, b, name))


def _tree_bits(got, want):
    _tree_check(got, want, lambda a, b: assert_bits_equal(
        a.reshape(-1), np.asarray(b).reshape(-1)))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# init and forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_init_params_tree_matches_reference(name):
    jcfg = jbase.get_arch(name).smoke
    want = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)
    params = tf.init_params(base.get_arch(name).smoke, 0, device="cpu")
    assert _shapes(params) == want
    assert tf.param_count(params) == jtf.param_count(_jax(name)[1])


def _tokens(vocab, shape=(2, 24), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_forward(name, mode):
    jcfg, jparams = _jax(name)
    logits, aux, states = jax.jit(lambda p, t: jtf.forward(
        p, {"tokens": t}, jcfg, None, mode=mode))(
            jparams, jnp.asarray(_tokens(jcfg.vocab)))
    return np.asarray(logits), float(aux), jax_tree_to_np(states)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name, mode):
    cfg, params = _port(name)
    want, want_aux, want_states = _jax_forward(name, mode)
    got, aux, states = tf.forward(
        params, {"tokens": torch.from_numpy(_tokens(cfg.vocab))}, cfg,
        mode=mode)
    assert tuple(got.shape) == want.shape
    _close(got, want, name)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5, atol=0)
    if mode == "prefill":
        _tree_close(states, want_states, name)


# ---------------------------------------------------------------------------
# the dense cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_dense_cache_and_decode_step_match_reference(name):
    """``init_cache`` bit for bit; prefill of 10 tokens into a 16-token
    cache, then 4 forced-token decode steps, fused and per-access."""
    jcfg, jparams = _jax(name)
    cfg, params = _port(name)
    _tree_bits(dec.init_cache(cfg, 2, 16, device="cpu"),
               jdec.init_cache(jcfg, 2, 16, jnp.float32))
    toks = _tokens(cfg.vocab, (2, 10), seed=1)
    forced = _tokens(cfg.vocab, (4, 2), seed=2)
    _, _, jst = jtf.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                            None, mode="prefill")
    jc = jdec.cache_from_prefill(jcfg, jst, 10, 16, jnp.float32)
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, jcfg, None))
    want = []
    for t in forced:
        lg, jc = jstep(jparams, jc, jnp.asarray(t))
        want.append(np.asarray(lg))
    for fuse in (True, False):
        _, _, st = tf.forward(params, {"tokens": torch.from_numpy(toks)},
                              cfg, mode="prefill")
        c = dec.cache_from_prefill(cfg, st, 10, 16)
        for t, w in zip(forced, want):
            lg, c = dec.decode_step(params, c, torch.from_numpy(t), cfg,
                                    fuse=fuse)
            _close(lg, w, name)
        assert int(c["len"]) == int(jc["len"]) == 14
        _tree_close(c["blocks"], jax_tree_to_np(jc["blocks"]), name)


# ---------------------------------------------------------------------------
# the paged cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("name", ARCHS)
def test_init_paged_cache_leaves_match_reference(name, quant):
    """Pools only at attention positions, per-slot recurrent leaves
    elsewhere (in the cache dtype for the Mamba conv window, float32 for
    the rest, also beside an int8 pool)."""
    jcfg, _ = _jax(name)
    cfg = base.get_arch(name).smoke
    for dtype in ("float32", "bfloat16"):
        got = dec.init_paged_cache(cfg, 3, 32, PAGE, getattr(torch, dtype),
                                   quantize=quant, device="cpu")
        want = jdec.init_paged_cache(jcfg, 3, 32, PAGE, jnp.dtype(dtype),
                                     quantize=quant)
        _tree_bits(got, want)


@functools.lru_cache(maxsize=None)
def _jpaged(jcfg):
    return (jax.jit(lambda p, c, t, s, n: jdec.paged_prefill_chunk(
                p, c, t, jcfg, None, slot=s, count=n)),
            jax.jit(lambda p, c, t, a: jdec.paged_decode_step(
                p, c, t, jcfg, None, active=a)),
            jax.jit(lambda c, s: jdec.paged_release_slot(jcfg, c, s)))


def _paged_lockstep(name, fuse):
    """Chunks with pad tokens into two slots, decode steps with an idle
    slot, a release: the port and the reference after every op."""
    jcfg, jparams = _jax(name)
    cfg, params = _port(name)
    jchunk, jstep, jrel = _jpaged(jcfg)
    tc = dec.init_paged_cache(cfg, 2, 32, PAGE, device="cpu")
    jc = jdec.init_paged_cache(jcfg, 2, 32, PAGE, jnp.float32)
    toks = _tokens(cfg.vocab, (6, PAGE), seed=3)

    def same(lg=None, jlg=None):
        for k in STATE:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                          err_msg=k)
        for i, kind in enumerate(cfg.block_pattern):
            if kind != "attn":
                _tree_close(tc["blocks"][f"pos{i}"],
                            jax_tree_to_np(jc["blocks"][f"pos{i}"]), name)
        if lg is not None:
            _close(lg, jlg, name)

    for tok, slot, count in ((toks[0], 0, 3), (toks[1], 1, 4),
                             (toks[2], 1, 2)):
        jc = jchunk(jparams, jc, jnp.asarray(tok), slot, count)
        tc = dec.paged_prefill_chunk(params, tc, torch.from_numpy(tok), cfg,
                                     slot=slot, count=count)
        same()
    for t, act in ((toks[3, :2], [True, False]), (toks[4, :2], [True, True]),
                   (toks[5, :2], [False, True])):
        jlg, jc = jstep(jparams, jc, jnp.asarray(t), jnp.asarray(act))
        lg, tc = dec.paged_decode_step(params, tc, torch.from_numpy(t), cfg,
                                       active=torch.tensor(act), fuse=fuse)
        same(lg, jlg)
    jc = jrel(jc, 1)
    tc = dec.paged_release_slot(cfg, tc, 1)
    same()
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "attn":
            for a, b in zip(tree_leaves(tc["blocks"][f"pos{i}"]),
                            jax.tree.leaves(jc["blocks"][f"pos{i}"])):
                assert_bits_equal(a[:, 1], np.asarray(b)[:, 1])
    assert not dec.paged_invariants(cfg, tc)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", ARCHS)
def test_paged_chunk_step_release_match_reference(name, fuse):
    _paged_lockstep(name, fuse)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _hybrid_kw():
    return dict(name="hyb-serve", d_model=32, n_layers=2, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab=97, head_dim=16, mlp="swiglu",
                block_pattern=("attn", "mamba"), window_pattern=(None, None),
                moe_pattern=(False, False), scan_layers=True, remat="none")


def test_prompt_prefill_hybrid_recurrent_layers():
    """The reference's case on the port: 5 prefilled tokens, not a page
    multiple; the pad tokens of the prefill chunk must not leak into the
    slot's Mamba state.  The scheduler's logits against token-by-token
    paged decode steps, and against the reference scheduler's, within the
    reference's 2e-4."""
    from repro.models.ssm import MambaSpec as JMambaSpec
    from repro_torch.models.ssm import MambaSpec
    jcfg = jtf.ModelConfig(**_hybrid_kw(), mamba=JMambaSpec(d_model=32),
                           kernel_impl="ref")
    cfg = tf.ModelConfig(**_hybrid_kw(), mamba=MambaSpec(d_model=32),
                         kernel_impl="ref")
    jparams = jtf.init_params(jcfg, jax.random.key(8))
    params = tf.params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")
    prompt = [3, 7, 11, 15, 19, 23]
    sched = Scheduler(cfg, params, slots=1, max_len=32, page_size=16,
                      device="cpu")
    s = sched.add_request(prompt)
    sched.step()
    cache = dec.init_paged_cache(cfg, 1, 32, 16, device="cpu")
    for t in prompt:
        want, cache = dec.paged_decode_step(params, cache,
                                            torch.tensor([t]), cfg)
    np.testing.assert_allclose(sched.last_logits[s].numpy(), want[0].numpy(),
                               rtol=2e-4, atol=2e-4)
    js = JScheduler(jcfg, jparams, slots=1, max_len=32, page_size=16)
    jslot = js.add_request(prompt)
    js.step()
    np.testing.assert_allclose(sched.last_logits[s].numpy(),
                               np.asarray(js.last_logits[jslot]),
                               rtol=2e-4, atol=2e-4)
    assert sched.tokens[s] == js.tokens[jslot]
