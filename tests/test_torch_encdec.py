"""Port parity for the encoder-decoder (whisper): ``layers.layer_norm``,
the cross-attention pieces of ``models/attention``, ``models/encdec`` whole,
the encoder arms of ``transformer`` / ``decode`` / ``serve.engine``, the
input builders of ``configs/base``, and the refusals of the paged serving
path, against ``repro`` with the reference's weights, on the CPU at
whisper-tiny's smoke config (float32).

Tolerances: rtol = atol = 2e-5 on float32 outputs (XLA and torch sum the
matmuls and the online softmax in different orders); the decode logits,
whose stacks add the cache's softmax and a per-step cross-attention over
every frame, within rtol = atol = 2e-5 as well.  Greedy streams, parameter
trees, counts, shapes, dtypes and refusal messages are exact.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import jax_tree_to_np, to_torch
from repro.configs import base as jbase
from repro.dist.sharding import local_ctx
from repro.models import attention as jattn
from repro.models import decode as jdec
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import jit_decode_step as jjit_decode_step
from repro.serve.engine import jit_prefill as jjit_prefill
from repro_torch.configs import base
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, decode, encdec, layers
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import (BatchedServer, ServeConfig,
                                      jit_decode_step, jit_prefill)
from repro_torch.serve.scheduler import Scheduler

RTOL = ATOL = 2e-5

NAME = "whisper-tiny"
B, S = 2, 12


@functools.lru_cache(maxsize=None)
def _jax():
    cfg = jbase.get_arch(NAME).smoke
    return cfg, jtf.init_params(cfg, jax.random.key(0))


def _port(impl="ref"):
    _, jparams = _jax()
    cfg = dataclasses.replace(base.get_arch(NAME).smoke, kernel_impl=impl)
    return cfg, tf.params_from_jax(jax_tree_to_np(jparams), cfg,
                                   device="cpu")


def _inputs(cfg, frames=None, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    F = cfg.encoder.context if frames is None else frames
    fr = rng.normal(size=(B, F, cfg.d_model)).astype(np.float32)
    return toks, fr


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _tree_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_close(got[k], want[k])
    else:
        _close(got, want)


# ---------------------------------------------------------------------------
# layers and attention pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x, sc, bi = (rng.normal(size=s).astype(np.float32)
                 for s in ((3, 5, 48), (48,), (48,)))
    jx = jnp.asarray(x, dtype)
    want = jlayers.layer_norm(jx, jnp.asarray(sc), jnp.asarray(bi))
    got = layers.layer_norm(to_torch(np.asarray(jx)), torch.from_numpy(sc),
                            torch.from_numpy(bi))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_cross_attention_tree_and_values_match_reference():
    d, H, K, D = 32, 4, 2, 8
    jp = jattn.init_cross_attention(jax.random.key(3), d, H, K, D,
                                    jnp.float32)
    tp = attention.init_cross_attention(d, H, K, D,
                                        torch.Generator().manual_seed(3),
                                        torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 21, d)).astype(np.float32)
    enc = rng.normal(size=(2, 37, d)).astype(np.float32)
    ek, ev = jattn.encoder_kv(jp, jnp.asarray(enc), K, D, policy="ref")
    k, v = attention.encoder_kv(p, torch.from_numpy(enc), K, D,
                                policy="ref")
    _close(k, ek)
    _close(v, ev)
    want = jattn.cross_attention(jp, jnp.asarray(x), ek, ev, H, K, D)
    _close(attention.cross_attention(p, torch.from_numpy(x), k, v, H, K, D),
           want)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_attn_apply_cross_kv_arm_matches_reference(impl):
    """``transformer._attn_apply``'s ``cross_kv`` arm (no init builds its
    ``cross`` / ``ln_cross`` leaves and whisper's decoder runs encdec's own
    layer, so the layer is built here from the reference's inits): causal
    self-attention, then cross-attention over 37 encoder frames."""
    jcfg = jbase.get_arch("qwen3-0.6b").smoke
    cfg = dataclasses.replace(base.get_arch("qwen3-0.6b").smoke,
                              kernel_impl=impl)
    d, H, K, D = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.hd
    ka, kc = jax.random.split(jax.random.key(5))
    rng = np.random.default_rng(5)
    jp = {"ln1": jnp.asarray(rng.normal(size=(d,)).astype(np.float32)),
          "ln_cross": jnp.asarray(rng.normal(size=(d,)).astype(np.float32)),
          "attn": jattn.init_attention(ka, d, H, K, D, qk_norm=jcfg.qk_norm,
                                       dtype=jnp.float32),
          "cross": jattn.init_cross_attention(kc, d, H, K, D, jnp.float32)}
    x = rng.normal(size=(2, 21, d)).astype(np.float32)
    enc = rng.normal(size=(2, 37, d)).astype(np.float32)
    ek, ev = jattn.encoder_kv(jp["cross"], jnp.asarray(enc), K, D,
                              policy="ref")
    pos = jnp.broadcast_to(jnp.arange(21), (2, 21))
    want, _ = jtf._attn_apply(jp, jnp.asarray(x), jcfg, None, 0, pos,
                              "train", cross_kv=(ek, ev))
    p = tf.tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax_tree_to_np(jp))
    with torch.no_grad():
        k, v = attention.encoder_kv(p["cross"], torch.from_numpy(enc), K, D,
                                    policy=impl)
        got, kv = tf._attn_apply(p, torch.from_numpy(x), cfg, None, 0,
                                 torch.from_numpy(np.array(pos)), "train",
                                 cross_kv=(k, v))
    assert kv is None
    _close(got, want)


@pytest.mark.parametrize("sq,sk", [(37, 37), (21, 53), (64, 40)])
def test_bidirectional_ragged_flash_matches_reference(sq, sk):
    """Non-causal flash with Sq != Sk and ragged chunks at chunk 16 (the
    encoder's 1500 frames at chunk 512 are 2 * 512 + 476)."""
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(2, sq, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, 2, 8)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=False, window=None, q_chunk=16, kv_chunk=16)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, want)


@pytest.mark.parametrize("frames", [64, 600])
def test_encode_matches_reference(frames):
    """600 frames: the 512-frame chunk leaves a ragged 88-frame tail.  Its
    softmax sums run over 600 keys in each of the two layers, and the two
    packages' summation orders drift further apart: atol 1e-4 there
    (about 2.5e-5 of the outputs' largest magnitude, 4)."""
    jcfg, jp = _jax()
    cfg, p = _port()
    _, fr = _inputs(cfg, frames)
    want = jed.encode(jp, jnp.asarray(fr), jcfg, None)
    _close(encdec.encode(p, torch.from_numpy(fr), cfg), want,
           atol=ATOL if frames == 64 else 1e-4)


@pytest.mark.parametrize("n,d,atol", [(64, 64, ATOL), (1500, 384, 2.5e-4)])
def test_sinusoid_matches_reference(n, d, atol):
    """At whisper-tiny's 1500 frames the angle ``pos * freq`` reaches 1500
    rad, where one float32 ulp of the angle is 1.2e-4, and XLA's and
    torch's ``exp`` round ``freq`` an ulp apart: two ulps of the largest
    angle (2.5e-4) there."""
    want = jed._sinusoid(jnp.arange(n), d)
    _close(encdec._sinusoid(torch.arange(n), d), want, atol=atol)


# ---------------------------------------------------------------------------
# params, forward, caches
# ---------------------------------------------------------------------------

def test_params_tree_and_count_match_reference():
    jcfg, jp = _jax()
    cfg, p = _port()
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    got = tf.tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).replace("torch.", "")), p)
    assert got == want
    own = tf.init_params(cfg, 0, device="cpu")
    assert tf.tree_map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       own) == want
    assert tf.param_count(own) == tf.param_count(p) == jtf.param_count(jp)
    full = jbase.get_arch(NAME).model
    shapes = jax.eval_shape(lambda: jtf.init_params(full, jax.random.key(0)))
    assert jtf.param_count(shapes) == 36479232
    tf.check_supported(base.get_arch(NAME).model)


@functools.lru_cache(maxsize=None)
def _jax_forward(mode):
    jcfg, jp = _jax()
    toks, fr = _inputs(jcfg)
    out, aux, states = jax.jit(lambda p, b: jtf.forward(
        p, b, jcfg, None, mode=mode))(jp, {"tokens": jnp.asarray(toks),
                                           "audio_frames": jnp.asarray(fr)})
    return np.asarray(out), float(aux), jax_tree_to_np(states)


@pytest.mark.parametrize("mode", ["train", "prefill", "hidden"])
def test_forward_matches_reference(mode):
    cfg, p = _port()
    toks, fr = _inputs(cfg)
    want, want_aux, want_states = _jax_forward(mode)
    got, aux, states = tf.forward(p, {"tokens": torch.from_numpy(toks),
                                      "audio_frames": torch.from_numpy(fr)},
                                  cfg, None, mode=mode)
    assert tuple(got.shape) == want.shape
    _close(got, want)
    assert float(aux) == want_aux == 0.0
    if mode == "prefill":
        assert tuple(states["pos0"].shape) == \
            (cfg.n_superblocks, B, S, cfg.n_kv_heads, 2 * cfg.hd)
        _tree_close(states, want_states)
    else:
        assert states == {} and want_states == {}


def test_forward_under_kernel_policy_on_cpu_matches_ref():
    """On the CPU the kernel policies send the wrappers to their plain
    versions: the forward's B1 / B2 (B6 / B7) calls change nothing."""
    toks, fr = _inputs(_port()[0])
    batch = {"tokens": torch.from_numpy(toks),
             "audio_frames": torch.from_numpy(fr)}
    outs = [tf.forward(p, batch, cfg, mode="prefill")
            for cfg, p in (_port(i) for i in ("ref", "kernel",
                                              "kernel_dynamic"))]
    for logits, _, states in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        assert torch.equal(states["pos0"], outs[0][2]["pos0"])


def test_init_cache_and_precompute_enc_kv_match_reference():
    jcfg, jp = _jax()
    cfg, p = _port()
    want = jed.init_cache(jcfg, B, 16, jnp.float32)
    got = encdec.init_cache(cfg, B, 16, torch.float32, device="cpu")
    assert tf.tree_map(lambda t: (tuple(t.shape), str(t.dtype)), got) == \
        jax.tree.map(lambda a: (tuple(a.shape), "torch." + str(a.dtype)),
                     want)
    _, fr = _inputs(cfg)
    _close(encdec.precompute_enc_kv(p, torch.from_numpy(fr), cfg),
           jed.precompute_enc_kv(jp, jnp.asarray(fr), jcfg, None))


@functools.lru_cache(maxsize=None)
def _jax_decode(max_len, steps):
    """The reference's decode_step from an empty cache over a seeded
    token stream (the ring wraps when steps > max_len)."""
    jcfg, jp = _jax()
    _, fr = _inputs(jcfg)
    cache = jed.init_cache(jcfg, B, max_len, jnp.float32)
    cache["enc_kv"] = jed.precompute_enc_kv(jp, jnp.asarray(fr), jcfg, None)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (steps, B))
    step = jax.jit(lambda p, c, t: jed.decode_step(p, c, t, jcfg, None))
    logits = []
    for t in toks:
        out, cache = step(jp, cache, jnp.asarray(t, jnp.int32))
        logits.append(np.asarray(out))
    return toks, logits, jax_tree_to_np(cache)


@pytest.mark.parametrize("max_len,steps", [(16, 6), (4, 10)])
def test_decode_steps_match_reference(max_len, steps):
    """Six steps into a 16-beat ring; ten into a 4-beat ring (it wraps
    twice, as the reference's ring does at ``pos % Sc``)."""
    cfg, p = _port()
    toks, want, want_cache = _jax_decode(max_len, steps)
    _, fr = _inputs(cfg)
    cache = encdec.init_cache(cfg, B, max_len, torch.float32, device="cpu")
    cache["enc_kv"] = encdec.precompute_enc_kv(p, torch.from_numpy(fr), cfg)
    for t, w in zip(toks, want):
        got, cache = decode.decode_step(
            p, cache, torch.from_numpy(t.astype(np.int32)), cfg)
        _close(got, w)
    assert int(cache["len"]) == int(want_cache["len"]) == steps
    _tree_close(cache["blocks"], want_cache["blocks"])
    _close(cache["enc_kv"], want_cache["enc_kv"])


@functools.lru_cache(maxsize=None)
def _jax_serve(gen):
    """The reference's whisper serving path, as tests/test_smoke_archs.py
    drives it: jit_prefill -> cache_from_prefill -> enc_kv -> greedy
    jit_decode_step."""
    jcfg, jp = _jax()
    toks, fr = _inputs(jcfg)
    batch = {"tokens": jnp.asarray(toks), "audio_frames": jnp.asarray(fr)}
    ctx = local_ctx()
    logits, states = jjit_prefill(jcfg, ctx, jp, batch)(jp, batch)
    cache = jdec.cache_from_prefill(jcfg, states, S, S + gen, jnp.float32)
    cache["enc_kv"] = jed.precompute_enc_kv(jp, batch["audio_frames"], jcfg,
                                            None)
    step = jjit_decode_step(jcfg, ctx, JServeConfig(max_len=S + gen), jp,
                            cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    stream, outs = [np.asarray(tok)], [np.asarray(logits[:, -1])]
    for _ in range(gen):
        out, cache = step(jp, cache, tok)
        tok = jnp.argmax(out, -1).astype(jnp.int32)
        stream.append(np.asarray(tok))
        outs.append(np.asarray(out))
    return np.stack(stream, 1), outs


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_serving_composition_matches_reference(impl):
    """jit_prefill -> decode.cache_from_prefill -> precompute_enc_kv ->
    jit_decode_step: greedy streams exact, logits within tolerance."""
    gen = 6
    cfg, p = _port(impl)
    toks, fr = _inputs(cfg)
    want_stream, want = _jax_serve(gen)
    batch = {"tokens": torch.from_numpy(toks),
             "audio_frames": torch.from_numpy(fr)}
    logits, states = jit_prefill(cfg, None, device="cpu")(p, batch)
    assert sorted(states) == ["enc_out", "pos0"]
    cache = decode.cache_from_prefill(cfg, states, S, S + gen,
                                      torch.float32)
    cache["enc_kv"] = encdec.precompute_enc_kv(p, batch["audio_frames"],
                                               cfg)
    step = jit_decode_step(cfg, None, ServeConfig(max_len=S + gen),
                           device="cpu")
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    stream, outs = [tok], [logits[:, -1]]
    for _ in range(gen):
        out, cache = step(p, cache, tok)
        tok = torch.argmax(out, -1).to(torch.int32)
        stream.append(tok)
        outs.append(out)
    assert torch.stack(stream, 1).numpy().tolist() == want_stream.tolist()
    for g, w in zip(outs, want):
        _close(g, w)
    assert int(cache["len"]) == S + gen


def test_decode_matches_teacher_forced_forward():
    """The reference's smoke gate, on the port alone: the decode step's
    logits after a prefill equal a teacher-forced forward's."""
    cfg, p = _port()
    toks, fr = _inputs(cfg)
    frames = torch.from_numpy(fr)
    logits, _, states = tf.forward(p, {"tokens": torch.from_numpy(toks),
                                       "audio_frames": frames}, cfg,
                                   mode="prefill")
    cache = decode.cache_from_prefill(cfg, states, S, S + 1)
    cache["enc_kv"] = encdec.precompute_enc_kv(p, frames, cfg)
    nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
    step_logits, _ = decode.decode_step(p, cache, nxt, cfg)
    full, _, _ = tf.forward(p, {"tokens": torch.cat(
        [torch.from_numpy(toks), nxt[:, None]], 1), "audio_frames": frames},
        cfg)
    np.testing.assert_allclose(step_logits.numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# input builders
# ---------------------------------------------------------------------------

def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: _sig(v) for k, v in tree._asdict().items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_input_builders_match_reference(name):
    jcfg, cfg = jbase.get_arch(name).smoke, base.get_arch(name).smoke
    for fn, jfn in ((base.train_batch, jbase.train_batch),
                    (base.prefill_batch, jbase.prefill_batch)):
        want = _sig(jfn(jcfg, 32, 2, specs=True))
        assert _sig(fn(cfg, 32, 2, specs=True)) == want
        real = fn(cfg, 32, 2, specs=False, device="cpu")
        assert _sig(real) == want
        assert int(real["tokens"].max()) < cfg.vocab
    jcache, jtok = jbase.decode_inputs(jcfg, 32, 2, specs=True,
                                       cache_dtype=jnp.float32)
    cache, tok = base.decode_inputs(cfg, 32, 2, specs=True,
                                    cache_dtype=torch.float32)
    assert tok.device.type == "meta"
    assert (_sig(cache), _sig(tok)) == (_sig(jcache), _sig(jtok))
    cache, tok = base.decode_inputs(cfg, 32, 2, specs=False,
                                    cache_dtype=torch.float32, device="cpu")
    assert (_sig(cache), _sig(tok)) == (_sig(jcache), _sig(jtok))
    assert int(cache["len"]) == 16


def test_whisper_decode_inputs_drive_a_step():
    """The reference's decode smoke (test_smoke_archs.py) on the port:
    decode_inputs, enc_kv from zero frames, one step."""
    cfg, p = _port()
    cache, token = base.decode_inputs(cfg, 32, B, specs=False,
                                      cache_dtype=torch.float32,
                                      device="cpu")
    cache["enc_kv"] = encdec.precompute_enc_kv(
        p, torch.zeros((B, cfg.encoder.context, cfg.d_model)), cfg)
    logits, cache2 = encdec.decode_step(p, cache, token, cfg)
    assert tuple(logits.shape) == (B, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert int(cache2["len"]) == 17


# ---------------------------------------------------------------------------
# refusals: the paged path serves decoders only, as in the reference
# ---------------------------------------------------------------------------

def _message(fn, *args, **kw):
    with pytest.raises((NotImplementedError, SystemExit)) as e:
        fn(*args, **kw)
    return str(e.value)


def test_paged_serving_refuses_with_reference_messages():
    from repro.serve.engine import BatchedServer as JBatchedServer
    from repro.serve.scheduler import Scheduler as JScheduler
    jcfg, jp = _jax()
    cfg, p = _port()
    want = _message(JScheduler, jcfg, jp, slots=1, max_len=16, page_size=4)
    assert want == "paged serving covers decoder-only models"
    assert _message(Scheduler, cfg, p, slots=1, max_len=16, page_size=4,
                    device="cpu") == want
    assert _message(JBatchedServer, jcfg, jp, slots=1, max_len=16,
                    page_size=4) == want
    assert _message(BatchedServer, cfg, p, slots=1, max_len=16, page_size=4,
                    device="cpu") == want
    step_msg = "paged serving covers decoder-only models; use " \
               "encdec.decode_step"
    for fn, args in ((decode.paged_prefill_chunk,
                      (p, {}, torch.zeros(4, dtype=torch.int32), cfg)),
                     (decode.paged_decode_step,
                      (p, {}, torch.zeros(1, dtype=torch.int32), cfg)),
                     (decode.paged_verify_step,
                      (p, {}, torch.zeros((1, 2), dtype=torch.int32), cfg))):
        kw = ({"slot": 0, "count": 4} if fn is decode.paged_prefill_chunk
              else {"n_draft": [1]} if fn is decode.paged_verify_step
              else {})
        assert _message(fn, *args, **kw) == step_msg
    for fn, args in ((jdec.paged_prefill_chunk,
                      (jp, {}, jnp.zeros(4, jnp.int32), jcfg)),
                     (jdec.paged_decode_step,
                      (jp, {}, jnp.zeros(1, jnp.int32), jcfg))):
        kw = {"slot": 0, "count": 4} if fn is jdec.paged_prefill_chunk \
            else {}
        assert _message(fn, *args, None, **kw) == step_msg


def test_serve_cli_refuses_whisper_with_reference_text(monkeypatch):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", NAME, "--smoke"])
    want = _message(jserve.main)
    assert want == "use whisper example for enc-dec serving"
    assert _message(serve_cli.main, ["--arch", NAME, "--smoke", "--device",
                                     "cpu"]) == want
