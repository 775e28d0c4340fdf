"""Port parity for training on one device: the flash attention backward,
the cross-entropy pieces, AdamW, gradient compression, the train step,
remat, and the refusal to differentiate through the hand-written kernels,
against ``repro`` on numpy-seeded inputs, on the CPU.

Tolerances: gradients and losses within rtol = atol = 2e-5 (XLA and torch
sum in different orders).  Exact: the decay mask, the warm-up arm of the
schedule, AdamW's moments, step and params given the same gradients
(clipping off), the int8 and top-k round trips and their error state, the
top-k masks.  Stated where more is needed:

- the schedule's cosine arm within ``lr * 2**-23`` (one ulp of a cosine
  near 1, scaled by lr): XLA's float32 ``cos`` on the CPU is not
  correctly rounded (one ulp off at 3 of 130 steps here), torch's is, and
  ``min + (1 - min) / 2 * (1 + cos)`` carries that ulp into a result
  near ``min``, a few of whose ulps it is;
- the global grad norm within rtol 1e-6 (a sum over every leaf in a
  different order), so clipped updates within 1e-6 too;
- the 3-step train step with 2 microbatches (compression none and int8):
  loss and grad norm within 1e-5; params within half a learning rate,
  and all but a small share of each leaf (1% without compression, 0.1%
  with int8) within 1e-3 of it.  The two packages' float32 gradients
  differ by a few ulps; where |g| is near AdamW's eps, or sits on an int8
  rounding tie, that gap becomes a fraction of one lr-sized step for that
  element.

The loss and gradients of whole models, the refusal of both packages to
differentiate the kernel policies and one train step under ``ref`` are in
tests/test_torch_train_grads.py.
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
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import step as jstep
from repro_torch import vx
from repro_torch.configs import base
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, compression
from repro_torch.train import state as tstate
from repro_torch.train import step as tstep

RTOL = ATOL = 2e-5


def _np(t):
    return t.detach().numpy()


def _same(got, want):
    """Bit equality of two arrays of any rank (0-dim included)."""
    g = got.detach().reshape(-1) if isinstance(got, torch.Tensor) \
        else np.asarray(got).reshape(-1)
    assert_bits_equal(g, np.asarray(want).reshape(-1))


# ---------------------------------------------------------------------------
# flash attention backward (the reference's _flash_bwd)
# ---------------------------------------------------------------------------

# tests/test_attention.py:30-37:
# (Sq, Sk, H, K, D, causal, window, q_chunk, kv_chunk)
FLASH_CASES = {
    "causal": (64, 64, 4, 2, 16, True, None, 16, 16),
    "mqa": (64, 64, 4, 1, 16, True, None, 32, 16),
    "bidirectional": (64, 64, 4, 4, 16, False, None, 16, 32),
    "window-banded": (128, 128, 2, 2, 8, True, 32, 32, 16),
    "ragged": (48, 48, 4, 2, 16, True, None, 16, 16),
    "ragged-cross": (50, 70, 4, 2, 16, False, None, 16, 16),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_backward_matches_reference_vjp(name):
    Sq, Sk, H, K, D, causal, window, qc, kc = FLASH_CASES[name]
    rng = np.random.default_rng(Sq + Sk + H + K)
    q = rng.normal(size=(2, Sq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sk, K, D)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(2, Sq, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    out, vjp = jax.vjp(lambda *a: jattn.flash_attention(*a, **kw),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got_out = attention.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(_np(got_out), np.asarray(out), rtol=RTOL,
                               atol=ATOL)
    for a, b, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{n}")


def test_flash_backward_of_bf16_inputs_returns_their_dtype():
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(1, 24, 4, 8)), dtype=torch.bfloat16,
                     requires_grad=True)
    kv = torch.tensor(rng.normal(size=(1, 24, 2, 8)), dtype=torch.bfloat16,
                      requires_grad=True)
    out = attention.flash_attention(q, kv, kv, q_chunk=8, kv_chunk=8)
    (dq, dkv) = torch.autograd.grad(out.float().sum(), (q, kv))
    assert dq.dtype == dkv.dtype == torch.bfloat16
    assert bool(torch.isfinite(dq.float()).all())


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

def test_label_logprob_terms_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 53)).astype(np.float32) * 4
    labels = rng.integers(0, 53, (2, 7)).astype(np.int32)
    want = jtf.label_logprob_terms(jnp.asarray(logits), jnp.asarray(labels))
    got = tf.label_logprob_terms(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("S,chunk", [(40, 16), (12, 16), (64, 16),
                                     (16, 16)])
def test_chunked_xent_matches_reference(S, chunk):
    """S % chunk != 0 and S <= chunk fall back to one chunk of S; 64 / 16
    runs four checkpointed chunks."""
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 24)).astype(np.float32)
    head = rng.normal(size=(61, 24)).astype(np.float32) * 0.2
    labels = rng.integers(0, 61, (2, S)).astype(np.int32)
    w = rng.normal(size=(2, S)).astype(np.float32)
    args = (x, head, labels, w)

    def jf(x, head):
        return jtf.chunked_xent(x, head, jnp.asarray(labels),
                                jnp.asarray(w), None, chunk=chunk)

    want, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(head))
    tx, th = (torch.tensor(a, requires_grad=True) for a in args[:2])
    got = tf.chunked_xent(tx, th, torch.from_numpy(labels),
                          torch.from_numpy(w), chunk=chunk)
    tg = torch.autograd.grad(got, (tx, th))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# AdamW (tests/test_optim.py's cases, then against the reference)
# ---------------------------------------------------------------------------

def _small_params(rng):
    return {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "ln": np.ones((16,), np.float32),
            "b": np.zeros((16,), np.float32),
            "blocks": {"pos0": {"mamba": {"D": rng.normal(size=(4,)).astype(
                np.float32), "dt_bias": np.ones((4,), np.float32)}}}}


def test_schedule_matches_reference():
    """The warm-up arm bit for bit; the cosine arm within lr * 2**-23
    (XLA's float32 cos is not correctly rounded).  The reference's own gates
    (tests/test_optim.py:30) hold on the port."""
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for s in range(0, 130):
        want = jadamw.schedule(jcfg, jnp.asarray(s))
        got = adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        if s <= 10:
            _same(got, want)
        assert abs(float(got) - float(want)) <= kw["lr"] * 2.0 ** -23, s
    assert float(adamw.schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(adamw.schedule(cfg, torch.tensor(10))) - 1.0) < 0.11
    assert float(adamw.schedule(cfg, torch.tensor(100))) <= 0.1 + 1e-6
    vals = [float(adamw.schedule(cfg, torch.tensor(s)))
            for s in range(10, 101, 10)]
    assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:]))


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 4.5, 10.0])
def test_clip_global_norm_matches_reference(max_norm):
    g = {"a": np.full((4, 4), 3.0, np.float32),
         "b": np.full((2,), -4.0, np.float32)}
    want, wnorm = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    got, norm = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6)
    new_norm = float(adamw.global_norm(got))
    assert new_norm <= max_norm + 1e-4 or new_norm <= float(norm) + 1e-4


def test_adamw_reduces_quadratic_loss():
    cfg = adamw.AdamWConfig(lr=0.05, warmup_steps=0, total_steps=1000,
                            weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw.init_opt_state(params)
    l0 = float(torch.sum(params["w"] ** 2))
    for _ in range(50):
        params, opt, _ = adamw.apply_updates(params, {"w": 2 * params["w"]},
                                             opt, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 0.1 * l0


def test_weight_decay_skips_norm_params():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=1.0,
                            grad_clip=1e9)
    params = {k: torch.from_numpy(v) for k, v in _small_params(
        np.random.default_rng(0)).items() if k != "blocks"}
    before = {k: v.clone() for k, v in params.items()}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = adamw.apply_updates(params, zeros,
                                    adamw.init_opt_state(params), cfg)
    assert all(new[k] is params[k] for k in params)    # updated in place
    assert torch.equal(new["ln"], before["ln"])
    assert float(new["w"].abs().sum()) < float(before["w"].abs().sum())


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_decay_mask_matches_reference_on_every_arch(name):
    jcfg = jbase.get_arch(name).smoke
    shapes = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
    want = {"/".join(getattr(k, "key", str(k)) for k in kp):
            jadamw._decay_mask("/".join(getattr(k, "key", str(k))
                                        for k in kp))
            for kp, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    params = tf.init_params(base.get_arch(name).smoke, 0, device="cpu")
    got = {}

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            else:
                got[v] = adamw._decay_mask(v)

    walk(adamw._paths(params))
    assert got == want


@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_apply_updates_match_reference(clip):
    """Five steps of AdamW from the same gradients (two in warm-up, three
    on the cosine arm at points where both cosines agree): moments and
    step exact; params exact with clipping off and within 1e-6 with it on
    (the clip scale comes from the norm's sum)."""
    rng = np.random.default_rng(1)
    p0 = _small_params(rng)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32) * 3, p0) for _ in range(5)]
    kw = dict(grad_clip=clip, warmup_steps=2, total_steps=6)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    jo = jadamw.init_opt_state(jp)
    tp = tf.tree_map(lambda a: torch.from_numpy(a.copy()), p0)  # updated
    to = adamw.init_opt_state(tp)                                # in place
    for g in grads:
        jp, jo, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          jo, jcfg)
        tp, to, tm = adamw.apply_updates(tp, tf.tree_map(torch.from_numpy,
                                                         g), to, cfg)
        _same(tm["lr"], jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(to["step"]) == int(jo["step"])
        for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
            flat_g = jax.tree.leaves(tf.tree_map(_np, got))
            flat_w = jax.tree.leaves(jax_tree_to_np(want))
            for a, b in zip(flat_g, flat_w):
                if clip > 1e6:
                    _same(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# compression with error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_matches_reference_bit_for_bit(kind):
    """Five rounds of compress_with_feedback from the same gradients: the
    sent gradients and the error state equal the reference's bit for bit
    (the int8 round trip is core/quant's; the top-k mask keeps |g| at or
    above the k-th largest, ties included)."""
    rng = np.random.default_rng(2)
    g = {"w": rng.normal(size=(64,)).astype(np.float32),
         "b": {"x": np.round(rng.normal(size=(9, 7)) * 4).astype(
             np.float32)}}          # rounded: ties at the top-k threshold
    jc = jcomp.CompressionConfig(kind=kind, topk_frac=0.1)
    tc = compression.CompressionConfig(kind=kind, topk_frac=0.1)
    jerr = jcomp.init_error_state(jax.tree.map(jnp.asarray, g))
    terr = compression.init_error_state(tf.tree_map(torch.from_numpy, g))
    for _ in range(5):
        jsent, jerr, jm = jcomp.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jerr, jc)
        tsent, terr, tm = compression.compress_with_feedback(
            tf.tree_map(torch.from_numpy, g), terr, tc)
        for a, b in ((tsent["w"], jsent["w"]), (tsent["b"]["x"],
                                                jsent["b"]["x"]),
                     (terr["w"], jerr["w"]), (terr["b"]["x"],
                                              jerr["b"]["x"])):
            assert_bits_equal(a, b)
        np.testing.assert_allclose(float(tm["compression_error"]),
                                   float(jm["compression_error"]),
                                   rtol=1e-6)
    assert compression.wire_bytes_ratio(tc) == jcomp.wire_bytes_ratio(jc)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_preserves_signal(kind):
    """tests/test_optim.py:80 on the port: what was not sent is exactly
    the residual, and the residual stays bounded."""
    cfg = compression.CompressionConfig(kind=kind, topk_frac=0.1)
    g = {"w": torch.randn(64, generator=torch.Generator().manual_seed(1))}
    err = compression.init_error_state(g)
    sent_total = torch.zeros(64)
    resids = []
    for _ in range(40):
        sent, err, _ = compression.compress_with_feedback(g, err, cfg)
        sent_total = sent_total + sent["w"]
        resids.append(float(torch.linalg.norm(err["w"])))
    np.testing.assert_allclose(_np(sent_total + err["w"]), _np(40 * g["w"]),
                               rtol=1e-4, atol=1e-4)
    assert resids[-1] < 2.0 * max(resids[:10]) + 1e-6
    assert resids[-1] < 10 * float(torch.linalg.norm(g["w"]))


def test_compression_none_is_identity_and_ratios():
    g = {"w": torch.arange(4.0)}
    sent, _, _ = compression.compress_with_feedback(
        g, compression.init_error_state(g),
        compression.CompressionConfig(kind="none"))
    assert sent["w"] is g["w"]
    for kw in ({"kind": "int8"}, {"kind": "none"},
               {"kind": "topk", "topk_frac": 0.05}):
        assert compression.wire_bytes_ratio(
            compression.CompressionConfig(**kw)) == \
            jcomp.wire_bytes_ratio(jcomp.CompressionConfig(**kw))


def test_compression_int8_roundtrip_delegates_bit_exact():
    """The port of tests/test_quant.py:93: ``_int8_roundtrip`` (through
    core/quant.roundtrip) against the inline formula (scale = max|g|/127,
    round, dequant) across magnitudes, bit for bit, and against the
    reference's ``_int8_roundtrip`` on the same inputs."""
    for i, mag in enumerate([1e-15, 1e-3, 1.0, 1e4]):
        g = (mag * np.random.default_rng(i).normal(size=257)).astype(
            np.float32)
        t = torch.from_numpy(g)
        scale = torch.clamp(torch.max(torch.abs(t)), min=1e-12) / 127.0
        ref = torch.round(torch.clamp(t / scale, -127, 127)).to(
            torch.int8).float() * scale
        got = compression._int8_roundtrip(t)
        assert_bits_equal(got, ref)
        assert_bits_equal(got, jcomp._int8_roundtrip(jnp.asarray(g)))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _train_cfgs(kind, microbatches=2):
    a = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    return (jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**a),
                              microbatches=microbatches,
                              compression=jcomp.CompressionConfig(kind=kind)),
            tstep.TrainConfig(optimizer=adamw.AdamWConfig(**a),
                              microbatches=microbatches,
                              compression=compression.CompressionConfig(
                                  kind=kind)))


@functools.lru_cache(maxsize=None)
def _jax_train(kind, steps):
    """tests/test_optim.py:113's train step: qwen3 smoke, 2 microbatches
    of a (4, 32) batch."""
    jcfg = jbase.get_arch("qwen3-0.6b").smoke
    jt, _ = _train_cfgs(kind)
    state = jstep.init_full_state(jcfg, jt, jax.random.key(0))
    batch = jbase.train_batch(jcfg, 32, 4, specs=False)
    fn = jax.jit(jstep.make_train_step(jcfg, jt, None))
    init = jax_tree_to_np(state)
    out = []
    for _ in range(steps):
        state, m = fn(state, batch)
        out.append((jax_tree_to_np(state), {k: float(v)
                                            for k, v in m.items()}))
    return init, jax_tree_to_np(batch), out


# the share of each leaf's elements allowed beyond TIGHT * lr of the
# reference's params, per compression kind (observed at most 0.0039 and
# 0.00025 over the three steps; a wrong decay on one leaf or a wrong bias
# correction after step 1 moves 0.77-1.0 of a leaf)
TIGHT, BEYOND = 1e-3, {"none": 0.01, "int8": 0.001}


@pytest.mark.parametrize("kind", ["int8", "none"])
def test_train_step_matches_reference(kind):
    """Three steps of the reference's train step (tests/test_optim.py:113).
    Loss and grad norm within 1e-5; lr and step exact.  Params: every
    element within 0.5 lr, and all but a small share of each leaf within
    1e-3 lr.  Both kinds need the loose bound for a few elements: where
    |g| is near AdamW's eps (1e-8), g / (|g| + eps) turns a gradient gap
    of a few float32 ulps of the largest gradient (the losses' sums run
    in different orders) into a fraction of lr (0.31 lr without
    compression); int8 snaps most such gradients to one level, so its
    share is ten times smaller."""
    init, batch, want = _jax_train(kind, 3)
    cfg = base.get_arch("qwen3-0.6b").smoke
    _, tt = _train_cfgs(kind)
    params = tf.params_from_jax(init["params"], cfg, device="cpu")
    state = tstate.init_train_state(params)
    if kind != "none":
        state["grad_error"] = compression.init_error_state(params)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    step = tstep.jit_train_step(cfg, tt, None, state, tb)
    lr = tt.optimizer.lr
    for wstate, wm in want:
        state, m = step(state, tb)
        assert sorted(m) == sorted(wm)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), wm[k], rtol=1e-5)
        _same(m["lr"], np.float32(wm["lr"]))
        assert int(state["opt"]["step"]) == int(wstate["opt"]["step"])
        for a, b in zip(jax.tree.leaves(tf.tree_map(_np, state["params"])),
                        jax.tree.leaves(wstate["params"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=0.5 * lr)
            assert np.mean(np.abs(a - b) > TIGHT * lr) <= BEYOND[kind]
        if kind != "none":
            np.testing.assert_allclose(float(m["compression_error"]),
                                       wm["compression_error"], rtol=1e-4)
    # the reference's own gates (tests/test_optim.py:113)
    assert np.isfinite(want[0][1]["loss"]) and np.isfinite(float(m["loss"]))
    assert int(state["opt"]["step"]) == 3


def test_split_microbatches_matches_reference():
    b = {"tokens": np.arange(24, dtype=np.int32).reshape(4, 6),
         "w": np.ones((4, 6), np.float32)}
    want = jstep._split_microbatches(jax.tree.map(jnp.asarray, b), 2)
    got = tstep._split_microbatches({k: torch.from_numpy(v)
                                     for k, v in b.items()}, 2)
    for k in b:
        assert_bits_equal(got[k], want[k])


def test_state_placement_is_none_without_a_mesh():
    cfg = base.get_arch("qwen3-0.6b").smoke
    tt = tstep.TrainConfig(compression=compression.CompressionConfig(
        kind="int8"))
    state = tstep.init_full_state(cfg, tt, 0, device="cpu")
    assert sorted(state) == ["grad_error", "opt", "params"]
    assert tstate.state_shardings(state, None) is None
    assert tstate.train_state_specs(state, None) is None
    assert tstep.full_state_shardings(state, None, tt) is None
    assert tstep.batch_shardings({}, None) is None

    class Ctx:
        mesh = object()
    for fn in (lambda: tstate.state_shardings(state, Ctx()),
               lambda: tstep.full_state_shardings(state, Ctx(), tt),
               lambda: tstep.make_train_step(cfg, tt, Ctx())):
        with pytest.raises(NotImplementedError, match="9h"):
            fn()


# ---------------------------------------------------------------------------
# remat, and the refusal under the kernel policies
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _grads_remat(name, remat):
    cfg = dataclasses.replace(base.get_arch(name).smoke, remat=remat)
    params = tf.init_params(cfg, 0, device="cpu")
    batch = base.train_batch(cfg, 24, 2, specs=False, device="cpu")
    loss, _, grads = tstep._loss_and_grads(params, batch, cfg, None)
    return loss, jax.tree.leaves(tf.tree_map(_np, grads))


@pytest.mark.parametrize("name,remat", [("qwen3-0.6b", "full"),
                                        ("qwen3-0.6b", "dots"),
                                        ("gemma3-12b", "full"),
                                        ("whisper-tiny", "full")])
def test_remat_gives_the_same_gradients(name, remat):
    """Checkpointed superblocks, positions (gemma3's six), whisper's
    decoder layers and the xent chunks recompute the same ops: the
    gradients equal remat-off's bit for bit ("dots" recomputes as
    "full" does)."""
    loss, grads = _grads_remat(name, remat)
    want_loss, want = _grads_remat(name, "none")
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        assert_bits_equal(a, b)


def _seg():
    return vx.Segment(n=16, fields=2)


def _strided(stride, offset=0):
    return vx.Strided(n=16, stride=stride, vl=8, offset=offset)


def _routing():
    return {"shift": torch.zeros(16, dtype=torch.int32),
            "valid": torch.ones(16, dtype=torch.bool)}


# every vx verb with a kernel branch (True) and the ones that run torch ops
# under every policy (False), each on an operand that requires grad
VERB_CASES = {
    "seg.deint": (True, lambda x, p: vx.transpose(_seg(), x, policy=p)),
    "seg.int": (True, lambda x, p: vx.transpose(
        _seg(), [x[..., :8], x[..., 8:]], policy=p)),
    "gather.plan": (True, lambda x, p: vx.gather(_strided(2), x, policy=p)),
    "gather.plan-bank": (False, lambda x, p: vx.gather(
        _strided(-2, 15), x, policy=p)),
    "gather.plan-fused": (True, lambda x, p: vx.gather_many(
        [_strided(2), _strided(1, 3)], [x, x], policy=p)),
    "gather.plan-shared": (True, lambda x, p: vx.gather_many(
        [_strided(2), _strided(2)], [x, x], policy=p)),
    "scatter.plan": (True, lambda x, p: vx.scatter(
        _strided(2), x, x[..., :8], policy=p)),
    "idx.gather": (True, lambda x, p: vx.gather(
        vx.Indexed(n=16), x, **_routing(), policy=p)),
    "idx.gather-routing": (False, lambda x, p: vx.gather(
        vx.Indexed(n=16), x, shift=np.zeros(16, np.int32),
        valid=np.ones(16, bool), policy=p)),
    "idx.scatter": (True, lambda x, p: vx.scatter(
        vx.Indexed(n=16), None, x, **_routing(), policy=p)),
    "compact.rows": (True, lambda x, p: vx.compact(
        vx.Compact(n=2), torch.tensor([False, True]), x, policy=p)),
    "compact.expand": (True, lambda x, p: vx.scatter(
        vx.Compact(n=2), torch.tensor([False, True]), x, policy=p)),
}


def _first(out):
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


@pytest.mark.parametrize("impl", ["kernel", "kernel_dynamic"])
@pytest.mark.parametrize("verb", sorted(VERB_CASES))
def test_each_kernel_branch_refuses_grad(verb, impl):
    """A builder's kernel branch refuses an operand that requires grad
    (gradients on), runs under no_grad, and the same verb under ``ref``
    passes the gradient on; a branch of torch ops under every policy
    passes it on under the kernel policies too."""
    kernel, call = VERB_CASES[verb]
    x = torch.randn((2, 16), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    if kernel:
        with pytest.raises(RuntimeError, match="no backward"):
            call(x, impl)
        with torch.no_grad():
            assert not _first(call(x, impl)).requires_grad
        assert _first(call(x, "ref")).requires_grad
    else:
        assert _first(call(x, impl)).requires_grad
