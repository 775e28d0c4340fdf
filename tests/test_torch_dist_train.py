"""The reference's distributed TRAINING checks (``tests/_dist_checks.py``:
``check_sharded_train_step``, ``check_pipeline_equivalence``,
``check_elastic_reshard``), the mesh forward and batch-sharded serve
paths that reuse them, and tensor parallelism over the model axis
(``tp_losses``), held against the port run as 8 ``gloo`` ranks on the
CPU.

The reference side runs here, in this process, on one device (its
one-device ``loss_fn``, ``jax.grad``, ``jit_train_step``, ``forward``,
``jit_prefill`` / ``jit_decode_step`` and ``BatchedServer``): the
function every mesh program must compute.  The port side runs in
``tests/_torch_dist_run.py`` (no JAX): ONE spawn of 8 ranks for every
check, inputs and outputs through ``.npz`` files.  Weights are the
reference's ``init_params`` (key 0, qwen3-0.6b smoke), batches its
seeded ``train_batch``; training runs under the ``ref`` policy in both
packages (no kernel is differentiated).

Tolerances.  Float32 results of a mesh program and the one-device
program differ by the order of their sums (the data blocks' partial sums
added by a ``psum``, the weights' gradients summed over ranks): the
forward and the loss are held at rtol 1e-5, the gradients at rtol 1e-5
and atol 1e-5 of their largest entry (an entry summed over 256 tokens in
another order lands a few ulps of the largest entry away).  AdamW's first steps move a weight by
about ``lr * sign(g)``, so a gradient entry near 0 whose sign the
summation order flips moves it by up to ``2 lr``: params after two steps
are held within ``2 lr`` everywhere and within ``1e-3 lr`` for all but
0.1% of the entries; the moments within rtol 1e-4 (atol 1e-5 of their
largest entry).  Compression rounds: int8 error feedback rounds ``g + e``
to a grid of ``max|g + e| / 127``, top-k keeps the entries at or above a
threshold, and an entry on a rounding boundary or at the threshold may
land a grid step apart (or be kept on one side only): under compression
the int8 error state is held within one grid step, and within 1% of one
for all but 0.5% of its entries (at least one), the top-k error state
and the moments within rtol 1e-4 likewise.  The pipeline's loss is held at
the reference's rtol 2e-3, its gradients at rtol 1e-4 of the one-device
gradients (atol 1e-5 of their largest entry).
"""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_run import (CUT, FAMILIES, LONG_GEN, NORMS, PREFILL_LEN,
                             TP_CASES, XLSTM64_MESHES, XLSTM64_MUTANTS)
from repro.models import attention as jattn

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CHECKS = ("mesh_forward", "sharded_train_step", "elastic_reshard",
          "pipeline_equivalence", "batch_sharded_serve", "family_losses",
          "encdec_mesh_decode", "tp_losses")
IMPLS = ("ref", "kernel")
LR = 3e-4                      # AdamWConfig's default
MAX_LEN, GEN = 512, 5     # a rank's cache block clears MIN_FUSED_ELEMS
ENC_MAX_LEN, ENC_GEN = 16, 4   # whisper's ring and greedy steps
MOE = "qwen3-moe-30b-a3b"


# ---------------------------------------------------------------------------
# The reference side
# ---------------------------------------------------------------------------

def _flat(tree, prefix: str) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + "/" + "/".join(str(getattr(k, "key", getattr(
        k, "idx", k))) for k in kp): np.asarray(v) for kp, v in flat}


@functools.lru_cache(maxsize=None)
def _model():
    from repro.configs import get_arch
    from repro.models.transformer import init_params
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke,
                              kernel_impl="ref")
    return cfg, init_params(cfg, jax.random.key(0))


def _inputs(batch) -> dict:
    _, params = _model()
    return {**_flat(params, "params"), **_flat(batch, "batch")}


@functools.lru_cache(maxsize=None)
def _forward():
    from repro.configs.base import train_batch
    from repro.models import transformer as jtf
    cfg, params = _model()
    batch = train_batch(cfg, 64, 4, specs=False)
    want = {}
    for mode in ("train", "hidden", "prefill"):
        y, _, states = jax.jit(lambda p, b, m=mode: jtf.forward(
            p, b, cfg, None, mode=m))(params, batch)
        want[f"{mode}/y"] = np.asarray(y)
        if mode == "prefill":
            want.update(_flat(states, "prefill/states"))
    want["loss"] = float(jax.jit(lambda p, b: jtf.loss_fn(
        p, b, cfg, None)[0])(params, batch))
    x = jnp.asarray(want["hidden/y"])
    want["xent"] = float(jtf.chunked_xent(
        x, params["embed"], batch["labels"], batch["loss_weight"], None,
        chunk=16))
    return _inputs(batch), want


@functools.lru_cache(maxsize=None)
def _train():
    from repro.configs.base import train_batch
    from repro.dist.sharding import local_ctx
    from repro.models.transformer import loss_fn
    from repro.train.state import init_train_state
    from repro.train.step import TrainConfig, jit_train_step
    cfg, params = _model()
    batch = train_batch(cfg, 64, 4, specs=False)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg, None)[0]))(params, batch)
    state = init_train_state(jax.tree.map(jnp.copy, params))
    step = jit_train_step(cfg, TrainConfig(), local_ctx(), state, batch)
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    want = {"loss": float(loss), "metrics": metrics,
            **_flat(grads, "grads"),
            **_flat(state["params"], "state/params"),
            **_flat(state["opt"]["m"], "state/m"),
            **_flat(state["opt"]["v"], "state/v")}
    return _inputs(batch), want


@functools.lru_cache(maxsize=None)
def _pipeline():
    from repro.configs.base import train_batch
    from repro.models.transformer import loss_fn
    cfg, params = _model()
    batch = train_batch(cfg, 32, 4, specs=False)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg, None)[0]))(params, batch)
    return _inputs(batch), {"loss": float(loss), **_flat(grads, "grads")}


@functools.lru_cache(maxsize=None)
def _tree():
    """The reference check's tree."""
    return {"blocks": {"pos0": {"attn": {
        "wq": jax.random.normal(jax.random.key(0), (4, 64, 64))}}},
        "embed": jax.random.normal(jax.random.key(1), (128, 64))}


def _elastic(tmp):
    from repro.ft.checkpoint import CheckpointManager
    tree = _tree()
    ref_dir, port_dir = tmp / "ref_ckpt", tmp / "port_ckpt"
    CheckpointManager(str(ref_dir)).save(1, tree, blocking=True)
    return {**_flat(tree, "tree"), "ref_dir": np.asarray(str(ref_dir)),
            "port_dir": np.asarray(str(port_dir))}


@functools.lru_cache(maxsize=None)
def _serve():
    from repro.dist.sharding import local_ctx
    from repro.models import decode as jdec
    from repro.serve import engine as jengine
    cfg, params = _model()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (4, 6)).astype(np.int32)
    ctx = local_ctx()
    logits, states = jengine.jit_prefill(cfg, ctx, params, None)(
        params, {"tokens": jnp.asarray(tokens)})
    cache = jdec.cache_from_prefill(cfg, states, 8, MAX_LEN, jnp.float32)
    step = jengine.jit_decode_step(
        cfg, ctx, jengine.ServeConfig(max_len=MAX_LEN), params, cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    steps = []
    for _ in range(GEN):
        lg, cache = step(params, cache, tok)
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    srv = jengine.BatchedServer(cfg, params, slots=4, max_len=MAX_LEN)
    reqs = [srv.submit(p.tolist(), max_new_tokens=GEN) for p in prompts]
    for _ in range(200):
        srv.tick()
        if srv.scheduler.drained():
            break
    inp = {**_flat(params, "params"), "tokens": tokens, "prompts": prompts,
           "gen": np.asarray(GEN), "max_len": np.asarray(MAX_LEN)}
    return inp, {"prefill": np.asarray(logits), "steps": np.stack(steps),
                 "streams": [list(r.tokens) for r in reqs]}


@functools.lru_cache(maxsize=None)
def _family(arch):
    """The reference's smoke weights (key 0) and seeded batch for a family
    of the mesh-loss check."""
    from repro.configs import get_arch
    from repro.configs.base import train_batch
    from repro.models.transformer import init_params
    cfg = dataclasses.replace(get_arch(arch).smoke, kernel_impl="ref")
    return cfg, init_params(cfg, jax.random.key(0)), train_batch(
        cfg, 16, 4, specs=False)


def _expert_parallel_oracle(data: int, model: int):
    """The reference's ``moe_layer`` as its expert-parallel program on a
    (``data``, ``model``) mesh computes it, on one device: each data
    block of the batch routed alone, each model shard's experts through
    the reference's own ``moe_ffn_local`` (its shard index standing in for
    ``axis_index``, its capacity its own), the shards' outputs summed and
    the blocks' aux estimates averaged (the ``pmean`` over the data
    axis).  With ``(1, 1)`` it is the one-device layer."""
    from unittest import mock
    from repro.models.moe import moe_ffn_local

    def moe_layer(p, x, spec, ctx):
        B, S, d = x.shape
        e = spec.n_experts // model
        ys, auxs = [], []
        for xl in x.reshape(data, B // data * S, d):
            y = 0
            for j in range(model):
                with mock.patch.object(jax.lax, "axis_index",
                                       lambda _, j=j: j):
                    yj, aux = moe_ffn_local(
                        p["router"], *(p[k][j * e:(j + 1) * e]
                                       for k in ("wg", "wu", "wo")),
                        xl, spec, model_axis="model", data_axes=(),
                        n_shards=model)
                y = y + yj
            ys.append(y)
            auxs.append(aux)
        return jnp.stack(ys).reshape(B, S, d), sum(auxs) / data

    return moe_layer


@functools.lru_cache(maxsize=None)
def _family_want(arch, mesh=(2, 4)):
    """The reference's one-device loss, aux and ``jax.value_and_grad`` of
    ``loss_fn`` on :func:`_family`'s inputs; for MoE with its layer the
    ``mesh``'s expert-parallel function (:func:`_expert_parallel_oracle`),
    which the mesh loss must compute."""
    from unittest import mock
    from repro.models import transformer as jtf
    cfg, params, batch = _family(arch)
    patch = (mock.patch.object(jtf, "moe_layer",
                               _expert_parallel_oracle(*mesh))
             if any(cfg.moe_pattern) else contextlib.nullcontext())
    with patch:
        (loss, m), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jtf.loss_fn(p, b, cfg, None), has_aux=True))(
                params, batch)
    return {"loss": float(m["loss"]), "aux": float(m["aux"]),
            **_flat(grads, "grads")}


@functools.lru_cache(maxsize=None)
def _long_want(arch):
    """The reference's one-device ``jit_decode_step``: ``LONG_GEN``
    greedy steps of :func:`_family`'s weights from an empty float32 cache
    of one row, from the first token of its batch's first row."""
    from repro.dist.sharding import local_ctx
    from repro.models import decode as jdec
    from repro.serve import engine as jengine
    cfg, params, batch = _family(arch)
    cache = jdec.init_cache(cfg, 1, 16, jnp.float32)
    step = jengine.jit_decode_step(cfg, local_ctx(),
                                   jengine.ServeConfig(max_len=16), params,
                                   cache)
    tok = jnp.asarray(np.asarray(batch["tokens"])[:1, 0])
    logits, toks = [], []
    for _ in range(LONG_GEN):
        lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(logits), np.stack(toks)


@functools.lru_cache(maxsize=None)
def _encdec():
    """whisper-tiny-smoke (the reference's weights, key 0): ``enc_kv``
    precomputed from seeded frames, then the reference's one-device
    ``jit_decode_step`` (``encdec.decode_step``) for ``ENC_GEN`` greedy
    steps from seeded tokens, on the batch of 4 and on its first row
    alone (the long-context cell's B 1)."""
    from repro.configs import get_arch
    from repro.dist.sharding import local_ctx
    from repro.models import encdec as jenc
    from repro.models.transformer import init_params
    from repro.serve import engine as jengine
    cfg = dataclasses.replace(get_arch("whisper-tiny").smoke,
                              kernel_impl="ref")
    params = init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((4, cfg.encoder.context, cfg.d_model)
                                 ).astype(np.float32)
    tok0 = rng.integers(0, cfg.vocab, (4,)).astype(np.int32)
    enc_kv = np.asarray(jenc.precompute_enc_kv(params, jnp.asarray(frames),
                                               cfg, None))
    want = {}
    for tag, rows in (("batch", slice(0, 4)), ("long", slice(0, 1))):
        cache = jenc.init_cache(cfg, rows.stop, ENC_MAX_LEN, jnp.float32)
        cache["enc_kv"] = jnp.asarray(enc_kv[:, rows])   # donated
        step = jengine.jit_decode_step(
            cfg, local_ctx(), jengine.ServeConfig(max_len=ENC_MAX_LEN),
            params, cache)
        tok, logits, toks = jnp.asarray(tok0[rows]), [], []
        for _ in range(ENC_GEN):
            lg, cache = step(params, cache, tok)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        want[f"{tag}/logits"] = np.stack(logits)
        want[f"{tag}/tokens"] = np.stack(toks)
    inp = {**_flat(params, "params"), "enc_kv": enc_kv,
           "tokens": tok0, "gen": np.asarray(ENC_GEN),
           "max_len": np.asarray(ENC_MAX_LEN)}
    return inp, want


# ---------------------------------------------------------------------------
# The port side: one spawn of 8 ranks for every check
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    inp = {}
    for name, i in (("mesh_forward", _forward()[0]),
                    ("sharded_train_step", _train()[0]),
                    ("elastic_reshard", _elastic(d)),
                    ("pipeline_equivalence", _pipeline()[0]),
                    ("batch_sharded_serve", _serve()[0]),
                    ("family_losses", {
                        k: v for arch in FAMILIES for k, v in {
                            **_flat(_family(arch)[1], f"{arch}/params"),
                            **_flat(_family(arch)[2], f"{arch}/batch"),
                        }.items()}),
                    ("encdec_mesh_decode", _encdec()[0]),
                    ("tp_losses", {
                        **{f"qwen3-0.6b/{k}": v
                           for k, v in _train()[0].items()},
                        **{k: v for arch in (MOE, "starcoder2-3b",
                                             *FAMILIES[:3])
                           for k, v in {
                               **_flat(_family(arch)[1], f"{arch}/params"),
                               **_flat(_family(arch)[2], f"{arch}/batch"),
                           }.items()}})):
        inp.update({f"{name}/{k}": v for k, v in i.items()})
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_dist_run.py"),
         ",".join(CHECKS), str(d / "in.npz"), str(d / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-6000:]
    with np.load(d / "out.npz") as f:
        return dict(f), d


def _out(port, check: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in port[0].items()
            if k.startswith(check + "/")}


def _close(got, want, rtol=1e-5, rel_atol=1e-6, err_msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rel_atol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# The mesh forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("train", "hidden", "prefill"))
def test_mesh_forward_matches_reference(port, mode):
    """Each rank's batch block through the gathered weights: the outputs
    placed on the batch over the data axes, whole equal to the
    reference's one-device forward; the prefill's cache states too."""
    got = _out(port, "mesh_forward")
    _, want = _forward()
    _close(got[f"{mode}/y"], want[f"{mode}/y"], err_msg=mode)
    assert str(got[f"{mode}/spec"]).startswith("P('data'")
    if mode == "prefill":
        keys = [k for k in want if k.startswith("prefill/states/")]
        assert keys
        for k in keys:
            _close(got[k], want[k], err_msg=k)
    if mode == "train":
        # a batch placed on its batch dim gives the same logits
        np.testing.assert_array_equal(got["train/placed_batch_y"],
                                      got["train/y"])


def test_mesh_loss_is_global(port):
    """``loss_fn`` and ``chunked_xent`` under the mesh: the whole batch's
    ``psum(num) / max(psum(den), 1)`` (the seeded ``loss_weight`` differs
    per block, so a mean of the blocks' losses would differ), equal to
    the reference's one-device loss."""
    got = _out(port, "mesh_forward")
    _, want = _forward()
    _close(got["loss"], want["loss"])
    _close(got["xent"], want["xent"])
    w = _train()[0]["batch/loss_weight"]
    assert len({round(float(b.sum()), 3) for b in np.split(w, 2)}) == 2


def test_flash_attention_on_placed_operands(port):
    """``flash_attention`` with a mesh on ``DTensor`` s placed on their
    batch: each rank attends its block, the output placed alike, equal
    to the reference's one-device attention."""
    got = _out(port, "mesh_forward")
    q, k, v = (jnp.asarray(got[f"flash/in/{n}"]) for n in "qkv")
    want = np.asarray(jattn.flash_attention(q, k, v, q_chunk=8, kv_chunk=8))
    assert str(got["flash/spec"]).startswith("P('data'")
    np.testing.assert_array_equal(got["flash"], got["flash/whole"])
    _close(got["flash"], want)


# ---------------------------------------------------------------------------
# The sharded train step (ZeRO-1)
# ---------------------------------------------------------------------------

def test_sharded_gradients_match_one_device(port):
    """The gradients reaching each rank's DTensor blocks, summed over the
    data axes, equal the reference's one-device ``jax.grad``: no
    model-axis replica is counted twice (a double count would be 4x here)
    and the loss is the global one; a rank holds its block's gradient."""
    got = _out(port, "sharded_train_step")
    _, want = _train()
    _close(got["f32/loss"], want["loss"])
    keys = [k for k in want if k.startswith("grads/")]
    assert keys
    for k in keys:
        _close(got["f32/" + k], want[k], rel_atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["f32/wq_grad_local"], [2, 128, 32])


def test_fsdp_gradients_match_one_device(port):
    """Weights split over the data axis too (``make_ctx(fsdp=True)``):
    the gather's transpose sums the data blocks' shares before it takes
    the rank's slice; the gradients, whole, equal the reference's
    one-device ``jax.grad``."""
    got = _out(port, "sharded_train_step")
    _, want = _train()
    assert str(got["fsdp/wq_spec"]) == "P(None, 'data', 'model')"
    _close(got["fsdp/loss"], want["loss"])
    for k in [k for k in want if k.startswith("grads/")]:
        _close(got["fsdp/" + k], want[k], rel_atol=1e-5, err_msg=k)


def test_sharded_train_step_float32_matches_reference(port):
    """Two float32 ZeRO-1 steps on (2, 4): the loss and the global norm
    of each step, then the params and moments, against the reference's
    one-device ``jit_train_step``."""
    got = _out(port, "sharded_train_step")
    _, want = _train()
    for i, m in enumerate(want["metrics"]):
        _close(got[f"f32/step{i}/loss"], m["loss"])
        _close(got[f"f32/step{i}/grad_norm"], m["grad_norm"])
        np.testing.assert_allclose(float(got[f"f32/step{i}/lr"]), m["lr"],
                                   rtol=1e-7)
    for k in [k for k in want if k.startswith("state/params/")]:
        gap = np.abs(got["f32/" + k] - want[k])
        assert gap.max() <= 2 * LR, (k, gap.max())
        assert np.mean(gap > 1e-3 * LR) <= 1e-3, (k, np.mean(gap > 1e-3 * LR))
    for k in [k for k in want if k.startswith(("state/m/", "state/v/"))]:
        _close(got["f32/" + k], want[k], rtol=1e-4, rel_atol=1e-5,
               err_msg=k)


def test_sharded_train_state_placement(port):
    """Params placed by the parameter rules (``wq`` a DTensor, a rank
    holding 1/4 of it on the model axis), the moments ZeRO-1 (also split
    over the data axis): a rank holds 1/4 of the params and 1/8 of the
    sharded moments."""
    got = _out(port, "sharded_train_step")
    is_d, *shapes = got["f32/wq"]
    assert bool(is_d) and shapes == [2, 128, 32, 2, 128, 128]
    assert str(got["f32/m_spec"]) == "P(None, 'data', 'model')"
    np.testing.assert_array_equal(got["f32/m_local"], [2, 64, 32])
    whole, mine, m_mine = got["f32/bytes"]
    assert whole / 4 <= mine < whole / 2, (whole, mine)
    assert m_mine < mine


def test_sharded_train_step_bf16_reference_gates(port):
    """The reference check's own assertions on its bf16 arm: finite
    losses, the second below the first + 0.5, ``wq`` distributed."""
    got = _out(port, "sharded_train_step")
    m1, m2 = got["bf16/losses"]
    assert np.isfinite(m1) and np.isfinite(m2)
    assert m2 < m1 + 0.5
    is_d, *shapes = got["bf16/wq"]
    assert bool(is_d) and shapes[:3] == [2, 128, 32] and \
        4 * shapes[2] == shapes[5]


@pytest.mark.parametrize("kind", ("int8", "topk"))
def test_sharded_compression_microbatches_match_one_process(port, kind):
    """Error-feedback compression (int8, top-k) and 2 microbatches: the
    mesh step against the one-process port on the same state and batch,
    two steps."""
    got = _out(port, "sharded_train_step")
    for i in range(2):
        for k in ("loss", "grad_norm", "compression_error"):
            _close(got[f"{kind}/mesh/step{i}/{k}"],
                   got[f"{kind}/one/step{i}/{k}"], rtol=1e-4,
                   err_msg=f"{i} {k}")
    keys = [k.split("/", 3)[3] for k in got
            if k.startswith(f"{kind}/one/state/")]
    assert keys
    for k in keys:
        a, b = got[f"{kind}/mesh/state/{k}"], got[f"{kind}/one/state/{k}"]
        if k.startswith("params/"):
            gap = np.abs(a - b)
            assert gap.max() <= 2 * LR, (k, gap.max())
            assert np.mean(gap > 1e-3 * LR) <= 1e-3, k
        elif k.startswith("err/") and kind == "int8":
            # |e| <= step / 2: twice the largest error bounds a step; off
            # a rounding boundary the gap is the gradients' float noise
            step = 2 * max(np.abs(a).max(), np.abs(b).max(), 1e-30)
            gap = np.abs(a - b)
            assert gap.max() <= step * (1 + 1e-3), (k, gap.max(), step)
            assert np.sum(gap > 1e-2 * step) <= max(1, 5e-3 * gap.size), k
        else:
            far = ~np.isclose(a, b, rtol=1e-4,
                              atol=1e-5 * max(np.abs(b).max(), 1e-30))
            assert np.sum(far) <= max(1, 5e-3 * far.size), (k, far.sum())


# ---------------------------------------------------------------------------
# Elastic restore and GPipe
# ---------------------------------------------------------------------------

def test_elastic_reshard(port):
    """Saved from (2, 4) (the logical arrays, written once), restored onto
    (4, 2) bit for bit, ``wq`` then on a model axis of 2; a
    reference-written checkpoint restores into a sharded port
    template, bit for bit."""
    got = _out(port, "elastic_reshard")
    for k, v in _flat(_tree(), "tree").items():
        np.testing.assert_array_equal(got["restored/" + k.split("/", 1)[1]],
                                      v, err_msg=k)
        np.testing.assert_array_equal(got["from_ref/" + k.split("/", 1)[1]],
                                      v, err_msg=k)
    np.testing.assert_array_equal(got["wq"], [2, 4, 64, 32])
    assert str(got["wq_spec"]) == "P(None, None, 'model')"
    assert str(got["extra"]) == "(2, 4)" and bool(got["from_ref_placed"])
    assert sorted(os.listdir(port[1] / "port_ckpt")) == ["step_00000001"]


def test_pipeline_equivalence(port):
    """GPipe over the pod axis of (2, 2, 2), two microbatches: the loss
    within the reference's rtol 2e-3 of its one-device ``loss_fn``; the
    gradients (through the differentiable hand-offs) finite and nonzero
    on every stage, and, added over the stages, the one-device
    gradients."""
    got = _out(port, "pipeline_equivalence")
    _, want = _pipeline()
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=2e-3)
    keys = [k for k in want if k.startswith("grads/")]
    total = sum(float(np.abs(got["stage_" + k]).sum()) for k in keys)
    assert np.isfinite(total) and total > 0
    for k in keys:
        assert np.isfinite(got[k]).all(), k
        _close(got[k], want[k], rtol=1e-4, rel_atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The batch-sharded serve paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", ("2x4", "4x2"))
def test_batch_sharded_serve(port, impl, mesh):
    """``jit_prefill`` under the mesh, then greedy batch-sharded
    ``jit_decode_step`` s (KV sequence over the model axis on (2, 4), KV
    heads on (4, 2)) against the reference's one-device calls; streams
    equal.  Under ``kernel`` each rank's step makes one call of B1
    (the fused split of its block, the CPU taking its plain route) and no
    other kernel call; none under ``ref``.  ``BatchedServer`` with the
    mesh streams as the reference's."""
    got = _out(port, "batch_sharded_serve")
    _, want = _serve()
    tag = f"{impl}/{mesh}"
    _close(got[f"{tag}/prefill"], want["prefill"])
    _close(got[f"{tag}/steps"], want["steps"])
    np.testing.assert_array_equal(got[f"{tag}/steps"].argmax(-1),
                                  want["steps"].argmax(-1))
    spec = str(got[f"{tag}/kv_spec"])
    assert spec == ("P(None, 'data', 'model', None, None)" if mesh == "2x4"
                    else "P(None, 'data', None, 'model', None)"), spec
    calls = got[f"{tag}/calls"].reshape(8, GEN, 2)
    assert (calls == ((1, 1) if impl == "kernel" else (0, 0))).all(), calls
    streams = got[f"{tag}/streams"]
    flat = [t for s in want["streams"] for t in s]
    for row in streams:
        assert row.tolist() == flat


# ---------------------------------------------------------------------------
# The other families under the mesh loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_mesh_loss_matches_one_process(port, arch):
    """The encoder-decoder and the recurrent stacks (the generic weight
    gather) and MoE (expert-parallel on each rank's resident experts)
    under the mesh loss on (2, 4), on the reference's weights and batch:
    the cross entropy, the aux and every gradient leaf against the
    reference's one-device ``jax.value_and_grad`` of ``loss_fn``.  For
    MoE that reference takes its layer as the (2, 4) mesh's
    expert-parallel program computes it (:func:`_expert_parallel_oracle`:
    each data block routed alone, the aux the blocks' mean), so the
    router and the expert banks are held too; a model-axis double count
    of any leaf (the cotangents summed over the model axis once too
    often, or the aux's counted per rank) would be 4x.  The dense
    families' gradients also against the one-process port's at the
    file's tolerance, and, for every family (whisper's ``enc_kv`` from
    its batch's frames), three batch-sharded decode steps against the
    one-process steps, streams equal.  MoE's expert-parallel layer on the
    rank's resident banks equals the shard-mapped ``moe_layer`` and
    the one-process ``expert_parallel_plain``, and with the params not
    placed (each bank whole on every rank, the layer slicing its block)
    the mesh loss gives the placed params' gradients.

    Against the reference the port's one-device gradients are held at
    2e-5 of each leaf's largest entry (tests/test_torch_train_grads.py),
    xlstm's at 2e-3 (its blocks amplify XLA's and torch's ulp-level
    ``exp`` differences, ROADMAP C): the mesh is held to the same.  Against
    the one-process port xlstm's float32 gradients and decode logits are
    held at that 2e-3 too: its head-parallel cells sum row-parallel
    partials in another order than one matmul does, an ulp of the block's
    output, which its stack amplifies to about 1e-4 of the gradients'
    largest entries; its partition is held in float64
    (``test_xlstm_float64_partition_matches_one_process``)."""
    got = _out(port, "family_losses")
    want = _family_want(arch)
    tol = 2e-3 if arch == "xlstm-125m" else 2e-5
    one_tol = FAMILY_TOL["xlstm-125m"] if arch == "xlstm-125m" else 1e-5
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(got[f"{arch}/mesh/{k}"]), want[k],
                                   rtol=tol, atol=tol, err_msg=k)
    if arch == "xlstm-125m":
        _close(got[f"{arch}/serve/mesh"], got[f"{arch}/serve/one"],
               rtol=0, rel_atol=one_tol)
    else:
        _close(got[f"{arch}/serve/mesh"], got[f"{arch}/serve/one"])
    np.testing.assert_array_equal(got[f"{arch}/serve/mesh/tokens"],
                                  got[f"{arch}/serve/one/tokens"])
    keys = [k for k in want if k.startswith("grads/")]
    assert keys
    assert sorted(keys) == sorted(k.split("/", 2)[2] for k in got
                                  if k.startswith(f"{arch}/mesh/grads/"))
    moe = f"{arch}/ep/aux" in got
    for k in keys:
        a = got[f"{arch}/mesh/{k}"]
        _close(a, want[k], rtol=0, rel_atol=tol, err_msg=k)
        if not moe:
            _close(a, got[f"{arch}/one/{k}"], rel_atol=one_tol, err_msg=k)
    if moe:
        assert want["aux"] > 0
        for k in keys:      # the banks whole on every rank, not placed
            _close(got[f"{arch}/mesh_whole/{k}"], got[f"{arch}/mesh/{k}"],
                   rel_atol=1e-5, err_msg=k)
        for arm in ("rank_local", "plain"):
            _close(got[f"{arch}/{arm}/y"], got[f"{arch}/ep/y"], err_msg=arm)
            _close(got[f"{arch}/{arm}/aux"], got[f"{arch}/ep/aux"],
                   err_msg=arm)
    else:
        assert float(got[f"{arch}/mesh/aux"]) == 0.0


def test_mesh_loss_gathers_no_expert_bank(port):
    """Expert parallelism keeps the banks resident: during the MoE
    families' mesh loss (forward, remat and backward) a rank's
    ``dist.sharding.LOG`` holds no collective, and no whole tensor a
    packed gather rebuilt, of an expert bank's shape (whole, stacked or a
    rank's block); the dense families' logs are checked alike."""
    got = _out(port, "family_losses")
    for arch in FAMILIES:
        assert got[f"{arch}/mesh/banks_in_log"].tolist() == [""], arch


def test_rank_holds_its_share_of_expert_banks(port):
    """Placed by the parameter rules on (2, 4), every rank holds exactly
    1/4 (the model axis) of the MoE families' expert bank bytes."""
    got = _out(port, "family_losses")
    for arch in ("jamba-1.5-large-398b", "qwen3-moe-30b-a3b"):
        rows = got[f"{arch}/bank_bytes"]
        assert rows.shape == (8, 2)
        whole, held = rows[:, 0], rows[:, 1]
        assert (whole > 0).all() and (held * 4 == whole).all(), rows


# ---------------------------------------------------------------------------
# whisper's decode step on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", ("2x4", "1x8"))
def test_encdec_mesh_decode_matches_reference(port, impl, mesh):
    """whisper-tiny-smoke's batch-sharded ``jit_decode_step``: its 4 heads
    split over the model axis of (2, 4) (self- and cross-attention
    head-parallel), and on (1, 8), where 8 does not divide them, the
    ring's and ``enc_kv``'s sequence over it (the distributed softmax).
    The logits against the reference's one-device ``encdec.decode_step``
    on the same weights and ``enc_kv``, the greedy streams equal; under
    ``kernel`` every rank's step makes one B1 and one B2 call per layer
    (``qkv_project``'s split and re-pack on its batch block), none under
    ``ref``, and the logits equal ``ref``'s bit for bit."""
    got = _out(port, "encdec_mesh_decode")
    _, want = _encdec()
    tag = f"{impl}/{mesh}"
    _close(got[f"{tag}/logits"], want["batch/logits"])
    np.testing.assert_array_equal(got[f"{tag}/tokens"], want["batch/tokens"])
    np.testing.assert_array_equal(got[f"{tag}/logits"],
                                  got[f"ref/{mesh}/logits"])
    spec = ("P(None, 'data', None, 'model', None)" if mesh == "2x4"
            else "P(None, 'data', 'model', None, None)")
    for k in ("ring", "enc_kv"):
        assert str(got[f"{tag}/{k}_spec"]) == spec, (k, got[f"{tag}/{k}_spec"])
    calls = got[f"{tag}/calls"].reshape(8, ENC_GEN, 2)
    n = 2 if impl == "kernel" else 0      # the smoke decoder's 2 layers
    assert (calls == n).all(), calls


def test_encdec_head_parallel_is_bitwise(port):
    """Head-parallel attention changes no bit: each rank's logits on
    (2, 4) equal the port's one-process step on its own batch block, bit
    for bit, under both policies."""
    got = _out(port, "encdec_mesh_decode")
    for impl in IMPLS:
        assert (got[f"{impl}/2x4/bitwise"] == 1).all(), impl


def test_encdec_long_context_decode_matches_reference(port):
    """Long-context (B 1) on (2, 4): the ring and ``enc_kv`` each on its
    sequence over both axes (``cache_specs``' long-context rule), the
    beat written by the rank that owns its slot, self- and
    cross-attention the distributed softmax; the logits against the
    reference's one-device steps, the stream equal, ``kernel`` equal to
    ``ref`` bit for bit."""
    got = _out(port, "encdec_mesh_decode")
    _, want = _encdec()
    for impl in IMPLS:
        _close(got[f"{impl}/long/logits"], want["long/logits"])
        np.testing.assert_array_equal(got[f"{impl}/long/tokens"],
                                      want["long/tokens"])
        for k in ("ring", "enc_kv"):
            assert str(got[f"{impl}/long/{k}_spec"]) == \
                "P(None, None, ('data', 'model'), None, None)", k
    np.testing.assert_array_equal(got["kernel/long/logits"],
                                  got["ref/long/logits"])


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# ---------------------------------------------------------------------------

#: The families held at their own tolerances (2e-5 of each leaf's
#: largest entry, xlstm 2e-3), as ``test_family_mesh_loss_matches_one_
#: process`` holds them.
FAMILY_TOL = {"jamba-1.5-large-398b": 2e-5, "xlstm-125m": 2e-3,
              "whisper-tiny": 2e-5}


def _tp_want(arch, shape):
    """The function the mesh loss must compute: the reference's
    one-device loss and gradients (``jax.value_and_grad``), for the MoE
    configs with their layer as the mesh's expert-parallel function."""
    if arch == "qwen3-0.6b":
        return _train()[1]
    if arch in (MOE, "jamba-1.5-large-398b") and shape != (2, 4):
        return _family_want(arch, shape)
    return _family_want(arch)      # the family test's cached (2, 4) call


@pytest.mark.parametrize("arch,shape", TP_CASES)
def test_tp_mesh_loss_matches_reference(port, arch, shape):
    """The mesh loss under tensor parallelism (Megatron column / row
    blocks, the sequence-sharded residual, the vocab-sharded embedding,
    head and cross entropy; on (2, 4) the 2 KV heads replicated on each
    rank), its gradients reduced as the train step reduces them: the
    loss, the aux and every gradient leaf against the reference's, at the
    float32 bounds (loss rtol 1e-5, gradients rtol 1e-5 and atol 1e-5 of
    the leaf's largest entry).  A replicated leaf's shares summed over
    the model axis too often or a block's summed at all would be 2-4x."""
    got = _out(port, "tp_losses")
    want = _tp_want(arch, shape)
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    keys = [k for k in want if k.startswith("grads/")]
    assert keys
    assert sorted(keys) == sorted(k.split("/", 2)[2] for k in got
                                  if k.startswith(f"{tag}/grads/"))
    if arch in FAMILY_TOL:
        tol = FAMILY_TOL[arch]
        for k in ("loss", "aux"):
            np.testing.assert_allclose(float(got[f"{tag}/{k}"]), want[k],
                                       rtol=tol, atol=tol, err_msg=k)
        for k in keys:
            _close(got[f"{tag}/{k}"], want[k], rtol=0, rel_atol=tol,
                   err_msg=k)
        return
    _close(got[f"{tag}/loss"], want["loss"])
    if arch == MOE:
        _close(got[f"{tag}/aux"], want["aux"])
        assert want["aux"] > 0
    for k in keys:
        _close(got[f"{tag}/{k}"], want[k], rel_atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch,shape", TP_CASES)
def test_tp_gathers_no_model_sharded_weight(port, arch, shape):
    """No collective of the mesh loss's forward or backward (remat
    included), and no whole tensor a packed gather rebuilt, has the shape
    of a weight the rules place on the model axis, whole or a rank's
    block: each rank keeps its blocks, and only activations move (the
    xLSTM cells too: the mLSTM head-parallel, the sLSTM channel-parallel
    on its ``wx`` and ``r`` column blocks)."""
    got = _out(port, "tp_losses")
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    assert got[f"{tag}/weights_in_log"].tolist() == [""], \
        got[f"{tag}/weights_in_log"]
    assert int(got[f"{tag}/leaves_gathered"]) == 0


def test_tp_mutation_drops_norm_gradients(port):
    """The train step's gradient reduction (``_reduce_grads``) on
    qwen3-0.6b (2, 4): with its model-axis sum of the replicated leaves'
    gradients the norm gains' gradients equal the reference's; with that
    sum removed (each rank left with its share) every one of them is
    off by more than a tenth."""
    got = _out(port, "tp_losses")
    _, want = _train()
    keys = [k for k in want if k.startswith("grads/")
            and k.endswith(NORMS)]
    assert len(keys) == 5
    for k in keys:
        name = k.split("/", 1)[1]
        _close(got[f"qwen3-0.6b/2x4/step/grads/{name}"], want[k],
               rel_atol=1e-5, err_msg=k)
        bad = got[f"qwen3-0.6b/2x4/mutated/grads/{name}"]
        rel = np.abs(bad - want[k]).max() / np.abs(want[k]).max()
        assert rel > 0.1, (k, rel)


def test_tp_odd_glu_block_gathers_its_leaf(port):
    """d_ff 65 on a model axis of 2: a block of ``wi``'s 130 interleaved
    columns would split a (gate, up) pair, so the layer takes ``wi`` (and
    ``wo``, whose 65 rows do not split) whole, gathered, and runs on the
    whole sequence; the loss and every gradient leaf equal the
    one-process port's at the float32 bounds."""
    got = _out(port, "tp_losses")
    assert str(got["odd/wi_spec"]) == "P(None, None, 'model')"
    gathered = got["odd/gathered"].tolist()
    assert "(128, 130)" in gathered and "(65, 128)" in gathered, gathered
    mesh_loss, one_loss = got["odd/loss"]
    _close(mesh_loss, one_loss)
    keys = [k.split("/", 2)[2] for k in got if k.startswith("odd/one/")]
    assert keys
    for k in keys:
        _close(got[f"odd/mesh/{k}"], got[f"odd/one/{k}"], rel_atol=1e-5,
               err_msg=k)


def test_tp_mutation_drops_cut_vector_gradients(port):
    """The train step's gradient reduction on jamba (2, 4): a Mamba layer
    cuts the replicated ``conv_b``, ``dt_bias`` and ``D`` to a rank's
    channels, so each rank's gradient of them is zero outside its block;
    with the step's model-axis sum they equal the reference's, without it
    every one is off by more than a tenth."""
    got = _out(port, "tp_losses")
    want = _tp_want("jamba-1.5-large-398b", (2, 4))
    keys = [k for k in want if k.startswith("grads/") and k.endswith(CUT)]
    assert len(keys) == 3 * 7          # 7 Mamba positions of a superblock
    tag = "jamba-1.5-large-398b/2x4"
    for k in keys:
        name = k.split("/", 1)[1]
        _close(got[f"{tag}/step/grads/{name}"], want[k], rtol=0,
               rel_atol=2e-5, err_msg=k)
        bad = got[f"{tag}/mutated/grads/{name}"]
        rel = np.abs(bad - want[k]).max() / np.abs(want[k]).max()
        assert rel > 0.1, (k, rel)


#: The recurrent stacks.
RECURRENT = ("jamba-1.5-large-398b", "xlstm-125m")
#: xlstm's placed cell weights: the mLSTM's and the sLSTM's.
XLSTM_CELLS = {"up", "ogate", "wq", "wk", "wv", "wi", "wf", "down", "wx",
               "r", "ffn_wi", "ffn_wo"}


def test_rank_holds_its_share_of_mamba_blocks(port):
    """Placed by the parameter rules on (2, 4), every rank holds exactly
    1/4 (the model axis) of each of jamba's six Mamba matrices, the
    blocks its channel-parallel layer computes on."""
    got = _out(port, "tp_losses")
    tag = "jamba-1.5-large-398b/2x4"
    paths = got[f"{tag}/mixer_paths"].tolist()
    names = {p.rsplit("/", 1)[1] for p in paths}
    assert names == {"in_proj", "conv_w", "x_proj", "dt_proj", "A_log",
                     "out_proj"}, paths
    rows = got[f"{tag}/mixer_bytes"].reshape(8, len(paths), 3)
    whole, held, n = rows[..., 0], rows[..., 1], rows[..., 2]
    assert (n == 4).all() and (held * 4 == whole).all(), rows


@pytest.mark.parametrize("shape", ((2, 4), (4, 2)))
def test_rank_holds_its_share_of_xlstm_blocks(port, shape):
    """Placed by the parameter rules, every rank holds exactly 1/m (the
    model axis) of each of xlstm's placed mLSTM and sLSTM weights, the
    blocks its head- and channel-parallel cells compute on."""
    got = _out(port, "tp_losses")
    tag = f"xlstm-125m/{shape[0]}x{shape[1]}"
    paths = got[f"{tag}/mixer_paths"].tolist()
    assert {p.rsplit("/", 1)[1] for p in paths} == XLSTM_CELLS, paths
    rows = got[f"{tag}/mixer_bytes"].reshape(8, len(paths), 3)
    whole, held, n = rows[..., 0], rows[..., 1], rows[..., 2]
    m = shape[1]
    assert (n == m).all() and (held * m == whole).all(), rows


@pytest.mark.parametrize("arch", RECURRENT)
def test_rank_holds_its_share_of_recurrent_state(port, arch):
    """After the batch-sharded steps on (2, 4), every recurrent state
    leaf is placed on the batch over the data axis and on its first dim
    after it that the model axis divides: jamba's Mamba ``conv`` / ``h``
    on their channels, xlstm's mLSTM ``C`` / ``n`` / ``m`` on their heads
    and sLSTM ``c`` / ``n`` / ``m`` / ``h`` on their channels.  Each rank
    holds exactly 1/8 of them, the block its layer steps."""
    got = _out(port, "family_losses")
    paths = got[f"{arch}/serve/state_paths"].tolist()
    fields = {p.rsplit("/", 1)[1] for p in paths}
    assert fields == ({".conv", ".h"} if arch.startswith("jamba")
                      else {".C", ".n", ".m", ".c", ".h"}), paths
    rows = got[f"{arch}/serve/state_bytes"].reshape(8, len(paths), 3)
    whole, held, n = rows[..., 0], rows[..., 1], rows[..., 2]
    assert (n == 8).all() and (held * 8 == whole).all(), rows


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_places_recurrent_state_as_cache_specs(port, arch):
    """``jit_decode_step`` with a mesh leaves every cache leaf, the
    recurrent states among them, placed exactly as ``cache_specs`` says
    (the reference's rules; ``test_cache_specs_match_reference``),
    batch-sharded on (2, 4) and long-context on (2, 4): jamba's Mamba
    state on its channels over the model axis, xlstm's mLSTM state on its
    heads and sLSTM state on its channels."""
    got = _out(port, "family_losses")
    assert bool(got[f"{arch}/serve/placed_ok"])
    assert bool(got[f"{arch}/long/placed_ok"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_long_context_decode_matches_reference(port, arch):
    """The long-context (B 1) ``jit_decode_step`` on (2, 4), the layers
    tensor-parallel (Mamba on each rank's blocks of its weights and
    state), the recurrent states placed as ``cache_specs`` says:
    ``LONG_GEN`` greedy steps from an empty cache
    against the reference's one-device steps, the logits within 3e-3 and
    the streams equal."""
    got = _out(port, "family_losses")
    logits, toks = _long_want(arch)
    np.testing.assert_allclose(got[f"{arch}/long"], logits, rtol=0,
                               atol=3e-3)
    np.testing.assert_array_equal(got[f"{arch}/long/tokens"], toks)


@functools.lru_cache(maxsize=None)
def _prefill_want(arch):
    """The reference's one-device ``jit_prefill`` of the first
    ``PREFILL_LEN`` tokens of :func:`_family`'s batch: the logits and the
    recurrent states, flat."""
    from repro.dist.sharding import local_ctx
    from repro.serve import engine as jengine
    cfg, params, batch = _family(arch)
    prompt = {"tokens": jnp.asarray(
        np.asarray(batch["tokens"])[:, :PREFILL_LEN])}
    logits, states = jengine.jit_prefill(cfg, local_ctx(), params,
                                         prompt)(params, prompt)
    rec = {k: v for k, v in states.items()
           if cfg.block_pattern[int(k[3:])] != "attn"}
    return np.asarray(logits), _flat(rec, "states")


@pytest.mark.parametrize("arch", RECURRENT)
def test_mesh_prefill_places_recurrent_state(port, arch):
    """``jit_prefill`` on (2, 4), the layers tensor-parallel, returns
    every recurrent state placed as ``cache_specs`` says (the placement
    ``jit_decode_step`` keeps), and its logits and states, gathered,
    are the reference's one-device ``jit_prefill``'s within the family
    tolerance (2e-5 of each one's largest entry, xlstm 2e-3)."""
    got = _out(port, "family_losses")
    assert bool(got[f"{arch}/prefill/placed_ok"])
    logits, states = _prefill_want(arch)
    tol = FAMILY_TOL[arch]
    _close(got[f"{arch}/prefill/mesh/logits"], logits, rtol=0,
           rel_atol=tol)
    pre = f"{arch}/prefill/mesh/"
    assert sorted(states) == sorted(k[len(pre):] for k in got
                                    if k.startswith(pre + "states/")), \
        sorted(states)
    for k, v in states.items():
        _close(got[pre + k], v, rtol=0, rel_atol=tol, err_msg=k)


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_from_mesh_prefill_matches_one_process(port, arch):
    """Three greedy batch-sharded ``jit_decode_step`` steps on (2, 4)
    from the mesh prefill's cache, its recurrent states taken as the
    prefill placed them, give the one-process prefill's and steps'
    tokens."""
    got = _out(port, "family_losses")
    np.testing.assert_array_equal(got[f"{arch}/prefill/mesh/tokens"],
                                  got[f"{arch}/prefill/one/tokens"])


# ---------------------------------------------------------------------------
# xlstm's partition in float64
# ---------------------------------------------------------------------------

#: The float64 arm's bound, stated before its first run: each gradient
#: leaf's and the decode logits' largest gap within 1e-9 of the largest
#: entry.  Float64 sums in another order differ by about 1e-16 of their
#: magnitude; xlstm's stack amplifies a float32 ulp (6e-8) to 2e-4 of its
#: gradients, about 4e3 times, which leaves 1e-12, far inside 1e-9.  A
#: partition fault (a block summed twice, blocks swapped) moves them by
#: far more than 1e-6.
XLSTM64_BOUND = 1e-9


@pytest.mark.parametrize("shape", XLSTM64_MESHES)
def test_xlstm_float64_partition_matches_one_process(port, shape):
    """xlstm-smoke in float64 (the reference's weights converted, the
    compute dtype float64: norms, recurrences and cross entropy float64
    too): the head-parallel mesh loss on ``shape`` and every gradient
    leaf, and three greedy batch-sharded decode steps, against the
    one-process port at ``XLSTM64_BOUND``, streams equal; no model-axis
    weight among its collectives."""
    got = _out(port, "family_losses")
    pre = f"xlstm64/{shape[0]}x{shape[1]}"
    mesh_loss, one_loss = got[f"{pre}/loss"]
    assert abs(mesh_loss - one_loss) <= XLSTM64_BOUND * abs(one_loss)
    gaps = dict(zip(got[f"{pre}/paths"].tolist(), got[f"{pre}/gaps"]))
    assert len(gaps) > 50 and max(gaps.values()) <= XLSTM64_BOUND, \
        max(gaps.items(), key=lambda kv: kv[1])
    _close(got[f"{pre}/serve/mesh"], got[f"{pre}/serve/one"], rtol=0,
           rel_atol=XLSTM64_BOUND)
    np.testing.assert_array_equal(got[f"{pre}/serve/mesh/tokens"],
                                  got[f"{pre}/serve/one/tokens"])
    assert got[f"{pre}/weights_in_log"].tolist() == [""]


@pytest.mark.parametrize("mutant", XLSTM64_MUTANTS)
def test_xlstm_float64_arm_catches_partition_faults(port, mutant):
    """The mutation check of the float64 arm: an mLSTM whose ``down``
    partial is summed twice, and an sLSTM with two ranks' blocks of its
    input projection swapped, each move the float64 gradients by more
    than 1e3 times ``XLSTM64_BOUND`` (orders of magnitude past it), and
    past the float32 holds' 2e-3 too."""
    got = _out(port, "family_losses")
    m = XLSTM64_MESHES[0]
    pre = f"xlstm64/{m[0]}x{m[1]}/{mutant}"
    worst = float(got[f"{pre}/gaps"].max())
    assert worst > 1e3 * XLSTM64_BOUND and worst > 2e-3, worst


def test_xlstm_float64_split_ffn_matches_one_process(port):
    """A d_model 48 xlstm whose sLSTM FFN the rules split as xlstm-125m's
    (``ffn_wi`` on its columns, ``ffn_wo`` on its rows; the smoke
    config's 85-wide FFN they place otherwise: ``ffn_wo`` on its columns,
    ``ffn_wi`` on its rows or columns): its float64 mesh loss and every
    gradient leaf on the first mesh against the one-process port at
    ``XLSTM64_BOUND``, no model-axis weight among its collectives."""
    got = _out(port, "family_losses")
    pre = "xlstm64/d48"
    mesh_loss, one_loss = got[f"{pre}/loss"]
    assert abs(mesh_loss - one_loss) <= XLSTM64_BOUND * abs(one_loss)
    gaps = got[f"{pre}/gaps"]
    assert len(gaps) > 50 and gaps.max() <= XLSTM64_BOUND, gaps.max()
    assert got[f"{pre}/weights_in_log"].tolist() == [""]
