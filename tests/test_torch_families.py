"""Port parity for the whole arch registry and the six attention families
the port serves (gemma3-12b windowed, llava-next-mistral-7b VLM,
granite-34b and starcoder2-3b with the GELU MLP, phi3.5-moe and
qwen3-moe-30b-a3b with MoE), against ``repro`` with the reference's
weights, on the CPU at the smoke configs.

- ``get_arch`` for all ten ``ARCH_IDS``: ``model``, ``smoke`` (field by
  field, specs included), ``family``, ``runs_long_context`` and ``notes``
  equal the reference's; so do ``SHAPES``, ``shape_by_name`` and
  ``cells_for``.
- The port's own ``init_params`` gives the reference's tree, shapes and
  dtypes for every family (the router float32, also through
  ``cast_params`` in bf16 compute).
- ``forward`` in the modes train and prefill (llava with
  ``patch_embeds``) against the reference's: logits and the prefill
  states within rtol 2e-5 / atol 2e-5 in float32 (XLA and torch sum the
  matmuls in different orders; six-layer stacks and the MoE's float32
  routing products add a few ULPs over the two-layer dense smoke's 1e-5),
  the MoE aux loss within rtol 1e-5.
- A paged ``Scheduler`` run of each family under ``ref`` and ``kernel``
  (the CPU sends the kernel wrappers to their plain versions) gives the
  reference scheduler's token streams exactly.  gemma3's prompts are
  longer than its 16-token smoke window, so its local layers' ring and
  mask are exercised.
- The serve CLI takes each family through ``get_arch`` (``--arch NAME
  --smoke --device cpu``): exit 0, every request finished.
- B1 / B6 take a row too wide for the permuted copy's shared memory
  (gemma3-12b's GLU split, 30720 lanes in bf16) as chunks: the identity
  the wrappers rely on holds bit for bit on the plain versions.
- whisper (the encoder-decoder, tests/test_torch_encdec.py) inits and
  runs its forward in the tree and forward cases here, and the paged
  ``Scheduler`` and ``BatchedServer`` refuse it with the reference's own
  message (jamba and xlstm run: tests/test_torch_recurrent_serve.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import jax_tree_to_np
from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.configs import base
from repro_torch.kernels import _common, segment
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import BatchedServer
from repro_torch.serve.scheduler import Scheduler

FAMILIES = ("gemma3-12b", "llava-next-mistral-7b", "granite-34b",
            "starcoder2-3b", "phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b")
# the paged path serves decoders only, in the reference as in the port
REFUSED = {"whisper-tiny": "paged serving covers decoder-only models"}
# the forward and init cases also run the encoder-decoder
MODELS = FAMILIES + ("whisper-tiny",)
RTOL = ATOL = 2e-5
SLOTS, PROMPT_LEN, GEN, MAX_LEN, PAGE = 2, 20, 6, 64, 4


def _norm(v):
    """A config as plain data: dataclasses and spec NamedTuples by their
    type names and fields."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, {f.name: _norm(getattr(v, f.name))
                                   for f in dataclasses.fields(v)})
    if hasattr(v, "_asdict"):
        return (type(v).__name__, {k: _norm(x)
                                   for k, x in v._asdict().items()})
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_registry_matches_reference(name):
    got, want = base.get_arch(name), jbase.get_arch(name)
    assert _norm(got) == _norm(want)
    assert [dataclasses.astuple(s) for s in base.cells_for(name)] == \
        [dataclasses.astuple(s) for s in jbase.cells_for(name)]


def test_shapes_and_lookups_match_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert base._MODULES == jbase._MODULES
    assert [dataclasses.astuple(s) for s in base.SHAPES] == \
        [dataclasses.astuple(s) for s in jbase.SHAPES]
    for s in jbase.SHAPES:
        assert dataclasses.astuple(base.shape_by_name(s.name)) == \
            dataclasses.astuple(s)
    with pytest.raises(KeyError):
        base.shape_by_name("train_8k")
    with pytest.raises(KeyError, match="unknown arch"):
        base.get_arch("llama-7b")


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_families_refused_at_use(name):
    """Init and the forward run; the paged Scheduler and BatchedServer
    raise the reference scheduler's own message."""
    jcfg, jparams = _jax(name)
    with pytest.raises(NotImplementedError) as want:
        JScheduler(jcfg, jparams, slots=1, max_len=16, page_size=4)
    assert str(want.value) == REFUSED[name]
    cfg = base.get_arch(name).smoke
    params = tf.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    logits, _, _ = tf.forward(params, batch, cfg)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(NotImplementedError) as got:
        Scheduler(cfg, params, slots=1, max_len=16, page_size=4,
                  device="cpu")
    assert str(got.value) == REFUSED[name]
    with pytest.raises(NotImplementedError) as got:
        BatchedServer(cfg, params, slots=1, max_len=16, page_size=4,
                      device="cpu")
    assert str(got.value) == REFUSED[name]


# ---------------------------------------------------------------------------
# init, forward and serving against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax(name):
    cfg = jbase.get_arch(name).smoke
    return cfg, jtf.init_params(cfg, jax.random.key(0))


def _port(name, impl="ref"):
    _, jparams = _jax(name)
    cfg = dataclasses.replace(base.get_arch(name).smoke, kernel_impl=impl)
    return cfg, tf.params_from_jax(jax_tree_to_np(jparams), cfg,
                                   device="cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", MODELS)
def test_init_params_tree_matches_reference(name):
    jcfg = jbase.get_arch(name).smoke
    want = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)
    cfg = base.get_arch(name).smoke
    params = tf.init_params(cfg, 0, device="cpu")
    assert _shapes(params) == want
    assert tf.param_count(params) == jtf.param_count(_jax(name)[1])
    cast = tf.cast_params(params, dataclasses.replace(
        cfg, compute_dtype="bfloat16"))
    for leaf_path, dt in _leaf_dtypes(cast):
        want_dt = (torch.float32 if leaf_path.endswith("router")
                   else torch.bfloat16)
        assert dt == want_dt, leaf_path


def _leaf_dtypes(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_dtypes(v, f"{path}/{k}")
    else:
        yield path, tree.dtype


def _batch(cfg):
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    batch = {"tokens": toks}
    if cfg.vlm_patches:
        batch["patch_embeds"] = np.random.default_rng(1).normal(
            size=(2, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        batch["audio_frames"] = np.random.default_rng(2).normal(
            size=(2, cfg.encoder.context, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_forward(name, mode):
    jcfg, jparams = _jax(name)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    logits, aux, states = jax.jit(lambda p, b: jtf.forward(
        p, b, jcfg, None, mode=mode))(jparams, batch)
    return np.asarray(logits), float(aux), jax_tree_to_np(states)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_reference(name, mode):
    cfg, params = _port(name)
    want, want_aux, want_states = _jax_forward(name, mode)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    got, aux, states = tf.forward(params, batch, cfg, None, mode=mode)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if cfg.moe is not None:
        assert want_aux > 0
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5, atol=0)
    if mode == "prefill":
        assert sorted(states) == sorted(want_states)
        for k, v in want_states.items():
            np.testing.assert_allclose(states[k].numpy(), v, rtol=RTOL,
                                       atol=ATOL)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, PROMPT_LEN + 3 * i).tolist()
            for i in range(SLOTS + 1)]


def _serve(sched, prompts):
    reqs = [sched.submit(p, max_new_tokens=GEN) for p in prompts]
    for _ in range(400):
        sched.tick()
        if sched.drained():
            break
    assert sched.drained()
    assert all(r.state.value == "finished" for r in reqs)
    return [r.tokens for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_streams(name):
    jcfg, jparams = _jax(name)
    return _serve(JScheduler(jcfg, jparams, slots=SLOTS, max_len=MAX_LEN,
                             page_size=PAGE), _prompts(jcfg.vocab))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("name", FAMILIES)
def test_paged_scheduler_streams_match_reference(name, impl):
    cfg, params = _port(name, impl)
    got = _serve(Scheduler(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                           page_size=PAGE, device="cpu"),
                 _prompts(cfg.vocab))
    assert got == _jax_streams(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_runs_each_family(name, capsys):
    assert serve_cli.main(["--arch", name, "--smoke", "--device", "cpu",
                           "--requests", "3", "--prompt-len", "8", "--gen",
                           "6", "--max-len", "64"]) == 0
    out = capsys.readouterr().out
    assert out.count("finished") == 3, out


@pytest.mark.parametrize("n,elem,chunks", [(30720, 2, 2), (28672, 2, 2),
                                           (30720, 4, 3), (6144, 2, 1)])
def test_wide_rows_fold_into_chunks(n, elem, chunks):
    """gemma3-12b's (30720) and llava's (28672) GLU splits: the fewest
    chunks whose row fits the copy; the deinterleave of the chunks, put
    back, equals the whole row's."""
    assert segment._fold(n, 2, elem) == chunks
    w = n // chunks
    assert _common.copy_row_fits(w, w, 2, elem)
    assert chunks == 1 or not _common.copy_row_fits(n, n, 2, elem)
    dtype = {2: torch.bfloat16, 4: torch.float32}[elem]
    x = torch.randn((3, 4, n), generator=torch.Generator().manual_seed(n)
                    ).to(dtype)
    whole = segment.deinterleave_plain(x, 2)
    folded = segment.deinterleave_plain(x.reshape(-1, w), 2)
    for a, b in zip(folded, whole):
        assert torch.equal(a.reshape(b.shape), b)


@pytest.mark.parametrize("n,elem,chunks", [(30720, 2, 2), (28672, 2, 1),
                                           (24576, 4, 2), (6144, 2, 1)])
def test_wide_interleave_rows_fold_into_chunks(n, elem, chunks):
    """The interleave copy's rows fold the same way: the fewest chunks
    whose row fits its shared memory; the interleave of the fields'
    chunks, put back, equals the whole row's."""
    assert segment._fold(n, 2, elem, interleave=True) == chunks
    w = n // chunks
    assert _common.interleave_smem(w, 2, 1, elem) <= _common.SMEM_LIMIT
    assert chunks == 1 or \
        _common.interleave_smem(n, 2, 1, elem) > _common.SMEM_LIMIT
    dtype = {2: torch.bfloat16, 4: torch.float32}[elem]
    g = torch.Generator().manual_seed(n)
    soa = [torch.randn((3, 4, n // 2), generator=g).to(dtype)
           for _ in range(2)]
    whole = segment.interleave_plain(soa)
    folded = segment.interleave_plain([t.reshape(-1, w // 2) for t in soa])
    assert torch.equal(folded.reshape(whole.shape), whole)
