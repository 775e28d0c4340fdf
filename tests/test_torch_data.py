"""Port parity for the data path: ``repro_torch.data.aos`` and
``repro_torch.data.pipeline`` against ``repro.data`` (the port of
tests/test_data.py and of tests/test_step_fusion.py's input-pipeline
cases).

Everything here is exact: AoS buffers, batches (the loss weights are
``k / 1024``, exact in float32) and pipeline states equal the reference's
bit for bit, under the port's three policies against the reference's
``ref`` and ``pallas`` (interpret mode).  The one tolerance is the loss
of a pipeline batch through ``loss_fn`` at qwen3-0.6b-smoke, with the
reference's weights: within rtol = atol = 2e-5, as
tests/test_torch_train_grads.py holds the loss.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, strategies as st
except ImportError:  # container without hypothesis: deterministic fallback
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _hypcompat import given, strategies as st

from _torch_bridge import assert_bits_equal, jax_tree_to_np
from repro.data import aos as jaos
from repro.data import pipeline as jpipe
from repro_torch.data import aos
from repro_torch.data.aos import FIELDS, pack_records, unpack_records
from repro_torch.data.pipeline import DataConfig, SyntheticAoSPipeline

IMPLS = ("ref", "kernel", "kernel_dynamic")
JAX_IMPLS = ("ref", "pallas")
B, S = 4, 32


def _pipe(cfg, **kw):
    return SyntheticAoSPipeline(cfg, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _fields():
    """Seeded int32 fields and float32 weights of (B, S); the weights hold
    exact ties (k + 0.5) / 1024, where the quantization rounds half to
    even."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, (B, S), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    weights = rng.random((B, S), dtype=np.float32)
    weights[:, :8] = (np.arange(8, dtype=np.float32) + 0.5) / 1024
    weights[:, -1] = 0.0
    docs = rng.integers(0, 9, (B, S), dtype=np.int32)
    return toks, labels, weights, docs


def _torch_fields():
    return [torch.from_numpy(f.copy()) for f in _fields()]


@functools.lru_cache(maxsize=None)
def _ref_pack(impl):
    return np.asarray(jaos.pack_records(*map(jnp.asarray, _fields()),
                                        policy=impl))


@functools.lru_cache(maxsize=None)
def _ref_unpack(impl):
    return jax_tree_to_np(jaos.unpack_records(jnp.asarray(_ref_pack("ref")),
                                              policy=impl))


# ---------------------------------------------------------------------------
# the AoS record format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_pack_matches_reference(impl, jimpl):
    got = pack_records(*_torch_fields(), policy=impl)
    assert tuple(got.shape) == (B, FIELDS * S) and got.dtype == torch.int32
    assert_bits_equal(got, _ref_pack(jimpl))


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_unpack_matches_reference(impl, jimpl):
    got = unpack_records(torch.from_numpy(_ref_pack("ref").copy()),
                         policy=impl)
    want = _ref_unpack(jimpl)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
        assert_bits_equal(got[k], want[k])


@pytest.mark.parametrize("impl", IMPLS)
def test_aos_roundtrip(impl):
    toks, labels, weights, docs = _torch_fields()
    out = unpack_records(pack_records(toks, labels, weights, docs,
                                      policy=impl), policy=impl)
    assert torch.equal(out["tokens"], toks)
    assert torch.equal(out["labels"], labels)
    assert torch.equal(out["doc_id"], docs)
    # the quantized weight is the nearest multiple of 1/1024, ties to even
    want = np.round(_fields()[2] * 1024).astype(np.int32) / np.float32(1024)
    assert_bits_equal(out["loss_weight"], want.astype(np.float32))


def test_aos_layout_is_interleaved():
    """The buffer really is AoS: fields of token j adjacent at 4j..4j+3."""
    buf = pack_records(torch.tensor([[10, 20]]), torch.tensor([[11, 21]]),
                       torch.tensor([[1.0, 1.0]]), torch.tensor([[5, 5]]))
    assert buf[0, :4].tolist() == [10, 11, 1024, 5]
    assert buf[0, 4:].tolist() == [20, 21, 1024, 5]


def test_pack_unpack_fused_matches_roundtrip_and_reference():
    fields = _torch_fields()
    want = unpack_records(pack_records(*fields))
    got = aos.pack_unpack_fused(*fields)
    ref = jax_tree_to_np(jaos.pack_unpack_fused(*map(jnp.asarray,
                                                      _fields())))
    assert sorted(got) == sorted(want) == sorted(ref)
    for k in want:
        assert_bits_equal(got[k], want[k])
        assert_bits_equal(got[k], ref[k])


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_determinism_across_instances():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=8, seed=3)
    a, b = _pipe(cfg), _pipe(cfg)
    for _ in range(3):
        np.testing.assert_array_equal(a.next_host_aos(), b.next_host_aos())


@given(st.integers(1, 4).map(lambda k: 2 ** k))
def test_host_sharding_partitions_global_batch(nproc):
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=16, seed=1)
    full = _pipe(cfg)._global_batch_np(0)
    shards = [_pipe(cfg, process_index=p, process_count=nproc).next_host_aos()
              for p in range(nproc)]
    np.testing.assert_array_equal(np.concatenate(shards, axis=0), full)


def test_checkpoint_restore_resumes_exactly():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=4, seed=2)
    a = _pipe(cfg)
    a.next_host_aos()
    a.next_host_aos()
    saved = a.state_dict()
    want = a.next_host_aos()
    b = _pipe(cfg)
    b.load_state_dict(saved)
    np.testing.assert_array_equal(b.next_host_aos(), want)


def test_elastic_rescale_preserves_global_stream():
    """Restarting with a different host count continues the same global
    batch sequence."""
    cfg = DataConfig(vocab=50, seq_len=8, global_batch=8, seed=4)
    one = _pipe(cfg)
    one.next_host_aos()
    saved = one.state_dict()
    want = one.next_host_aos()  # global batch @ step 1
    parts = []
    for p in range(4):
        pipe = _pipe(cfg, process_index=p, process_count=4)
        pipe.load_state_dict(saved)
        parts.append(pipe.next_host_aos())
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_pipeline_fused_bit_exact_and_same_state(impl):
    cfg = DataConfig(vocab=101, seq_len=16, global_batch=4, seed=3)
    a = _pipe(cfg, process_index=1, process_count=2)
    b = _pipe(cfg, process_index=1, process_count=2)
    for _ in range(3):
        ba = a.next_batch(fused=True)
        bb = b.next_batch(fused=False, policy=impl)
        assert sorted(ba) == sorted(bb) == ["labels", "loss_weight",
                                            "tokens"]
        for key in ba:
            assert_bits_equal(ba[key], bb[key])
    assert a.state_dict() == b.state_dict()


PIPE_CFG = DataConfig(vocab=97, seq_len=16, global_batch=4, seed=5)
PIPE_STEPS = 3


@functools.lru_cache(maxsize=None)
def _ref_stream(count):
    """The reference pipeline's per-host AoS shards, fused batches and
    unfused batches, step by step, and its final states."""
    out = []
    for p in range(count):
        kw = dict(process_index=p, process_count=count)
        pipes = [jpipe.SyntheticAoSPipeline(PIPE_CFG, **kw)
                 for _ in range(3)]
        steps = [(pipes[0].next_host_aos(),
                  jax_tree_to_np(pipes[1].next_batch(fused=True)),
                  jax_tree_to_np(pipes[2].next_batch(fused=False)))
                 for _ in range(PIPE_STEPS)]
        out.append((steps, [q.state_dict() for q in pipes]))
    return out


@pytest.mark.parametrize("count", [1, 2])
def test_pipeline_matches_reference(count):
    for p, (steps, states) in enumerate(_ref_stream(count)):
        kw = dict(process_index=p, process_count=count)
        pipes = [_pipe(PIPE_CFG, **kw) for _ in range(3)]
        for buf, fused, unfused in steps:
            assert_bits_equal(pipes[0].next_host_aos(), buf)
            for got, want in ((pipes[1].next_batch(fused=True), fused),
                              (pipes[2].next_batch(fused=False), unfused)):
                assert sorted(got) == sorted(want)
                for k in want:
                    assert_bits_equal(got[k], want[k])
        assert [q.state_dict() for q in pipes] == states


def test_next_batch_lands_on_the_pipeline_device():
    pipe = _pipe(DataConfig(vocab=11, seq_len=4, global_batch=2))
    assert pipe.device == torch.device("cpu")
    for fused in (True, False):
        assert all(t.device.type == "cpu"
                   for t in pipe.next_batch(fused=fused).values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SyntheticAoSPipeline(DataConfig(vocab=11, seq_len=4,
                                            global_batch=2))


@functools.lru_cache(maxsize=None)
def _ref_loss():
    from repro.configs import get_arch
    from repro.models.transformer import init_params, loss_fn
    cfg = get_arch("qwen3-0.6b").smoke
    pipe = jpipe.SyntheticAoSPipeline(jpipe.DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2))
    params = jax.jit(lambda k: init_params(cfg, k))(jax.random.key(0))
    loss, _ = jax.jit(lambda p, b: loss_fn(p, b, cfg, None))(
        params, pipe.next_batch())
    return jax_tree_to_np(params), float(loss)


def test_batch_feeds_model_loss():
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as tf
    params, want = _ref_loss()
    cfg = get_arch("qwen3-0.6b").smoke
    pipe = _pipe(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2))
    with torch.no_grad():
        loss, _ = tf.loss_fn(tf.params_from_jax(params, cfg, device="cpu"),
                             pipe.next_batch(), cfg)
    assert np.isfinite(want) and np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), want, rtol=2e-5, atol=2e-5)
