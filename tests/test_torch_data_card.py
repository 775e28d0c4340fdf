"""The data path and checkpoints on the card (no JAX here: the card's
machine has none).

- The AoS pipeline at ``(4, 4 * 64)`` and ``(8, 4 * 4096)`` int32 under
  ``kernel``, ``kernel_dynamic`` and ``ref``: ``next_host_aos`` equals a
  numpy interleave of the pipeline's own fields bit for bit,
  ``unpack_records`` gives the fields back, ``next_batch(fused=True)``
  equals ``next_batch(fused=False)`` with equal states; one B2 (B7) per
  pack and one B1 (B6) per unpack, none under ``ref`` and none on the
  fused path.
- A checkpoint of a CUDA tree restored onto a CUDA template, and one
  written from the CPU restored onto the card, bit for bit.

Skips without a card."""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal
from _torch_bridge import cuda_device  # noqa: F401
from repro_torch import vx
from repro_torch.data.aos import WEIGHT_SCALE, unpack_records
from repro_torch.data.pipeline import DataConfig, SyntheticAoSPipeline
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.kernels import segment
from repro_torch.kernels._common import tree_leaves
from repro_torch.models.transformer import tree_map

pytestmark = pytest.mark.cuda

MINE = {"kernel": ("deinterleave", "interleave"),
        "kernel_dynamic": ("deinterleave_dynamic", "interleave_dynamic"),
        "ref": (None, None)}


def _launches():
    return {f.__name__: f.launches for f in segment.KERNELS + segment.DYNAMIC}


def _expect(impl, split, pack):
    d, i = MINE[impl]
    want = dict.fromkeys(_launches(), 0)
    if d is not None:
        want[d], want[i] = split, pack
    return want


def _numpy_aos(pipe, step):
    toks, labels, weights, docs = pipe._global_fields_np(step)
    wq = np.round(weights * WEIGHT_SCALE).astype(np.int32)
    B, S = toks.shape
    return np.stack([toks, labels, wq, docs], -1).reshape(B, 4 * S)


@pytest.mark.parametrize("shape", [(4, 64), (8, 4096)])
@pytest.mark.parametrize("impl", ["kernel", "kernel_dynamic", "ref"])
def test_pipeline_on_card(cuda_device, impl, shape):
    B, S = shape
    cfg = DataConfig(vocab=151936, seq_len=S, global_batch=B, seed=7)
    with vx.use(impl):
        pipe = SyntheticAoSPipeline(cfg, device=cuda_device)
        segment.reset_counts()
        buf = pipe.next_host_aos()
        assert _launches() == _expect(impl, 0, 1)
        assert buf.dtype == np.int32 and buf.shape == (B, 4 * S)
        np.testing.assert_array_equal(buf, _numpy_aos(pipe, 0))

        segment.reset_counts()
        out = unpack_records(torch.from_numpy(buf).to(cuda_device))
        assert _launches() == _expect(impl, 1, 0)
        toks, labels, weights, docs = pipe._global_fields_np(0)
        for key, want in (("tokens", toks), ("labels", labels),
                          ("doc_id", docs), ("loss_weight", weights)):
            assert out[key].device.type == "cuda"
            assert_bits_equal(out[key], want)

        fused = SyntheticAoSPipeline(cfg, device=cuda_device)
        unfused = SyntheticAoSPipeline(cfg, device=cuda_device)
        for _ in range(2):
            segment.reset_counts()
            a = fused.next_batch(fused=True)
            assert _launches() == _expect(impl, 0, 0)
            b = unfused.next_batch(fused=False)
            assert _launches() == _expect(impl, 1, 1)
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].device.type == "cuda"
                assert_bits_equal(a[key], b[key])
        assert fused.state_dict() == unfused.state_dict()


def _tree(device):
    g = torch.Generator(device).manual_seed(3)
    return {"params": {"w": torch.randn((64, 32), generator=g,
                                        device=device)},
            "opt": {"m": torch.randn((64, 32), generator=g, device=device),
                    "step": torch.tensor(5, dtype=torch.int32,
                                         device=device)}}


def test_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    tree = _tree(cuda_device)
    mgr = CheckpointManager(str(tmp_path / "card"))
    mgr.save(1, tree, blocking=False)
    for leaf in tree_leaves(tree):
        leaf.add_(1)                  # in place, after the snapshot
    mgr.wait()
    template = tree_map(torch.zeros_like, tree)
    restored, _ = mgr.restore(template)
    for got, now in zip(tree_leaves(restored), tree_leaves(tree)):
        assert got.device.type == "cuda"
        assert_bits_equal(got + 1, now)

    cpu = tree_map(lambda t: t.cpu(), tree)
    mgr = CheckpointManager(str(tmp_path / "cpu"))
    mgr.save(2, cpu, blocking=True)
    restored, _ = mgr.restore(template)
    for got, want in zip(tree_leaves(restored), tree_leaves(cpu)):
        assert got.device.type == "cuda"
        assert_bits_equal(got, want)
