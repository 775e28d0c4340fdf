"""Port parity for checkpoints: ``repro_torch.ft.checkpoint`` and
``repro_torch.ft.elastic`` (the port of tests/test_ft.py's checkpoint
cases), the format shared with ``repro.ft.checkpoint`` (each package
restores the other's checkpoints of a train state bit for bit, and the
manifests agree), the snapshot an in-place update cannot tear, and the
bfloat16 leaf both packages refuse on restore.  Everything is exact."""
import functools
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, jax_tree_to_np
from repro.ft import checkpoint as jckpt
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft import elastic
from repro_torch.ft.checkpoint import CheckpointError, CheckpointManager
from repro_torch.kernels._common import tree_leaves
from repro_torch.models.transformer import tree_map


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((8, 4), dtype=np.float32)),
                       "ln": torch.ones((4,))},
            "opt": {"m": torch.zeros((8, 4)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def _assert_tree_bits(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_bits(got[k], want[k])
        return
    assert tuple(got.shape) == np.shape(want)      # 0-dim leaves included
    assert_bits_equal(got.reshape(-1), np.asarray(want).reshape(-1))


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(7, tree, extra={"pipeline": {"step": 3, "seed": 0}},
             blocking=True)
    restored, extra = mgr.restore(_zeros(tree))
    _assert_tree_bits(restored, tree)
    assert restored["opt"]["step"].dtype == torch.int32
    assert extra["pipeline"]["step"] == 3


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]  # older GC'd


def test_atomic_no_partial_checkpoint(tmp_path):
    """A leftover .tmp dir is never listed as a valid step."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp0"))
    assert mgr.all_steps() == []
    mgr.save(1, _tree(), blocking=True)
    assert mgr.latest_step() == 1


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_restore_onto_different_value_template(tmp_path):
    """The leaves come back in the dtype they were saved in, on the
    template leaf's device, whatever the template leaf holds."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    template = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float64),
                        tree)
    restored, _ = mgr.restore(template)
    assert float(restored["params"]["w"].abs().sum()) > 0
    _assert_tree_bits(restored, tree)
    assert all(t.device.type == "cpu" for t in tree_leaves(restored))


def test_crash_mid_save_previous_checkpoint_restores(tmp_path, monkeypatch):
    """Kill between the tmp write and the rename: the tmp dir is left
    behind, the previous checkpoint stays the latest, and restore reads
    it cleanly."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, extra={"mark": "good"}, blocking=True)

    def crash(src, dst):
        raise OSError("simulated kill before rename")

    monkeypatch.setattr(ckpt.os, "rename", crash)
    newer = tree_map(lambda a: a + 1, tree)
    mgr.save(2, newer, blocking=True)     # dies after tmp write
    monkeypatch.undo()

    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000002.tmp0"))
    assert mgr.all_steps() == [1]
    restored, extra = mgr.restore(_zeros(tree))
    _assert_tree_bits(restored, tree)
    assert extra["mark"] == "good"

    # a retried save of the same step succeeds over the stale tmp dir
    mgr.save(2, newer, blocking=True)
    assert mgr.latest_step() == 2
    restored2, _ = mgr.restore(_zeros(tree))
    _assert_tree_bits(restored2, newer)


# --------------------------- torn-checkpoint recovery ------------------------

def _corrupt_manifest(tmp_path, step):
    path = os.path.join(str(tmp_path), f"step_{step:08d}", "manifest.json")
    with open(path, "w") as f:
        f.write('{"step": 2, "paths": [truncated')


def _truncate_npz(tmp_path, step):
    path = os.path.join(str(tmp_path), f"step_{step:08d}", "proc0.npz")
    with open(path, "r+b") as f:
        f.truncate(20)          # a few bytes of zip header, nothing else


def test_restore_falls_back_to_newest_intact_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, extra={"mark": "good"}, blocking=True)
    mgr.save(2, tree_map(lambda a: a + 1, tree), blocking=True)
    _corrupt_manifest(tmp_path, 2)
    restored, extra = mgr.restore(_zeros(tree))
    _assert_tree_bits(restored, tree)
    assert extra["mark"] == "good"
    assert mgr.latest_step() == 2                 # listing is unchanged
    assert mgr.latest_step(intact=True) == 1      # but only 1 loads


def test_restore_falls_back_on_truncated_npz(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(3, tree, blocking=True)
    mgr.save(4, tree_map(lambda a: a * 2, tree), blocking=True)
    _truncate_npz(tmp_path, 4)
    restored, _ = mgr.restore(_zeros(tree))
    _assert_tree_bits(restored, tree)


def test_restore_explicit_corrupt_step_raises_typed(tmp_path):
    """An explicitly named step is restored exactly or fails typed."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    mgr.save(2, tree, blocking=True)
    _corrupt_manifest(tmp_path, 2)
    with pytest.raises(CheckpointError, match="step 2.*torn or corrupted"):
        mgr.restore(_zeros(tree), step=2)
    with pytest.raises(CheckpointError):
        mgr.restore(_zeros(tree), step=99)


def test_restore_empty_dir_raises_typed(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(CheckpointError, match="no checkpoint found"):
        mgr.restore(_tree())


def test_restore_all_steps_torn_raises_typed(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    for s in (1, 2):
        mgr.save(s, tree, blocking=True)
        _corrupt_manifest(tmp_path, s)
    with pytest.raises(CheckpointError, match="no intact checkpoint"):
        mgr.restore(_zeros(tree))
    assert mgr.latest_step(intact=True) is None


# --------------------------- the snapshot -----------------------------------

def test_async_save_is_not_torn_by_in_place_update(tmp_path, monkeypatch):
    """``save(blocking=False)`` then an in-place ``add_(1)`` on every leaf
    before the background write starts: the checkpoint holds the values
    at save time (the train step updates its state in place)."""
    gate = threading.Event()
    write = CheckpointManager._write

    def held_write(self, *args):
        assert gate.wait(30)
        write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = tree_map(torch.clone, tree)
    mgr.save(1, tree, blocking=False)
    for leaf in tree_leaves(tree):
        leaf.add_(1)
    gate.set()
    mgr.wait()
    restored, _ = mgr.restore(_zeros(tree))
    _assert_tree_bits(restored, want)
    assert not torch.equal(tree["params"]["w"], want["params"]["w"])


# --------------------------- bfloat16 leaves --------------------------------

def test_bfloat16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    """A bf16 leaf goes to disk as the reference writes it (a 2-byte void
    array, ``bfloat16`` in the manifest); restoring it raises the typed
    error in both packages, whichever wrote it."""
    b16 = torch.tensor([1.5, -2.0, 3.0], dtype=torch.bfloat16)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(str(port_dir)).save(1, {"b": b16, "n": torch.ones(2)},
                                          blocking=True)
    jckpt.CheckpointManager(str(ref_dir)).save(
        1, {"b": jnp.asarray([1.5, -2.0, 3.0], jnp.bfloat16),
            "n": jnp.ones(2)}, blocking=True)
    for d in (port_dir, ref_dir):
        z = np.load(d / "step_00000001" / "proc0.npz")
        assert z["b"].dtype == np.dtype("V2")
        assert_bits_equal(z["b"].view(np.uint16), b16.view(torch.int16))
        m = json.loads((d / "step_00000001" / "manifest.json").read_text())
        assert m["dtypes"] == {"b": "bfloat16", "n": "float32"}
        with pytest.raises(CheckpointError, match="torn or corrupted"):
            CheckpointManager(str(d)).restore({"b": b16, "n": torch.ones(2)})
        with pytest.raises(jckpt.CheckpointError, match="torn or corrupted"):
            jckpt.CheckpointManager(str(d)).restore(
                {"b": jnp.zeros(3, jnp.bfloat16), "n": jnp.ones(2)})


# --------------------------- interchange with the reference -----------------

@functools.lru_cache(maxsize=None)
def _ref_state():
    """The reference's qwen3-0.6b-smoke train state with moments and step
    filled from its params (so that no leaf is all zeros), as numpy."""
    from repro.configs import get_arch
    from repro.train.step import TrainConfig, init_full_state
    cfg = get_arch("qwen3-0.6b").smoke
    state = jax.jit(lambda k: init_full_state(cfg, TrainConfig(), k))(
        jax.random.key(0))
    p = state["params"]
    state["opt"] = {"m": jax.tree.map(lambda x: x * 0.5, p),
                    "v": jax.tree.map(lambda x: x * x, p),
                    "step": jnp.asarray(3, jnp.int32)}
    return jax_tree_to_np(state)


def _port_template():
    from repro_torch.configs.base import get_arch
    from repro_torch.train.step import TrainConfig, init_full_state
    return init_full_state(get_arch("qwen3-0.6b").smoke, TrainConfig(), 1,
                           "cpu")


EXTRA = {"step": 3, "pipeline": {"step": 3, "seed": 0}}


def _manifest(d, step=3):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_port_restores_the_reference_checkpoint(tmp_path):
    state = _ref_state()
    jckpt.CheckpointManager(str(tmp_path)).save(
        3, jax.tree.map(jnp.asarray, state), extra=EXTRA, blocking=True)
    restored, extra = CheckpointManager(str(tmp_path)).restore(
        _port_template())
    _assert_tree_bits(restored, state)
    assert extra == EXTRA
    assert all(t.device.type == "cpu" for t in tree_leaves(restored))


def test_reference_restores_the_port_checkpoint(tmp_path):
    state = _ref_state()
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    port_state = tree_map(lambda a: torch.from_numpy(np.array(a)), state)
    CheckpointManager(port_dir).save(3, port_state, extra=EXTRA,
                                     blocking=True)
    template = jax.tree.map(jnp.zeros_like, state)
    restored, extra = jckpt.CheckpointManager(port_dir).restore(template)
    _assert_tree_bits(jax_tree_to_np(restored), state)
    assert extra == EXTRA
    # the same state through the reference's save: the same manifest and
    # the same npz members, name for name and byte for byte
    jckpt.CheckpointManager(ref_dir).save(
        3, jax.tree.map(jnp.asarray, state), extra=EXTRA, blocking=True)
    mine, theirs = _manifest(port_dir), _manifest(ref_dir)
    assert {k: v for k, v in mine.items() if k != "extra"} == \
        {k: v for k, v in theirs.items() if k != "extra"}
    zp = np.load(os.path.join(port_dir, "step_00000003", "proc0.npz"))
    zr = np.load(os.path.join(ref_dir, "step_00000003", "proc0.npz"))
    assert zp.files == zr.files == mine["paths"]
    for k in zr.files:
        assert zp[k].dtype == zr[k].dtype and zp[k].shape == zr[k].shape
        assert_bits_equal(zp[k], zr[k])


def test_port_state_has_the_reference_paths(tmp_path):
    """The port's train state flattens to the reference's paths, shapes
    and dtypes (the manifest of a port checkpoint of its own state)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _port_template(), blocking=True)
    jax_state = _ref_state()
    flat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp) for kp, _ in flat]
    m = _manifest(str(tmp_path))
    assert list(m["shapes"]) == paths
    assert m["shapes"] == {p: list(a.shape) for p, (_, a) in
                           zip(paths, flat)}
    assert m["dtypes"] == {p: str(a.dtype) for p, (_, a) in zip(paths, flat)}


# --------------------------- elastic restore --------------------------------

def test_restore_elastic_without_a_mesh(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(2, tree, extra={"mark": 1}, blocking=True)
    assert elastic.reshard_template(tree, None) is None
    assert elastic.reshard_template(
        tree, types.SimpleNamespace(mesh=None)) is None
    for ctx in (None, types.SimpleNamespace(mesh=None)):
        restored, extra = elastic.restore_elastic(mgr, _zeros(tree), ctx)
        _assert_tree_bits(restored, tree)
        assert extra == {"mark": 1}


def test_mesh_is_refused_naming_the_dist_slice(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    with pytest.raises(NotImplementedError, match="9h"):
        elastic.restore_elastic(mgr, tree,
                                types.SimpleNamespace(mesh="a mesh"))
    with pytest.raises(NotImplementedError, match="9h"):
        mgr.restore(tree, shardings=tree_map(lambda t: "replicated", tree))
