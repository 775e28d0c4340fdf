"""The port's multi-pod dry run (``launch/dryrun.py``) on torch's ``fake``
process group, held against the reference's placement arithmetic.

ONE subprocess (a process has one default group) traces three cells of
the real steps on fake tensors and writes their artifacts:
qwen3-0.6b ``train_4k`` on 16x16 (the ZeRO-1 train step), qwen3-moe-30b-a3b
``decode_32k`` on 2x16x16 (the batch-sharded step, expert-parallel MoE)
and whisper-tiny ``decode_32k`` on 16x16 (the encoder-decoder's step on a
mesh); then, at smoke widths with 4 superblocks, qwen3-0.6b's
``decode_32k`` with the reference's 1- and 2-superblock probes.

- every cell comes back ``ok`` with the reference's artifact keys, the
  trace's policy and MoE method recorded, the direct count as
  ``corrected``;
- a rank's argument bytes equal the arithmetic from the reference's own
  specs on the same axis sizes (``train/step.full_state_shardings`` and
  ``batch_shardings``; ``tree_param_specs`` of the bf16 weights and
  ``cache_specs``; the reference's ``NamedSharding`` s on
  ``AbstractMesh`` es): each leaf's bytes over the sizes of the mesh
  axes its spec names;
- at smoke size ``fixed + NS * body`` from the probes equals the direct
  FLOP count (the eager trace is linear in the superblocks).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CELLS = (("qwen3-0.6b", "train_4k", False),
         ("qwen3-moe-30b-a3b", "decode_32k", True),
         ("whisper-tiny", "decode_32k", False))
PROBE_ARCH, PROBE_SHAPE, PROBE_SUPERBLOCKS = ("qwen3-0.6b",
                                              "decode_32k", 4)
DRIVER = """
import dataclasses, sys, warnings
warnings.filterwarnings("ignore", category=FutureWarning)
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
out, probe_out = sys.argv[1], sys.argv[2]
res = dryrun.run_cells({cells!r}, probes=False, out=out)
smoke = get_arch({arch!r}).smoke
smoke = dataclasses.replace(smoke, n_layers={n} * smoke.sb_len)
res += dryrun.run_cells([({arch!r}, {shape!r}, False)], probes=True,
                        out=probe_out, cfg_override=smoke)
sys.exit(sum(isinstance(r, Exception) for _, r in res))
""".format(cells=list(CELLS), arch=PROBE_ARCH, shape=PROBE_SHAPE,
           n=PROBE_SUPERBLOCKS)


def _name(arch, shape, mp):
    return f"{arch}__{shape}__{'2_16_16' if mp else '16_16'}.json"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-c", DRIVER, str(d / "cells"), str(d / "probe")],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-6000:])
    got = {}
    for c in CELLS:
        with open(d / "cells" / _name(*c)) as f:
            got[c] = json.load(f)
    with open(d / "probe" / _name(PROBE_ARCH, PROBE_SHAPE, False)) as f:
        got["probe"] = json.load(f)
    return got


def _spec_bytes(leaf, spec, sizes) -> float:
    n = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n /= sizes[a]
    return n


def _tree_bytes(shapes, specs, sizes) -> float:
    from jax.sharding import NamedSharding, PartitionSpec
    leaves = jax.tree.leaves(shapes)
    specs = jax.tree.leaves(
        jax.tree.map(lambda s: s.spec if isinstance(s, NamedSharding) else s,
                     specs, is_leaf=lambda x: isinstance(
                         x, (NamedSharding, PartitionSpec))),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(specs)
    return sum(_spec_bytes(x, s, sizes) for x, s in zip(leaves, specs))


def _reference_arguments(arch, shape_name, multi_pod) -> float:
    """The bytes of rank 0's argument blocks by the reference's specs."""
    from jax.sharding import AbstractMesh

    from repro.configs import get_arch, shape_by_name
    from repro.configs.base import decode_inputs, train_batch
    from repro.dist.sharding import tree_param_specs
    from repro.launch.mesh import make_ctx
    from repro.models.transformer import init_params
    from repro.serve.engine import ServeConfig, cache_specs
    from repro.train import step as jstep
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = dict(zip(names, shape))
    ctx = make_ctx(AbstractMesh(shape, names))
    cfg = get_arch(arch).model
    cell = shape_by_name(shape_name)
    params = jax.eval_shape(lambda: init_params(cfg, jax.random.key(0)))
    if cell.kind == "train":
        tcfg = jstep.TrainConfig()
        state = jax.eval_shape(lambda: jstep.init_full_state(
            cfg, tcfg, jax.random.key(0)))
        batch = train_batch(cfg, cell.seq_len, cell.global_batch, specs=True)
        return (_tree_bytes(state, jstep.full_state_shardings(
                    state, ctx, tcfg), sizes)
                + _tree_bytes(batch, jstep.batch_shardings(batch, ctx),
                              sizes))
    params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating)
        else s.dtype), params)
    cache, token = decode_inputs(cfg, cell.seq_len, cell.global_batch,
                                 specs=True)
    return (_tree_bytes(params, tree_param_specs(params, ctx), sizes)
            + _tree_bytes(cache, cache_specs(
                cfg, ctx, ServeConfig(max_len=cell.seq_len), cache), sizes)
            + _spec_bytes(token, ctx.batch_spec(), sizes))


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_dryrun_cell_ok(artifacts, cell):
    """The cell traced to the end on its fake world, with the reference's
    artifact keys; the rank's bytes fit the H100's 80 GB; the trace's
    policy, MoE method and direct count recorded."""
    a = artifacts[cell]
    assert a["status"] == "ok"
    assert a["mesh"] == ("2x16x16" if cell[2] else "16x16")
    assert a["chips"] == (512 if cell[2] else 256)
    for k in ("bytes_per_device", "fits_hbm", "raw", "corrected",
              "roofline", "policy"):
        assert k in a, k
    b = a["bytes_per_device"]
    assert b["peak_est"] == b["arguments"] + b["output"] + b["temp"]
    assert a["fits_hbm"] and b["peak_est"] < 80e9
    assert a["policy"].startswith("ref")
    assert ("moe" in a) == (cell[0] == "qwen3-moe-30b-a3b")
    assert a["corrected"]["method"].startswith("direct")
    assert a["corrected"]["flops_per_dev"] == a["raw"]["flops_per_dev"] > 0
    assert a["raw"]["coll_bytes_per_dev"] > 0
    r = a["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["model_flops"] > 0 and 0 < r["useful_ratio"]
    if cell[1] == "train_4k":
        assert a["microbatches"] == 1


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_dryrun_argument_bytes_match_reference_specs(artifacts, cell):
    got = artifacts[cell]["bytes_per_device"]["arguments"]
    assert got == _reference_arguments(*cell), cell


def test_dryrun_probes_match_direct_count(artifacts):
    """fixed + NS * body of the 1- and 2-superblock probes equals the
    direct count of the 4-superblock trace: FLOPs and collective bytes
    exactly; bytes accessed within 1e-4 (the step's once-a-step work on
    its cache, its plan tables and ``len``, is not quite linear in the
    superblocks: a few kB)."""
    a = artifacts["probe"]
    p, c = a["probes"], a["corrected"]
    assert p["method"] == (f"fixed + {PROBE_SUPERBLOCKS} * body "
                           f"(1/2-superblock probes)")
    assert p["flops_per_dev"] == c["flops_per_dev"] > 0
    assert p["coll_bytes_per_dev"] == c["coll_bytes_per_dev"] > 0
    assert abs(p["bytes_per_dev"] - c["bytes_per_dev"]) <= \
        1e-4 * c["bytes_per_dev"]
