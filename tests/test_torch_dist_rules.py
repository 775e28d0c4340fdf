"""The port's placement rules and ``vx.Shard`` against the reference's, in
this process (``dist/sharding.py``, ``launch/mesh.py``,
``serve/engine.cache_specs``, ``vx/program.Shard``).

- ``param_spec`` / ``tree_param_specs`` / ``add_data_sharding`` and
  ``cache_specs``: entry for entry equal to the reference's, for all ten
  archs' full-width parameter and cache templates (shapes from the
  reference's ``jax.eval_shape``, ``meta`` tensors on the port's side), on
  the meshes ``(16, 16)``, ``(2, 16, 16)``, ``(2, 4)`` and ``(4, 2)``, with
  and without ``fsdp`` / ``long_context``.  The reference's rules read
  only ``mesh.shape[axis]`` and ``mesh.axis_names``, so a stand-in with
  those serves them; the port's ``DeviceMesh`` es are built on torch's
  one-process fake group, destroyed once they exist.
- ``train_state_specs`` (ZeRO-1 on and off), ``state_shardings``,
  ``full_state_shardings`` (the error state placed as the moments) and
  ``batch_shardings``: entry for entry equal to the reference's, for all
  ten archs' full-width templates on the same four meshes (the
  reference's ``NamedSharding`` s built on ``AbstractMesh`` es).
- ``make_ctx``'s roles and ``vx_seq_shard`` / ``vx_pool_shard``; the
  production mesh refuses a world of another size, and so do the
  training CLI's ``--mesh`` arms.
- ``Shard``'s validation and plan keys (``tests/test_vx_api.py`` and
  ``tests/test_paged.py``), on one-rank meshes of a one-rank ``gloo``
  group.
"""
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_run import one_rank_group
from repro.configs import ARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.dist import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.models import decode as jdec
from repro.models import encdec as jencdec
from repro.models.transformer import init_params as jinit_params
from repro.serve import engine as jengine
from repro_torch import vx
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P, make_mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.serve import engine

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (4, 2): ("data", "model")}


@pytest.fixture(scope="module")
def meshes():
    """The port's meshes, each built on a fake group of its size (the
    production ones through ``make_production_mesh``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    out = {}
    for shape, names in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        try:
            if shape in ((16, 16), (2, 16, 16)):
                out[shape] = tmesh.make_production_mesh(
                    multi_pod=len(shape) == 3, device="cpu")
            else:
                out[shape] = tmesh.make_test_mesh(shape, names, device="cpu")
        finally:
            dist.destroy_process_group()
    return out


def _stand_in(shape):
    names = MESHES[shape]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _ctxs(meshes, shape, **kw):
    return (jmesh.make_ctx(_stand_in(shape), **kw),
            tmesh.make_ctx(meshes[shape], **kw))


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    cfg = jget_arch(arch).model
    return jax.eval_shape(lambda: jinit_params(cfg, jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _cache_shapes(arch: str, long_context: bool):
    cfg = jget_arch(arch).model
    batch, seq = (1, 524288) if long_context else (128, 32768)
    init = jencdec.init_cache if cfg.encoder is not None else jdec.init_cache
    return jax.eval_shape(lambda: init(cfg, batch, seq, jnp.bfloat16))


def _flat_ref(specs) -> list:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp), tuple(s)) for kp, s in flat]


def _flat_port(specs) -> list:
    out = []

    def walk(t, path):
        if isinstance(t, P):
            out.append(("/".join(path), tuple(t)))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        else:
            for name, v in zip(t._fields, t):
                walk(v, path + (f".{name}",))

    walk(specs, ())
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(meshes, arch):
    shapes = _param_shapes(arch)
    template = _meta(shapes)
    n_sharded = 0
    for shape in MESHES:
        for fsdp in (False, True):
            jctx, tctx = _ctxs(meshes, shape, fsdp=fsdp)
            want = _flat_ref(jsharding.tree_param_specs(shapes, jctx))
            got = _flat_port(sharding.tree_param_specs(template, tctx))
            assert got == want, (shape, fsdp)
            n_sharded += sum(any(e is not None for e in s) for _, s in got)
            # the placements a serve step uses name the same spec
            psh = engine.serve_param_shardings(template, None, tctx)
            assert _flat_port(sharding.map_specs(lambda s: s.spec,
                                                 psh)) == want
    assert n_sharded > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(meshes, arch):
    for long_context in (False, True):
        shapes = _cache_shapes(arch, long_context)
        template = _meta(shapes)
        for shape in MESHES:
            jctx, tctx = _ctxs(meshes, shape, long_context=long_context)
            jscfg = jengine.ServeConfig(max_len=8, long_context=long_context)
            tscfg = engine.ServeConfig(max_len=8, long_context=long_context)
            want = _flat_ref(jengine.cache_specs(None, jctx, jscfg, shapes))
            got = _flat_port(engine.cache_specs(None, tctx, tscfg, template))
            assert got == want, (shape, long_context)


def _abstract_ctx(shape):
    from jax.sharding import AbstractMesh
    return jmesh.make_ctx(AbstractMesh(shape, MESHES[shape]))


def _ref_specs(shardings) -> list:
    return sorted(_flat_ref(jax.tree.map(
        lambda s: s.spec, shardings,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))))


def _port_specs(shardings) -> list:
    return sorted(_flat_port(sharding.map_specs(lambda s: s.spec,
                                                shardings)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_placement_matches_reference(meshes, arch):
    from repro.configs.base import train_batch as jtrain_batch
    from repro.train import state as jstate
    from repro.train import step as jstep
    from repro_torch.train import state as tstate
    from repro_torch.train import step as tstep
    shapes = _param_shapes(arch)
    template = _meta(shapes)
    bshapes = jtrain_batch(jget_arch(arch).model, 4096, 256)
    btemplate = _meta(bshapes)
    n_zero1 = 0
    for shape in MESHES:
        jctx, tctx = _abstract_ctx(shape), tmesh.make_ctx(meshes[shape])
        for zero1 in (True, False):
            want = sorted(_flat_ref(jstate.train_state_specs(
                {"params": shapes}, jctx, zero1=zero1)))
            got = sorted(_flat_port(tstate.train_state_specs(
                {"params": template}, tctx, zero1=zero1)))
            assert got == want, (shape, zero1)
            assert _port_specs(tstate.state_shardings(
                {"params": template}, tctx, zero1=zero1)) == want
            want = _ref_specs(jstep.full_state_shardings(
                {"params": shapes, "opt": {}, "grad_error": shapes}, jctx,
                jstep.TrainConfig(zero1=zero1)))
            got = _port_specs(tstep.full_state_shardings(
                {"params": template, "opt": {}, "grad_error": template},
                tctx, tstep.TrainConfig(zero1=zero1)))
            assert got == want, (shape, zero1)
            if zero1:
                n_zero1 += sum("data" in str(s) for p, s in got
                               if p.startswith("opt/m/"))
        assert _port_specs(tstep.batch_shardings(btemplate, tctx)) == \
            _ref_specs(jstep.batch_shardings(bshapes, jctx)), shape
    assert n_zero1 > 0


def test_add_data_sharding_matches_reference(meshes):
    for shape in MESHES:
        jctx, tctx = _ctxs(meshes, shape)
        for dims in ((16, 64), (3, 64), (64, 3), (1, 1), (32, 32, 8)):
            for start in (0, 1):
                want = jsharding.add_data_sharding(
                    jax.sharding.PartitionSpec(), dims, jctx, start=start)
                got = sharding.add_data_sharding(P(), dims, tctx, start=start)
                assert tuple(got) == tuple(want), (shape, dims, start)


def test_make_ctx_roles_match_reference(meshes):
    for shape in MESHES:
        for kw in ({}, {"fsdp": True}, {"long_context": True}):
            jctx, tctx = _ctxs(meshes, shape, **kw)
            for f in ("data_axes", "model_axis", "seq_axes", "fsdp",
                      "model_size", "data_size", "seq_shard_acts"):
                assert getattr(tctx, f) == getattr(jctx, f), (shape, kw, f)
            assert tuple(tctx.batch_spec("x")) == tuple(jctx.batch_spec("x"))
            for dim in (1, 2, 16, 151936):
                assert tctx.model_if_divisible(dim) == \
                    jctx.model_if_divisible(dim)
            for a, b in ((tctx.vx_seq_shard(), jctx.vx_seq_shard()),
                         (tctx.vx_pool_shard(), jctx.vx_pool_shard())):
                assert (a.axes, a.axis, a.nshards) == \
                    (b.axes, b.axis, b.nshards)
    local = sharding.local_ctx()
    assert local.vx_seq_shard() is None and local.model_size == 1
    assert sharding.param_spec("blocks/w", (4, 8), local) == P()
    assert engine.cache_specs(None, local, engine.ServeConfig(8), {}) is None
    assert engine.serve_param_shardings({}, None, None) is None


def test_meshes_need_their_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((2,), ("s",), device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with pytest.raises(ValueError, match=r"256 ranks.*has 8"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match=r"512 ranks.*has 8"):
            tmesh.make_production_mesh(multi_pod=True, device="cpu")
        # the training CLI's mesh arms build the production mesh on the
        # caller's process group: a world of 8 is refused, never shrunk
        from repro_torch.launch import train
        for arm, n in (("single-pod", 256), ("multi-pod", 512)):
            with pytest.raises(ValueError, match=rf"{n} ranks.*has 8"):
                train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                            "cpu", "--steps", "1", "--mesh", arm])
        assert dist.is_initialized()
        mesh = tmesh.make_test_mesh(device="cpu")
        assert tuple(mesh.shape) == (2, 4)
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Shard validation and plan keys (one-rank meshes)
# ---------------------------------------------------------------------------

@pytest.fixture
def group():
    with one_rank_group():
        yield


def test_same_spec_two_layouts_distinct_cached_programs(group):
    from repro_torch.vx import lower as vxlower
    mesh_a = make_mesh((1,), ("a",), device="cpu")
    mesh_b = make_mesh((1,), ("b",), device="cpu")
    spec = vx.Strided(n=48, stride=3, vl=8, offset=1, dtype="float32")
    shards = [None, vx.Shard(axes=("a",), axis=-1, mesh=mesh_a),
              vx.Shard(axes=("b",), axis=-1, mesh=mesh_b)]
    progs = [vxlower.lower("gather.plan", spec, "ref", sh) for sh in shards]
    assert len({p.key() for p in progs}) == 3
    # executing all three fills three entries, and the one-shard
    # lowerings agree with the replicated one
    w = torch.arange(48, dtype=torch.float32)[None]
    outs = [vxlower.executor(p, spec, sh)(w) for p, sh in zip(progs, shards)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert sum(p.key() in vx.PLANS for p in progs) == 3


def test_layout_key_includes_mesh(group):
    from repro_torch.vx import lower as vxlower
    mesh_ab = make_mesh((1, 1), ("a", "b"), device="cpu")
    mesh_ba = make_mesh((1, 1), ("b", "a"), device="cpu")
    spec = vx.Strided(n=48, stride=2, vl=8, dtype="float32")
    p1 = vxlower.lower("gather.plan", spec, "ref",
                       vx.Shard(axes=("a", "b"), axis=-1, mesh=mesh_ab))
    p2 = vxlower.lower("gather.plan", spec, "ref",
                       vx.Shard(axes=("a", "b"), axis=-1, mesh=mesh_ba))
    assert p1.key() != p2.key()
    assert p1.key() == vxlower.lower(
        "gather.plan", spec, "ref",
        vx.Shard(axes=("a", "b"), axis=-1, mesh=mesh_ab)).key()


def test_sharded_gather_many_rejects_heterogeneous_specs(group):
    mesh = make_mesh((1,), ("a",), device="cpu")
    shard = vx.Shard(axes=("a",), axis=-1, mesh=mesh)
    wins = torch.stack([torch.arange(64.0)] * 2)[:, None, :]
    specs = [vx.Strided(n=64, stride=2, offset=0, vl=8),
             vx.Strided(n=64, stride=3, offset=1, vl=8)]
    with pytest.raises(NotImplementedError, match="heterogeneous"):
        vx.gather_many(specs, wins, policy="ref", shard=shard)
    same = [vx.Strided(n=64, stride=2, offset=0, vl=8)] * 2
    got = vx.gather_many(same, wins, policy="ref", shard=shard)
    assert torch.equal(got, vx.gather_many(same, wins, policy="ref"))


def test_sharded_lowering_rejects_bad_placements(group):
    from repro_torch.vx import lower as vxlower
    mesh = make_mesh((1,), ("a",), device="cpu")
    sh_lane = vx.Shard(axes=("a",), axis=-1, mesh=mesh)
    sh_outer = vx.Shard(axes=("a",), axis=-2, mesh=mesh)
    with pytest.raises(ValueError, match="lane axis"):
        vxlower.lower("gather.plan", vx.Strided(n=8, stride=2, vl=4),
                      "ref", sh_outer)
    with pytest.raises(ValueError, match="permutes the lane axis"):
        vxlower.lower("seg.deint", vx.Segment(n=8, fields=2), "ref",
                      sh_lane)
    with pytest.raises(NotImplementedError):
        vxlower.lower("compact.rows", vx.Compact(n=8), "ref", sh_lane)
    with pytest.raises(NotImplementedError, match="runtime-stride"):
        vxlower.lower("gather.plan", vx.Strided(n=8, stride=vx.BANK, vl=4),
                      "ref", sh_lane)
    with pytest.raises(ValueError, match="counts from the end"):
        vx.Shard(axes=("a",), axis=1, mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        vx.Shard(axes=("a",), axis=-1)
    with pytest.raises(NotImplementedError, match="sharded lowering"):
        vx.scatter(vx.Paged(page_size=4, pages=2, trail=1),
                   torch.zeros((4, 4, 2)), torch.zeros((1, 2)),
                   table=torch.zeros((1, 2), dtype=torch.int32),
                   pos=torch.zeros((1,), dtype=torch.int32),
                   shard=vx.Shard(axes=("a",), axis=-3, mesh=mesh))


def test_paged_shard_axis_validation(group):
    pool = torch.zeros((4, 4, 2))
    spec = vx.Paged(page_size=4, pages=2, trail=1)
    mesh = make_mesh((1,), ("x",), device="cpu")
    bad = vx.Shard(axes=("x",), axis=-1, mesh=mesh)
    with pytest.raises(ValueError, match="page-pool axis"):
        vx.gather(spec, pool, table=torch.zeros((1, 2), dtype=torch.int32),
                  shard=bad)


def test_shard_layout_and_index(group):
    mesh = make_mesh((1, 1), ("a", "b"), device="cpu")
    sh = vx.Shard(axes=["a", "b"], axis=-3, mesh=mesh)
    assert sh.axes == ("a", "b") and sh.nshards == 1 and sh.index() == 0
    assert sh.layout() == (("a", "b"), -3, 1, mesh)
    assert sh.divides(7)
    assert sh == vx.Shard(axes=("a", "b"), axis=-3,
                          mesh=make_mesh((1, 1), ("a", "b"), device="cpu"))
    # P keeps a one-name tuple as the name, as PartitionSpec does
    assert P(("a",), None) == P("a", None)
    assert tuple(jax.sharding.PartitionSpec(("a",), None)) == ("a", None)
    x = torch.arange(6.0).reshape(2, 3)
    placed = sharding.place(x, sharding.Sharding(mesh, P(("a", "b"))))
    assert sharding.is_dtensor(placed)
    np.testing.assert_array_equal(sharding.full_tensor(placed).numpy(),
                                  x.numpy())
    # constrain places as the spec says, replicate gathers a tree whole
    ctx = sharding.ShardCtx(mesh=mesh, data_axes=("a",), model_axis="b")
    got = ctx.constrain(x, P(None, "b"))
    assert sharding.spec_of(got) == P(None, "b")
    whole = sharding.replicate({"w": got, "v": [x]}, ctx)
    assert not sharding.is_dtensor(whole["w"])
    assert torch.equal(whole["w"], x) and whole["v"][0] is x
    assert sharding.local_ctx().constrain(x, P("a")) is x
