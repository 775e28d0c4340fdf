"""The port's side of the reference's distributed checks
(``tests/_dist_checks.py``: the serving checks of
``tests/test_torch_dist.py`` and the training checks of
``tests/test_torch_dist_train.py``), run as ranks of one ``gloo`` process
group.

    PYTHONPATH=src:tests python tests/_torch_dist_run.py <check>[,<check>...] \\
        <in.npz> <out.npz>

spawns ``RANKS`` processes on the CPU (``torch.multiprocessing``, spawn
start method), joins them over localhost with ``gloo`` and runs each
named check on every rank, in order, in one spawn.  A check reads its
inputs (keys ``<check>/...`` of ``in.npz``, made by the test from the
reference's seeds) and returns what rank 0 writes to ``out.npz`` (keys
``<check>/...``); the test holds those against the reference.  Each rank
runs torch on one thread.  Imports no JAX and nothing of ``repro``.

:func:`one_rank_group` is the in-process form for tests: a ``gloo`` group
of one rank, destroyed on exit.
"""
from __future__ import annotations

import contextlib
import math
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

RANKS = 8
#: The reference's mesh layouts for the vx property sweeps.
LAYOUTS = (((8,), ("s",)), ((2, 4), ("a", "b")), ((4, 2), ("a", "b")))
#: The reference's (stride, offset) list, negative strides included.
STRIDED = ((1, 0), (2, 3), (3, 1), (5, 2), (7, 1), (-1, 63), (-2, 50),
           (-4, 40))
IMPLS = ("ref", "kernel")


@contextlib.contextmanager
def one_rank_group():
    """A ``gloo`` default process group of one rank (for one-rank meshes
    in a test process), destroyed on exit."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    from repro_torch.dist import sharding
    return sharding.full_tensor(x).detach().cpu().numpy()


def _kernel_calls() -> dict:
    from repro_torch.kernels import segment, strided
    return {f.__name__: f.calls for f in strided.KERNELS + strided.DYNAMIC
            + segment.KERNELS + segment.DYNAMIC}


def _reset_calls() -> None:
    from repro_torch.kernels import segment, strided
    segment.reset_counts()
    strided.reset_counts()


def _per_rank(values, mesh) -> np.ndarray:
    """Every rank's row of ``values`` stacked on every rank (rank order)."""
    from repro_torch.dist import sharding
    row = torch.tensor([values], dtype=torch.int64)
    return sharding.all_gather(row, mesh, mesh.mesh_dim_names, 0).numpy()


# ---------------------------------------------------------------------------
# The checks (run on every rank; rank 0's dict is written)
# ---------------------------------------------------------------------------

def check_sharded_vx_property(inp: dict) -> dict:
    """The shard-local strided gather / scatter (lane axis) and segment
    transposition (outer axis) over the three layouts, under ``ref`` and
    ``kernel``, operands plain (sliced by each rank) and, for the gather
    and the interleave, placed ``DTensor`` s."""
    from repro_torch import vx
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, Sharding, make_mesh
    out = {}
    for li, (shape, axes) in enumerate(LAYOUTS):
        mesh = make_mesh(shape, axes, device="cpu")
        lane = vx.Shard(axes=axes, axis=-1, mesh=mesh)
        outer = vx.Shard(axes=axes, axis=-2, mesh=mesh)
        w = _t(inp[f"L{li}/w"])
        wd = sharding.place(w, Sharding(mesh, P(None, axes)))
        for impl in IMPLS:
            _reset_calls()
            for j, (s, o) in enumerate(STRIDED):
                spec = vx.Strided(n=64, stride=s, offset=o, vl=8)
                got = vx.gather(spec, w, policy=impl, shard=lane)
                placed = vx.gather(spec, wd, policy=impl, shard=lane)
                if not torch.equal(got, placed):
                    raise AssertionError(f"placed gather differs {s, o}")
                out[f"{impl}/L{li}/g{j}"] = got.numpy()
                vals = _t(inp[f"L{li}/v{j}"])
                out[f"{impl}/L{li}/s{j}"] = _np(vx.scatter(
                    spec, w, vals, policy=impl, shard=lane))
            for fields in (2, 4):
                aos = _t(inp[f"L{li}/aos{fields}"])
                spec = vx.Segment(n=8 * fields, fields=fields)
                got = vx.transpose(spec, aos, policy=impl, shard=outer)
                back = vx.transpose(spec, list(got), policy=impl,
                                    shard=outer)
                for f, g in enumerate(got):
                    out[f"{impl}/L{li}/t{fields}/{f}"] = _np(g)
                out[f"{impl}/L{li}/back{fields}"] = _np(back)
            calls = _kernel_calls()
            out[f"{impl}/L{li}/calls"] = np.asarray(
                [calls["gather_strided"], calls["scatter_strided"],
                 calls["deinterleave"], calls["interleave"]])
        # a DTensor placed on another axis than the shard's is refused
        bad = sharding.place(torch.zeros((8, 64)),
                             Sharding(mesh, P(axes, None)))
        try:
            vx.gather(vx.Strided(n=64, stride=2, vl=8), bad, policy="ref",
                      shard=lane)
            out[f"L{li}/refused"] = np.asarray(0)
        except ValueError:
            out[f"L{li}/refused"] = np.asarray(1)
    return out


def _paged_cfg():
    from repro_torch.models.transformer import ModelConfig
    return ModelConfig(name="paged-shard", d_model=32, n_layers=2,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab=97,
                       head_dim=16, mlp="swiglu", scan_layers=True,
                       kernel_impl="ref", remat="none")


def _place_pools(cache: dict, mesh, axes) -> dict:
    """A copy of a paged cache whose pools and scales are ``DTensor`` s
    sharded on their page axis (each rank keeps its page block)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, Sharding
    where = Sharding(mesh, P(None, axes))
    blocks = {k: sharding.place(v, where) if k.startswith(("pos", "scl"))
              else v for k, v in cache["blocks"].items()}
    return {**cache, "blocks": blocks}


def _clone(cache: dict) -> dict:
    return {k: ({b: v.clone() for b, v in x.items()} if k == "blocks"
                else x.clone()) for k, x in cache.items()}


def _serve_pool_shard(out: dict, prefix: str, quantize) -> None:
    """Five greedy paged decode steps of the reference check's model with
    the pool sharded over (8,): replicated, ``pool_shard`` over the plain
    (replicated) pool as the reference runs it, and ``pool_shard`` over
    pools placed as ``DTensor`` s (owner-local appends)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import ShardCtx, make_mesh
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import init_params
    mesh = make_mesh((RANKS,), ("s",), device="cpu")
    ctx = ShardCtx(mesh=mesh, data_axes=(), model_axis=None,
                   seq_axes=("s",))
    pool_shard = ctx.vx_pool_shard(-4)
    cfg = _paged_cfg()
    params = init_params(cfg, 0, device="cpu")
    rep = dec.init_paged_cache(cfg, 2, 32, 4, torch.float32,
                               quantize=quantize, device="cpu")
    shd = _clone(rep)
    placed = _place_pools(_clone(rep), mesh, ("s",))
    tok = torch.tensor([3, 9], dtype=torch.int32)
    logits = {"rep": [], "shd": [], "placed": []}
    for _ in range(5):
        lr, rep = dec.paged_decode_step(params, rep, tok, cfg, None)
        ls, shd = dec.paged_decode_step(params, shd, tok, cfg, None,
                                        pool_shard=pool_shard)
        lp, placed = dec.paged_decode_step(params, placed, tok, cfg, None,
                                           pool_shard=pool_shard)
        for k, v in (("rep", lr), ("shd", ls), ("placed", lp)):
            logits[k].append(v.numpy())
        tok = torch.argmax(lr.float(), -1).to(torch.int32)
    for k, v in logits.items():
        out[f"{prefix}/logits/{k}"] = np.stack(v)
    for k in rep["blocks"]:
        out[f"{prefix}/rep/{k}"] = _np(rep["blocks"][k])
        out[f"{prefix}/placed/{k}"] = _np(placed["blocks"][k])
    out[f"{prefix}/bytes"] = np.asarray(
        [sharding.local_nbytes(rep["blocks"]),
         sharding.local_nbytes(placed["blocks"])])


def check_paged_pool_shard(inp: dict) -> dict:
    """The sharded page gather (one pool, and the fused two-pool form),
    plain and placed pools, over the three layouts; then the serving
    step."""
    from repro_torch import vx
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, Sharding, make_mesh
    pool, table = _t(inp["pool"]), _t(inp["table"])
    spec = vx.Paged(page_size=4, pages=6, trail=2)
    out = {}
    for li, (shape, axes) in enumerate(LAYOUTS):
        mesh = make_mesh(shape, axes, device="cpu")
        shard = vx.Shard(axes=axes, axis=-4, mesh=mesh)
        placed = sharding.place(pool, Sharding(mesh, P(None, axes)))
        for impl in IMPLS:
            out[f"{impl}/L{li}/one"] = vx.gather(
                spec, pool, table=table, policy=impl, shard=shard).numpy()
            out[f"{impl}/L{li}/placed"] = vx.gather(
                spec, placed, table=table, policy=impl,
                shard=shard).numpy()
            many = vx.gather_many(spec, [pool, pool * 2], table=table,
                                  policy=impl, shard=shard)
            out[f"{impl}/L{li}/many0"] = many[0].numpy()
            out[f"{impl}/L{li}/many1"] = many[1].numpy()
        sharding.LOG.reset()
        vx.gather(spec, placed, table=table, policy="ref", shard=shard)
        out[f"L{li}/collective_numels"] = np.asarray(
            sorted(math.prod(sh) for sh in sharding.LOG.shapes()))
    _serve_pool_shard(out, "serve", None)
    return out


def check_quantized_pool_shard(inp: dict) -> dict:
    """The sharded quantized page gather (int8 pool, per-page scales
    sharded alike) over the three layouts; then the serving step over an
    int8 pool."""
    from repro_torch import vx
    from repro_torch.dist.sharding import make_mesh
    pool, scales = _t(inp["pool"]), _t(inp["scales"])
    table = _t(inp["table"])
    spec = vx.Paged(page_size=4, pages=6, trail=2)
    out = {}
    for li, (shape, axes) in enumerate(LAYOUTS):
        mesh = make_mesh(shape, axes, device="cpu")
        shard = vx.Shard(axes=axes, axis=-4, mesh=mesh)
        for impl in IMPLS:
            out[f"{impl}/L{li}"] = vx.gather(
                spec, pool, table=table, scales=scales, policy=impl,
                shard=shard).numpy()
    _serve_pool_shard(out, "serve", "int8")
    return out


def _longctx_inputs(inp: dict):
    """The reference's smoke qwen3 weights and seeded cache, as the
    port's."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import params_from_jax
    cfg = get_arch("qwen3-0.6b").smoke
    tree: dict = {}
    for key, val in inp.items():
        if key.startswith("params/"):
            node = tree
            *path, leaf = key.split("/")[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = val
    params = params_from_jax(tree, cfg, device="cpu")

    def fresh_cache():
        blocks = {k.split("/", 1)[1]: _t(v).clone() for k, v in inp.items()
                  if k.startswith("blocks/")}
        return {"len": torch.tensor(int(inp["len"]), dtype=torch.int32),
                "blocks": blocks}

    return cfg, params, fresh_cache, _t(inp["token"])


def check_seq_parallel_decode(inp: dict) -> dict:
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.serve.engine import ServeConfig, jit_decode_step
    cfg, params, fresh_cache, token = _longctx_inputs(inp)
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    ctx = make_ctx(mesh, long_context=True)
    scfg = ServeConfig(max_len=32, long_context=True)
    cache = fresh_cache()
    step = jit_decode_step(cfg, ctx, scfg, params, cache, device="cpu")
    logits, _ = step(params, dict(cache), token)
    return {"logits": logits.numpy()}


def check_longctx_fused_decode(inp: dict) -> dict:
    """Fused and per-access long-context steps on one placement, with the
    step's collectives recorded."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.serve.engine import ServeConfig, jit_decode_step
    cfg, params, fresh_cache, token = _longctx_inputs(inp)
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    ctx = make_ctx(mesh, long_context=True)
    out = {}
    for fuse in (True, False):
        scfg = ServeConfig(max_len=32, long_context=True, step_fusion=fuse)
        cache = fresh_cache()
        step = jit_decode_step(cfg, ctx, scfg, params, cache, device="cpu")
        sharding.LOG.reset()
        logits, cache = step(params, cache, token)
        tag = "fused" if fuse else "per"
        out[f"{tag}/logits"] = logits.numpy()
        out[f"{tag}/collective_shapes"] = np.asarray(
            sorted(",".join(map(str, sh)) for sh in sharding.LOG.shapes()))
        out[f"{tag}/collectives"] = np.asarray(sharding.LOG.calls)
        for k, v in cache["blocks"].items():
            out[f"{tag}/cache/{k}"] = _np(v)
            out[f"{tag}/placed/{k}"] = np.asarray(sharding.is_dtensor(v))
        out[f"{tag}/len"] = cache["len"].numpy()
    return out


def check_longctx_launch_gate(inp: dict) -> dict:
    """Kernel calls of the sequence-sharded fused step and the per-access
    step under ``kernel`` (the CPU takes each kernel's plain route; the
    wrappers still count), per rank.  Each call of B1 / B2 reads one
    routing table, the port's mask operand."""
    from repro_torch import vx
    from repro_torch.core import accessfuse
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import decode as dec
    cfg, params, fresh_cache, token = _longctx_inputs(inp)
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    ctx = make_ctx(mesh, long_context=True)
    shard = ctx.vx_seq_shard(-3)
    counts = []
    for fuse in (True, False):
        _reset_calls()
        with vx.use("kernel"), accessfuse.pinned_kernel_lowering():
            dec.decode_step(params, fresh_cache(), token, cfg, ctx,
                            fuse=fuse, kv_shard=shard if fuse else None)
        c = _kernel_calls()
        launches = sum(c.values())
        counts += [launches, c["deinterleave"] + c["interleave"]]
    return {"counts": _per_rank(counts, mesh),
            "nshards": np.asarray(shard.nshards)}


def check_moe_ep_equivalence(inp: dict) -> dict:
    from repro_torch.dist.sharding import ShardCtx, full_tensor
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe import MoESpec, moe_layer
    spec = MoESpec(n_experts=8, top_k=2, d_ff=96, capacity_slack=8.0)
    params = {k: _t(inp[k]) for k in ("router", "wg", "wu", "wo")}
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    y, aux = moe_layer(params, _t(inp["x"]), spec, ctx)
    return {"y": full_tensor(y).numpy(), "aux": aux.numpy()}


# ---------------------------------------------------------------------------
# Training checks (tests/test_torch_dist_train.py): the mesh forward and
# loss, the sharded train step (ZeRO-1), elastic restore, GPipe, and the
# batch-sharded serve paths
# ---------------------------------------------------------------------------

def _tree_from(inp: dict, prefix: str) -> dict:
    """The nested dict of the ``<prefix>/a/b`` keys of ``inp``."""
    tree: dict = {}
    for key, val in inp.items():
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = val
    return tree


def _put(out: dict, prefix: str, tree) -> None:
    """Write every leaf of ``tree`` whole (gathered) under ``prefix``."""
    from repro_torch.dist import sharding
    for path, leaf in sharding._leaves_with_path(tree):
        out[prefix + "/" + "/".join(path)] = _np(leaf)


def _train_inputs(inp: dict, **replace):
    """The reference's smoke qwen3 weights and its seeded batch, as the
    port's (float32 params, the ``ref`` policy: training differentiates
    no kernel)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import params_from_jax
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke,
                              **{"kernel_impl": "ref", **replace})
    params = params_from_jax(_tree_from(inp, "params"), cfg, device="cpu")
    batch = {k: _t(v) for k, v in _tree_from(inp, "batch").items()}
    return cfg, params, batch


def _clone_tree(tree):
    from repro_torch.dist import sharding
    return sharding.tree_map(torch.clone, tree)


def _dtensor_leaves(params, shardings):
    """``params`` placed, every leaf (a ``DTensor`` block or a plain
    tensor) a fresh leaf that requires grad."""
    from repro_torch.dist import sharding

    def leaf(x, where):
        x = sharding.place(x, where)
        if sharding.is_dtensor(x):
            return sharding.from_local(x.to_local().detach(), x.device_mesh,
                                       sharding.spec_of(x),
                                       x.shape).requires_grad_()
        return x.detach().requires_grad_()

    return sharding.tree_map(leaf, params, shardings)


def _reduced_grads(leaves, ctx, tp: bool = True) -> dict:
    """Each leaf's gradient summed over the data axes its placement does
    not name (the weight gather's transpose summed over those it does)
    and, under tensor parallelism (``tp``: a decoder's mesh loss), over
    the model axis when it does not name that (a replicated leaf's
    gradient is each rank's share), whole."""
    from repro_torch.dist import sharding
    axes = ctx.data_axes + ((ctx.model_axis,) if tp else ())

    def one(x):
        g = x.grad
        if not sharding.is_dtensor(g):
            return sharding.psum(g, ctx.mesh, axes)
        spec = sharding.spec_of(g)
        named = {a for e in spec for a in sharding._names(e)}
        rest = tuple(a for a in axes if a not in named)
        return sharding.from_local(
            sharding.psum(g.to_local(), ctx.mesh, rest), ctx.mesh, spec,
            g.shape)

    return sharding.tree_map(one, leaves)


def check_mesh_forward(inp: dict) -> dict:
    """``forward`` (train / hidden / prefill), ``loss_fn`` and
    ``chunked_xent`` on (2, 4) with the weights placed by the parameter
    rules and the batch whole or placed; ``flash_attention`` on
    batch-placed ``DTensor`` s."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, Sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import attention, transformer
    from repro_torch.serve.engine import serve_param_shardings
    cfg, params, batch = _train_inputs(inp)
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    ctx = make_ctx(mesh)
    placed = sharding.place_tree(params,
                                 serve_param_shardings(params, cfg, ctx))
    on_batch = {k: sharding.place(v, Sharding(mesh, P(("data",))))
                for k, v in batch.items()}
    out = {}
    for mode in ("train", "hidden", "prefill"):
        y, aux, states = transformer.forward(placed, batch, cfg, ctx,
                                             mode=mode)
        out[f"{mode}/y"] = _np(y)
        out[f"{mode}/spec"] = np.asarray(str(sharding.spec_of(y)))
        if mode == "prefill":
            _put(out, "prefill/states", states)
    out["train/placed_batch_y"] = _np(
        transformer.forward(placed, on_batch, cfg, ctx)[0])
    loss, m = transformer.loss_fn(placed, batch, cfg, ctx)
    out["loss"] = loss.numpy()
    x = transformer.forward(placed, batch, cfg, ctx, mode="hidden")[0]
    out["xent"] = transformer.chunked_xent(
        x, placed["embed"], batch["labels"], batch["loss_weight"], ctx,
        chunk=16).numpy()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((4, 24, 2, 8), generator=g) for _ in range(3))
    qd, kd, vd = (sharding.place(t, Sharding(mesh, P(("data",))))
                  for t in (q, k, v))
    fa = attention.flash_attention(qd, kd, vd, q_chunk=8, kv_chunk=8,
                                   ctx=ctx)
    out["flash/spec"] = np.asarray(str(sharding.spec_of(fa)))
    out["flash"] = _np(fa)
    out["flash/whole"] = attention.flash_attention(
        q, k, v, q_chunk=8, kv_chunk=8).numpy()
    for name in ("q", "k", "v"):
        out[f"flash/in/{name}"] = {"q": q, "k": k, "v": v}[name].numpy()
    return out


#: Families whose mesh loss goes through the generic weight gather (the
#: encoder-decoder, the recurrent stacks) or the MoE layer's rank-local
#: expert-parallel function.
FAMILIES = ("whisper-tiny", "jamba-1.5-large-398b", "xlstm-125m",
            "qwen3-moe-30b-a3b")


def _bank_shapes(cfg, model: int) -> set:
    """The shapes of a MoE config's expert banks: whole, stacked over the
    superblocks, and a model-axis rank's block."""
    if cfg.moe is None:
        return set()
    E, d, f, ns = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff, \
        cfg.n_superblocks
    out = set()
    for e in (E, E // model):
        for sh in ((e, d, f), (e, f, d)):
            out |= {sh, (ns,) + sh}
    return out


#: Long-context greedy steps of the recurrent stacks.
LONG_GEN = 4


#: The prompt of the mesh prefill the recurrent stacks decode from.
PREFILL_LEN = 8


def _prefill_then_decode(out, name, cfg, params, batch, ctx) -> None:
    """``jit_prefill`` of the batch's first ``PREFILL_LEN`` tokens on one
    process and on ``ctx``'s mesh, then three greedy ``jit_decode_step``
    steps from each prefill's cache (the mesh's recurrent states as the
    prefill placed them, its KV gathered): the logits, the states
    (gathered), whether the mesh's states are placed as ``step_specs``
    says, and the greedy tokens."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.models import decode as dec
    from repro_torch.serve import engine
    scfg = engine.ServeConfig(max_len=16)
    prompt = {"tokens": batch["tokens"][:, :PREFILL_LEN]}
    for tag, c in (("one", None), ("mesh", ctx)):
        logits, states = engine.jit_prefill(cfg, c, device="cpu")(params,
                                                                   prompt)
        rec = {k: v for k, v in states.items()
               if cfg.block_pattern[int(k[3:])] != "attn"}
        if c is not None:
            out[f"{name}/prefill/placed_ok"] = np.asarray(_placed_as(
                rec, engine.step_specs(cfg, ctx, scfg,
                                       {"blocks": rec})["blocks"]))
        out[f"{name}/prefill/{tag}/logits"] = _np(logits)
        _put(out, f"{name}/prefill/{tag}/states", rec)
        cache = dec.cache_from_prefill(cfg, {
            k: v if k in rec else sharding.full_tensor(v)
            for k, v in states.items()}, PREFILL_LEN, 16)
        step = engine.jit_decode_step(cfg, c, scfg, device="cpu")
        tok = torch.argmax(sharding.full_tensor(logits)[:, -1], -1).to(
            torch.int32)
        toks = []
        for _ in range(3):
            lg, cache = step(params, cache, tok)
            tok = torch.argmax(sharding.full_tensor(lg), -1).to(torch.int32)
            toks.append(tok.numpy())
        out[f"{name}/prefill/{tag}/tokens"] = np.stack(toks)


def _placed_as(tree, specs) -> bool:
    """Whether every leaf of ``tree`` is placed as the matching spec of
    ``specs`` says (a plain leaf: a spec that shards nothing)."""
    from repro_torch.dist import sharding
    ok = []
    sharding.tree_map(lambda a, sp: ok.append(sharding._norm(
        sharding.spec_of(a) if sharding.is_dtensor(a) else sharding.P(),
        a.ndim) == sharding._norm(sp, a.ndim)), tree, specs)
    return all(ok)


def check_family_losses(inp: dict) -> dict:
    """For each family's smoke config (the reference's weights and seeded
    batch, ``ref``): the mesh loss on (2, 4) and its gradients (reduced
    over the data axes and, the layers tensor-parallel, the model axis,
    whole) beside the one-process port's; three greedy batch-sharded
    decode steps beside the one-process steps, with the cache's placement
    against ``step_specs`` and ``cache_specs`` and the recurrent state
    bytes a rank holds; for the recurrent stacks ``LONG_GEN``
    long-context (B 1) steps, and the mesh ``jit_prefill`` of
    ``PREFILL_LEN`` tokens (its states' placement, the logits and states
    gathered) and three greedy batch-sharded steps from its cache beside
    the one-process prefill and steps; for
    MoE, the expert-parallel layer on the
    rank's resident banks (the mesh forward's) against the expert-parallel
    ``moe_layer`` and the one-process ``expert_parallel_plain`` on the
    same batch, the expert-bank shapes among the mesh loss's collectives
    (``LOG``), the bank bytes a rank holds and the mesh loss's gradients
    on params not placed (each bank whole on every rank)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import RankLocal
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import moe, transformer
    from repro_torch.train import state as tstate
    from repro_torch.train.step import _loss_and_grads
    ctx = make_ctx(make_test_mesh((2, 4), ("data", "model"), device="cpu"))
    out = {}
    for name in FAMILIES:
        cfg = dataclasses.replace(get_arch(name).smoke, kernel_impl="ref")
        params = transformer.params_from_jax(
            _tree_from(inp, f"{name}/params"), cfg, device="cpu")
        batch = {k: _t(v) for k, v in
                 _tree_from(inp, f"{name}/batch").items()}
        loss, m, grads = _loss_and_grads(params, batch, cfg, None)
        out[f"{name}/one/loss"] = m["loss"].numpy()
        out[f"{name}/one/aux"] = m["aux"].numpy()
        _put(out, f"{name}/one/grads", grads)
        psh = tstate.state_shardings({"params": params, "opt": {}}, ctx)
        leaves = _dtensor_leaves(params, psh["params"])
        sharding.LOG.reset()
        with torch.enable_grad():
            loss, m = transformer.loss_fn(leaves, batch, cfg, ctx)
            loss.backward()
        banks = _bank_shapes(cfg, ctx.model_size)
        out[f"{name}/mesh/banks_in_log"] = np.asarray(sorted(
            str(sh) for sh in sharding.LOG.shapes() & banks) or [""])
        out[f"{name}/mesh/loss"] = m["loss"].detach().numpy()
        out[f"{name}/mesh/aux"] = m["aux"].detach().numpy()
        _put(out, f"{name}/mesh/grads", _reduced_grads(leaves, ctx))
        # three greedy batch-sharded decode steps (recurrent states: each
        # rank its batch block, updated in place; MoE: each rank its
        # resident experts; whisper: its enc_kv from the batch's frames)
        from repro_torch.models import decode as dec
        from repro_torch.models import encdec
        from repro_torch.serve import engine
        scfg = engine.ServeConfig(max_len=16)
        for tag, c in (("one", None), ("mesh", ctx)):
            step = engine.jit_decode_step(cfg, c, scfg, device="cpu")
            if cfg.encoder is None:
                cache = dec.init_cache(cfg, 4, 16, device="cpu")
            else:
                cache = encdec.init_cache(cfg, 4, 16, device="cpu")
                cache["enc_kv"] = encdec.precompute_enc_kv(
                    params, batch["audio_frames"], cfg)
            tok = batch["tokens"][:, 0]
            logits, toks = [], []
            for _ in range(3):
                lg, cache = step(params, cache, tok)
                lg = sharding.full_tensor(lg)
                logits.append(lg.numpy())
                tok = torch.argmax(lg, -1).to(torch.int32)
                toks.append(tok.numpy())
            out[f"{name}/serve/{tag}"] = np.stack(logits)
            out[f"{name}/serve/{tag}/tokens"] = np.stack(toks)
        if cfg.encoder is None:
            # the mesh step's cache as it placed it: step_specs (Mamba's
            # state a rank's block of its channels, as cache_specs says;
            # the xLSTM cells' whole over the model axis)
            out[f"{name}/serve/placed_ok"] = np.asarray(
                _placed_as(cache, engine.step_specs(cfg, ctx, scfg, cache)))
            out[f"{name}/serve/as_cache_specs"] = np.asarray(
                _placed_as(cache, engine.cache_specs(cfg, ctx, scfg, cache)))
            out[f"{name}/serve/state_paths"], out[
                f"{name}/serve/state_bytes"] = _mixer_bytes(cache["blocks"],
                                                            ctx.mesh)
        if cfg.mamba is not None or cfg.xlstm is not None:
            # long-context (B 1) steps from an empty cache
            lctx = make_ctx(ctx.mesh, long_context=True)
            long = engine.ServeConfig(max_len=16, long_context=True)
            step = engine.jit_decode_step(cfg, lctx, long, device="cpu")
            cache = dec.init_cache(cfg, 1, 16, device="cpu")
            tok = batch["tokens"][:1, 0]
            logits, toks = [], []
            for _ in range(LONG_GEN):
                lg, cache = step(params, cache, tok)
                lg = sharding.full_tensor(lg)
                logits.append(lg.numpy())
                tok = torch.argmax(lg, -1).to(torch.int32)
                toks.append(tok.numpy())
            out[f"{name}/long"] = np.stack(logits)
            out[f"{name}/long/tokens"] = np.stack(toks)
            out[f"{name}/long/placed_ok"] = np.asarray(
                _placed_as(cache, engine.step_specs(cfg, lctx, long, cache)))
            _prefill_then_decode(out, name, cfg, params, batch, ctx)
        if any(cfg.moe_pattern):
            pos = f"pos{list(cfg.moe_pattern).index(True)}"
            pm = sharding.tree_map(lambda a: a[0],
                                   params["blocks"][pos]["moe"])
            x = torch.randn((4, 16, cfg.d_model),
                            generator=torch.Generator().manual_seed(1))
            y_ep, aux_ep = moe.moe_layer(pm, x, cfg.moe, ctx)
            # the mesh forward's layer: the rank's block of experts
            mine = {k: v if k == "router" else sharding.local_block(
                v, ctx.mesh, sharding.P("model")) for k, v in pm.items()}
            y_rl, aux_rl = moe.moe_layer(
                mine, sharding.local_block(x, ctx.mesh, ctx.batch_spec()),
                cfg.moe, RankLocal(mesh=None, experts=ctx))
            aux_rl = sharding.pmean(aux_rl, ctx.mesh, ctx.data_axes)
            y_pl, aux_pl = moe.expert_parallel_plain(pm, x, cfg.moe, 2, 4)
            out[f"{name}/ep/y"] = _np(y_ep)
            out[f"{name}/ep/aux"] = aux_ep.numpy()
            out[f"{name}/rank_local/y"] = _np(sharding.from_local(
                y_rl, ctx.mesh, ctx.batch_spec()))
            out[f"{name}/rank_local/aux"] = aux_rl.numpy()
            out[f"{name}/plain/y"] = y_pl.numpy()
            out[f"{name}/plain/aux"] = aux_pl.numpy()
            # params not placed (every rank holds each bank whole): the
            # layer slices the rank's block, its gradient summed over the
            # model axis
            whole = sharding.tree_map(
                lambda p: p.detach().clone().requires_grad_(), params)
            with torch.enable_grad():
                transformer.loss_fn(whole, batch, cfg, ctx)[0].backward()
            _put(out, f"{name}/mesh_whole/grads",
                 _reduced_grads(whole, ctx))
            whole = held = 0
            for path, leaf in sharding._leaves_with_path(leaves):
                if sharding.is_expert_bank("/".join(path), leaf.ndim, 1):
                    whole += leaf.numel() * leaf.element_size()
                    held += sharding.local_nbytes(leaf)
            out[f"{name}/bank_bytes"] = np.asarray(
                _per_rank([whole, held], ctx.mesh))
    return out


#: The tensor-parallel checks: (arch, mesh) on 8 ranks.  On (2, 4) the
#: smoke configs' 2 KV heads do not split 4 ways (every rank keeps both),
#: and starcoder2-smoke's 6 heads do not either (every rank attends every
#: head, the query columns gathered; its GELU MLP).
TP_CASES = (("qwen3-0.6b", (2, 4)), ("qwen3-0.6b", (4, 2)),
            ("qwen3-moe-30b-a3b", (2, 4)), ("qwen3-moe-30b-a3b", (4, 2)),
            ("starcoder2-3b", (2, 4)),
            ("jamba-1.5-large-398b", (2, 4)), ("jamba-1.5-large-398b", (4, 2)),
            ("xlstm-125m", (2, 4)),
            ("whisper-tiny", (2, 4)), ("whisper-tiny", (4, 2)))
#: The replicated leaves whose gradient the train step sums over the
#: model axis (the mutation check's): qwen3's norm gains and the vectors
#: jamba's Mamba layers cut to a rank's channels.
NORMS = ("ln1", "ln2", "attn/q_norm", "attn/k_norm", "final_norm")
CUT = ("mamba/conv_b", "mamba/dt_bias", "mamba/D")
MUTATIONS = {"qwen3-0.6b/2x4": NORMS, "jamba-1.5-large-398b/2x4": CUT}
#: The xLSTM cells' subtrees: their layers take the leaves the rules
#: place on the model axis whole, gathered.
XLSTM = ("/xl/", "/slstm/")


def _stacked(path) -> bool:
    """Whether the leaf at ``path`` is stacked over layers: the
    superblocks, whisper's encoder layers and its cross stack."""
    return path[0] in ("blocks", "cross") or tuple(path[:2]) == (
        "encoder", "blocks")


def _weight_shapes(params, psh, model: int, only=None) -> set:
    """The shapes of the leaves the parameter rules place on the model
    axis (those whose path ends with one of ``only``, if given), whole and
    a model-axis rank's block, as a gather moves them: a stacked leaf a
    layer's, without its stacked dim (the mesh forward gathers a
    superblock at a time; the stacked shape of smoke qwen3's ``ffn/wo``
    block, (2, 64, 128), is also the gathered residual stream's, and a
    stacked shape of whisper-smoke's, (2, 64, 128), its encoder's summed
    beat's on a batch block of 2)."""
    from repro_torch.dist import sharding
    out = set()
    for (path, leaf), where in zip(sharding._leaves_with_path(params),
                                   sharding._sharding_leaves(psh)):
        spec = sharding._norm(where.spec, leaf.ndim)
        dims = [d for d, e in enumerate(spec) if "model" in
                sharding._names(e)]
        if not dims or (only and not "/".join(path).endswith(only)):
            continue
        blk = list(leaf.shape)
        blk[dims[0]] //= model
        for sh in (tuple(leaf.shape), tuple(blk)):
            out.add(sh[1:] if _stacked(path) else sh)
    return out


#: The mixers whose weights a rank holds as its model-axis blocks:
#: Mamba's channels.
MIXERS = ("/mamba/",)


def _mixer_bytes(tree, mesh) -> tuple:
    """``(paths, per-rank rows)`` for the leaves of ``tree`` placed on the
    model axis under a block-wise mixer (:data:`MIXERS`), and the placed
    leaves of a recurrent state (a NamedTuple field, ``.``-named,
    whether or not the model axis places it): per rank and leaf
    its whole bytes, this rank's bytes and the number of blocks its
    spec cuts it into (the data axes' size, where it names them, times
    the model axis's)."""
    from repro_torch.dist import sharding
    paths, rows = [], []
    for path, leaf in sharding._leaves_with_path(tree):
        key = "/" + "/".join(path) + "/"
        if not sharding.is_dtensor(leaf) or not (
                any(m in key for m in MIXERS) or "/." in key):
            continue
        names = {a for e in sharding.spec_of(leaf)
                 for a in sharding._names(e)}
        if "model" not in names and "/." not in key:
            continue
        paths.append("/".join(path))
        rows += [leaf.numel() * leaf.element_size(),
                 sharding.local_nbytes(leaf),
                 sharding.axes_size(leaf.device_mesh, tuple(names))]
    return np.asarray(paths or [""]), _per_rank(rows, mesh)


def check_tp_losses(inp: dict) -> dict:
    """Tensor parallelism under the mesh loss: for each ``TP_CASES``
    config and mesh (the reference's smoke weights and seeded batch,
    ``ref``), the loss, aux and every gradient leaf (reduced as the train
    step reduces them, whole), and the shapes of model-sharded weights
    among the collectives and packed gathers of its forward and backward
    (``LOG``), with the whole shapes of the xLSTM cells' placed leaves;
    for jamba the bytes of the Mamba leaves placed on the model axis a
    rank holds (:func:`_mixer_bytes`).  On qwen3-0.6b
    and jamba (2, 4) also the train step's own gradient reduction
    (``train/step._reduce_grads``) of the replicated leaves (the norm
    gains; the vectors a Mamba layer cuts to a rank's channels) with and
    without its model-axis sum (the mutation check), and a
    config whose ``wi`` block would split a (gate, up) pair (d_ff 65 on a
    model axis of 2: ``wi`` and ``wo`` gathered whole, the FFN replicated)
    against the one-process port."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.train import state as tstate
    from repro_torch.train import step as tstep
    out = {}
    for arch, shape in TP_CASES:
        tag = f"{arch}/{shape[0]}x{shape[1]}"
        cfg = dataclasses.replace(get_arch(arch).smoke, kernel_impl="ref")
        params = transformer.params_from_jax(
            _tree_from(inp, f"{arch}/params"), cfg, device="cpu")
        batch = {k: _t(v) for k, v in _tree_from(inp, f"{arch}/batch")
                 .items()}
        ctx = make_ctx(make_test_mesh(shape, ("data", "model"),
                                      device="cpu"))
        state = tstate.init_train_state(_clone_tree(params))
        sh = tstep.full_state_shardings(state, ctx, tstep.TrainConfig())
        leaves = _dtensor_leaves(params, sh["params"])
        sharding.LOG.reset()
        with torch.enable_grad():
            loss, m = transformer.loss_fn(leaves, batch, cfg, ctx)
            loss.backward()
        seen = sharding.LOG.shapes() & _weight_shapes(params, sh["params"],
                                                       ctx.model_size)
        out[f"{tag}/weights_in_log"] = np.asarray(
            sorted(str(x) for x in seen) or [""])
        out[f"{tag}/leaves_gathered"] = np.asarray(len(sharding.LOG.leaves))
        # the whole shapes (a superblock's) of the xLSTM cells' placed
        # leaves
        out[f"{tag}/xlstm_whole"] = np.asarray(sorted({
            str(tuple(leaf.shape[1:])) for (path, leaf), where in zip(
                sharding._leaves_with_path(params),
                sharding._sharding_leaves(sh["params"]))
            if any(c in "/" + "/".join(path) + "/" for c in XLSTM)
            and sharding.is_sharded(where.spec)}) or [""])
        out[f"{tag}/loss"] = m["loss"].detach().numpy()
        out[f"{tag}/aux"] = m["aux"].detach().numpy()
        _put(out, f"{tag}/grads", _reduced_grads(leaves, ctx))
        if cfg.mamba is not None:
            out[f"{tag}/mixer_paths"], out[f"{tag}/mixer_bytes"] = \
                _mixer_bytes(leaves, ctx.mesh)
        if tag not in MUTATIONS:
            continue
        # the train step's own reduction, with and without the model-axis
        # sum of the replicated leaves' gradients
        from repro_torch.train.step import _by_path
        wp, wm = _by_path(sh["params"]), _by_path(sh["opt"]["m"])
        grads = {k: sharding.block_of(x.grad)
                 for k, x in _by_path(leaves).items()}
        plans = {k: tstep._leaf_plan(g, wp[k].spec, wm[k].spec, ctx, True)
                 for k, g in grads.items()}
        for arm, use in (("step", plans), ("mutated", {
                k: p[:3] + ((),) for k, p in plans.items()})):
            red = tstep._reduce_grads(grads, use, ctx)
            for k, g in red.items():
                if k.endswith(MUTATIONS[tag]):
                    zd, zaxes = use[k][:2]
                    if zd is not None:
                        g = sharding.all_gather(g, ctx.mesh, zaxes, zd)
                    out[f"{tag}/{arm}/grads/{k}"] = g.numpy()
    # a wi block that would split a (gate, up) pair: gathered whole
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl="ref",
                              d_ff=65)
    params = transformer.init_params(cfg, 0, device="cpu")
    batch = {k: _t(v) for k, v in _tree_from(inp, "qwen3-0.6b/batch")
             .items()}
    _, m1, g1 = tstep._loss_and_grads(params, batch, cfg, None)
    ctx = make_ctx(make_test_mesh((4, 2), ("data", "model"), device="cpu"))
    psh = tstate.state_shardings({"params": params, "opt": {}}, ctx)
    leaves = _dtensor_leaves(params, psh["params"])
    sharding.LOG.reset()
    with torch.enable_grad():
        loss, m = transformer.loss_fn(leaves, batch, cfg, ctx)
        loss.backward()
    out["odd/wi_spec"] = np.asarray(str(sharding.spec_of(
        leaves["blocks"]["pos0"]["ffn"]["wi"])))
    out["odd/gathered"] = np.asarray(sorted(
        str(shape) for shape, _ in sharding.LOG.leaves))
    out["odd/loss"] = np.asarray([float(m["loss"]), float(m1["loss"])])
    _put(out, "odd/mesh", _reduced_grads(leaves, ctx))
    _put(out, "odd/one", g1)
    return out


#: whisper's mesh decode: (mesh, the arm its KV leaves take) on 8 ranks.
ENCDEC_MESHES = (((2, 4), "heads"), ((1, 8), "sequence"))


def _encdec_steps(step, params, cache: dict, tok, gen: int) -> tuple:
    """``gen`` greedy steps: (logits (gen, B, V) whole, tokens (gen, B),
    each step's (B1, B2) wrapper calls, the last cache)."""
    from repro_torch.core import accessfuse
    from repro_torch.dist import sharding
    logits, toks, calls = [], [], []
    for _ in range(gen):
        _reset_calls()
        with accessfuse.pinned_kernel_lowering():
            lg, cache = step(params, cache, tok)
        c = _kernel_calls()
        calls.append([c["deinterleave"], c["interleave"]])
        lg = sharding.full_tensor(lg)
        logits.append(lg.numpy())
        tok = torch.argmax(lg, -1).to(torch.int32)
        toks.append(tok.numpy())
    return np.stack(logits), np.stack(toks), calls, cache


def check_encdec_mesh_decode(inp: dict) -> dict:
    """whisper-tiny-smoke's decode step under a mesh (the reference's
    weights and ``enc_kv``, greedy steps from seeded tokens): batch-sharded
    on (2, 4) (the KV heads over the model axis, head-parallel) and on
    (1, 8) (4 heads do not split 8 ways: the ring's and ``enc_kv``'s
    sequence over it, the distributed softmax) under ``ref`` and
    ``kernel``, with the (B1, B2) calls a rank makes a step; each rank's
    head-parallel logits against the one-process step on its batch block,
    bit for bit; long-context (B 1) on (2, 4), both leaves on their
    sequence over both axes."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import encdec, transformer
    from repro_torch.serve import engine
    gen, max_len = int(inp["gen"]), int(inp["max_len"])
    tok0 = _t(inp["tokens"])
    out = {}

    def fresh(cfg, rows):
        cache = encdec.init_cache(cfg, rows.stop - rows.start, max_len,
                                  torch.float32, device="cpu")
        cache["enc_kv"] = _t(inp["enc_kv"])[:, rows].clone()
        return cache

    scfg = engine.ServeConfig(max_len=max_len)
    for impl in IMPLS:
        cfg = dataclasses.replace(get_arch("whisper-tiny").smoke,
                                  kernel_impl=impl)
        params = transformer.params_from_jax(_tree_from(inp, "params"), cfg,
                                             device="cpu")
        B = tok0.shape[0]
        one = engine.jit_decode_step(cfg, None, scfg, device="cpu")
        out[f"{impl}/one/logits"], out[f"{impl}/one/tokens"], _, _ = \
            _encdec_steps(one, params, fresh(cfg, slice(0, B)), tok0, gen)
        for shape, arm in ENCDEC_MESHES:
            tag = f"{impl}/{shape[0]}x{shape[1]}"
            ctx = make_ctx(make_test_mesh(shape, ("data", "model"),
                                          device="cpu"))
            step = engine.jit_decode_step(cfg, ctx, scfg, device="cpu")
            lg, tk, calls, cache = _encdec_steps(
                step, params, fresh(cfg, slice(0, B)), tok0, gen)
            out[f"{tag}/logits"], out[f"{tag}/tokens"] = lg, tk
            out[f"{tag}/calls"] = _per_rank(
                [x for pair in calls for x in pair], ctx.mesh)
            for k, leaf in (("ring", cache["blocks"]["pos0"]),
                            ("enc_kv", cache["enc_kv"])):
                out[f"{tag}/{k}_spec"] = np.asarray(str(sharding.spec_of(
                    leaf)))
            if arm == "heads":
                # the one-process step on this rank's batch block
                n = B // ctx.data_size
                r = sharding.axis_index(ctx.mesh, ctx.data_axes)
                rows = slice(r * n, (r + 1) * n)
                mine, _, _, _ = _encdec_steps(
                    one, params, fresh(cfg, rows), tok0[rows], gen)
                same = bool(np.array_equal(lg[:, rows], mine))
                out[f"{tag}/bitwise"] = _per_rank([int(same)], ctx.mesh)
        ctx = make_ctx(make_test_mesh((2, 4), ("data", "model"),
                                      device="cpu"), long_context=True)
        long = dataclasses.replace(scfg, long_context=True)
        step = engine.jit_decode_step(cfg, ctx, long, device="cpu")
        lg, tk, _, cache = _encdec_steps(step, params, fresh(cfg, slice(0, 1)),
                                         tok0[:1], gen)
        out[f"{impl}/long/logits"], out[f"{impl}/long/tokens"] = lg, tk
        for k, leaf in (("ring", cache["blocks"]["pos0"]),
                        ("enc_kv", cache["enc_kv"])):
            out[f"{impl}/long/{k}_spec"] = np.asarray(
                str(sharding.spec_of(leaf)))
    return out


def check_sharded_train_step(inp: dict) -> dict:
    """The reference's ``check_sharded_train_step`` on (2, 4): a float32
    arm (the loss, the gradients reduced over the data axes, two steps'
    state and metrics, placements and a rank's bytes), the reference's
    bf16 arm, and compression with microbatches against the one-process
    port."""
    import dataclasses
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.compression import (CompressionConfig,
                                               init_error_state)
    from repro_torch.train import state as tstate
    from repro_torch.train import step as tstep
    cfg, params, batch = _train_inputs(inp)
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    ctx = make_ctx(mesh)
    out = {}
    psh = tstate.state_shardings({"params": params, "opt": {}}, ctx)
    leaves = _dtensor_leaves(params, psh["params"])
    with torch.enable_grad():
        loss, _ = transformer.loss_fn(leaves, batch, cfg, ctx)
        loss.backward()
    out["f32/loss"] = loss.detach().numpy()
    _put(out, "f32/grads", _reduced_grads(leaves, ctx))
    wq = leaves["blocks"]["pos0"]["attn"]["wq"]
    out["f32/wq_grad_local"] = np.asarray(wq.grad.to_local().shape)
    # weights also split over the data axis (fsdp): the gather's
    # transpose sums the data blocks' shares before taking the slice
    fctx = make_ctx(mesh, fsdp=True)
    fsh = tstate.state_shardings({"params": params, "opt": {}}, fctx,
                                 zero1=False)
    leaves = _dtensor_leaves(params, fsh["params"])
    with torch.enable_grad():
        loss, _ = transformer.loss_fn(leaves, batch, cfg, fctx)
        loss.backward()
    out["fsdp/loss"] = loss.detach().numpy()
    _put(out, "fsdp/grads", _reduced_grads(leaves, fctx))
    wq = leaves["blocks"]["pos0"]["attn"]["wq"]
    out["fsdp/wq_spec"] = np.asarray(str(sharding.spec_of(wq)))

    state = tstate.init_train_state(_clone_tree(params))
    step = tstep.make_train_step(cfg, tstep.TrainConfig(), ctx)
    for i in range(2):
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            out[f"f32/step{i}/{k}"] = m[k].numpy()
    _put(out, "f32/state/params", state["params"])
    _put(out, "f32/state/m", state["opt"]["m"])
    _put(out, "f32/state/v", state["opt"]["v"])
    wq = state["params"]["blocks"]["pos0"]["attn"]["wq"]
    mq = state["opt"]["m"]["blocks"]["pos0"]["attn"]["wq"]
    out["f32/wq"] = np.asarray([sharding.is_dtensor(wq)]
                               + list(wq.to_local().shape) + list(wq.shape))
    out["f32/m_spec"] = np.asarray(str(sharding.spec_of(mq)))
    out["f32/m_local"] = np.asarray(mq.to_local().shape)
    out["f32/bytes"] = np.asarray(
        [sharding.local_nbytes(params), sharding.local_nbytes(
            state["params"]), sharding.local_nbytes(state["opt"]["m"])])

    cfgb = dataclasses.replace(cfg, compute_dtype="bfloat16")
    state = tstate.init_train_state(_clone_tree(params))
    step = tstep.make_train_step(cfgb, tstep.TrainConfig(), ctx)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    out["bf16/losses"] = np.asarray([float(m1["loss"]), float(m2["loss"])])
    wq = state["params"]["blocks"]["pos0"]["attn"]["wq"]
    out["bf16/wq"] = np.asarray([sharding.is_dtensor(wq)]
                                + list(wq.to_local().shape) + list(wq.shape))

    for kind in ("int8", "topk"):
        tcfg = tstep.TrainConfig(microbatches=2,
                                 compression=CompressionConfig(kind=kind))
        states = []
        for c in (None, ctx):
            st = tstate.init_train_state(_clone_tree(params))
            st["grad_error"] = init_error_state(st["params"])
            run = tstep.make_train_step(cfg, tcfg, c)
            for i in range(2):
                st, m = run(st, batch)
                for k in ("loss", "grad_norm", "compression_error"):
                    out[f"{kind}/{'one' if c is None else 'mesh'}/"
                        f"step{i}/{k}"] = m[k].numpy()
            states.append(st)
        for tag, st in zip(("one", "mesh"), states):
            _put(out, f"{kind}/{tag}/state", {
                "params": st["params"], "m": st["opt"]["m"],
                "v": st["opt"]["v"], "err": st["grad_error"]})
    return out


def check_elastic_reshard(inp: dict) -> dict:
    """The reference's ``check_elastic_reshard``: a tree placed on (2, 4)
    saved and restored onto (4, 2); a reference-written checkpoint
    restored into a sharded port template."""
    from repro_torch.dist import sharding
    from repro_torch.ft import elastic
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    tree = sharding.tree_map(_t, _tree_from(inp, "tree"))
    ctx = make_ctx(make_test_mesh((2, 4), ("data", "model"), device="cpu"))
    ctx2 = make_ctx(make_test_mesh((4, 2), ("data", "model"), device="cpu"))
    src = sharding.place_tree(tree, elastic.reshard_template(tree, ctx))
    mgr = CheckpointManager(str(inp["port_dir"]))
    mgr.save(1, src, extra={"from": "(2, 4)"}, blocking=True)
    dist.barrier()
    restored, extra = elastic.restore_elastic(mgr, src, ctx2)
    out = {"extra": np.asarray(extra["from"])}
    _put(out, "restored", restored)
    wq = restored["blocks"]["pos0"]["attn"]["wq"]
    out["wq"] = np.asarray([sharding.axis_size(wq.device_mesh, "model")]
                           + list(wq.to_local().shape))
    out["wq_spec"] = np.asarray(str(sharding.spec_of(wq)))
    ref = CheckpointManager(str(inp["ref_dir"]))
    got, _ = elastic.restore_elastic(ref, src, ctx)
    _put(out, "from_ref", got)
    out["from_ref_placed"] = np.asarray(sharding.is_dtensor(
        got["blocks"]["pos0"]["attn"]["wq"]))
    return out


def check_pipeline_equivalence(inp: dict) -> dict:
    """The reference's ``check_pipeline_equivalence``: GPipe over the pod
    axis of (2, 2, 2), two microbatches; the loss, and the gradients
    (each rank's stage share, added over the stages)."""
    from repro_torch.dist.pipeline_par import (PipelineConfig,
                                               pipeline_loss_fn,
                                               reduce_stage_grads)
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.train.step import _grads_of
    cfg, params, batch = _train_inputs(inp)
    ctx = make_ctx(make_mesh((2, 2, 2), ("pod", "data", "model"),
                             device="cpu"))
    pcfg = PipelineConfig(axis="pod", n_microbatches=2)
    loss, metrics, grads = _grads_of(
        lambda p: pipeline_loss_fn(p, batch, cfg, ctx, pcfg), params)
    out = {"loss": loss.numpy(), "xent": metrics["loss"].numpy()}
    _put(out, "stage_grads", grads)
    _put(out, "grads", reduce_stage_grads(grads, ctx, pcfg))
    return out


def check_batch_sharded_serve(inp: dict) -> dict:
    """``jit_prefill``, the batch-sharded ``jit_decode_step`` (greedy
    steps) and ``BatchedServer`` with a mesh, on (2, 4) (KV sequence over
    the model axis) and (4, 2) (KV heads over it), under ``ref`` and
    ``kernel``; the kernel wrappers' calls per decode step (the fused
    split pinned to its kernel lowering, as the card's full-width step
    takes it: the smoke cache is below the fusion threshold)."""
    from repro_torch.core import accessfuse
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import decode as dec
    from repro_torch.serve import engine
    out = {}
    tokens = _t(inp["tokens"])
    prompts = [list(map(int, r)) for r in inp["prompts"]]
    gen = int(inp["gen"])
    for impl in IMPLS:
        cfg, params, _ = _train_inputs(inp, kernel_impl=impl)
        for shape in ((2, 4), (4, 2)):
            tag = f"{impl}/{shape[0]}x{shape[1]}"
            ctx = make_ctx(make_test_mesh(shape, ("data", "model"),
                                          device="cpu"))
            logits, states = engine.jit_prefill(cfg, ctx, device="cpu")(
                params, {"tokens": tokens})
            out[f"{tag}/prefill"] = _np(logits)
            cache = dec.cache_from_prefill(
                cfg, sharding.tree_map(sharding.full_tensor, states),
                tokens.shape[1], int(inp["max_len"]))
            step = engine.jit_decode_step(
                cfg, ctx, engine.ServeConfig(max_len=int(inp["max_len"])),
                device="cpu")
            tok = torch.argmax(sharding.full_tensor(logits)[:, -1], -1).to(
                torch.int32)
            steps, calls = [], []
            for _ in range(gen):
                _reset_calls()
                with accessfuse.pinned_kernel_lowering():
                    lg, cache = step(params, cache, tok)
                c = _kernel_calls()
                calls.append([c["deinterleave"], sum(c.values())])
                lg = sharding.full_tensor(lg)
                steps.append(lg.numpy())
                tok = torch.argmax(lg, -1).to(torch.int32)
            out[f"{tag}/steps"] = np.stack(steps)
            out[f"{tag}/calls"] = _per_rank(
                [x for pair in calls for x in pair], ctx.mesh)
            out[f"{tag}/kv_spec"] = np.asarray(str(sharding.spec_of(
                cache["blocks"]["pos0"])))
            srv = engine.BatchedServer(cfg, params, slots=len(prompts),
                                       max_len=int(inp["max_len"]),
                                       ctx=ctx, device="cpu")
            reqs = [srv.submit(p, max_new_tokens=gen) for p in prompts]
            for _ in range(200):
                srv.tick()
                if srv.scheduler.drained():
                    break
            out[f"{tag}/streams"] = _per_rank(
                [t for r in reqs for t in r.tokens], ctx.mesh)
    return out


CHECKS = {
    "sharded_vx_property": check_sharded_vx_property,
    "paged_pool_shard": check_paged_pool_shard,
    "quantized_pool_shard": check_quantized_pool_shard,
    "seq_parallel_decode": check_seq_parallel_decode,
    "longctx_fused_decode": check_longctx_fused_decode,
    "longctx_launch_gate": check_longctx_launch_gate,
    "moe_ep_equivalence": check_moe_ep_equivalence,
    "mesh_forward": check_mesh_forward,
    "sharded_train_step": check_sharded_train_step,
    "elastic_reshard": check_elastic_reshard,
    "pipeline_equivalence": check_pipeline_equivalence,
    "batch_sharded_serve": check_batch_sharded_serve,
    "family_losses": check_family_losses,
    "encdec_mesh_decode": check_encdec_mesh_decode,
    "tp_losses": check_tp_losses,
}


def _rank(rank: int, world: int, port: int, names: list, inp_path: str,
          out_path: str) -> None:
    import warnings
    # newer torch names all_gather_into_tensor / reduce_scatter_tensor
    # deprecated; the card's torch has only these
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with np.load(inp_path) as f:
            data = dict(f)
        out = {}
        with torch.no_grad():
            for name in names:
                mine = {k.split("/", 1)[1]: v for k, v in data.items()
                        if k.startswith(name + "/")}
                out.update({f"{name}/{k}": np.asarray(v)
                            for k, v in CHECKS[name](mine).items()})
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def main(argv: list) -> int:
    import torch.multiprocessing as mp
    names, inp_path, out_path = argv[0].split(","), argv[1], argv[2]
    unknown = [n for n in names if n not in CHECKS]
    if unknown:
        print(f"unknown checks {unknown}; known: {sorted(CHECKS)}",
              file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(RANKS, port, names, inp_path, out_path),
             nprocs=RANKS, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
