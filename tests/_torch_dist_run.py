"""The port's side of the reference's distributed serving checks
(``tests/_dist_checks.py``), run as ranks of one ``gloo`` process group.

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


CHECKS = {
    "sharded_vx_property": check_sharded_vx_property,
    "paged_pool_shard": check_paged_pool_shard,
    "quantized_pool_shard": check_quantized_pool_shard,
    "seq_parallel_decode": check_seq_parallel_decode,
    "longctx_fused_decode": check_longctx_fused_decode,
    "longctx_launch_gate": check_longctx_launch_gate,
    "moe_ep_equivalence": check_moe_ep_equivalence,
}


def _rank(rank: int, world: int, port: int, names: list, inp_path: str,
          out_path: str) -> None:
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
