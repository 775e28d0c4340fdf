"""Train-step factory: mixed precision, microbatch accumulation, gradient
compression with error feedback, AdamW, and the state's placement on a
mesh (ZeRO-1).

Port of ``repro``'s ``train/step.py``.  The step is eager: each
microbatch runs :func:`models.transformer.loss_fn` on fresh leaves of the
params that require grad and ``loss.backward()``; microbatch gradients
are averaged in float32 in the reference's order (``acc + g / n``), then
compressed with error feedback (``optim/compression.py``) and applied by
AdamW (``optim/adamw.py``).  The step consumes its state, as the
reference's donation does: params, the AdamW moments and the error state
are updated in place and the returned state holds the same tensors.

Under a ``ShardCtx`` with a mesh the step is one SPMD program on every
rank.  It places the state as :func:`full_state_shardings` says (each
leaf a ``DTensor`` built with ``from_local``; a leaf already so placed is
taken as it is), and then:

1. runs the mesh loss (``transformer.rank_loss``) on its blocks of the
   params and its block of the whole batch, whose gradient is this data
   block's share of each weight's block (no model-axis replica counted
   twice: the weight gather's transpose takes the owned slice);
2. reduces the gradients over the data axes: a ``reduce_scatter`` to the
   rank's ZeRO-1 block where the moments' spec splits the leaf over them,
   else an ``all_reduce`` (leaves bucketed, one collective per bucket);
3. compresses the blocks (error feedback on its block of the error
   state), clips by the global norm (each leaf's squares summed over the
   axes that shard its block, a replicated leaf counted once) and runs
   AdamW on the rank's ZeRO-1 block of the params and the moments;
4. rebuilds each parameter's block with an ``all_gather`` of the updated
   ZeRO-1 blocks over the data axes.

The batch may come whole (every rank holds it) or placed on its batch
dim over the data axes; microbatches split the whole batch as the
reference does, each rank then taking its block of each.

Training runs under ``vx`` policy ``ref``: the hand-written kernels have
no backward, and under ``kernel`` / ``kernel_dynamic`` every ``vx`` verb
that would reach one refuses an operand that requires grad, as the
reference cannot differentiate its Pallas path either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.dist import sharding
from repro_torch.models.transformer import ModelConfig, loss_fn, rank_loss
from repro_torch.optim.adamw import AdamWConfig, _map, _sqrt, apply_updates
from repro_torch.optim.compression import (CompressionConfig,
                                           compress_with_feedback,
                                           init_error_state, sharded_sumsq)
from repro_torch.train.state import state_shardings

#: Elements of one gradient bucket (one collective), float32: 256 MiB.
BUCKET = 1 << 26


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compression: CompressionConfig = CompressionConfig()
    zero1: bool = True


def _split_microbatches(batch: dict, n: int) -> dict:
    def r(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    return {k: r(v) for k, v in batch.items()}


def _grads_of(loss_of, params):
    """(loss, metrics, grads) of ``loss_of`` at ``params``: leaves
    detached from any graph, ``loss.backward()``, a zero gradient for a
    leaf the loss does not reach (as ``jax.grad`` gives)."""
    leaves = _map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_of(leaves)
        loss.backward()
    grads = _map(lambda p: p.grad if p.grad is not None
                 else torch.zeros_like(p), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _loss_and_grads(params, batch, cfg: ModelConfig, ctx):
    return _grads_of(lambda p: loss_fn(p, batch, cfg, ctx), params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, ctx=None
                    ) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``."""
    if sharding.meshed(ctx):
        return _mesh_train_step(cfg, tcfg, ctx)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        metrics, grads = _accumulate(
            lambda b: _loss_and_grads(params, b, cfg, ctx), params, batch,
            tcfg.microbatches)
        if tcfg.compression.kind != "none":
            grads, _, cm = compress_with_feedback(
                grads, state["grad_error"], tcfg.compression)
            metrics.update(cm)
        _, _, om = apply_updates(params, grads, state["opt"], tcfg.optimizer)
        metrics.update(om)
        return state, metrics

    return train_step


def _accumulate(grads_of, like, batch: dict, n: int) -> tuple[dict, Any]:
    """(metrics, gradients) over ``n`` microbatches of ``batch``: float32
    accumulators ``acc + g / n`` in the reference's order, the loss
    averaged alike; one microbatch passes the gradients through."""
    if n == 1:
        _, metrics, grads = grads_of(batch)
        return metrics, grads
    mb = _split_microbatches(batch, n)
    grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), like)
    loss = 0.0
    for i in range(n):
        l_i, _, g = grads_of({k: v[i] for k, v in mb.items()})
        _map(lambda a, x: a.add_(x.float() / n), grads, g)
        del g
        loss = loss + l_i / n
    return {"loss": loss, "aux": torch.zeros((), dtype=torch.float32,
                                             device=loss.device)}, grads


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def _zero1_dim(pspec, mspec, ndim: int):
    """``(dim, axes)`` of the split the moments' spec adds to the params'
    (ZeRO-1), or ``(None, ())``."""
    p = sharding._norm(pspec, ndim)
    m = sharding._norm(mspec, ndim)
    for d in range(ndim):
        extra = tuple(a for a in sharding._names(m[d])
                      if a not in sharding._names(p[d]))
        if extra:
            return d, sharding._names(m[d])
    return None, ()


def _leaf_plan(x, pspec, mspec, ctx) -> tuple:
    """``(zero1 dim, its axes, data axes left to psum)`` for one leaf: its
    gradient is partial over the data axes its spec does not name."""
    named = {a for e in pspec for a in sharding._names(e)}
    missing = tuple(a for a in ctx.data_axes if a not in named)
    zd, zaxes = _zero1_dim(pspec, mspec, x.ndim)
    return zd, zaxes, tuple(a for a in missing if a not in zaxes)


def _buckets(items: list) -> list:
    """Consecutive runs of ``(key, tensor)`` items under :data:`BUCKET`
    elements (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for it in items:
        n = it[1].numel()
        if cur and size + n > BUCKET:
            out.append(cur)
            cur, size = [], 0
        cur.append(it)
        size += n
    if cur:
        out.append(cur)
    return out


def _rows(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` as ``(n, -1)``: row ``j`` its ``j``-th block along ``dim``."""
    return x.movedim(dim, 0).reshape(n, -1)


def _unrows(rows: torch.Tensor, like_shape, dim: int) -> torch.Tensor:
    moved = list(like_shape)
    moved.insert(0, moved.pop(dim))
    return rows.reshape(moved).movedim(0, dim)


@torch.no_grad()
def _reduce_grads(grads: dict, plans: dict, ctx) -> dict:
    """The gradients summed over the data axes, each the rank's ZeRO-1
    block where the leaf has one: bucketed ``reduce_scatter`` s, then
    bucketed ``all_reduce`` s of what stays partial."""
    mesh = ctx.mesh
    out = dict(grads)
    scatter: dict = {}
    for key, g in grads.items():
        zd, zaxes, _ = plans[key]
        if zd is not None:
            n = sharding.axes_size(mesh, zaxes)
            scatter.setdefault(zaxes, []).append((key, _rows(g, zd, n)))
    for zaxes, items in scatter.items():
        for bucket in _buckets(items):
            buf = torch.cat([r for _, r in bucket], dim=1)
            got = sharding.psum_scatter(buf, mesh, zaxes, 0)
            off = 0
            for key, r in bucket:
                zd = plans[key][0]
                shape = list(grads[key].shape)
                shape[zd] //= r.shape[0]
                out[key] = _unrows(got[:, off:off + r.shape[1]], shape, zd)
                off += r.shape[1]
    left: dict = {}
    for key, g in out.items():
        if plans[key][2]:
            left.setdefault(plans[key][2], []).append((key, g))
    for axes, items in left.items():
        for bucket in _buckets(items):
            flat = sharding.psum(torch.cat([g.reshape(-1)
                                            for _, g in bucket]),
                                 mesh, axes)
            off = 0
            for key, g in bucket:
                out[key] = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
    return out


def _zero1_block(x: torch.Tensor, plan, mesh) -> torch.Tensor:
    """The rank's ZeRO-1 block of a param block (a view)."""
    zd, zaxes, _ = plan
    if zd is None:
        return x
    n = x.shape[zd] // sharding.axes_size(mesh, zaxes)
    return x.narrow(zd, sharding.axis_index(mesh, zaxes) * n, n)


@torch.no_grad()
def _rebuild(params: dict, plans: dict, mesh) -> None:
    """Each param block rebuilt from the updated ZeRO-1 blocks: bucketed
    ``all_gather`` s over the data axes, copied in place."""
    groups: dict = {}
    for key, p in params.items():
        zd, zaxes, _ = plans[key]
        if zd is not None:
            blk = _zero1_block(p, plans[key], mesh)
            groups.setdefault((zaxes, p.dtype), []).append(
                (key, _rows(blk, zd, 1)))
    for (zaxes, _), items in groups.items():
        for bucket in _buckets(items):
            got = sharding.all_gather(torch.cat([r for _, r in bucket],
                                                dim=1), mesh, zaxes, 0)
            off = 0
            for key, r in bucket:
                # row j is block j: the rows in order are the whole
                params[key].copy_(_unrows(got[:, off:off + r.shape[1]],
                                          params[key].shape, plans[key][0]))
                off += r.shape[1]


def _by_path(tree) -> dict:
    """A tree's leaves by ``/``-joined path (``sharding.tree_paths``'s
    keys)."""
    return {"/".join(p): x for p, x in sharding._leaves_with_path(tree)}


def _mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, ctx) -> Callable:
    mesh = ctx.mesh
    held: dict = {}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        if not held:
            held["sh"] = full_state_shardings(state, ctx, tcfg)
        sh = held["sh"]
        for key in state:
            state[key] = sharding.tree_map(sharding.place, state[key],
                                           sh[key])
        pspecs = sharding.tree_map(lambda s: s.spec, sh["params"])
        mspecs = sharding.tree_map(lambda s: s.spec, sh["opt"]["m"])
        local = sharding.tree_map(sharding.block_of, state["params"])
        batch = {k: sharding.full_tensor(v) for k, v in batch.items()}
        metrics, grads = _accumulate(
            lambda b: _grads_of(
                lambda p: rank_loss(p, pspecs, b, cfg, ctx), local),
            local, batch, tcfg.microbatches)

        flat_p = _by_path(local)
        wp, wm = _by_path(sh["params"]), _by_path(sh["opt"]["m"])
        plans = {k: _leaf_plan(x, wp[k].spec, wm[k].spec, ctx)
                 for k, x in flat_p.items()}
        gz = _reduce_grads(_by_path(grads), plans, ctx)
        del grads
        pz = {k: _zero1_block(p, plans[k], mesh) for k, p in flat_p.items()}
        gz = sharding.tree_paths(local, lambda k, _: gz[k])
        if tcfg.compression.kind != "none":
            gz, _, cm = compress_with_feedback(
                gz, sharding.tree_map(sharding.block_of, state["grad_error"]),
                tcfg.compression, mesh=mesh, specs=mspecs)
            metrics.update(cm)
        gnorm = _sqrt(sharded_sumsq(gz, mspecs, mesh))
        _, _, om = apply_updates(
            sharding.tree_paths(local, lambda k, _: pz[k]), gz,
            sharding.tree_map(sharding.block_of, state["opt"]),
            tcfg.optimizer, gnorm=gnorm)
        _rebuild(flat_p, plans, mesh)
        metrics.update(om)
        return state, metrics

    return train_step


def init_full_state(cfg: ModelConfig, tcfg: TrainConfig, generator=0,
                    device=None) -> dict:
    """Seeded params (``init_params``), the AdamW state and, under
    compression, the error-feedback state."""
    from repro_torch.models.transformer import init_params
    from repro_torch.train.state import init_train_state
    params = init_params(cfg, generator, device=device)
    state = init_train_state(params)
    if tcfg.compression.kind != "none":
        state["grad_error"] = init_error_state(params)
    return state


def full_state_shardings(state: dict, ctx, tcfg: TrainConfig):
    """The state's placement (``train/state.state_shardings``; the error
    state placed as the moments); ``None`` without a mesh."""
    if not sharding.meshed(ctx):
        return None
    sh = state_shardings({"params": state["params"], "opt": state["opt"]},
                         ctx, zero1=tcfg.zero1)
    if "grad_error" in state:
        sh["grad_error"] = sh["opt"]["m"]
    return sh


def batch_shardings(batch_template: Any, ctx):
    """Each batch leaf placed on its batch dim over the data axes;
    ``None`` without a mesh."""
    if not sharding.meshed(ctx):
        return None
    return sharding.tree_map(
        lambda x: ctx.sharding(ctx.batch_spec(*([None] * (x.ndim - 1)))),
        batch_template)


def jit_train_step(cfg: ModelConfig, tcfg: TrainConfig, ctx, state: dict,
                   batch_template: Any):
    """The reference's name for the compiled step: here the eager
    :func:`make_train_step` (no ``torch.compile``; the state is updated
    in place where the reference donates it); the templates keep the
    reference's signature."""
    return make_train_step(cfg, tcfg, ctx)
