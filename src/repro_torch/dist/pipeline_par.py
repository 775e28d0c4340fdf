"""GPipe pipeline parallelism over one mesh axis (the multi-pod "pod" axis).

Port of ``repro``'s ``dist/pipeline_par.py``.  The superblock stack is
split into ``axis_size`` contiguous stages; microbatches stream through
the stages, each stage handing its activations to the next with
:func:`dist.sharding.ppermute` (a differentiable send: its backward is
the inverse permutation, which carries the cotangents back a stage).

The schedule is the classic GPipe fill / steady / drain loop: with M
microbatches and S stages, tick t has stage s working on microbatch
``t - s`` (when in range).  Every rank runs the same ticks (one SPMD
program): out-of-range ticks compute on don't-care data and are masked
out of the accumulators.  Each tick's input is ``where(stage == 0,
embedding, received)`` as in the reference, and the last hand-off is
tied into the loss, so every rank differentiates through every hand-off
and the backward's sends pair up across the stages, in the same order.

The send is one ``all_to_all_single`` over the axis's group whose only
non-empty splits are the peer's: ``gloo`` refuses point-to-point sends of
CUDA tensors on one card (``chip_smoke.py`` phase 17.0 probes it), and
takes this collective.

Numerics match ``models.transformer.loss_fn`` (the same per-token terms,
microbatch-partitioned sums combined before the division).  A rank's
gradient of :func:`pipeline_loss_fn` is its stage's share (the loss
sums over the stages with the identity transpose of
``dist.sharding.global_sum``); :func:`reduce_stage_grads` adds the
stages' shares, which gives the one-device gradient.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import sharding


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    axis: str = "pod"
    n_microbatches: int = 2


def _stage_blocks(blocks, stage: int, per: int):
    """This stage's ``per`` superblocks of the ``(NS, ...)`` stacks."""
    return sharding.tree_map(lambda a: a[stage * per:(stage + 1) * per],
                             blocks)


def pipeline_loss_fn(params, batch, cfg, ctx, pcfg: PipelineConfig):
    """Pipelined equivalent of ``loss_fn(params, batch, cfg, None)``.

    ``params`` and ``batch`` are whole on every rank (plain tensors); the
    pipeline axis places the stages and carries the hand-offs, the other
    axes hold replicas.  Returns (loss + aux, {"loss", "aux"}), the same
    on every rank."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import (cast_params,
                                                label_logprob_terms,
                                                superblock_apply)
    if not sharding.meshed(ctx):
        raise ValueError("pipeline parallelism needs a mesh")
    mesh, axis = ctx.mesh, pcfg.axis
    n_stages = sharding.axis_size(mesh, axis)
    M = pcfg.n_microbatches
    NS = cfg.n_superblocks
    if NS % n_stages:
        raise ValueError(f"{NS} superblocks do not split into {n_stages} "
                         f"stages")
    per = NS // n_stages
    B, S = batch["tokens"].shape
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    bm = B // M
    stage = mesh.get_local_rank(axis)
    cparams = cast_params(params, cfg)
    mb = {k: v.reshape((M, bm) + tuple(v.shape[1:]))
          for k, v in batch.items()}
    dev = batch["tokens"].device
    positions = torch.arange(S, device=dev).expand(bm, S)
    my_blocks = _stage_blocks(cparams["blocks"], stage, per)
    head = (params["embed"] if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.cdtype)
    first = torch.tensor(stage == 0, device=dev)
    last = stage == n_stages - 1

    def stage_apply(x):
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(per):
            sb = sharding.tree_map(lambda a: a[j], my_blocks)
            x, aux_d, _ = superblock_apply(sb, x, cfg, None, positions,
                                           mode="train")
            aux = aux + aux_d
        return x, aux

    buf = torch.zeros((bm, S, cfg.d_model), dtype=cfg.cdtype, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    num, den, aux_sum = zero, zero, zero
    for t in range(M + n_stages - 1):
        m_in = min(t, M - 1)
        x0 = layers.embed(mb["tokens"][m_in],
                          cparams["embed"]).to(cfg.cdtype)
        y, aux_t = stage_apply(torch.where(first, x0, buf))
        m_out = t - (n_stages - 1)
        if last and 0 <= m_out < M:
            h = layers.rms_norm(y, cparams["final_norm"], cfg.norm_eps)
            lse, ll = label_logprob_terms(layers.unembed(h, head),
                                          mb["labels"][m_out])
            w = mb.get("loss_weight")
            w = (torch.ones((bm, S), dtype=torch.float32, device=dev)
                 if w is None else w[m_out].float())
            num = num + torch.sum((lse - ll) * w)
            den = den + torch.sum(w)
        # every stage adds its superblocks' aux once per REAL microbatch
        # it processed (ticks stage .. stage + M - 1)
        if 0 <= t - stage < M:
            aux_sum = aux_sum + aux_t
        buf = sharding.ppermute(y, mesh, axis, 1)
    # tie the last hand-off into the loss (a zero cotangent) so that
    # every rank's backward reaches every hand-off: a stage whose loss
    # terms are all zero still has to pass its cotangents back
    num = sharding.global_sum(_Tie.apply(num, buf), mesh, axis)
    den = sharding.psum(den.detach(), mesh, axis)
    aux = sharding.global_sum(aux_sum, mesh, axis) / M
    loss = num / torch.clamp(den, min=1.0)
    return loss + aux, {"loss": loss, "aux": aux}


class _Tie(torch.autograd.Function):
    """``x`` as it is; its backward also hands ``dep`` a zero cotangent."""

    @staticmethod
    def forward(fctx, x, dep):
        fctx.like = (dep.shape, dep.dtype, dep.device)
        return x.clone()

    @staticmethod
    def backward(fctx, g):
        shape, dtype, device = fctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


@torch.no_grad()
def reduce_stage_grads(grads, ctx, pcfg: PipelineConfig):
    """The whole gradient from each rank's stage share: a ``psum`` over
    the pipeline axis, leaves packed into one buffer."""
    leaves: list = []
    sharding.tree_map(leaves.append, grads)
    flat = sharding.psum(torch.cat([g.reshape(-1).float() for g in leaves]),
                         ctx.mesh, pcfg.axis)
    out, off = [], 0
    for g in leaves:
        out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    it = iter(out)
    return sharding.tree_map(lambda _: next(it), grads)
