"""Serving engine: the dense prefill and decode steps, and the fixed-slot
server wrapper over the paged scheduler.

Port of ``repro``'s ``serve/engine.py``: :class:`ServeConfig`,
:func:`jit_decode_step` and :func:`jit_prefill` (the reference's names, so
a reader finds the counterpart; they return EAGER callables — no
``torch.compile``, no donation: the dense cache leaves are updated in
place) and :class:`BatchedServer` over
:class:`repro_torch.serve.scheduler.Scheduler`.  :func:`cache_specs` and
:func:`serve_param_shardings` are the reference's placement rules
(``None`` without a mesh).  With a mesh every step is one SPMD program
on each rank, the weights placed by :func:`serve_param_shardings` and
gathered a layer at a time: :func:`jit_decode_step` serves long-context
decode (``ServeConfig.long_context``: the cache sequence axis sharded
over the context's sequence axes) or, without ``long_context``, the
batch-sharded step (each rank its block of the batch over the data axes,
the KV leaves per :func:`cache_specs`: its block of the KV heads over
the model axis, attended head-parallel, or of the sequence, attended by
the distributed softmax); :func:`jit_prefill` runs the mesh forward
(``models/transformer.forward``: each rank its batch block, the
recurrent states returned placed as :func:`step_specs` says).
``BatchedServer`` with a mesh runs the paged scheduler on every rank,
unsharded, as the reference's does (its scheduler takes no mesh).
:func:`make_fleet` puts N scheduler replicas behind the
fleet router (``serve/fleet.py``).  An encoder config (whisper) takes
the dense steps: :func:`jit_prefill` runs its forward (the batch carries
``audio_frames``), and :func:`jit_decode_step` runs
``models/encdec.decode_step`` over a cache whose ``enc_kv`` the caller
filled with ``encdec.precompute_enc_kv``, with or without a mesh;
``BatchedServer`` refuses it, as the paged scheduler does.  Serving runs
under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import vx
from repro_torch.device import resolve as resolve_device
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P
from repro_torch.models import decode as dec
from repro_torch.models.transformer import (STATE_BLOCK_DIMS, ModelConfig,
                                            check_supported, forward,
                                            rank_ctx, tp_on)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    cache_dtype: str = "bfloat16"
    long_context: bool = False     # sequence-parallel KV sharding (dist)
    # Whole-step access fusion (core/accessfuse.py): one fused KV split
    # per decode step.  Costs one transient cache-sized pre-split copy;
    # set False when the cache is the memory ceiling.
    step_fusion: bool = True


def cache_specs(cfg: ModelConfig, ctx, scfg: ServeConfig, cache_template):
    """Tree of P for the cache (the reference's rules); ``None`` without a
    mesh.

    * long-context (B=1): each ``(NS, B, S, K, 2D)`` KV leaf shards its
      sequence over every sequence axis when they divide it, else
      replicates;
    * otherwise: batch over the data axes, the KV heads over the model
      axis when it divides them, else the sequence over it;
    * ``len`` replicates; a recurrent state ``(NS, B, inner...)`` puts
      the batch over the data axes and its first inner dim the model
      axis divides over it."""
    if ctx is None or ctx.mesh is None:
        return None

    batch_axes = ctx.data_axes if ctx.data_axes else None

    def spec_for(path: str, leaf) -> P:
        if path.endswith("len"):
            return P()
        if scfg.long_context and leaf.ndim == 5:
            # (NS, B, S, K, 2D): B=1 — shard the sequence over every axis
            axes = ctx.seq_axes or (ctx.data_axes
                                    + ((ctx.model_axis,)
                                       if ctx.model_axis else ()))
            if axes and leaf.shape[2] % sharding.axes_size(ctx.mesh,
                                                           axes) == 0:
                return P(None, None, axes)
            return P()
        if leaf.ndim == 5:  # (NS, B, S, K, 2D)
            k, s = leaf.shape[3], leaf.shape[2]
            if ctx.model_axis and k % ctx.model_size == 0:
                return P(None, batch_axes, None, ctx.model_axis)
            if ctx.model_axis and s % ctx.model_size == 0:
                return P(None, batch_axes, ctx.model_axis)  # seq-sharded
            return P(None, batch_axes)
        # (NS, B, inner...) recurrent state
        parts = [None, batch_axes] + [None] * (leaf.ndim - 2)
        if ctx.model_axis:
            for i in range(2, leaf.ndim):
                if leaf.shape[i] % ctx.model_size == 0 and \
                        leaf.shape[i] >= ctx.model_size:
                    parts[i] = ctx.model_axis
                    break
        return P(*parts)

    return sharding.tree_paths(cache_template, spec_for)


def step_specs(cfg: ModelConfig, ctx, scfg: ServeConfig, cache_template):
    """The placement a mesh decode step keeps its cache in (``None``
    without a mesh): :func:`cache_specs`, except that a recurrent state
    whose mixer steps it whole (the xLSTM cells, whose weights stay whole
    under tensor parallelism) stays whole over the model axis.  Placed as
    the reference places it, such a state would be gathered before every
    step and cut back after it, buying only its memory; Mamba steps the
    rank's block of its channels (``transformer.STATE_BLOCK_DIMS``), as
    :func:`cache_specs` places it."""
    specs = cache_specs(cfg, ctx, scfg, cache_template)
    if specs is None or not ctx.model_axis:
        return specs

    def whole(sp):
        return P(*(None if a == ctx.model_axis else a for a in sp))

    return {**specs, "blocks": {
        k: sharding.map_specs(whole, v)
        if cfg.block_pattern[int(k[3:])] not in ("attn", *STATE_BLOCK_DIMS)
        else v for k, v in specs["blocks"].items()}}


def serve_param_shardings(params_template, cfg: ModelConfig, ctx):
    """The weights' placement, a tree of ``dist.sharding.Sharding`` (the
    reference's ``tree_param_specs`` rules on ``ctx``'s mesh); ``None``
    without a mesh."""
    if ctx is None or ctx.mesh is None:
        return None
    return sharding.spec_tree_shardings(
        sharding.tree_param_specs(params_template, ctx), ctx)


def jit_decode_step(cfg: ModelConfig, ctx, scfg: ServeConfig,
                    params_template=None, cache_template=None, *,
                    param_ctx=None, device=None):
    """``serve_step(params, cache, token) -> (logits, cache)``: one dense
    decode step (:func:`repro_torch.models.decode.decode_step`, fused per
    ``scfg.step_fusion``), eager.  ``token`` is moved to ``device`` (the
    port's rule: cuda unless the caller asks for the CPU).

    With a mesh and ``scfg.long_context`` each rank runs the step (one
    SPMD program): the params are placed as :func:`serve_param_shardings`
    says on ``param_ctx or ctx`` (the templates', else the first call's
    tree) and gathered a layer at a time as the layer runs, the KV leaves
    as :func:`cache_specs` says, and the step runs with ``kv_shard =
    ctx.vx_seq_shard(-3)``.  A leaf already placed so is taken as it is;
    place the weights once (``dist.sharding.place_tree``) to keep only
    their blocks resident.  The logits come back whole on every rank.
    Recurrent state leaves are placed as :func:`step_specs` says: Mamba's
    as :func:`cache_specs` says (its channels over the model axis; it
    steps the rank's block, channel-parallel), the xLSTM cells' on their
    batch only (they step whole state on whole weights).

    With a mesh and without ``scfg.long_context`` (the batch-sharded
    step) each rank steps its block of the batch over the data axes: the
    token and the cache leaves (:func:`step_specs`, the recurrent states
    among them) are its blocks, the logits come back placed on the
    batch.  KV leaves whose heads the
    model axis splits are attended head-parallel (each rank its heads,
    the heads' outputs gathered), those whose sequence it splits by the
    distributed softmax over the model axis.  The fused split then runs
    on the rank's block: one B1 launch per step under ``kernel``.  A MoE
    layer keeps each rank's block of experts resident and runs
    expert-parallel on the rank's batch block (``models/moe.py``).

    An encoder config (whisper) runs ``models/encdec.decode_step`` the
    same ways: its self-attention ring and ``enc_kv`` are placed alike by
    :func:`cache_specs` (long-context: each on its sequence over every
    axis that divides it; batch-sharded: the batch, then the heads or
    the sequence over the model axis), ``qkv_project``'s split and
    re-pack on the rank's block, its weights gathered a layer at a time.
    Without a mesh the templates are unused."""
    meshed = sharding.meshed(ctx)
    check_supported(cfg)
    device = resolve_device(device)
    # one-time host compile of the FIELD=2 segment plans the fused KV
    # split consults (nothing under impl="ref")
    vx.warm(2 * cfg.hd, strided=False, fields=(2,), policy=cfg.vx_policy)
    fuse = scfg.step_fusion
    kv_shard = (ctx.vx_seq_shard(-3)
                if ctx is not None and scfg.long_context else None)
    placed = {}

    def placements(params, cache):
        if not placed:
            placed["params"] = serve_param_shardings(
                params_template if params_template is not None else params,
                cfg, param_ctx or ctx)
            placed["cache"] = sharding.spec_tree_shardings(step_specs(
                cfg, ctx, scfg, cache_template if cache_template is not None
                else cache), ctx)
        return placed["params"], placed["cache"]

    @torch.no_grad()
    def serve_step(params, cache, token):
        if meshed:
            psh, csh = placements(params, cache)
            params = sharding.place_tree(params, psh)
            cache = sharding.place_tree(cache, csh)
            if not scfg.long_context:
                return _batch_sharded_step(params, cache, token.to(device),
                                           cfg, ctx, fuse)
        # an encoder config dispatches to encdec.decode_step in there;
        # a decoder's layers run tensor-parallel on the mesh
        step_ctx = rank_ctx(ctx, cfg, 1) if tp_on(cfg, ctx) else ctx
        return dec.decode_step(params, cache, token.to(device), cfg,
                               step_ctx, fuse=fuse, kv_shard=kv_shard)

    return serve_step


def _batch_sharded_step(params, cache: dict, token, cfg: ModelConfig, ctx,
                        fuse: bool):
    """One decode step on this rank's block of the batch (the cache placed
    per :func:`cache_specs`); returns the logits placed on the batch and
    the cache, its leaves updated in place."""
    from repro_torch.dist.sharding import block_of, spec_of
    mesh, m_ax = ctx.mesh, ctx.model_axis
    shards = {}

    def rank_block(leaf):
        """A KV leaf's block: head-parallel, a DTensor on the model
        axis's submesh (sequence-split) or plain (batch only)."""
        local = block_of(leaf)
        spec = sharding._norm(spec_of(leaf), 5) \
            if sharding.is_dtensor(leaf) else (None,) * 5
        if m_ax is not None and spec[3] == m_ax:
            shards["head"] = vx.Shard(axes=(m_ax,), axis=-2, mesh=mesh)
        elif m_ax is not None and spec[2] == m_ax:
            sub = _model_submesh(mesh, m_ax)
            shards["kv"] = vx.Shard(axes=(m_ax,), axis=-3, mesh=sub)
            local = sharding.from_local(local, sub, P(None, None, m_ax))
        return local

    # a recurrent state goes as it is placed: the step reads its batch
    # dim as the rank's block (models/decode._state_in)
    blocks = {k: rank_block(leaf) if isinstance(leaf, torch.Tensor)
              and leaf.ndim == 5 else leaf
              for k, leaf in cache["blocks"].items()}
    local = {"len": cache["len"], "blocks": blocks}
    if "enc_kv" in cache:
        local["enc_kv"] = rank_block(cache["enc_kv"])
    tok = sharding.local_block(token, mesh, ctx.batch_spec())
    logits, new = dec.decode_step(
        params, local, tok, cfg, rank_ctx(ctx, cfg, 1),
        fuse=fuse, kv_shard=shards.get("kv"), head_shard=shards.get("head"))
    out = {"len": new["len"], "blocks": cache["blocks"]}
    if "enc_kv" in cache:
        out["enc_kv"] = cache["enc_kv"]
    return sharding.from_local(logits, mesh, ctx.batch_spec()), out


_SUBMESHES: dict = {}


def _model_submesh(mesh, axis: str):
    """The 1-D mesh of this rank's model-axis group (the ranks of its
    data block), one per mesh object (a mesh equal to an earlier one but
    built on a newer process group gets its own)."""
    key = (mesh, axis)
    hit = _SUBMESHES.get(key)
    if hit is None or hit[0] is not mesh:
        hit = _SUBMESHES[key] = (mesh, mesh[axis])
    return hit[1]


def jit_prefill(cfg: ModelConfig, ctx, params_template=None,
                batch_template=None, *, param_ctx=None, device=None):
    """``prefill(params, batch) -> (logits (B, 1, V), cache_states)``:
    :func:`repro_torch.models.transformer.forward` in ``prefill`` mode,
    eager.  The batch's tensors (``tokens``, and ``audio_frames`` or
    ``patch_embeds`` where the config takes them) are moved to
    ``device``.

    With a mesh the params are placed as :func:`serve_param_shardings`
    says on ``param_ctx or ctx`` (the template's, else the first call's
    tree; a leaf already so placed is taken as it is) and the mesh
    forward runs: each rank prefills its block of the batch over the
    data axes, and the logits and cache states come back placed on their
    batch, the recurrent states as :func:`step_specs` places them (the
    model layer places them: ``transformer._place_states``)."""
    check_supported(cfg)
    device = resolve_device(device)
    meshed = sharding.meshed(ctx)
    placed = {}

    @torch.no_grad()
    def prefill(params, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if meshed:
            if not placed:
                placed["params"] = serve_param_shardings(
                    params_template if params_template is not None
                    else params, cfg, param_ctx or ctx)
            params = sharding.place_tree(params, placed["params"])
        logits, _, cache_states = forward(params, batch, cfg, ctx,
                                          mode="prefill")
        return logits, cache_states

    return prefill


class BatchedServer:
    """Fixed-slot continuous batching — thin wrapper over
    :class:`repro_torch.serve.scheduler.Scheduler` (the paged runtime:
    per-slot positions, a shared page pool per layer, reclamation on
    ``finish``, multi-token prompts through chunked prefill, optional
    temperature / top-k sampling).  The single-token ``add_request(int)``
    / ``step()`` / ``finish()`` surface is the reference's; ``cache`` is
    presented in the legacy ``{"len", "blocks"}`` shape with ``len`` = the
    furthest active position.  ``device`` follows the port's rule.
    With ``ctx`` on a mesh every rank runs this same scheduler, unsharded:
    the reference's ``BatchedServer`` keeps its ``ctx`` and hands its
    scheduler none."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_len: int,
                 ctx=None, cache_dtype=torch.float32, fuse_step: bool = True,
                 page_size: int | None = None, num_pages: int | None = None,
                 temperature: float = 0.0, top_k: int | None = None,
                 seed: int = 0, device=None, **lifecycle_kw):
        from repro_torch.serve.scheduler import Scheduler
        self.cfg, self.params = cfg, params
        self.slots, self.max_len, self.ctx = slots, max_len, ctx
        # lifecycle_kw passes the runtime knobs through unchanged
        # (queue_depth / preemption / guard_nan / watchdog /
        # debug_invariants / clock,
        # the prefix_cache / chunk_pages prefill knobs, the kv_quant
        # quantized-pool selector and the speculate / draft_cfg /
        # draft_params speculation knobs; see serve/scheduler.py)
        self.scheduler = Scheduler(
            cfg, params, slots=slots, max_len=max_len, page_size=page_size,
            num_pages=num_pages, cache_dtype=cache_dtype,
            fuse_step=fuse_step, temperature=temperature, top_k=top_k,
            seed=seed, device=device, **lifecycle_kw)

    @property
    def active(self) -> list:
        return self.scheduler.active

    @property
    def tokens(self) -> list:
        return self.scheduler.tokens

    @property
    def cache(self) -> dict:
        st = self.scheduler.cache.state
        return {"len": torch.max(st["pos"]), "blocks": st["blocks"]}

    def add_request(self, prompt_token=None, *, prompt=None) -> int:
        """Admit a request: a single first token (legacy form) or a full
        prompt list (prefilled to completion)."""
        req = prompt if prompt is not None else prompt_token
        if req is None:
            raise ValueError("pass a prompt token or prompt= list")
        return self.scheduler.add_request(req)

    def step(self) -> list[int]:
        """Advance every active slot one token."""
        return self.scheduler.step()

    def submit(self, prompt, **kw):
        """Queue a typed request (lifecycle surface — see Scheduler)."""
        return self.scheduler.submit(prompt, **kw)

    def tick(self):
        """One lifecycle iteration: admit / step / retire."""
        return self.scheduler.tick()

    def finish(self, slot: int) -> list[int]:
        """Release the slot (pages reclaimed, per-slot state cleared)."""
        return self.scheduler.finish(slot)


def make_fleet(cfg: ModelConfig, params, *, replicas: int, slots: int,
               max_len: int, **fleet_kw):
    """N scheduler replicas behind the health-checked fleet router — the
    multi-replica counterpart of :class:`BatchedServer`.  Each replica is a
    full :class:`~repro_torch.serve.scheduler.Scheduler` (own page pool,
    own admission queue) over ONE copy of the weights; the router does
    least-loaded admission, heartbeat / watchdog health tracking and
    replay-based failover (``serve/fleet.py``).  A ``replicas=1`` fleet is
    exactly one ``BatchedServer.scheduler`` behind a router.  ``device``
    (in ``fleet_kw``) follows the port's rule."""
    from repro_torch.serve.fleet import FleetRouter
    return FleetRouter(cfg, params, replicas=replicas, slots=slots,
                       max_len=max_len, **fleet_kw)
