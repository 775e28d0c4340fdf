"""Single-token decode over the interleaved KV cache: the dense cache and
the paged one (the serving step body).

Port of ``repro``'s ``models/decode.py`` for decoders of attention, Mamba
and xLSTM blocks.  The dense cache: ``cache_len_for_pos``, ``init_cache``,
``cache_from_prefill`` and ``decode_step`` (``fuse=True`` and
``fuse=False``), the oracle the paged step is held against.  The paged
cache: ``init_paged_cache`` (float pools, or int8 / fp8 pools with
per-page scales), ``paged_prefill_chunk``, ``paged_decode_step``
(``fuse=True`` and ``fuse=False``), ``paged_release_slot``,
``paged_insert_prefill``, ``paged_invariants``, and prefix sharing:
``paged_adopt_prefix``, ``paged_addref``, ``paged_deref_pages`` and the
copy-on-write ``paged_fork_page``; speculative decode: the K-token
``paged_verify_step`` and the draft pool's ``paged_truncate``.

Dense layout (EARTH): each attention layer stores K and V interleaved along
features, ``(NS, B, Sc, K, 2D)``; appending a token is one beat write per
layer at ``pos % Sc`` (sliding-window layers keep a ring of ``Sc = W``
beats), and ``cache["len"]`` is one position for the whole batch.

Paged layout (EARTH): each attention layer's pool stores K and V
interleaved along features, ``(NS, P, page_size, K, 2D)``; ``table`` maps
each slot's logical pages to physical pages (``-1`` = unallocated),
``pos`` holds per-slot positions, ``free[:free_top]`` is the device free
stack and ``ref`` the per-page reference count.  The page allocators match
the reference bit for bit: cumsum ranks, pops from the free stack, and
masked (never wrapped) out-of-range updates.  A QUANTIZED pool stores
int8 / fp8 pages, and each attention layer's pool ``pos{i}`` has a
float32 scale side tensor ``scl{i}`` ``(NS, P, K)`` beside it: a page's
scale travels with its id through adoption and forks.

Recurrent positions (``mamba``, ``mlstm``, ``slstm``) carry O(1) state
instead of KV beats: the NamedTuples of models/ssm.py and models/xlstm.py,
each leaf ``(NS, B or slots, ...)``, the Mamba conv window in the cache
dtype and every other leaf float32.  The paged cache keeps them per slot
beside the pools (pools exist only at attention positions; a stack without
attention has page size 1 and nothing to page); the prefill chunk and the
verify step advance them token by token with pad tokens gated out, and the
verify step keeps the state after ``commit`` tokens.

Superblocks run in a Python loop over the stacked ``(NS, ...)`` leaves in
place of ``lax.scan``.  Dense cache leaves, page pools and recurrent
states are updated IN PLACE (the reference donates the cache to its jit'd
step), so a step consumes the cache it is given; the small integer state
is rebuilt.

An encoder config (whisper) takes the dense step only: :func:`decode_step`
dispatches to ``models/encdec.decode_step``, and the paged steps raise the
reference's ``NotImplementedError``.

Sharded serving (one SPMD program over the ranks of a ``DeviceMesh``):
:func:`decode_step` takes ``kv_shard``, a ``vx.Shard`` on the cache's
sequence axis (long-context serving), and :func:`paged_decode_step` /
:func:`paged_verify_step` take ``pool_shard``, a ``vx.Shard`` on the
pools' page axis.  Each rank keeps its block of a sharded leaf (a
``DTensor``); the fused split and the page gathers run on the blocks
(vx/lower.py), a beat is written only by the rank that owns its position
or page, and attention over a sequence-sharded cache is a distributed
softmax (``attention.decode_attention``).  Weights placed as ``DTensor``
s are gathered a layer at a time, when the layer runs
(``transformer.superblock``); under tensor parallelism a recurrent
state ``DTensor`` placed as ``serve/engine.cache_specs`` says is stepped
on the rank's block of Mamba's channels or of the xLSTM cells' heads (a
state placed otherwise, as on a mesh whose model axis does not divide the
heads, is gathered for the step and cut back).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import vx
from repro_torch.core import quant
from repro_torch.device import resolve as resolve_device
from repro_torch.dist import sharding
from repro_torch.kernels import kv_interleaved
from repro_torch.kernels._common import tree_leaves
from repro_torch.models import attention, layers
from repro_torch.models.ssm import init_mamba_cache, mamba_decode_step
from repro_torch.models.transformer import (STATE_BLOCK_DIMS, ModelConfig,
                                            _ffn_apply, _mixer_params,
                                            cast_params, check_supported,
                                            recurrent_blocks,
                                            recurrent_partial, superblock,
                                            tp_specs, tree_map)
from repro_torch.models.xlstm import (init_mlstm_state, init_slstm_state,
                                      mlstm_decode_step, slstm_decode_step)

I32 = torch.int32


def _recurrent_init(cfg: ModelConfig, kind: str, batch: int, dtype,
                    device):
    """A recurrent position's initial state for ``batch`` rows (the Mamba
    conv window in ``dtype``, every other leaf float32)."""
    if kind == "mamba":
        return init_mamba_cache(batch, cfg.mamba, dtype, device)
    if kind == "mlstm":
        return init_mlstm_state(batch, cfg.xlstm, device)
    return init_slstm_state(batch, cfg.xlstm, device)


def _stacked_init(cfg: ModelConfig, kind: str, batch: int, dtype, device):
    """The initial state broadcast over superblocks, ``(NS, batch, ...)``."""
    ns = cfg.n_superblocks
    return tree_map(lambda a: a.expand((ns,) + a.shape).clone(),
                    _recurrent_init(cfg, kind, batch, dtype, device))


def _recurrent_step(p, h: torch.Tensor, state, cfg: ModelConfig,
                    kind: str, tp=None):
    """(y, state) of one token through a recurrent position's block; with
    ``tp`` (the weights this rank's blocks) the rank's ``y``
    (``transformer.recurrent_partial``) and its block of the state."""
    pm = _mixer_params(p, cfg, kind)
    if kind == "mamba":
        return mamba_decode_step(pm, h, state, cfg.mamba, tp)
    if kind == "mlstm":
        return mlstm_decode_step(pm, h, state, cfg.xlstm, tp)
    return slstm_decode_step(pm, h, state, cfg.xlstm, tp)


def _placed(x, rl):
    """``(local, spec, model, other)`` of a superblock's state field: its
    block and spec, the dims after the batch (dim 0, whose placement is
    the rank's block of the batch) the model axis shards, and those other
    axes shard; a plain tensor is whole."""
    if not sharding.is_dtensor(x):
        return x, (None,) * x.ndim, [], []
    spec = sharding._norm(sharding.spec_of(x), x.ndim)
    axis = getattr(rl, "tp_axis", None)
    model = [d for d in range(1, x.ndim) if axis and spec[d] == axis]
    other = [d for d in range(1, x.ndim)
             if spec[d] is not None and d not in model]
    return x.to_local(), spec, model, other


def _state_in(x, need, rl):
    """One field of a superblock's recurrent state, placed as
    ``serve/engine.cache_specs`` says (a ``DTensor``: the batch dim the
    rank's block, the dims after it as placed; or a plain tensor every
    rank holds whole), in the layout its mixer takes: whole after the batch
    (``need`` None), or this rank's block along dim ``need`` over the
    model axis (a block the placement already holds there as it is, else
    gathered and cut; or re-laid by one ``all_to_all``, when the model axis
    places it on one other dim: the mLSTM's ``C``, which ``cache_specs``
    places on its first ``dh`` dim)."""
    local, spec, model, other = _placed(x, rl)
    if need is not None and model == [need] and not other:
        return local
    if need is not None and len(model) == 1 and not other:
        return sharding.reshard(local, rl.tp.mesh, rl.tp_axis, model[0],
                                need)
    for d in model + other:
        local = sharding.all_gather(local, x.device_mesh, spec[d], d)
    return local if need is None else sharding.tp_block(local, rl, need)


def _state_out(x, new, need, rl) -> None:
    """Write ``new`` (the mixer's layout, as :func:`_state_in` gave it)
    back into the field ``x`` as it is placed, in place (cast to its
    dtype)."""
    local, spec, model, other = _placed(x, rl)
    if need is not None and model == [need] and not other:
        local.copy_(new)
        return
    if need is not None and len(model) == 1 and not other:
        local.copy_(sharding.reshard(new, rl.tp.mesh, rl.tp_axis, need,
                                     model[0]))
        return
    if need is not None:
        new = sharding.all_gather(new, rl.tp.mesh, rl.tp_axis, need)
    if model or other:
        new = sharding.local_block(new, x.device_mesh,
                                   sharding.P(None, *spec[1:]))
    local.copy_(new)


def _recurrent_position(p, h, leaf, sbi: int, cfg: ModelConfig, kind: str,
                        rl) -> torch.Tensor:
    """One token through superblock ``sbi``'s recurrent position, its
    state ``leaf`` updated in place; returns the block's output.  Under
    tensor parallelism with the weights this rank's blocks (Mamba's, the
    xLSTM cells' where the model axis divides their heads) the mixer runs
    on the rank's block of the state (:func:`_state_in` /
    :func:`_state_out` cut it from and write it back to its placement)
    and its partial output is summed over the model axis and rounded
    once; on whole weights the state is whole."""
    block = getattr(rl, "tp", None) is not None and \
        recurrent_blocks(p, cfg, kind)
    dims = STATE_BLOCK_DIMS[kind] if block else None
    fields = tree_map(lambda a: sharding.select(a, sbi), leaf)
    needs = dims if dims is not None else (None,) * len(fields)
    st = type(fields)(*(_state_in(x, n, rl)
                        for x, n in zip(fields, needs)))
    y, st = _recurrent_step(p, h, st, cfg, kind, rl if block else None)
    for x, new, n in zip(fields, st, needs):
        _state_out(x, new, n, rl)
    if block and recurrent_partial(p, cfg, kind):
        y = sharding.tp_leave(y, rl)
    return y.to(h.dtype)


def _keep_active(new, old, active: torch.Tensor):
    """Per-slot state gate: inactive slots keep their old state."""
    def sel(n, o):
        return torch.where(active.reshape(active.shape + (1,) * (n.ndim - 1)),
                           n, o)
    return tree_map(sel, new, old)


def _sb_state(leaf, sbi: int):
    """Superblock ``sbi``'s slice of a stacked recurrent state."""
    return tree_map(lambda a: a[sbi], leaf)


def _set_state(leaf, index, state) -> None:
    """Write ``state`` into the stacked recurrent ``leaf`` at ``index`` in
    place (cast to each leaf's dtype), as the pools are written."""
    tree_map(lambda c, s: c[index].copy_(s), leaf, state)


def _refuse_encoder(cfg: ModelConfig) -> None:
    """The paged steps serve decoders only, as in the reference."""
    if cfg.encoder is not None:
        raise NotImplementedError("paged serving covers decoder-only "
                                  "models; use encdec.decode_step")


def cache_len_for_pos(cfg: ModelConfig, i: int, max_len: int) -> int:
    w = cfg.window_pattern[i]
    return min(w, max_len) if w is not None else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None) -> dict:
    """Empty dense cache: ``{"len": 0-dim int32, "blocks": {"pos{i}":
    (NS, batch, Sc, K, 2D)}}`` at attention positions and the initial
    recurrent state broadcast over superblocks at the others."""
    check_supported(cfg)
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    ns = cfg.n_superblocks
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        blocks[f"pos{i}"] = (torch.zeros(
            (ns, batch, cache_len_for_pos(cfg, i, max_len), cfg.n_kv_heads,
             2 * cfg.hd), dtype=dtype, device=device) if kind == "attn"
            else _stacked_init(cfg, kind, batch, dtype, device))
    return {"len": torch.zeros((), dtype=I32, device=device),
            "blocks": blocks}


def cache_from_prefill(cfg: ModelConfig, cache_states, seq_len: int,
                       max_len: int, dtype=torch.float32) -> dict:
    """Embed prefill states ``{"pos{i}": (NS, B, S or W, K, 2D)}`` into a
    fresh ``max_len`` dense cache: zero-padded, or trimmed, to each
    layer's ``Sc`` beats; recurrent states are copied through (the steps
    update them in place)."""
    check_supported(cfg)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        st = cache_states[f"pos{i}"]
        if kind != "attn":
            blocks[f"pos{i}"] = tree_map(torch.clone, st)
            continue
        sc = cache_len_for_pos(cfg, i, max_len)
        kv = torch.zeros(st.shape[:2] + (sc,) + st.shape[3:], dtype=dtype,
                         device=st.device)
        n = min(sc, st.shape[2])
        kv[:, :, :n] = st[:, :, :n]
        blocks[f"pos{i}"] = kv
    return {"len": torch.tensor(seq_len, dtype=I32,
                                device=tree_leaves(blocks)[0].device),
            "blocks": blocks}


def _whole(params: dict, ctx=None) -> dict:
    """``params`` with every leaf outside ``blocks`` gathered whole (the
    embedding, the final norm, the head), under tensor parallelism
    (``ctx.tp``) the embedding's and head's vocab blocks kept
    (``transformer.tp_specs``); blocks stay placed and gather a layer at
    a time (``transformer.superblock``)."""
    tp = getattr(ctx, "tp", None)
    top = {k: v for k, v in params.items() if k != "blocks"}
    if tp is None:
        top = {k: sharding.tree_map(sharding.full_tensor, v)
               for k, v in top.items()}
    else:
        local, specs = sharding.split_tree(top)
        top = sharding.gather_tree(local, tp_specs(local, specs, tp),
                                   tp.mesh)
    return {**top, "blocks": params["blocks"]}


def _tp_logits(x, head, cfg: ModelConfig, ctx) -> torch.Tensor:
    """The logits (B, V): under tensor parallelism from this rank's vocab
    block of the head, gathered over the model axis."""
    logits = layers.unembed(x, head.to(cfg.cdtype))
    if head.shape[0] != cfg.vocab:
        logits = sharding.all_gather(logits, ctx.tp.mesh, ctx.tp_axis, -1)
    return logits


def _tp_embed(token, params, cfg: ModelConfig, ctx) -> torch.Tensor:
    """The embedded tokens: under tensor parallelism from this rank's
    vocab block, a partial summed over the model axis."""
    table = params["embed"]
    if table.shape[0] == cfg.vocab:
        return layers.embed(token, table).to(cfg.cdtype)
    x = layers.embed_block(token, table,
                           ctx.tp_index * table.shape[0]).to(cfg.cdtype)
    return sharding.tp_leave(x, ctx)


def _owner_write(buf: torch.Tensor, at: torch.Tensor,
                 beat: torch.Tensor) -> None:
    """``buf[:, at] = beat`` where ``0 <= at < buf.shape[1]`` (this rank
    owns the position), else nothing; ``at`` a 0-dim tensor, no host
    sync: a rank that does not own it writes its own values back."""
    n = buf.shape[1]
    idx = at.clamp(0, n - 1).reshape(1).long()
    own = (at >= 0) & (at < n)
    buf.index_copy_(1, idx, torch.where(own, beat.to(buf.dtype),
                                        buf.index_select(1, idx)))


def _head_block(t: torch.Tensor, heads, n: int) -> torch.Tensor:
    """This rank's block of ``n`` heads (dim 2 of ``(B, S, n, D)``)."""
    if heads is None:
        return t
    m = n // heads.nshards
    return t[:, :, heads.index() * m:(heads.index() + 1) * m]


def _dense_attn(p, h, x, blocks, pre_split, i: int, sbi: int, pos,
                positions, cfg: ModelConfig, pol, beat_pol, fuse: bool,
                shard, heads=None, rl=None):
    """One attention position of :func:`decode_step`: project, append the
    beat at ``pos % Sc`` (on a sequence-sharded leaf, ``shard`` set: only
    on the rank whose block holds the slot), split, attend; returns the
    new residual stream.  ``heads`` (a ``vx.Shard`` on the KV-head axis
    of the cache leaves, which then hold this rank's heads): the rank
    appends and attends with its block of the KV heads and their query
    heads, and the heads' outputs are gathered before ``wo``.  Under
    tensor parallelism (``rl.tp``, the layer's weights this rank's
    blocks) q, k and v come from ``attention.qkv_project_tp``: with
    ``heads`` the rank's own query and KV heads, else every head (the
    query columns gathered, the beat summed); the output leaves through
    the rank's ``wo`` rows, summed over the model axis."""
    B = x.shape[0]
    tp = getattr(rl, "tp", None) is not None and \
        p["attn"]["wo"].shape[0] != cfg.n_heads * cfg.hd
    if tp:
        q, k, v, kv = attention.qkv_project_tp(
            p["attn"], h[:, None], cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            positions, cfg.rope_theta, rl, policy=beat_pol,
            all_heads=heads is None)
    else:
        q, k, v, kv = attention.qkv_project(
            p["attn"], h[:, None], cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            positions, cfg.rope_theta, policy=beat_pol)
        q = _head_block(q, heads, cfg.n_heads)
        k, v, kv = (_head_block(t, heads, cfg.n_kv_heads)
                    for t in (k, v, kv))
    if shard is not None:
        lay = sharding.select(blocks[f"pos{i}"], sbi)     # (B, Sc, K, 2D)
        kvc, base, _ = sharding.owned_block(lay, 1)
        sc = lay.shape[1]
        at = torch.remainder(pos, sc) - base
        _owner_write(kvc, at, kv)
        if fuse:
            k_all, v_all = (sharding.select(t, sbi)
                            for t in pre_split[f"pos{i}"])
            _owner_write(sharding.owned_block(k_all, 1)[0], at, k)
            _owner_write(sharding.owned_block(v_all, 1)[0], at, v)
        else:
            k_all, v_all = vx.transpose(
                vx.Segment(n=lay.shape[-1], fields=2), lay, policy=pol,
                shard=shard)
    else:
        kvc = blocks[f"pos{i}"][sbi]                       # (B, Sc, K, 2D)
        sc = kvc.shape[1]
        slot = torch.remainder(pos, sc).reshape(1).long()
        kvc.index_copy_(1, slot, kv.to(kvc.dtype))
        if fuse:
            # the pre-split arrays are this step's own (under ``ref`` a
            # view of the cache, where the beat wrote the same bits)
            k_all, v_all = (t[sbi] for t in pre_split[f"pos{i}"])
            k_all.index_copy_(1, slot, k.to(kvc.dtype))
            v_all.index_copy_(1, slot, v.to(kvc.dtype))
        else:
            k_all, v_all = vx.transpose(
                vx.Segment(n=kvc.shape[-1], fields=2), kvc, policy=pol)
    eff_len = torch.clamp(pos + 1, max=sc)
    out = attention.decode_attention(q[:, 0], k_all, v_all, eff_len,
                                     window=None, shard=shard)
    if tp:
        wo = p["attn"]["wo"]
        o = attention.tp_rows(out.reshape(B, -1), wo, rl)
        # the parts in float32, rounded once after the sum
        return x + sharding.tp_leave(o.float() @ wo.float(), rl).to(x.dtype)
    if heads is not None:
        out = sharding.all_gather(out, heads.mesh, heads.axes, 1)
    return x + (out.reshape(B, cfg.n_heads * cfg.hd)
                @ p["attn"]["wo"]).to(x.dtype)


def decode_step(params, cache: dict, token: torch.Tensor, cfg: ModelConfig,
                ctx=None, *, fuse: bool | None = None, kv_shard=None,
                head_shard=None):
    """token: (B,) int.  Returns (logits (B, V), updated cache).

    ``fuse`` (default ``cfg.step_fusion``) is whole-step access fusion:
    every layer's cache split is hoisted to the top of the step (it reads
    the pre-append cache) and runs as ONE fused FIELD=2 segment load (one
    B1 launch under ``kernel``, one B6 under ``kernel_dynamic``); the
    current token's k and v are then written into the pre-split arrays at
    its slot, bit-exact with splitting the post-append cache.  The
    single-token beat pack and GLU split ride the plain path below the
    policy's fusion threshold.  ``fuse=False`` splits each layer's
    post-append cache on its own (the equivalence oracle).  The KV leaves
    and the recurrent states are updated in place; ``len`` is rebuilt.

    ``kv_shard`` (a ``vx.Shard`` with ``axis=-3``, the cache sequence
    axis) marks the KV leaves as sequence-sharded: a leaf whose sequence
    extent the shard divides is placed on the mesh (a ``DTensor`` placed
    so is kept; a plain one is sliced, and the returned cache holds the
    ``DTensor``), the fused split runs on each rank's block (one launch
    per rank), the token's k and v are written only by the rank whose
    block holds its slot, and attention is the distributed softmax.  The
    per-access arm splits each layer's block the same way, so the two
    arms agree bit for bit on one placement.  Leaves the shard does not
    divide stay replicated and split locally.  ``head_shard`` (a
    ``vx.Shard`` with ``axis=-2``, the caches' KV-head axis) marks the
    KV leaves as this rank's block of the heads (plain tensors): the step
    projects every head, keeps its block of the beat and of the query
    heads, splits and attends locally and gathers the heads' outputs
    (the batch-sharded serve step's model axis).  An encoder config runs
    :func:`models.encdec.decode_step` (its cache carries ``enc_kv``),
    which takes both shards alike."""
    check_supported(cfg)
    params = cast_params(params, cfg)
    if cfg.encoder is not None:
        from repro_torch.models import encdec
        return encdec.decode_step(params, cache, token, cfg, ctx,
                                  kv_shard=kv_shard, head_shard=head_shard)
    params = _whole(params, ctx)
    fuse = cfg.step_fusion if fuse is None else fuse
    pol = cfg.vx_policy
    B = token.shape[0]
    pos = cache["len"]
    x = _tp_embed(token, params, cfg, ctx)
    attn_pos = [i for i, k in enumerate(cfg.block_pattern) if k == "attn"]
    blocks = cache["blocks"]
    if kv_shard is not None and kv_shard.axis != -3:
        raise ValueError(f"kv_shard shards the cache's sequence axis: "
                         f"Shard.axis must be -3, got {kv_shard.axis}")
    sharded = [i for i in attn_pos if kv_shard is not None
               and kv_shard.divides(blocks[f"pos{i}"].shape[-3])]
    if sharded:
        blocks = dict(blocks)
        where = sharding.Sharding(kv_shard.mesh, sharding.P(
            None, None, kv_shard.axes))
        for i in sharded:
            blocks[f"pos{i}"] = sharding.place(blocks[f"pos{i}"], where)
    pre_split: dict[str, Any] = {}
    if fuse and attn_pos:
        # one fused split for the sharded leaves (shard-locally) and one
        # for the replicated ones
        local = [i for i in attn_pos if i not in sharded]
        splits = {}
        for group, shard in ((sharded, kv_shard), (local, None)):
            if group:
                outs = kv_interleaved.split_kv_step(
                    [blocks[f"pos{i}"] for i in group], policy=pol,
                    shard=shard)
                splits.update(zip(group, outs))
        pre_split = {f"pos{i}": splits[i] for i in attn_pos}
    beat_pol = (pol.for_elems(B * cfg.n_kv_heads * 2 * cfg.hd)
                if fuse else pol)
    ffn_pol = pol.for_elems(B * 2 * cfg.d_ff) if fuse else pol
    positions = pos.expand(B, 1)

    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi, ctx)
        for i, kind in enumerate(cfg.block_pattern):
            p = sb_p[f"pos{i}"]
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            if kind != "attn":
                x = x + _recurrent_position(p, h, blocks[f"pos{i}"], sbi,
                                            cfg, kind, ctx)
            else:
                x = _dense_attn(p, h, x, blocks, pre_split, i, sbi, pos,
                                positions, cfg, pol, beat_pol, fuse,
                                kv_shard if i in sharded else None,
                                head_shard, ctx)
            if cfg.pos_has_ffn(i):
                x2, _ = _ffn_apply(p, x[:, None], cfg, ctx, i,
                                   policy=ffn_pol)
                x = x2[:, 0]

    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return _tp_logits(x, head, cfg, ctx), {"len": pos + 1, "blocks": blocks}


def pages_per_seq(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     page_size: int, dtype=torch.float32, *,
                     num_pages: int | None = None,
                     quantize: str | None = None, device=None) -> dict:
    """Paged cache: a shared page pool per attention layer, one page table,
    per-slot positions, the free-page stack and page refcounts.
    ``num_pages`` defaults to full provisioning (``slots *
    pages_per_seq``).  ``quantize`` ("int8" / "fp8") switches the pools to
    the QUANTIZED layout: each pool stores int8 / fp8 and gains a
    per-page, per-head float32 scale side tensor ``scl{i}`` of shape
    ``(NS, num_pages, K)`` in ``blocks``.  Recurrent positions hold
    per-slot O(1) state ``(NS, slots, ...)`` instead of a pool, in
    ``dtype`` (the Mamba conv window) or float32, also when the pools are
    quantized."""
    check_supported(cfg)
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    ns = cfg.n_superblocks
    n_seq = pages_per_seq(max_len, page_size)
    if num_pages is None:
        num_pages = slots * n_seq
    qdt = None if quantize is None else quant.pool_dtype(quantize)
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "attn":
            blocks[f"pos{i}"] = _stacked_init(cfg, kind, slots, dtype,
                                              device)
            continue
        blocks[f"pos{i}"] = torch.zeros(
            (ns, num_pages, page_size, cfg.n_kv_heads, 2 * cfg.hd),
            dtype=dtype if qdt is None else qdt, device=device)
        if qdt is not None:
            blocks[f"scl{i}"] = torch.zeros(
                (ns, num_pages, cfg.n_kv_heads), dtype=torch.float32,
                device=device)
    return {
        "pos": torch.zeros((slots,), dtype=I32, device=device),
        "table": torch.full((slots, n_seq), -1, dtype=I32, device=device),
        # descending so pages allocate in 0, 1, 2, ... order
        "free": torch.arange(num_pages - 1, -1, -1, dtype=I32,
                             device=device),
        "free_top": torch.tensor(num_pages, dtype=I32, device=device),
        "ref": torch.zeros((num_pages,), dtype=I32, device=device),
        "blocks": blocks,
    }


def _paged_geometry(cfg: ModelConfig, cache: dict):
    """(attn positions, page_size, pages_per_seq) from the cache leaves; a
    stack without attention has page size 1."""
    attn_pos = [i for i, k in enumerate(cfg.block_pattern) if k == "attn"]
    n_seq = cache["table"].shape[-1]
    ps = (cache["blocks"][f"pos{attn_pos[0]}"].shape[2] if attn_pos
          else 1)
    return attn_pos, ps, n_seq


def _pool_quantized(cache: dict, attn_pos) -> bool:
    """Quantized pool detection from the cache itself (the scale side
    tensors are present): every paged op switches on this, so a quantized
    cache flows through the scheduler unannotated."""
    return bool(attn_pos) and f"scl{attn_pos[0]}" in cache["blocks"]


def _reset_scales(cache: dict, attn_pos, ids: torch.Tensor,
                  on: torch.Tensor) -> None:
    """Fresh pages start at scale 0: a stale scale would poison the
    monotone widen's ``s_old`` (and the rescale would never zero the
    resident garbage).  Zeroes, in place, every layer's scale rows of the
    pages ``ids`` where ``on``, without a host sync."""
    P = cache["free"].shape[0]
    hit = torch.zeros((P,), dtype=I32, device=ids.device)
    hit.index_put_((torch.where(on, ids, 0).to(torch.int64),), on.to(I32),
                   accumulate=True)
    for i in attn_pos:
        # a scale DTensor sharded on its page axis resets its own block
        scl, base, n = sharding.owned_block(cache["blocks"][f"scl{i}"], 1)
        scl.masked_fill_((hit[base:base + n] > 0)[None, :, None], 0.0)


def _add_refs(ref: torch.Tensor, ids: torch.Tensor,
              on: torch.Tensor) -> torch.Tensor:
    """``ref.at[where(on, ids, P)].add(1, mode="drop")`` without a host
    sync: rows that are off add 0 at a safe index."""
    ref = ref.clone()
    safe = torch.where(on, ids, torch.zeros_like(ids)).to(torch.int64)
    ref.index_put_((safe,), on.to(I32), accumulate=True)
    return ref


def _pop_pages(free, free_top, need):
    """Rank-pop ``need`` (bool, flattened order) pages off the free stack.
    Returns (have, newp, free_top): exhaustion degrades locally — ranks past
    the free count get no page."""
    ni = need.to(I32)
    rank = torch.cumsum(ni, 0, dtype=I32) - ni
    have = need & (rank < free_top)
    P = free.shape[0]
    newp = free[torch.clamp(free_top - 1 - rank, 0, P - 1).to(torch.int64)]
    return have, newp, free_top - have.to(I32).sum(dtype=I32)


def paged_invariants(cfg: ModelConfig, cache: dict, *,
                     external_ref=None) -> list[str]:
    """Audit the paged cache's structural invariants (refcount
    conservation with the external pins ``external_ref``, the prefix
    trie's per-page counts; free-stack consistency, copy-on-write tails,
    pos-vs-table occupancy, bounds; for a QUANTIZED pool the scale
    liveness: every layer carries its ``scl{i}``, of the pool's geometry,
    finite and non-negative); returns violations (empty = healthy).  One
    host fetch of the small integer state, plus the scales when
    quantized."""
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    table, free, pos, ref = (cache[k].cpu().numpy()
                             for k in ("table", "free", "pos", "ref"))
    free_top = int(cache["free_top"])
    num_pages = free.shape[0]
    out: list[str] = []
    if not attn_pos:
        return out                      # recurrent-only: no pool to audit
    if not (0 <= free_top <= num_pages):
        out.append(f"free_top={free_top} outside [0, {num_pages}]")
        return out
    ext = (np.zeros(num_pages, np.int64) if external_ref is None
           else np.asarray(external_ref, np.int64))
    owned = table[table >= 0]
    if owned.size and (owned >= num_pages).any():
        out.append(f"table holds out-of-range page ids "
                   f"{sorted(set(owned[owned >= num_pages].tolist()))}")
        owned = owned[owned < num_pages]
    tc = np.bincount(owned, minlength=num_pages)
    if (ref < 0).any():
        out.append(f"page(s) {np.nonzero(ref < 0)[0].tolist()} hold "
                   f"negative refcounts (double release)")
    aliased = np.nonzero(tc > ref)[0]
    if aliased.size:
        out.append(f"page(s) {aliased.tolist()} aliased between slots "
                   f"(referenced {tc[aliased].tolist()} times, "
                   f"refcount {ref[aliased].tolist()})")
    bad_ref = np.nonzero((tc <= ref) & (ref != tc + ext))[0]
    if bad_ref.size:
        out.append(f"refcount conservation broken for page(s) "
                   f"{bad_ref.tolist()}: refcount {ref[bad_ref].tolist()} "
                   f"!= table refs {tc[bad_ref].tolist()} + external pins "
                   f"{ext[bad_ref].tolist()}")
    stack = free[:free_top]
    uniq_f = np.unique(stack)
    if uniq_f.size != stack.size:
        out.append("free stack holds duplicate page ids")
    both = uniq_f[(tc[uniq_f] > 0) | (ref[uniq_f] > 0)] \
        if uniq_f.size else uniq_f
    if both.size:
        out.append(f"page(s) {both.tolist()} both allocated and free")
    live = np.zeros(num_pages, bool)
    live[uniq_f] = True
    leaked = np.nonzero(~live & (ref == 0) & (tc == 0))[0]
    if leaked.size:
        out.append(f"page(s) {leaked.tolist()} leaked (refcount zero but "
                   f"not on the free stack)")
    for s in range(table.shape[0]):
        p = int(pos[s])
        if p % ps != 0 and 0 <= p <= n_seq * ps:
            tail = int(table[s, p // ps])
            if tail >= 0 and ref[tail] > 1:
                out.append(f"slot {s}: partial tail page {tail} is SHARED "
                           f"(ref={int(ref[tail])})")
    for s in range(table.shape[0]):
        alloc = np.nonzero(table[s] >= 0)[0]
        p = int(pos[s])
        if not (0 <= p <= n_seq * ps):
            out.append(f"slot {s}: pos={p} outside [0, {n_seq * ps}]")
            continue
        extent = -(-p // ps)
        if alloc.size > extent:
            out.append(f"slot {s}: owns {alloc.size} pages but pos={p} "
                       f"spans only {extent}")
        if alloc.size and alloc.max() >= extent:
            out.append(f"slot {s}: page at logical index "
                       f"{int(alloc.max())} beyond pos={p} extent {extent}")
    scl_layers = [i for i in attn_pos if f"scl{i}" in cache["blocks"]]
    if scl_layers:
        if len(scl_layers) != len(attn_pos):
            missing = sorted(set(attn_pos) - set(scl_layers))
            out.append(f"quantized pool missing scale tensor(s) for "
                       f"attention layer(s) {missing}")
        for i in scl_layers:
            s = cache["blocks"][f"scl{i}"].cpu().numpy()
            pool = cache["blocks"][f"pos{i}"]
            if s.shape[1] != num_pages or s.shape[0] != pool.shape[0] \
                    or s.shape[2] != pool.shape[3]:
                out.append(f"layer {i}: scale tensor shape {s.shape} does "
                           f"not match pool (NS={pool.shape[0]}, "
                           f"P={num_pages}, K={pool.shape[3]})")
                continue
            if not np.isfinite(s).all():
                bad = sorted(set(np.nonzero(~np.isfinite(s))[1].tolist()))
                out.append(f"layer {i}: non-finite scale on page(s) {bad} "
                           f"— beats there can never be dequantized")
            elif (s < 0).any():
                bad = sorted(set(np.nonzero(s < 0)[1].tolist()))
                out.append(f"layer {i}: negative scale on page(s) {bad}")
    return out


def _deref_push(ref, free, free_top, ids):
    """Drop one reference from each page id in ``ids`` (pad with -1; ids
    distinct) and push pages whose count hits zero back on the free
    stack.  No host sync: rows that push nothing write one slot past the
    stack, which is cut off (the reference's ``mode="drop"``)."""
    ids = ids.to(I32)
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).to(torch.int64)
    ref = ref.clone()
    ref.index_put_((safe,), -valid.to(I32), accumulate=True)
    orphan = valid & (ref[safe] <= 0)
    oi = orphan.to(I32)
    rank = torch.cumsum(oi, 0, dtype=I32) - oi
    P = free.shape[0]
    dst = torch.where(orphan, free_top + rank, P).to(torch.int64)
    buf = torch.cat([free, free.new_zeros(1)])
    buf[dst] = ids
    return ref, buf[:P], free_top + oi.sum(dtype=I32)


def paged_release_slot(cfg: ModelConfig, cache: dict, slot: int) -> dict:
    """Free a slot: drop one reference from each of its pages (orphans go
    back on the free stack), then clear its table row and position and
    reset its recurrent state to init, so that a reused slot never carries
    the previous occupant's state.  Pool pages are not zeroed: a new
    occupant overwrites position ``p`` before ``p`` ever becomes
    attendable."""
    table = cache["table"]
    ref, free, free_top = _deref_push(cache["ref"], cache["free"],
                                      cache["free_top"], table[slot])
    table = table.clone()
    table[slot] = -1
    pos = cache["pos"].clone()
    pos[slot] = 0
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "attn":
            _set_state(cache["blocks"][f"pos{i}"], (slice(None), slot),
                       _recurrent_init(cfg, kind, 1, torch.float32,
                                       pos.device))
    return {"pos": pos, "table": table, "free": free, "free_top": free_top,
            "ref": ref, "blocks": cache["blocks"]}


def paged_insert_prefill(cfg: ModelConfig, cache: dict, slot: int,
                         cache_states: dict, length: int,
                         state_len: int) -> dict:
    """Embed B=1 prefill states ``{"pos{i}": (NS, 1, S or W, K, 2D)}`` into
    a slot's pages: allocates ``ceil(state_len / page_size)`` pages off the
    free stack (exhaustion degrades locally), zero-pads the beats to whole
    pages and sets the slot's position to ``length``.  Recurrent states
    ``(NS, 1, ...)`` are installed in the slot's row."""
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    n_pg = -(-state_len // ps)
    sp = n_pg * ps
    if n_pg > n_seq:
        raise ValueError(f"state_len={state_len} needs {n_pg} pages, the "
                         f"table holds {n_seq}")
    free, free_top = cache["free"], cache["free_top"]
    dev = free.device
    k = torch.arange(n_pg, device=dev, dtype=I32)
    have = k < free_top
    newp = torch.where(
        have, free[torch.clamp(free_top - 1 - k, 0,
                               free.shape[0] - 1).to(torch.int64)],
        torch.full_like(k, -1))
    free_top = free_top - have.to(I32).sum(dtype=I32)
    table = cache["table"].clone()
    table[slot, :n_pg] = newp
    pos = cache["pos"].clone()
    pos[slot] = int(length)
    ref = _add_refs(cache["ref"], newp, have)
    quantized = _pool_quantized(cache, attn_pos)
    for i in attn_pos:
        leaf = cache["blocks"][f"pos{i}"]
        # a quantized pool keeps the states float here and quantizes per
        # page below (a cast to the pool's dtype would truncate)
        kv = cache_states[f"pos{i}"].to(torch.float32 if quantized
                                        else leaf.dtype)
        w = cfg.window_pattern[i]
        if w is not None and kv.shape[2] < state_len:
            # prefill ring-trimmed the window: un-roll to natural order and
            # park at positions [state_len - W, state_len)
            W = kv.shape[2]
            nat = torch.roll(kv, -(state_len % W), dims=2)
            full = torch.zeros(kv.shape[:2] + (sp,) + kv.shape[3:],
                               dtype=kv.dtype, device=kv.device)
            full[:, :, state_len - W:state_len] = nat
            kv = full
        elif kv.shape[2] != state_len:
            raise ValueError(f"prefill states carry {kv.shape[2]} beats; "
                             f"expected state_len={state_len}")
        if kv.shape[2] < sp:
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0,
                                              sp - kv.shape[2]))
        beats = kv[:, 0].reshape(kv.shape[0], n_pg, ps, *kv.shape[3:])
        hv = have.to(torch.int64).nonzero()[:, 0]
        ids = newp[hv].to(torch.int64)
        if quantized:
            # per-(superblock, page, head) max-abs scale over the in-page
            # and feature axes, then the beats quantized at it
            s = quant.scale_for(beats, leaf.dtype, axis=(2, 4))
            beats = quant.quantize(beats, s[:, :, None, :, None],
                                   leaf.dtype)
            cache["blocks"][f"scl{i}"][:, ids] = s[:, hv]
        quant.raw(leaf)[:, ids] = quant.raw(beats)[:, hv]
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "attn":
            _set_state(cache["blocks"][f"pos{i}"], (slice(None), slot),
                       tree_map(lambda st: st[:, 0],
                                cache_states[f"pos{i}"]))
    return {"pos": pos, "table": table, "free": free, "free_top": free_top,
            "ref": ref, "blocks": cache["blocks"]}


def paged_adopt_prefix(cfg: ModelConfig, cache: dict, slot: int,
                       page_ids) -> dict:
    """Point a freshly admitted slot's page table at SHARED prefix pages.

    ``page_ids`` is ``(pages_per_seq,)`` int32, the physical page run
    backing the slot's leading logical pages, padded with -1.  Each
    adopted page gains one reference and no pool data moves: the page
    gather already reads through the table.  The slot's position is set to
    ``(#adopted) * page_size`` (whole pages only; a partial tail is forked
    with :func:`paged_fork_page`).  The slot must be empty (released)."""
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    ids = torch.as_tensor(page_ids, dtype=I32,
                          device=cache["table"].device)
    valid = ids >= 0
    table = cache["table"].clone()
    table[slot] = torch.where(valid, ids, -1)
    pos = cache["pos"].clone()
    pos[slot] = valid.to(I32).sum(dtype=I32) * ps
    return {"pos": pos, "table": table, "free": cache["free"],
            "free_top": cache["free_top"],
            "ref": _add_refs(cache["ref"], ids, valid),
            "blocks": cache["blocks"]}


def paged_addref(cfg: ModelConfig, cache: dict, page_ids) -> dict:
    """Add one EXTERNAL reference (a prefix-trie pin) to each page id in
    ``page_ids`` (padded with -1): pinned pages survive the release of
    every slot that references them until the trie evicts them
    (:func:`paged_deref_pages`)."""
    ids = torch.as_tensor(page_ids, dtype=I32, device=cache["ref"].device)
    return dict(cache, ref=_add_refs(cache["ref"], ids, ids >= 0))


def paged_deref_pages(cfg: ModelConfig, cache: dict, page_ids) -> dict:
    """Drop one reference from each page id in ``page_ids`` (padded with
    -1), the trie-eviction counterpart of :func:`paged_addref`; pages whose
    count hits zero go back on the free stack."""
    ids = torch.as_tensor(page_ids, dtype=I32, device=cache["ref"].device)
    ref, free, free_top = _deref_push(cache["ref"], cache["free"],
                                      cache["free_top"], ids)
    return dict(cache, ref=ref, free=free, free_top=free_top)


def paged_fork_page(cfg: ModelConfig, cache: dict, slot: int,
                    logical_idx: int, src: int, *, deref_src: bool = False,
                    pos_to: int | None = None) -> dict:
    """Copy-on-write fork: pop a fresh page off the free stack, copy the
    SOURCE page's beats into it in every attention layer's pool, and point
    ``table[slot, logical_idx]`` at the copy (refcount 1).

    Used at admission when a prompt's tail matches only PART of a trie
    page: the slot adopts the shared whole-page run, then forks the
    donor's next page to go on writing mid-page, so a shared page is never
    written in place.  ``deref_src=True`` also drops one reference on
    ``src`` (the slot referenced the shared page before).  ``pos_to``, when
    given, sets the slot's position.  A quantized pool's scale forks WITH
    the page, before any write lands on the copy; a sourceless fork (``src
    < 0``: a fresh empty page) resets the scale to 0 instead.  An exhausted
    free stack degrades locally (the entry stays -1, nothing is copied).
    Admission-time bookkeeping: reads ``free_top`` on the host."""
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    slot, logical_idx, src = int(slot), int(logical_idx), int(src)
    free, free_top, ref = cache["free"], cache["free_top"], cache["ref"]
    top = int(free_top)
    newp = int(free[top - 1]) if top > 0 else -1
    table = cache["table"].clone()
    table[slot, logical_idx] = newp
    if newp >= 0:
        free_top = free_top - 1
        ref = ref.clone()
        ref[newp] += 1
        for i in attn_pos:
            if src >= 0:
                leaf = quant.raw(cache["blocks"][f"pos{i}"])
                leaf[:, newp] = leaf[:, src]
            scl = cache["blocks"].get(f"scl{i}")
            if scl is not None:
                # the source's scale, or 0 for a sourceless fork (a stale
                # scale would poison the first widen's s_old)
                scl[:, newp] = scl[:, src] if src >= 0 else 0.0
    if deref_src:
        ref, free, free_top = _deref_push(
            ref, free, free_top,
            torch.tensor([max(src, -1)], dtype=I32, device=free.device))
    pos = cache["pos"]
    if pos_to is not None:
        pos = pos.clone()
        pos[slot] = int(pos_to)
    return {"pos": pos, "table": table, "free": free, "free_top": free_top,
            "ref": ref, "blocks": cache["blocks"]}


def _tok_scan(step_fn, state0, h: torch.Tensor, on: torch.Tensor,
              keep_dtype, *, collect: bool = False):
    """Advance B rows of recurrent state over the T tokens of ``h`` (B, T,
    d) one token at a time; ``on`` (B, T) gates pad tokens out of both the
    carry and the output (their outputs are zero).  Returns (the final
    state, or with ``collect`` the list of the T intermediate states; the
    outputs (B, T, d) in ``keep_dtype``)."""
    st, sts, ys = state0, [], []
    for t in range(h.shape[1]):
        y, st2 = step_fn(h[:, t], st)
        st = _keep_active(st2, st, on[:, t])
        sts.append(st)
        ys.append(torch.where(on[:, t, None], y, 0.0))
    return (sts if collect else st), torch.stack(ys, dim=1).to(keep_dtype)


def paged_prefill_chunk(params, cache: dict, tokens: torch.Tensor,
                        cfg: ModelConfig, ctx=None, *, slot: int,
                        count) -> dict:
    """Prefill up to ``tokens.shape[0]`` prompt tokens into ONE slot,
    starting at the slot's current position; ``count`` leading tokens are
    real (pad tokens append nothing and never touch recurrent state).
    Missing pages in the touched range are allocated off the free stack
    (refcount 1), the chunk's KV beats scatter through the page table, and
    C-query causal attention runs over the slot's gathered pages;
    recurrent blocks advance the slot's state token by token.  No logits:
    the scheduler feeds the last prompt token through the decode step.
    Returns the updated cache."""
    _refuse_encoder(cfg)
    params = cast_params(params, cfg)
    pol = cfg.vx_policy
    C = tokens.shape[0]
    dev = tokens.device
    count = torch.as_tensor(count, dtype=I32, device=dev)
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    table, free, free_top = cache["table"], cache["free"], cache["free_top"]
    ref, pos = cache["ref"], cache["pos"]
    start = pos[slot]
    offs = torch.arange(C, device=dev, dtype=I32)
    tpos = start + offs                          # (C,) token positions
    real = offs < count
    seq = n_seq * ps if attn_pos else 1 << 30
    quantized = _pool_quantized(cache, attn_pos)

    if attn_pos:
        # allocate every missing page the chunk touches (rank-pop, as the
        # decode step; exhaustion degrades locally)
        row = table[slot]
        idx = torch.arange(n_seq, device=dev, dtype=I32)
        lastp = (start + torch.clamp(count, min=1) - 1) // ps
        neednew = (idx >= start // ps) & (idx <= lastp) & (row < 0)
        have, newp, free_top = _pop_pages(free, free_top, neednew)
        row = torch.where(have, newp, row)
        table = table.clone()
        table[slot] = row
        ref = _add_refs(ref, newp, have)
        if quantized:
            _reset_scales(cache, attn_pos, newp, have)
        table_c = row[None].expand(C, n_seq)
        wpos = torch.where(real & (tpos < seq), tpos,
                           torch.full_like(tpos, -1))
        spec = vx.Paged(page_size=ps, pages=n_seq, trail=2)

    x = layers.embed(tokens, params["embed"]).to(cfg.cdtype)[None]
    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi)
        for i, kind in enumerate(cfg.block_pattern):
            p = sb_p[f"pos{i}"]
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            if kind != "attn":
                leaf = cache["blocks"][f"pos{i}"]
                st, y = _tok_scan(
                    lambda ht, st, p=p, kind=kind: _recurrent_step(
                        p, ht, st, cfg, kind),
                    tree_map(lambda a: a[sbi, slot:slot + 1], leaf), h,
                    real[None], x.dtype)
                x = x + y
                _set_state(leaf, (sbi, slice(slot, slot + 1)), st)
            else:
                q, k, v, kv = attention.qkv_project(
                    p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                    tpos[None], cfg.rope_theta, policy=pol)
                pool = cache["blocks"][f"pos{i}"][sbi]  # (P, ps, K, 2D)
                # quantized: quantize-on-write (the scale only widens),
                # then the read dequantizes the slot's whole prefix, the
                # beats just written included, in the same one gather
                scl = (cache["blocks"][f"scl{i}"][sbi] if quantized
                       else None)
                vx.scatter(spec, pool, kv[0], table=table_c, pos=wpos,
                           scales=scl, policy=pol)
                full = vx.gather(spec, pool, table=row[None], scales=scl,
                                 policy=pol)
                k_all, v_all = vx.transpose(
                    vx.Segment(n=full.shape[-1], fields=2), full,
                    policy=pol)
                out = attention.chunk_attention(
                    q, k_all, v_all, tpos, window=cfg.window_pattern[i])
                x = x + (out.reshape(1, C, cfg.n_heads * cfg.hd)
                         @ p["attn"]["wo"]).to(x.dtype)
            if cfg.pos_has_ffn(i):
                x, _ = _ffn_apply(p, x, cfg, ctx, i, policy=pol)

    new_pos = pos.clone()
    new_pos[slot] = torch.clamp(start + count, max=seq)
    return {"pos": new_pos, "table": table, "free": free,
            "free_top": free_top, "ref": ref, "blocks": cache["blocks"]}


def paged_truncate(cfg: ModelConfig, cache: dict, new_pos) -> dict:
    """Truncate every slot's position DOWN to ``new_pos`` (B,) and free the
    pages past the new extent: the draft-cache sync of speculative decode
    (the draft ran ahead on tokens the target then rejected).

    Pages at logical indices ``>= ceil(new_pos / page_size)`` lose one
    reference and go back on the free stack when their count hits zero.
    The truncated range must not be shared ACROSS slots (the scheduler
    truncates only the draft pool, which never runs the prefix trie).
    Beats left in the surviving tail page past ``new_pos`` are unreachable
    and overwritten by the next append."""
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    table, pos = cache["table"], cache["pos"]
    new_pos = torch.as_tensor(new_pos, dtype=I32, device=pos.device)
    new_pos = torch.minimum(torch.clamp(new_pos, 0, n_seq * ps), pos)
    ext = (new_pos + ps - 1) // ps                   # surviving extent
    idx = torch.arange(n_seq, device=pos.device)[None, :]
    roll = (table >= 0) & (idx >= ext[:, None])
    ids = torch.where(roll, table, -1).reshape(-1)
    ref, free, free_top = _deref_push(cache["ref"], cache["free"],
                                      cache["free_top"], ids)
    return {"pos": new_pos, "table": torch.where(roll, -1, table),
            "free": free, "free_top": free_top, "ref": ref,
            "blocks": cache["blocks"]}


def _layer_pool(cache: dict, i: int, sbi: int, quantized: bool):
    """Layer ``sbi``'s pool ``(P, ps, K, 2D)`` at position ``i`` and its
    scales (None unquantized); a pool placed on a mesh stays placed."""
    blocks = cache["blocks"]
    return (sharding.select(blocks[f"pos{i}"], sbi),
            sharding.select(blocks[f"scl{i}"], sbi) if quantized else None)


def _insert_beats(pre: torch.Tensor, beats: torch.Tensor,
                  at: torch.Tensor) -> torch.Tensor:
    """``pre.at[b, at[b, j]].set(beats[b, j], mode="drop")`` out of place:
    ``pre`` (B, S, ...), ``beats`` (B, K, ...), ``at`` (B, K) with ``S``
    marking a dropped row.  The rows are written into a buffer one
    position longer, whose last position is cut off."""
    B, S = pre.shape[:2]
    buf = torch.cat([pre, pre.new_zeros((B, 1) + pre.shape[2:])], dim=1)
    rows = torch.arange(B, device=pre.device)[:, None].expand(at.shape)
    buf[rows, at.long()] = beats.to(pre.dtype)
    return buf[:, :S]


def paged_verify_step(params, cache: dict, tokens: torch.Tensor,
                      cfg: ModelConfig, ctx=None, *, n_draft, active=None,
                      fuse: bool | None = None, pool_shard=None):
    """Speculative K-token verify over the paged cache.

    ``tokens`` is ``(B, K)`` int: column 0 is each slot's CURRENT token,
    columns 1..K-1 the draft's proposals; ``n_draft`` (B,) in [1, K] is
    the number of real columns per slot (a tensor: one call serves every
    mixture of widths).  Returns ``(logits (B, K, V), out_tok (B, K),
    commit (B,), cache)``: ``out_tok[:, j]`` is the argmax of column j and
    ``commit`` the greedy accept count, 1 plus the number of LEADING
    drafts equal to the previous column's argmax, so ``out_tok[b,
    :commit[b]]`` is the non-speculative greedy stream.

    The K positions stack along the beat axis of the single-token step's
    ``vx.Paged`` spec: pages over ``[pos, pos + n_draft - 1]`` are
    allocated in one rank-pop (exhaustion degrades locally), the append is
    one ``(B*K,)`` scatter per layer through the table rows repeated K
    times (the chunked prefill's shape), and the read is the step's ONE
    fused page gather and ONE fused FIELD=2 split (``fuse=True``) or the
    per-access pair per layer (``fuse=False``).  Attention reads the
    PRE-append pages and inserts the K fresh beats as floats, so every
    arm sees the same attention inputs.  The pools are updated in place
    (the reference donates them), so the fused gather runs before any
    scatter and the per-access gather of a layer before that layer's
    scatter; a quantized pool's gather reads the scales before the
    append widens them.  Rejection rolls back through the page table
    only: pages allocated this step past the accept extent go straight
    back on the free stack.  Recurrent blocks advance token by token with
    every intermediate state kept; the state after ``commit`` tokens is
    selected afterwards (a K-way where), so rejected tokens never reach
    the carry.  ``pool_shard`` as for :func:`paged_decode_step`.
    """
    check_supported(cfg)
    _refuse_encoder(cfg)
    params = cast_params(params, cfg)
    fuse = cfg.step_fusion if fuse is None else fuse
    pol = cfg.vx_policy
    B, K = tokens.shape
    dev = tokens.device
    pos = cache["pos"]
    active = (torch.ones((B,), dtype=torch.bool, device=dev)
              if active is None else torch.as_tensor(active, device=dev)
              .to(torch.bool))
    n_draft = torch.clamp(torch.as_tensor(n_draft, dtype=I32, device=dev),
                          1, K)
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    table, free, free_top = cache["table"], cache["free"], cache["free_top"]
    ref = cache["ref"]
    quantized = _pool_quantized(cache, attn_pos)
    seq = n_seq * ps if attn_pos else 1 << 30

    offs = torch.arange(K, device=dev, dtype=I32)[None, :]
    tpos = pos[:, None] + offs                       # (B, K) positions
    valid = active[:, None] & (offs < n_draft[:, None])
    idx = torch.arange(n_seq, device=dev, dtype=I32)[None, :]
    if attn_pos:
        # batched multi-page allocation: exactly the pages the oracle
        # would allocate crossing boundaries in [pos, pos + n_draft - 1]
        startp = (pos + ps - 1) // ps
        lastp = (pos + n_draft - 1) // ps
        need = (active[:, None] & (idx >= startp[:, None])
                & (idx <= lastp[:, None]) & (table < 0))
        have_f, newp_f, free_top = _pop_pages(free, free_top,
                                              need.reshape(-1))
        have = have_f.reshape(B, n_seq)
        newp_grid = torch.where(have, newp_f.reshape(B, n_seq), -1)
        table = torch.where(have, newp_grid, table)
        ref = _add_refs(ref, newp_f, have_f)
        if quantized:
            _reset_scales(cache, attn_pos, newp_f, have_f)
        spec = vx.Paged(page_size=ps, pages=n_seq, trail=2)
        # (B*K,) append rows through the table rows repeated K times
        keep = valid & (tpos < seq)
        wpos_flat = torch.where(keep, tpos, -1).reshape(-1)
        table_flat = table.repeat_interleave(K, dim=0)
        qpos = torch.where(valid, tpos, -1)          # pad queries
        wp_ins = torch.where(keep, tpos, seq)        # pad rows drop

    x = layers.embed(tokens, params["embed"]).to(cfg.cdtype)   # (B, K, d)
    pre_split: dict[str, Any] = {}
    if fuse and attn_pos:
        gathered = kv_interleaved.gather_paged_kv(
            [cache["blocks"][f"pos{i}"] for i in attn_pos], table, ps,
            policy=pol, scales=([cache["blocks"][f"scl{i}"]
                                 for i in attn_pos] if quantized else None),
            shard=pool_shard)
        splits = kv_interleaved.split_kv_step(gathered, policy=pol)
        pre_split = {f"pos{i}": splits[a] for a, i in enumerate(attn_pos)}
    beat_pol = (pol.for_elems(B * K * cfg.n_kv_heads * 2 * cfg.hd)
                if fuse else pol)
    ffn_pol = pol.for_elems(B * K * 2 * cfg.d_ff) if fuse else pol
    states = {f"pos{i}": [] for i, k in enumerate(cfg.block_pattern)
              if k != "attn"}

    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi)
        for i, kind in enumerate(cfg.block_pattern):
            p = sb_p[f"pos{i}"]
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            if kind != "attn":
                sts, y = _tok_scan(
                    lambda ht, st, p=p, kind=kind: _recurrent_step(
                        p, ht, st, cfg, kind),
                    _sb_state(cache["blocks"][f"pos{i}"], sbi), h, valid,
                    x.dtype, collect=True)
                x = x + y
                states[f"pos{i}"].append(sts)
            else:
                q, k, v, kv = attention.qkv_project(
                    p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd, tpos,
                    cfg.rope_theta, policy=beat_pol)
                pool, scl = _layer_pool(cache, i, sbi, quantized)
                if fuse:
                    k_pre, v_pre = (t[sbi] for t in pre_split[f"pos{i}"])
                else:
                    # the per-access arm reads this layer's PRE-append pages
                    # before its scatter writes the pool in place
                    full = vx.gather(spec, pool, table=table, scales=scl,
                                     policy=pol, shard=pool_shard)
                    k_pre, v_pre = vx.transpose(
                        vx.Segment(n=full.shape[-1], fields=2), full,
                        policy=pol)
                vx.scatter(spec, pool,
                           kv.reshape(B * K, cfg.n_kv_heads, 2 * cfg.hd),
                           table=table_flat, pos=wpos_flat, scales=scl,
                           policy=pol)
                # all K fresh beats inserted as floats; pad rows drop
                k_all = _insert_beats(k_pre, k, wp_ins)
                v_all = _insert_beats(v_pre, v, wp_ins)
                out = attention.chunk_attention(
                    q, k_all, v_all, qpos, window=cfg.window_pattern[i])
                x = x + (out.reshape(B, K, cfg.n_heads * cfg.hd)
                         @ p["attn"]["wo"]).to(x.dtype)
            if cfg.pos_has_ffn(i):
                x, _ = _ffn_apply(p, x, cfg, ctx, i, policy=ffn_pol)

    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))        # (B, K, V)

    # greedy accept recurrence: commit = 1 + (# leading drafts equal to
    # the previous column's argmax)
    out_tok = torch.argmax(logits.float(), dim=-1).to(I32)
    if K > 1:
        match = ((tokens[:, 1:].to(I32) == out_tok[:, :-1])
                 & (offs[:, 1:] < n_draft[:, None]))
        m = torch.cumprod(match.to(I32), dim=1).sum(dim=1, dtype=I32)
    else:
        m = torch.zeros((B,), dtype=I32, device=dev)
    commit = torch.where(active, 1 + m, 0).to(I32)
    new_pos = torch.where(active, torch.clamp(pos + commit, max=seq), pos)

    # accept-point select for recurrent leaves: the state after `commit`
    # tokens is index commit-1 (inactive slots carried their old state
    # through the gated scan, so any index reads it back)
    ci = torch.clamp(commit, 1, K) - 1

    def select(*per_tok):
        out = per_tok[0]
        for kk in range(1, K):
            hit = (ci == kk).reshape((-1,) + (1,) * (out.ndim - 1))
            out = torch.where(hit, per_tok[kk], out)
        return out

    for key, per_sb in states.items():
        for sbi, sts in enumerate(per_sb):
            _set_state(cache["blocks"][key], sbi, tree_map(select, *sts))

    if attn_pos:
        # rollback through the page table only: pages allocated THIS step
        # past the accept extent are refcount 1; clear and push them back
        ext = (new_pos + ps - 1) // ps
        roll = have & (idx >= ext[:, None])
        ref, free, free_top = _deref_push(
            ref, free, free_top,
            torch.where(roll, newp_grid, -1).reshape(-1))
        table = torch.where(roll, -1, table)
    return logits, out_tok, commit, {
        "pos": new_pos, "table": table, "free": free,
        "free_top": free_top, "ref": ref, "blocks": cache["blocks"]}


def paged_decode_step(params, cache: dict, token: torch.Tensor,
                      cfg: ModelConfig, ctx=None, *, active=None,
                      fuse: bool | None = None, pool_shard=None):
    """One decode step over the paged cache.  token: (B,) int with B =
    slots.  Returns (logits (B, V), updated cache).

    Idle slots (``active`` False) append and advance nothing; a slot
    crossing a page boundary pops a page off the free stack.  With
    ``fuse=True`` ALL layers' page gathers run as ONE page-granular gather
    and ONE fused FIELD=2 split (kernel B1: one launch per step) over the
    pre-append pages, and each layer's fresh beat is inserted into the
    split K/V.  ``fuse=False`` is the per-access paged oracle.

    QUANTIZED pools dequantize inside the same fused gather (float32
    K/V), quantize the appended beat on write (the page scale only
    widens), and attention always reads the pre-append pages plus the
    fresh FLOAT beat: the fused and per-access paths stay bit-identical,
    and the beat is quantized only for the next step's read.  The
    per-access arm gathers each layer's pages before its scatter writes
    the pool in place.  Recurrent positions step every slot's state and
    keep the old state (and add nothing to ``x``) where a slot is idle.

    ``pool_shard`` (a ``vx.Shard`` on the pools' page axis, ``axis=-4``)
    runs every page gather shard-locally: each rank gathers the pages of
    its block and one psum merges them.  The pools may be plain (every
    rank holds them whole and appends replicated, the reference's case)
    or ``DTensor`` s sharded on the page axis (each rank holds ``1/R`` of
    the pages, scales alike, and a beat is appended only by the rank that
    owns its page)."""
    _refuse_encoder(cfg)
    params = cast_params(params, cfg)
    fuse = cfg.step_fusion if fuse is None else fuse
    pol = cfg.vx_policy
    B = token.shape[0]
    dev = token.device
    pos = cache["pos"]
    active = (torch.ones((B,), dtype=torch.bool, device=dev)
              if active is None else torch.as_tensor(active, device=dev)
              .to(torch.bool))
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    table, free, free_top = cache["table"], cache["free"], cache["free_top"]
    ref = cache["ref"]
    quantized = _pool_quantized(cache, attn_pos)
    # logical capacity; a stack without attention carries O(1) state
    seq = n_seq * ps if attn_pos else 1 << 30

    if attn_pos:
        # allocate on page-boundary crossing — one shared table update for
        # every layer.  An exhausted free stack degrades locally: slots
        # whose pop rank exceeds the free count get no page (never an
        # aliased one).
        need = active & (pos % ps == 0) & (pos // ps < n_seq)
        have, newp, free_top = _pop_pages(free, free_top, need)
        hit = have[:, None] & (torch.arange(n_seq, device=dev)[None, :]
                               == (pos // ps)[:, None])
        table = torch.where(hit, newp[:, None], table)
        ref = _add_refs(ref, newp, have)
        if quantized:
            _reset_scales(cache, attn_pos, newp, have)
        # idle slots and full sequences append nothing (dropped scatter
        # rows)
        write_pos = torch.where(active & (pos < seq), pos,
                                torch.full_like(pos, -1))
        spec = vx.Paged(page_size=ps, pages=n_seq, trail=2)
        ins = (active[:, None] & (torch.arange(seq, device=dev)[None, :]
                                  == pos[:, None]))[:, :, None, None]

    x = layers.embed(token, params["embed"]).to(cfg.cdtype)

    pre_split: dict[str, Any] = {}
    if fuse and attn_pos:
        # ONE fused page gather for all layers' pools, then ONE fused
        # FIELD=2 split
        gathered = kv_interleaved.gather_paged_kv(
            [cache["blocks"][f"pos{i}"] for i in attn_pos], table, ps,
            policy=pol, scales=([cache["blocks"][f"scl{i}"]
                                 for i in attn_pos] if quantized else None),
            shard=pool_shard)
        splits = kv_interleaved.split_kv_step(gathered, policy=pol)
        pre_split = {f"pos{i}": splits[a] for a, i in enumerate(attn_pos)}
    beat_pol = (pol.for_elems(B * cfg.n_kv_heads * 2 * cfg.hd)
                if fuse else pol)
    ffn_pol = pol.for_elems(B * 2 * cfg.d_ff) if fuse else pol
    eff = (pos + active.to(I32))[:, None]                 # (B, 1) per slot

    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi)
        for i, kind in enumerate(cfg.block_pattern):
            p = sb_p[f"pos{i}"]
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            if kind != "attn":
                leaf = cache["blocks"][f"pos{i}"]
                old = _sb_state(leaf, sbi)
                y, st = _recurrent_step(p, h, old, cfg, kind)
                x = x + torch.where(active[:, None], y, 0)
                _set_state(leaf, sbi, _keep_active(st, old, active))
            else:
                q, k, v, kv = attention.qkv_project(
                    p["attn"], h[:, None], cfg.n_heads, cfg.n_kv_heads,
                    cfg.hd, pos[:, None], cfg.rope_theta, policy=beat_pol)
                pool, scl = _layer_pool(cache, i, sbi, quantized)
                if quantized and not fuse:
                    # the per-access quantized arm reads the PRE-append pages
                    # (as the fused gather does) and inserts the fresh float
                    # beat below
                    full = vx.gather(spec, pool, table=table, scales=scl,
                                     policy=pol, shard=pool_shard)
                    pre = vx.transpose(vx.Segment(n=full.shape[-1], fields=2),
                                       full, policy=pol)
                vx.scatter(spec, pool, kv[:, 0], table=table, pos=write_pos,
                           scales=scl, policy=pol)
                if fuse or quantized:
                    k_pre, v_pre = ((t[sbi] for t in pre_split[f"pos{i}"])
                                    if fuse else pre)
                    # k/v are (B, 1, K, D): broadcast over the seq axis
                    k_all = torch.where(ins, k.to(k_pre.dtype), k_pre)
                    v_all = torch.where(ins, v.to(v_pre.dtype), v_pre)
                else:
                    full = vx.gather(spec, pool, table=table, policy=pol,
                                     shard=pool_shard)
                    k_all, v_all = vx.transpose(
                        vx.Segment(n=full.shape[-1], fields=2), full,
                        policy=pol)
                out = attention.decode_attention(
                    q[:, 0], k_all, v_all, eff, window=cfg.window_pattern[i])
                x = x + (out.reshape(B, cfg.n_heads * cfg.hd)
                         @ p["attn"]["wo"]).to(x.dtype)
            if cfg.pos_has_ffn(i):
                x2, _ = _ffn_apply(p, x[:, None], cfg, ctx, i,
                                   policy=ffn_pol)
                x = x2[:, 0]

    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))
    new_pos = pos + (active & (pos < seq)).to(I32)
    return logits, {"pos": new_pos, "table": table, "free": free,
                    "free_top": free_top, "ref": ref,
                    "blocks": cache["blocks"]}
