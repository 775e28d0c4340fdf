"""Single-token decode over the interleaved KV cache: the dense cache and
the paged one (the serving step body).

Port of the attention-only subset of ``repro``'s ``models/decode.py``.
The dense cache: ``cache_len_for_pos``, ``init_cache``,
``cache_from_prefill`` and ``decode_step`` (``fuse=True`` and
``fuse=False``), the oracle the paged step is held against.  The paged
cache: ``init_paged_cache`` (float pools), ``paged_prefill_chunk``,
``paged_decode_step`` (``fuse=True`` and ``fuse=False``),
``paged_release_slot``, ``paged_insert_prefill`` and ``paged_invariants``.

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
masked (never wrapped) out-of-range updates.

Superblocks run in a Python loop over the stacked ``(NS, ...)`` leaves in
place of ``lax.scan``.  Dense cache leaves and page pools are updated IN
PLACE (the reference donates the cache to its jit'd step); the small
integer state is rebuilt.

Waiting for later slices: Mamba/xLSTM blocks and the encoder-decoder step,
the sequence-sharded dense step (``kv_shard``, with ``dist``), the
quantized pool, speculative verify/truncate and prefix adopt/fork.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import vx
from repro_torch.device import resolve as resolve_device
from repro_torch.kernels import kv_interleaved
from repro_torch.models import attention, layers
from repro_torch.models.transformer import (ModelConfig, _ffn_apply,
                                            cast_params, check_supported,
                                            superblock)

I32 = torch.int32


def cache_len_for_pos(cfg: ModelConfig, i: int, max_len: int) -> int:
    w = cfg.window_pattern[i]
    return min(w, max_len) if w is not None else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None) -> dict:
    """Empty dense cache: ``{"len": 0-dim int32, "blocks": {"pos{i}":
    (NS, batch, Sc, K, 2D)}}``, leaves stacked over superblocks."""
    check_supported(cfg)
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    ns = cfg.n_superblocks
    blocks = {f"pos{i}": torch.zeros(
        (ns, batch, cache_len_for_pos(cfg, i, max_len), cfg.n_kv_heads,
         2 * cfg.hd), dtype=dtype, device=device)
        for i in range(cfg.sb_len)}
    return {"len": torch.zeros((), dtype=I32, device=device),
            "blocks": blocks}


def cache_from_prefill(cfg: ModelConfig, cache_states, seq_len: int,
                       max_len: int, dtype=torch.float32) -> dict:
    """Embed prefill states ``{"pos{i}": (NS, B, S or W, K, 2D)}`` into a
    fresh ``max_len`` dense cache: zero-padded, or trimmed, to each
    layer's ``Sc`` beats."""
    check_supported(cfg)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    blocks = {}
    for i in range(cfg.sb_len):
        st = cache_states[f"pos{i}"]
        sc = cache_len_for_pos(cfg, i, max_len)
        kv = torch.zeros(st.shape[:2] + (sc,) + st.shape[3:], dtype=dtype,
                         device=st.device)
        n = min(sc, st.shape[2])
        kv[:, :, :n] = st[:, :, :n]
        blocks[f"pos{i}"] = kv
    return {"len": torch.tensor(seq_len, dtype=I32,
                                device=blocks["pos0"].device),
            "blocks": blocks}


def decode_step(params, cache: dict, token: torch.Tensor, cfg: ModelConfig,
                ctx=None, *, fuse: bool | None = None, kv_shard=None):
    """token: (B,) int.  Returns (logits (B, V), updated cache).

    ``fuse`` (default ``cfg.step_fusion``) is whole-step access fusion:
    every layer's cache split is hoisted to the top of the step (it reads
    the pre-append cache) and runs as ONE fused FIELD=2 segment load (one
    B1 launch under ``kernel``, one B6 under ``kernel_dynamic``); the
    current token's k and v are then written into the pre-split arrays at
    its slot, bit-exact with splitting the post-append cache.  The
    single-token beat pack and GLU split ride the plain path below the
    policy's fusion threshold.  ``fuse=False`` splits each layer's
    post-append cache on its own (the equivalence oracle).  The cache
    leaves are updated in place; ``len`` is rebuilt.  ``kv_shard`` (the
    sequence-sharded cache) waits for the port's dist slice."""
    check_supported(cfg)
    if kv_shard is not None:
        raise NotImplementedError("the sequence-sharded dense step waits "
                                  "for the port's dist slice")
    params = cast_params(params, cfg)
    fuse = cfg.step_fusion if fuse is None else fuse
    pol = cfg.vx_policy
    B = token.shape[0]
    pos = cache["len"]
    x = layers.embed(token, params["embed"]).to(cfg.cdtype)
    attn_pos = [i for i, k in enumerate(cfg.block_pattern) if k == "attn"]
    pre_split: dict[str, Any] = {}
    if fuse and attn_pos:
        splits = kv_interleaved.split_kv_step(
            [cache["blocks"][f"pos{i}"] for i in attn_pos], policy=pol)
        pre_split = {f"pos{i}": splits[a] for a, i in enumerate(attn_pos)}
    beat_pol = (pol.for_elems(B * cfg.n_kv_heads * 2 * cfg.hd)
                if fuse else pol)
    ffn_pol = pol.for_elems(B * 2 * cfg.d_ff) if fuse else pol
    positions = pos.expand(B, 1)

    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi)
        for i in attn_pos:
            p = sb_p[f"pos{i}"]
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v, kv = attention.qkv_project(
                p["attn"], h[:, None], cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                positions, cfg.rope_theta, policy=beat_pol)
            kvc = cache["blocks"][f"pos{i}"][sbi]          # (B, Sc, K, 2D)
            sc = kvc.shape[1]
            slot = torch.remainder(pos, sc).reshape(1).long()
            kvc.index_copy_(1, slot, kv.to(kvc.dtype))
            if fuse:
                # the pre-split arrays are this step's own (under ``ref``
                # a view of the cache, where the beat wrote the same bits)
                k_all, v_all = (t[sbi] for t in pre_split[f"pos{i}"])
                k_all.index_copy_(1, slot, k.to(kvc.dtype))
                v_all.index_copy_(1, slot, v.to(kvc.dtype))
            else:
                k_all, v_all = vx.transpose(
                    vx.Segment(n=kvc.shape[-1], fields=2), kvc, policy=pol)
            eff_len = torch.clamp(pos + 1, max=sc)
            out = attention.decode_attention(q[:, 0], k_all, v_all, eff_len,
                                             window=None)
            x = x + (out.reshape(B, cfg.n_heads * cfg.hd)
                     @ p["attn"]["wo"]).to(x.dtype)
            if cfg.pos_has_ffn(i):
                x2, _ = _ffn_apply(p, x[:, None], cfg, ctx, i,
                                   policy=ffn_pol)
                x = x2[:, 0]

    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(x, head.to(cfg.cdtype))
    return logits, {"len": pos + 1, "blocks": cache["blocks"]}


def pages_per_seq(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     page_size: int, dtype=torch.float32, *,
                     num_pages: int | None = None, device=None) -> dict:
    """Paged cache: a shared page pool per attention layer, one page table,
    per-slot positions, the free-page stack and page refcounts.
    ``num_pages`` defaults to full provisioning (``slots *
    pages_per_seq``)."""
    check_supported(cfg)
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    ns = cfg.n_superblocks
    n_seq = pages_per_seq(max_len, page_size)
    if num_pages is None:
        num_pages = slots * n_seq
    blocks = {f"pos{i}": torch.zeros(
        (ns, num_pages, page_size, cfg.n_kv_heads, 2 * cfg.hd),
        dtype=dtype, device=device) for i in range(cfg.sb_len)}
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
    """(attn positions, page_size, pages_per_seq) from the cache leaves."""
    attn_pos = [i for i, k in enumerate(cfg.block_pattern) if k == "attn"]
    n_seq = cache["table"].shape[-1]
    ps = cache["blocks"][f"pos{attn_pos[0]}"].shape[2]
    return attn_pos, ps, n_seq


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
    conservation, free-stack consistency, copy-on-write tails,
    pos-vs-table occupancy, bounds); returns violations (empty =
    healthy).  One host fetch of the small integer state."""
    attn_pos, ps, n_seq = _paged_geometry(cfg, cache)
    table, free, pos, ref = (cache[k].cpu().numpy()
                             for k in ("table", "free", "pos", "ref"))
    free_top = int(cache["free_top"])
    num_pages = free.shape[0]
    out: list[str] = []
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
    return out


def _deref_push(ref, free, free_top, ids):
    """Drop one reference from each page id in ``ids`` (pad with -1; ids
    distinct) and push pages whose count hits zero back on the free
    stack."""
    ids = ids.to(I32)
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).to(torch.int64)
    ref = ref.clone()
    ref.index_put_((safe,), -valid.to(I32), accumulate=True)
    orphan = valid & (ref[safe] <= 0)
    oi = orphan.to(I32)
    rank = torch.cumsum(oi, 0, dtype=I32) - oi
    free = free.clone()
    free[(free_top + rank)[orphan].to(torch.int64)] = ids[orphan]
    return ref, free, free_top + oi.sum(dtype=I32)


def paged_release_slot(cfg: ModelConfig, cache: dict, slot: int) -> dict:
    """Free a slot: drop one reference from each of its pages (orphans go
    back on the free stack), then clear its table row and position.  Pool
    pages are not zeroed: a new occupant overwrites position ``p`` before
    ``p`` ever becomes attendable."""
    table = cache["table"]
    ref, free, free_top = _deref_push(cache["ref"], cache["free"],
                                      cache["free_top"], table[slot])
    table = table.clone()
    table[slot] = -1
    pos = cache["pos"].clone()
    pos[slot] = 0
    return {"pos": pos, "table": table, "free": free, "free_top": free_top,
            "ref": ref, "blocks": cache["blocks"]}


def paged_insert_prefill(cfg: ModelConfig, cache: dict, slot: int,
                         cache_states: dict, length: int,
                         state_len: int) -> dict:
    """Embed B=1 prefill states ``{"pos{i}": (NS, 1, S or W, K, 2D)}`` into
    a slot's pages: allocates ``ceil(state_len / page_size)`` pages off the
    free stack (exhaustion degrades locally), zero-pads the beats to whole
    pages and sets the slot's position to ``length``."""
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
    for i in attn_pos:
        leaf = cache["blocks"][f"pos{i}"]
        kv = cache_states[f"pos{i}"].to(leaf.dtype)
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
        leaf[:, newp[hv].to(torch.int64)] = beats[:, hv]
    return {"pos": pos, "table": table, "free": free, "free_top": free_top,
            "ref": ref, "blocks": cache["blocks"]}


def paged_prefill_chunk(params, cache: dict, tokens: torch.Tensor,
                        cfg: ModelConfig, ctx=None, *, slot: int,
                        count) -> dict:
    """Prefill up to ``tokens.shape[0]`` prompt tokens into ONE slot,
    starting at the slot's current position; ``count`` leading tokens are
    real (pad tokens append nothing).  Missing pages in the touched range
    are allocated off the free stack (refcount 1), the chunk's KV beats
    scatter through the page table, and C-query causal attention runs over
    the slot's gathered pages.  No logits: the scheduler feeds the last
    prompt token through the decode step.  Returns the updated cache."""
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
    seq = n_seq * ps

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
    table_c = row[None].expand(C, n_seq)
    wpos = torch.where(real & (tpos < seq), tpos, torch.full_like(tpos, -1))
    spec = vx.Paged(page_size=ps, pages=n_seq, trail=2)

    x = layers.embed(tokens, params["embed"]).to(cfg.cdtype)[None]
    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi)
        for i in attn_pos:
            p = sb_p[f"pos{i}"]
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v, kv = attention.qkv_project(
                p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                tpos[None], cfg.rope_theta, policy=pol)
            pool = cache["blocks"][f"pos{i}"][sbi]     # (P, ps, K, 2D)
            vx.scatter(spec, pool, kv[0], table=table_c, pos=wpos,
                       policy=pol)
            full = vx.gather(spec, pool, table=row[None], policy=pol)
            k_all, v_all = vx.transpose(
                vx.Segment(n=full.shape[-1], fields=2), full, policy=pol)
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


def paged_decode_step(params, cache: dict, token: torch.Tensor,
                      cfg: ModelConfig, ctx=None, *, active=None,
                      fuse: bool | None = None):
    """One decode step over the paged cache.  token: (B,) int with B =
    slots.  Returns (logits (B, V), updated cache).

    Idle slots (``active`` False) append and advance nothing; a slot
    crossing a page boundary pops a page off the free stack.  With
    ``fuse=True`` ALL layers' page gathers run as ONE page-granular gather
    and ONE fused FIELD=2 split (kernel B1: one launch per step) over the
    pre-append pages, and each layer's fresh beat is inserted into the
    split K/V.  ``fuse=False`` is the per-access paged oracle."""
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
    seq = n_seq * ps

    # allocate on page-boundary crossing — one shared table update for
    # every layer.  An exhausted free stack degrades locally: slots whose
    # pop rank exceeds the free count get no page (never an aliased one).
    need = active & (pos % ps == 0) & (pos // ps < n_seq)
    have, newp, free_top = _pop_pages(free, free_top, need)
    hit = have[:, None] & (torch.arange(n_seq, device=dev)[None, :]
                           == (pos // ps)[:, None])
    table = torch.where(hit, newp[:, None], table)
    ref = _add_refs(cache["ref"], newp, have)
    # idle slots and full sequences append nothing (dropped scatter rows)
    write_pos = torch.where(active & (pos < seq), pos,
                            torch.full_like(pos, -1))
    spec = vx.Paged(page_size=ps, pages=n_seq, trail=2)

    x = layers.embed(token, params["embed"]).to(cfg.cdtype)

    pre_split: dict[str, Any] = {}
    if fuse:
        # ONE fused page gather for all layers' pools, then ONE fused
        # FIELD=2 split
        gathered = kv_interleaved.gather_paged_kv(
            [cache["blocks"][f"pos{i}"] for i in attn_pos], table, ps,
            policy=pol)
        splits = kv_interleaved.split_kv_step(gathered, policy=pol)
        pre_split = {f"pos{i}": splits[a] for a, i in enumerate(attn_pos)}
    beat_pol = (pol.for_elems(B * cfg.n_kv_heads * 2 * cfg.hd)
                if fuse else pol)
    ffn_pol = pol.for_elems(B * 2 * cfg.d_ff) if fuse else pol
    eff = (pos + active.to(I32))[:, None]                 # (B, 1) per slot
    ins = (active[:, None] & (torch.arange(seq, device=dev)[None, :]
                              == pos[:, None]))[:, :, None, None]

    for sbi in range(cfg.n_superblocks):
        sb_p = superblock(params["blocks"], sbi)
        for i in attn_pos:
            p = sb_p[f"pos{i}"]
            h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v, kv = attention.qkv_project(
                p["attn"], h[:, None], cfg.n_heads, cfg.n_kv_heads,
                cfg.hd, pos[:, None], cfg.rope_theta, policy=beat_pol)
            pool = cache["blocks"][f"pos{i}"][sbi]     # (P, ps, K, 2D)
            vx.scatter(spec, pool, kv[:, 0], table=table, pos=write_pos,
                       policy=pol)
            if fuse:
                k_pre, v_pre = (t[sbi] for t in pre_split[f"pos{i}"])
                # k/v are (B, 1, K, D): broadcast over the seq axis
                k_all = torch.where(ins, k.to(k_pre.dtype), k_pre)
                v_all = torch.where(ins, v.to(v_pre.dtype), v_pre)
            else:
                full = vx.gather(spec, pool, table=table, policy=pol)
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
