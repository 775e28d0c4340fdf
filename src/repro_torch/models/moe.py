"""Mixture-of-Experts with expert parallelism and EARTH-compaction dispatch.

Port of ``repro``'s ``models/moe.py``.  Each MoE FFN:

  1. routes its tokens (top-k of the float32 softmax, renormalized),
  2. selects the (token, slot) units owned by this device's experts,
  3. **compacts** their indices to a fixed-capacity buffer through
     ``vx.compact(vx.Compact(n, cap), mine)`` (``dispatch="earth"``: the
     runtime-count shift network of ``accessfuse.compact_indices``, torch
     ops under every policy, as the reference's are jnp ops) or a stable
     argsort (``dispatch="sort"``),
  4. sorts the units by expert and runs the grouped GEMMs: the reference's
     ``lax.ragged_dot`` (not a Pallas kernel) becomes one ``torch.matmul``
     per expert over its contiguous run of the sorted units, so the run
     lengths come to the host once per MoE layer (one sync),
  5. combines the weighted expert outputs per token in ``x.dtype``.

The combine adds each token's contributions one after another in the
sorted order, rounding in ``x.dtype`` after each add: the serial
scatter-add of the reference's ``y.at[tok].add(contrib)``, without the
atomics of ``index_add_`` on CUDA, so a run gives the same bits every time.

Expert parallelism: under a ``ShardCtx`` with a mesh, :func:`moe_layer`
runs the body on each rank's blocks (``dist.sharding.shard_map``): the
tokens of its data shard and the experts of its model shard (the rank
holding experts ``[my * E/m, (my + 1) * E/m)``, ``my`` its index on the
model axis).  Each rank routes its tokens over all experts, keeps the
units of its own experts (capacity per shard: a shard may drop units the
one-device run keeps), and the partial outputs sum over the model axis:
a ``psum_scatter`` over the sequence when the model axis divides it (the
result sharded on it), else a ``psum``.  The aux loss is a per-data-shard
estimate averaged with ``pmean`` over the data axes.

The mesh forward (``models/transformer.forward`` / ``loss_fn`` under a
mesh, the sharded train step, the batch-sharded serve step) hands its
layers a ``dist.sharding.RankLocal`` context whose ``experts`` is the
mesh's: the layer's expert banks arrive as the rank's resident block of
experts (never gathered) and the activations replicated over the model
axis, and :func:`moe_layer` runs the same expert-parallel body on the
rank's batch block under autograd.  The routing (and so the aux loss) is
computed alike on every rank of a model group; the tokens and the
routing weights enter the rank's experts through
``dist.sharding.sum_grads`` (identity forward, ``psum`` backward) and
the partial outputs leave through ``dist.sharding.global_sum`` (``psum``
forward, identity backward), so the cotangents that reach ``x`` and the
router through the experts are summed over the model axis, the aux's is
counted once and each bank's stays on its owner.
:func:`expert_parallel_plain` is the one-process oracle of that function
(each data block alone, the model shards one after another).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import vx
from repro_torch.models import layers


class MoESpec(NamedTuple):
    n_experts: int
    top_k: int
    d_ff: int
    capacity_slack: float = 2.0
    aux_coef: float = 0.01
    dispatch: str = "earth"   # "earth" (shift network) | "sort" (argsort)


def init_moe(d_model: int, spec: MoESpec, g: torch.Generator, dtype,
             device) -> dict:
    """The reference's leaves, shapes and scales; the router float32."""
    E, f = spec.n_experts, spec.d_ff
    s = d_model ** -0.5
    return {
        "router": layers.normal((d_model, E), s, g, torch.float32, device),
        "wg": layers.normal((E, d_model, f), s, g, dtype, device),
        "wu": layers.normal((E, d_model, f), s, g, dtype, device),
        "wo": layers.normal((E, f, d_model), f ** -0.5, g, dtype, device),
    }


def _capacity(T: int, k: int, n_shards: int, slack: float) -> int:
    cap = int(math.ceil(T * k / n_shards * slack))
    cap = min(max(cap, 8), T * k)
    return ((cap + 7) // 8) * 8 if cap % 8 else cap


def _compact_ids(mine: torch.Tensor, cap: int,
                 dispatch: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack indices of set bits of ``mine`` (n,) to the front; take cap."""
    n = mine.shape[0]
    if dispatch == "earth":
        packed = vx.compact(vx.Compact(n=n, cap=cap), mine)
    else:  # argsort baseline
        order = torch.argsort((~mine).to(torch.int32), stable=True)
        packed = order[:cap].to(torch.int32)
    total = torch.sum(mine.to(torch.int32))
    pv = torch.arange(packed.shape[0], dtype=torch.int32,
                      device=mine.device) < total
    return packed, pv


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, equal values
    taken lower index first (a stable descending sort; ``torch.topk``
    leaves the order of ties unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(idx, minlength=n)`` for ``idx < n`` without its host
    sync on CUDA (which reads the max to size the output)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _grouped_ffn(xs: torch.Tensor, wg, wu, wo,
                 gs: torch.Tensor) -> torch.Tensor:
    """``ragged_dot`` x3 with the SwiGLU between: rows of group ``e`` (a
    contiguous run of ``gs[e]`` rows) go through expert ``e``'s weights;
    rows past the groups stay zero.  Products in ``xs.dtype``."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(gs):
        # a traced step on fake tensors (launch/dryrun.py): the run
        # lengths are data it does not have; each product is counted as
        # ragged_dot computes it, over the whole capacity buffer
        return (F.silu(xs @ wg[0]) * (xs @ wu[0])) @ wo[0]
    ye = xs.new_zeros((xs.shape[0], wo.shape[-1]))
    start = 0
    for e, n in enumerate(gs.tolist()):         # the one host sync
        if n:
            xg = xs[start:start + n]
            ye[start:start + n] = (F.silu(xg @ wg[e]) * (xg @ wu[e])) @ wo[e]
        start += n
    return ye


def _combine(contrib: torch.Tensor, tok: torch.Tensor, valid: torch.Tensor,
             T: int, k: int) -> torch.Tensor:
    """``zeros((T, d)).at[tok].add(contrib)`` as the serial scatter-add:
    each token's rows added one after another in row order, rounding in
    ``contrib.dtype`` after each add.  A token holds at most ``k`` valid
    rows (its distinct (token, slot) units); rows not ``valid`` add zero
    and go to a spare row."""
    n, d = contrib.shape
    tok = torch.where(valid, tok, T).long()
    perm = torch.argsort(tok, stable=True)
    counts = _counts(tok, T + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(tok)
    rank[perm] = torch.arange(n, device=tok.device) - starts[tok[perm]]
    rank = torch.where(valid, rank, 0)
    table = contrib.new_zeros((T + 1, k, d))
    table[tok, rank] = contrib
    y = contrib.new_zeros((T, d))
    for r in range(k):
        y = y + table[:T, r]
    return y


class Dispatch(NamedTuple):
    """One MoE layer's routing: the aux loss, each unit's weight, the
    compacted unit ids and their validity, the local expert of each
    compacted unit (``e_loc`` for the sentinel), the stable sort by expert
    and the group sizes."""
    aux: torch.Tensor
    weight: torch.Tensor
    packed: torch.Tensor
    pv: torch.Tensor
    le: torch.Tensor
    order: torch.Tensor
    gs: torch.Tensor


def route(x: torch.Tensor, router: torch.Tensor, spec: MoESpec,
          n_shards: int = 1, my: int = 0) -> Dispatch:
    """Top-k routing, the load-balance + z losses, unit selection and the
    EARTH compaction of ``moe_ffn_local`` (this device holds experts
    ``[my * E / n_shards, (my + 1) * E / n_shards)``)."""
    T = x.shape[0]
    E, k = spec.n_experts, spec.top_k
    e_loc = E // n_shards

    logits = (x @ router.to(x.dtype)).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)                                 # (T, k)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    # ---- aux (load-balance + z) losses ----
    dispatch_frac = torch.zeros((E,), dtype=torch.float32,
                                device=x.device).index_add_(
        0, topi.reshape(-1), torch.full((T * k,), 1.0 / (T * k),
                                        dtype=torch.float32, device=x.device))
    aux = E * torch.sum(dispatch_frac * torch.mean(probs, dim=0))
    zloss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = spec.aux_coef * (aux + 1e-3 * zloss)

    # ---- unit selection & EARTH compaction ----
    expert = topi.reshape(-1).to(torch.int32)                    # (T*k,)
    mine = (expert >= my * e_loc) & (expert < (my + 1) * e_loc)
    cap = _capacity(T, k, n_shards, spec.capacity_slack)
    packed, pv = _compact_ids(mine, cap, spec.dispatch)          # (cap,)
    le = torch.where(pv, expert[packed.long()] - my * e_loc, e_loc)
    order = torch.argsort(le, stable=True)
    gs = _counts(le[order].long(), e_loc + 1)[:e_loc]
    return Dispatch(aux, topw.reshape(-1), packed, pv, le, order, gs)


def moe_ffn_local(router, wg, wu, wo, x: torch.Tensor, spec: MoESpec, *,
                  model_axis: str | None = None, data_axes: tuple = (),
                  n_shards: int = 1, shard: int = 0,
                  axes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-device MoE body. x: (T, d). Returns (y (T, d), aux loss scalar).

    ``wg``, ``wu``, ``wo`` hold this device's ``E / n_shards`` experts and
    the capacity is per shard.  Inside :func:`moe_layer`'s ``shard_map``,
    ``axes`` (a ``dist.sharding.Axes``) gives the device's index on
    ``model_axis`` (which experts it holds) and averages the aux over
    ``data_axes``; the partial ``y`` is summed by the caller.  Outside it
    (``axes`` None) the device holds the experts of model shard
    ``shard`` (the first by default: the parity tests use that to reach
    dropped units)."""
    my = axes.index(model_axis) if axes is not None and model_axis \
        else shard
    r = route(x, router, spec, n_shards, my)
    aux = r.aux
    if axes is not None and data_axes:
        aux = axes.pmean(aux, data_axes)
    return _experts(x, r.weight, r, wg, wu, wo, spec), aux


def _experts(x: torch.Tensor, weight: torch.Tensor, r: Dispatch, wg, wu,
             wo, spec: MoESpec) -> torch.Tensor:
    """The partial output (T, d) of the experts ``wg`` / ``wu`` / ``wo``
    over the units ``r`` compacted for them, each weighted by
    ``weight``."""
    pidx = r.packed.long()
    tok = pidx // spec.top_k
    xe = x[tok] * r.pv[:, None].to(x.dtype)                      # (cap, d)
    ye = _grouped_ffn(xe[r.order], wg, wu, wo, r.gs)             # (cap, d)

    # ---- unsort + weighted combine ----
    w_packed = weight[pidx] * r.pv.to(weight.dtype)
    contrib = (ye.float() * w_packed[r.order][:, None]).to(x.dtype)
    return _combine(contrib, tok[r.order], r.pv[r.order], x.shape[0],
                    spec.top_k)


def _rank_experts(params, x: torch.Tensor, spec: MoESpec,
                  ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel body on this rank's batch block ``x`` (B, S, d),
    replicated over the model axis of ``ctx`` (the mesh's ``ShardCtx``),
    under autograd.  ``params``' banks are the rank's block of experts
    (a whole bank is sliced to it).  Routes the block's tokens over all
    experts (the aux the block's estimate), runs the units of its own
    experts (capacity per shard) and sums the partial outputs over the
    model axis with a ``psum`` (the activations are replicated there, so
    the reference's ``psum_scatter`` over the sequence would only split
    what every rank holds)."""
    from repro_torch.dist import sharding
    B, S, d = x.shape
    mesh, m_ax, m = ctx.mesh, ctx.model_axis, ctx.model_size
    my = sharding.axis_index(mesh, m_ax)
    e_loc = spec.n_experts // m
    if spec.n_experts % m:
        raise ValueError(f"{spec.n_experts} experts do not split over a "
                         f"model axis of {m}")
    banks = []
    for k in ("wg", "wu", "wo"):
        w = params[k]
        if w.shape[0] == spec.n_experts and m > 1:
            # a bank held whole: its gradient is every rank's block
            w = sharding.sum_grads(w, mesh, m_ax)[my * e_loc:
                                                  (my + 1) * e_loc]
        elif w.shape[0] != e_loc:
            raise ValueError(f"expert bank {k} holds {w.shape[0]} experts; "
                             f"a rank of a model axis of {m} holds {e_loc}")
        banks.append(w)
    xt = x.reshape(B * S, d)
    r = route(xt, params["router"], spec, m, my)
    y = _experts(sharding.sum_grads(xt, mesh, m_ax),
                 sharding.sum_grads(r.weight, mesh, m_ax), r, *banks, spec)
    return sharding.global_sum(y, mesh, m_ax).reshape(B, S, d), r.aux


def expert_parallel_plain(params, x: torch.Tensor, spec: MoESpec, data: int,
                          model: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The function :func:`moe_layer` computes on a (``data``, ``model``)
    mesh, in one process: each of the ``data`` blocks of the batch routed
    alone, each model shard's experts through :func:`moe_ffn_local` (its
    own capacity), the shards' outputs summed in shard order and the
    blocks' aux estimates averaged.  With ``(1, 1)`` it is the one-device
    layer.  The oracle of the mesh tests and ``chip_smoke.py`` (no JAX
    there)."""
    B, S, d = x.shape
    e = spec.n_experts // model
    ys, aux = [], 0.0
    for xl in x.reshape(data, B // data * S, d):
        y = None
        for j in range(model):
            yj, aux_j = moe_ffn_local(
                params["router"], *(params[k][j * e:(j + 1) * e]
                                    for k in ("wg", "wu", "wo")),
                xl, spec, n_shards=model, shard=j)
            y = yj if y is None else y + yj
        ys.append(y)
        aux = aux + aux_j
    return torch.stack(ys).reshape(B, S, d), aux / data


def moe_layer(params, x: torch.Tensor, spec: MoESpec,
              ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). ctx: a ``dist.sharding.ShardCtx`` or None (one
    device), or the mesh forward's ``dist.sharding.RankLocal``
    (:func:`_rank_experts`).

    With a mesh, the experts shard over the model axis and the batch over
    the data axes (operands placed so as ``DTensor`` s, or plain full
    tensors each rank slices).  The model-axis reduction of the partial
    outputs is a ``psum_scatter`` over the sequence dim when the model
    axis divides it (the result a ``DTensor`` sharded on the batch over
    the data axes and on the sequence over the model axis), else a
    ``psum``; a result sharded on nothing is the plain tensor every rank
    holds."""
    from repro_torch.dist.sharding import resident_axis
    if resident_axis(ctx) is not None:
        return _rank_experts(params, x, spec, ctx.experts)
    B, S, d = x.shape
    m_ax = ctx.model_axis if ctx is not None else None
    m_sz = ctx.model_size if ctx is not None else 1
    seq_scatter = m_ax is not None and S % m_sz == 0 and S >= m_sz
    data_axes = ctx.data_axes if ctx is not None else ()

    def body(axes, router, wg, wu, wo, xl):
        Tl = xl.shape[0] * xl.shape[1]
        y, aux = moe_ffn_local(router, wg, wu, wo, xl.reshape(Tl, d), spec,
                               model_axis=m_ax, data_axes=data_axes,
                               n_shards=m_sz, axes=axes)
        y = y.reshape(xl.shape)
        if axes is not None and m_ax is not None:
            y = (axes.psum_scatter(y, m_ax, 1) if seq_scatter
                 else axes.psum(y, m_ax))
        return y, aux

    operands = (params["router"], params["wg"], params["wu"], params["wo"],
                x)
    if ctx is None or ctx.mesh is None:
        return body(None, *operands)

    from repro_torch.dist.sharding import P, shard_map
    ba = data_axes if data_axes else None
    sm = shard_map(body, mesh=ctx.mesh,
                   in_specs=(P(), P(m_ax), P(m_ax), P(m_ax),
                             P(ba, None, None)),
                   out_specs=(P(ba, m_ax if seq_scatter else None, None),
                              P()))
    return sm(*operands)
