"""Mixture-of-Experts with EARTH-compaction dispatch, on one device.

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

Only the one-device path is ported: :func:`moe_layer` refuses a mesh;
expert parallelism (the ``shard_map`` body over a model axis, its
``psum`` / ``psum_scatter`` and the aux mean over data axes) waits for
the port's dist slice (ROADMAP.md queue A, item 9h).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import vx
from repro_torch.device import refuse_mesh
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
          n_shards: int = 1) -> Dispatch:
    """Top-k routing, the load-balance + z losses, unit selection and the
    EARTH compaction of ``moe_ffn_local`` (this device holds the first
    ``E / n_shards`` experts)."""
    T = x.shape[0]
    E, k = spec.n_experts, spec.top_k
    e_loc = E // n_shards
    my = 0

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
                  n_shards: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-device MoE body. x: (T, d). Returns (y (T, d), aux loss scalar).

    The serve and forward paths call it with one shard.  With ``n_shards >
    1`` this device holds the first ``E / n_shards`` experts (``wg``,
    ``wu``, ``wo`` hold only those) and the capacity shrinks, as in the
    reference outside ``shard_map``: the parity tests use it to reach
    dropped units."""
    T = x.shape[0]
    r = route(x, router, spec, n_shards)
    pidx = r.packed.long()
    tok = pidx // spec.top_k
    xe = x[tok] * r.pv[:, None].to(x.dtype)                      # (cap, d)
    ye = _grouped_ffn(xe[r.order], wg, wu, wo, r.gs)             # (cap, d)

    # ---- unsort + weighted combine ----
    w_packed = r.weight[pidx] * r.pv.to(r.weight.dtype)
    contrib = (ye.float() * w_packed[r.order][:, None]).to(x.dtype)
    y = _combine(contrib, tok[r.order], r.pv[r.order], T, spec.top_k)
    return y, r.aux


def moe_layer(params, x: torch.Tensor, spec: MoESpec,
              ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d); one device (a mesh waits for the dist slice)."""
    refuse_mesh(ctx)
    B, S, d = x.shape
    y, aux = moe_ffn_local(params["router"], params["wg"], params["wu"],
                           params["wo"], x.reshape(B * S, d), spec)
    return y.reshape(B, S, d), aux
