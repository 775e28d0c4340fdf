"""LSDO — Load/Store Data Organization (EARTH §4.4, §5.1), as torch ops.

Port of ``repro``'s ``core/lsdo.py``.  The Load/Store Address Sequencer
splits a strided vector access into the minimum number of aligned-MLEN
transactions: all elements falling into the same aligned region are
coalesced into one memory request.  The planner is static Python; the
loads and stores run the per-transaction reorganization as compiled
batched shift plans (``batched=True``) or as the dynamic-count networks
(``batched=False``, the loop oracle), on plain torch ops as the reference
runs on jnp.

Negative strides are handled by the Reverser (EARTH §3.2.2): plan on the
reversed element order, then reverse the assembled output.  Buffer
addresses follow ``jnp.take`` / ``.at[].set(mode="drop")``: an index in
``[-N, 0)`` counts from the end, reads past the end clamp to the last
element, reads below ``-N`` give the fill value, and writes outside
``[-N, N)`` are dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import scg, shiftnet, shiftplan


@dataclasses.dataclass(frozen=True)
class Transaction:
    """One coalesced memory request (a LIFQ/SIFQ entry)."""
    region: int        # aligned region index (region_start = region * mlen)
    first_elem: int    # index of the first vector element served
    count: int         # number of vector elements served by this request
    offset: int        # in-region offset of the first element


@dataclasses.dataclass(frozen=True)
class AccessPlan:
    base: int
    stride: int        # in elements; may be negative (Reverser engaged)
    vl: int
    mlen: int          # elements per aligned region / transaction
    reversed: bool
    transactions: tuple[Transaction, ...]

    @property
    def num_transactions(self) -> int:
        return len(self.transactions)

    @property
    def element_wise_transactions(self) -> int:
        """What element-wise access would issue."""
        return self.vl

    @property
    def coalescing_factor(self) -> float:
        return self.vl / max(1, len(self.transactions))


def plan_strided(base: int, stride: int, vl: int, mlen: int) -> AccessPlan:
    """LAS/SAS split: group elements by aligned region (order-preserving)."""
    if vl <= 0:
        return AccessPlan(base, stride, vl, mlen, False, ())
    rev = stride < 0
    b, s = (base + (vl - 1) * stride, -stride) if rev else (base, stride)
    s = max(s, 1) if stride == 0 else s  # stride 0 == broadcast: one region
    txs: list[Transaction] = []
    cur_region, first, count, off = None, 0, 0, 0
    for i in range(vl):
        addr = b + i * s
        region, in_off = addr // mlen, addr % mlen
        if region != cur_region:
            if count:
                txs.append(Transaction(cur_region, first, count, off))
            cur_region, first, count, off = region, i, 1, in_off
        else:
            count += 1
    txs.append(Transaction(cur_region, first, count, off))
    return AccessPlan(base, stride, vl, mlen, rev, tuple(txs))


def _tx_meta(plan: AccessPlan):
    txs = plan.transactions
    starts = np.array([tx.region * plan.mlen for tx in txs])
    offsets = tuple(tx.offset for tx in txs)
    counts = tuple(tx.count for tx in txs)
    firsts = tuple(tx.first_elem for tx in txs)
    return starts, offsets, counts, firsts


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an out-of-bounds read."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _take(buffer: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``jnp.take(buffer, idx)`` for ``idx <= N-1``: an index in ``[-N, 0)``
    counts from the end, one below ``-N`` reads the fill value."""
    N = buffer.shape[0]
    oob = idx < -N
    norm = np.where(oob, 0, np.where(idx < 0, idx + N, idx))
    dev = buffer.device
    out = buffer[torch.from_numpy(norm.astype(np.int64)).to(dev)]
    if oob.any():
        out = out.masked_fill(torch.from_numpy(oob).to(dev),
                              _fill_value(buffer.dtype))
    return out


def _put(buffer: torch.Tensor, idx: np.ndarray,
         vals: torch.Tensor) -> torch.Tensor:
    """``buffer.at[idx].set(vals, mode="drop")`` out of place."""
    N = buffer.shape[0]
    keep = (idx >= -N) & (idx < N)
    norm = np.where(idx < 0, idx + N, idx)[keep].astype(np.int64)
    out = buffer.clone()
    out[torch.from_numpy(norm).to(buffer.device)] = \
        vals[torch.from_numpy(keep).to(buffer.device)]
    return out


def _reassemble(routed: torch.Tensor, counts, row0: int,
                mlen: int) -> torch.Tensor:
    flat_idx = np.concatenate([(row0 + t) * mlen + np.arange(c)
                               for t, c in enumerate(counts)])
    return routed[torch.from_numpy(flat_idx).to(routed.device)]


def load_strided(buffer: torch.Tensor, plan: AccessPlan, *,
                 batched: bool = True) -> torch.Tensor:
    """Gather ``vl`` strided elements via coalesced regions + GSN.

    buffer: flat (N,) tensor.  Returns (vl,) dense elements.  The default
    path stacks ALL transactions into one (T, mlen) block, routes it
    through ONE compiled batched plan, and reassembles with one take;
    ``batched=False`` is the per-transaction dynamic-count loop."""
    if plan.vl <= 0:
        return buffer.new_zeros((0,))
    if not batched:
        return _load_strided_loop(buffer, plan)
    s = abs(plan.stride) if plan.stride != 0 else 1
    mlen = plan.mlen
    starts, offsets, counts, _ = _tx_meta(plan)
    idx = starts[:, None] + np.arange(mlen)[None, :]          # (T, mlen)
    block = _take(buffer, np.minimum(idx, buffer.shape[0] - 1))
    bplan = shiftplan.batched_gather_plan(mlen, s, offsets, counts)
    routed = shiftnet.apply_plan(block, bplan, axis=-1)
    out = _reassemble(routed.reshape(-1), counts, 0, mlen)
    return torch.flip(out, (0,)) if plan.reversed else out


def load_strided_many(buffer: torch.Tensor,
                      plans: Sequence[AccessPlan]) -> list[torch.Tensor]:
    """Whole-step LSDO fusion: ALL transactions of several same-mlen
    accesses stacked into one (sum_T, mlen) block, routed by ONE
    multi-access plan (core/shiftplan.multi_gather_plan) — one gather, one
    network application, one reassembly per step instead of one per
    access.  Returns one dense (vl,) output per plan (Reverser applied per
    access)."""
    plans = list(plans)
    live = [p for p in plans if p.vl > 0]
    if not live:
        return [buffer.new_zeros((0,)) for _ in plans]
    mlen = live[0].mlen
    assert all(p.mlen == mlen for p in live), "fusion needs one mlen"
    rows: list[tuple[int, int, int]] = []
    row_starts: list[int] = []
    for p in live:
        s = abs(p.stride) if p.stride != 0 else 1
        starts, offsets, counts, _ = _tx_meta(p)
        rows.extend((s, o, c) for o, c in zip(offsets, counts))
        row_starts.extend(int(x) for x in starts)
    mplan = shiftplan.multi_gather_plan(mlen, tuple(rows))
    idx = np.asarray(row_starts)[:, None] + np.arange(mlen)[None, :]
    block = _take(buffer, np.minimum(idx, buffer.shape[0] - 1))
    routed = shiftnet.apply_plan(block, mplan, axis=-1).reshape(-1)
    outs: list[torch.Tensor] = []
    row0 = 0
    for p in plans:
        if p.vl <= 0:
            outs.append(buffer.new_zeros((0,)))
            continue
        counts = [tx.count for tx in p.transactions]
        out = _reassemble(routed, counts, row0, mlen)
        outs.append(torch.flip(out, (0,)) if p.reversed else out)
        row0 += len(counts)
    return outs


def _region_lanes(buffer: torch.Tensor, start: int,
                  mlen: int) -> torch.Tensor:
    """One aligned region with per-lane clipping (a region whose tail
    hangs past the buffer end is not start-clamped; the clipped lanes are
    invalid by construction)."""
    return _take(buffer, np.minimum(start + np.arange(mlen),
                                    buffer.shape[0] - 1))


def _load_strided_loop(buffer: torch.Tensor,
                       plan: AccessPlan) -> torch.Tensor:
    """Per-transaction dynamic-count fallback."""
    s = abs(plan.stride) if plan.stride != 0 else 1
    pieces = []
    for tx in plan.transactions:
        region = _region_lanes(buffer, tx.region * plan.mlen, plan.mlen)
        shift, valid = scg.gather_counts(plan.mlen, s, tx.offset, tx.count,
                                         device=buffer.device)
        routed = shiftnet.gather_network(region, shift, valid)
        pieces.append(routed.payload[:tx.count])
    out = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    return torch.flip(out, (0,)) if plan.reversed else out


def store_strided(buffer: torch.Tensor, values: torch.Tensor,
                  plan: AccessPlan, *, batched: bool = True) -> torch.Tensor:
    """Scatter ``vl`` dense elements to strided positions via SSN +
    coalesced region writes.  Returns the updated buffer (out of place).

    The default path mirrors :func:`load_strided`: one stacked (T, mlen)
    block, ONE batched scatter-plan pass, one merged region write-back
    (aligned regions are disjoint, so the write has no duplicate
    targets)."""
    if plan.vl <= 0:
        return buffer
    if not batched:
        return _store_strided_loop(buffer, values, plan)
    s = abs(plan.stride) if plan.stride != 0 else 1
    mlen = plan.mlen
    vals = torch.flip(values, (0,)) if plan.reversed else values
    starts, offsets, counts, firsts = _tx_meta(plan)
    src = np.array(firsts)[:, None] + np.arange(mlen)[None, :]
    lane_valid = np.arange(mlen)[None, :] < np.array(counts)[:, None]
    src = np.clip(src, 0, plan.vl - 1)
    dev = buffer.device
    block = torch.where(torch.from_numpy(lane_valid).to(dev),
                        vals[torch.from_numpy(src).to(dev)],
                        torch.zeros((), dtype=vals.dtype, device=dev))
    bplan = shiftplan.batched_scatter_plan(mlen, s, offsets, counts)
    routed = shiftnet.apply_plan(block, bplan, axis=-1)
    idx = starts[:, None] + np.arange(mlen)[None, :]
    old = _take(buffer, np.minimum(idx, buffer.shape[0] - 1))
    merged = torch.where(torch.from_numpy(bplan.valid).to(dev), routed, old)
    return _put(buffer, idx.reshape(-1), merged.reshape(-1))


def _store_strided_loop(buffer: torch.Tensor, values: torch.Tensor,
                        plan: AccessPlan) -> torch.Tensor:
    s = abs(plan.stride) if plan.stride != 0 else 1
    vals = torch.flip(values, (0,)) if plan.reversed else values
    for tx in plan.transactions:
        piece = vals[tx.first_elem:tx.first_elem + tx.count]
        piece = torch.nn.functional.pad(piece, (0, plan.mlen - tx.count))
        shift, valid = scg.scatter_counts(plan.mlen, s, tx.offset, tx.count,
                                          device=buffer.device)
        routed = shiftnet.scatter_network(piece, shift, valid)
        start = tx.region * plan.mlen
        old = _region_lanes(buffer, start, plan.mlen)
        merged = torch.where(routed.valid, routed.payload, old)
        buffer = _put(buffer, start + np.arange(plan.mlen), merged)
    return buffer


def plan_segment_unit(base: int, fields: int, vl: int,
                      mlen: int) -> list[AccessPlan]:
    """Field-wise segment unit-stride access (EARTH §5.2): FIELDS strided
    plans, one per field, each with stride=FIELDS, offset advanced by
    EEWB."""
    return [plan_strided(base + f, fields, vl, mlen) for f in range(fields)]


def transactions_saved(plans: Sequence[AccessPlan]) -> tuple[int, int]:
    """(coalesced, element_wise) request counts — the Fig. 12 x-axis
    quantity."""
    co = sum(p.num_transactions for p in plans)
    ew = sum(p.element_wise_transactions for p in plans)
    return co, ew
