"""Static shift-plan compiler — EARTH's DROM routing folded at plan time.

A copy of the reference package's NumPy plan compiler (``repro``'s
``core/shiftplan.py``), kept here so the port never imports that package.
Two changes: plans memoize in the port's own ``vx.cache.PLANS``, and the
permute cost penalty is fixed at the non-TPU value (see
:func:`_permute_penalty`), so every plan is byte-equal to the reference's
CPU plan.  Nothing here waits for a later slice.

The dynamic networks in ``core/shiftnet.py`` carry (payload, shiftcnt,
valid) through every one of ``log2(n)`` layers and re-derive the per-layer
routing decision with runtime arithmetic.  But almost every call site in
this repo routes a pattern that is *fully determined by static Python ints*
(stride, offset, vl, field count).  This module simulates the network once
in NumPy at trace time and emits a :class:`ShiftPlan`:

* per-layer **constant boolean take-masks** (folded into the kernel as
  literals — Mosaic/XLA see them as constants),
* **layer pruning**: layers in which no element moves are dropped entirely
  (a stride-2 gather needs about half the layers; single-transaction
  patterns often need 1-2),
* the per-layer *triple* shift (payload + shiftcnt + valid) collapses to
  **one static shift + one select per active layer**,
* the final occupancy mask and source map are compile-time constants.

Three plan families:

1. monotone gather/scatter (closed-form SCG counts — the §4.2 paths),
2. batched gather/scatter — one plan routing a stacked ``(T, n)`` block of
   coalesced transactions (per-row constant masks; used by core/lsdo.py),
3. arbitrary permutations (the fused segment transposition): bit-fixing
   butterfly routing when it is conflict-free, else a Benes network
   (2*log2(n)-1 exchange stages, conflict-free for ANY permutation by the
   looping algorithm).

The dynamic-count network remains the runtime-stride fallback and the
property-test oracle (tests/test_property_shiftnet.py).

Every plan constructor is memoized in the unified spec-keyed LRU
(``repro_torch.vx.cache.PLANS``) — one cache for shift plans, the
runtime-stride bank, and vx dispatch executors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.vx.cache import memoize as _memoize


def num_layers(n: int) -> int:
    """Layers needed so any shift in [0, n-1] is representable."""
    if n <= 1:
        return 0
    return max(1, math.ceil(math.log2(n)))


def _np_shift(x: np.ndarray, k: int, fill) -> np.ndarray:
    """NumPy mirror of shiftnet.shift_static: result[i] = x[i + k]."""
    n = x.shape[-1]
    if k == 0:
        return x.copy()
    out = np.full_like(x, fill)
    if abs(k) >= n:
        return out
    if k > 0:
        out[..., : n - k] = x[..., k:]
    else:
        out[..., -k:] = x[..., : n + k]
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class PlanLayer:
    """One network layer: ``out = select(masks, statically shifted copies)``.

    All (shift, mask) pairs read the SAME input snapshot (masks are
    disjoint); slots covered by no mask keep their value.  Monotone plans
    have a single pair per layer; Benes exchange stages have two (+d / -d).
    """
    shifts: tuple[int, ...]
    masks: tuple[np.ndarray, ...]          # bool, broadcastable to payload


@dataclasses.dataclass(frozen=True, eq=False)
class ShiftPlan:
    n: int                                 # routed width
    kind: str                              # gather|scatter|permute|counts
    layers: tuple[PlanLayer, ...]          # pruned: only active layers
    valid: np.ndarray                      # occupancy after routing
    source: np.ndarray                     # source[slot] = input idx or -1
    conflict: bool                         # compile-time §4.1.4 violation

    @property
    def active_layers(self) -> int:
        return len(self.layers)

    @property
    def total_layers(self) -> int:
        return num_layers(self.n)

    @property
    def num_shifts(self) -> int:
        """Static shift op count."""
        return sum(len(l.shifts) for l in self.layers)

    @property
    def wide_ops(self) -> int:
        """Full-width ops per application: each layer pays its shifts plus
        one (multi-way) select on the wide payload."""
        return sum(len(l.shifts) + 1 for l in self.layers)


# ---------------------------------------------------------------------------
# NumPy closed-form SCG counts (mirrors core/scg.py, host-side)
# ---------------------------------------------------------------------------

def gather_counts_np(n, stride, offset, vl):
    p = np.arange(n, dtype=np.int64)
    s = max(int(stride), 1)
    rel = p - int(offset)
    dest = rel // s
    valid = (rel >= 0) & (rel % s == 0) & (dest < int(vl))
    shift = np.where(valid, p - dest, 0)
    return shift, valid


def scatter_counts_np(n, stride, offset, vl):
    i = np.arange(n, dtype=np.int64)
    valid = i < int(vl)
    shift = np.where(valid, int(offset) + i * (int(stride) - 1), 0)
    return shift, valid


# ---------------------------------------------------------------------------
# Monotone network simulation (the compile-time twin of shiftnet._route)
# ---------------------------------------------------------------------------

def _simulate_route(shift, valid, *, toward_zero: bool, lsb_first: bool):
    """Run the layer loop in NumPy; returns (bit->take-mask dict, valid,
    source, conflict).  The take-mask of layer ``l`` is the network's
    ``cand_valid`` — a constant once (shift, valid) are static."""
    shift = np.asarray(shift, np.int64)
    valid = np.asarray(valid, bool)
    n = shift.shape[-1]
    layers = num_layers(n)
    order = range(layers) if lsb_first else range(layers - 1, -1, -1)
    direction = 1 if toward_zero else -1
    source = np.where(valid, np.arange(n), -1)
    conflict = False
    n_valid0 = int(valid.sum())

    masks: dict[int, np.ndarray] = {}
    for l in order:
        k = 1 << l
        bit = (shift >> l) & 1
        stay = valid & (bit == 0)
        cand_shift = _np_shift(shift, direction * k, 0)
        cand_valid = (_np_shift(valid, direction * k, False)
                      & (((cand_shift >> l) & 1) == 1))
        conflict = conflict or bool(np.any(cand_valid & stay))
        masks[l] = cand_valid
        source = np.where(cand_valid, _np_shift(source, direction * k, -1),
                          np.where(stay, source, -1))
        shift = np.where(cand_valid, cand_shift, shift)
        valid = cand_valid | stay
    conflict = conflict or int(valid.sum()) != n_valid0
    return masks, valid, source, conflict


def _monotone_plan(shift, valid, *, kind: str, toward_zero: bool,
                   lsb_first: bool) -> ShiftPlan:
    n = np.asarray(shift).shape[-1]
    masks, out_valid, source, conflict = _simulate_route(
        shift, valid, toward_zero=toward_zero, lsb_first=lsb_first)
    direction = 1 if toward_zero else -1
    layers = []
    order = (sorted(masks) if lsb_first else sorted(masks, reverse=True))
    for l in order:
        if masks[l].any():                 # prune no-op layers
            layers.append(PlanLayer((direction * (1 << l),), (masks[l],)))
    return ShiftPlan(n, kind, tuple(layers), out_valid, source, conflict)


@_memoize("plan.gather")
def gather_plan(n: int, stride: int, offset: int, vl: int) -> ShiftPlan:
    """Compiled GSN for a strided load window (§4.2 closed form)."""
    shift, valid = gather_counts_np(n, stride, offset, vl)
    return _monotone_plan(shift, valid, kind="gather", toward_zero=True,
                          lsb_first=True)


@_memoize("plan.scatter")
def scatter_plan(n: int, stride: int, offset: int, vl: int) -> ShiftPlan:
    """Compiled SSN for a strided store window."""
    shift, valid = scatter_counts_np(n, stride, offset, vl)
    return _monotone_plan(shift, valid, kind="scatter", toward_zero=False,
                          lsb_first=False)


def host_counts(shift, valid) -> bool:
    """True when both counts are host data (numpy arrays, tuples, lists),
    which compile to a :func:`counts_plan`; tensors take the dynamic
    network."""
    host = (np.ndarray, tuple, list)
    return isinstance(shift, host) and isinstance(valid, host)


@_memoize("plan.counts")
def counts_plan(shift: tuple, valid: tuple, *, gather: bool) -> ShiftPlan:
    """Compiled network for arbitrary *static* per-lane counts (the
    shift_gather/shift_scatter fast path when the SCG output is host data)."""
    return _monotone_plan(np.asarray(shift), np.asarray(valid),
                          kind="counts", toward_zero=gather,
                          lsb_first=gather)


# ---------------------------------------------------------------------------
# Batched transaction plans (LSDO: route all coalesced requests in one call)
# ---------------------------------------------------------------------------

def _batched_plan(count_fn, n: int, rows: tuple, *, kind: str,
                  toward_zero: bool, lsb_first: bool) -> ShiftPlan:
    """One plan routing a stacked (T, n) block: row t carries transaction
    t's window, described by a (stride, offset, count) triple — rows may
    come from DIFFERENT accesses (the whole-step super-transaction).  Layer
    masks are (T, n) constants; a layer survives pruning if ANY row moves
    an element in it, so depth is the union of the per-row active sets
    (still <= log2(n))."""
    T = len(rows)
    per_bit: dict[int, list[np.ndarray]] = {}
    valid = np.zeros((T, n), bool)
    source = np.full((T, n), -1)
    conflict = False
    for t, (stride, off, cnt) in enumerate(rows):
        shift_t, valid_t = count_fn(n, stride, off, cnt)
        masks, v, s, c = _simulate_route(shift_t, valid_t,
                                         toward_zero=toward_zero,
                                         lsb_first=lsb_first)
        conflict = conflict or c
        valid[t], source[t] = v, s
        for l, m in masks.items():
            per_bit.setdefault(l, [np.zeros(n, bool)] * T)
            per_bit[l] = [m if i == t else x
                          for i, x in enumerate(per_bit[l])]
    direction = 1 if toward_zero else -1
    layers = []
    order = sorted(per_bit) if lsb_first else sorted(per_bit, reverse=True)
    for l in order:
        stacked = np.stack(per_bit[l])
        if stacked.any():
            layers.append(PlanLayer((direction * (1 << l),), (stacked,)))
    return ShiftPlan(n, kind, tuple(layers), valid, source, conflict)


@_memoize("plan.batched_gather")
def batched_gather_plan(n: int, stride: int, offsets: tuple,
                        counts: tuple) -> ShiftPlan:
    rows = tuple((stride, o, c) for o, c in zip(offsets, counts))
    return _batched_plan(gather_counts_np, n, rows,
                         kind="gather", toward_zero=True, lsb_first=True)


@_memoize("plan.batched_scatter")
def batched_scatter_plan(n: int, stride: int, offsets: tuple,
                         counts: tuple) -> ShiftPlan:
    rows = tuple((stride, o, c) for o, c in zip(offsets, counts))
    return _batched_plan(scatter_counts_np, n, rows,
                         kind="scatter", toward_zero=False, lsb_first=False)


@_memoize("plan.multi_gather")
def multi_gather_plan(n: int, rows: tuple) -> ShiftPlan:
    """Whole-step super-transaction plan: one (T, n) batched plan whose rows
    are the concatenated transactions of SEVERAL accesses — each row its
    own (stride, offset, count).  One network application and one mask
    operand cover every strided load a step issues at this mlen."""
    return _batched_plan(gather_counts_np, n, rows,
                         kind="gather", toward_zero=True, lsb_first=True)


@_memoize("plan.multi_scatter")
def multi_scatter_plan(n: int, rows: tuple) -> ShiftPlan:
    """Scatter twin of :func:`multi_gather_plan`."""
    return _batched_plan(scatter_counts_np, n, rows,
                         kind="scatter", toward_zero=False, lsb_first=False)


# ---------------------------------------------------------------------------
# Arbitrary permutations (fused segment transposition)
# ---------------------------------------------------------------------------

def _bitfix_stages(dest: np.ndarray, order) -> list | None:
    """Butterfly bit-fixing: at stage l an element whose position disagrees
    with its destination in bit l hops by +-2^l.  Conflict-free only for
    some permutations — returns None on collision (caller falls to Benes)."""
    n = dest.shape[0]
    stages = []
    d = dest.copy()
    for l in order:
        k = 1 << l
        new = np.full(n, -1)
        take_hi = np.zeros(n, bool)        # out[i] = in[i + k]
        take_lo = np.zeros(n, bool)        # out[i] = in[i - k]
        for slot in range(n):
            t = d[slot]
            if t < 0:
                continue
            ns = slot ^ k if ((slot ^ t) >> l) & 1 else slot
            if new[ns] != -1:
                return None
            new[ns] = t
            if ns < slot:
                take_hi[ns] = True
            elif ns > slot:
                take_lo[ns] = True
        d = new
        stages.append((k, take_hi, take_lo))
    assert all(d[s] in (-1, s) for s in range(n))
    return stages


def _benes_exchanges(perm: np.ndarray) -> list:
    """Benes looping decomposition: list of (distance, swap_flags) stages,
    outer distance n/2 first and last, distance-1 switches in the middle.
    ``swap_flags[i]`` (i in the low half of a pair) marks pair (i, i+d)."""
    n = perm.shape[0]
    stages_pre: list = []
    stages_post: list = []

    def route(sub_perm: np.ndarray, base: int, depth: int,
              pre: list, post: list):
        m = sub_perm.shape[0]
        if m == 1:
            return
        h = m // 2
        if m == 2:
            pre.append((1, base, np.array([sub_perm[0] == 1])))
            return
        inv = np.empty(m, dtype=np.int64)
        inv[sub_perm] = np.arange(m)
        color = np.full(m, -1)
        for s0 in range(m):
            if color[s0] != -1:
                continue
            stack = [(s0, 0)]
            while stack:
                s, c = stack.pop()
                if color[s] != -1:
                    continue
                color[s] = c
                stack.append((s ^ h, 1 - c))
                stack.append((int(inv[sub_perm[s] ^ h]), 1 - c))
        # entry switches: low slot of each pair gets the color-0 element
        swap_in = np.array([color[i] == 1 for i in range(h)])
        # exit switches: output pair (j, j+h) — swap iff the element
        # destined for low output j routed through the bottom half
        swap_out = np.array(
            [color[int(inv[j])] == 1 for j in range(h)])
        # positions after the entry stage
        top_src = np.where(swap_in, np.arange(h) + h, np.arange(h))
        bot_src = np.where(swap_in, np.arange(h), np.arange(h) + h)
        top_perm = np.array([sub_perm[s] % h for s in top_src])
        bot_perm = np.array([sub_perm[s] % h for s in bot_src])
        pre.append((h, base, swap_in))
        post.append((h, base, swap_out))
        route(top_perm, base, depth + 1, pre, post)
        route(bot_perm, base + h, depth + 1, pre, post)

    pre: list = []
    post: list = []
    route(perm, 0, 0, pre, post)
    return pre, post


def _merge_exchange_stages(raw: list, n: int) -> dict:
    """Group (distance, base, swap_flags) entries of the same distance into
    full-width swap masks (independent subnetworks share stages)."""
    by_d: dict[int, np.ndarray] = {}
    for d, base, flags in raw:
        m = by_d.setdefault(d, np.zeros(n, bool))
        idx = base + np.nonzero(flags)[0]
        m[idx] = True
    return by_d


def _exchange_layers(by_d: dict, order: list) -> list:
    layers = []
    for d in order:
        swap = by_d.get(d)
        if swap is None or not swap.any():
            continue
        take_hi = np.zeros(swap.shape[0], bool)
        take_lo = np.zeros(swap.shape[0], bool)
        lo_idx = np.nonzero(swap)[0]
        take_hi[lo_idx] = True             # out[i]   = in[i + d]
        take_lo[lo_idx + d] = True         # out[i+d] = in[i]
        layers.append(PlanLayer((d, -d), (take_hi, take_lo)))
    return layers


def apply_np(plan: ShiftPlan, x: np.ndarray) -> np.ndarray:
    """Host-side plan application (used for compile-time verification and
    as a test oracle). x: (..., plan.n)."""
    for layer in plan.layers:
        y = x.copy()
        for s, m in zip(layer.shifts, layer.masks):
            y = np.where(m, _np_shift(x, s, 0), y)
        x = y
    return x


def _checked(plan: ShiftPlan) -> ShiftPlan:
    """Assert the compiled routing delivers source[t] to every valid slot."""
    lane = np.arange(plan.n)
    x = np.broadcast_to(lane, plan.valid.shape).copy()
    out = apply_np(plan, x)
    ok = np.where(plan.valid, out == plan.source, True)
    assert bool(np.all(ok)), f"mis-routed {plan.kind} plan (n={plan.n})"
    return plan


@_memoize("plan.permutation")
def permutation_plan(dest: tuple) -> ShiftPlan:
    """Plan routing input slot p to slot dest[p] (-1 = don't-care lane).

    Tries single-butterfly bit-fixing both bit orders (log2 stages, often
    fewer after pruning); falls back to a Benes decomposition (always
    routable, 2*log2-1 exchange stages).  Width is padded to a power of two
    internally — callers pad the payload to ``plan.n`` lanes.
    """
    d = np.asarray(dest, np.int64)
    n0 = d.shape[0]
    n = 1 << num_layers(n0) if n0 > 1 else 1
    full = np.concatenate([d, np.arange(n0, n)]) if n > n0 else d.copy()
    L = num_layers(n)
    valid = np.zeros(n, bool)
    source = np.full(n, -1)
    for p, t in enumerate(full):
        if t >= 0:
            valid[t] = True
            source[t] = p

    for order in (range(L - 1, -1, -1), range(L)):
        stages = _bitfix_stages(full, order)
        if stages is None:
            continue
        layers = []
        for k, hi, lo in stages:
            shifts, masks = [], []
            if hi.any():
                shifts.append(k)
                masks.append(hi)
            if lo.any():
                shifts.append(-k)
                masks.append(lo)
            if shifts:
                layers.append(PlanLayer(tuple(shifts), tuple(masks)))
        return _checked(
            ShiftPlan(n, "permute", tuple(layers), valid, source, False))

    # Benes: complete don't-care lanes into a full permutation first
    perm = full.copy()
    used = set(int(t) for t in perm if t >= 0)
    free = iter([t for t in range(n) if t not in used])
    for p in range(n):
        if perm[p] < 0:
            perm[p] = next(free)
    pre, post = _benes_exchanges(perm)
    by_d_pre = _merge_exchange_stages(pre, n)
    by_d_post = _merge_exchange_stages(post, n)
    dists = sorted(by_d_pre, reverse=True)
    layers = _exchange_layers(by_d_pre, dists)
    layers += _exchange_layers(by_d_post, sorted(by_d_post))
    return _checked(
        ShiftPlan(n, "permute", tuple(layers), valid, source, False))


# A Benes pass is one long dependency chain of exchange stages, while
# per-field passes are ``fields`` independent chains.  The reference weighs
# a permute wide-op at 2x on TPU and 6x elsewhere; the port has no TPU, so
# the weight is the non-TPU 6 with no platform probe.  At main-path widths
# (n=256 and n=6144, FIELD=2) this picks ``per_field`` in both directions.
def _permute_penalty() -> int:
    return 6


@_memoize("plan.segment_deint")
def segment_deinterleave_plans(n: int, fields: int
                               ) -> tuple[str, tuple[ShiftPlan, ...]]:
    """Cost-modeled segment-load routing: ('fused', (permutation_plan,)) —
    ONE O(log n) pass emitting every field — when its wide-op count beats
    ``fields`` compiled per-field passes, else ('per_field', plans).

    The crossover is real: a Benes pass costs ~3*(2*log2(n)-1) wide ops
    regardless of ``fields``, while per-field compiled passes cost
    ~2*fields*log2(n) — so small field counts route per-field and large
    ones fuse.  Either way the masks are constants and the whole op is one
    kernel."""
    fused = deinterleave_plan(n, fields)
    per = tuple(gather_plan(n, fields, f, n // fields)
                for f in range(fields))
    if fused.wide_ops * _permute_penalty() <= sum(p.wide_ops for p in per):
        return "fused", (fused,)
    return "per_field", per


@_memoize("plan.segment_int")
def segment_interleave_plans(n: int, fields: int
                             ) -> tuple[str, tuple[ShiftPlan, ...]]:
    """Segment-store twin of :func:`segment_deinterleave_plans` (per-field
    passes pay one extra merge select each)."""
    fused = interleave_plan(n, fields)
    per = tuple(scatter_plan(n, fields, f, n // fields)
                for f in range(fields))
    if fused.wide_ops * _permute_penalty() <= \
            sum(p.wide_ops + 1 for p in per):
        return "fused", (fused,)
    return "per_field", per


@_memoize("plan.deinterleave")
def deinterleave_plan(n: int, fields: int) -> ShiftPlan:
    """AoS (f0 f1 .. f0 f1 ..) -> concatenated SoA fields, one fused pass."""
    assert n % fields == 0
    m = n // fields
    p = np.arange(n)
    dest = (p % fields) * m + p // fields
    return permutation_plan(tuple(int(x) for x in dest))


@_memoize("plan.interleave")
def interleave_plan(n: int, fields: int) -> ShiftPlan:
    """Concatenated SoA fields -> AoS beat (inverse fused transposition)."""
    assert n % fields == 0
    m = n // fields
    p = np.arange(n)
    dest = (p % m) * fields + p // m
    return permutation_plan(tuple(int(x) for x in dest))


# ---------------------------------------------------------------------------
# Shard-local rebasing (the SPMD arm of the plan layer)
# ---------------------------------------------------------------------------

@_memoize("plan.shard_rows")
def shard_strided_rows(n: int, stride: int, offset: int, vl: int,
                       nshards: int) -> tuple:
    """Per-shard rebased sub-accesses of a strided pattern over a window
    sharded into ``nshards`` contiguous equal blocks.

    For shard ``r`` owning global lanes ``[r*nl, (r+1)*nl)`` (with
    ``nl = n // nshards``), returns ``(out_lo, count, local_offset)``:
    output lanes ``[out_lo, out_lo + count)`` of the global access land in
    shard ``r``, and inside the shard they are the plain strided pattern
    ``local[local_offset + i*stride]`` — i.e. the shard-local program is
    the SAME plan family with a rebased offset, so sharded lowering reuses
    the unsharded plan compiler per shard.  ``count == 0`` marks a shard
    the access never touches (its branch is dead).

    Requires ``stride > 0`` (callers normalize negative strides with the
    Reverser first) and ``n % nshards == 0``.
    """
    if stride <= 0:
        raise ValueError(f"shard rebasing needs stride > 0, got {stride}")
    if nshards <= 0 or n % nshards:
        raise ValueError(f"window of {n} lanes does not split into "
                         f"{nshards} equal shards")
    nl = n // nshards
    rows = []
    for r in range(nshards):
        lo_lane, hi_lane = r * nl, (r + 1) * nl
        i_lo = max(0, -(-(lo_lane - offset) // stride))     # ceil div
        i_hi = min(vl, (hi_lane - 1 - offset) // stride + 1)
        if i_hi <= i_lo:
            rows.append((0, 0, 0))
            continue
        rows.append((i_lo, i_hi - i_lo, offset + i_lo * stride - lo_lane))
    return tuple(rows)
