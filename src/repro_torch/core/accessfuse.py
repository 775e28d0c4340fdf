"""Whole-step access fusion — the step-level memory scheduler — and the
runtime-stride plan bank.

Port of ``repro``'s ``core/accessfuse.py``:

* :class:`StepScheduler` collects a step's deinterleave, interleave and
  strided-gather accesses, merges same-shape ones into ONE wide
  transaction through ``vx.program.fuse`` (one kernel launch for the
  group), and executes it through ``vx.lower.executor``.
  ``fuse_split_kv`` is the one fused KV split per decode step (kernel B1,
  or B6 under ``kernel_dynamic``); a group of ``gather_strided`` requests
  with different ``(stride, offset)`` is one launch of the fused strided
  gather (kernel B4), or under ``kernel_dynamic`` one dynamic gather (B8)
  per request, as the reference's ``pallas_dynamic`` loops.  A
  deinterleave or interleave may carry a ``vx.Shard`` placement: its
  group key includes the layout, so a sharded group never merges with a
  replicated one, and it runs shard-locally (each rank splits its block
  of a sequence-sharded cache; ``DTensor`` operands stack block by
  block).
* The runtime-stride plan bank (:func:`bank_gather_strided`,
  :func:`bank_scatter_strided`): compiled plans for strides +-1..8 (the
  §3.2.2 Reverser for the negative half), the dynamic-count network for
  any other stride.  The reference picks a branch with ``lax.switch``
  on a traced stride; eager torch has none, so a tensor stride is read on
  the host once (a sync) and only the branch it selects runs.

Lowering policy:

* :func:`pick_impl` — groups below the policy's fusion threshold ride the
  plain path (the reference's own threshold).
* :func:`platform_impl` — the reference demotes merged ``pallas`` groups
  to ``ref`` off-TPU, because interpret-mode Pallas is no dispatch win
  (``pallas_dynamic`` groups it never demotes).  The port demotes only
  groups whose tensors lie on the CPU, under either kernel impl: on the
  card a merged group reaches its CUDA kernels.
  :func:`pinned_kernel_lowering` (or ``Policy(platform_lowering=False)``)
  turns the demotion off, so a CPU run can count the kernel calls the card
  would launch.

Launch accounting counts calls at the kernel entry points
(``kernels.segment.deinterleave.calls`` / ``.launches``,
``kernels.strided.gather_strided_fused.calls`` ...) in place of the
reference's ``jaxpr_access_counts``.

:func:`compact_indices` is the bank's runtime-count member, the MoE
dispatch primitive: torch ops under every policy, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import scg, shiftnet, shiftplan
from repro_torch.vx import cache as vxcache
from repro_torch.vx import policy as vxpolicy

BANK_STRIDES = vxpolicy.BANK_STRIDES
BANK_FIELDS = vxpolicy.BANK_FIELDS


def pick_impl(total_elems: int, impl: str,
              policy: "vxpolicy.Policy | None" = None) -> str:
    """Scheduler launch policy: tiny accesses ride the plain path."""
    pol = vxpolicy.current() if policy is None else policy
    return pol.with_impl(impl).for_elems(total_elems).impl


_PIN_KERNEL_LOWERING = False


def platform_impl(impl: str, policy: "vxpolicy.Policy | None" = None,
                  device: torch.device | None = None) -> str:
    """Platform arm of the lowering policy: a merged group whose tensors
    lie on the CPU lowers to ``ref`` (the kernels run only on the card).
    Disabled while :func:`pinned_kernel_lowering` is active or when the
    governing policy sets ``platform_lowering=False``."""
    pol = vxpolicy.current() if policy is None else policy
    if impl != "ref" and not _PIN_KERNEL_LOWERING \
            and pol.platform_lowering \
            and (device is None or torch.device(device).type == "cpu"):
        return "ref"
    return impl


@contextlib.contextmanager
def pinned_kernel_lowering():
    """Pin merged groups to the kernel lowering regardless of device, so
    call counts taken on the CPU show the launches the card would make."""
    global _PIN_KERNEL_LOWERING
    prev = _PIN_KERNEL_LOWERING
    _PIN_KERNEL_LOWERING = True
    try:
        yield
    finally:
        _PIN_KERNEL_LOWERING = prev


class Handle:
    """Result slot filled by :meth:`StepScheduler.flush`."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = None


@dataclasses.dataclass
class _Req:
    key: tuple
    payload: Any
    handle: Handle


class StepScheduler:
    """Collects a step's shift-routed accesses and executes them merged.

    Each registered access lowers to a single-transaction program;
    same-key programs merge through ``vx.program.fuse`` into ONE wide
    transaction (payloads stacked along a new leading axis, one kernel
    launch) that executes through ``vx.lower.executor``.  Lowering is
    governed by ONE ``vx.Policy``: ``policy`` (or the ambient one) with
    ``impl`` pinned on top; ``platform_policy=False`` is sugar for
    ``platform_lowering=False``."""

    def __init__(self, impl: str | None = None, *,
                 platform_policy: bool = True,
                 policy: "vxpolicy.Policy | None" = None):
        pol = vxpolicy.resolve(policy).with_impl(impl)
        if not platform_policy:
            pol = dataclasses.replace(pol, platform_lowering=False)
        self.policy = pol
        self.impl = pol.impl
        self._reqs: list[_Req] = []

    def _impl_for(self, total_elems: int, device) -> str:
        return platform_impl(self.policy.for_elems(total_elems).impl,
                             self.policy, device)

    def deinterleave(self, aos: torch.Tensor, fields: int,
                     shard=None) -> Handle:
        from repro_torch.vx.program import layout_of
        h = Handle()
        key = ("deint", fields, tuple(aos.shape), str(aos.dtype),
               str(aos.device), layout_of(shard))
        self._reqs.append(_Req(key, (aos, shard), h))
        return h

    def interleave(self, parts: Sequence[torch.Tensor],
                   shard=None) -> Handle:
        from repro_torch.vx.program import layout_of
        parts = list(parts)
        h = Handle()
        key = ("int", len(parts), tuple(parts[0].shape),
               str(parts[0].dtype), str(parts[0].device), layout_of(shard))
        self._reqs.append(_Req(key, (parts, shard), h))
        return h

    def gather_strided(self, window: torch.Tensor, stride: int, offset: int,
                       vl: int) -> Handle:
        h = Handle()
        key = ("gather", tuple(window.shape), str(window.dtype), vl,
               str(window.device))
        self._reqs.append(_Req(key, (window, int(stride), int(offset)), h))
        return h

    def flush(self) -> None:
        groups: dict[tuple, list[_Req]] = {}
        for r in self._reqs:
            groups.setdefault(r.key, []).append(r)
        for key, reqs in groups.items():
            self._run_group(key, reqs)
        self._reqs = []

    def _fused(self, op: str, specs: list, impl: str, shard=None):
        """lower each access -> fuse the programs -> ONE executor."""
        from repro_torch.vx import lower as vxlower
        from repro_torch.vx import program as vxprogram
        progs = [vxlower.lower(op, s, impl, shard) for s in specs]
        prog = progs[0] if len(progs) == 1 else vxprogram.fuse(progs)
        return vxlower.executor(prog, tuple(specs), shard)

    def _run_group(self, key: tuple, reqs: list[_Req]) -> None:
        from repro_torch import vx
        from repro_torch.dist import sharding
        kind = key[0]
        if kind == "deint":
            fields = key[1]
            shard = reqs[0].payload[1]
            stack = (reqs[0].payload[0] if len(reqs) == 1
                     else sharding.stack([r.payload[0] for r in reqs]))
            impl = self._impl_for(stack.numel(), stack.device)
            spec = vx.Segment(n=stack.shape[-1],
                              fields=fields).bind(stack.dtype)
            outs = self._fused("seg.deint", [spec] * len(reqs), impl,
                               shard)(stack)
            for a, r in enumerate(reqs):
                r.handle.value = (list(outs) if len(reqs) == 1
                                  else [sharding.select(o, a) for o in outs])
        elif kind == "int":
            nf = key[1]
            shard = reqs[0].payload[1]
            if len(reqs) == 1:
                parts = list(reqs[0].payload[0])
            else:
                parts = [sharding.stack([r.payload[0][f] for r in reqs])
                         for f in range(nf)]
            impl = self._impl_for(parts[0].numel() * nf, parts[0].device)
            spec = vx.Segment(n=nf * parts[0].shape[-1],
                              fields=nf).bind(parts[0].dtype)
            out = self._fused("seg.int", [spec] * len(reqs), impl,
                              shard)(parts)
            for a, r in enumerate(reqs):
                r.handle.value = (out if len(reqs) == 1
                                  else sharding.select(out, a))
        elif kind == "gather":
            vl = key[3]
            n = key[1][-1]
            stack = (reqs[0].payload[0] if len(reqs) == 1
                     else torch.stack([r.payload[0] for r in reqs]))
            specs = [vx.Strided(n=n, stride=r.payload[1], offset=r.payload[2],
                                vl=vl).bind(stack.dtype) for r in reqs]
            impl = self._impl_for(stack.numel(), stack.device)
            out = self._fused("gather.plan", specs, impl)(stack)
            for a, r in enumerate(reqs):
                r.handle.value = out if len(reqs) == 1 else out[a]
        else:  # pragma: no cover
            raise ValueError(kind)


def fuse_deinterleave(arrays: Sequence[torch.Tensor], fields: int, *,
                      impl: str | None = None, platform_policy: bool = True,
                      policy: "vxpolicy.Policy | None" = None,
                      shard=None) -> list[list[torch.Tensor]]:
    """One fused segment load for a whole step's same-shape AoS arrays.

    ``shard`` (a ``vx.Shard`` on an outer axis) runs the merged
    transaction shard-locally: a sequence-sharded cache splits in place,
    block by block, and is never gathered."""
    sched = StepScheduler(impl=impl, platform_policy=platform_policy,
                          policy=policy)
    hs = [sched.deinterleave(a, fields, shard=shard) for a in arrays]
    sched.flush()
    return [h.value for h in hs]


def fuse_split_kv(kvs: Sequence[torch.Tensor], *, impl: str | None = None,
                  platform_policy: bool = True,
                  policy: "vxpolicy.Policy | None" = None, shard=None):
    """All layers' (…, 2d) KV-cache splits in one launch (FIELD=2)."""
    return [tuple(pair) for pair in
            fuse_deinterleave(kvs, 2, impl=impl,
                              platform_policy=platform_policy,
                              policy=policy, shard=shard)]


def fuse_interleave(groups: Sequence[Sequence[torch.Tensor]], *,
                    impl: str | None = None,
                    policy: "vxpolicy.Policy | None" = None
                    ) -> list[torch.Tensor]:
    """One fused segment store for a step's same-shape SoA groups."""
    sched = StepScheduler(impl=impl, policy=policy)
    hs = [sched.interleave(g) for g in groups]
    sched.flush()
    return [h.value for h in hs]


# ---------------------------------------------------------------------------
# Runtime-stride plan bank
# ---------------------------------------------------------------------------

def _flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-1,))


def _bank_slots(make, n: int, offset: int, vl: int) -> tuple:
    """16 bank slots: strides 1..8, then -1..-8 (Reverser: plan on the
    reversed element order — a positive-stride plan from the window's low
    end, output reversed).  None marks a (stride, offset, vl) that does not
    fit the window; its slot dispatches to the dynamic fallback."""
    slots = []
    for s in BANK_STRIDES:
        ok = 0 <= offset and offset + (vl - 1) * s < n
        slots.append(make(n, s, offset, vl) if ok else None)
    for s in BANK_STRIDES:
        base = offset - (vl - 1) * s
        ok = base >= 0 and offset < n
        slots.append(make(n, s, base, vl) if ok else None)
    return tuple(slots)


@vxcache.memoize("bank.gather")
def _gather_bank(n: int, offset: int, vl: int):
    return _bank_slots(shiftplan.gather_plan, n, offset, vl)


@vxcache.memoize("bank.scatter")
def _scatter_bank(n: int, offset: int, vl: int):
    return _bank_slots(shiftplan.scatter_plan, n, offset, vl)


def _bank_index(stride: int, slots) -> int:
    """stride -> bank slot, or 16 = the dynamic fallback (a stride outside
    the bank, or a banked stride whose plan does not fit the window)."""
    top = BANK_STRIDES[-1]
    if 1 <= stride <= top:
        raw = stride - 1
    elif -top <= stride <= -1:
        raw = 7 - stride
    else:
        raw = 16
    return raw if raw < 16 and slots[raw] is not None else 16


def _host_stride(stride) -> int:
    """The runtime stride as a Python int: a tensor is read on the host
    (one device sync)."""
    if isinstance(stride, torch.Tensor):
        if stride.numel() != 1:
            raise ValueError(f"runtime stride must be a scalar, got shape "
                             f"{tuple(stride.shape)}")
        return int(stride.item())
    return int(stride)


def _dynamic_gather(window: torch.Tensor, stride: int, offset: int,
                    vl: int) -> torch.Tensor:
    """Fully dynamic fallback: a runtime stride of either sign (Reverser by
    output flip), the oracle the bank must match bit-exactly."""
    n = window.shape[-1]
    s_abs = max(abs(stride), 1)
    base = offset + (vl - 1) * stride if stride < 0 else offset
    shift, valid = scg.gather_counts(n, s_abs, base, vl,
                                     device=window.device)
    res = shiftnet.gather_network(window, shift, valid, axis=-1)
    dense = res.payload[..., :vl]
    return _flip(dense) if stride < 0 else dense


def _plan_gather(window, plan, vl: int, rev: bool) -> torch.Tensor:
    out = shiftnet.apply_plan(window, plan, axis=-1)[..., :vl]
    return _flip(out) if rev else out


def bank_gather_strided(window: torch.Tensor, stride, offset: int,
                        vl: int) -> torch.Tensor:
    """out[..., i] = window[..., offset + i*stride], stride of either sign.

    A Python int stride compiles its own plan (the reference's static
    path).  A tensor stride is the runtime form: it is read on the host
    once (a device sync), and the ONE branch it selects runs — its banked
    compiled plan, or the dynamic-count network for a stride outside the
    bank or a banked plan that does not fit the window."""
    n = window.shape[-1]
    if not isinstance(stride, torch.Tensor):
        stride = int(stride)
        if stride == 0:
            raise ValueError("stride 0 is a broadcast, not a strided access")
        s, rev = abs(stride), stride < 0
        base = offset + (vl - 1) * stride if rev else offset
        return _plan_gather(window, shiftplan.gather_plan(n, s, base, vl),
                            vl, rev)
    stride = _host_stride(stride)
    slots = _gather_bank(n, offset, vl)
    i = _bank_index(stride, slots)
    if i == 16:
        return _dynamic_gather(window, stride, offset, vl)
    return _plan_gather(window, slots[i], vl, i >= len(BANK_STRIDES))


def _dynamic_scatter(window: torch.Tensor, values: torch.Tensor, stride: int,
                     offset: int) -> torch.Tensor:
    n = window.shape[-1]
    vl = values.shape[-1]
    s_abs = max(abs(stride), 1)
    base = offset + (vl - 1) * stride if stride < 0 else offset
    vals = _flip(values) if stride < 0 else values
    shift, valid = scg.scatter_counts(n, s_abs, base, vl,
                                      device=window.device)
    res = shiftnet.scatter_network(
        torch.nn.functional.pad(vals, (0, n - vl)), shift, valid, axis=-1)
    return torch.where(res.valid, res.payload, window)


def _plan_scatter(window, values, plan, rev: bool) -> torch.Tensor:
    n, vl = window.shape[-1], values.shape[-1]
    vals = _flip(values) if rev else values
    routed = shiftnet.apply_plan(torch.nn.functional.pad(vals, (0, n - vl)),
                                 plan, axis=-1)
    return torch.where(shiftnet._broadcast_const(plan.valid, routed, -1),
                       routed, window)


def bank_scatter_strided(window: torch.Tensor, values: torch.Tensor, stride,
                         offset: int) -> torch.Tensor:
    """window[..., offset + i*stride] = values[..., i] (out of place); the
    stride is taken as in :func:`bank_gather_strided`."""
    n = window.shape[-1]
    vl = values.shape[-1]
    if not isinstance(stride, torch.Tensor):
        stride = int(stride)
        if stride == 0:
            raise ValueError("stride 0 is a broadcast, not a strided access")
        s, rev = abs(stride), stride < 0
        base = offset + (vl - 1) * stride if rev else offset
        return _plan_scatter(window, values,
                             shiftplan.scatter_plan(n, s, base, vl), rev)
    stride = _host_stride(stride)
    slots = _scatter_bank(n, offset, vl)
    i = _bank_index(stride, slots)
    if i == 16:
        return _dynamic_scatter(window, values, stride, offset)
    return _plan_scatter(window, values, slots[i], i >= len(BANK_STRIDES))


def warm(n: int, *, offset: int = 0, vl: int | None = None,
         strided: bool = True, fields: tuple = BANK_FIELDS) -> None:
    """Precompile bank plans for a window width (one-time host cost, so the
    first step never pays plan compilation).  ``strided=False`` skips the
    +-stride slots: serving consults only the segment plans."""
    if strided:
        vl = vl if vl is not None else n // BANK_STRIDES[-1]
        _gather_bank(n, offset, vl)
        _scatter_bank(n, offset, vl)
    for f in fields:
        if n % f == 0:
            shiftplan.segment_deinterleave_plans(n, f)
            shiftplan.segment_interleave_plans(n, f)


# ---------------------------------------------------------------------------
# Runtime-count member of the bank: MoE compaction
# ---------------------------------------------------------------------------

def compact_indices(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Pack the indices of the set bits of ``mask`` (n,) to the front,
    first ``cap`` kept.  The routing is derived once from the prefix-sum
    counts (``shiftnet.layer_masks``); the int32 id payload then pays one
    static shift + one select per layer (compaction is GSN-safe by
    construction, so no conflict reductions)."""
    n = mask.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=mask.device)
    shift, valid = scg.compaction_counts(mask)
    masks, _ = shiftnet.layer_masks(shift, valid, toward_zero=True,
                                    lsb_first=True)
    if masks.shape[0]:
        ids = shiftnet.apply_layer_masks(ids, masks, axis=0,
                                         toward_zero=True, lsb_first=True)
    return ids[:min(cap, n)]
