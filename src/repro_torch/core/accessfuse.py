"""Whole-step access fusion — the step-level memory scheduler.

Port of ``repro``'s ``core/accessfuse.py`` for the segment groups:
:class:`StepScheduler` collects a step's deinterleave and interleave
accesses, merges same-shape ones into ONE wide transaction through
``vx.program.fuse`` (one kernel launch for the group), and executes it
through ``vx.lower.executor``.  ``fuse_split_kv`` is the one fused KV split
per decode step.

Lowering policy:

* :func:`pick_impl` — groups below the policy's fusion threshold ride the
  plain path (the reference's own threshold).
* :func:`platform_impl` — the reference demotes every merged group to
  ``ref`` off-TPU, because interpret-mode Pallas is no dispatch win.  The
  port demotes only groups whose tensors lie on the CPU: on the card a
  merged group is one CUDA launch.  :func:`pinned_kernel_lowering` (or
  ``Policy(platform_lowering=False)``) turns the demotion off, so a CPU run
  can count the kernel calls the card would launch.

Launch accounting counts calls at the kernel entry points
(``kernels.segment.deinterleave.calls`` / ``.launches``) in place of the
reference's ``jaxpr_access_counts``.  The strided group, the runtime-stride
plan bank and ``compact_indices`` wait for a later slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import shiftplan
from repro_torch.vx import policy as vxpolicy


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
    """Collects a step's segment accesses and executes them merged.

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

    def deinterleave(self, aos: torch.Tensor, fields: int) -> Handle:
        h = Handle()
        key = ("deint", fields, tuple(aos.shape), str(aos.dtype),
               str(aos.device))
        self._reqs.append(_Req(key, aos, h))
        return h

    def interleave(self, parts: Sequence[torch.Tensor]) -> Handle:
        parts = list(parts)
        h = Handle()
        key = ("int", len(parts), tuple(parts[0].shape),
               str(parts[0].dtype), str(parts[0].device))
        self._reqs.append(_Req(key, parts, h))
        return h

    def flush(self) -> None:
        groups: dict[tuple, list[_Req]] = {}
        for r in self._reqs:
            groups.setdefault(r.key, []).append(r)
        for key, reqs in groups.items():
            self._run_group(key, reqs)
        self._reqs = []

    def _fused(self, op: str, specs: list, impl: str):
        """lower each access -> fuse the programs -> ONE executor."""
        from repro_torch.vx import lower as vxlower
        from repro_torch.vx import program as vxprogram
        progs = [vxlower.lower(op, s, impl) for s in specs]
        prog = progs[0] if len(progs) == 1 else vxprogram.fuse(progs)
        return vxlower.executor(prog, tuple(specs))

    def _run_group(self, key: tuple, reqs: list[_Req]) -> None:
        from repro_torch import vx
        kind = key[0]
        if kind == "deint":
            fields = key[1]
            stack = (reqs[0].payload if len(reqs) == 1
                     else torch.stack([r.payload for r in reqs]))
            impl = self._impl_for(stack.numel(), stack.device)
            spec = vx.Segment(n=stack.shape[-1],
                              fields=fields).bind(stack.dtype)
            outs = self._fused("seg.deint", [spec] * len(reqs), impl)(stack)
            for a, r in enumerate(reqs):
                r.handle.value = (list(outs) if len(reqs) == 1
                                  else [o[a] for o in outs])
        elif kind == "int":
            nf = key[1]
            if len(reqs) == 1:
                parts = list(reqs[0].payload)
            else:
                parts = [torch.stack([r.payload[f] for r in reqs])
                         for f in range(nf)]
            impl = self._impl_for(parts[0].numel() * nf, parts[0].device)
            spec = vx.Segment(n=nf * parts[0].shape[-1],
                              fields=nf).bind(parts[0].dtype)
            out = self._fused("seg.int", [spec] * len(reqs), impl)(parts)
            for a, r in enumerate(reqs):
                r.handle.value = out if len(reqs) == 1 else out[a]
        else:  # pragma: no cover
            raise ValueError(kind)


def fuse_deinterleave(arrays: Sequence[torch.Tensor], fields: int, *,
                      impl: str | None = None, platform_policy: bool = True,
                      policy: "vxpolicy.Policy | None" = None
                      ) -> list[list[torch.Tensor]]:
    """One fused segment load for a whole step's same-shape AoS arrays."""
    sched = StepScheduler(impl=impl, platform_policy=platform_policy,
                          policy=policy)
    hs = [sched.deinterleave(a, fields) for a in arrays]
    sched.flush()
    return [h.value for h in hs]


def fuse_split_kv(kvs: Sequence[torch.Tensor], *, impl: str | None = None,
                  platform_policy: bool = True,
                  policy: "vxpolicy.Policy | None" = None):
    """All layers' (…, 2d) KV-cache splits in one launch (FIELD=2)."""
    return [tuple(pair) for pair in
            fuse_deinterleave(kvs, 2, impl=impl,
                              platform_policy=platform_policy,
                              policy=policy)]


def fuse_interleave(groups: Sequence[Sequence[torch.Tensor]], *,
                    impl: str | None = None,
                    policy: "vxpolicy.Policy | None" = None
                    ) -> list[torch.Tensor]:
    """One fused segment store for a step's same-shape SoA groups."""
    sched = StepScheduler(impl=impl, policy=policy)
    hs = [sched.interleave(g) for g in groups]
    sched.flush()
    return [h.value for h in hs]


def warm(n: int, *, fields: tuple = (2,)) -> None:
    """Precompile the segment plans for a beat width."""
    for f in fields:
        if n % f == 0:
            shiftplan.segment_deinterleave_plans(n, f)
            shiftplan.segment_interleave_plans(n, f)
