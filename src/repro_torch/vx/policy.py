"""vx.Policy — the single knob stack for vector-access lowering.

Port of ``repro``'s ``vx/policy.py``.  Impls map one to one onto the
reference's: ``ref`` (plain torch ops), ``kernel`` (the hand-written CUDA
plan kernels; the reference's ``pallas``) and ``kernel_dynamic`` (the
hand-written CUDA dynamic-count kernels B6-B9, whose shift networks are
derived on the card from runtime counts; the reference's
``pallas_dynamic``).  Both kernel impls take their kernels' plain
versions for CPU tensors.

Resolution order: an explicit ``policy=`` argument, else the innermost
``with vx.use(...)`` scope, else :meth:`Policy.default` — the
``REPRO_TORCH_VX_IMPL`` environment variable, else ``kernel`` when a GPU
is present and ``ref`` otherwise (the reference picks ``pallas`` on TPU
and ``ref`` elsewhere).  ``MIN_FUSED_ELEMS`` and :meth:`Policy.for_elems`
are the reference's own launch policy, kept as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading

#: Below this many elements a merged group rides the plain path instead
#: of paying a kernel launch (decode-time single-token beats).
MIN_FUSED_ELEMS = 1 << 15

#: What the runtime-stride plan bank precompiles: strides +-1..8 (the
#: negative half via the Reverser) and the segment field counts.
BANK_STRIDES = tuple(range(1, 9))
BANK_FIELDS = (2, 4)

IMPLS = ("ref", "kernel", "kernel_dynamic")

ENV_VAR = "REPRO_TORCH_VX_IMPL"


@dataclasses.dataclass(frozen=True)
class Policy:
    """How vx verbs lower.  Frozen and hashable."""

    impl: str = "ref"                       # ref | kernel | kernel_dynamic
    fusion_threshold: int = MIN_FUSED_ELEMS
    platform_lowering: bool = True          # cpu merged groups -> ref

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(
                f"unknown impl {self.impl!r} (want one of {IMPLS})")

    @staticmethod
    def default() -> "Policy":
        import torch
        return _default_policy(os.environ.get(ENV_VAR),
                               torch.cuda.is_available())

    def with_impl(self, impl: str | None) -> "Policy":
        if impl is None or impl == self.impl:
            return self
        return dataclasses.replace(self, impl=impl)

    def for_elems(self, total_elems: int) -> "Policy":
        """Scheduler launch policy: accesses below the fusion threshold
        ride the plain path."""
        if self.impl == "ref" or total_elems >= self.fusion_threshold:
            return self
        return dataclasses.replace(self, impl="ref")


@functools.lru_cache(maxsize=None)
def _default_policy(env_impl: str | None, cuda: bool) -> Policy:
    return Policy(impl=env_impl or ("kernel" if cuda else "ref"))


_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current() -> Policy:
    """The active policy: innermost ``vx.use`` scope, else the default."""
    s = _stack()
    return s[-1] if s else Policy.default()


def resolve(policy: "Policy | str | None" = None) -> Policy:
    """Normalize a verb's ``policy=`` argument (None, impl string, or
    Policy)."""
    if policy is None:
        return current()
    if isinstance(policy, str):
        return current().with_impl(policy)
    if isinstance(policy, Policy):
        return policy
    raise TypeError(f"policy must be Policy | str | None, got {policy!r}")


@contextlib.contextmanager
def use(policy: "Policy | str | None" = None, **overrides):
    """Scope a policy: ``with vx.use("kernel"): ...``.  Nests; the previous
    policy is restored on exit."""
    base = resolve(policy)
    pol = dataclasses.replace(base, **overrides) if overrides else base
    s = _stack()
    s.append(pol)
    try:
        yield pol
    finally:
        s.pop()
