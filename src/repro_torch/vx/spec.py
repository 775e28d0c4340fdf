"""AccessSpec — frozen, hashable descriptions of a vector access.

Port of ``repro``'s ``vx/spec.py``: :class:`Strided` (``out[i] =
window[offset + i*stride]``, a static stride or the runtime :data:`BANK`),
:class:`Segment` (AoS <-> SoA transposition), :class:`Indexed` (the raw
shift-network access on per-lane ``(shift, valid)`` routing, runtime or
folded into the spec as ``routing=``), :class:`Compact` (order-preserving
masked compaction, the MoE dispatch primitive, and its expansion) and
:class:`Paged` (page-table gather/append over a shared pool, float pools
only).  The quantized ``Paged.scale_dtype`` waits for a later slice.

``dtype`` participates in ``key()``, so plan-cache entries never collide
across element types.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _dtype_str(dtype: Any) -> str | None:
    if dtype is None:
        return None
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


class _Bank:
    """Singleton marker: the stride is a runtime value."""

    _instance: "_Bank | None" = None

    def __new__(cls) -> "_Bank":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "vx.BANK"


#: Pass as ``Strided.stride`` to defer the stride to call time: an in-bank
#: stride runs its compiled plan, anything else the dynamic-count network.
BANK = _Bank()


class AccessSpec:
    """Mixin shared by the spec dataclasses (not instantiable)."""

    def key(self) -> tuple:
        """Hashable cache key: class name + every field, BANK normalized."""
        vals = []
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            vals.append("bank" if v is BANK else v)
        return (type(self).__name__, *vals)

    def bind(self, dtype: Any) -> "AccessSpec":
        """Spec with the element dtype filled in (no-op if already set)."""
        if getattr(self, "dtype", None) is not None:
            return self
        return dataclasses.replace(self, dtype=_dtype_str(dtype))


@dataclasses.dataclass(frozen=True)
class Strided(AccessSpec):
    """``out[..., i] = window[..., offset + i*stride]`` for i < vl.

    ``stride`` is a static Python int (either sign; negative engages the
    §3.2.2 Reverser) or :data:`BANK` (runtime stride, supplied to the verb
    as ``stride=``)."""

    n: int
    stride: Any                 # int | BANK
    vl: int
    offset: int = 0
    dtype: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", _dtype_str(self.dtype))
        if self.vl < 0:
            raise ValueError(f"vl must be >= 0, got {self.vl}")
        s = self.stride
        if s is BANK:
            return
        s = int(s)
        object.__setattr__(self, "stride", s)
        if s == 0:
            raise ValueError("stride 0 is a broadcast, not a strided access")
        if self.vl == 0:
            return
        last = self.offset + (self.vl - 1) * s
        lo, hi = (last, self.offset) if s < 0 else (self.offset, last)
        if lo < 0 or hi >= self.n:
            raise ValueError(
                f"strided access [{lo}, {hi}] leaves the {self.n}-lane "
                f"window: {self}")

    @property
    def runtime(self) -> bool:
        return self.stride is BANK


@dataclasses.dataclass(frozen=True)
class Segment(AccessSpec):
    """AoS beat of ``n`` lanes <-> ``fields`` SoA fields of ``n/fields``."""

    n: int
    fields: int
    dtype: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", _dtype_str(self.dtype))
        if self.fields < 1 or self.n % self.fields:
            raise ValueError(
                f"segment needs n divisible by fields, got {self}")


@dataclasses.dataclass(frozen=True)
class Indexed(AccessSpec):
    """DROM access over ``n`` lanes routed by per-lane (shift, valid).

    Two forms:

    * dynamic — ``shift``/``valid`` are call-time tensors and the access
      pays the dynamic-count network;
    * static — a host-known routing folded into the spec as
      ``routing=(shifts, valids)`` (hashable tuples) PROMOTES the access
      into the plan stage: the layer take-masks are computed once when the
      executor is built and memoized in ``vx.PLANS`` under this spec's key
      (the verbs apply the same promotion to numpy/list/tuple operands).

    The routing must be GSN-safe (order-preserving, separation
    non-increasing toward lane 0), as for the dynamic network."""

    n: int
    dtype: str | None = None
    routing: tuple | None = None   # ((shift,)*n, (valid,)*n) host constants

    def __post_init__(self):
        object.__setattr__(self, "dtype", _dtype_str(self.dtype))
        if self.routing is not None:
            shifts, valids = self.routing
            shifts = tuple(int(s) for s in shifts)
            valids = tuple(bool(v) for v in valids)
            if len(shifts) != self.n or len(valids) != self.n:
                raise ValueError(
                    f"routing must carry {self.n} per-lane entries, got "
                    f"{len(shifts)}/{len(valids)}")
            object.__setattr__(self, "routing", (shifts, valids))

    @property
    def static(self) -> bool:
        return self.routing is not None


@dataclasses.dataclass(frozen=True)
class Compact(AccessSpec):
    """Order-preserving masked compaction over ``n`` rows (MoE dispatch).

    ``cap`` bounds the packed output length (defaults to ``n``)."""

    n: int
    cap: int | None = None
    dtype: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", _dtype_str(self.dtype))

    @property
    def capacity(self) -> int:
        return self.n if self.cap is None else min(self.cap, self.n)


@dataclasses.dataclass(frozen=True)
class Paged(AccessSpec):
    """Page-table-indexed access over a shared pool (paged KV cache).

    The pool holds ``(*lead, P, page_size, *trail)``; the page table is a
    runtime int32 operand ``(*batch, pages)`` with ``-1`` marking
    unallocated entries (gather returns zeros there; scatter drops
    writes).  Only the page geometry is spec data, so one cached program
    serves every request and every step."""

    page_size: int
    pages: int
    trail: int = 0
    dtype: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", _dtype_str(self.dtype))
        if self.page_size < 1 or self.pages < 1 or self.trail < 0:
            raise ValueError(f"bad paged geometry: {self}")

    def pool_axis(self, ndim: int) -> int:
        """Index of the pool's page axis for a rank-``ndim`` operand."""
        ax = ndim - 2 - self.trail
        if ax < 0:
            raise ValueError(
                f"rank-{ndim} pool cannot carry (P, page_size) plus "
                f"{self.trail} trailing dims: {self}")
        return ax
