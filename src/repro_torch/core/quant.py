"""Shared symmetric quantization helpers.

Port of ``repro``'s ``core/quant.py``.  Its consumer here is the quantized
paged KV pool (``vx/lower.py`` + ``models/decode.py``): per-page,
per-head scales in a side tensor, the dequant inside the one fused page
gather, and the quantize-on-write append.  (The reference's other
consumer, the gradient compression of the training stack, is not ported
yet.)

All quantization here is symmetric (no zero point): ``q = x / scale``
clipped to ``[-qmax, qmax]`` and rounded for integer targets (``torch.round``
rounds half to even, as ``jnp.round`` does), ``x' = q * scale``.  A scale
of exactly 0 means "nothing written yet": the safe-divide in
:func:`quantize` writes 0, never NaN (fp8 has NaN encodings, and a NaN
page poisons every later gather), and dequant multiplies garbage by 0.

fp8 is feature-gated: ``torch.float8_e4m3fn`` when the installed torch
has it, otherwise :func:`supported` returns False.
"""
from __future__ import annotations

import numpy as np
import torch

# Largest representable magnitude per quantized dtype.  int8 uses the
# symmetric range [-127, 127] (not -128: symmetry keeps dequant
# unbiased).  float8_e4m3fn's max finite is 448 (the "fn" variant trades
# inf for range); e5m2 listed for completeness.
_QMAX = {
    "int8": 127.0,
    "float8_e4m3fn": 448.0,
    "float8_e5m2": 57344.0,
}

# Worst-case round-to-nearest error of a value at magnitude ``qmax *
# scale`` quantized into the dtype, as a fraction of that magnitude:
#   int8            : half a step  => (1/127) / 2
#   float8_e4m3fn   : 3 mantissa bits => half-ulp relative 2**-4
#   float8_e5m2     : 2 mantissa bits => half-ulp relative 2**-3
_REL_ERR = {
    "int8": 0.5 / 127.0,
    "float8_e4m3fn": 2.0 ** -4,
    "float8_e5m2": 2.0 ** -3,
}

_ALIASES = {"fp8": "float8_e4m3fn", "e4m3": "float8_e4m3fn",
            "e5m2": "float8_e5m2"}


def _name(dtype) -> str:
    """The dtype's name: a string as given, a torch dtype without its
    ``torch.`` prefix, anything else through ``np.dtype``."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def canonical(name) -> str:
    """Canonical dtype string for a user-facing name or dtype object."""
    s = _name(name) if isinstance(name, torch.dtype) else str(name)
    s = _ALIASES.get(s, s)
    if s not in _QMAX:
        raise ValueError(f"unsupported quantized dtype {name!r}; "
                         f"known: {sorted(_QMAX) + sorted(_ALIASES)}")
    return s


def supported(name) -> bool:
    """Whether this torch build can materialize the dtype (fp8 is gated)."""
    try:
        s = canonical(name)
    except ValueError:
        return False
    return s == "int8" or hasattr(torch, s)


def pool_dtype(name) -> torch.dtype:
    """torch dtype for a canonical or user-facing quantized dtype name."""
    s = canonical(name)
    if s == "int8":
        return torch.int8
    if not hasattr(torch, s):
        raise ValueError(f"{s} unavailable in this torch build "
                         f"(gate with quant.supported)")
    return getattr(torch, s)


def qmax(dtype) -> float:
    """Largest encodable magnitude of a quantized dtype."""
    return _QMAX[canonical(_name(dtype))]


def scale_for(x: torch.Tensor, dtype, *, axis=None, keepdims: bool = False,
              eps: float = 0.0) -> torch.Tensor:
    """Symmetric max-abs scale so that |x| maps into [-qmax, qmax].

    The divisor is a 0-dim tensor on ``x``'s device: CUDA divides by a
    Python scalar as a multiply by its reciprocal, one ulp away from the
    reference's quotient at times; a tensor divisor divides on every
    device."""
    a = x.abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=keepdims)
    if eps:
        amax = torch.clamp(amax, min=eps)
    return amax / amax.new_full((), qmax(dtype))


def quantize(x: torch.Tensor, scale, dtype) -> torch.Tensor:
    """``round(clip(x / scale))`` cast to ``dtype``; scale==0 writes 0."""
    qd = pool_dtype(dtype) if isinstance(dtype, str) else dtype
    scale = torch.as_tensor(scale, device=x.device)
    on = scale > 0
    safe = torch.where(on, scale, torch.ones_like(scale))
    y = torch.where(on, x / safe, 0.0)
    return requantize(y, qd)


def requantize(y: torch.Tensor, dtype) -> torch.Tensor:
    """Clip+round a value already in the quantized domain and cast."""
    qd = pool_dtype(dtype) if isinstance(dtype, str) else dtype
    qm = qmax(qd)
    y = torch.clamp(y, -qm, qm)
    if not qd.is_floating_point:
        y = torch.round(y)
    return y.to(qd)


def dequantize(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * torch.as_tensor(scale, device=q.device).to(dtype)


def roundtrip(x: torch.Tensor, dtype=torch.int8, *,
              eps: float = 0.0) -> torch.Tensor:
    """Per-tensor symmetric quantize->dequantize (compression wire sim)."""
    s = scale_for(x, dtype, eps=eps)
    return dequantize(quantize(x, s, dtype), s, torch.float32)


def raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a one-byte float tensor (fp8) as ``uint8``, other
    tensors as they are (a port-only helper): every take and put of a
    quantized pool moves these, so that no indexing op needs a Float8
    kernel on any device."""
    if t.dtype.is_floating_point and t.element_size() == 1:
        return t.view(torch.uint8)
    return t


def error_bound(dtype, amax) -> float:
    """Worst-case |x - roundtrip(x)| for |x| <= amax under a per-tensor
    max-abs scale.  int8: half a quantization step.  fp8: half-ulp
    relative error at the top binade dominates the subnormal floor."""
    return float(amax) * _REL_ERR[canonical(_name(dtype))]
