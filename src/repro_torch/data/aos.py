"""AoS training-record format — EARTH segment access in the input path.

Port of ``repro``'s ``data/aos.py``.  A record packs FIELDS=4 int32 fields
per token position, interleaved (Array-of-Structures):
[token, label, weight_q, doc_id] x S.  One record is therefore a single
contiguous (4*S,) buffer: writing it is one sequential transaction (the
coalescing win), and unpacking to SoA batch arrays is a FIELD=4 segment
load (``vx.transpose`` with a Segment spec: kernel B1 under ``kernel``, B6
under ``kernel_dynamic``; the pack is B2 / B7).

``torch.round`` rounds half to even, as ``jnp.round`` does, and the weight
scale is a power of two, so the quantized weights and their ``/
WEIGHT_SCALE`` are exact on the card as on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch import vx

FIELDS = 4
WEIGHT_SCALE = 1024  # loss weights quantized to int32 / WEIGHT_SCALE


def _quantize(weights: torch.Tensor) -> torch.Tensor:
    return torch.round(weights * WEIGHT_SCALE).to(torch.int32)


def pack_records(tokens: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, doc_ids: torch.Tensor, *,
                 policy=None) -> torch.Tensor:
    """(B,S) x4 -> (B, 4S) interleaved AoS buffer (segment store)."""
    spec = vx.Segment(n=FIELDS * tokens.shape[-1], fields=FIELDS)
    return vx.transpose(
        spec, [tokens.to(torch.int32), labels.to(torch.int32),
               _quantize(weights), doc_ids.to(torch.int32)], policy=policy)


def unpack_records(aos: torch.Tensor, *, policy=None) -> dict:
    """(B, 4S) AoS -> SoA batch dict (segment load)."""
    tokens, labels, wq, doc_ids = vx.transpose(
        vx.Segment(n=aos.shape[-1], fields=FIELDS), aos, policy=policy)
    return {
        "tokens": tokens,
        "labels": labels,
        "loss_weight": wq.to(torch.float32) / WEIGHT_SCALE,
        "doc_id": doc_ids,
    }


def pack_unpack_fused(tokens: torch.Tensor, labels: torch.Tensor,
                      weights: torch.Tensor, doc_ids: torch.Tensor) -> dict:
    """``unpack_records(pack_records(...))`` with the segment round trip
    elided: ``interleave_plan(n, 4)`` followed by ``deinterleave_plan(n,
    4)`` is the identity permutation, so neither network pass is launched
    and only the field dtype conversions of the round trip remain
    (bit-exact with the unfused path, the loss-weight quantization
    included)."""
    return {
        "tokens": tokens.to(torch.int32),
        "labels": labels.to(torch.int32),
        "loss_weight": _quantize(weights).to(torch.float32) / WEIGHT_SCALE,
        "doc_id": doc_ids.to(torch.int32),
    }
