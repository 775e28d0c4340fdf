"""Error-feedback gradient compression for data-parallel reduction, as
torch ops.

Port of ``repro``'s ``optim/compression.py``.  Two compressors, both with
per-tensor error feedback (the standard fix that keeps compressed SGD
convergent):

* int8: symmetric per-tensor quantization (``core/quant.roundtrip``, the
  format the quantized page pool shares; 4x fewer bytes on the wire),
* topk: keep every ``|g|`` at or above the k-th largest ``|g|`` (ties
  included), zero the rest.

On one device the compressors and their error state run in the train
step's microbatch loop (``train/step.py``); the all-reduce they would wrap
waits for ``dist`` (item 9h).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.kernels._common import tree_leaves
from repro_torch.optim.adamw import _map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"        # none | int8 | topk
    topk_frac: float = 0.05


def init_error_state(params: Any) -> Any:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    # per-tensor symmetric int8 wire format (shared with the quantized
    # paged KV pool — core/quant.py)
    return quant.roundtrip(g, torch.int8, eps=1e-12)


def _topk_roundtrip(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


@torch.no_grad()
def compress_with_feedback(grads: Any, err: Any, cfg: CompressionConfig
                           ) -> tuple[Any, Any, dict]:
    """Returns (decompressed grads as sent on the wire, error state,
    metrics).  The error state is updated in place and returned (the
    reference donates it with the train state); ``grads`` are read only.
    Identity when kind == 'none'."""
    if cfg.kind == "none":
        dev = tree_leaves(grads)[0].device
        return grads, err, {"compression_error": torch.zeros((),
                                                             device=dev)}
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)

    def one(g, e):
        g32 = g.float() + e
        sent = (_int8_roundtrip(g32) if cfg.kind == "int8"
                else _topk_roundtrip(g32, cfg.topk_frac))
        e.copy_(g32 - sent)
        return sent

    sent = _map(one, grads, err)
    err_norm = torch.sqrt(sum(torch.sum(torch.square(x))
                              for x in tree_leaves(err)))
    return sent, err, {"compression_error": err_norm}


def wire_bytes_ratio(cfg: CompressionConfig) -> float:
    """Bytes-on-wire ratio vs a float32 all-reduce."""
    if cfg.kind == "int8":
        return 0.25
    if cfg.kind == "topk":
        return cfg.topk_frac * 2.0  # value + index
    return 1.0
