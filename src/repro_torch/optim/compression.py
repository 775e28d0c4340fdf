"""Error-feedback gradient compression for data-parallel reduction, as
torch ops.

Port of ``repro``'s ``optim/compression.py``.  Two compressors, both with
per-tensor error feedback (the standard fix that keeps compressed SGD
convergent):

* int8: symmetric per-tensor quantization (``core/quant.roundtrip``, the
  format the quantized page pool shares; 4x fewer bytes on the wire),
* topk: keep every ``|g|`` at or above the k-th largest ``|g|`` (ties
  included), zero the rest.

The train step compresses the gradients it has reduced, once per step
(``train/step.py``).  Under a mesh each rank compresses its ZeRO-1 block
of every gradient against its block of the error state, with each
tensor's statistics taken over the whole tensor: the int8 scale from the
``pmax`` of the blocks' max ``|g|``, the top-k threshold from the
gathered ``|g|`` of every block (``specs`` names the axes that shard
each block; the ranks of any other axis hold the same block).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P
from repro_torch.kernels._common import tree_leaves
from repro_torch.optim.adamw import _map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"        # none | int8 | topk
    topk_frac: float = 0.05


def init_error_state(params: Any) -> Any:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def _int8_roundtrip(g: torch.Tensor, mesh=None, axes=()) -> torch.Tensor:
    # per-tensor symmetric int8 wire format (shared with the quantized
    # paged KV pool — core/quant.py)
    if not sharding._names(axes):
        return quant.roundtrip(g, torch.int8, eps=1e-12)
    amax = torch.clamp(sharding.pmax(g.abs().amax(), mesh, axes), min=1e-12)
    s = amax / amax.new_full((), quant.qmax(torch.int8))
    return quant.dequantize(quant.quantize(g, s, torch.int8), s,
                            torch.float32)


def _topk_roundtrip(g: torch.Tensor, frac: float, mesh=None,
                    axes=()) -> torch.Tensor:
    flat = torch.abs(g.reshape(-1))
    if sharding._names(axes):
        flat = sharding.all_gather(flat, mesh, axes, 0)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


@torch.no_grad()
def compress_with_feedback(grads: Any, err: Any, cfg: CompressionConfig,
                           *, mesh=None, specs=None
                           ) -> tuple[Any, Any, dict]:
    """Returns (decompressed grads as sent on the wire, error state,
    metrics).  The error state is updated in place and returned (the
    reference donates it with the train state); ``grads`` are read only.
    Identity when kind == 'none'.  With ``mesh``, ``grads`` and ``err``
    hold this rank's blocks, placed as the matching :class:`P` of
    ``specs`` says; the statistics and the error norm cover the whole
    tensors."""
    if cfg.kind == "none":
        dev = tree_leaves(grads)[0].device
        return grads, err, {"compression_error": torch.zeros((),
                                                             device=dev)}
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)

    if specs is None:
        specs = _map(lambda _: P(), grads)

    def one(g, e, spec):
        axes = _axes(spec)
        g32 = g.float() + e
        sent = (_int8_roundtrip(g32, mesh, axes) if cfg.kind == "int8"
                else _topk_roundtrip(g32, cfg.topk_frac, mesh, axes))
        e.copy_(g32 - sent)
        return sent

    sent = _map(one, grads, err, specs)
    err_norm = torch.sqrt(sharded_sumsq(err, specs, mesh))
    return sent, err, {"compression_error": err_norm}


def _axes(spec) -> tuple:
    return tuple(a for e in spec for a in sharding._names(e))


def sharded_sumsq(tree: Any, specs: Any, mesh=None) -> torch.Tensor:
    """The sum of squares of every leaf of a tree of blocks: each leaf's
    sum over the ranks of the axes that shard it (``specs``), a leaf that
    no axis shards counted once, not once per rank."""
    groups: dict = {}
    _map(lambda x, s: groups.setdefault(_axes(s), []).append(
        torch.sum(torch.square(x.float()))), tree, specs)
    total = None
    for axes, parts in groups.items():
        part = sum(parts)
        if axes:
            part = sharding.psum(part, mesh, axes)
        total = part if total is None else total + part
    return total


def wire_bytes_ratio(cfg: CompressionConfig) -> float:
    """Bytes-on-wire ratio vs a float32 all-reduce."""
    if cfg.kind == "int8":
        return 0.25
    if cfg.kind == "topk":
        return cfg.topk_frac * 2.0  # value + index
    return 1.0
