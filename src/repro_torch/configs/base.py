"""Config substrate: shape cells and the arch registry (port of ``repro``'s
``configs/base.py``).

Every assigned architecture ships as ``configs/<id>.py`` exposing:
  * ``config()``       — the exact published geometry,
  * ``smoke_config()`` — a reduced same-family config for CPU smoke tests.

Shape cells follow the assignment: train_4k / prefill_32k / decode_32k /
long_500k; ``long_500k`` only runs for sub-quadratic archs (see
``runs_long_context``).  ``get_arch`` returns all ten archs, and the port
runs every one (dense, windowed, VLM, GELU MLP, MoE, the hybrid Mamba
stack, xLSTM and the whisper encoder-decoder).

The input builders ``train_batch``, ``prefill_batch`` and
``decode_inputs`` give the reference's keys, shapes and dtypes:
``specs=True`` returns tensors on the ``meta`` device (no allocation),
otherwise seeded values from a ``torch.Generator`` (the draws differ from
``jax.random``'s; tests carry the reference's own batches through numpy).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.device import resolve as resolve_device
from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    smoke: ModelConfig
    runs_long_context: bool       # sub-quadratic family?
    family: str                   # dense|moe|hybrid|ssm|audio|vlm
    notes: str = ""


ARCH_IDS = (
    "granite-34b", "gemma3-12b", "qwen3-0.6b", "starcoder2-3b",
    "jamba-1.5-large-398b", "whisper-tiny", "llava-next-mistral-7b",
    "phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b", "xlstm-125m",
)

_MODULES = {
    "granite-34b": "granite_34b",
    "gemma3-12b": "gemma3_12b",
    "qwen3-0.6b": "qwen3_0_6b",
    "starcoder2-3b": "starcoder2_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "whisper-tiny": "whisper_tiny",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "xlstm-125m": "xlstm_125m",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.arch()


def cells_for(name: str) -> list[ShapeCell]:
    a = get_arch(name)
    return [s for s in SHAPES
            if s.name != "long_500k" or a.runs_long_context]


# ---------------------------------------------------------------------------
# Input builders.  ``specs=True`` returns ``meta`` tensors (shapes and
# dtypes, no allocation); otherwise seeded values on ``device``.
# ---------------------------------------------------------------------------

def _generator(generator, seed: int, device) -> torch.Generator:
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    return generator


def _maybe_struct(shape, dtype, specs: bool, generator=None, vocab: int = 0,
                  device=None) -> torch.Tensor:
    if specs:
        return torch.empty(shape, dtype=dtype, device="meta")
    device = resolve_device(device)
    g = _generator(generator, 0, device)
    if not dtype.is_floating_point:
        return torch.randint(0, max(vocab, 2), shape, generator=g,
                             dtype=dtype, device=g.device).to(device)
    return torch.randn(shape, generator=g, dtype=torch.float32,
                       device=g.device).to(dtype=dtype, device=device)


def train_batch(cfg: ModelConfig, seq: int, batch: int, *,
                specs: bool = True, generator=None,
                device=None) -> dict[str, Any]:
    """tokens, labels (int32), loss_weight (float32, seeded normal as in
    the reference), and ``patch_embeds`` (VLM) or ``audio_frames``
    (encoder) in the compute dtype."""
    if not specs:
        device = resolve_device(device)
        generator = _generator(generator, 0, device)
    mk = dict(specs=specs, generator=generator, device=device)
    b = {
        "tokens": _maybe_struct((batch, seq), torch.int32, vocab=cfg.vocab,
                                **mk),
        "labels": _maybe_struct((batch, seq), torch.int32, vocab=cfg.vocab,
                                **mk),
        "loss_weight": _maybe_struct((batch, seq), torch.float32, **mk),
    }
    if cfg.vlm_patches:
        n = min(cfg.vlm_patches, seq)
        b["patch_embeds"] = _maybe_struct((batch, n, cfg.d_model),
                                          cfg.cdtype, **mk)
    if cfg.encoder is not None:
        b["audio_frames"] = _maybe_struct(
            (batch, cfg.encoder.context, cfg.d_model), cfg.cdtype, **mk)
    return b


def prefill_batch(cfg: ModelConfig, seq: int, batch: int, *,
                  specs: bool = True, generator=None,
                  device=None) -> dict[str, Any]:
    b = train_batch(cfg, seq, batch, specs=specs, generator=generator,
                    device=device)
    b.pop("labels", None)
    b.pop("loss_weight", None)
    return b


def decode_inputs(cfg: ModelConfig, seq: int, batch: int, *,
                  specs: bool = True, cache_dtype=torch.bfloat16,
                  generator=None, device=None):
    """(cache, token) for a one-token decode step with a ``seq``-length
    cache (``encdec.init_cache`` for an encoder config); ``len`` is
    ``seq // 2`` when the values are real."""
    from repro_torch.models import decode as dec
    from repro_torch.models import encdec
    init = encdec.init_cache if cfg.encoder is not None else dec.init_cache
    if specs:
        cache = init(cfg, batch, seq, cache_dtype, device="meta")
        return cache, torch.empty((batch,), dtype=torch.int32,
                                  device="meta")
    device = resolve_device(device)
    cache = init(cfg, batch, seq, cache_dtype, device=device)
    cache["len"] = torch.tensor(seq // 2, dtype=torch.int32, device=device)
    g = _generator(generator, 1, device)
    token = torch.randint(0, cfg.vocab, (batch,), generator=g,
                          dtype=torch.int32, device=g.device).to(device)
    return cache, token
