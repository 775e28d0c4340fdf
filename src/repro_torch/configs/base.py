"""Config substrate: shape cells and the arch registry (port of ``repro``'s
``configs/base.py``).

Every assigned architecture ships as ``configs/<id>.py`` exposing:
  * ``config()``       — the exact published geometry,
  * ``smoke_config()`` — a reduced same-family config for CPU smoke tests.

Shape cells follow the assignment: train_4k / prefill_32k / decode_32k /
long_500k; ``long_500k`` only runs for sub-quadratic archs (see
``runs_long_context``).  ``get_arch`` returns all ten archs; the port runs
the decoders among them (dense, windowed, VLM, GELU MLP, MoE, the hybrid
Mamba stack and xLSTM), and ``transformer.check_supported`` refuses the
encoder family when it is used.  The input builders (``train_batch``,
``prefill_batch``, ``decode_inputs``) wait for the training and benchmark
slices.
"""
from __future__ import annotations

import dataclasses
import importlib

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
