"""Config substrate: the arch registry (port of ``repro``'s
``configs/base.py``, reduced to ``get_arch`` for the one model this slice
serves).  Shape cells and input builders wait for the training and
benchmark slices."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    smoke: ModelConfig
    runs_long_context: bool       # sub-quadratic family?
    family: str                   # dense|moe|hybrid|ssm|audio|vlm
    notes: str = ""


_MODULES = {"qwen3-0.6b": "qwen3_0_6b"}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r} in this slice; known: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.arch()
