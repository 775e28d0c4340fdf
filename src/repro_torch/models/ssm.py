"""Mamba (selective SSM) block — the state-space half of Jamba.

Port of ``repro``'s ``models/ssm.py``, reduced to :class:`MambaSpec`, which
the jamba config needs.  The bodies (``init_mamba``, the chunked scan of
``mamba_forward``, ``mamba_decode_step`` and the cache) wait for the
recurrent slice (ROADMAP.md queue A, item 9d); until then
``transformer.check_supported`` refuses ``"mamba"`` blocks.
"""
from __future__ import annotations

from typing import NamedTuple


class MambaSpec(NamedTuple):
    d_model: int
    expand: int = 2
    state_dim: int = 16
    conv_width: int = 4
    dt_rank: int = 0  # 0 -> d_model // 16

    @property
    def ed(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)
