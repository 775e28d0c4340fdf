"""xLSTM blocks (mLSTM matrix-memory + sLSTM scalar-memory), arXiv:2405.04517.

Port of ``repro``'s ``models/xlstm.py``, reduced to :class:`XLSTMSpec`,
which the xlstm config needs.  The bodies (init, the chunked forward scans
and the decode steps with their ``(C, n, m)`` / ``(c, n, m, h)`` states)
wait for the recurrent slice (ROADMAP.md queue A, item 9d); until then
``transformer.check_supported`` refuses ``"mlstm"`` and ``"slstm"`` blocks.
"""
from __future__ import annotations

from typing import NamedTuple


class XLSTMSpec(NamedTuple):
    d_model: int
    n_heads: int
    m_proj_factor: float = 2.0   # mLSTM up-projection
    s_ffn_factor: float = 4.0 / 3.0

    @property
    def m_inner(self) -> int:
        return int(self.d_model * self.m_proj_factor)

    @property
    def m_head(self) -> int:
        return self.m_inner // self.n_heads

    @property
    def s_head(self) -> int:
        return self.d_model // self.n_heads
