"""RCVRF — Row/Column-accessible Vector Register File (EARTH §4.5).

Port of ``repro``'s ``core/rcvrf.py``.  The paper skews register blocks
diagonally across banks::

    (VREG_i, Block_j)  ->  Bank_k, Row_r
    k = (i + j) mod nBanks
    r = (floor(i / nBanks) * VLEN/ELEN + i mod nBanks) mod nRows

so both a whole register (row access) and "block j of registers
V_b..V_{b+7}" (column access) touch all banks exactly once — conflict-free
parallel access without a segment buffer.  The skew turns column access
into a row access plus a rotate, the Block Circular Shifter of Fig. 5
(c1).

This module keeps the mapping math and a functional VRF as torch ops on
the VRF's device (``empty_vrf`` takes the port's device rule): every
access returns a new tensor and leaves ``vrf`` as it was, as the
reference's functional updates do.  Column accesses route through
``core/scg`` counts and the ``core/shiftnet`` GSN / SSN.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import scg, shiftnet
from repro_torch.device import resolve as resolve_device


@dataclasses.dataclass(frozen=True)
class VRFSpec:
    vlen: int = 256          # bits per architectural register
    elen: int = 64           # bits per block
    n_regs: int = 32
    n_banks: int = 8
    elem_bits: int = 8       # granularity we route at (one "element")

    @property
    def blocks_per_reg(self) -> int:
        return self.vlen // self.elen

    @property
    def n_rows(self) -> int:
        return self.vlen * self.n_regs // (self.elen * self.n_banks)

    @property
    def elems_per_block(self) -> int:
        return self.elen // self.elem_bits


def bank_of(spec: VRFSpec, reg: int, block: int) -> int:
    return (reg + block) % spec.n_banks


def row_of(spec: VRFSpec, reg: int, block: int) -> int:
    del block  # row depends only on the register (paper §4.5.1)
    return ((reg // spec.n_banks) * spec.blocks_per_reg
            + reg % spec.n_banks) % spec.n_rows


def locate(spec: VRFSpec, reg: int, block: int) -> tuple[int, int]:
    return bank_of(spec, reg, block), row_of(spec, reg, block)


def empty_vrf(spec: VRFSpec, dtype=torch.uint8, device=None) -> torch.Tensor:
    """Physical storage: (n_rows, n_banks, elems_per_block)."""
    return torch.zeros((spec.n_rows, spec.n_banks, spec.elems_per_block),
                       dtype=dtype, device=resolve_device(device))


def _bank_mask(spec: VRFSpec, reg: int, device) -> torch.Tensor:
    """(n_banks, 1) bool: the banks register ``reg`` occupies."""
    mask = torch.zeros((spec.n_banks, 1), dtype=torch.bool, device=device)
    mask[:spec.blocks_per_reg] = True
    return torch.roll(mask, shifts=reg % spec.n_banks, dims=0)


# ---------------------------------------------------------------------------
# Row access (single architectural register) — Block Shifter only.
# ---------------------------------------------------------------------------

def write_row(spec: VRFSpec, vrf: torch.Tensor, reg: int,
              data: torch.Tensor) -> torch.Tensor:
    """Write one architectural register.  data: (blocks_per_reg *
    elems_per_block,)."""
    blocks = data.reshape(spec.blocks_per_reg, spec.elems_per_block)
    # Block Circular Shifter: rotate so block j lands in bank (reg+j)%nB.
    row = row_of(spec, reg, 0)
    banked = torch.zeros((spec.n_banks, spec.elems_per_block),
                         dtype=blocks.dtype, device=vrf.device)
    banked[:spec.blocks_per_reg] = blocks
    banked = torch.roll(banked, shifts=reg % spec.n_banks, dims=0)
    out = vrf.clone()
    if spec.blocks_per_reg == spec.n_banks:
        out[row] = banked
    else:   # partial-row registers: only touch this register's banks
        out[row] = torch.where(_bank_mask(spec, reg, vrf.device), banked,
                               vrf[row])
    return out


def read_row(spec: VRFSpec, vrf: torch.Tensor, reg: int) -> torch.Tensor:
    row = row_of(spec, reg, 0)
    banked = torch.roll(vrf[row], shifts=-(reg % spec.n_banks), dims=0)
    return banked[:spec.blocks_per_reg].reshape(-1)


# ---------------------------------------------------------------------------
# Column access (same block of consecutive registers) — Block Shifter + DROM.
# Used by segment ops: one memory beat per segment touches all banks once.
# ---------------------------------------------------------------------------

def _column(spec: VRFSpec, base_reg: int, block: int, count: int,
            device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, banks) index tensors of a column access."""
    rows = [row_of(spec, base_reg + i, 0) for i in range(count)]
    banks = [bank_of(spec, base_reg + i, block) for i in range(count)]
    return (torch.tensor(rows, dtype=torch.int64, device=device),
            torch.tensor(banks, dtype=torch.int64, device=device))


def read_column(spec: VRFSpec, vrf: torch.Tensor, base_reg: int, block: int,
                byte: int, count: int) -> torch.Tensor:
    """Collect element ``byte`` of block ``block`` from registers
    base_reg .. base_reg+count-1 (count <= n_banks).

    Reads every bank once (conflict-free), rotates (Block Shifter), then a
    GSN pass with stride = elems_per_block consolidates the target bytes —
    EARTH §4.5.2's "const stride value of EMUL x ELEN/8".
    """
    rows, banks = _column(spec, base_reg, block, count, vrf.device)
    flat = vrf[rows, banks].reshape(-1)          # (count * elems_per_block,)
    # gather element ``byte`` of each beat: stride=elems_per_block,
    # offset=byte (the paper's constant stride, element granularity)
    shift, valid = scg.gather_counts(flat.shape[0], spec.elems_per_block,
                                     byte, count, device=vrf.device)
    routed = shiftnet.gather_network(flat, shift, valid)
    return routed.payload[:count]


def write_column(spec: VRFSpec, vrf: torch.Tensor, base_reg: int, block: int,
                 byte: int, values: torch.Tensor) -> torch.Tensor:
    """Scatter values[i] into element ``byte`` of block ``block`` of register
    base_reg+i — one conflict-free parallel bank write (segment load
    beat)."""
    count = values.shape[0]
    n = spec.n_banks * spec.elems_per_block
    vals = torch.cat([values, values.new_zeros((n - count,))])
    shift, valid = scg.scatter_counts(n, spec.elems_per_block, byte, count,
                                      device=vrf.device)
    routed = shiftnet.scatter_network(vals, shift, valid)
    spread = routed.payload.reshape(spec.n_banks, spec.elems_per_block)
    vmask = routed.valid.reshape(spec.n_banks, spec.elems_per_block)
    rows, banks = _column(spec, base_reg, block, count, vrf.device)
    out = vrf.clone()
    out[rows, banks] = torch.where(vmask[:count], spread[:count],
                                   vrf[rows, banks])
    return out


def column_banks_distinct(spec: VRFSpec, base_reg: int, block: int,
                          count: int) -> bool:
    """Conflict-freeness invariant: a column access touches distinct
    banks."""
    banks = [bank_of(spec, base_reg + i, block) for i in range(count)]
    return len(set(banks)) == len(banks)
