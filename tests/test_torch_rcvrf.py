"""Port parity for ``repro_torch.core.rcvrf`` against ``repro.core.rcvrf``
(the port of tests/test_core_lsdo_rcvrf.py's RCVRF cases): the
diagonal-skew mapping (bijective, Fig. 9's placement, row and column
accesses conflict-free), and ``write_row`` / ``read_row`` /
``read_column`` / ``write_column`` against the reference's on the same
uint8 payloads, bit for bit.  The column cases are a fixed list that
covers every block, every count class (1, 4, 8) and bytes 0..7, each
computed once by the reference (eager JAX compiles each shape once;
a Hypothesis example per reference call would recompile)."""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, strategies as st
except ImportError:  # container without hypothesis: deterministic fallback
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _hypcompat import given, strategies as st

from _torch_bridge import assert_bits_equal
from repro.core import rcvrf as jrcvrf
from repro_torch.core import rcvrf

SPEC = rcvrf.VRFSpec(vlen=256, elen=64, n_regs=32, n_banks=8, elem_bits=8)
JSPEC = jrcvrf.VRFSpec(vlen=256, elen=64, n_regs=32, n_banks=8, elem_bits=8)
# (block, byte, count, base_reg): every block, counts 1 / 4 / 8, bytes 0-7
COLUMN_CASES = [(b, (3 * b + c) % 8, c, (5 * b + c) % 25)
                for b in range(4) for c in (1, 4, 8)] + \
    [(0, 7, 8, 24), (3, 0, 1, 0), (1, 6, 4, 16), (2, 1, 8, 0)]


def _row_data(reg, n=32):
    return ((np.arange(n) * 3 + 11 * reg) % 256).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------- the mapping ----------------------------------

@pytest.mark.parametrize("spec", [SPEC,
                                  rcvrf.VRFSpec(vlen=512, elen=64),
                                  rcvrf.VRFSpec(vlen=128, elen=32)])
def test_mapping_bijective_and_matches_reference(spec):
    jspec = jrcvrf.VRFSpec(**spec.__dict__)
    assert (spec.blocks_per_reg, spec.n_rows, spec.elems_per_block) == \
        (jspec.blocks_per_reg, jspec.n_rows, jspec.elems_per_block)
    seen = set()
    for reg in range(spec.n_regs):
        for blk in range(spec.blocks_per_reg):
            loc = rcvrf.locate(spec, reg, blk)
            assert loc == jrcvrf.locate(jspec, reg, blk)
            assert loc not in seen
            seen.add(loc)
    assert len(seen) == spec.n_regs * spec.blocks_per_reg


def test_paper_figure9_placement():
    # VREG0 -> Row0 Banks0..3; VREG4 -> Row4 Banks4..7; VREG8 -> Row4 Banks0..3
    assert [rcvrf.bank_of(SPEC, 0, j) for j in range(4)] == [0, 1, 2, 3]
    assert rcvrf.row_of(SPEC, 0, 0) == 0
    assert [rcvrf.bank_of(SPEC, 4, j) for j in range(4)] == [4, 5, 6, 7]
    assert rcvrf.row_of(SPEC, 4, 0) == 4
    assert rcvrf.row_of(SPEC, 8, 0) == 4
    assert [rcvrf.bank_of(SPEC, 8, j) for j in range(4)] == [0, 1, 2, 3]


@given(st.integers(0, 31))
def test_row_access_conflict_free(reg):
    banks = [rcvrf.bank_of(SPEC, reg, j) for j in range(SPEC.blocks_per_reg)]
    assert len(set(banks)) == len(banks)


@given(st.integers(0, 24), st.integers(0, 3), st.integers(1, 8))
def test_column_access_conflict_free(base, block, count):
    assert rcvrf.column_banks_distinct(SPEC, base, block, count)
    assert jrcvrf.column_banks_distinct(JSPEC, base, block, count)


def test_empty_vrf_follows_the_device_rule():
    vrf = rcvrf.empty_vrf(SPEC, device="cpu")
    assert tuple(vrf.shape) == (SPEC.n_rows, SPEC.n_banks,
                                SPEC.elems_per_block)
    assert vrf.dtype == torch.uint8 and not vrf.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rcvrf.empty_vrf(SPEC)


# ----------------------------- row access -----------------------------------

@functools.lru_cache(maxsize=None)
def _ref_rows(vlen):
    """The reference's VRF after each of n_regs row writes, and every
    register read back from the last."""
    spec = jrcvrf.VRFSpec(vlen=vlen, elen=64)
    n = spec.blocks_per_reg * spec.elems_per_block
    vrf, states = jrcvrf.empty_vrf(spec), []
    for reg in range(spec.n_regs):
        vrf = jrcvrf.write_row(spec, vrf, reg, jnp.asarray(_row_data(reg, n)))
        states.append(np.asarray(vrf))
    return states, [np.asarray(jrcvrf.read_row(spec, vrf, reg))
                    for reg in range(spec.n_regs)]


@pytest.mark.parametrize("vlen", [256, 512])
def test_rows_match_reference(vlen):
    """Partial rows (4 blocks over 8 banks) and whole rows (8 over 8):
    every write's VRF and every read against the reference's; the input
    VRF is left as it was."""
    spec = rcvrf.VRFSpec(vlen=vlen, elen=64)
    n = spec.blocks_per_reg * spec.elems_per_block
    states, reads = _ref_rows(vlen)
    vrf = rcvrf.empty_vrf(spec, device="cpu")
    for reg in range(spec.n_regs):
        before = vrf.clone()
        new = rcvrf.write_row(spec, vrf, reg, _t(_row_data(reg, n)))
        assert torch.equal(vrf, before)
        assert_bits_equal(new, states[reg])
        vrf = new
    for reg in range(spec.n_regs):
        got = rcvrf.read_row(spec, vrf, reg)
        assert_bits_equal(got, reads[reg])
        assert_bits_equal(got, _row_data(reg, n))


# ----------------------------- column access --------------------------------

@functools.lru_cache(maxsize=None)
def _ref_column(block, byte, count, base):
    """The reference's read_column from the full VRF of
    :func:`_ref_rows`, and its VRF after a write_column of
    ``100 + i`` into that VRF."""
    full = jnp.asarray(_ref_rows(256)[0][-1])
    col = jrcvrf.read_column(JSPEC, full, base, block, byte, count)
    vals = jnp.arange(count, dtype=jnp.uint8) + 100
    wrote = jrcvrf.write_column(JSPEC, full, base, block, byte, vals)
    return np.asarray(col), np.asarray(wrote)


@pytest.mark.parametrize("case", COLUMN_CASES)
def test_columns_match_reference(case):
    block, byte, count, base = case
    want_col, want_vrf = _ref_column(*case)
    full = _t(_ref_rows(256)[0][-1])
    before = full.clone()
    col = rcvrf.read_column(SPEC, full, base, block, byte, count)
    assert_bits_equal(col, want_col)
    # the column is element ``byte`` of block ``block`` of each register
    for i in range(count):
        assert int(col[i]) == _row_data(base + i)[
            block * SPEC.elems_per_block + byte]
    vals = torch.arange(count, dtype=torch.uint8) + 100
    wrote = rcvrf.write_column(SPEC, full, base, block, byte, vals)
    assert torch.equal(full, before)
    assert_bits_equal(wrote, want_vrf)
    for i in range(count):
        row = rcvrf.read_row(SPEC, wrote, base + i)
        assert int(row[block * SPEC.elems_per_block + byte]) == 100 + i


def test_cases_cover_every_block_count_and_byte():
    assert {c[0] for c in COLUMN_CASES} == set(range(4))
    assert {c[2] for c in COLUMN_CASES} == {1, 4, 8}
    assert {c[1] for c in COLUMN_CASES} == set(range(8))
