"""Port parity for the staged copy behind kernels B3 (``gather_strided``)
and B4 (``gather_strided_fused``).

On the card B3 and B4 run no shift layer: a gather plan's composed table
(``ShiftPlan.source``) is static, so the wrapper keeps per access the
staged-unit list (the copy units of a row that hold a source lane) and the
table remapped into the row compacted to those units
(``strided.staged_operands``, ``_common.staged_units``), and one staged
copy moves the rows.  Here, on the CPU, for 1-, 2-, 4- and 8-byte
elements and every copy unit the wrapper can pick:

* the plan's table is ``offset + i*stride`` on lanes [0, vl), all valid;
* the list covers every source lane, sorted and distinct, and the
  remapped table finds each lane in the compacted row;
* the composition as torch ops (``_common.staged_copy_plain``) equals the
  plain versions and the reference's own Pallas bodies
  (``_gather_plan_kernel``, ``_gather_fused_kernel``, interpret mode).  A
  Pallas interpret compile costs about half a second, so the reference
  routes a numbered int32 payload (``1 + lane``) once per geometry and
  each dtype is held against that map;
* the copy's tiles stay within ``_common.COPY_SMEM`` at n = 4096.

The ``cuda`` cases hold B3 and B4 against their plain versions bit for bit
on the card (ragged and large row counts, odd vl, an offset view, the
sector-only staging at wide strides, A up to 8) and skip without one:
``python -m pytest -m cuda tests/test_torch_strided_copy.py``.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch.core import shiftplan
from repro_torch.kernels import _common, strided

GATHER_GRID = [((), 128), ((4,), 64), ((2, 3), 256), ((5,), 96), ((8,), 512)]
GATHER_SO = [(2, 0), (3, 1), (4, 2), (7, 5), (1, 0), (16, 3)]
WIDE_SO = [(16, 3), (64, 0)]                 # n = 4096 only
# 1-, 2-, 4- and 8-byte elements
DTYPES = [torch.int8, torch.bfloat16, torch.float32, torch.int64]


def vl_of(n, stride, offset):
    return (n - 1 - offset) // stride + 1


def rand(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)
    return torch.from_numpy(rng.integers(-100, 100, shape)).to(dtype)


def per_units(n, elem):
    """Lanes per copy unit for every unit the wrapper can pick (16, 8, 4,
    2 or 1 bytes, at least one element) that divides the row."""
    return [u // elem for u in (16, 8, 4, 2, 1)
            if u >= elem and n % (u // elem) == 0]


def numbered_map(n, pairs, vl):
    """The reference's own tables: ``1 + lane`` routed by its Pallas body
    in interpret mode (``_gather_plan_kernel`` for one access,
    ``_gather_fused_kernel`` for several), minus one; ``(A, vl)``."""
    import jax.numpy as jnp
    from repro.kernels import strided as jstrided
    ids = jnp.arange(1, n + 1, dtype=jnp.int32)
    if len(pairs) == 1:
        (s, o), = pairs
        got = jstrided.gather_strided(ids[None], s, o, vl)
    else:
        got = jstrided.gather_strided_fused(
            jnp.stack([ids[None]] * len(pairs)), pairs, vl)
    return np.asarray(got).reshape(len(pairs), vl) - 1


def check_access(win, stride, offset, vl, want_src):
    """One access: the plan's table, the staged-unit list and the remapped
    table at every copy unit, and the twin's output against the plain
    version and the reference's map."""
    n = win.shape[-1]
    plan = shiftplan.gather_plan(n, stride, offset, vl)
    src = plan.source[:vl]
    assert plan.valid[:vl].all()
    np.testing.assert_array_equal(src, offset + stride * np.arange(vl))
    np.testing.assert_array_equal(src, want_src)
    rows = win.reshape(-1, n)
    plain = strided.gather_strided_plain(win, stride, offset, vl)
    assert_bits_equal(plain, win[..., torch.from_numpy(want_src).long()])
    elem = win.element_size()
    sector = 32 // elem
    every_sector = len(set((src // sector).tolist())) == -(-n // sector)
    for pu in per_units(n, elem):
        units, pos = _common.staged_units(src, n, pu, elem)
        assert units.dtype == np.int32 and pos.dtype == np.int32
        assert np.all(np.diff(units) > 0)                # sorted, distinct
        if every_sector:                                 # the whole row
            assert units.tolist() == list(range(n // pu))
        else:
            assert set(units.tolist()) == set((src // pu).tolist())
        assert 0 <= units.min() and units.max() < n // pu
        # lane j sits at pos[j] of the row compacted to the listed units
        compact = (units[:, None] * pu + np.arange(pu)).reshape(-1)
        np.testing.assert_array_equal(compact[pos], src)
        got = _common.staged_copy_plain(rows, units, pos, pu)
        assert_bits_equal(got.reshape(plain.shape), plain)


@pytest.mark.parametrize("n", sorted({n for _, n in GATHER_GRID}) + [4096])
def test_staged_copy_b3_vs_reference(n):
    """B3's composition on the gather grid (n = 4096: the wide strides
    (16, 3) and (64, 0)), every dtype width and copy unit."""
    lead = dict((n_, lead_) for lead_, n_ in GATHER_GRID).get(n, (3,))
    pairs = WIDE_SO if n == 4096 else GATHER_SO
    for stride, offset in pairs:
        vl = vl_of(n, stride, offset)
        want_src = numbered_map(n, [(stride, offset)], vl)[0]
        for d, dtype in enumerate(DTYPES):
            check_access(rand(d, lead + (n,), dtype), stride, offset, vl,
                         want_src)


@pytest.mark.parametrize("A", [2, 4, 8])
def test_staged_copy_b4_vs_reference(A):
    """B4's composition: A accesses of mixed (stride, offset) over one
    launch's operands (``strided.staged_operands``: one padded unit list
    per access, its length, one remapped table per access), applied per
    access, against the plain version and the reference's fused body."""
    so = GATHER_SO + WIDE_SO
    for n in (96, 256, 4096):
        pairs = [so[(a * 3 + A) % len(so)] for a in range(A)]
        pairs = [(s, o) for s, o in pairs if o < n]
        vl = min(vl_of(n, s, o) for s, o in pairs)
        want_src = numbered_map(n, pairs, vl)
        source = np.stack([shiftplan.gather_plan(n, s, o, vl).source[:vl]
                           for s, o in pairs]).astype(np.int32)
        np.testing.assert_array_equal(source, want_src)
        for d, dtype in enumerate(DTYPES):
            wins = rand(d, (len(pairs), 5, n), dtype)
            plain = strided.gather_strided_fused_plain(wins, pairs, vl)
            for pu in per_units(n, wins.element_size()):
                ops = strided.staged_operands(source, n, pu,
                                              wins.element_size())
                K = ops["nunits"]
                assert ops["units"].shape == (len(pairs), ops["kmax"])
                assert ops["kmax"] == K.max() and ops["pos"].shape == (
                    len(pairs), vl)
                for a in range(len(pairs)):
                    units = ops["units"][a, :K[a]]
                    assert not ops["units"][a, K[a]:].any()     # padding
                    got = _common.staged_copy_plain(wins[a], units,
                                                    ops["pos"][a], pu)
                    assert_bits_equal(got, plain[a])
                    idx = torch.from_numpy(want_src[a]).long()
                    assert_bits_equal(got, wins[a][:, idx])


def staged_smem(vl, kmax, rows, sunit, elem):
    """``staged_copy_smem`` of csrc/perm_copy.cuh: the table, the unit
    list, two staged tiles and the output tile, each padded to 16 B."""
    def pad(b):
        return -(-b // 16) * 16
    return (pad(vl * 4) + pad(kmax * 4) + 2 * pad(rows * kmax * sunit)
            + pad(rows * vl * elem))


def test_staged_copy_tiles_fit():
    """The wrapper's tile height (``copy_tile_rows`` on the staged lanes
    and the unit list) keeps a block within COPY_SMEM at n = 4096 wherever
    one row fits it, and within the card's 227 KB at one row otherwise;
    sector-only staging fits more rows: at (64, 0) in bf16 a staged row is
    one unit in eight, and a tile holds several times the rows."""
    n, R, blocks = 4096, 1 << 15, 264
    for stride, offset in GATHER_SO + WIDE_SO:
        vl = vl_of(n, stride, offset)
        src = shiftplan.gather_plan(n, stride, offset, vl).source[:vl]
        for elem in (1, 2, 4, 8):
            sunit = 16
            pu = sunit // elem
            kmax = len(_common.staged_units(src, n, pu, elem)[0])
            rows = _common.copy_tile_rows(R, kmax * pu, vl, 1, elem, blocks,
                                          units=kmax)
            smem = staged_smem(vl, kmax, rows, sunit, elem)
            assert rows >= 1 and smem <= _common.SMEM_LIMIT
            if rows > 1 or staged_smem(vl, kmax, 1, sunit, elem) <= \
                    _common.COPY_SMEM:
                assert smem <= _common.COPY_SMEM, (stride, offset, elem)
    src = shiftplan.gather_plan(n, 64, 0, 64).source[:64]
    units, _ = _common.staged_units(src, n, 8, 2)
    assert len(units) == 64 and len(units) * 8 == n // 8
    sector = _common.copy_tile_rows(R, 64 * 8, 64, 1, 2, blocks, units=64)
    whole = _common.copy_tile_rows(R, n, 64, 1, 2, blocks)
    assert sector >= 8 * whole
    assert _common.copy_tile_rows(7, 512, 64, 1, 2, blocks, units=64) == 1


def test_staged_units_edges():
    """One lane; a source lane below zero (no gather plan has one) is
    refused; the twin on a whole-row list is the gather itself."""
    units, pos = _common.staged_units(np.array([0]), 1, 1, 4)
    assert units.tolist() == [0] and pos.tolist() == [0]
    with pytest.raises(ValueError):
        _common.staged_units(np.array([3, -1]), 8, 8, 2)
    x = rand(0, (3, 64), torch.bfloat16)
    units, pos = _common.staged_units(np.arange(1, 64, 2), 64, 8, 2)
    assert units.tolist() == list(range(8))
    np.testing.assert_array_equal(pos, np.arange(1, 64, 2))
    assert_bits_equal(_common.staged_copy_plain(x, units, pos, 8),
                      x[:, 1::2])


@pytest.mark.parametrize("elem,stride,listed", [
    (2, 16, 128), (2, 32, 32), (2, 64, 16), (4, 8, 256), (4, 16, 64),
    (1, 32, 64), (1, 64, 16), (8, 4, 512), (8, 8, 128)])
def test_staged_units_sector_rule(elem, stride, listed):
    """A 1024-lane row at offset 0, 16-byte units: the list holds only the
    units with a source lane once those skip a 32-byte sector (``listed``
    units), and the whole row while they touch every sector (16 B apart
    in bf16: one unit in two, but every sector), where one contiguous
    chunk moves the same sectors faster."""
    n, pu = 1024, 16 // elem
    src = stride * np.arange((n - 1) // stride + 1)
    units, pos = _common.staged_units(src, n, pu, elem)
    assert len(units) == listed
    if listed == n // pu:
        np.testing.assert_array_equal(pos, src)
    else:
        np.testing.assert_array_equal(units, np.unique(src // pu))
        np.testing.assert_array_equal(pos, np.arange(len(src)) * pu)


# ---------------------------------------------------------------------------
# On the card: B3 and B4 against their plain versions
# ---------------------------------------------------------------------------

def card_rand(seed, shape, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=device).to(dtype)
    return torch.randint(-100, 100, shape, generator=g, device=device,
                         dtype=dtype)


def card_pairs(n):
    return [(s, o) for s, o in GATHER_SO + WIDE_SO if o < n]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [96, 256, 4096])
@pytest.mark.parametrize("rows", [7, 1001, 20011])
def test_b3_b4_match_plain_on_card(cuda_device, dtype, n, rows):
    """B3 at every (stride, offset) with the largest vl and an odd one; B4
    with 2, 4 and 8 accesses of mixed strides."""
    win = card_rand(1, (rows, n), dtype, cuda_device)
    for stride, offset in card_pairs(n):
        top = vl_of(n, stride, offset)
        for vl in sorted({top, max(1, (top // 2) | 1)}):
            got = strided.gather_strided(win, stride, offset, vl)
            torch.cuda.synchronize()
            assert_bits_equal(got, strided.gather_strided_plain(
                win, stride, offset, vl))
    so = card_pairs(n)
    for A in (2, 4, 8):
        pairs = [so[(a * 3 + A) % len(so)] for a in range(A)]
        vl = min(vl_of(n, s, o) for s, o in pairs)
        wins = card_rand(2 + A, (A, rows, n), dtype, cuda_device)
        got = strided.gather_strided_fused(wins, pairs, vl)
        torch.cuda.synchronize()
        assert_bits_equal(got, strided.gather_strided_fused_plain(
            wins, pairs, vl))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_b3_b4_sector_only_and_offset_views_on_card(cuda_device, dtype):
    """The sector-only staging at (16, 3) and (64, 0) in 1- and 2-byte
    elements on a 4096-lane window; an offset view (data_ptr one element
    past a 16-byte boundary, so the staging unit falls to the element);
    an odd vl, so the store unit narrows; each call one launch; the
    operands on the card equal the host plan's."""
    n = 4096
    win = card_rand(3, (20011, n), dtype, cuda_device)
    strided.reset_counts()
    for stride, offset in WIDE_SO:
        for vl in (vl_of(n, stride, offset), 17):
            got = strided.gather_strided(win, stride, offset, vl)
            torch.cuda.synchronize()
            assert_bits_equal(got, strided.gather_strided_plain(
                win, stride, offset, vl))
    assert strided.gather_strided.launches == 4
    flat = card_rand(4, (1 + 517 * 1024,), dtype, cuda_device)
    view = flat[1:].view(517, 1024)
    assert view.data_ptr() % 16 != 0
    for stride, offset in ((64, 0), (16, 3), (2, 1)):
        vl = vl_of(1024, stride, offset)
        got = strided.gather_strided(view, stride, offset, vl)
        torch.cuda.synchronize()
        assert_bits_equal(got, strided.gather_strided_plain(
            view, stride, offset, vl))
    wins = torch.stack([win[:1001]] * 2)
    got = strided.gather_strided_fused(wins, WIDE_SO, 63)
    torch.cuda.synchronize()
    assert_bits_equal(got, strided.gather_strided_fused_plain(
        wins, WIDE_SO, 63))
    assert strided.gather_strided_fused.launches == 1
    ops = strided._operands("gather", n, tuple(WIDE_SO), 63, win.device)
    host = np.stack([shiftplan.gather_plan(n, s, o, 63).source[:63]
                     for s, o in WIDE_SO])
    np.testing.assert_array_equal(ops["source"].cpu().numpy(), host)
    for pu, st in ops["staged"].items():          # (lanes a unit, elem)
        want = strided.staged_operands(host, n, *pu)
        for k in ("units", "nunits", "pos"):
            np.testing.assert_array_equal(st[k].cpu().numpy(), want[k])
