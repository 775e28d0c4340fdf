"""Port parity for the two table-driven copy forms behind kernels B1
(``segment.deinterleave``) and B9 (``strided.scatter_strided_dynamic``).

B1 runs no shift layer on the card: a deinterleave plan's composed table
(``ShiftPlan.source``) is static, so the wrapper keeps the ``(fields, m)``
table (``segment.deinterleave_table``) and one permuted copy moves the rows
through it.  B9 derives the SSN once per launch into an n-entry source
table, compacts its occupied lanes into a list of (lane, values lane)
pairs (``_common.merge_pairs``), and one merge copy writes those lanes of
a copy of the window.  Here, on the CPU, for 1-, 2-, 4- and 8-byte
elements:

* B1, over fields 2, 3, 4, 5 and 8, widths 96, 256 and 6144, the cost
  model's plans and the fused Benes plan: the table is ``f + j*fields``
  with every lane valid, it equals the reference's own table (a numbered
  int32 payload routed once per geometry by ``_deint_plan_kernel`` in
  interpret mode, minus one), and the table applied as torch ops equals
  ``deinterleave_plain``;
* B9, over the scatter grid of tests/test_torch_dynamic.py plus n = 4096
  at (64, 0) and n = 2048 at (32, 7): the merge twin
  (``where(tab >= 0, pad(vals)[tab], window)`` and
  ``_common.merge_copy_plain`` on the list) equals
  ``scatter_strided_dynamic_plain`` and the reference's
  ``_scatter_dyn_kernel`` (interpret mode, window and values numbered
  apart, once per geometry), and the list holds exactly vl sorted,
  distinct lanes;
* the merge copy's tiles fit ``_common.COPY_SMEM`` with several rows at
  n = 4096.

The ``cuda`` cases hold B1 and B9 against their plain versions bit for bit
on the card (7, 1001 and 20011 rows, odd widths, offset views), B9 against
its plan twin B5 and its device list against the twin, and run B1 and B9
right behind a kernel that writes their input on the same stream, with no
synchronization between them; they skip without a card:
``python -m pytest -m cuda tests/test_torch_copy_forms.py``.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch.core import scg, shiftplan
from repro_torch.kernels import _common, segment, strided

# 1-, 2-, 4- and 8-byte elements
DTYPES = [torch.int8, torch.bfloat16, torch.float32, torch.int64]
SEGMENT_FIELDS = [2, 3, 4, 5, 8]
SEGMENT_WIDTHS = [96, 256, 6144]
SCATTER_GRID = [((), 128), ((4,), 64), ((3, 2), 256)]
SCATTER_SO = [(2, 0), (3, 1), (5, 4), (1, 0)]
# (lead, n, stride, offset) beyond the grid: wide windows of few values
WIDE_SCATTERS = [((3,), 4096, 64, 0), ((2,), 2048, 32, 7)]


def rand(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        a = rng.normal(size=shape).astype(np.float32)
        a.reshape(-1)[::7] = -0.0
        return torch.from_numpy(a).to(dtype)
    return torch.from_numpy(rng.integers(-100, 100, shape)).to(dtype)


def vl_of(n, stride, offset):
    return (n - 1 - offset) // stride + 1


def segment_plans(n, fields, mode):
    if mode == "fused":
        return ("fused", (shiftplan.deinterleave_plan(n, fields),))
    return shiftplan.segment_deinterleave_plans(n, fields)


# ---------------------------------------------------------------------------
# B1: the permuted copy through the host plan's table
# ---------------------------------------------------------------------------

def reference_deint_table(n, fields, mode):
    """The reference's own table: lanes ``1 + j`` of an 8-row beat routed
    by its ``_deint_plan_kernel`` (interpret mode) under the reference's
    plans for ``mode``, minus one; ``(fields, m)``."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from repro.core import shiftplan as jplan
    from repro.kernels import _common as jcommon
    from repro.kernels import segment as jseg
    m = n // fields
    mode, plans = (("fused", (jplan.deinterleave_plan(n, fields),))
                   if mode == "fused" else
                   jplan.segment_deinterleave_plans(n, fields))
    masks, spans = jseg._stack_masks(plans)
    S, W = masks.shape
    ids = jnp.broadcast_to(jnp.arange(1, n + 1, dtype=jnp.int32), (8, n))
    outs = jcommon.call(
        functools.partial(jseg._deint_plan_kernel, mode=mode, plans=plans,
                          spans=spans, fields=fields),
        out_shape=tuple(jax.ShapeDtypeStruct((8, m), jnp.int32)
                        for _ in range(fields)),
        grid=(1,),
        in_specs=[pl.BlockSpec((S, W), lambda i: (0, 0)),
                  pl.BlockSpec((8, n), lambda i: (0, 0))],
        out_specs=tuple(pl.BlockSpec((8, m), lambda i: (0, 0))
                        for _ in range(fields)),
    )(jnp.asarray(masks), ids)
    return np.stack([np.asarray(o)[0] for o in outs]) - 1


def apply_table(x, table):
    """``x`` (..., n) through a ``(fields, m)`` table: output f takes
    lanes ``table[f]`` of each row, 0 where the entry is -1 (what the
    permuted copy computes)."""
    outs = []
    for row in torch.from_numpy(np.asarray(table, np.int64)):
        got = x[..., row.clamp(min=0)]
        outs.append(torch.where(row >= 0, got,
                                torch.zeros((), dtype=x.dtype)))
    return outs


@pytest.mark.parametrize("width", SEGMENT_WIDTHS)
@pytest.mark.parametrize("fields", SEGMENT_FIELDS)
def test_b1_table_vs_reference(fields, width):
    """B1's host table, in both plan modes: ``f + j*fields`` with every
    lane valid, equal to the reference's own table, and applied to the
    data equal to ``deinterleave_plain`` for every element width."""
    m = width // fields
    n = fields * m
    want = np.arange(fields)[:, None] + fields * np.arange(m)[None, :]
    for mode in ("picked", "fused"):
        plans = segment_plans(n, fields, mode)
        table = segment.deinterleave_table(*plans, n, fields)
        assert table.dtype == np.int32 and table.shape == (fields, m)
        np.testing.assert_array_equal(table, want, err_msg=mode)
        np.testing.assert_array_equal(
            table, reference_deint_table(n, fields, mode), err_msg=mode)
        for d, dtype in enumerate(DTYPES):
            aos = rand(d, (3, n), dtype)
            plain = segment.deinterleave_plain(aos, fields, plans=plans)
            for got, w in zip(apply_table(aos, table), plain):
                assert_bits_equal(got, w)


def test_b1_table_marks_unoccupied_lanes():
    """A lane a plan leaves unoccupied, or fills from its zero padding,
    becomes -1 (the copy writes 0); every deinterleave plan has none."""
    n, fields = 12, 3
    mode, plans = segment_plans(n, fields, "fused")
    plan = plans[0]
    assert plan.n == 16                      # padded to a power of two
    table = segment.deinterleave_table(mode, plans, n, fields)
    assert (table >= 0).all()
    fake = type("Plan", (), {"source": plan.source.copy(),
                             "valid": plan.valid.copy()})()
    fake.source[1] = 13                      # a padding lane
    fake.valid[5] = False
    table = segment.deinterleave_table("fused", (fake,), n, fields)
    assert table[0, 1] == -1 and table[1, 1] == -1
    assert (np.delete(table.reshape(-1), [1, 5]) >= 0).all()


# ---------------------------------------------------------------------------
# B9: one derivation per launch plus a merge copy
# ---------------------------------------------------------------------------

def reference_scatter_map(lead, n, stride, offset, vl):
    """The reference's ``_scatter_dyn_kernel`` (interpret mode) on a
    window numbered ``1 + i`` and values numbered after it: which input
    each output lane holds (jitted: the same bits, a fraction of the
    time)."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.kernels import strided as jstrided
    shape, vshape = lead + (n,), lead + (vl,)
    size = int(np.prod(shape))
    win = np.arange(1, size + 1, dtype=np.int32).reshape(shape)
    vals = np.arange(size + 1, size + 1 + int(np.prod(vshape)),
                     dtype=np.int32).reshape(vshape)
    fn = jax.jit(functools.partial(jstrided.scatter_strided, stride=stride,
                                   offset=offset, compiled=False))
    return np.asarray(fn(jnp.asarray(win), jnp.asarray(vals)))


def take(sources, x):
    """``x``'s elements (flattened) at the reference's element numbers."""
    idx = torch.from_numpy(np.asarray(sources, np.int64))
    flat = torch.cat([torch.zeros(1, dtype=x.dtype), x.reshape(-1)])
    return flat[idx.reshape(-1)].reshape(idx.shape)


def check_merge(lead, n, stride, offset, vl, ref_map=None):
    """One scatter geometry: the SSN table and its list, both twins of the
    merge copy against the plain version (and the reference's map)."""
    table = _common.dyn_sources_plain(
        *scg.scatter_counts(n, stride, offset, vl), gsn=False)
    pairs = _common.merge_pairs(table)
    assert pairs.dtype == torch.int32 and pairs.shape == (vl, 2)
    lanes = pairs[:, 0]
    assert (lanes[1:] > lanes[:-1]).all()               # sorted, distinct
    np.testing.assert_array_equal(
        lanes.numpy(), offset + stride * np.arange(vl))
    np.testing.assert_array_equal(pairs[:, 1].numpy(), np.arange(vl))
    tab = table.long()
    for d, dtype in enumerate(DTYPES):
        win, vals = rand(10 + d, lead + (n,), dtype), rand(
            20 + d, lead + (vl,), dtype)
        plain = strided.scatter_strided_dynamic_plain(win, vals, stride,
                                                      offset)
        padded = torch.nn.functional.pad(vals, (0, n - vl))
        assert_bits_equal(torch.where(tab >= 0, padded[..., tab.clamp(min=0)],
                                      win), plain)
        assert_bits_equal(_common.merge_copy_plain(win, vals, pairs), plain)
        if ref_map is not None:
            both = torch.cat([win.reshape(-1), vals.reshape(-1)])
            assert_bits_equal(plain, take(ref_map, both))


@pytest.mark.parametrize("lead,n", SCATTER_GRID)
def test_b9_merge_vs_reference_grid(lead, n):
    """The merge copy's composition on the scatter grid: the reference
    routes each (stride, offset) once at the largest vl; half and one
    value are held against the plain version."""
    for stride, offset in SCATTER_SO:
        vl = vl_of(n, stride, offset)
        check_merge(lead, n, stride, offset, vl,
                    reference_scatter_map(lead, n, stride, offset, vl))
        for fewer in {max(1, vl // 2), 1}:
            check_merge(lead, n, stride, offset, fewer)


@pytest.mark.parametrize("lead,n,stride,offset", WIDE_SCATTERS)
def test_b9_merge_wide_windows(lead, n, stride, offset):
    """n = 4096 at (64, 0) and n = 2048 at (32, 7): vl = 64 values into a
    window of thousands of lanes, where the list (64 pairs) replaces a
    scan of every lane."""
    vl = vl_of(n, stride, offset)
    check_merge(lead, n, stride, offset, vl,
                reference_scatter_map(lead, n, stride, offset, vl))


def test_b9_merge_one_lane_and_list_edges():
    """n = 1 (no layer): one pair (0, 0); the twin on an empty list keeps
    the window."""
    table = _common.dyn_sources_plain(*scg.scatter_counts(1, 1, 0, 1),
                                      gsn=False)
    assert _common.merge_pairs(table).tolist() == [[0, 0]]
    win, vals = rand(0, (4, 1), torch.float32), rand(1, (4, 1), torch.float32)
    assert_bits_equal(strided.scatter_strided_dynamic_plain(win, vals, 1, 0),
                      vals)
    empty = _common.merge_pairs(torch.full((8,), -1, dtype=torch.int32))
    assert empty.shape == (0, 2)
    win = rand(2, (3, 8), torch.bfloat16)
    assert_bits_equal(_common.merge_copy_plain(win, win[:, :2], empty), win)


def merge_smem(n, vl, kmax, rows, elem):
    """``merge_copy_smem`` of csrc/perm_copy.cuh: the list, two window
    tiles and two value tiles, each padded to 16 bytes."""
    def pad(b):
        return -(-b // 16) * 16
    return (pad(kmax * 8) + 2 * pad(rows * n * elem)
            + 2 * pad(rows * vl * elem))


def test_merge_tile_rows_fit():
    """The merge copy's tile height keeps a block within COPY_SMEM with
    several rows at n = 4096 (no output tile: the window tile is merged in
    place), spreads a small call over the blocks, and raises where one row
    does not fit the card."""
    R, blocks = 1 << 15, 264
    for n, vl, elem in ((4096, 64, 2), (4096, 64, 4), (256, 128, 2),
                        (2048, 64, 4), (96, 96, 1)):
        rows = _common.merge_tile_rows(R, n, vl, vl, elem, blocks)
        assert rows > 1, (n, vl, elem)
        assert merge_smem(n, vl, vl, rows, elem) <= _common.COPY_SMEM
        assert merge_smem(n, vl, vl, rows + 1, elem) > _common.COPY_SMEM or \
            rows == -(-R // blocks)
    # the main shape: (28*4*512*8, 256) bf16, vl 128
    assert _common.merge_tile_rows(458752, 256, 128, 128, 2, 264) == 63
    assert _common.merge_tile_rows(4096 * 16, 4096, 64, 64, 2, 264) == 5
    assert _common.merge_tile_rows(7, 256, 128, 128, 2, 264) == 1
    # 8-byte lanes at n = 4096: one row a tile, still within the budget
    assert _common.merge_tile_rows(R, 4096, 64, 64, 8, blocks) == 1
    assert merge_smem(4096, 64, 64, 1, 8) <= _common.COPY_SMEM
    with pytest.raises(ValueError):
        _common.merge_tile_rows(1, 16384, 8192, 8192, 8, 264)


# ---------------------------------------------------------------------------
# On the card: B1 and B9 against their plain versions
# ---------------------------------------------------------------------------

CARD_SO = [(1, 0), (2, 0), (2, 1), (3, 1), (4, 2), (7, 5), (16, 3), (64, 0)]


def assert_same_bits(got, want):
    """Bit for bit, compared on the card (integer views): moving the
    20011-row cases to the host for the comparison would take most of the
    test's time.  The host comparison, with its report, runs only when
    they differ."""
    def ints(t):
        return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                    4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    if not (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(ints(got), ints(want))):
        assert_bits_equal(got, want)


def card_rand(seed, shape, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if not dtype.is_floating_point:
        return torch.randint(-100, 100, shape, generator=g, device=device,
                             dtype=dtype)
    x = torch.randn(shape, generator=g, device=device)
    x.view(-1)[::7] = -0.0
    x.view(-1)[3::11] = float("nan")
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [7, 1001, 20011])
def test_b1_matches_plain_on_card(cuda_device, dtype, rows):
    """B1 at widths 96, 256 and 6144 with fields 2, 3, 4 and 8, both plan
    modes: one launch a call, bit-exact against the plain version."""
    for width in (96, 256, 6144):
        for fields in (2, 3, 4, 8):
            m = width // fields
            n = fields * m
            aos = card_rand(fields, (rows, n), dtype, cuda_device)
            for mode in ("picked", "fused"):
                plans = segment_plans(n, fields, mode)
                before = segment.deinterleave.launches
                got = segment.deinterleave(aos, fields, plans=plans)
                torch.cuda.synchronize()
                assert segment.deinterleave.launches == before + 1
                want = segment.deinterleave_plain(aos, fields, plans=plans)
                for g, w in zip(got, want):
                    assert_same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [7, 1001, 20011])
def test_b9_matches_plain_and_b5_on_card(cuda_device, dtype, rows):
    """B9 at n = 96, 256, 2048 and 4096 over CARD_SO, the largest vl and
    an odd one: bit-exact against its plain version and its plan twin B5,
    one launch a call."""
    for n in (96, 256, 2048, 4096):
        win = card_rand(n, (rows, n), dtype, cuda_device)
        for stride, offset in CARD_SO:
            top = vl_of(n, stride, offset)
            for vl in sorted({top, max(1, (top // 2) | 1)}):
                vals = card_rand(vl, (rows, vl), dtype, cuda_device)
                before = strided.scatter_strided_dynamic.launches
                got = strided.scatter_strided(win, vals, stride, offset,
                                              compiled=False)
                torch.cuda.synchronize()
                assert strided.scatter_strided_dynamic.launches == before + 1
                assert_same_bits(got, strided.scatter_strided_dynamic_plain(
                    win, vals, stride, offset))
                assert_same_bits(got, strided.scatter_strided(
                    win, vals, stride, offset))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_b1_b9_odd_widths_and_offset_views_on_card(cuda_device, dtype):
    """Views whose data_ptr is one element past a 16-byte boundary (the
    copy unit falls to the element) and odd widths (a 2- or 1-byte unit),
    for B1 in both plan modes and for B9's window and values."""
    flat = card_rand(1, (1 + 517 * 256,), dtype, cuda_device)
    view = flat[1:].view(517, 256)
    assert view.data_ptr() % 16 != 0
    odd = card_rand(2, (1003, 99), dtype, cuda_device)
    for x, fields in ((view, 2), (view, 4), (odd, 3), (odd, 9)):
        n = x.shape[-1]
        for mode in ("picked", "fused"):
            plans = segment_plans(n, fields, mode)
            got = segment.deinterleave(x, fields, plans=plans)
            torch.cuda.synchronize()
            for g, w in zip(got, segment.deinterleave_plain(x, fields,
                                                            plans=plans)):
                assert_same_bits(g, w)
    vflat = card_rand(3, (1 + 517 * 128,), dtype, cuda_device)
    vview = vflat[1:].view(517, 128)
    for win, stride, offset, vals in (
            (view, 2, 1, vview), (view, 2, 0, vview[:, :128].contiguous()),
            (odd, 7, 5, card_rand(4, (1003, 14), dtype, cuda_device)),
            (odd, 3, 1, card_rand(5, (1003, 33), dtype, cuda_device))):
        got = strided.scatter_strided(win, vals, stride, offset,
                                      compiled=False)
        torch.cuda.synchronize()
        assert_same_bits(got, strided.scatter_strided_dynamic_plain(
            win, vals, stride, offset))


@pytest.mark.cuda
def test_b9_device_list_on_card(cuda_device):
    """B9's derivation alone: the SSN table equals
    ``_common.dyn_sources_plain`` and the list equals
    ``_common.merge_pairs`` of it, exactly vl pairs for an access that
    fits (also at vl below the largest)."""
    for n in (1, 96, 256, 2048, 4096):
        for stride, offset in CARD_SO:
            if offset >= n:
                continue
            top = vl_of(n, stride, offset)
            for vl in sorted({top, max(1, top // 2), 1}):
                want = _common.dyn_sources_plain(
                    *scg.scatter_counts(n, stride, offset, vl), gsn=False)
                table, raw = strided.dynamic_merge_list(n, stride, offset,
                                                        vl, device=cuda_device)
                raw = raw.cpu()
                K = int(raw[0])
                where = f"n={n} ({stride}, {offset}) vl={vl}"
                np.testing.assert_array_equal(table.cpu().numpy(),
                                              want.numpy(), err_msg=where)
                assert K == vl, where
                np.testing.assert_array_equal(
                    raw[1:1 + 2 * K].view(K, 2).numpy(),
                    _common.merge_pairs(want).numpy(), err_msg=where)


@pytest.mark.cuda
def test_b1_operands_on_card(cuda_device):
    """On the card the deinterleave operands hold the host table and none
    of the plan layer loop's operands; nor do B2's, whose interleave copy
    takes its own table (tests/test_torch_store_copies.py)."""
    for fields, n in ((2, 256), (3, 96), (8, 6144)):
        for mode in ("picked", "fused"):
            plans = segment_plans(n, fields, mode)
            ops = segment._operands("deint", *plans, n, fields, cuda_device)
            np.testing.assert_array_equal(
                ops["table"].cpu().numpy(),
                segment.deinterleave_table(*plans, n, fields))
            assert not {"masks_bits", "layers", "plan_lo"} & set(ops)
    iops = segment._operands("int", *shiftplan.segment_interleave_plans(
        256, 2), 256, 2, cuda_device)
    assert not {"masks_bits", "layers", "plan_lo"} & set(iops)


@pytest.mark.cuda
def test_b1_b9_right_behind_their_producer_on_card(cuda_device):
    """B1 has no derive kernel before its copy, so it runs without
    Programmatic Dependent Launch: a kernel that writes its input just
    before it on the same stream, with no synchronization between them,
    must be complete before the copy reads.  128 rounds of
    ``torch.add(a, k, out=x)`` then B1 (and B9 on the same window), each
    result held against the plain version on the same ``x``."""
    R, n = 1 << 17, 256                               # 64 MiB of bf16
    a = card_rand(7, (R, n), torch.bfloat16, cuda_device)
    vals = card_rand(8, (R, n // 2), torch.bfloat16, cuda_device)
    x = torch.empty_like(a)
    for k in range(128):
        x.zero_()
        torch.cuda.synchronize()
        torch.add(a, float(k % 7 + 1), out=x)
        got = segment.deinterleave(x, 2)
        got9 = strided.scatter_strided(x, vals, 2, 1, compiled=False)
        want = segment.deinterleave_plain(x, 2)
        want9 = strided.scatter_strided_dynamic_plain(x, vals, 2, 1)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert_same_bits(g, w)
        assert_same_bits(got9, want9)
