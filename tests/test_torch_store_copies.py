"""Port parity for the two table-driven store copies behind kernels B5
(``strided.scatter_strided``) and B2 (``segment.interleave``), and for
the kernel wrappers' contiguity contract.

B5 runs no shift layer on the card: a scatter plan's table
(``ShiftPlan.source`` under ``.valid``) is static, so the wrapper composes
the merge copy's list on the host (``strided.scatter_pairs``, through
``_common.merge_pairs``, B9's list format) and one merge copy writes the
listed lanes of a copy of the window.  B2 likewise: every interleave plan
sends lane j of field f to output lane f + j*fields, so the wrapper keeps
the ``(n,)`` table (``segment.interleave_table``) and one interleave copy
moves the fields' rows through it.  Here, on the CPU, for 1-, 2-, 4- and
8-byte elements:

* B5, over the scatter grid of tests/test_torch_copy_forms.py plus n =
  4096 at (64, 0) and n = 2048 at (32, 7): the host list equals the one
  read off the reference's ``_scatter_plan_kernel`` (interpret mode,
  window and values numbered apart, once per geometry) and B9's list
  (``merge_pairs`` of ``dyn_sources_plain``) pair for pair, and the merge
  twin on it equals ``scatter_strided_plain`` and the reference;
* B2, over fields 2, 3, 4, 5 and 8, widths 96, 256 and 6144, the cost
  model's plans and the fused Benes plan: the table is ``f*m + j`` at lane
  ``f + j*fields``, equals the reference's own table (a numbered payload
  routed by ``_int_plan_kernel`` in interpret mode, and by the reference's
  ``interleave``), and ``take(cat(fields), table)`` equals
  ``interleave_plain``;
* the interleave copy's tiles fit ``_common.COPY_SMEM``, with two rows at
  n = 6144 in bf16.

The ``cuda`` cases hold B5 and B2 against their plain versions bit for bit
on the card (7, 1001 and 20011 rows, odd widths, offset views), B5 against
B9, ``interleave(deinterleave(x))`` against ``x``, run both right behind a
kernel that writes their input on the same stream, and hand every kernel
wrapper (B1-B14) and the ``vx`` Strided and Segment verbs a transposed
view and a last-dim slice of a wider tensor; they skip without a card:
``python -m pytest -m cuda tests/test_torch_store_copies.py``.
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


def interleave_plans(n, fields, mode):
    if mode == "fused":
        return ("fused", (shiftplan.interleave_plan(n, fields),))
    return shiftplan.segment_interleave_plans(n, fields)


# ---------------------------------------------------------------------------
# B5: the merge copy through the host plan's list
# ---------------------------------------------------------------------------

def reference_scatter_map(lead, n, stride, offset, vl):
    """The reference's ``_scatter_plan_kernel`` (interpret mode, through
    its ``scatter_strided``) on a window numbered ``1 + i`` and values
    numbered after it: which input each output lane holds (jitted: the
    same bits, a fraction of the time)."""
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
                                   offset=offset, compiled=True))
    return np.asarray(fn(jnp.asarray(win), jnp.asarray(vals)))


def list_of_map(ref_map, n, vl):
    """The (lane, values lane) pairs of row 0 of a reference map: the lanes
    that hold a values number, in lane order."""
    size = ref_map.size
    row = ref_map.reshape(-1, n)[0].astype(np.int64)
    lanes = np.nonzero(row > size)[0]
    return np.stack([lanes, (row[lanes] - size - 1) % vl], axis=1)


def take(sources, x):
    """``x``'s elements (flattened) at the reference's element numbers."""
    idx = torch.from_numpy(np.asarray(sources, np.int64))
    flat = torch.cat([torch.zeros(1, dtype=x.dtype), x.reshape(-1)])
    return flat[idx.reshape(-1)].reshape(idx.shape)


def check_list(lead, n, stride, offset, vl, ref_map=None):
    """One scatter geometry: B5's host list against B9's, its twin against
    the plain version (and the reference's map)."""
    pairs = strided.scatter_pairs(
        shiftplan.scatter_plan(n, stride, offset, vl), vl)
    assert pairs.dtype == torch.int32 and pairs.shape == (vl, 2)
    b9 = _common.merge_pairs(_common.dyn_sources_plain(
        *scg.scatter_counts(n, stride, offset, vl), gsn=False))
    np.testing.assert_array_equal(pairs.numpy(), b9.numpy())
    np.testing.assert_array_equal(pairs[:, 0].numpy(),
                                  offset + stride * np.arange(vl))
    np.testing.assert_array_equal(pairs[:, 1].numpy(), np.arange(vl))
    if ref_map is not None:
        np.testing.assert_array_equal(pairs.numpy(),
                                      list_of_map(ref_map, n, vl))
    for d, dtype in enumerate(DTYPES):
        win, vals = rand(30 + d, lead + (n,), dtype), rand(
            40 + d, lead + (vl,), dtype)
        plain = strided.scatter_strided_plain(win, vals, stride, offset)
        assert_bits_equal(_common.merge_copy_plain(win, vals, pairs), plain)
        if ref_map is not None:
            both = torch.cat([win.reshape(-1), vals.reshape(-1)])
            assert_bits_equal(plain, take(ref_map, both))


@pytest.mark.parametrize("lead,n", SCATTER_GRID)
def test_b5_list_vs_reference_grid(lead, n):
    """B5's list on the scatter grid: the reference routes each (stride,
    offset) once at the largest vl; half and one value are held against
    B9's list and the plain version."""
    for stride, offset in SCATTER_SO:
        vl = vl_of(n, stride, offset)
        check_list(lead, n, stride, offset, vl,
                   reference_scatter_map(lead, n, stride, offset, vl))
        for fewer in {max(1, vl // 2), 1}:
            check_list(lead, n, stride, offset, fewer)


@pytest.mark.parametrize("lead,n,stride,offset", WIDE_SCATTERS)
def test_b5_list_wide_windows(lead, n, stride, offset):
    """n = 4096 at (64, 0) and n = 2048 at (32, 7): 64 pairs for a window
    of thousands of lanes."""
    vl = vl_of(n, stride, offset)
    check_list(lead, n, stride, offset, vl,
               reference_scatter_map(lead, n, stride, offset, vl))


def test_b5_list_refuses_padding_sources():
    """A plan lane that would take the values' zero padding (a source >=
    vl) is refused at composition: the merge copy reads only the vl
    values.  An empty plan gives an empty list."""
    plan = shiftplan.scatter_plan(16, 2, 1, 8)
    fake = type("Plan", (), {"source": plan.source.copy(),
                             "valid": plan.valid.copy()})()
    fake.source[np.nonzero(plan.valid)[0][3]] = 8
    with pytest.raises(ValueError):
        strided.scatter_pairs(fake, 8)
    empty = type("Plan", (), {"source": np.full(8, -1),
                              "valid": np.zeros(8, bool)})()
    assert strided.scatter_pairs(empty, 4).shape == (0, 2)


# ---------------------------------------------------------------------------
# B2: the interleave copy through the host plan's table
# ---------------------------------------------------------------------------

def reference_int_table(n, fields, mode):
    """The reference's own table: fields numbered ``1 + f*m + j`` (8
    rows) routed by its ``_int_plan_kernel`` (interpret mode) under the
    reference's plans for ``mode``, row 0 minus one; ``(n,)``."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from repro.core import shiftplan as jplan
    from repro.kernels import _common as jcommon
    from repro.kernels import segment as jseg
    m = n // fields
    mode, plans = (("fused", (jplan.interleave_plan(n, fields),))
                   if mode == "fused" else
                   jplan.segment_interleave_plans(n, fields))
    masks, spans = jseg._stack_masks(plans)
    S, W = masks.shape
    valid = np.stack([p.valid for p in plans]).astype(np.int32) \
        if mode == "per_field" else np.zeros((1, n), np.int32)
    ids = [jnp.broadcast_to(jnp.arange(1 + f * m, 1 + (f + 1) * m,
                                       dtype=jnp.int32), (8, m))
           for f in range(fields)]
    out = jcommon.call(
        functools.partial(jseg._int_plan_kernel, mode=mode, plans=plans,
                          spans=spans, fields=fields),
        out_shape=jax.ShapeDtypeStruct((8, n), jnp.int32),
        grid=(1,),
        in_specs=[pl.BlockSpec((S, W), lambda i: (0, 0)),
                  pl.BlockSpec(valid.shape, lambda i: (0, 0))]
        + [pl.BlockSpec((8, m), lambda i: (0, 0)) for _ in range(fields)],
        out_specs=pl.BlockSpec((8, n), lambda i: (0, 0)),
    )(jnp.asarray(masks), jnp.asarray(valid), *ids)
    return np.asarray(out)[0] - 1


def reference_interleave_map(n, fields):
    """The reference's public ``interleave`` (its cost model's plans) on
    the same numbered fields, row 0 minus one (jitted)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import segment as jseg
    m = n // fields
    ids = [jnp.broadcast_to(jnp.arange(1 + f * m, 1 + (f + 1) * m,
                                       dtype=jnp.int32), (8, m))
           for f in range(fields)]
    return np.asarray(jax.jit(jseg.interleave)(ids))[0] - 1


def apply_int_table(soa, table):
    """``take(cat(fields), table)``: output lane c takes lane ``table[c]``
    of the concatenated fields, 0 where it is -1 (what the interleave copy
    computes)."""
    x = torch.cat(list(soa), dim=-1)
    idx = torch.from_numpy(np.asarray(table, np.int64))
    got = x[..., idx.clamp(min=0)]
    return torch.where(idx >= 0, got, torch.zeros((), dtype=x.dtype))


@pytest.mark.parametrize("width", SEGMENT_WIDTHS)
@pytest.mark.parametrize("fields", SEGMENT_FIELDS)
def test_b2_table_vs_reference(fields, width):
    """B2's host table, in both plan modes: ``f*m + j`` at lane ``f +
    j*fields``, equal to the reference's own table and to its
    ``interleave``'s map, and applied to the data equal to
    ``interleave_plain`` for every element width."""
    m = width // fields
    n = fields * m
    want = np.empty(n, np.int64)
    for f in range(fields):
        want[f + fields * np.arange(m)] = f * m + np.arange(m)
    np.testing.assert_array_equal(reference_interleave_map(n, fields), want)
    for mode in ("picked", "fused"):
        plans = interleave_plans(n, fields, mode)
        table = segment.interleave_table(*plans, n, fields)
        assert table.dtype == np.int32 and table.shape == (n,)
        np.testing.assert_array_equal(table, want, err_msg=mode)
        np.testing.assert_array_equal(
            table, reference_int_table(n, fields, mode), err_msg=mode)
        for d, dtype in enumerate(DTYPES):
            soa = [rand(50 + d * fields + f, (3, m), dtype)
                   for f in range(fields)]
            assert_bits_equal(apply_int_table(soa, table),
                              segment.interleave_plain(soa, plans=plans))


def test_b2_table_marks_unfilled_lanes():
    """A lane no plan fills, or one filled from a plan's zero padding,
    becomes -1 (the copy writes 0); per field, a later field wins; every
    interleave plan has none."""
    n, fields = 12, 3
    mode, plans = interleave_plans(n, fields, "fused")
    plan = plans[0]
    assert plan.n == 16                      # padded to a power of two
    assert (segment.interleave_table(mode, plans, n, fields) >= 0).all()
    fake = type("Plan", (), {"source": plan.source.copy(),
                             "valid": plan.valid.copy()})()
    fake.source[1] = 13                      # a padding lane
    fake.valid[5] = False
    table = segment.interleave_table("fused", (fake,), n, fields)
    assert table[1] == -1 and table[5] == -1
    assert (np.delete(table, [1, 5]) >= 0).all()

    mode, per = interleave_plans(n, fields, "per_field")
    assert mode == "per_field"
    fakes = [type("Plan", (), {"source": p.source.copy(),
                               "valid": p.valid.copy()})() for p in per]
    fakes[0].valid[3] = False                # nobody fills lane 3
    fakes[2].valid[0] = True                 # field 2 also claims lane 0
    fakes[2].source[0] = 1                   # ... with its lane 1
    fakes[1].source[4] = 7                   # field 1's zero padding
    table = segment.interleave_table("per_field", fakes, n, fields)
    m = n // fields
    assert table[3] == -1 and table[4] == -1
    assert table[0] == 2 * m + 1             # the later field wins
    x = [rand(60 + f, (2, m), torch.float32) for f in range(fields)]
    acc = apply_int_table(x, table)
    assert (acc[:, 3] == 0).all() and (acc[:, 4] == 0).all()


def test_interleave_tile_rows_fit():
    """The interleave copy's tile height keeps a block within COPY_SMEM
    (the uint16 table, two staged tiles of skewed field tiles, the output
    tile), with two rows at n = 6144 in bf16 (one row of 8-byte lanes
    there, within the card's limit); spreads a small call over the
    blocks, and raises where one row does not fit the card."""
    R, blocks = 1 << 15, 264
    for n, fields, elem, least in ((6144, 2, 2, 2), (6144, 8, 2, 2),
                                   (6144, 3, 1, 4), (6144, 2, 4, 1),
                                   (6144, 2, 8, 1), (256, 2, 2, 60),
                                   (96, 3, 8, 30)):
        rows = _common.interleave_tile_rows(R, n, fields, elem, blocks)
        assert rows >= least, (n, fields, elem, rows)
        smem = _common.interleave_smem(n, fields, rows, elem)
        # one row of 8-byte lanes at n = 6144 needs more than the budget,
        # and still fits the card
        assert smem <= _common.COPY_SMEM or (
            rows == 1 and smem <= _common.SMEM_LIMIT)
        assert _common.interleave_smem(n, fields, rows + 1, elem) > \
            _common.COPY_SMEM or rows == -(-R // blocks)
    # the skew puts consecutive fields' spans of a warp in distinct banks
    assert _common.interleave_skew(2, 2) == 32
    assert _common.interleave_skew(2, 4) == 64
    assert _common.interleave_skew(8, 2) == 16
    # the main shapes: a prefill re-pack (128 rows) spreads one row a
    # block; the decode-sized stack fills the budget
    assert _common.interleave_tile_rows(128, 256, 2, 2, 264) == 1
    assert _common.interleave_tile_rows(458752, 256, 2, 2, 264) == 63
    with pytest.raises(ValueError):
        _common.interleave_tile_rows(1, 1 << 15, 2, 8, 264)


# ---------------------------------------------------------------------------
# On the card: B5 and B2 against their plain versions
# ---------------------------------------------------------------------------

CARD_SO = [(1, 0), (2, 0), (2, 1), (3, 1), (4, 2), (7, 5), (16, 3), (64, 0)]


def assert_same_bits(got, want):
    """Bit for bit, compared on the card (integer views); the host
    comparison, with its report, runs only when they differ."""
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
def test_b5_matches_plain_and_b9_on_card(cuda_device, dtype, rows):
    """B5 at n = 96, 256, 2048 and 4096 over CARD_SO, the largest vl and an
    odd one: one launch a call, bit-exact against its plain version and
    against B9."""
    for n in (96, 256, 2048, 4096):
        win = card_rand(n, (rows, n), dtype, cuda_device)
        for stride, offset in CARD_SO:
            top = vl_of(n, stride, offset)
            for vl in sorted({top, max(1, (top // 2) | 1)}):
                vals = card_rand(vl, (rows, vl), dtype, cuda_device)
                before = strided.scatter_strided.launches
                got = strided.scatter_strided(win, vals, stride, offset)
                torch.cuda.synchronize()
                assert strided.scatter_strided.launches == before + 1
                assert_same_bits(got, strided.scatter_strided_plain(
                    win, vals, stride, offset))
                assert_same_bits(got, strided.scatter_strided(
                    win, vals, stride, offset, compiled=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [7, 1001, 20011])
def test_b2_matches_plain_on_card(cuda_device, dtype, rows):
    """B2 at widths 96, 256 and 6144 with fields 2, 3, 4 and 8, both plan
    modes: one launch a call, bit-exact against the plain version."""
    for width in (96, 256, 6144):
        for fields in (2, 3, 4, 8):
            m = width // fields
            n = fields * m
            soa = [card_rand(fields + f, (rows, m), dtype, cuda_device)
                   for f in range(fields)]
            for mode in ("picked", "fused"):
                plans = interleave_plans(n, fields, mode)
                before = segment.interleave.launches
                got = segment.interleave(soa, plans=plans)
                torch.cuda.synchronize()
                assert segment.interleave.launches == before + 1
                assert_same_bits(got, segment.interleave_plain(
                    soa, plans=plans))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_b2_inverts_b1_on_card(cuda_device, dtype):
    """``interleave(deinterleave(x, f)) == x`` for fields 2, 3, 4 and 8,
    up to the decode KV stack's beat (28*4*64 rows of 256 lanes)."""
    for shape in ((28, 4, 64, 8, 256), (1001, 96), (7, 6144)):
        x = card_rand(shape[-1], shape, dtype, cuda_device)
        for fields in (2, 3, 4, 8):
            if shape[-1] % fields:
                continue
            got = segment.interleave(segment.deinterleave(x, fields))
            torch.cuda.synchronize()
            assert_same_bits(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_b2_b5_odd_widths_and_offset_views_on_card(cuda_device, dtype):
    """Views whose data_ptr is one element past a 16-byte boundary (the
    copy unit falls to the element) and odd widths (a 2- or 1-byte unit),
    for B2's fields in both plan modes and for B5's window and values."""
    for rows, m, fields in ((517, 128, 2), (517, 64, 4), (1003, 33, 3),
                            (1003, 11, 9)):
        # every field one element past a 16-byte boundary
        base = card_rand(fields * m, (1 + fields * rows * m,), dtype,
                         cuda_device)
        soa = [base[1 + f * rows * m:1 + (f + 1) * rows * m].view(rows, m)
               for f in range(fields)]
        assert soa[0].data_ptr() % 16 != 0
        for mode in ("picked", "fused"):
            plans = interleave_plans(m * fields, fields, mode)
            got = segment.interleave(soa, plans=plans)
            torch.cuda.synchronize()
            assert_same_bits(got, segment.interleave_plain(soa, plans=plans))
    flat = card_rand(1, (1 + 517 * 256,), dtype, cuda_device)
    view = flat[1:].view(517, 256)
    odd = card_rand(2, (1003, 99), dtype, cuda_device)
    vflat = card_rand(3, (1 + 517 * 128,), dtype, cuda_device)
    vview = vflat[1:].view(517, 128)
    for win, stride, offset, vals in (
            (view, 2, 1, vview), (view, 2, 0, vview[:, :128].contiguous()),
            (odd, 7, 5, card_rand(4, (1003, 14), dtype, cuda_device)),
            (odd, 3, 1, card_rand(5, (1003, 33), dtype, cuda_device))):
        got = strided.scatter_strided(win, vals, stride, offset)
        torch.cuda.synchronize()
        assert_same_bits(got, strided.scatter_strided_plain(
            win, vals, stride, offset))


@pytest.mark.cuda
def test_b2_b5_operands_on_card(cuda_device):
    """On the card B5's operands hold the host list in B9's format and B2's
    launch entry the host table, and neither holds the plan layer loop's
    packed operands."""
    for n, stride, offset in ((256, 2, 1), (4096, 64, 0), (96, 7, 5)):
        vl = vl_of(n, stride, offset)
        ops = strided._operands("scatter", n, ((stride, offset),), vl,
                                cuda_device)
        pairs = strided.scatter_pairs(ops["plans"][0], vl)
        assert ops["kmax"] == vl
        np.testing.assert_array_equal(
            ops["list"].cpu().numpy(),
            np.concatenate([[vl], pairs.reshape(-1).numpy()]))
        assert not {"masks_bits", "valid_bits", "layers"} & set(ops)
    for fields, n in ((2, 256), (3, 96), (8, 6144)):
        for mode in ("picked", "fused"):
            plans = interleave_plans(n, fields, mode)
            ent = segment._interleave_launch(n, fields, plans, cuda_device)
            np.testing.assert_array_equal(
                ent["table"].cpu().numpy(),
                segment.interleave_table(*plans, n, fields))
            iops = segment._operands("int", *plans, n, fields, cuda_device)
            assert not {"masks_bits", "layers", "plan_lo"} & set(iops)


@pytest.mark.cuda
def test_b2_b5_right_behind_their_producer_on_card(cuda_device):
    """B2 and B5 have no derive kernel before their copies, so they run
    without Programmatic Dependent Launch: a kernel that writes their input
    just before them on the same stream, with no synchronization between
    them, must be complete before the copy reads.  128 rounds of
    ``torch.add(a, k, out=x)`` then B5 (window ``x``) and B2 (fields ``x``
    and ``y``), each result held against the plain version on the same
    inputs."""
    R, n = 1 << 17, 256                               # 64 MiB of bf16
    a = card_rand(7, (R, n), torch.bfloat16, cuda_device)
    vals = card_rand(8, (R, n // 2), torch.bfloat16, cuda_device)
    x = torch.empty_like(a)
    for k in range(128):
        x.zero_()
        torch.cuda.synchronize()
        torch.add(a, float(k % 7 + 1), out=x)
        got5 = strided.scatter_strided(x, vals, 2, 1)
        got2 = segment.interleave([x, a])
        want5 = strided.scatter_strided_plain(x, vals, 2, 1)
        want2 = segment.interleave_plain([x, a])
        torch.cuda.synchronize()
        assert_same_bits(got5, want5)
        assert_same_bits(got2, want2)


def noncontiguous(kind, seed, shape, dtype, device):
    """A non-contiguous view of ``shape``: the transpose of a
    ``(..., shape[-1], shape[-2])`` tensor, or the first ``shape[-1]``
    lanes of a tensor 24 lanes wider."""
    if kind == "transposed":
        base = card_rand(seed, shape[:-2] + (shape[-1], shape[-2]), dtype,
                         device)
        view = base.transpose(-1, -2)
    else:
        base = card_rand(seed, shape[:-1] + (shape[-1] + 24,), dtype, device)
        view = base[..., :shape[-1]]
    assert view.shape == shape and not view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["transposed", "sliced"])
def test_every_wrapper_takes_views_on_card(cuda_device, kind):
    """Every kernel wrapper (B1-B14) and the ``vx`` Strided and Segment
    verbs take a non-contiguous CUDA operand, as the reference does: each
    result equals the plain version (or the ``ref`` policy) on a
    ``.contiguous()`` copy, bit for bit."""
    from repro_torch import vx
    from repro_torch.core import shiftnet
    from repro_torch.kernels import moe_compact, shift_gather, shift_scatter
    dev, dt = cuda_device, torch.bfloat16
    R, n = 300, 256
    x = noncontiguous(kind, 1, (R, n), dt, dev)
    xc = x.contiguous()
    half = [noncontiguous(kind, 2 + f, (R, n // 2), dt, dev)
            for f in range(2)]
    halfc = [h.contiguous() for h in half]
    vals = noncontiguous(kind, 4, (R, n // 2), dt, dev)
    valsc = vals.contiguous()
    wins = noncontiguous(kind, 5, (2, R, n), dt, dev)
    vl = n // 2
    checks = [
        ("B1", segment.deinterleave(x, 2), segment.deinterleave_plain(xc, 2)),
        ("B6", segment.deinterleave(x, 2, fused=False),
         segment.deinterleave_dynamic_plain(xc, 2)),
        ("B2", segment.interleave(half), segment.interleave_plain(halfc)),
        ("B7", segment.interleave(half, fused=False),
         segment.interleave_dynamic_plain(halfc)),
        ("B3", strided.gather_strided(x, 2, 1, vl),
         strided.gather_strided_plain(xc, 2, 1, vl)),
        ("B8", strided.gather_strided(x, 2, 1, vl, compiled=False),
         strided.gather_strided_dynamic_plain(xc, 2, 1, vl)),
        ("B4", strided.gather_strided_fused(wins, ((2, 0), (2, 1)), vl),
         strided.gather_strided_fused_plain(wins.contiguous(),
                                            ((2, 0), (2, 1)), vl)),
        ("B5", strided.scatter_strided(x, vals, 2, 1),
         strided.scatter_strided_plain(xc, valsc, 2, 1)),
        ("B9", strided.scatter_strided(x, vals, 2, 1, compiled=False),
         strided.scatter_strided_dynamic_plain(xc, valsc, 2, 1)),
    ]
    gs, gv = scg.gather_counts(n, 2, 1, vl)
    ss, sv = scg.scatter_counts(n, 2, 1, vl)
    gplan = shift_gather.host_plan(gs.numpy(), gv.numpy(), gather=True)
    splan = shift_gather.host_plan(ss.numpy(), sv.numpy(), gather=False)
    checks += [
        ("B11", shift_gather.shift_gather_static(x, gplan),
         shift_gather.shift_gather_static_plain(xc, gplan)),
        ("B12", shift_gather.shift_gather(x, gs.to(dev), gv.to(dev)),
         shift_gather.shift_gather_plain(xc, gs.to(dev), gv.to(dev))),
    ]
    for name, got, want in (
            ("B13", shift_scatter.shift_scatter_static(x, splan),
             shift_scatter.shift_scatter_static_plain(xc, splan)),
            ("B14", shift_scatter.shift_scatter(x, ss.to(dev), sv.to(dev)),
             shift_scatter.shift_scatter_plain(xc, ss.to(dev),
                                               sv.to(dev)))):
        checks += [(name, got[0], want[0]), (name + " occupancy", got[1],
                                             want[1])]
    # B10: 96 routed rows of 64 lanes, compacted under a seeded mask
    rows = noncontiguous(kind, 6, (96, 64), dt, dev)
    mask = torch.from_numpy(np.random.default_rng(0).random(96) < 0.4)
    shift, valid = scg.compaction_counts(mask)
    masks, _ = shiftnet.layer_masks(shift, valid, toward_zero=True,
                                    lsb_first=True)
    keep = torch.arange(96) < int(mask.sum())
    checks.append(("B10", moe_compact.route_rows(
        rows, masks.to(dev), keep.to(dev), toward_zero=True, lsb_first=True),
        moe_compact.route_rows_plain(
            rows.contiguous(), masks.to(dev), keep.to(dev),
            toward_zero=True, lsb_first=True)))
    spec = vx.Strided(n=n, stride=2, offset=1, vl=vl)
    seg = vx.Segment(n=n, fields=2)
    checks += [
        ("vx.gather", vx.gather(spec, x, policy="kernel"),
         vx.gather(spec, xc, policy="ref")),
        ("vx.scatter", vx.scatter(spec, x, vals, policy="kernel"),
         vx.scatter(spec, xc, valsc, policy="ref")),
        ("vx.transpose int", vx.transpose(seg, half, policy="kernel"),
         vx.transpose(seg, halfc, policy="ref")),
    ]
    for f, (got, want) in enumerate(zip(
            vx.transpose(seg, x, policy="kernel"),
            vx.transpose(seg, xc, policy="ref"))):
        checks.append((f"vx.transpose deint {f}", got, want))
    torch.cuda.synchronize()
    for name, got, want in checks:
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert_same_bits(g, w)
