"""Port parity for the two dynamic kernels that became one derivation per
launch plus a table-driven copy: B7 (``segment.interleave(fused=False)``)
and B14 (``shift_scatter.shift_scatter`` with tensor counts).

B7's derive kernel writes field f's SSN source table on
``scg.scatter_counts(n, fields, f, m)`` for every output lane, and B2's
interleave copy merges the fields' tables as it loads them, a later field
winning (``segment.interleave_dynamic_table`` is the merged table's twin).
B14's derive kernel writes the SSN's ``(n,)`` source table on the ``shift``
/ ``valid`` operands (twin: ``_common.dyn_sources_plain(shift, valid,
gsn=False)``) and from it the staged copy's operands, the input units that
hold a source lane and the table remapped into the row compacted to them
(twin: ``_indexed.staged_units_plain``); one staged copy reads only those
units, moves the rows through the remapped table and writes the occupancy
(entry >= 0) in the same pass.  Here, on the CPU, with no tolerance:

* B7's merged table, for fields 2, 3, 4 and 8 at widths 96 and 256, equals
  the reference's ``interleave(fused=False)`` of numbered fields, minus
  one, and B2's host table (``segment.interleave_table``) in both plan
  modes;
* B14's table, on numpy-seeded random operand counts (uniform, short and
  negative or out-of-range shifts) at the widths of the indexed grid (96,
  256, 100, 4095 and 1), equals the reference's ``shift_scatter`` of a
  numbered payload (interpret mode): payload = source + 1, occupancy =
  source >= 0;
* each table applied to rows equals ``interleave_dynamic_plain`` /
  ``shift_scatter_plain`` bit for bit in float32, bfloat16 (with -0.0 and
  quiet-NaN lanes) and int32, and so does B14's staged form (rows
  compacted to the listed units, read through the remapped table) for 1-,
  2-, 4- and 8-byte lanes, with only the values' half of each row listed
  on the KV stack's (2,1) scatter;
* the host path's helpers: B7's launch entry is one per ``(n, fields,
  device)`` and keeps its tile heights per (rows, element size); the
  staged copy's tile holds B14's occupancy tile within its budget.

The ``cuda`` cases hold B7 and B14 against their plain versions and their
plan twins (B2, B13) on the card at odd row counts, odd widths and offset
views (B7 up to 6144 lanes, B14 up to 4095), the device tables and B14's
unit lists against their twins, and run both right behind a kernel that
writes their input
on the same stream (the copy stages its first tile before it waits on the
derive kernel); they skip without a card:
``python -m pytest -m cuda tests/test_torch_dyn_copies.py``.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch.core import scg, shiftplan
from repro_torch.kernels import (_common, _indexed, segment, shift_gather,
                                 shift_scatter)

DTYPES = ["float32", "bfloat16", "int32"]
B7_FIELDS = [2, 3, 4, 8]
B7_WIDTHS = [96, 256]
B14_WIDTHS = [96, 256, 100, 4095, 1]
COUNT_KINDS = ["uniform", "short", "wild"]


def rand(seed, shape, dtype):
    """numpy-seeded input; bfloat16 through float32, with -0.0 and quiet-NaN
    lanes so raw bits are what must move."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-100, 100, shape)
                                .astype(np.int32))
    a = rng.normal(size=shape).astype(np.float32)
    a.reshape(-1)[::7] = -0.0
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    quiet_nan = {"float32": 0x7FC00000, "bfloat16": 0x7FC0}[dtype]
    ints = t.view(torch.int32 if dtype == "float32" else torch.int16)
    ints.view(-1)[3::11] = quiet_nan
    return t


def random_counts(n, kind, seed):
    """numpy-seeded ``(shift, valid)`` int32 operands over n lanes:
    ``uniform`` shifts in [0, n) on about half the lanes, ``short`` shifts
    in [0, 8) on most lanes, ``wild`` shifts in [-n, 2n) (negative and
    out-of-range counts: the network reads their two's-complement bits)."""
    rng = np.random.default_rng(seed)
    lo, hi, density = {"uniform": (0, max(n, 1), 0.5),
                       "short": (0, 8, 0.8),
                       "wild": (-n, 2 * n + 1, 0.6)}[kind]
    shift = rng.integers(lo, hi, n).astype(np.int32)
    valid = (rng.random(n) < density).astype(np.int32)
    return torch.from_numpy(shift), torch.from_numpy(valid)


def numbered_fields(fields, m, rows=8):
    """Fields numbered ``1 + f*m + j`` (int32, ``rows`` rows each)."""
    return [np.broadcast_to(np.arange(1 + f * m, 1 + (f + 1) * m,
                                      dtype=np.int32), (rows, m))
            for f in range(fields)]


def apply_int_table(soa, table):
    """Output lane c takes lane ``table[c]`` of the concatenated fields, 0
    where it is -1 (what the interleave copy computes)."""
    x = torch.cat(list(soa), dim=-1)
    idx = torch.from_numpy(np.asarray(table, np.int64))
    got = x[..., idx.clamp(min=0)]
    return torch.where(idx >= 0, got, torch.zeros((), dtype=x.dtype))


def apply_sources(x, src):
    """Lane j takes ``x[..., src[j]]``, 0 where ``src[j]`` is -1 (what the
    permuted copy computes)."""
    src = src.to(torch.int64)
    got = x[..., src.clamp(min=0)]
    return torch.where(src >= 0, got, torch.zeros((), dtype=x.dtype))


def interleave_plans(n, fields, mode):
    """The cost model's pick (``picked``) or the fused Benes plan."""
    if mode == "fused":
        return "fused", (shiftplan.interleave_plan(n, fields),)
    return shiftplan.segment_interleave_plans(n, fields)


# ---------------------------------------------------------------------------
# B7: the merged table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", B7_WIDTHS)
@pytest.mark.parametrize("fields", B7_FIELDS)
def test_b7_merged_table_vs_reference(fields, width):
    """The merged twin, built from each field's SSN table with the last
    field winning, equals the reference's dynamic interleave of numbered
    fields minus one, and B2's host table in both plan modes."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import segment as jseg
    m = width // fields
    n = fields * m
    table = segment.interleave_dynamic_table(n, fields)
    assert table.dtype == np.int32 and table.shape == (n,)
    want = np.asarray(jax.jit(lambda xs: jseg.interleave(xs, fused=False))(
        [jnp.asarray(f) for f in numbered_fields(fields, m)]))
    np.testing.assert_array_equal(want, np.broadcast_to(want[0], want.shape))
    np.testing.assert_array_equal(table, want[0] - 1)
    # the same merge, field by field from the twin of the device tables
    manual = np.full(n, -1)
    for f in range(fields):
        src = _common.dyn_sources_plain(
            *scg.scatter_counts(n, fields, f, m), gsn=False).numpy()
        manual[src >= 0] = f * m + src[src >= 0]
    np.testing.assert_array_equal(table, manual)
    for mode in ("picked", "fused"):
        np.testing.assert_array_equal(
            table, segment.interleave_table(*interleave_plans(n, fields, mode),
                                            n, fields), err_msg=mode)


@pytest.mark.parametrize("dtype", DTYPES)
def test_b7_table_applied_equals_plain(dtype):
    """The composition the card runs: the fields' rows taken through the
    merged table equal ``interleave_dynamic_plain``, bit for bit, for
    fields 2/3/4/8 at widths 96 and 256."""
    for width in B7_WIDTHS:
        for fields in B7_FIELDS:
            m = width // fields
            n = fields * m
            soa = [rand(100 + 10 * fields + f, (3, 5, m), dtype)
                   for f in range(fields)]
            assert_bits_equal(
                apply_int_table(soa, segment.interleave_dynamic_table(
                    n, fields)),
                segment.interleave_dynamic_plain(soa))


def test_b7_launch_entry_and_tile_rows(monkeypatch):
    """B7's host path: one launch entry per ``(n, fields, device)`` (the
    bound entry point, the block count, the tile heights), and the tile
    height sized once per (rows, element size) with the interleave copy's
    own sizing."""
    from repro_torch.vx.cache import PlanCache

    class Lib:
        segment_interleave_dyn = object()

    monkeypatch.setattr(segment, "PLANS", PlanCache())
    monkeypatch.setattr(segment, "_lib", lambda: Lib)
    monkeypatch.setattr(_common, "min_blocks", lambda device: 264)
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    ent = segment._interleave_dyn_launch(256, 2, d0)
    assert ent["fn"] is Lib.segment_interleave_dyn and ent["blocks"] == 264
    assert segment._interleave_dyn_launch(256, 2, d0) is ent
    assert segment._interleave_dyn_launch(256, 2,
                                          torch.device("cuda:0")) is ent
    others = [segment._interleave_dyn_launch(*key)
              for key in ((256, 4, d0), (96, 2, d0), (256, 2, d1))]
    assert all(o is not ent for o in others)
    assert len({id(o) for o in others}) == 3
    # tile heights: the decode-sized stack fills the budget, a prefill
    # re-pack spreads one row a block; each kept per (rows, element size)
    assert segment._tile_rows(ent, 458752, 256, 2, 2) == 63
    assert segment._tile_rows(ent, 128, 256, 2, 2) == 1
    assert segment._tile_rows(ent, 128, 256, 2, 4) == 1
    assert ent["rows"] == {(458752, 2): 63, (128, 2): 1, (128, 4): 1}
    for (R, elem), rows in ent["rows"].items():
        assert rows == _common.interleave_tile_rows(R, 256, 2, elem, 264)
    ent["rows"][7, 2] = 5                       # a kept height is reused
    assert segment._tile_rows(ent, 7, 256, 2, 2) == 5


# ---------------------------------------------------------------------------
# B14: the source table on the operand counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", B14_WIDTHS)
def test_b14_table_vs_reference(n):
    """The SSN twin on random operand counts equals the reference's
    ``shift_scatter`` of a numbered payload (its dynamic body, interpret
    mode): payload = source + 1 (0 where the source is -1), occupancy =
    source >= 0, for every kind of counts."""
    import jax.numpy as jnp
    from repro.kernels import shift_scatter as jss
    ids = np.broadcast_to(np.arange(1, n + 1, dtype=np.int32), (2, n))
    for k, kind in enumerate(COUNT_KINDS):
        shift, valid = random_counts(n, kind, 10 * n + k)
        src = _common.dyn_sources_plain(shift, valid, gsn=False)
        assert src.dtype == torch.int32 and src.shape == (n,)
        jp, jo = jss.shift_scatter(jnp.asarray(ids), jnp.asarray(
            shift.numpy()), jnp.asarray(valid.numpy()))
        jp, jo = np.asarray(jp), np.asarray(jo)
        np.testing.assert_array_equal(jp, np.broadcast_to(src.numpy() + 1,
                                                          (2, n)),
                                      err_msg=kind)
        np.testing.assert_array_equal(jo, np.broadcast_to(src.numpy() >= 0,
                                                          (2, n)),
                                      err_msg=kind)


@pytest.mark.parametrize("dtype", DTYPES)
def test_b14_table_applied_equals_plain(dtype):
    """The composition the card runs: rows taken through the twin's table
    equal ``shift_scatter_plain``'s payload bit for bit, and ``table >= 0``
    for every row its occupancy, at every width of the grid and every kind
    of counts."""
    for n in B14_WIDTHS:
        x = rand(200 + n, (3, 4, n), dtype)
        for k, kind in enumerate(COUNT_KINDS):
            shift, valid = random_counts(n, kind, 20 * n + k)
            src = _common.dyn_sources_plain(shift, valid, gsn=False)
            payload, occ = shift_scatter.shift_scatter_plain(x, shift, valid)
            assert_bits_equal(apply_sources(x, src), payload)
            assert torch.equal(occ, (src >= 0).expand(x.shape))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32, torch.int64])
def test_b14_staged_form_equals_plain(dtype):
    """B14's staged copy on the CPU: each row compacted to the listed
    units (``_common.staged_copy_plain``) and read through the remapped
    table, 0 where it is -1, equals ``shift_scatter_plain``'s payload bit
    for bit, for 16-byte units and for the narrower unit an odd width or an
    offset pointer leaves; on the KV stack's (2,1) scatter (values padded
    to 256 lanes) only the values' half of the row is listed, and a network
    that occupies every sector lists the whole row."""
    elem = torch.empty((), dtype=dtype).element_size()
    if dtype.is_floating_point:
        def make(seed, shape):
            return rand(seed, shape, "float32").to(dtype)
    else:
        def make(seed, shape):
            return torch.from_numpy(np.random.default_rng(seed).integers(
                -100, 100, shape)).to(dtype)
    cases = [(n, random_counts(n, kind, 50 * n + k))
             for n in B14_WIDTHS for k, kind in enumerate(COUNT_KINDS)]
    cases.append((256, scg.scatter_counts(256, 2, 1, 128)))
    for n, (shift, valid) in cases:
        x = make(n, (3, n))
        want, _ = shift_scatter.shift_scatter_plain(x, shift, valid)
        table = _common.dyn_sources_plain(shift, valid, gsn=False)
        for unit in sorted({_common.copy_unit(n * elem, 0),
                            _common.copy_unit(n * elem, elem)}):
            per = unit // elem
            units, pos = _indexed.staged_units_plain(table, n, per, elem)
            assert units.dtype == pos.dtype == np.int32
            np.testing.assert_array_equal(pos < 0, table.numpy() < 0)
            if units.size:
                staged = _common.staged_copy_plain(x, units,
                                                   np.maximum(pos, 0), per)
            else:                         # no occupied lane: no unit staged
                staged = torch.zeros_like(x)
            got = torch.where(torch.from_numpy(pos >= 0), staged,
                              torch.zeros((), dtype=dtype))
            assert_bits_equal(got, want)
    table = _common.dyn_sources_plain(*scg.scatter_counts(256, 2, 1, 128),
                                      gsn=False)
    units, _ = _indexed.staged_units_plain(table, 256, 16 // 2, 2)
    np.testing.assert_array_equal(units, np.arange(16))       # 256 of 512 B
    shift, valid = scg.scatter_counts(256, 1, 0, 256)         # identity
    units, pos = _indexed.staged_units_plain(
        _common.dyn_sources_plain(shift, valid, gsn=False), 256, 8, 2)
    np.testing.assert_array_equal(units, np.arange(32))
    np.testing.assert_array_equal(pos, np.arange(256))
    units, pos = _indexed.staged_units_plain(np.full(8, -1), 8, 8, 2)
    assert units.size == 0 and (pos == -1).all()


def test_copy_tile_rows_with_occupancy():
    """B14's staged copy holds a (rows, n) tile of occupancy bytes beside
    its output tile, and is sized for whole rows (its unit list, up to n
    entries, is known only on the card): the tile stays within COPY_SMEM
    (table, list, two staged tiles, the output tile, the occupancy tile),
    is shorter than without it, spreads a small call, and at n = 4095
    still holds rows of 8-byte lanes."""
    budget, blocks = _common.COPY_SMEM, 264

    def smem(rows, n, elem):
        def pad(b):
            return -(-b // 16) * 16
        return (2 * pad(n * 4) + 3 * pad(rows * n * elem) + pad(rows * n))

    for R, n, elem in ((458752, 256, 2), (20011, 4095, 2), (7, 100, 4),
                       (1001, 4095, 8), (3, 1, 1)):
        rows = _common.copy_tile_rows(R, n, n, 1, elem, blocks, units=n,
                                      occupancy=True)
        assert 1 <= rows <= min(R, -(-R // blocks)), (R, n, elem, rows)
        assert rows <= _common.copy_tile_rows(R, n, n, 1, elem, blocks)
        # within the budget (one row of 8-byte lanes at n = 4095 needs
        # more, and still fits the card), and as tall as it allows
        assert smem(rows, n, elem) <= budget or (
            rows == 1 and smem(1, n, elem) <= _common.SMEM_LIMIT)
        assert rows == -(-R // blocks) or smem(rows + 1, n, elem) > budget
    assert _common.copy_tile_rows(458752, 256, 256, 1, 2, 264, units=256,
                                  occupancy=True) == 53
    assert _common.copy_tile_rows(458752, 256, 256, 1, 2, 264) == 63
    with pytest.raises(ValueError):
        _common.copy_tile_rows(1, 1 << 15, 1 << 15, 1, 4, 264,
                               units=1 << 15, occupancy=True)


# ---------------------------------------------------------------------------
# On the card: B7 and B14 against their plain versions and plan twins
# ---------------------------------------------------------------------------

CARD_DTYPES = [torch.int8, torch.bfloat16, torch.float32, torch.int64]


def assert_same_bits(got, want):
    """Bit for bit, compared on the card (integer views); the host
    comparison, with its report, runs only when they differ."""
    def ints(t):
        return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                    4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    if not (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(ints(got), ints(want))):
        assert_bits_equal(got.cpu(), want.cpu())


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


def offset_view(seed, rows, n, dtype, device):
    """A (rows, n) view whose data_ptr is one element past a 16-byte
    boundary (the copy unit falls to the element size)."""
    flat = card_rand(seed, (1 + rows * n,), dtype, device)
    view = flat[1:].view(rows, n)
    assert view.data_ptr() % 16 != 0 or view.element_size() >= 16
    return view


def check_b7(soa):
    before = segment.interleave_dynamic.launches
    got = segment.interleave(soa, fused=False)
    twin = segment.interleave(soa)
    want = segment.interleave_dynamic_plain(soa)
    torch.cuda.synchronize()
    assert segment.interleave_dynamic.launches == before + 1
    assert_same_bits(got, want)
    assert_same_bits(got, twin)


def check_b14(x, shift, valid):
    before = shift_scatter.shift_scatter.launches
    p, o = shift_scatter.shift_scatter(x, shift, valid)
    hs, hv = shift.cpu().numpy(), valid.cpu().numpy()
    tp, to = shift_scatter.shift_scatter(x, hs, hv)
    wp, wo = shift_scatter.shift_scatter_plain(x, shift, valid)
    torch.cuda.synchronize()
    assert shift_scatter.shift_scatter.launches == before + 1
    assert o.dtype == torch.bool and o.shape == x.shape and o.is_contiguous()
    assert_same_bits(p, wp)
    assert torch.equal(o, wo)
    assert_same_bits(p, tp)
    assert torch.equal(o, to)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
def test_b7_matches_plain_and_b2_on_card(cuda_device, dtype):
    """B7 bit-exact against its plain version and B2 (one launch a call):
    odd row counts that leave every block several tiles, widths up to 6144,
    odd widths (a 2- or 1-byte copy unit) and fields one element past a
    16-byte boundary."""
    dev = cuda_device
    for rows, width, fields in ((20011, 256, 2), (1001, 256, 4),
                                (7, 6144, 2), (7, 6144, 8), (1003, 99, 3),
                                (1003, 99, 9), (5, 96, 3)):
        m = width // fields
        check_b7([card_rand(rows + f, (rows, m), dtype, dev)
                  for f in range(fields)])
        check_b7([offset_view(2 * rows + f, rows, m, dtype, dev)
                  for f in range(fields)])
    # the stack's leading dims ride along
    check_b7([card_rand(9 + f, (28, 4, 16, 8, 128), dtype, dev)
              for f in range(2)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("n", B14_WIDTHS)
def test_b14_matches_plain_and_b13_on_card(cuda_device, dtype, n):
    """B14 bit-exact against its plain version and B13 on the same counts
    (one launch a call), payload and occupancy: random operand counts and
    the indexed grid's scatter counts, 7, 1001 and 20011 rows, and a view
    one element past a 16-byte boundary."""
    dev = cuda_device
    counts = [random_counts(n, kind, 30 * n + k)
              for k, kind in enumerate(COUNT_KINDS)]
    stride = {96: 3, 256: 2, 100: 7, 4095: 64, 1: 1}[n]
    offset = {96: 1, 256: 1, 100: 5, 4095: 0, 1: 0}[n]
    counts.append(scg.scatter_counts(n, stride, offset,
                                     (n - 1 - offset) // stride + 1))
    for rows in (7, 1001, 20011):
        x = card_rand(n + rows, (rows, n), dtype, dev)
        for shift, valid in counts:
            check_b14(x, shift.to(dev), valid.to(dev))
    view = offset_view(n, 517, n, dtype, dev)
    for shift, valid in counts:
        check_b14(view, shift.to(dev), valid.to(dev))


@pytest.mark.cuda
def test_b7_b14_device_tables_match_twins(cuda_device):
    """One derivation per launch: B7's per-field tables
    (``segment.interleave_sources``) equal the SSN twin per field, and the
    merged table the copy composes, read off B7 on numbered int32 fields,
    equals ``interleave_dynamic_table``; B14's table
    (``_indexed.dyn_sources``) equals ``dyn_sources_plain`` on random and
    grid counts, and so do the staged copy's operands it composes (the
    remapped table and the unit list) against ``staged_units_plain`` for
    1-, 2-, 4- and 8-byte lanes at 16-byte and narrower units."""
    dev = cuda_device
    for width in (96, 256, 6144):
        for fields in B7_FIELDS:
            m = width // fields
            n = fields * m
            want = torch.stack([_common.dyn_sources_plain(
                *scg.scatter_counts(n, fields, f, m), gsn=False)
                for f in range(fields)])
            got = segment.interleave_sources(n, fields, device=dev)
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
            ids = [torch.from_numpy(np.ascontiguousarray(f)).to(dev)
                   for f in numbered_fields(fields, m, rows=3)]
            merged = segment.interleave(ids, fused=False).cpu().numpy() - 1
            np.testing.assert_array_equal(
                merged, np.broadcast_to(segment.interleave_dynamic_table(
                    n, fields), merged.shape))
    for n in B14_WIDTHS:
        counts = [random_counts(n, kind, 40 * n + k)
                  for k, kind in enumerate(COUNT_KINDS)]
        counts.append(scg.scatter_counts(n, 1, 0, n))
        counts.append(scg.scatter_counts(n, 2, 1, -(-n // 2)))
        for c, (shift, valid) in enumerate(counts):
            shift = shift.to(torch.int32)
            valid = valid.to(torch.int32)
            want = _common.dyn_sources_plain(shift, valid, gsn=False)
            for elem in (1, 2, 4, 8):
                for unit in sorted({_common.copy_unit(n * elem, 0),
                                    _common.copy_unit(n * elem, elem)}):
                    table, pos, units = _indexed.dyn_sources(
                        shift.to(dev), valid.to(dev), gsn=False, elem=elem,
                        unit=unit)
                    wu, wp = _indexed.staged_units_plain(
                        want.numpy(), n, unit // elem, elem)
                    where = f"n={n} counts {c} elem {elem} unit {unit}"
                    np.testing.assert_array_equal(table.cpu().numpy(),
                                                  want.numpy(), err_msg=where)
                    np.testing.assert_array_equal(pos.cpu().numpy(), wp,
                                                  err_msg=where)
                    units = units.cpu().numpy()
                    assert units.shape == (1 + n * elem // unit,), where
                    np.testing.assert_array_equal(units[1:1 + units[0]], wu,
                                                  err_msg=where)


@pytest.mark.cuda
def test_b7_b14_right_behind_their_producer_on_card(cuda_device):
    """B7's and B14's copies stage their first tile before they wait on
    their derive kernel (Programmatic Dependent Launch); the derive kernel
    itself is stream-ordered after whatever wrote the input.  128 rounds of
    ``torch.add(a, k, out=x)`` then B7 (fields ``x`` and ``a``) and B14
    (payload ``x``) on the same stream with no synchronization between
    them, each result held against the plain version on the same inputs."""
    dev = cuda_device
    R, n = 1 << 17, 256                               # 64 MiB of bf16
    a = card_rand(7, (R, n), torch.bfloat16, dev)
    x = torch.empty_like(a)
    shift, valid = (t.to(dev) for t in random_counts(n, "short", 5))
    for k in range(128):
        x.zero_()
        torch.cuda.synchronize()
        torch.add(a, float(k % 7 + 1), out=x)
        got7 = segment.interleave([x, a], fused=False)
        got14, occ = shift_scatter.shift_scatter(x, shift, valid)
        want7 = segment.interleave_dynamic_plain([x, a])
        want14, want_occ = shift_scatter.shift_scatter_plain(x, shift, valid)
        torch.cuda.synchronize()
        assert_same_bits(got7, want7)
        assert_same_bits(got14, want14)
        assert torch.equal(occ, want_occ)


@pytest.mark.cuda
def test_b12_keeps_its_own_kernel_on_card(cuda_device):
    """B12 runs B14's pair on its own network: the derive kernel on the GSN
    (``gsn=True``: its table is the GSN's twin, not the SSN's B14 derives
    on the same counts) and the staged copy without the occupancy, one
    launch a call; it equals its plain version on the random counts B14
    takes, and B11 where their gather plan has no conflicts (B11 refuses
    the others, as the reference's plan body does)."""
    dev = cuda_device
    for n in B14_WIDTHS:
        x = card_rand(n, (1001, n), torch.bfloat16, dev)
        for k, kind in enumerate(COUNT_KINDS):
            shift, valid = (t.to(dev) for t in random_counts(n, kind, k))
            hs, hv = shift.cpu().numpy(), valid.cpu().numpy()
            before = shift_gather.shift_gather.launches
            got = shift_gather.shift_gather(x, shift, valid)
            torch.cuda.synchronize()
            assert shift_gather.shift_gather.launches == before + 1
            assert_same_bits(got, shift_gather.shift_gather_plain(
                x, shift, valid))
            if shift_gather.host_plan(hs, hv, gather=True).conflict:
                with pytest.raises(AssertionError, match="conflicting plan"):
                    shift_gather.shift_gather(x, hs, hv)
            else:
                assert_same_bits(got, shift_gather.shift_gather(x, hs, hv))
            table = _indexed.dyn_sources(shift, valid, gsn=True, elem=2,
                                         unit=_common.copy_unit(2 * n, 0))[0]
            np.testing.assert_array_equal(
                table.cpu().numpy(), _common.dyn_sources_plain(
                    shift.cpu(), valid.cpu(), gsn=True).numpy())
