"""Port parity for the raw shift kernels that became staged copies through
a source table: B11 (``shift_gather.shift_gather_static``, and
``shift_gather`` with host counts), B12 (``shift_gather.shift_gather``
with tensor counts) and B13 (``shift_scatter.shift_scatter_static``, and
``shift_scatter`` with host counts).

B12's derive kernel writes the GSN's ``(n,)`` source table on the
``shift`` / ``valid`` operands (twin: ``_common.dyn_sources_plain(shift,
valid, gsn=True)``) and from it the staged copy's operands, the input
units that hold a source lane and the table remapped into the row
compacted to them (twin: ``_indexed.staged_units_plain``); one staged copy
reads only those units and moves the rows through the remapped table, 0
where it holds -1.  B11's and B13's networks are static: the table is
``where(plan.valid, plan.source, -1)`` of the counts plan, and the
wrapper composes the same operands on the host (``_indexed.plan_staged``)
and uploads them once per (plan, device, staging unit, element size); for
B13 the staged copy also writes the occupancy (entry >= 0).  Here, on the
CPU, with no tolerance:

* B12's table, on numpy-seeded random operand counts (uniform, short and
  negative or out-of-range shifts), a random mask's compaction counts and
  the indexed grid's gather counts at widths 96, 256, 100, 4095 and 1,
  equals the reference's ``shift_gather``
  of a numbered payload (its dynamic body, interpret mode): payload =
  source + 1, 0 where the source is -1;
* B12's staged form (rows compacted to the listed units, read through the
  remapped table, 0 where it is -1) equals ``shift_gather_plain`` bit for
  bit for 1-, 2-, 4- and 8-byte lanes, at 16-byte units and the narrower
  unit an odd width or an offset pointer leaves, with -0.0 and quiet-NaN
  payloads; on the KV stack's (2,1) gather the list is the whole row;
* B13's host table equals the reference's ``shift_scatter_static`` of a
  numbered payload, payload and occupancy, on a random mask's expansion
  counts and the grid's scatter counts, and its dynamic ``shift_scatter``
  on the random operand counts, whose lanes collide (a plan with
  conflicts, which the plan bodies refuse and B13's kernel must route as
  B14 does); its staged form, with ``pos >= 0`` as the occupancy, equals
  ``shift_scatter_static_plain`` (B14's plain version where the plan has
  conflicts); on the KV stack's (2,1) scatter the list is the first 16 of
  32 units;
* B13's host operand builder: dtypes, shapes, an empty plan, and one plan
  cache entry per (plan, unit, element size);
* B11's staged form through its host operands equals the reference's
  ``shift_gather_static`` (interpret mode) on conflict-free gather counts
  at widths 4, 96, 100, 256 and 4095 in bfloat16 and float32; its
  operands share B13's cache, one entry per (plan, device, unit, element
  size); an empty plan writes zeros; a plan with conflicts is refused in
  both packages, in the port before the wrapper's device branch.

The ``cuda`` cases hold B11, B12 and B13 against their plain versions and
their twins (B11 == B12 on the same counts, B14 == B13) on the B11-B14
grid for 1/2/4/8-byte lanes and on views, B12's device tables against
their twins, and run them right behind a kernel that writes their input
on the same stream; they skip without a card:
``python -m pytest -m cuda tests/test_torch_shift_copies.py``.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch.core import scg
from repro_torch.kernels import _common, _indexed, shift_gather, shift_scatter
from repro_torch.vx.cache import PLANS, PlanCache
from test_torch_dyn_copies import (COUNT_KINDS, assert_same_bits, card_rand,
                                   offset_view, rand, random_counts)

WIDTHS = [96, 256, 100, 4095, 1]
# (stride, offset) of the indexed grid's strided counts at each width
GRID = {96: (3, 1), 256: (2, 1), 100: (7, 5), 4095: (64, 0), 1: (1, 0),
        4: (2, 1)}
ELEM_DTYPES = [torch.int8, torch.bfloat16, torch.float32, torch.int64]


def grid_counts(n, *, gather):
    """``scg.gather_counts`` / ``scatter_counts`` of the grid's (stride,
    offset) with the largest vl that fits, as int32 tensors."""
    stride, offset = GRID[n]
    vl = (n - 1 - offset) // stride + 1
    fn = scg.gather_counts if gather else scg.scatter_counts
    return tuple(t.to(torch.int32) for t in fn(n, stride, offset, vl))


def all_counts(n, seed, *, gather):
    """Every kind of random operand counts (their scatters collide), the
    compaction (gather) or expansion (scatter) counts of a random mask,
    then the grid's counts."""
    mask = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.4)
    fn = scg.compaction_counts if gather else scg.expansion_counts
    return ([random_counts(n, kind, seed + k)
             for k, kind in enumerate(COUNT_KINDS)]
            + [tuple(t.to(torch.int32) for t in fn(mask)),
               grid_counts(n, gather=gather)])


def numbered(n, rows=2):
    return np.broadcast_to(np.arange(1, n + 1, dtype=np.int32), (rows, n))


def make_rows(seed, shape, dtype):
    """Rows of ``dtype``; floats with -0.0 and quiet-NaN lanes."""
    if dtype.is_floating_point:
        return rand(seed, shape, "float32").to(dtype)
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -100, 100, shape)).to(dtype)


def units_for(n, elem):
    """The 16-byte unit (or the widest the row allows) and the unit an
    element-aligned offset pointer leaves."""
    return sorted({_common.copy_unit(n * elem, 0),
                   _common.copy_unit(n * elem, elem)})


def staged_apply(x, table, unit, elem):
    """The staged copy the card runs, as torch ops: the operands composed
    from ``table`` (``staged_units_plain``), the rows compacted to the
    listed units and read through the remapped table, 0 where it is -1."""
    n = x.shape[-1]
    units, pos = _indexed.staged_units_plain(table, n, unit // elem, elem)
    assert units.dtype == pos.dtype == np.int32
    np.testing.assert_array_equal(pos < 0, np.asarray(table) < 0)
    if not units.size:                     # no occupied lane: none staged
        return torch.zeros_like(x), pos
    staged = _common.staged_copy_plain(x, units, np.maximum(pos, 0),
                                       unit // elem)
    return torch.where(torch.from_numpy(pos >= 0), staged,
                       torch.zeros((), dtype=x.dtype)), pos


def host_plan(shift, valid):
    return shift_gather.host_plan(np.asarray(shift), np.asarray(valid),
                                  gather=False)


# ---------------------------------------------------------------------------
# B12: the GSN's source table on the operand counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", WIDTHS)
def test_b12_table_vs_reference(n):
    """The GSN twin on random operand counts and the grid's gather counts
    equals the reference's ``shift_gather`` of a numbered payload (its
    dynamic body, interpret mode): payload = source + 1, 0 where the
    source is -1."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import shift_gather as jsg
    ids = jnp.asarray(numbered(n))
    run = jax.jit(jsg.shift_gather)
    for c, (shift, valid) in enumerate(all_counts(n, 60 * n, gather=True)):
        src = _common.dyn_sources_plain(shift, valid, gsn=True)
        assert src.dtype == torch.int32 and src.shape == (n,)
        got = np.asarray(run(ids, jnp.asarray(shift.numpy()),
                             jnp.asarray(valid.numpy())))
        want = np.where(src.numpy() >= 0, src.numpy() + 1, 0)
        np.testing.assert_array_equal(got, np.broadcast_to(want, (2, n)),
                                      err_msg=f"counts {c}")


@pytest.mark.parametrize("dtype", ELEM_DTYPES)
def test_b12_staged_form_equals_plain(dtype):
    """B12's staged copy on the CPU equals ``shift_gather_plain`` bit for
    bit at every width and kind of counts, for 16-byte units and the
    narrower unit an odd width or an offset pointer leaves; on the KV
    stack's (2,1) gather (odd lanes 1..255) every sector holds a source,
    so the list is the whole row and the table is unchanged."""
    elem = torch.empty((), dtype=dtype).element_size()
    for n in WIDTHS:
        x = make_rows(70 + n, (3, n), dtype)
        for shift, valid in all_counts(n, 80 * n, gather=True):
            want = shift_gather.shift_gather_plain(x, shift, valid)
            table = _common.dyn_sources_plain(shift, valid, gsn=True).numpy()
            for unit in units_for(n, elem):
                got, _ = staged_apply(x, table, unit, elem)
                assert_bits_equal(got, want)
    table = _common.dyn_sources_plain(*scg.gather_counts(256, 2, 1, 128),
                                      gsn=True).numpy()
    np.testing.assert_array_equal(table[:128], np.arange(1, 256, 2))
    assert (table[128:] == -1).all()
    units, pos = _indexed.staged_units_plain(table, 256, 16 // 2, 2)
    np.testing.assert_array_equal(units, np.arange(32))       # all 512 B
    np.testing.assert_array_equal(pos, table)


# ---------------------------------------------------------------------------
# B13: the host plan's table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", WIDTHS)
def test_b13_table_vs_reference(n):
    """``where(plan.valid, plan.source, -1)`` of the scatter counts plan
    equals the reference on a numbered payload, payload (source + 1, 0
    where -1) and occupancy (source >= 0): its ``shift_scatter_static``
    (interpret mode) on the counts that compile to a plan without
    conflicts (a random mask's expansion counts, the grid's), and on the
    random operand counts, whose lanes collide and which the reference's
    plan body refuses, its ``shift_scatter`` on the same counts as arrays
    (the dynamic body, which B14 runs and B13 must equal there: the plan
    tracks each source through the same take-masks).  The table is the
    dynamic network's on every count."""
    import jax
    import jax.numpy as jnp
    from repro.core import shiftplan as jplan
    from repro.kernels import shift_scatter as jss
    ids = jnp.asarray(numbered(n))
    dynamic = jax.jit(jss.shift_scatter)
    conflicts = []
    for c, (shift, valid) in enumerate(all_counts(n, 90 * n, gather=False)):
        hs, hv = shift.numpy(), valid.numpy()
        plan = host_plan(hs, hv)
        table = _indexed.plan_staged(plan, 16, 1)["table"]
        assert table.dtype == np.int32 and table.shape == (n,)
        ref = jplan.counts_plan(tuple(int(s) for s in hs),
                                tuple(bool(v) for v in hv), gather=False)
        assert ref.conflict == plan.conflict
        conflicts.append(plan.conflict)
        if plan.conflict:
            jp, jo = dynamic(ids, jnp.asarray(hs), jnp.asarray(hv))
        else:
            jp, jo = jss.shift_scatter_static(ids, ref)
        np.testing.assert_array_equal(
            np.asarray(jp), np.broadcast_to(np.where(table >= 0, table + 1,
                                                     0), (2, n)),
            err_msg=f"counts {c}")
        np.testing.assert_array_equal(
            np.asarray(jo), np.broadcast_to(table >= 0, (2, n)),
            err_msg=f"counts {c}")
        np.testing.assert_array_equal(
            table, _common.dyn_sources_plain(shift, valid, gsn=False).numpy())
    assert conflicts[-2:] == [False, False]
    assert all(conflicts[:3]) or n == 1


@pytest.mark.parametrize("dtype", ELEM_DTYPES)
def test_b13_staged_form_equals_plain(dtype):
    """B13's staged copy on the CPU, through the operands its wrapper
    composes on the host (``plan_staged``), equals
    ``shift_scatter_static_plain`` bit for bit, payload and occupancy
    (``pos >= 0``), at every width and kind of counts and both units
    (``shift_scatter_plain``, B14's, on counts whose plan has conflicts,
    which the plan's plain version refuses); on
    the KV stack's (2,1) scatter only the values' half of the row is
    listed."""
    elem = torch.empty((), dtype=dtype).element_size()
    for n in WIDTHS:
        x = make_rows(110 + n, (3, n), dtype)
        for shift, valid in all_counts(n, 120 * n, gather=False):
            plan = host_plan(shift.numpy(), valid.numpy())
            if plan.conflict:       # the plan body refuses; B14's is B13's
                wp, wo = shift_scatter.shift_scatter_plain(x, shift, valid)
            else:
                wp, wo = shift_scatter.shift_scatter_static_plain(x, plan)
            for unit in units_for(n, elem):
                ops = _indexed.plan_staged(plan, unit // elem, elem)
                got, pos = staged_apply(x, ops["table"], unit, elem)
                np.testing.assert_array_equal(pos, ops["pos"])
                K = int(ops["nunits"][0])
                np.testing.assert_array_equal(
                    ops["units"][:K], _indexed.staged_units_plain(
                        ops["table"], n, unit // elem, elem)[0])
                assert_bits_equal(got, wp)
                assert torch.equal(torch.from_numpy(pos >= 0).expand(
                    x.shape), wo)
    shift, valid = scg.scatter_counts(256, 2, 1, 128)
    ops = _indexed.plan_staged(host_plan(shift.numpy(),
                                                 valid.numpy()), 8, 2)
    np.testing.assert_array_equal(ops["units"], np.arange(16))  # 256 of 512 B
    assert ops["kmax"] == 16 and ops["nunits"].tolist() == [16]
    np.testing.assert_array_equal(ops["pos"][1:256:2], np.arange(128))
    assert (ops["pos"][0:256:2] == -1).all()


def test_b13_host_operands_and_cache(monkeypatch):
    """The host operand builder: int32 arrays of shapes ``(kmax,)``,
    ``(1,)`` and ``(n,)``, the list padded with 0 past its count, at least
    one entry for a plan that occupies no lane (all -1); and the upload
    through the plan cache, one entry per (plan, unit, element size),
    returned again on a repeat."""
    monkeypatch.setattr(_indexed, "PLANS", PlanCache())
    n = 100
    shift, valid = random_counts(n, "short", 5)
    plan = host_plan(shift.numpy(), valid.numpy())
    for per, elem in ((4, 4), (1, 4), (8, 2), (2, 8)):
        ops = _indexed.plan_staged(plan, per, elem)
        K = int(ops["nunits"][0])
        assert {k: v.dtype for k, v in ops.items() if k != "kmax"} == {
            "table": np.int32, "units": np.int32, "nunits": np.int32,
            "pos": np.int32}
        assert ops["table"].shape == ops["pos"].shape == (n,)
        assert ops["nunits"].shape == (1,)
        assert ops["units"].shape == (ops["kmax"],) and ops["kmax"] == max(K,
                                                                          1)
        assert 0 < K <= n // per
        assert (np.diff(ops["units"][:K]) > 0).all()
    empty = host_plan(np.zeros(8, np.int32), np.zeros(8, np.int32))
    ops = _indexed.plan_staged(empty, 8, 2)
    assert ops["kmax"] == 1 and ops["nunits"].tolist() == [0]
    assert ops["units"].tolist() == [0] and (ops["pos"] == -1).all()
    assert (ops["table"] == -1).all()
    # the upload: one cache entry per (plan, unit, element size)
    cpu = torch.device("cpu")
    a = _indexed.plan_staged_operands(plan, cpu, 4, 4)
    assert _indexed.plan_staged_operands(plan, cpu, 4, 4) is a
    assert a["kmax"] == _indexed.plan_staged(plan, 4, 4)["kmax"]
    assert all(a[k].dtype == torch.int32 for k in ("units", "nunits",
                                                   "pos"))
    others = [_indexed.plan_staged_operands(plan, cpu, per, elem)
              for per, elem in ((1, 4), (8, 2))]
    others.append(_indexed.plan_staged_operands(empty, cpu, 4, 4))
    assert all(o is not a for o in others)
    keys = [k for k in _indexed.PLANS.keys() if k[0] == "indexed.staged"]
    assert len(keys) == 4
    assert PLANS is not _indexed.PLANS


# ---------------------------------------------------------------------------
# B11: the host plan's table, without the occupancy
# ---------------------------------------------------------------------------

B11_WIDTHS = [4, 96, 100, 256, 4095]


def b11_counts(n, seed):
    """Gather counts whose counts plan has no conflicts, as int32 tensors:
    a random mask's compaction, the grid's strided gather, and the identity
    (every lane stays)."""
    mask = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.4)
    stride, offset = GRID[n]
    vl = (n - 1 - offset) // stride + 1
    return [tuple(t.to(torch.int32) for t in c) for c in (
        scg.compaction_counts(mask),
        scg.gather_counts(n, stride, offset, vl),
        scg.gather_counts(n, 1, 0, n))]


def gather_plan(shift, valid):
    return shift_gather.host_plan(np.asarray(shift), np.asarray(valid),
                                  gather=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", B11_WIDTHS)
def test_b11_staged_form_vs_reference(n, dtype):
    """B11's staged copy on the CPU, through the operands its wrapper
    composes on the host from ``where(plan.valid, plan.source, -1)``
    (``plan_staged``), equals the reference's ``shift_gather_static``
    (``_plan_kernel`` in interpret mode) bit for bit on payloads with -0.0
    lanes (XLA rewrites NaN payloads, so the NaN lanes are held against the
    port's plain version instead), on conflict-free gather counts, at
    16-byte units and the narrower unit an odd width or an offset pointer
    leaves; so do the wrapper and its plain version.  On the KV stack's
    (2,1) gather the list is the whole row and the remapped table is the
    table."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.core import shiftplan as jplan
    from repro.kernels import shift_gather as jsg
    from _torch_bridge import to_np
    elem = torch.empty((), dtype=dtype).element_size()
    nan = make_rows(160 + n, (3, n), dtype)
    x = torch.where(nan.isnan(), torch.ones((), dtype=dtype), nan)
    for c, (shift, valid) in enumerate(b11_counts(n, 170 * n)):
        hs, hv = shift.numpy(), valid.numpy()
        plan = gather_plan(hs, hv)
        ref = jplan.counts_plan(tuple(int(s) for s in hs),
                                tuple(bool(v) for v in hv), gather=True)
        assert not plan.conflict and not ref.conflict
        want = np.asarray(jax.jit(functools.partial(
            jsg.shift_gather_static, plan=ref))(jnp.asarray(to_np(x))))
        for unit in units_for(n, elem):
            ops = _indexed.plan_staged(plan, unit // elem, elem)
            got, pos = staged_apply(x, ops["table"], unit, elem)
            np.testing.assert_array_equal(pos, ops["pos"])
            K = int(ops["nunits"][0])
            np.testing.assert_array_equal(ops["units"][:K],
                                          _indexed.staged_units_plain(
                                              ops["table"], n, unit // elem,
                                              elem)[0])
            assert_bits_equal(got, want)
            assert_bits_equal(staged_apply(nan, ops["table"], unit, elem)[0],
                              shift_gather.shift_gather_static_plain(nan,
                                                                     plan))
        assert_bits_equal(shift_gather.shift_gather_static(x, plan), want)
        assert_bits_equal(shift_gather.shift_gather(x, hs, hv), want)
    if n == 256:
        shift, valid = scg.gather_counts(256, 2, 1, 128)
        ops = _indexed.plan_staged(gather_plan(shift.numpy(), valid.numpy()),
                                   8, 2)
        np.testing.assert_array_equal(ops["units"], np.arange(32))  # 512 B
        assert ops["kmax"] == 32 and ops["nunits"].tolist() == [32]
        np.testing.assert_array_equal(ops["table"][:128],
                                      np.arange(1, 256, 2))
        np.testing.assert_array_equal(ops["pos"], ops["table"])


def test_b11_host_operands_cache_and_empty_plan(monkeypatch):
    """B11's operands go through the same cache as B13's: one entry per
    (plan, device, staging unit, element size), returned again on a
    repeat.  A gather plan that occupies no lane lists no unit (``kmax``
    1, ``nunits`` 0, ``pos`` all -1), and B11 writes zeros there, as the
    reference does."""
    import jax.numpy as jnp
    from repro.core import shiftplan as jplan
    from repro.kernels import shift_gather as jsg
    monkeypatch.setattr(_indexed, "PLANS", PlanCache())
    n = 96
    plan = gather_plan(*(t.numpy() for t in b11_counts(n, 3)[0]))
    cpu, meta = torch.device("cpu"), torch.device("meta")
    a = _indexed.plan_staged_operands(plan, cpu, 4, 4)
    assert _indexed.plan_staged_operands(plan, cpu, 4, 4) is a
    assert a["kmax"] == _indexed.plan_staged(plan, 4, 4)["kmax"]
    assert all(a[k].dtype == torch.int32 and a[k].device == cpu
               for k in ("units", "nunits", "pos"))
    others = [_indexed.plan_staged_operands(plan, cpu, 1, 4),
              _indexed.plan_staged_operands(plan, cpu, 2, 8),
              _indexed.plan_staged_operands(plan, meta, 4, 4),
              _indexed.plan_staged_operands(gather_plan(
                  *(t.numpy() for t in b11_counts(n, 3)[1])), cpu, 4, 4)]
    assert all(o is not a for o in others)
    assert others[2]["pos"].device == meta
    keys = [k for k in _indexed.PLANS.keys() if k[0] == "indexed.staged"]
    assert len(keys) == 5
    assert {k[1:] for k in keys} >= {(plan, "cpu", 4, 4), (plan, "cpu", 1, 4),
                                     (plan, "cpu", 2, 8),
                                     (plan, "meta", 4, 4)}
    zeros = np.zeros(8, np.int32)
    empty = gather_plan(zeros, zeros)
    ops = _indexed.plan_staged(empty, 8, 2)
    assert ops["kmax"] == 1 and ops["nunits"].tolist() == [0]
    assert ops["units"].tolist() == [0] and (ops["pos"] == -1).all()
    x = make_rows(9, (3, 8), torch.bfloat16)
    got, _ = staged_apply(x, ops["table"], 16, 2)
    assert not got.view(torch.int16).any()
    out = shift_gather.shift_gather_static(x, empty)
    assert not out.view(torch.int16).any()
    ref = jplan.counts_plan((0,) * 8, (False,) * 8, gather=True)
    assert not np.asarray(jsg.shift_gather_static(
        jnp.ones((3, 8), jnp.float32), ref)).any()


def test_b11_refuses_a_conflicting_plan(monkeypatch):
    """A gather plan with conflicts is refused with the reference's
    ``AssertionError`` at the top of B11's wrapper, before its device
    branch (a tensor off the CPU never reaches the launch), and by the
    reference's ``shift_gather_static``; a conflict-free plan does reach
    that branch."""
    import jax.numpy as jnp
    from repro.core import shiftplan as jplan
    from repro.kernels import shift_gather as jsg
    reached = []
    monkeypatch.setattr(_indexed, "launch_plan_copy",
                        lambda x, plan, wrapper, *, occupancy:
                        reached.append((plan, occupancy)))
    rng = np.random.default_rng(21)
    routings = [(np.array([0, 1, 0, 0]), np.array([1, 1, 0, 0], bool))]
    routings += [(rng.integers(0, 4, 96), rng.random(96) < 0.5)
                 for _ in range(3)]
    for hs, hv in routings:
        plan = gather_plan(hs, hv)
        assert plan.conflict
        n = len(hs)
        x = torch.arange(2 * n, dtype=torch.float32).reshape(2, n)
        before = shift_gather.shift_gather_static.launches
        for t in (x, x.to("meta")):
            with pytest.raises(AssertionError, match="conflicting plan"):
                shift_gather.shift_gather_static(t, plan)
            with pytest.raises(AssertionError, match="conflicting plan"):
                shift_gather.shift_gather(t, hs, hv)
        assert shift_gather.shift_gather_static.launches == before
        ref = jplan.counts_plan(tuple(int(s) for s in hs),
                                tuple(bool(v) for v in hv), gather=True)
        assert ref.conflict
        with pytest.raises(AssertionError, match="conflicting plan"):
            jsg.shift_gather_static(jnp.asarray(x.numpy()), ref)
    assert not reached
    ok = gather_plan(*(t.numpy() for t in b11_counts(96, 4)[1]))
    shift_gather.shift_gather_static(torch.empty((2, 96), device="meta"), ok)
    assert reached == [(ok, False)]


# ---------------------------------------------------------------------------
# On the card: B11, B12 and B13 against their plain versions and twins
# ---------------------------------------------------------------------------

def check_b12(x, shift, valid):
    """B12 against its plain version, and against B11 on the same counts
    as host data where their plan has no conflicts (B11 refuses the others,
    as the reference's plan body does)."""
    before = shift_gather.shift_gather.launches
    got = shift_gather.shift_gather(x, shift, valid)
    hs, hv = shift.cpu().numpy(), valid.cpu().numpy()
    if shift_gather.host_plan(hs, hv, gather=True).conflict:
        with pytest.raises(AssertionError, match="conflicting plan"):
            shift_gather.shift_gather(x, hs, hv)
        twin = None
    else:
        twin = shift_gather.shift_gather(x, hs, hv)
    want = shift_gather.shift_gather_plain(x, shift, valid)
    torch.cuda.synchronize()
    assert shift_gather.shift_gather.launches == before + 1
    assert_same_bits(got, want)
    if twin is not None:
        assert_same_bits(got, twin)


def check_b13(x, shift, valid):
    before = shift_scatter.shift_scatter_static.launches
    hs, hv = shift.cpu().numpy(), valid.cpu().numpy()
    plan = host_plan(hs, hv)
    p, o = shift_scatter.shift_scatter_static(x, plan)
    tp, to = shift_scatter.shift_scatter(x, shift, valid)
    if plan.conflict:               # the plan body refuses; B14's is B13's
        wp, wo = shift_scatter.shift_scatter_plain(x, shift, valid)
    else:
        wp, wo = shift_scatter.shift_scatter_static_plain(x, plan)
    torch.cuda.synchronize()
    assert shift_scatter.shift_scatter_static.launches == before + 1
    assert o.dtype == torch.bool and o.shape == x.shape and o.is_contiguous()
    assert_same_bits(p, wp)
    assert torch.equal(o, wo)
    assert_same_bits(p, tp)
    assert torch.equal(o, to)


def check_b11(x, shift, valid):
    """B11 on the plan of the (conflict-free) counts against its plain
    version and against B12 on the same counts as tensors, one launch."""
    plan = gather_plan(shift.cpu().numpy(), valid.cpu().numpy())
    before = shift_gather.shift_gather_static.launches
    got = shift_gather.shift_gather_static(x, plan)
    torch.cuda.synchronize()
    assert shift_gather.shift_gather_static.launches == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    assert_same_bits(got, shift_gather.shift_gather_static_plain(x, plan))
    assert_same_bits(got, shift_gather.shift_gather(x, shift, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ELEM_DTYPES)
@pytest.mark.parametrize("n", WIDTHS + [4])
def test_b11_matches_plain_and_b12_on_card(cuda_device, dtype, n):
    """B11 bit-exact against its plain version and against B12 on the same
    counts, one launch a call: the gather counts whose plan has no
    conflicts (the grid's, a random mask's compaction, the identity, and
    those of the random operand counts that compile without one), 7, 1001
    and 20011 rows, and a view one element past a 16-byte boundary."""
    dev = cuda_device
    counts = b11_counts(n, 180 * n) + [
        c for c in all_counts(n, 190 * n, gather=True)
        if not gather_plan(c[0].numpy(), c[1].numpy()).conflict]
    counts = [tuple(t.to(dev) for t in c) for c in counts]
    for rows in (7, 1001, 20011):
        x = card_rand(n + rows, (rows, n), dtype, dev)
        for shift, valid in counts:
            check_b11(x, shift, valid)
    view = offset_view(n, 517, n, dtype, dev)
    for shift, valid in counts:
        check_b11(view, shift, valid)


@pytest.mark.cuda
def test_b11_right_behind_its_producer_on_card(cuda_device):
    """B11's copy is launched plainly, stream-ordered after whatever wrote
    its input: 128 rounds of ``torch.add(a, k, out=x)`` then B11 on ``x``
    on the same stream with no synchronization between them, each result
    held against the plain version on the same input."""
    dev = cuda_device
    R, n = 1 << 17, 256                               # 64 MiB of bf16
    a = card_rand(12, (R, n), torch.bfloat16, dev)
    x = torch.empty_like(a)
    plan = gather_plan(*(t.numpy() for t in scg.gather_counts(n, 2, 1, 128)))
    for k in range(128):
        x.zero_()
        torch.cuda.synchronize()
        torch.add(a, float(k % 7 + 1), out=x)
        got = shift_gather.shift_gather_static(x, plan)
        want = shift_gather.shift_gather_static_plain(x, plan)
        torch.cuda.synchronize()
        assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ELEM_DTYPES)
@pytest.mark.parametrize("n", WIDTHS)
def test_b12_b13_match_plain_and_twins_on_card(cuda_device, dtype, n):
    """B12 and B13 bit-exact against their plain versions and their twins
    (B12 == B11 on the same counts as host data; B13 == B14), one launch a
    call: random operand counts and the grid's counts, 7, 1001 and 20011
    rows, and a view one element past a 16-byte boundary."""
    dev = cuda_device
    gathers = [tuple(t.to(dev) for t in c)
               for c in all_counts(n, 130 * n, gather=True)]
    scatters = [tuple(t.to(dev) for t in c)
                for c in all_counts(n, 140 * n, gather=False)]
    for rows in (7, 1001, 20011):
        x = card_rand(n + rows, (rows, n), dtype, dev)
        for shift, valid in gathers:
            check_b12(x, shift, valid)
        for shift, valid in scatters:
            check_b13(x, shift, valid)
    view = offset_view(n, 517, n, dtype, dev)
    for shift, valid in gathers:
        check_b12(view, shift, valid)
    for shift, valid in scatters:
        check_b13(view, shift, valid)


@pytest.mark.cuda
def test_b12_device_tables_match_twins(cuda_device):
    """B12's derive kernel alone (``_indexed.dyn_sources(gsn=True)``): its
    table equals ``dyn_sources_plain(gsn=True)`` and the staged copy's
    operands it composes (the remapped table and the unit list) equal
    ``staged_units_plain``, on random and grid counts, for 1-, 2-, 4- and
    8-byte lanes at 16-byte and narrower units."""
    dev = cuda_device
    for n in WIDTHS:
        counts = all_counts(n, 150 * n, gather=True)
        counts.append(tuple(t.to(torch.int32)
                            for t in scg.gather_counts(n, 1, 0, n)))
        for c, (shift, valid) in enumerate(counts):
            want = _common.dyn_sources_plain(shift, valid, gsn=True)
            for elem in (1, 2, 4, 8):
                for unit in units_for(n, elem):
                    table, pos, units = _indexed.dyn_sources(
                        shift.to(dev), valid.to(dev), gsn=True, elem=elem,
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
def test_b12_b13_right_behind_their_producer_on_card(cuda_device):
    """B12's derive kernel and B13's copy are stream-ordered after
    whatever wrote their input (B12's copy waits on its derive kernel
    under Programmatic Dependent Launch; B13's is launched plainly).  128
    rounds of ``torch.add(a, k, out=x)`` then B12 and B13 on ``x`` on the
    same stream with no synchronization between them, each result held
    against the plain version on the same inputs."""
    dev = cuda_device
    R, n = 1 << 17, 256                               # 64 MiB of bf16
    a = card_rand(11, (R, n), torch.bfloat16, dev)
    x = torch.empty_like(a)
    gs, gv = (t.to(dev) for t in random_counts(n, "short", 6))
    # a scatter plan without conflicts, so its plain version takes it
    hs, hv = (t.numpy() for t in all_counts(n, 7, gather=False)[3])
    plan = host_plan(hs, hv)
    assert not plan.conflict and plan.valid.any()
    for k in range(128):
        x.zero_()
        torch.cuda.synchronize()
        torch.add(a, float(k % 7 + 1), out=x)
        got12 = shift_gather.shift_gather(x, gs, gv)
        got13, occ = shift_scatter.shift_scatter_static(x, plan)
        want12 = shift_gather.shift_gather_plain(x, gs, gv)
        want13, want_occ = shift_scatter.shift_scatter_static_plain(x, plan)
        torch.cuda.synchronize()
        assert_same_bits(got12, want12)
        assert_same_bits(got13, want13)
        assert torch.equal(occ, want_occ)
