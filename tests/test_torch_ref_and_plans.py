"""Port parity: the torch oracles (repro_torch.kernels.ref) are bit-exact
against repro.kernels.ref on the tests/test_kernels_vs_ref.py grid, and
every segment ShiftPlan the port compiles is byte-equal to the
reference's (layers, shifts, masks, valid, source, conflict)."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import assert_bits_equal, to_torch
from repro.core import shiftplan as jplan
from repro.kernels import ref as jref
from repro.kernels import _common as jcommon
from repro_torch.core import shiftplan as tplan
from repro_torch.kernels import _common as tcommon
from repro_torch.kernels import ref as tref

DTYPES = ["float32", "bfloat16", "int32"]


def rand(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-100, 100, shape).astype(np.int32)
    return np.asarray(jnp.asarray(rng.normal(size=shape), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,n", [((), 128), ((2, 3), 256), ((5,), 96)])
@pytest.mark.parametrize("stride,offset", [(2, 0), (3, 1), (7, 5), (16, 3)])
def test_gather_strided_oracle(dtype, lead, n, stride, offset):
    vl = (n - 1 - offset) // stride + 1
    win = rand(0, lead + (n,), dtype)
    assert_bits_equal(tref.gather_strided(to_torch(win), stride, offset, vl),
                      jref.gather_strided(jnp.asarray(win), stride, offset,
                                          vl))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,n", [((4,), 64), ((3, 2), 256)])
@pytest.mark.parametrize("stride,offset", [(2, 0), (5, 4), (1, 0)])
def test_scatter_strided_oracle(dtype, lead, n, stride, offset):
    vl = (n - 1 - offset) // stride + 1
    win = rand(1, lead + (n,), dtype)
    vals = rand(2, lead + (vl,), dtype)
    assert_bits_equal(
        tref.scatter_strided(to_torch(win), to_torch(vals), stride, offset),
        jref.scatter_strided(jnp.asarray(win), jnp.asarray(vals), stride,
                             offset))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fields", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("lead,m", [((), 64), ((4,), 32), ((2, 2), 128)])
def test_segment_oracles(dtype, fields, lead, m):
    aos = rand(3, lead + (fields * m,), dtype)
    got = tref.deinterleave(to_torch(aos), fields)
    want = jref.deinterleave(jnp.asarray(aos), fields)
    assert len(got) == fields
    for g, w in zip(got, want):
        assert_bits_equal(g, w)
    soa = [rand(10 + f, lead + (m,), dtype) for f in range(fields)]
    assert_bits_equal(tref.interleave([to_torch(s) for s in soa]),
                      jref.interleave([jnp.asarray(s) for s in soa]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(64, 128), (256, 384), (32, 8)])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_expand_oracles(dtype, n, d, density):
    rows = rand(5, (n, d), dtype)
    mask = np.random.default_rng(6).uniform(size=(n,)) < density
    got, gv = tref.compact_rows(to_torch(rows), to_torch(mask))
    want, wv = jref.compact_rows(jnp.asarray(rows), jnp.asarray(mask))
    assert_bits_equal(got, want)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    packed = np.asarray(want)
    assert_bits_equal(tref.expand_rows(to_torch(packed), to_torch(mask)),
                      jref.expand_rows(jnp.asarray(packed),
                                       jnp.asarray(mask)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kv_oracles(dtype):
    k, v = rand(7, (3, 4, 16), dtype), rand(8, (3, 4, 16), dtype)
    beat = tref.kv_interleave(to_torch(k), to_torch(v))
    assert_bits_equal(beat, jref.kv_interleave(jnp.asarray(k),
                                               jnp.asarray(v)))
    tk, tv = tref.kv_split(beat)
    assert_bits_equal(tk, k)
    assert_bits_equal(tv, v)


def assert_plans_equal(tp, jp):
    assert (tp.n, tp.kind, tp.conflict) == (jp.n, jp.kind, jp.conflict)
    assert len(tp.layers) == len(jp.layers)
    for tl, jl in zip(tp.layers, jp.layers):
        assert tl.shifts == jl.shifts
        assert len(tl.masks) == len(jl.masks)
        for tm, jm in zip(tl.masks, jl.masks):
            assert tm.dtype == jm.dtype and tm.tobytes() == jm.tobytes()
    for a in ("valid", "source"):
        x, y = getattr(tp, a), getattr(jp, a)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), a


@pytest.mark.parametrize("fields", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("m", [32, 64, 128])
def test_segment_plans_byte_equal(fields, m):
    n = fields * m
    for name in ("segment_deinterleave_plans", "segment_interleave_plans"):
        tmode, tps = getattr(tplan, name)(n, fields)
        jmode, jps = getattr(jplan, name)(n, fields)
        assert tmode == jmode, name
        assert len(tps) == len(jps)
        for tp, jp in zip(tps, jps):
            assert_plans_equal(tp, jp)
    assert_plans_equal(tplan.deinterleave_plan(n, fields),
                       jplan.deinterleave_plan(n, fields))
    assert_plans_equal(tplan.interleave_plan(n, fields),
                       jplan.interleave_plan(n, fields))


@pytest.mark.parametrize("n", [256, 6144])
def test_main_path_plans_pick_per_field(n):
    """At main-path widths (FIELD=2) both directions choose per_field, as
    the reference does on a non-TPU platform."""
    for name in ("segment_deinterleave_plans", "segment_interleave_plans"):
        mode, plans = getattr(tplan, name)(n, 2)
        assert mode == "per_field"
        jmode, jplans = getattr(jplan, name)(n, 2)
        assert jmode == mode
        for tp, jp in zip(plans, jplans):
            assert_plans_equal(tp, jp)


@pytest.mark.parametrize("fields", [2, 3, 8])
def test_plan_operands_match_reference(fields):
    n = fields * 32
    for name in ("segment_deinterleave_plans", "segment_interleave_plans"):
        _, plans = getattr(tplan, name)(n, fields)
        _, jplans = getattr(jplan, name)(n, fields)
        tm, tspans = tcommon.stack_plan_masks(plans)
        jm, jspans = jcommon.stack_plan_masks(jplans)
        assert tspans == jspans and tm.tobytes() == np.asarray(jm).tobytes()
        for tp, jp in zip(plans, jplans):
            tmask, tvalid, ts = tcommon.plan_operands(tp)
            jmask, jvalid, js = jcommon.plan_operands(jp)
            assert ts == js
            np.testing.assert_array_equal(tmask, np.asarray(jmask))
            np.testing.assert_array_equal(tvalid, np.asarray(jvalid))
