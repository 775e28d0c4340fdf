"""Port parity for the Indexed / Compact slice: the compaction counts of
core/scg.py, row routing (``shiftnet.gather_rows`` / ``scatter_rows``),
``accessfuse.compact_indices``, kernels/moe_compact.py (kernel B10),
kernels/shift_gather.py (B11 plan, B12 runtime counts),
kernels/shift_scatter.py (B13 plan, B14 runtime counts) and the vx
``Indexed`` / ``Compact`` verbs.

On the CPU the wrappers run their plain versions.  Every comparison is
bit for bit (integer views, no tolerance) against the reference package
on numpy-seeded inputs: the counts and row routing against ``repro.core``,
each wrapper's plain arm against the reference's Pallas body in interpret
mode (the grids of tests/test_kernels_vs_ref.py, trimmed: float32 and
bfloat16, widths that are not powers of two, n <= 2, densities 0 and 1),
and the vx verbs under ``ref``, ``kernel`` and ``kernel_dynamic`` against
``repro.vx`` under ``pallas``.  The ``cuda`` cases hold the five kernels
against their plain versions (and B12 / B14 against their plan twins) on
the card and skip without one; JAX is imported inside the tests that need
it: ``python -m pytest -m cuda tests/test_torch_indexed.py``.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch import vx
from repro_torch.core import accessfuse, scg, shiftnet
from repro_torch.kernels import moe_compact, shift_gather, shift_scatter

MASK_N = [1, 2, 7, 64, 100]
DENSITIES = [0.0, 0.3, 1.0]
ROW_SHAPES = [(64, 128), (100, 8), (2, 8), (1, 8)]
LANES = [(96, 3, 1), (100, 2, 0), (2, 1, 1)]      # (n, stride, offset)


def rand(seed, shape, dtype):
    """numpy-seeded input; bfloat16 through float32, with -0.0 lanes."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-100, 100, shape)
                                .astype(np.int32))
    a = rng.normal(size=shape).astype(np.float32)
    a.reshape(-1)[::7] = -0.0
    return torch.from_numpy(a).to(getattr(torch, dtype))


def rand_mask(seed, n, density):
    return torch.from_numpy(np.random.default_rng(seed).random(n) < density)


def jnp_of(t):
    import jax.numpy as jnp
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def vl_of(n, stride, offset):
    return (n - 1 - offset) // stride + 1


def lane_counts(n, stride, offset, kind):
    """(shift, valid) host counts of one routing kind over n lanes."""
    vl = vl_of(n, stride, offset)
    if kind == "gather":
        return scg.gather_counts(n, stride, offset, vl)
    if kind == "scatter":
        return scg.scatter_counts(n, stride, offset, vl)
    mask = rand_mask(n + stride, n, 0.4)
    if kind == "compact":
        return scg.compaction_counts(mask)
    return scg.expansion_counts(mask)                 # "expand"


# ---------------------------------------------------------------------------
# Counts, row routing, compact_indices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", MASK_N)
@pytest.mark.parametrize("density", DENSITIES)
def test_compaction_counts_match_reference(n, density):
    from repro.core import scg as jscg
    mask = rand_mask(n, n, density)
    for port, ref in ((scg.compaction_counts, jscg.compaction_counts),
                      (scg.expansion_counts, jscg.expansion_counts)):
        s, v = port(mask)
        js, jv = ref(jnp_of(mask))
        assert s.dtype == torch.int32 and v.dtype == torch.bool
        assert_bits_equal(s, np.asarray(js))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_column_access_counts_match_reference():
    from repro.core import scg as jscg
    for n, stride, vl in ((64, 8, 8), (96, 16, 6), (100, 3, 30)):
        s, v = scg.column_access_counts(n, stride, vl)
        js, jv = jscg.column_access_counts(n, stride, vl)
        assert_bits_equal(s, np.asarray(js))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,d", [(64, 4), (100, 3), (2, 5), (1, 2)])
@pytest.mark.parametrize("density", DENSITIES)
def test_row_routing_matches_reference(n, d, density):
    from repro.core import scg as jscg
    from repro.core import shiftnet as jshiftnet
    rows = rand(n * d, (n, d), "float32")
    mask = rand_mask(n + 1, n, density)
    cases = ((shiftnet.gather_rows, jshiftnet.gather_rows,
              scg.compaction_counts(mask), jscg.compaction_counts),
             (shiftnet.scatter_rows, jshiftnet.scatter_rows,
              scg.expansion_counts(mask), jscg.expansion_counts))
    for port, ref, (s, v), jcounts in cases:
        got = port(rows, s, v)
        want = ref(jnp_of(rows), *jcounts(jnp_of(mask)))
        assert_bits_equal(got.payload, np.asarray(want.payload))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        assert bool(got.conflict) == bool(want.conflict)


@pytest.mark.parametrize("n", MASK_N)
@pytest.mark.parametrize("density", DENSITIES)
def test_compact_indices_matches_reference(n, density):
    from repro.core import accessfuse as jaccessfuse
    mask = rand_mask(2 * n, n, density)
    for cap in (n, max(1, n // 3)):
        got = accessfuse.compact_indices(mask, cap)
        want = jaccessfuse.compact_indices(jnp_of(mask), cap)
        assert got.dtype == torch.int32
        assert_bits_equal(got, np.asarray(want))
        np.testing.assert_array_equal(
            got[:int(mask.sum())].numpy(),
            torch.nonzero(mask)[:cap, 0].numpy())


# ---------------------------------------------------------------------------
# Kernel wrappers (plain arm on the CPU) against the reference's Pallas
# bodies in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", ROW_SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
def test_moe_compact_matches_pallas(dtype, n, d, density):
    from repro.kernels import moe_compact as jmoe
    rows = rand(n + d, (n, d), dtype)
    mask = rand_mask(n * 3 + d, n, density)
    moe_compact.reset_counts()
    packed, pv = moe_compact.compact_rows(rows, mask)
    jp, jv = jmoe.compact_rows(jnp_of(rows), jnp_of(mask))
    assert_bits_equal(packed, np.asarray(jp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    back = moe_compact.expand_rows(packed, mask)
    assert_bits_equal(back, np.asarray(jmoe.expand_rows(jp, jnp_of(mask))))
    assert_bits_equal(back, torch.where(mask[:, None], rows,
                                        torch.zeros_like(rows)))
    # n <= 1 has no layer: nothing reaches the kernel wrapper
    assert moe_compact.route_rows.calls == (2 if n > 1 else 0)
    assert moe_compact.route_rows.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,stride,offset", LANES)
@pytest.mark.parametrize("kind", ["gather", "compact"])
def test_shift_gather_matches_pallas(dtype, n, stride, offset, kind):
    from repro.core import shiftplan as jshiftplan
    from repro.kernels import shift_gather as jsg
    x = rand(n, (5, n), dtype)
    s, v = lane_counts(n, stride, offset, kind)
    want = np.asarray(jsg.shift_gather(jnp_of(x), jnp_of(s), jnp_of(v)))
    assert_bits_equal(shift_gather.shift_gather(x, s, v), want)
    hs, hv = s.numpy(), v.numpy()
    want_plan = np.asarray(jsg.shift_gather(jnp_of(x), hs, hv))
    assert_bits_equal(want_plan, want)
    assert_bits_equal(shift_gather.shift_gather(x, hs, hv), want_plan)
    jplan = jshiftplan.counts_plan(tuple(int(a) for a in hs),
                                   tuple(bool(a) for a in hv), gather=True)
    plan = shift_gather.host_plan(hs, hv, gather=True)
    assert_bits_equal(shift_gather.shift_gather_static(x, plan),
                      np.asarray(jsg.shift_gather_static(jnp_of(x), jplan)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,stride,offset", LANES)
@pytest.mark.parametrize("kind", ["scatter", "expand"])
def test_shift_scatter_matches_pallas(dtype, n, stride, offset, kind):
    from repro.kernels import shift_scatter as jss
    x = rand(n + 1, (3, n), dtype)
    s, v = lane_counts(n, stride, offset, kind)
    jp, jo = jss.shift_scatter(jnp_of(x), jnp_of(s), jnp_of(v))
    p, o = shift_scatter.shift_scatter(x, s, v)
    assert_bits_equal(p, np.asarray(jp))
    assert o.dtype == torch.bool and o.shape == x.shape
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    hs, hv = s.numpy(), v.numpy()
    jp2, jo2 = jss.shift_scatter(jnp_of(x), hs, hv)
    p2, o2 = shift_scatter.shift_scatter(x, hs, hv)
    assert_bits_equal(p2, np.asarray(jp2))
    np.testing.assert_array_equal(o2.numpy(), np.asarray(jo2))
    assert_bits_equal(p2, p)
    np.testing.assert_array_equal(o2.numpy(), o.numpy())


def test_shift_network_wrapper_counts_on_cpu():
    """Host counts take the plan wrapper, tensor counts the dynamic one;
    on the CPU nothing launches."""
    shift_gather.reset_counts()
    shift_scatter.reset_counts()
    x = rand(0, (4, 96), "float32")
    s, v = scg.gather_counts(96, 3, 1, 32)
    shift_gather.shift_gather(x, s, v)
    shift_gather.shift_gather(x, s.numpy(), v.numpy())
    s, v = scg.scatter_counts(96, 3, 1, 32)
    shift_scatter.shift_scatter(x, s, v)
    shift_scatter.shift_scatter(x, tuple(s.tolist()), tuple(v.tolist()))
    calls = [f.calls for f in shift_gather.KERNELS + shift_scatter.KERNELS]
    assert calls == [1, 2, 1, 2]
    assert all(f.launches == 0
               for f in shift_gather.KERNELS + shift_scatter.KERNELS)


# ---------------------------------------------------------------------------
# vx Indexed / Compact verbs, end to end
# ---------------------------------------------------------------------------

POLICIES = ["ref", "kernel", "kernel_dynamic"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vx_indexed_matches_reference_under_every_policy(dtype):
    from repro import vx as jvx
    n = 96
    x = rand(7, (4, n), dtype)
    gs, gv = scg.gather_counts(n, 3, 1, 32)
    ss, sv = scg.scatter_counts(n, 3, 1, 32)
    jx = jnp_of(x)
    want_g = np.asarray(jvx.gather(jvx.Indexed(n=n), jx, shift=jnp_of(gs),
                                   valid=jnp_of(gv), policy="pallas"))
    want_gs = np.asarray(jvx.gather(jvx.Indexed(n=n), jx,
                                    shift=gs.numpy(), valid=gv.numpy(),
                                    policy="pallas"))
    jp, jo = jvx.scatter(jvx.Indexed(n=n), None, jx, shift=jnp_of(ss),
                         valid=jnp_of(sv), policy="pallas")
    jp2, jo2 = jvx.scatter(jvx.Indexed(n=n), None, jx, shift=ss.numpy(),
                           valid=sv.numpy(), policy="pallas")
    for pol in POLICIES:
        assert_bits_equal(vx.gather(vx.Indexed(n=n), x, shift=gs, valid=gv,
                                    policy=pol), want_g)
        assert_bits_equal(vx.gather(vx.Indexed(n=n), x, shift=gs.numpy(),
                                    valid=gv.numpy(), policy=pol), want_gs)
        p, o = vx.scatter(vx.Indexed(n=n), None, x, shift=ss, valid=sv,
                          policy=pol)
        assert_bits_equal(p, np.asarray(jp))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        p, o = vx.scatter(vx.Indexed(n=n), None, x, shift=ss.numpy(),
                          valid=sv.numpy(), policy=pol)
        assert_bits_equal(p, np.asarray(jp2))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo2))


@pytest.mark.parametrize("n,d,density", [(64, 16, 0.3), (100, 8, 1.0),
                                         (33, 4, 0.0)])
def test_vx_compact_matches_reference_under_every_policy(n, d, density):
    from repro import vx as jvx
    rows = rand(n, (n, d), "bfloat16")
    mask = rand_mask(n + 5, n, density)
    jrows, jmask = jnp_of(rows), jnp_of(mask)
    cap = max(1, n // 4)
    want = {}
    for key, spec in (("full", (n, None)), ("cap", (n, cap))):
        jp, jv = jvx.compact(jvx.Compact(*spec), jmask, jrows,
                             policy="pallas")
        want[key] = (np.asarray(jp), np.asarray(jv))
        want[key + ".ids"] = np.asarray(jvx.compact(jvx.Compact(*spec),
                                                    jmask, policy="pallas"))
        if key == "full":
            want_back = np.asarray(jvx.scatter(jvx.Compact(n=n), jmask, jp,
                                               policy="pallas"))
    for pol in POLICIES:
        for key, spec in (("full", (n, None)), ("cap", (n, cap))):
            p, v = vx.compact(vx.Compact(*spec), mask, rows, policy=pol)
            assert_bits_equal(p, want[key][0])
            np.testing.assert_array_equal(v.numpy(), want[key][1])
            assert_bits_equal(vx.compact(vx.Compact(*spec), mask,
                                         policy=pol), want[key + ".ids"])
        packed, _ = vx.compact(vx.Compact(n=n), mask, rows, policy=pol)
        back = vx.scatter(vx.Compact(n=n), mask, packed, policy=pol)
        assert_bits_equal(back, want_back)
        assert_bits_equal(back, torch.where(mask[:, None], rows,
                                            torch.zeros_like(rows)))


def test_indexed_static_routing_promotes_to_plan():
    """Host-known (shift, valid) fold into the spec, run the plan stage,
    hit ``vx.PLANS`` on the second call and equal the dynamic network bit
    for bit (the port's twin of tests/test_paged.py's promotion test)."""
    n = 32
    shift, valid = scg.gather_counts(n, 3, 2, 7)
    buf = torch.arange(n, dtype=torch.float32) * 2 + 1
    dyn = vx.gather(vx.Indexed(n=n), buf, shift=shift, valid=valid)
    vx.PLANS.clear()
    static = vx.gather(vx.Indexed(n=n), buf, shift=shift.numpy(),
                       valid=valid.numpy())
    assert_bits_equal(static, dyn)
    m = vx.PLANS.stats()["misses"]
    assert m >= 1
    vx.gather(vx.Indexed(n=n), buf, shift=shift.numpy(),
              valid=valid.numpy())              # same routing: cache hit
    assert vx.PLANS.stats()["misses"] == m
    spec = vx.Indexed(n=n, routing=(tuple(shift.tolist()),
                                    tuple(valid.tolist())))
    assert_bits_equal(vx.gather(spec, buf), dyn)
    assert spec.static and not vx.Indexed(n=n).static


def test_indexed_spec_and_fold_errors():
    n = 8
    spec = vx.Indexed(n=n, routing=((0,) * n, (True,) * n))
    buf = torch.zeros(n)
    with pytest.raises(ValueError, match="already folds"):
        vx.gather(spec, buf, shift=np.zeros(n, np.int32),
                  valid=np.ones(n, bool))
    with pytest.raises(ValueError, match="per-lane entries"):
        vx.Indexed(n=n, routing=((0,) * 3, (True,) * n))
    with pytest.raises(ValueError, match="shift= and valid="):
        vx.gather(vx.Indexed(n=n), buf)
    with pytest.raises(ValueError, match="shift= and valid="):
        vx.scatter(vx.Indexed(n=n), None, buf, shift=torch.zeros(n))
    with pytest.raises(TypeError, match="Compact spec"):
        vx.compact(vx.Indexed(n=n), torch.ones(n, dtype=torch.bool))
    assert vx.Compact(n=8, cap=20).capacity == 8
    assert vx.Compact(n=8).key() != vx.Compact(n=8, cap=4).key()


@pytest.mark.parametrize("pol", POLICIES)
def test_vx_indexed_compact_call_counts(pol):
    """What each verb reaches per policy: under a kernel policy the
    tensor-count gather calls B12's wrapper once, the host-count gather
    none (plan stage), the scatter B14's (tensor counts) or B13's (host
    counts) once, compact and the Compact scatter B10's once each, the ids
    none; under ``ref`` no wrapper at all.  On the CPU nothing launches."""
    wrappers = (shift_gather.KERNELS + shift_scatter.KERNELS
                + moe_compact.KERNELS)
    for mod in (shift_gather, shift_scatter, moe_compact):
        mod.reset_counts()
    n = 64
    x = rand(3, (2, n), "float32")
    gs, gv = scg.gather_counts(n, 2, 1, 31)
    ss, sv = scg.scatter_counts(n, 2, 1, 31)
    mask = rand_mask(4, n, 0.5)

    def counts():
        return [f.calls for f in wrappers]

    seen = {}
    with vx.use(pol):
        steps = (
            ("gather[tensor]", lambda: vx.gather(vx.Indexed(n=n), x,
                                                 shift=gs, valid=gv)),
            ("gather[host]", lambda: vx.gather(vx.Indexed(n=n), x,
                                               shift=gs.numpy(),
                                               valid=gv.numpy())),
            ("scatter[tensor]", lambda: vx.scatter(vx.Indexed(n=n), None, x,
                                                   shift=ss, valid=sv)),
            ("scatter[host]", lambda: vx.scatter(vx.Indexed(n=n), None, x,
                                                 shift=ss.numpy(),
                                                 valid=sv.numpy())),
            ("compact", lambda: vx.compact(vx.Compact(n=n), mask, x.T
                                           .contiguous())),
            ("expand", lambda: vx.scatter(vx.Compact(n=n), mask,
                                          x.T.contiguous())),
            ("ids", lambda: vx.compact(vx.Compact(n=n, cap=8), mask)))
        for name, step in steps:
            before = counts()
            step()
            seen[name] = [a - b for a, b in zip(counts(), before)]
    # order: shift_gather_static, shift_gather, shift_scatter_static,
    # shift_scatter, route_rows
    if pol == "ref":
        assert all(c == [0] * 5 for c in seen.values()), seen
    else:
        assert seen == {"gather[tensor]": [0, 1, 0, 0, 0],
                        "gather[host]": [0, 0, 0, 0, 0],
                        "scatter[tensor]": [0, 0, 0, 1, 0],
                        "scatter[host]": [0, 0, 1, 1, 0],
                        "compact": [0, 0, 0, 0, 1],
                        "expand": [0, 0, 0, 0, 1],
                        "ids": [0, 0, 0, 0, 0]}, seen
    assert all(f.launches == 0 for f in wrappers)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

CARD_DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.int64]


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


def card_same(a, b) -> bool:
    def iv(t):
        return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                    4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(iv(a), iv(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("n", [2, 96, 4096])
@pytest.mark.parametrize("density", [0.0, 0.25, 1.0])
def test_route_rows_kernel_matches_plain_on_card(cuda_device, dtype, n,
                                                 density):
    rows = card_rand(n, (n, 24), dtype, cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n + 1)
    mask = torch.rand(n, generator=g, device=cuda_device) < density
    for counts, tz, out_valid in (
            (scg.compaction_counts, True,
             torch.arange(n, device=cuda_device) < mask.sum()),
            (scg.expansion_counts, False, mask)):
        s, v = counts(mask)
        masks, _ = shiftnet.layer_masks(s, v, toward_zero=tz, lsb_first=tz)
        before = moe_compact.route_rows.launches
        got = moe_compact.route_rows(rows, masks, out_valid, toward_zero=tz,
                                     lsb_first=tz)
        want = moe_compact.route_rows_plain(rows, masks, out_valid,
                                            toward_zero=tz, lsb_first=tz)
        torch.cuda.synchronize()
        assert moe_compact.route_rows.launches == before + 1
        assert card_same(got, want), (dtype, n, density, tz)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("n,stride,offset", [(96, 3, 1), (256, 2, 1),
                                             (4095, 64, 0), (1, 1, 0)])
@pytest.mark.parametrize("rows", [7, 1001])
def test_shift_kernels_match_plain_on_card(cuda_device, dtype, n, stride,
                                           offset, rows):
    x = card_rand(n + rows, (rows, n), dtype, cuda_device)
    for kind in ("gather", "scatter", "compact", "expand"):
        s, v = lane_counts(n, stride, offset, kind)
        s, v = s.to(cuda_device), v.to(cuda_device)
        hs, hv = s.cpu().numpy(), v.cpu().numpy()
        where = (dtype, n, stride, offset, rows, kind)
        if kind in ("gather", "compact"):
            dyn = shift_gather.shift_gather(x, s, v)
            plan = shift_gather.shift_gather(x, hs, hv)
            torch.cuda.synchronize()
            assert card_same(dyn, shift_gather.shift_gather_plain(x, s, v)), \
                where
            assert card_same(plan, shift_gather.shift_gather_static_plain(
                x, shift_gather.host_plan(hs, hv, gather=True))), where
            assert card_same(dyn, plan), where
        else:
            p, o = shift_scatter.shift_scatter(x, s, v)
            p2, o2 = shift_scatter.shift_scatter(x, hs, hv)
            torch.cuda.synchronize()
            wp, wo = shift_scatter.shift_scatter_plain(x, s, v)
            assert card_same(p, wp) and torch.equal(o, wo), where
            pp, po = shift_scatter.shift_scatter_static_plain(
                x, shift_gather.host_plan(hs, hv, gather=False))
            assert card_same(p2, pp) and torch.equal(o2, po), where
            assert card_same(p, p2) and torch.equal(o, o2), where
