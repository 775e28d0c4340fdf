"""Port parity for the strided arm: core/scg.py, the dynamic shift
networks, the strided ShiftPlans, kernels/strided.py (kernels B3 gather,
B4 fused gather, B5 scatter), vx Strided verbs, the runtime-stride plan
bank, the strided StepScheduler group and core/lsdo.py.

On the CPU the port's kernel wrappers run their plain version; every
routing comparison here is bit for bit (integer views, no tolerance)
against the reference package on numpy-seeded inputs: ``repro.vx`` under
``policy="ref"`` on the whole grid of tests/test_kernels_vs_ref.py, and
under ``policy="pallas"`` (interpret mode) on a handful of cases.  The
``cuda`` cases hold the CUDA kernels against their plain versions on the
card and skip without one; JAX is imported inside the tests that need
it, so they run where only torch is installed:
``python -m pytest -m cuda tests/test_torch_strided.py``.
"""
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch import vx
from repro_torch.core import accessfuse, lsdo, scg, shiftnet, shiftplan
from repro_torch.kernels import strided

DTYPES = ["float32", "bfloat16", "int32"]
GATHER_GRID = [((), 128), ((4,), 64), ((2, 3), 256), ((5,), 96), ((8,), 512)]
GATHER_SO = [(2, 0), (3, 1), (4, 2), (7, 5), (1, 0), (16, 3)]
SCATTER_GRID = [((), 128), ((4,), 64), ((3, 2), 256)]
SCATTER_SO = [(2, 0), (3, 1), (5, 4), (1, 0)]


def rand(seed, shape, dtype):
    """numpy-seeded input; bfloat16 through float32."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-100, 100, shape)
                                .astype(np.int32))
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return t.to(getattr(torch, dtype))


def jnp_of(t):
    import jax.numpy as jnp
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def vl_of(n, stride, offset):
    return (n - 1 - offset) // stride + 1


def assert_plans_equal(tp, jp):
    assert (tp.n, tp.kind, tp.conflict) == (jp.n, jp.kind, jp.conflict)
    assert len(tp.layers) == len(jp.layers)
    for tl, jl in zip(tp.layers, jp.layers):
        assert tl.shifts == jl.shifts
        for tm, jm in zip(tl.masks, jl.masks):
            assert tm.dtype == jm.dtype and tm.tobytes() == jm.tobytes()
    for a in ("valid", "source"):
        x, y = getattr(tp, a), getattr(jp, a)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), a


# ---------------------------------------------------------------------------
# scg counts, dynamic networks, plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,stride,offset,vl", [
    (64, 2, 0, 32), (96, 3, 1, 20), (128, 7, 5, 18), (33, 1, 0, 33),
    (256, 16, 3, 9), (64, 5, -3, 12)])
def test_scg_counts(n, stride, offset, vl):
    from repro.core import scg as jscg
    for name in ("gather_counts", "scatter_counts", "segment_gather_counts",
                 "segment_scatter_counts"):
        js, jv = getattr(jscg, name)(n, stride, offset, vl)
        for s in (stride, torch.tensor(stride)):       # int or 0-dim tensor
            ts, tv = getattr(scg, name)(n, s, offset, vl)
            assert ts.dtype == torch.int32 and tv.dtype == torch.bool
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,stride,offset,vl", [
    (64, 2, 0, 32), (96, 3, 1, 20), (64, 1, 0, 64)])
def test_dynamic_networks(n, stride, offset, vl):
    """Runtime-count GSN/SSN, layer masks and their application against
    the reference (jit-compiled: the same bits, less time)."""
    import jax
    import jax.numpy as jnp
    from repro.core import scg as jscg
    from repro.core import shiftnet as jnet
    x = rand(1, (3, n), "float32")
    jx = jnp.asarray(x.numpy())
    for counts, net, jnet_fn, kw in (
            (scg.gather_counts, shiftnet.gather_network,
             jnet.gather_network, dict(toward_zero=True, lsb_first=True)),
            (scg.scatter_counts, shiftnet.scatter_network,
             jnet.scatter_network, dict(toward_zero=False,
                                        lsb_first=False))):
        ts, tv = counts(n, stride, offset, vl)
        js, jv = jnp.asarray(ts.numpy()), jnp.asarray(tv.numpy())
        got = net(x, ts, tv)
        want = jax.jit(jnet_fn)(jx, js, jv)
        assert_bits_equal(got.payload, want.payload)
        assert_bits_equal(got.valid, want.valid)
        assert bool(got.conflict) == bool(want.conflict)
        tm, tval = shiftnet.layer_masks(ts, tv, **kw)
        jm, jval = jax.jit(lambda s, v: jnet.layer_masks(s, v, **kw))(js, jv)
        assert_bits_equal(tm, jm)
        assert_bits_equal(tval, jval)
        assert_bits_equal(
            shiftnet.apply_layer_masks(x, tm, axis=-1, **kw),
            jax.jit(lambda a, m: jnet.apply_layer_masks(a, m, axis=-1,
                                                        **kw))(jx, jm))


@pytest.mark.parametrize("lead,n", GATHER_GRID)
def test_strided_plans_byte_equal(lead, n):
    """gather_plan / scatter_plan over the reference grid, and the bank's
    32 slots for one window."""
    from repro.core import accessfuse as jaf
    from repro.core import shiftplan as jplan
    for stride, offset in GATHER_SO + SCATTER_SO:
        vl = vl_of(n, stride, offset)
        assert_plans_equal(shiftplan.gather_plan(n, stride, offset, vl),
                           jplan.gather_plan(n, stride, offset, vl))
        assert_plans_equal(shiftplan.scatter_plan(n, stride, offset, vl),
                           jplan.scatter_plan(n, stride, offset, vl))
    vl, off = n // 16, n // 2
    for bank, jbank in ((accessfuse._gather_bank, jaf._gather_bank),
                        (accessfuse._scatter_bank, jaf._scatter_bank)):
        slots, jslots = bank(n, off, vl), jbank(n, off, vl)
        assert len(slots) == len(jslots) == 16
        for tp, jp in zip(slots, jslots):
            assert (tp is None) == (jp is None)
            if tp is not None:
                assert_plans_equal(tp, jp)


# ---------------------------------------------------------------------------
# Plain versions of B3 / B4 / B5 against repro.vx
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,n", GATHER_GRID)
def test_gather_plain_vs_reference(dtype, lead, n):
    """B3's plain version on the whole gather grid against ``repro.vx``
    under ``ref``; B4's on all six (stride, offset) pairs at once."""
    from repro import vx as jvx
    win = rand(0, lead + (n,), dtype)
    jwin = jnp_of(win)
    for stride, offset in GATHER_SO:
        vl = vl_of(n, stride, offset)
        got = strided.gather_strided(win, stride, offset, vl)
        assert_bits_equal(got, jvx.gather(
            jvx.Strided(n=n, stride=stride, offset=offset, vl=vl), jwin,
            policy="ref"))
    vl = min(vl_of(n, s, o) for s, o in GATHER_SO)
    wins = torch.stack([rand(10 + a, lead + (n,), dtype)
                        for a in range(len(GATHER_SO))])
    got = strided.gather_strided_fused(wins, GATHER_SO, vl)
    want = jvx.gather_many([jvx.Strided(n=n, stride=s, offset=o, vl=vl)
                            for s, o in GATHER_SO], jnp_of(wins),
                           policy="ref")
    assert_bits_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,n", SCATTER_GRID)
def test_scatter_plain_vs_reference(dtype, lead, n):
    from repro import vx as jvx
    win = rand(1, lead + (n,), dtype)
    for stride, offset in SCATTER_SO:
        vl = vl_of(n, stride, offset)
        vals = rand(2, lead + (vl,), dtype)
        got = strided.scatter_strided(win, vals, stride, offset)
        assert_bits_equal(got, jvx.scatter(
            jvx.Strided(n=n, stride=stride, offset=offset, vl=vl),
            jnp_of(win), jnp_of(vals), policy="ref"))


@pytest.mark.parametrize("dtype,n,stride,offset", [
    ("float32", 96, 3, 1), ("bfloat16", 128, 2, 1), ("int32", 256, 7, 5)])
def test_plain_vs_pallas_interpret(dtype, n, stride, offset):
    """Against the reference's Pallas kernels themselves (interpret mode):
    the same plans, the same routing, the same bits."""
    from repro import vx as jvx
    vl = vl_of(n, stride, offset)
    spec = jvx.Strided(n=n, stride=stride, offset=offset, vl=vl)
    win = rand(3, (3, n), dtype)
    vals = rand(4, (3, vl), dtype)
    assert_bits_equal(strided.gather_strided(win, stride, offset, vl),
                      jvx.gather(spec, jnp_of(win), policy="pallas"))
    assert_bits_equal(strided.scatter_strided(win, vals, stride, offset),
                      jvx.scatter(spec, jnp_of(win), jnp_of(vals),
                                  policy="pallas"))
    pairs = [(stride, offset), (1, 0), (2, 1)]
    wins = torch.stack([rand(5 + a, (3, n), dtype) for a in range(3)])
    vlf = min(vl_of(n, s, o) for s, o in pairs)
    assert_bits_equal(
        strided.gather_strided_fused(wins, pairs, vlf),
        jvx.gather_many([jvx.Strided(n=n, stride=s, offset=o, vl=vlf)
                         for s, o in pairs], jnp_of(wins), policy="pallas"))


def test_wrapper_contract():
    """Calls counted, no launch on the CPU; a window the access does not
    fit raises ValueError; the dynamic arm (``compiled=False``, policy
    ``kernel_dynamic``) runs and equals the plan arm; tiles raise beyond
    the card's shared memory and otherwise keep at least one row."""
    strided.reset_counts()
    win = rand(0, (4, 96), "float32")
    strided.gather_strided(win, 3, 1, 32)
    strided.scatter_strided(win, rand(1, (4, 32), "float32"), 3, 1)
    strided.gather_strided_fused(torch.stack([win, win]), [(3, 1), (2, 0)],
                                 32)
    assert [f.calls for f in strided.KERNELS] == [1, 1, 1]
    assert [f.launches for f in strided.KERNELS] == [0, 0, 0]
    for bad in ((3, 1, 33), (0, 0, 4), (2, -1, 4), (97, 0, 2)):
        with pytest.raises(ValueError):
            strided.gather_strided(win, *bad)
    with pytest.raises(ValueError):
        strided.scatter_strided(win, rand(1, (4, 33), "float32"), 3, 1)
    assert_bits_equal(strided.gather_strided(win, 3, 1, 32, compiled=False),
                      strided.gather_strided(win, 3, 1, 32))
    assert_bits_equal(vx.gather(vx.Strided(n=96, stride=3, offset=1, vl=32),
                                win, policy="kernel_dynamic"),
                      strided.gather_strided(win, 3, 1, 32))
    from repro_torch.kernels import _common
    # stride 64 at float32: a 4096-lane window is 32 KB per buffer
    assert _common.rows_per_block(32768, 4096, 4, 6144, buffers=2) == 1
    with pytest.raises(ValueError):
        _common.rows_per_block(8, 1 << 15, 8, 64, buffers=2)


# ---------------------------------------------------------------------------
# vx verbs, the plan bank, the scheduler group, LSDO
# ---------------------------------------------------------------------------

HETERO = [(2, 0), (3, 1), (7, 5), (4, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["ref", "kernel", "kernel_dynamic"])
def test_vx_strided_verbs(dtype, impl):
    """gather / scatter (positive and negative static strides) and
    gather_many, homogeneous and heterogeneous, against ``repro.vx``."""
    from repro import vx as jvx
    n, vl = 256, 32
    win = rand(6, (3, 5, n), dtype)
    for stride, offset in [(2, 1), (7, 5), (-3, 200), (-1, 255)]:
        spec = vx.Strided(n=n, stride=stride, offset=offset, vl=vl)
        jspec = jvx.Strided(n=n, stride=stride, offset=offset, vl=vl)
        vals = rand(7, (3, 5, vl), dtype)
        assert_bits_equal(vx.gather(spec, win, policy=impl),
                          jvx.gather(jspec, jnp_of(win), policy="ref"))
        assert_bits_equal(vx.scatter(spec, win, vals, policy=impl),
                          jvx.scatter(jspec, jnp_of(win), jnp_of(vals),
                                      policy="ref"))
    wins = [rand(8 + a, (3, 5, n), dtype) for a in range(4)]
    for pairs in (HETERO, [(3, 1)] * 4):
        specs = [vx.Strided(n=n, stride=s, offset=o, vl=vl) for s, o in pairs]
        jspecs = [jvx.Strided(n=n, stride=s, offset=o, vl=vl)
                  for s, o in pairs]
        got = vx.gather_many(specs, wins, policy=impl)
        assert tuple(got.shape) == (4, 3, 5, vl)
        want = jvx.gather_many(jspecs, [jnp_of(w) for w in wins],
                               policy="ref")
        assert_bits_equal(got, want)
        assert_bits_equal(vx.gather_many(specs, torch.stack(wins),
                                         policy=impl), want)
    assert vx.Strided(n=n, stride=2, vl=vl).bind(win.dtype).key() == \
        jvx.Strided(n=n, stride=2, vl=vl).bind(jnp_of(win).dtype).key()


def test_vx_heterogeneous_group_is_one_fused_call():
    """Four specs sharing (n, vl): ONE fused-gather call (kernel lowering
    pinned on the CPU); identical specs share one plan (one B3 call)."""
    n, vl = 256, 32
    wins = torch.stack([rand(20 + a, (64, n), "float32") for a in range(4)])
    strided.reset_counts()
    vx.gather_many([vx.Strided(n=n, stride=s, offset=o, vl=vl)
                    for s, o in HETERO], wins, policy="kernel")
    vx.gather_many([vx.Strided(n=n, stride=3, offset=1, vl=vl)] * 4, wins,
                   policy="kernel")
    assert (strided.gather_strided_fused.calls,
            strided.gather_strided.calls) == (1, 1)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_bank_runtime_strides(dtype):
    """Runtime (tensor) strides 1..8, -1..-8 and four outside the bank
    (+-11 fit the window, +-13 do not), gather and scatter, against the
    reference's lax.switch bank (traced stride)."""
    import jax
    import jax.numpy as jnp
    from repro import vx as jvx
    n, vl, offset = 256, 12, 130
    win = rand(9, (4, n), dtype)
    spec = vx.Strided(n=n, stride=vx.BANK, vl=vl, offset=offset)
    jspec = jvx.Strided(n=n, stride=jvx.BANK, vl=vl, offset=offset)
    jgather = jax.jit(lambda w, s: jvx.gather(jspec, w, stride=s))
    jscatter = jax.jit(lambda w, v, s: jvx.scatter(jspec, w, v, stride=s))
    for s in list(range(1, 9)) + list(range(-8, 0)) + [11, -11, 13, -13]:
        vals = rand(30 + s, (4, vl), dtype)
        st = torch.tensor(s)
        got = vx.gather(spec, win, stride=st)
        assert_bits_equal(got, jgather(jnp_of(win), jnp.int32(s)))
        assert_bits_equal(vx.scatter(spec, win, vals, stride=st),
                          jscatter(jnp_of(win), jnp_of(vals), jnp.int32(s)))
        if abs(s) != 13:     # a Python int folds into the static spec
            assert_bits_equal(vx.gather(spec, win, stride=s), got)


def test_step_scheduler_strided_group_one_launch():
    """A StepScheduler group of A heterogeneous gather_strided requests
    (above the launch threshold) makes exactly one fused-gather entry call
    and returns each access its own result."""
    from repro_torch.kernels import ref
    n, vl = 256, 32
    wins = [rand(30 + a, (64, n), "float32") for a in range(4)]
    with accessfuse.pinned_kernel_lowering():
        strided.reset_counts()
        sched = accessfuse.StepScheduler(impl="kernel")
        hs = [sched.gather_strided(w, s, o, vl)
              for w, (s, o) in zip(wins, HETERO)]
        sched.flush()
    assert strided.gather_strided_fused.calls == 1
    assert strided.gather_strided.calls == 0
    for w, (s, o), h in zip(wins, HETERO, hs):
        assert_bits_equal(h.value, ref.gather_strided(w, s, o, vl))
    # below the threshold the group rides the plain path: no kernel call
    strided.reset_counts()
    sched = accessfuse.StepScheduler(impl="kernel", platform_policy=False)
    hs = [sched.gather_strided(w[:2], s, o, vl)
          for w, (s, o) in zip(wins, HETERO)]
    sched.flush()
    assert strided.gather_strided_fused.calls == 0
    assert_bits_equal(hs[1].value, ref.gather_strided(wins[1][:2], 3, 1,
                                                      vl))


LSDO_PLANS = [(0, 2, 64, 128), (7, 3, 40, 128), (513, 4, 32, 128),
              (1, -4, 50, 128), (9, 0, 0, 128)]


def test_lsdo_against_reference():
    """Plans, load_strided_many, load_strided and store_strided (batched
    and the dynamic loop) against repro.core.lsdo (jit-compiled: the same
    bits, a fraction of eager JAX's time), including the negative-stride
    and vl=0 cases of tests/test_step_fusion.py."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.core import lsdo as jlsdo
    buf = np.arange(4096, dtype=np.float32) * 5 + 3
    tbuf, jbuf = torch.from_numpy(buf), jnp.asarray(buf)
    extra = [(30, 3, 20, 64), (100, -3, 40, 64)]
    plans = [lsdo.plan_strided(*p) for p in LSDO_PLANS + extra]
    jplans = [jlsdo.plan_strided(*p) for p in LSDO_PLANS + extra]
    for p, jp in zip(plans, jplans):
        assert dataclasses.astuple(p) == dataclasses.astuple(jp)
    many = lsdo.load_strided_many(tbuf, plans[:5])
    want = jax.jit(lambda b: jlsdo.load_strided_many(b, jplans[:5]))(jbuf)
    for o, jo in zip(many, want):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    for i, (p, jp) in enumerate(zip(plans, jplans)):
        vals = np.arange(p.vl, dtype=np.float32) + 1000
        # the dynamic loop on a positive, a negative and an mlen-64 plan
        for batched in (True, False) if i in (1, 3, 6) else (True,):
            load = jax.jit(lambda b: jlsdo.load_strided(b, jp,
                                                        batched=batched))
            store = jax.jit(lambda b, v: jlsdo.store_strided(
                b, v, jp, batched=batched))
            np.testing.assert_array_equal(
                lsdo.load_strided(tbuf, p, batched=batched).numpy(),
                np.asarray(load(jbuf)))
            np.testing.assert_array_equal(
                lsdo.store_strided(tbuf, torch.from_numpy(vals), p,
                                   batched=batched).numpy(),
                np.asarray(store(jbuf, jnp.asarray(vals))))
    segs = lsdo.plan_segment_unit(3, 4, 16, 64)
    jsegs = jlsdo.plan_segment_unit(3, 4, 16, 64)
    assert [dataclasses.astuple(p) for p in segs] == \
        [dataclasses.astuple(p) for p in jsegs]
    assert lsdo.transactions_saved(segs) == jlsdo.transactions_saved(jsegs)


def test_warm_fills_the_bank():
    from repro_torch.vx.cache import PLANS
    vx.warm(192, vl=8, policy="kernel")
    assert ("bank.gather", 192, 0, 8) in PLANS
    assert ("bank.scatter", 192, 0, 8) in PLANS
    assert ("bank.gather", 320, 0, 8) not in PLANS
    vx.warm(320, vl=8, strided=False, policy="kernel")
    assert ("bank.gather", 320, 0, 8) not in PLANS


# ---------------------------------------------------------------------------
# On the card: CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

CARD_DTYPES = ["float32", "bfloat16", "int32", "int8"]
CARD_SO = [(1, 0), (2, 0), (2, 1), (3, 1), (4, 2), (7, 5), (16, 3), (64, 0)]


def card_rand(seed, shape, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if dtype in ("int32", "int8"):
        return torch.randint(-100, 100, shape, generator=g, device=device,
                             dtype=getattr(torch, dtype))
    return torch.randn(shape, generator=g, device=device).to(
        getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("n", [96, 256, 4096])
@pytest.mark.parametrize("rows", [7, 1001])
def test_strided_kernels_match_plain_on_card(cuda_device, dtype, n, rows):
    win = card_rand(1, (rows, n), dtype, cuda_device)
    for stride, offset in CARD_SO:
        if offset >= n:
            continue
        vl = vl_of(n, stride, offset)
        got = strided.gather_strided(win, stride, offset, vl)
        want = strided.gather_strided_plain(win, stride, offset, vl)
        vals = card_rand(2, (rows, vl), dtype, cuda_device)
        got_s = strided.scatter_strided(win, vals, stride, offset)
        want_s = strided.scatter_strided_plain(win, vals, stride, offset)
        torch.cuda.synchronize()
        assert_bits_equal(got, want)
        assert_bits_equal(got_s, want_s)
    for A in (2, 4, 8):
        pairs = [CARD_SO[(a * 3 + A) % len(CARD_SO)] for a in range(A)]
        vl = min(vl_of(n, s, o) for s, o in pairs)
        wins = card_rand(3 + A, (A, rows, n), dtype, cuda_device)
        got = strided.gather_strided_fused(wins, pairs, vl)
        want = strided.gather_strided_fused_plain(wins, pairs, vl)
        torch.cuda.synchronize()
        assert_bits_equal(got, want)
