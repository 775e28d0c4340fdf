"""Port parity for the ``kernel_dynamic`` policy: the dynamic-count arms of
kernels/strided.py (kernels B8 gather, B9 scatter; the fused gather as one
B8 per access) and kernels/segment.py (B6, B7), and the paged serving path
under ``kernel_dynamic``.

On the CPU the wrappers run their plain versions (the GSN / SSN of
core/shiftnet.py on core/scg.py counts); every routing comparison is bit
for bit against the reference's own dynamic Pallas bodies
(``compiled=False`` / ``fused=False``, interpret mode):

* on the strided grid of tests/test_kernels_vs_ref.py, the reference
  routes a payload of element numbers (int32, ``1 + flat index``) once per
  geometry, and each dtype's port output must equal its input taken
  through that map (0 marks a lane the network fills with 0).  Each
  Pallas interpret compile costs about half a second, so one run per
  geometry keeps the file near a minute; the segment grid lives in
  tests/test_torch_segment.py for the same reason;
* a few cases per arm run the reference on the dtype itself.

Serving: the CPU serve under ``kernel_dynamic`` gives the reference's
greedy streams; a paged trace keeps the page bookkeeping equal at every
step and the logits within rtol/atol 1e-5 (XLA and torch sum the float32
matmuls in different orders); one dynamic split call per decode step when
the kernel lowering is pinned.

The ``cuda`` cases hold B6-B9 against their plain versions and their plan
twins on the card, and the device derivation against
``shiftnet.layer_masks``; they skip without one (JAX is imported inside
the tests that need it: ``python -m pytest -m cuda
tests/test_torch_dynamic.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, cuda_device  # noqa: F401
from repro_torch.core import accessfuse, scg, shiftnet
from repro_torch.kernels import _common, segment, strided

DTYPES = ["float32", "bfloat16", "int32"]
GATHER_GRID = [((), 128), ((4,), 64), ((2, 3), 256), ((5,), 96), ((8,), 512)]
GATHER_SO = [(2, 0), (3, 1), (4, 2), (7, 5), (1, 0), (16, 3)]
SCATTER_GRID = [((), 128), ((4,), 64), ((3, 2), 256)]
SCATTER_SO = [(2, 0), (3, 1), (5, 4), (1, 0)]


def rand(seed, shape, dtype):
    """numpy-seeded input; bfloat16 through float32, with -0.0 and NaN
    lanes so raw bits are what must move.  The NaN is the quiet NaN XLA
    keeps (XLA on the CPU rewrites other bfloat16 NaN payloads)."""
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


def jnp_of(t):
    import jax.numpy as jnp
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def numbered(shape):
    """int32 payload ``1 + flat index``: routed by the reference, it
    records which input element each output lane holds."""
    return np.arange(1, int(np.prod(shape)) + 1, dtype=np.int32).reshape(
        shape)


def take(sources, x):
    """``x``'s elements (flattened) at the reference's element numbers;
    number 0 is a lane the network fills with 0."""
    idx = torch.from_numpy(np.asarray(sources, np.int64))
    flat = torch.cat([torch.zeros(1, dtype=x.dtype), x.reshape(-1)])
    return flat[idx.reshape(-1)].reshape(idx.shape)


def vl_of(n, stride, offset):
    return (n - 1 - offset) // stride + 1


# ---------------------------------------------------------------------------
# Strided arms on the reference grid (B8, B9, the fused gather)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead,n", GATHER_GRID)
def test_gather_dynamic_vs_reference_grid(lead, n):
    """``gather_strided(compiled=False)`` and ``gather_strided_fused(
    compiled=False)`` against the reference's dynamic bodies on every
    (stride, offset) and dtype of the gather grid."""
    import jax.numpy as jnp
    from repro.kernels import strided as jstrided
    shape = lead + (n,)
    ids = jnp.asarray(numbered(shape))
    wins = {dt: rand(0, shape, dt) for dt in DTYPES}
    for stride, offset in GATHER_SO:
        vl = vl_of(n, stride, offset)
        src = jstrided.gather_strided(ids, stride, offset, vl,
                                      compiled=False)
        for dt, win in wins.items():
            assert_bits_equal(
                strided.gather_strided(win, stride, offset, vl,
                                       compiled=False), take(src, win))
    # the fused gather: A windows, each its own (stride, offset)
    pairs = GATHER_SO[:3]
    vl = min(vl_of(n, s, o) for s, o in pairs)
    fshape = (len(pairs),) + shape
    src = jstrided.gather_strided_fused(jnp.asarray(numbered(fshape)),
                                        pairs, vl, compiled=False)
    for dt in DTYPES:
        w = rand(1, fshape, dt)
        assert_bits_equal(
            strided.gather_strided_fused(w, pairs, vl, compiled=False),
            take(src, w))


@pytest.mark.parametrize("lead,n", SCATTER_GRID)
def test_scatter_dynamic_vs_reference_grid(lead, n):
    """``scatter_strided(compiled=False)`` against the reference's dynamic
    body: values and window numbered apart, so the map says which of the
    two each output lane holds."""
    import jax.numpy as jnp
    from repro.kernels import strided as jstrided
    shape = lead + (n,)
    size = int(np.prod(shape))
    for stride, offset in SCATTER_SO:
        vl = vl_of(n, stride, offset)
        vshape = lead + (vl,)
        src = jstrided.scatter_strided(
            jnp.asarray(numbered(shape)),
            jnp.asarray(numbered(vshape) + size), stride, offset,
            compiled=False)
        for dt in DTYPES:
            win, vals = rand(2, shape, dt), rand(3, vshape, dt)
            both = torch.cat([win.reshape(-1), vals.reshape(-1)])
            assert_bits_equal(
                strided.scatter_strided(win, vals, stride, offset,
                                        compiled=False), take(src, both))


@pytest.mark.parametrize("arm", ["gather", "fused", "scatter",
                                 "deinterleave", "interleave"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dynamic_arms_vs_reference_dtype(arm, dtype):
    """Each of the five dynamic arms against the reference's Pallas body
    run on the dtype itself (interpret mode), n not a multiple of 32."""
    from repro.kernels import segment as jseg
    from repro.kernels import strided as jstrided
    if arm in ("gather", "fused", "scatter"):
        n, pairs = 96, [(3, 1), (2, 0)]
        vl = min(vl_of(n, s, o) for s, o in pairs)
        win = rand(4, (5, n), dtype)
        if arm == "gather":
            got = strided.gather_strided(win, 3, 1, vl, compiled=False)
            want = jstrided.gather_strided(jnp_of(win), 3, 1, vl,
                                           compiled=False)
        elif arm == "fused":
            wins = rand(5, (2, 5, n), dtype)
            got = strided.gather_strided_fused(wins, pairs, vl,
                                               compiled=False)
            want = jstrided.gather_strided_fused(jnp_of(wins), pairs, vl,
                                                 compiled=False)
        else:
            vals = rand(6, (5, vl), dtype)
            got = strided.scatter_strided(win, vals, 3, 1, compiled=False)
            want = jstrided.scatter_strided(jnp_of(win), jnp_of(vals), 3, 1,
                                            compiled=False)
        assert_bits_equal(got, want)
        return
    fields, m = 3, 32
    if arm == "deinterleave":
        aos = rand(7, (2, 2, fields * m), dtype)
        for g, w in zip(segment.deinterleave(aos, fields, fused=False),
                        jseg.deinterleave(jnp_of(aos), fields,
                                          fused=False)):
            assert_bits_equal(g, w)
    else:
        soa = [rand(8 + f, (2, 2, m), dtype) for f in range(fields)]
        assert_bits_equal(segment.interleave(soa, fused=False),
                          jseg.interleave([jnp_of(s) for s in soa],
                                          fused=False))


def test_dynamic_wrappers_count_and_contract():
    """The dispatchers count their own call and the dynamic wrapper's; on
    the CPU no kernel launches; a window the access does not fit raises
    before any routing; the dynamic tiles count the network's shared
    memory."""
    segment.reset_counts()
    strided.reset_counts()
    win = rand(0, (4, 96), "float32")
    strided.gather_strided(win, 3, 1, 32, compiled=False)
    strided.gather_strided_fused(torch.stack([win, win]), [(3, 1), (2, 0)],
                                 32, compiled=False)
    strided.scatter_strided(win, rand(1, (4, 32), "float32"), 3, 1,
                            compiled=False)
    segment.deinterleave(win, 3, fused=False)
    segment.interleave([win, win], fused=False)
    assert [f.calls for f in strided.KERNELS] == [1, 1, 1]
    # the fused gather is one B8 call per access, as the reference loops
    assert [f.calls for f in strided.DYNAMIC] == [3, 1]
    assert [f.calls for f in segment.KERNELS + segment.DYNAMIC] == \
        [1, 1, 1, 1]
    assert all(f.launches == 0 for f in strided.KERNELS + strided.DYNAMIC
               + segment.KERNELS + segment.DYNAMIC)
    for bad in ((3, 1, 33), (0, 0, 4), (2, -1, 4), (97, 0, 2)):
        with pytest.raises(ValueError):
            strided.gather_strided(win, *bad, compiled=False)
    with pytest.raises(ValueError):
        segment.deinterleave(win, 5, fused=False)
    # n = 4096: 12 layers of masks plus the count scratch, 40640 bytes
    assert _common.dyn_net_bytes(4096) == 40640
    assert _common.rows_per_block(32768, 4096, 2, 40640, buffers=2) == 1
    assert _common.dyn_net_bytes(1) == 32


# ---------------------------------------------------------------------------
# Serving under kernel_dynamic
# ---------------------------------------------------------------------------

N_REQ, PROMPT_LEN, GEN, MAX_LEN = 3, 8, 6, 64


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    from repro.configs import get_arch as jget_arch
    from repro.models.transformer import init_params as jinit
    cfg = jget_arch("qwen3-0.6b").smoke
    return cfg, jinit(cfg, jax.random.key(0))


def _port(impl):
    from _torch_bridge import jax_tree_to_np
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import params_from_jax
    _, jparams = _jax()
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl=impl)
    return cfg, params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")


def _serve(sched, prompts):
    reqs = [sched.submit(p, max_new_tokens=GEN) for p in prompts]
    for _ in range(200):
        sched.tick()
        if sched.drained():
            break
    assert sched.drained()
    return [r.tokens for r in reqs]


def test_serve_kernel_dynamic_streams_match_reference():
    """The ci.yml smoke served by the port under ``kernel_dynamic`` gives
    the reference scheduler's greedy streams; the dynamic arms (prefill's
    KV re-pack and GLU split) are really taken."""
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Scheduler
    jcfg, jparams = _jax()
    cfg, params = _port("kernel_dynamic")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, PROMPT_LEN).tolist()
               for _ in range(N_REQ)]
    want = _serve(JScheduler(jcfg, jparams, slots=N_REQ, max_len=MAX_LEN),
                  prompts)
    segment.reset_counts()
    got = _serve(Scheduler(cfg, params, slots=N_REQ, max_len=MAX_LEN,
                           device="cpu"), prompts)
    assert got == want
    assert segment.deinterleave_dynamic.calls > 0
    assert segment.interleave_dynamic.calls > 0
    assert segment.deinterleave_dynamic.launches == 0     # never on the CPU


def test_paged_trace_kernel_dynamic_matches_reference():
    """Prefill chunks and fused decode steps under ``kernel_dynamic``,
    with the kernel lowering pinned so the step's fused KV split takes the
    dynamic arm: page bookkeeping equal to the reference's after every
    call, logits within 1e-5, greedy tokens equal, and exactly one dynamic
    split call per decode step."""
    import jax
    import jax.numpy as jnp
    from _torch_bridge import to_torch
    from repro.models import decode as jdec
    from repro_torch.models import decode as tdec
    jcfg, jparams = _jax()
    tcfg, tparams = _port("kernel_dynamic")
    ps, slots, max_len = 4, 3, 64      # the fused split clears the threshold
    jstep = jax.jit(lambda p, c, t, a: jdec.paged_decode_step(
        p, c, t, jcfg, None, active=a))
    jchunk = jax.jit(lambda p, c, t, s, n: jdec.paged_prefill_chunk(
        p, c, t, jcfg, None, slot=s, count=n))
    jc = jdec.init_paged_cache(jcfg, slots, max_len, ps, jnp.float32)
    tc = tdec.init_paged_cache(tcfg, slots, max_len, ps, torch.float32,
                               device="cpu")

    def same_state():
        for k in ("table", "free", "free_top", "ref", "pos"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                          err_msg=k)

    prompts = {0: [5, 17, 3, 99, 42, 7], 1: [11, 250, 8]}
    cur = {}
    for s, prompt in prompts.items():
        pre = prompt[:-1]
        for c in range(0, len(pre), ps):
            n = min(ps, len(pre) - c)
            toks = np.asarray(pre[c:c + n] + [0] * (ps - n), np.int32)
            jc = jchunk(jparams, jc, jnp.asarray(toks), s, n)
            tc = tdec.paged_prefill_chunk(tparams, tc, to_torch(toks), tcfg,
                                          slot=s, count=n)
            same_state()
        cur[s] = prompt[-1]
    act = np.asarray([s in cur for s in range(slots)])
    for _ in range(4):
        tok = np.asarray([cur.get(s, 0) for s in range(slots)], np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(act))
        segment.reset_counts()
        with accessfuse.pinned_kernel_lowering():
            tl, tc = tdec.paged_decode_step(tparams, tc, to_torch(tok), tcfg,
                                            active=to_torch(act))
        assert segment.deinterleave_dynamic.calls == 1
        assert segment.deinterleave.calls == 1
        assert segment.interleave.calls == 0
        same_state()
        for s in cur:
            np.testing.assert_allclose(tl[s].numpy(), np.asarray(jl[s]),
                                       rtol=1e-5, atol=1e-5)
            want = int(jnp.argmax(jl[s]))
            assert int(torch.argmax(tl[s])) == want
            cur[s] = want


# ---------------------------------------------------------------------------
# On the card: B6-B9 against their plain versions and their plan twins
# ---------------------------------------------------------------------------

CARD_DTYPES = ["float32", "bfloat16", "int32", "int8"]
CARD_SO = [(1, 0), (2, 0), (2, 1), (3, 1), (4, 2), (7, 5), (16, 3), (64, 0)]


def card_rand(seed, shape, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if dtype in ("int32", "int8"):
        return torch.randint(-100, 100, shape, generator=g, device=device,
                             dtype=getattr(torch, dtype))
    x = torch.randn(shape, generator=g, device=device)
    x.view(-1)[::7] = -0.0
    x.view(-1)[3::11] = float("nan")
    return x.to(getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("fields", [2, 3, 4, 8])
@pytest.mark.parametrize("rows,width", [(7, 6144), (1000, 256), (5, 96)])
def test_segment_dynamic_kernels_on_card(cuda_device, dtype, fields, rows,
                                         width):
    m = width // fields
    n = fields * m
    aos = card_rand(1, (rows, n), dtype, cuda_device)
    got = segment.deinterleave(aos, fields, fused=False)
    want = segment.deinterleave_dynamic_plain(aos, fields)
    twin = segment.deinterleave(aos, fields)
    soa = [card_rand(2 + f, (rows, m), dtype, cuda_device)
           for f in range(fields)]
    got_i = segment.interleave(soa, fused=False)
    want_i = segment.interleave_dynamic_plain(soa)
    twin_i = segment.interleave(soa)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, twin):
        assert_bits_equal(g, w)
        assert_bits_equal(g, t)
    assert_bits_equal(got_i, want_i)
    assert_bits_equal(got_i, twin_i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("n", [96, 256, 4096])
@pytest.mark.parametrize("rows", [7, 1001])
def test_strided_dynamic_kernels_on_card(cuda_device, dtype, n, rows):
    win = card_rand(1, (rows, n), dtype, cuda_device)
    for stride, offset in CARD_SO:
        if offset >= n:
            continue
        vl = vl_of(n, stride, offset)
        vals = card_rand(2, (rows, vl), dtype, cuda_device)
        got = strided.gather_strided(win, stride, offset, vl, compiled=False)
        got_s = strided.scatter_strided(win, vals, stride, offset,
                                        compiled=False)
        torch.cuda.synchronize()
        assert_bits_equal(got, strided.gather_strided_dynamic_plain(
            win, stride, offset, vl))
        assert_bits_equal(got, strided.gather_strided(win, stride, offset,
                                                      vl))
        assert_bits_equal(got_s, strided.scatter_strided_dynamic_plain(
            win, vals, stride, offset))
        assert_bits_equal(got_s, strided.scatter_strided(win, vals, stride,
                                                         offset))
    pairs = [(2, 0), (3, 1), (7, 5)]
    vl = min(vl_of(n, s, o) for s, o in pairs)
    wins = card_rand(3, (3, rows, n), dtype, cuda_device)
    assert_bits_equal(
        strided.gather_strided_fused(wins, pairs, vl, compiled=False),
        strided.gather_strided_fused(wins, pairs, vl))


@pytest.mark.cuda
@pytest.mark.parametrize("n,stride,offset", [(96, 3, 1), (256, 2, 1),
                                             (4096, 64, 0), (1, 1, 0)])
def test_device_derivation_matches_layer_masks(cuda_device, n, stride,
                                               offset):
    vl = vl_of(n, stride, offset)
    for gather in (True, False):
        masks, occ = strided.dynamic_masks(n, stride, offset, vl,
                                           gather=gather, blocks=3)
        counts = scg.gather_counts if gather else scg.scatter_counts
        shift, valid = counts(n, stride, offset, vl)
        want, want_occ = shiftnet.layer_masks(
            shift, valid, toward_zero=gather, lsb_first=gather)
        words = -(-n // 32)
        packed = (_common.pack_bits(want.numpy()).view(np.int32)
                  if want.shape[0] else np.zeros((0, words), np.int32))
        np.testing.assert_array_equal(masks.cpu().numpy(), packed)
        np.testing.assert_array_equal(
            occ.cpu().numpy(),
            _common.pack_bits(want_occ.numpy()[None]).view(np.int32)[0])
