"""Port parity for the quantized paged KV pool: int8 / fp8 pages with
per-page, per-head float32 scales.

Lowering: ``vx.gather`` / ``vx.scatter`` / ``vx.gather_many`` with
``scales=`` against ``repro.vx`` on numpy-seeded pools, bit for bit (pool
bytes and scales), at int8 and fp8, with duplicate physical pages,
dropped rows (``pos < 0``, ``pos`` past the end, unallocated pages) and
the monotone widen over several appends; and the reference's own
lowering cases (``tests/test_quant_pool.py``).  Decode: the quantized
prefill insert against the reference bit for bit; the quantized
``paged_prefill_chunk`` / ``paged_decode_step`` against the reference's
within the reference's own bound ``max(0.08, 0.03 * |logits|max)``, with
page bookkeeping equal and pool values within one quantization step (XLA
and torch sum matmuls in other orders, so a k/v value near a rounding
boundary can land one step apart); the fused and per-access quantized
steps bit for bit; one fused split per step, read from the port's call
counter with the kernel lowering pinned.  Prefix interop at the decode
level: the fork copies the page's scale and leaves the source unchanged;
adopt / fork / addref / deref bookkeeping and ``paged_invariants``
against the reference's.  The reference's chaos and fleet gates at int8:
seeded chaos (preemption replays through quantize-on-write from scratch)
and fleet chaos (migration by replay into a fresh quantized pool)
terminate every request typed with the scale-extended audit every tick;
these hold the port to the reference's properties, not to its streams,
since a quantized step is held to the reference's only within the bound
above."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, jax_tree_to_np, to_torch
from repro import vx as jvx
from repro.configs import get_arch as jget_arch
from repro.core import quant as jquant
from repro.models import decode as jdec
from repro.models.transformer import ModelConfig as JModelConfig
from repro.models.transformer import init_params as jinit
from repro.serve.paged_cache import PagedCache as JPagedCache
from repro_torch import vx
from repro_torch.configs.base import get_arch
from repro_torch.core import accessfuse, quant
from repro_torch.kernels import segment
from repro_torch.models import decode as dec
from repro_torch.models.transformer import ModelConfig, params_from_jax
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.scheduler import Scheduler

DTYPES = ("int8", "fp8")
JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _bound(logits) -> float:
    """The reference's gate on a quantized step's logits."""
    return max(0.08, 0.03 * float(np.abs(np.asarray(logits)).max()))


def _cfg_kw(layers=2, hd=16, impl="ref", positions=2, mlp="none", d_ff=0):
    return dict(name="quant-test", d_model=2 * hd, n_layers=layers,
                n_heads=2, n_kv_heads=2, d_ff=d_ff, vocab=97, head_dim=hd,
                mlp=mlp, block_pattern=("attn",) * positions,
                window_pattern=(None,) * positions,
                moe_pattern=(False,) * positions, scan_layers=False,
                kernel_impl=impl, remat="none")


@functools.lru_cache(maxsize=None)
def _small(layers=2, hd=16, impl="ref"):
    """The reference's small quant-test model and the port's, with the
    reference's weights."""
    jcfg = JModelConfig(**_cfg_kw(layers, hd))
    jparams = jinit(jcfg, jax.random.key(0))
    cfg = ModelConfig(**_cfg_kw(layers, hd, impl))
    return jcfg, jparams, cfg, params_from_jax(jax_tree_to_np(jparams), cfg,
                                               device="cpu")


@functools.lru_cache(maxsize=None)
def _smoke():
    jcfg = jget_arch("qwen3-0.6b").smoke
    jparams = jinit(jcfg, jax.random.key(0))
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl="ref")
    return jcfg, jparams, cfg, params_from_jax(jax_tree_to_np(jparams), cfg,
                                               device="cpu")


def _tpool(jpool) -> torch.Tensor:
    """A reference pool's bytes as the port's pool of the same dtype."""
    a = np.asarray(jpool)
    dt = torch.int8 if a.dtype == np.int8 else torch.float8_e4m3fn
    return torch.from_numpy(a.view(np.uint8).copy()).view(dt)


def _pool_bits(pool) -> np.ndarray:
    if isinstance(pool, torch.Tensor):
        return quant.raw(pool).numpy().view(np.uint8)
    return np.asarray(pool).view(np.uint8)


def _steps_apart(a, b) -> int:
    """Largest distance in codes between the port's int8 / fp8 pool ``a``
    and the reference's ``b`` (fp8 codes ordered through sign and
    magnitude)."""
    is_int8 = a.dtype == torch.int8

    def ordinal(pool):
        c = _pool_bits(pool).astype(np.int32)
        if is_int8:
            return np.where(c & 0x80, c - 256, c)
        return np.where(c & 0x80, -(c & 0x7F), c & 0x7F)
    return int(np.abs(ordinal(a) - ordinal(b)).max())


def _random_pool(dt, shape, seed):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(size=shape) * 60, -127, 127).astype(np.float32)
    return jquant.requantize(jnp.asarray(x), JDT[dt] if dt == "int8"
                             else jnp.float8_e4m3fn)


# ---------------------------------------------------------------------------
# vx lowering against the reference, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
def test_quantized_gather_matches_reference(dt):
    ps, pages, P, K, D = 4, 3, 8, 2, 6
    jpool = _random_pool(dt, (P, ps, K, D), 0)
    scales = np.random.default_rng(1).uniform(0.01, 2.0, (P, K)).astype(
        np.float32)
    scales[6] = 0.0                                  # a never-written page
    table = np.asarray([[2, 0, -1], [5, -1, 6], [-1, -1, -1]], np.int32)
    jspec = jvx.Paged(page_size=ps, pages=pages, trail=2)
    spec = vx.Paged(page_size=ps, pages=pages, trail=2)
    want = jvx.gather(jspec, jpool, table=jnp.asarray(table),
                      scales=jnp.asarray(scales))
    got = vx.gather(spec, _tpool(jpool), table=to_torch(table),
                    scales=to_torch(scales))
    assert got.dtype == torch.float32
    assert_bits_equal(got, want)
    # the fused form: two stacked (NS, P, ...) pools, one table
    jpools = [jnp.stack([_random_pool(dt, (P, ps, K, D), s)
                         for s in (2, 3)]) for _ in range(2)]
    jscl = [jnp.asarray(np.random.default_rng(4 + a).uniform(
        0.0, 1.0, (2, P, K)).astype(np.float32)) for a in range(2)]
    want = jvx.gather_many(jspec, jpools, table=jnp.asarray(table),
                           scales=jscl)
    got = vx.gather_many(spec, [_tpool(p) for p in jpools],
                         table=to_torch(table),
                         scales=[to_torch(np.asarray(s)) for s in jscl])
    for g, w in zip(got, want):
        assert_bits_equal(g, w)


def test_quantized_gather_matches_manual_dequant():
    """out = pool[table].float() * the page's per-head scale, zeros
    through unallocated entries."""
    rng = np.random.default_rng(0)
    ps, pages, P, K, D = 4, 3, 8, 2, 6
    pool = torch.from_numpy(rng.integers(-127, 128, (P, ps, K, D)).astype(
        np.int8))
    scales = torch.from_numpy(rng.uniform(0.01, 2.0, (P, K)).astype(
        np.float32))
    out = vx.gather(vx.Paged(page_size=ps, pages=pages, trail=2), pool,
                    table=torch.tensor([[2, 0, -1], [5, -1, -1]]),
                    scales=scales)
    assert out.shape == (2, pages * ps, K, D) and out.dtype == torch.float32
    pn = pool.float() * scales[:, None, :, None]
    want = torch.zeros((2, pages * ps, K, D))
    want[0, :4], want[0, 4:8], want[1, :4] = pn[2], pn[0], pn[5]
    assert torch.equal(out, want)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
def test_quantized_scatter_matches_reference(dt, vdtype):
    """Five appends of 7 rows: two rows on one physical page (offsets 2
    and 3), a row past the end, a row with pos < 0, a row on an
    unallocated page, and a beat that grows every step (the scale widens
    and the residents are rescaled).  Pool bytes and scales bit for bit
    after every append; values in float32 and in bfloat16 (the full-width
    step's beats)."""
    ps, pages, P, K, D = 4, 2, 6, 2, 3
    jspec = jvx.Paged(page_size=ps, pages=pages, trail=2)
    spec = vx.Paged(page_size=ps, pages=pages, trail=2)
    table = np.asarray([[1, -1], [3, 0], [-1, -1], [1, -1], [1, -1],
                        [3, 0], [2, 4]], np.int32)
    jpool = jnp.zeros((P, ps, K, D), JDT[dt])
    jscl = jnp.zeros((P, K), jnp.float32)
    pool = torch.zeros((P, ps, K, D), dtype=quant.pool_dtype(dt))
    scl = torch.zeros((P, K))
    rng = np.random.default_rng(5)
    for step in range(5):
        pos = np.asarray([2, 5, -1, 3, 9, 4 + (step % 3), step], np.int32)
        vals = (rng.normal(size=(7, K, D)) * (step + 1) ** 2).astype(
            np.float32)
        jv = jnp.asarray(vals).astype(getattr(jnp, vdtype))
        jpool, jscl = jvx.scatter(jspec, jpool, jv, table=jnp.asarray(table),
                                  pos=jnp.asarray(pos), scales=jscl)
        out = vx.scatter(spec, pool, to_torch(np.asarray(jv)),
                         table=to_torch(table), pos=to_torch(pos),
                         scales=scl)
        assert out[0] is pool and out[1] is scl          # in place
        np.testing.assert_array_equal(_pool_bits(pool), _pool_bits(jpool))
        assert_bits_equal(scl, jscl)
    assert float(scl[5].abs().max()) == 0.0              # never written


def test_quantized_scatter_roundtrips_within_bound():
    ps, pages, P, K, D = 4, 2, 6, 2, 3
    pool = torch.zeros((P, ps, K, D), dtype=torch.int8)
    scales = torch.zeros((P, K))
    spec = vx.Paged(page_size=ps, pages=pages, trail=2)
    table = torch.tensor([[1, -1], [3, 0], [-1, -1]], dtype=torch.int32)
    vals = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, K, D)).astype(np.float32))
    pos = torch.tensor([2, 5, -1], dtype=torch.int32)
    npool, nscl = vx.scatter(spec, pool, vals, table=table, pos=pos,
                             scales=scales)
    assert npool.dtype == torch.int8 and nscl.shape == (P, K)
    got = npool.float() * nscl[:, None, :, None]
    for row, (pg, off) in ((0, (1, 2)), (1, (0, 1))):
        bound = quant.error_bound("int8", float(vals[row].abs().max()))
        assert float((got[pg, off] - vals[row]).abs().max()) <= \
            bound * 1.001
    assert float(got[1, 3].abs().max()) == 0.0
    untouched = np.delete(nscl.numpy(), [0, 1, 3], axis=0)
    np.testing.assert_array_equal(untouched, 0.0)


def test_quantized_scatter_duplicate_physical_page_is_safe():
    ps, pages, P, K, D = 4, 2, 4, 2, 3
    pool = torch.zeros((P, ps, K, D), dtype=torch.int8)
    scales = torch.zeros((P, K))
    spec = vx.Paged(page_size=ps, pages=pages, trail=2)
    table = torch.tensor([[2, -1], [2, -1]], dtype=torch.int32)
    vals = torch.tensor([[[0.1] * D] * K, [[50.0] * D] * K])
    npool, nscl = vx.scatter(spec, pool, vals, table=table,
                             pos=torch.tensor([0, 1]), scales=scales)
    got = npool.float() * nscl[:, None, :, None]
    np.testing.assert_allclose(got[2, 1].numpy(), 50.0, rtol=1e-2)
    assert float((got[2, 0] - 0.1).abs().max()) <= \
        quant.error_bound("int8", 50.0) * 1.001


def test_quantized_scatter_scale_widens_monotonically():
    ps, pages, P, K, D = 4, 1, 2, 1, 2
    pool = torch.zeros((P, ps, K, D), dtype=torch.int8)
    scales = torch.zeros((P, K))
    spec = vx.Paged(page_size=ps, pages=pages, trail=2)
    table = torch.tensor([[0]], dtype=torch.int32)
    hist = []
    for step, mag in enumerate([0.5, 8.0, 2.0]):
        vx.scatter(spec, pool, torch.full((1, K, D), mag), table=table,
                   pos=torch.tensor([step]), scales=scales)
        hist.append(float(scales[0, 0]))
    assert hist == sorted(hist)
    assert hist[-1] == pytest.approx(8.0 / 127.0)
    got = pool.float()[0, :, 0, 0] * hist[-1]
    assert abs(got[0] - 0.5) <= 2 * quant.error_bound("int8", 8.0)
    assert abs(got[1] - 8.0) <= quant.error_bound("int8", 8.0) * 1.001
    assert abs(got[2] - 2.0) <= quant.error_bound("int8", 8.0) * 1.001


def test_quantized_spec_is_its_own_plan_entry():
    """``scale_dtype`` is part of the spec, and so of the plan-cache key:
    the quantized program is an entry of its own, and a quantized spec
    without ``scales=`` is refused."""
    spec = vx.Paged(page_size=4, pages=2, trail=2)
    assert spec.seq_len == 8 and not spec.quantized
    q = dataclasses.replace(spec, scale_dtype=torch.float32)
    assert q.quantized and q.scale_dtype == "float32"
    assert q.key() != spec.key()
    assert vx.Segment(n=256, fields=2).field_len == 128
    pool = torch.zeros((4, 4, 2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="scales="):
        vx.gather(q, pool, table=torch.zeros((1, 2), dtype=torch.int32))
    vx.gather(spec, pool, table=torch.zeros((1, 2), dtype=torch.int32),
              scales=torch.zeros((4, 2)))
    misses = vx.PLANS.stats()["misses"]
    vx.gather(spec, pool, table=torch.zeros((1, 2), dtype=torch.int32),
              scales=torch.zeros((4, 2)))
    assert vx.PLANS.stats()["misses"] == misses


# ---------------------------------------------------------------------------
# decode against the reference
# ---------------------------------------------------------------------------

def _state_equal(tc, jc):
    for k in ("table", "free", "free_top", "ref", "pos"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                      err_msg=k)


@pytest.mark.parametrize("dt", DTYPES)
def test_quantized_insert_prefill_matches_reference(dt):
    jcfg, _, cfg, _ = _small()
    jc = jdec.init_paged_cache(jcfg, 3, 32, 4, jnp.float32, quantize=dt)
    tc = dec.init_paged_cache(cfg, 3, 32, 4, quantize=dt, device="cpu")
    states = {f"pos{i}": np.random.default_rng(7 + i).normal(
        size=(jcfg.n_superblocks, 1, 6, 2, 32)).astype(np.float32) * 3
        for i in range(2)}
    jc = jdec.paged_insert_prefill(
        jcfg, jc, 1, {k: jnp.asarray(v) for k, v in states.items()}, 6, 6)
    tc = dec.paged_insert_prefill(
        cfg, tc, 1, {k: to_torch(v) for k, v in states.items()}, 6, 6)
    _state_equal(tc, jc)
    for k in tc["blocks"]:
        np.testing.assert_array_equal(_pool_bits(tc["blocks"][k]),
                                      _pool_bits(jc["blocks"][k]), k)
    assert dec.paged_invariants(cfg, tc) == jdec.paged_invariants(jcfg, jc)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("fuse", [True, False])
def test_quantized_step_matches_reference(dt, fuse):
    """Chunked prefill of two slots (mid-page starts, a short chunk), then
    8 forced-teacher decode steps on the reference's tokens with one slot
    idle for two steps: bookkeeping equal after every call, logits within
    the reference's bound of the reference's quantized step and, at int8,
    of the port's own float32 pool (the reference holds fp8 to the float
    oracle with no bound: its e4m3 steps are 16x int8's at the top), pool
    values within one step, scales within float32 rounding of the
    reference's."""
    jcfg, jparams, tcfg, tparams = _smoke()
    jc = jdec.init_paged_cache(jcfg, 2, 32, 4, jnp.float32, quantize=dt)
    tc = dec.init_paged_cache(tcfg, 2, 32, 4, quantize=dt, device="cpu")
    fc = dec.init_paged_cache(tcfg, 2, 32, 4, device="cpu")
    jchunk = jax.jit(lambda c, t, s, n: jdec.paged_prefill_chunk(
        jparams, c, t, jcfg, None, slot=s, count=n))
    jstep = jax.jit(lambda c, t, a: jdec.paged_decode_step(
        jparams, c, t, jcfg, None, active=a, fuse=fuse))
    rng = np.random.default_rng(11)
    for slot, n in ((0, 4), (1, 3), (0, 2), (1, 4)):
        toks = np.zeros(4, np.int32)
        toks[:n] = rng.integers(0, jcfg.vocab, n)
        jc = jchunk(jc, jnp.asarray(toks), jnp.int32(slot), jnp.int32(n))
        for c in (tc, fc):
            c.update(dec.paged_prefill_chunk(tparams, c, to_torch(toks),
                                             tcfg, slot=slot, count=n))
        _state_equal(tc, jc)
    tok = np.asarray([5, 9], np.int32)
    for step in range(8):
        act = np.asarray([True, step not in (2, 3)])
        jl, jc = jstep(jc, jnp.asarray(tok), jnp.asarray(act))
        tl, tc = dec.paged_decode_step(tparams, tc, to_torch(tok), tcfg,
                                       active=to_torch(act), fuse=fuse)
        fl, fc = dec.paged_decode_step(tparams, fc, to_torch(tok), tcfg,
                                       active=to_torch(act), fuse=fuse)
        _state_equal(tc, jc)
        assert float((tl - to_torch(np.asarray(jl))).abs().max()) \
            <= _bound(jl)
        if dt == "int8":      # the reference holds only int8 to it
            assert float((tl - fl).abs().max()) <= _bound(fl)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for i in range(tcfg.sb_len):
        assert _steps_apart(tc["blocks"][f"pos{i}"],
                            jc["blocks"][f"pos{i}"]) <= 1
        np.testing.assert_allclose(tc["blocks"][f"scl{i}"].numpy(),
                                   np.asarray(jc["blocks"][f"scl{i}"]),
                                   rtol=1e-5, atol=0)
    assert dec.paged_invariants(tcfg, tc) == []


@pytest.mark.parametrize("ps,slots", [(4, 1), (4, 3), (8, 3), (16, 1)])
def test_quantized_decode_tracks_float_oracle(ps, slots):
    _, _, cfg, params = _small()
    cf = dec.init_paged_cache(cfg, slots, 32, ps, device="cpu")
    cq = dec.init_paged_cache(cfg, slots, 32, ps, quantize="int8",
                              device="cpu")
    tok = torch.arange(3, 3 + slots, dtype=torch.int32)
    worst = 0.0
    for _ in range(9):
        lf, cf = dec.paged_decode_step(params, cf, tok, cfg, fuse=True)
        lq, cq = dec.paged_decode_step(params, cq, tok, cfg, fuse=True)
        worst = max(worst, float((lf - lq).abs().max()))
        tok = torch.argmax(lf, -1).to(torch.int32)
    assert worst <= _bound(lf), worst
    assert not dec.paged_invariants(cfg, cq)


@pytest.mark.parametrize("dt", DTYPES)
def test_quantized_fused_equals_unfused_bit_exact(dt):
    _, _, cfg, params = _small()
    cm = {f: dec.init_paged_cache(cfg, 2, 32, 8, quantize=dt, device="cpu")
          for f in (True, False)}
    tok = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(6):
        outs = {}
        for f in (True, False):
            outs[f], cm[f] = dec.paged_decode_step(params, cm[f], tok, cfg,
                                                   fuse=f)
        assert_bits_equal(outs[True], outs[False])
        tok = torch.argmax(outs[True], -1).to(torch.int32)
    for k, leaf in cm[True]["blocks"].items():
        np.testing.assert_array_equal(_pool_bits(leaf),
                                      _pool_bits(cm[False]["blocks"][k]))


def test_quantized_fused_step_one_split_call():
    """With the kernel lowering pinned, the quantized fused step reaches
    the segment kernel entry exactly once (the one split of the float32
    dequantized stack); the logits equal the ref policy's bit for bit."""
    _, _, kcfg, params = _small(4, 64, "kernel")
    rcfg = dataclasses.replace(kcfg, kernel_impl="ref")
    caches = [dec.init_paged_cache(kcfg, 2, 64, 16, quantize="int8",
                                   device="cpu") for _ in range(2)]
    tok = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(3):
        segment.reset_counts()
        with accessfuse.pinned_kernel_lowering():
            lk, caches[0] = dec.paged_decode_step(params, caches[0], tok,
                                                  kcfg, fuse=True)
        assert segment.deinterleave.calls == 1
        assert segment.interleave.calls == 0
        lr, caches[1] = dec.paged_decode_step(params, caches[1], tok, rcfg,
                                              fuse=True)
        assert_bits_equal(lk, lr)
    assert segment.deinterleave.launches == 0      # never on the CPU


def test_quantized_plan_cache_steady_state():
    _, _, cfg, params = _small()
    cache = dec.init_paged_cache(cfg, 2, 16, 4, quantize="int8",
                                 device="cpu")
    tok = torch.tensor([3, 5], dtype=torch.int32)
    _, cache = dec.paged_decode_step(params, cache, tok, cfg)
    warm = vx.PLANS.stats()["misses"]
    for _ in range(4):
        _, cache = dec.paged_decode_step(params, cache, tok, cfg)
    assert vx.PLANS.stats()["misses"] == warm


def test_invariants_cover_scale_liveness():
    _, _, cfg, _ = _small()
    cache = dec.init_paged_cache(cfg, 2, 16, 4, quantize="int8",
                                 device="cpu")
    assert not dec.paged_invariants(cfg, cache)
    for i, j, val in ((0, 0, float("nan")), (1, 0, -1.0)):
        bad = dict(cache, blocks=dict(cache["blocks"]))
        bad["blocks"]["scl0"] = cache["blocks"]["scl0"].clone()
        bad["blocks"]["scl0"][0, i, j] = val
        assert any("scale" in v for v in dec.paged_invariants(cfg, bad))
    missing = dict(cache, blocks={k: v for k, v in cache["blocks"].items()
                                  if k != "scl1"})
    assert dec.paged_invariants(cfg, missing)


# ---------------------------------------------------------------------------
# prefix interop at the decode level
# ---------------------------------------------------------------------------

def test_fork_copies_scale_and_isolates_source():
    """The fork's page gets the SOURCE's scale row and beats; a borrower's
    append afterwards widens the fork's scale only: the source page and
    scale stay byte-identical."""
    _, _, cfg, params = _small()
    cache = dec.init_paged_cache(cfg, 2, 16, 4, quantize="int8",
                                 device="cpu")
    tok = torch.tensor([3, 5], dtype=torch.int32)
    for _ in range(3):
        _, cache = dec.paged_decode_step(params, cache, tok, cfg)
    src = int(cache["table"][0, 0])
    cache = dec.paged_fork_page(cfg, cache, 1, 0, src, pos_to=2)
    dst = int(cache["table"][1, 0])
    assert dst != src and int(cache["pos"][1]) == 2
    blocks = cache["blocks"]
    for i in range(2):
        assert torch.equal(blocks[f"scl{i}"][:, dst],
                           blocks[f"scl{i}"][:, src])
        assert torch.equal(blocks[f"pos{i}"][:, dst, :2],
                           blocks[f"pos{i}"][:, src, :2])
    before = {i: (blocks[f"pos{i}"][:, src].clone(),
                  blocks[f"scl{i}"][:, src].clone()) for i in range(2)}
    _, cache = dec.paged_decode_step(params, cache,
                                     torch.tensor([7, 7], dtype=torch.int32),
                                     cfg, active=torch.tensor([False, True]))
    for i in range(2):
        assert torch.equal(cache["blocks"][f"pos{i}"][:, src], before[i][0])
        assert torch.equal(cache["blocks"][f"scl{i}"][:, src], before[i][1])


@pytest.mark.parametrize("dt", [None, "int8", "fp8"])
def test_prefix_bookkeeping_matches_reference(dt):
    """adopt / fork (with a source, sourceless, with ``deref_src``) /
    addref / deref / release on both packages from the same written pool:
    page tables, positions, refcounts, free stacks, pools, scales and
    ``paged_invariants`` (with the trie's external pins) equal after every
    call."""
    jcfg, _, cfg, _ = _small()
    jc = jdec.init_paged_cache(jcfg, 3, 16, 4, jnp.float32, quantize=dt)
    tc = dec.init_paged_cache(cfg, 3, 16, 4, quantize=dt, device="cpu")
    states = {f"pos{i}": np.random.default_rng(3 + i).normal(
        size=(jcfg.n_superblocks, 1, 8, 2, 32)).astype(np.float32)
        for i in range(2)}
    jc = jdec.paged_insert_prefill(
        jcfg, jc, 0, {k: jnp.asarray(v) for k, v in states.items()}, 8, 8)
    tc = dec.paged_insert_prefill(
        cfg, tc, 0, {k: to_torch(v) for k, v in states.items()}, 8, 8)
    ext = np.zeros(12, np.int64)
    run = np.full(4, -1, np.int32)
    run[:1] = np.asarray(tc["table"][0, :1])
    pins = np.full(4, -1, np.int32)
    pins[:2] = np.asarray(tc["table"][0, :2])
    ops = [
        ("addref", lambda m, c, cf: m.paged_addref(cf, c, pins), pins),
        ("adopt", lambda m, c, cf: m.paged_adopt_prefix(cf, c, 1, run), None),
        ("fork", lambda m, c, cf: m.paged_fork_page(
            cf, c, 1, 1, int(pins[1]), pos_to=6), None),
        ("fork-none", lambda m, c, cf: m.paged_fork_page(
            cf, c, 2, 0, -1, pos_to=0), None),
        ("fork-deref", lambda m, c, cf: m.paged_fork_page(
            cf, c, 1, 0, int(run[0]), deref_src=True), None),
        ("release", lambda m, c, cf: m.paged_release_slot(cf, c, 0), None),
        ("deref", lambda m, c, cf: m.paged_deref_pages(cf, c, pins), "un"),
    ]
    for name, op, pin in ops:
        jc = op(jdec, jc, jcfg)
        tc = op(dec, tc, cfg)
        if isinstance(pin, np.ndarray):
            ext[pin[pin >= 0]] += 1
        elif pin == "un":
            ext[pins[pins >= 0]] -= 1
        _state_equal(tc, jc)
        for k in tc["blocks"]:
            np.testing.assert_array_equal(_pool_bits(tc["blocks"][k]),
                                          _pool_bits(jc["blocks"][k]),
                                          f"{name} {k}")
        assert dec.paged_invariants(cfg, tc, external_ref=ext) == \
            jdec.paged_invariants(jcfg, jc, external_ref=ext), name


def test_page_bytes_counts_scale_side_tensor():
    """page_bytes counts the quantized element type and the per-page
    scale rows, as the reference's; the int8 page of qwen3-0.6b's smoke
    geometry is just over a quarter of the float32 one."""
    jcfg, _, cfg, _ = _smoke()
    for kv in (None, "int8", "fp8"):
        pc = PagedCache(cfg, 2, 32, 8, kv_quant=kv, device="cpu")
        jpc = JPagedCache(jcfg, 2, 32, 8, kv_quant=kv)
        for name in ("page_bytes", "used_cache_bytes", "total_cache_bytes"):
            assert getattr(pc, name)() == getattr(jpc, name)(), (kv, name)
    pcf = PagedCache(cfg, 2, 32, 8, device="cpu")
    pcq = PagedCache(cfg, 2, 32, 8, kv_quant="int8", device="cpu")
    ratio = pcf.page_bytes() / pcq.page_bytes()
    assert 3.5 <= ratio <= 4.0, ratio
    assert pcq.total_cache_bytes() < pcf.total_cache_bytes()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_paged_cache_insert_prefill_matches_reference(kv):
    """PagedCache.insert_prefill (a 6-beat state into page_size 4) and the
    host views after it: state, pools, active_tokens, refcounts and the
    table row equal the reference's; an insert the pool cannot back is
    refused before any page moves."""
    jcfg, _, cfg, _ = _smoke()
    pc = PagedCache(cfg, 2, 16, 4, num_pages=3, kv_quant=kv, device="cpu")
    jpc = JPagedCache(jcfg, 2, 16, 4, num_pages=3, kv_quant=kv)
    st = np.random.default_rng(2).normal(size=(
        jcfg.n_superblocks, 1, 6, jcfg.n_kv_heads, 2 * jcfg.hd)).astype(
        np.float32)
    pc.insert_prefill(1, {"pos0": to_torch(st)}, 6)
    jpc.insert_prefill(1, {"pos0": jnp.asarray(st)}, 6)
    _state_equal(pc.state, jpc.state)
    for k in pc.state["blocks"]:
        np.testing.assert_array_equal(_pool_bits(pc.state["blocks"][k]),
                                      _pool_bits(jpc.state["blocks"][k]))
    assert pc.active_tokens() == jpc.active_tokens() == 6
    np.testing.assert_array_equal(pc.page_refcounts(), jpc.page_refcounts())
    np.testing.assert_array_equal(pc.table_row(1), jpc.table_row(1))
    with pytest.raises(RuntimeError, match="exhausted"):
        pc.insert_prefill(0, {"pos0": to_torch(st)}, 6)


def test_quantized_prefix_sharing_bit_exact_vs_nonshared():
    """Adopted pages carry their scales and a partial-tail fork copies the
    source's: a prefix-sharing int8 scheduler is bit-exact against a
    non-sharing one."""
    _, _, cfg, params = _smoke()
    shared_full = [3, 5, 7, 9, 2, 4, 6, 8] + [11, 13]
    forked_tail = [3, 5, 7, 9, 2, 4, 9, 9, 12]
    for pa, pb in ((shared_full, shared_full[:-2] + [12, 10]),
                   (shared_full, forked_tail)):
        outs = {}
        for name, pc in (("shared", True), ("oracle", False)):
            s = Scheduler(cfg, params, slots=2, max_len=32, page_size=4,
                          num_pages=16, kv_quant="int8", prefix_cache=pc,
                          debug_invariants=True, device="cpu")
            a, b = s.add_request(list(pa)), s.add_request(list(pb))
            outs[name] = [(st[a], st[b]) for st in
                          (s.step() for _ in range(6))]
            s.cache.check_invariants()
        assert outs["shared"] == outs["oracle"]


class _StepClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.01
        return self.t


@pytest.mark.parametrize("seed", (0, 1))
def test_chaos_preempt_replay_holds_at_int8(seed):
    """The chaos gate on the quantized pool: preemption replays a
    request's tokens through quantize-on-write from scratch; every request
    terminates typed and the scale-extended audit holds every tick."""
    from repro_torch.ft.straggler import StepWatchdog
    from repro_torch.serve.chaos import ChaosConfig, FaultPlan, run_plan
    from repro_torch.serve.lifecycle import TERMINAL_STATES
    _, _, cfg, params = _smoke()
    sched = Scheduler(cfg, params, slots=2, max_len=16, page_size=4,
                      num_pages=6, kv_quant="int8", guard_nan=True,
                      queue_depth=3, watchdog=StepWatchdog(),
                      clock=_StepClock(), device="cpu")
    plan = FaultPlan(ChaosConfig(seed=seed, requests=6, steps=32,
                                 max_ticks=256))
    report = run_plan(sched, plan)
    assert report.ticks < plan.cfg.max_ticks
    assert sched.drained()
    assert report.all_terminal, report.states
    for r in report.submitted:
        assert r.state in TERMINAL_STATES
    assert report.invariant_checks >= report.ticks
    assert report.preemptions > 0 or report.nan_failures > 0


def test_fleet_migration_holds_at_int8():
    """The fleet gate at int8: replica death migrates requests by replay
    into a fresh quantized pool; the fleet audit (with the per-replica
    scale-extended invariants) holds every tick."""
    from repro_torch.serve.chaos import (FleetChaosConfig, FleetFaultPlan,
                                         StepClock, run_fleet_plan)
    from repro_torch.serve.fleet import FleetRouter
    from repro_torch.serve.lifecycle import TERMINAL_STATES
    _, _, cfg, params = _smoke()
    fl = FleetRouter(cfg, params, replicas=2, slots=2, max_len=16,
                     page_size=4, num_pages=6, kv_quant="int8",
                     queue_depth=3, guard_nan=True, clock=StepClock(),
                     watchdog_hard_limit=30.0, hard_breach_limit=1,
                     heartbeat_ticks=4, device="cpu")
    plan = FleetFaultPlan(FleetChaosConfig(seed=1, requests=6, steps=24,
                                           max_ticks=512))
    report = run_fleet_plan(fl, plan)
    assert report.ticks < plan.cfg.max_ticks
    assert fl.drained()
    assert report.all_terminal, report.states
    for r in report.submitted:
        assert r.state in TERMINAL_STATES
    assert report.audits == report.ticks
    assert report.deaths > 0 and report.migrated > 0
    assert all(rep.sched.cache.kv_quant == "int8" for rep in fl.replicas)
