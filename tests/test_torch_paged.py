"""Port parity for the paged runtime: vx.Paged gather/scatter against
repro.vx, then paged_prefill_chunk and paged_decode_step (fused and
per-access) on a mixed late-joiner trace against repro.models.decode.

Tolerances: page bookkeeping (table, free, free_top, ref, pos) has none —
it must be equal after every call.  Logits agree within rtol 1e-5 /
atol 1e-5: XLA and torch sum the float32 matmuls and softmax in different
orders, so the logits may differ by a few ULPs.  Greedy tokens must be
equal, and inside the port the fused step equals the per-access step bit
for bit.
"""
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
from repro.models import decode as jdec
from repro.models.transformer import init_params as jinit
from repro_torch import vx
from repro_torch.configs.base import get_arch
from repro_torch.core import accessfuse
from repro_torch.kernels import segment
from repro_torch.models import decode as tdec
from repro_torch.models.transformer import params_from_jax

RTOL = ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jget_arch("qwen3-0.6b").smoke
    return cfg, jinit(cfg, jax.random.key(0))


def _configs(impl="ref"):
    jcfg, jparams = _jax_params()
    tcfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke,
                               kernel_impl=impl)
    tparams = params_from_jax(jax_tree_to_np(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _assert_state(tc, jc):
    for k in ("table", "free", "free_top", "ref", "pos"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# vx.Paged lowering
# ---------------------------------------------------------------------------

def _pool(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("table", [[[2, 0, -1], [5, -1, -1]],
                                   [[-1, -1, -1], [7, 6, 1]]])
def test_paged_gather_matches_reference(table):
    pool = _pool(0, (2, 8, 4, 2, 6))
    tab = np.asarray(table, np.int32)
    spec_t = vx.Paged(page_size=4, pages=3, trail=2)
    spec_j = jvx.Paged(page_size=4, pages=3, trail=2)
    assert_bits_equal(vx.gather(spec_t, to_torch(pool), table=to_torch(tab)),
                      jvx.gather(spec_j, jnp.asarray(pool),
                                 table=jnp.asarray(tab)))
    pools = [_pool(1, (2, 8, 4, 2, 6)), _pool(2, (2, 8, 4, 2, 6))]
    got = vx.gather_many(spec_t, [to_torch(p) for p in pools],
                         table=to_torch(tab))
    want = jvx.gather_many(spec_j, [jnp.asarray(p) for p in pools],
                           table=jnp.asarray(tab))
    for g, w in zip(got, want):
        assert_bits_equal(g, w)


@pytest.mark.parametrize("pos", [[0, 5, 3], [-1, 11, 12], [-1, -1, -1],
                                 [2, 9, 4]])
def test_paged_scatter_matches_reference(pos):
    """Appends land through the table; rows with pos < 0, pos past the
    table, or an unallocated page drop — exactly as the reference."""
    pool = _pool(3, (6, 4, 2, 6))
    beats = _pool(4, (3, 2, 6))
    tab = np.asarray([[1, 4, -1], [0, 2, 3], [5, -1, -1]], np.int32)
    p = np.asarray(pos, np.int32)
    got = vx.scatter(vx.Paged(page_size=4, pages=3, trail=2),
                     to_torch(pool), to_torch(beats), table=to_torch(tab),
                     pos=to_torch(p))
    want = jvx.scatter(jvx.Paged(page_size=4, pages=3, trail=2),
                       jnp.asarray(pool), jnp.asarray(beats),
                       table=jnp.asarray(tab), pos=jnp.asarray(p))
    assert_bits_equal(got, want)


# ---------------------------------------------------------------------------
# Prefill chunks + decode steps on a mixed late-joiner trace
# ---------------------------------------------------------------------------

PS, MAX_LEN, SLOTS = 4, 32, 3
PROMPTS = {0: [5, 17, 3, 99, 42, 7], 1: [11, 250, 8]}
JOIN = {0: 0, 1: 2}                      # decode step at which slot admits


@pytest.mark.parametrize("fuse", [True, False])
def test_paged_trace_matches_reference(fuse):
    jcfg, jparams, tcfg, tparams = _configs()
    jstep = jax.jit(lambda p, c, t, a: jdec.paged_decode_step(
        p, c, t, jcfg, None, active=a, fuse=fuse))
    jchunk = jax.jit(lambda p, c, t, s, n: jdec.paged_prefill_chunk(
        p, c, t, jcfg, None, slot=s, count=n))
    jc = jdec.init_paged_cache(jcfg, SLOTS, MAX_LEN, PS, jnp.float32)
    tc = tdec.init_paged_cache(tcfg, SLOTS, MAX_LEN, PS, torch.float32,
                               device="cpu")
    # the port's other path runs in lockstep: fused == per-access bitwise
    tc2 = tdec.init_paged_cache(tcfg, SLOTS, MAX_LEN, PS, torch.float32,
                                device="cpu")
    _assert_state(tc, jc)
    cur = {}
    for step in range(7):
        for s, prompt in PROMPTS.items():
            if JOIN[s] != step:
                continue
            pre = prompt[:-1]
            for c in range(0, len(pre), PS):
                n = min(PS, len(pre) - c)
                toks = np.asarray(pre[c:c + n] + [0] * (PS - n), np.int32)
                jc = jchunk(jparams, jc, jnp.asarray(toks), s, n)
                tc = tdec.paged_prefill_chunk(tparams, tc, to_torch(toks),
                                              tcfg, slot=s, count=n)
                tc2 = tdec.paged_prefill_chunk(tparams, tc2, to_torch(toks),
                                               tcfg, slot=s, count=n)
                _assert_state(tc, jc)
            cur[s] = prompt[-1]
        act = np.asarray([s in cur for s in range(SLOTS)])
        tok = np.asarray([cur.get(s, 0) for s in range(SLOTS)], np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(act))
        tl, tc = tdec.paged_decode_step(tparams, tc, to_torch(tok), tcfg,
                                        active=to_torch(act), fuse=fuse)
        tl2, tc2 = tdec.paged_decode_step(tparams, tc2, to_torch(tok), tcfg,
                                          active=to_torch(act),
                                          fuse=not fuse)
        _assert_state(tc, jc)
        assert_bits_equal(tl, tl2)
        for s in cur:
            np.testing.assert_allclose(tl[s].numpy(), np.asarray(jl[s]),
                                       rtol=RTOL, atol=ATOL)
            want = int(jnp.argmax(jl[s]))
            assert int(torch.argmax(tl[s])) == want
            cur[s] = want
    # the pools hold the same beats (a plain copy path: no tolerance on
    # the routing, the beats themselves are float32 projections)
    for k in tc["blocks"]:
        np.testing.assert_allclose(tc["blocks"][k].numpy(),
                                   np.asarray(jc["blocks"][k]),
                                   rtol=RTOL, atol=ATOL)


def test_paged_release_matches_reference():
    jcfg, jparams, tcfg, tparams = _configs()
    jc = jdec.init_paged_cache(jcfg, SLOTS, MAX_LEN, PS, jnp.float32)
    tc = tdec.init_paged_cache(tcfg, SLOTS, MAX_LEN, PS, torch.float32,
                               device="cpu")
    toks = np.asarray([4, 5, 6, 7], np.int32)
    for s in (0, 1):
        for _ in range(2):                       # two chunks = two pages
            jc = jdec.paged_prefill_chunk(jparams, jc, jnp.asarray(toks),
                                          jcfg, None, slot=s, count=4)
            tc = tdec.paged_prefill_chunk(tparams, tc, to_torch(toks), tcfg,
                                          slot=s, count=4)
    jc = jdec.paged_release_slot(jcfg, jc, 0)
    tc = tdec.paged_release_slot(tcfg, tc, 0)
    _assert_state(tc, jc)
    assert tdec.paged_invariants(tcfg, tc) == []
    assert jdec.paged_invariants(jcfg, jc) == []


def test_paged_insert_prefill_matches_reference():
    jcfg, _, tcfg, _ = _configs()
    jc = jdec.init_paged_cache(jcfg, SLOTS, MAX_LEN, PS, jnp.float32)
    tc = tdec.init_paged_cache(tcfg, SLOTS, MAX_LEN, PS, torch.float32,
                               device="cpu")
    states = _pool(9, (jcfg.n_superblocks, 1, 6, jcfg.n_kv_heads,
                       2 * jcfg.hd))
    jc = jdec.paged_insert_prefill(jcfg, jc, 1, {"pos0": jnp.asarray(states)},
                                   6, 6)
    tc = tdec.paged_insert_prefill(tcfg, tc, 1, {"pos0": to_torch(states)},
                                   6, 6)
    _assert_state(tc, jc)
    assert_bits_equal(tc["blocks"]["pos0"], jc["blocks"]["pos0"])


def test_one_split_call_per_decode_step_when_pinned():
    """Under a kernel policy with the kernel lowering pinned, the fused
    step reaches the segment kernel entry exactly once (the fused KV
    split); the single-token beats and GLU splits stay below the launch
    threshold.  Unpinned on the CPU the group demotes to the plain path.
    Either way the logits are bit-equal to the ref policy's."""
    _, _, tcfg, tparams = _configs("kernel")
    _, _, rcfg, _ = _configs("ref")
    tok = to_torch(np.asarray([3, 9, 0], np.int32))
    act = to_torch(np.asarray([True, True, False]))
    # a 64-token table: the fused split (NS*B*S*K*2D = 49152 elements)
    # clears the launch threshold (MIN_FUSED_ELEMS = 32768)
    caches = [tdec.init_paged_cache(tcfg, SLOTS, 64, PS, torch.float32,
                                    device="cpu") for _ in range(3)]
    for step in range(3):
        segment.reset_counts()
        with accessfuse.pinned_kernel_lowering():
            lp, caches[0] = tdec.paged_decode_step(tparams, caches[0], tok,
                                                   tcfg, active=act)
        assert segment.deinterleave.calls == 1
        assert segment.interleave.calls == 0
        segment.reset_counts()
        lu, caches[1] = tdec.paged_decode_step(tparams, caches[1], tok, tcfg,
                                               active=act)
        assert segment.deinterleave.calls == segment.interleave.calls == 0
        lr, caches[2] = tdec.paged_decode_step(tparams, caches[2], tok, rcfg,
                                               active=act)
        assert_bits_equal(lp, lr)
        assert_bits_equal(lu, lr)
    assert segment.deinterleave.launches == 0     # never on the CPU


def test_policy_resolution():
    assert vx.Policy.default().impl in ("ref", "kernel")
    assert vx.resolve("kernel").impl == "kernel"
    with vx.use("kernel"):
        assert vx.current().impl == "kernel"
    assert vx.Policy(impl="kernel").for_elems(8).impl == "ref"
    assert vx.Policy(impl="kernel").for_elems(1 << 15).impl == "kernel"
    with pytest.raises(ValueError):
        vx.Policy(impl="pallas")
    assert accessfuse.platform_impl("kernel", vx.Policy(impl="kernel"),
                                    torch.device("cpu")) == "ref"
    assert accessfuse.platform_impl("kernel", vx.Policy(impl="kernel"),
                                    torch.device("cuda")) == "kernel"
    assert accessfuse.platform_impl(
        "kernel", vx.Policy(impl="kernel", platform_lowering=False),
        torch.device("cpu")) == "kernel"


def test_append_paged_token_matches_reference():
    from repro.kernels import kv_interleaved as jkv
    from repro_torch.kernels import kv_interleaved as tkv
    pool = _pool(5, (6, 4, 2, 16))
    k, v = _pool(6, (3, 2, 8)), _pool(7, (3, 2, 8))
    tab = np.asarray([[1, 4, -1], [0, 2, 3], [5, -1, -1]], np.int32)
    pos = np.asarray([5, -1, 2], np.int32)
    got = tkv.append_paged_token(to_torch(pool), to_torch(k), to_torch(v),
                                 to_torch(tab), to_torch(pos),
                                 policy="kernel")
    want = jkv.append_paged_token(jnp.asarray(pool), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(tab),
                                  jnp.asarray(pos), policy="ref")
    assert_bits_equal(got, want)
    tk, tv = tkv.split_kv(tkv.interleave_kv(to_torch(k), to_torch(v)))
    assert_bits_equal(tk, k)
    assert_bits_equal(tv, v)
