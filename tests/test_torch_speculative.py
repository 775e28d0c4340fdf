"""Port parity for speculative K-token decode: ``paged_verify_step``,
``paged_truncate`` and the speculative ``Scheduler`` against ``repro``'s,
case for case with ``tests/test_speculative.py``.

Decode level: the port's verify step and the reference's run in lockstep
on the same drafts (oracle-perfect, corrupted to force rejections, or
arbitrary), with the reference's params through ``params_from_jax``.  The
committed tokens, the commit counts and the page bookkeeping (``table``,
``free``, ``free_top``, ``ref``, ``pos``) must be equal after every round;
committed logits hold to the reference's own ``rtol=5e-4, atol=1e-5`` in
float32 (XLA and torch sum the matmuls in other orders).  The committed
stream must equal the plain ``paged_decode_step`` oracle's.  Lowering: the
fused verify gathers the pre-append pages once (the per-access arm once
per layer) with logits equal bit for bit, reaches the segment kernel's
entry once (the fused split) with the kernel lowering pinned, and takes
no plan-cache miss across mixed ``n_draft``.  Serve level: the five
scheduler cases of the reference (uniform K, mixed per-request K, no
overshoot of ``max_new_tokens``, preempt-resume replay through the
verify batch, prefix sharing), each against the reference's speculative
scheduler (streams and the speculative stats) and the plain scheduler's
streams.  ``paged_truncate`` against the reference on random page
tables, quantized pools included.  The reference's recurrent mix case
(an ``("attn", "mamba")`` stack) runs in lockstep with the reference's
verify step, the Mamba state kept at the accept point.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, jax_tree_to_np
from repro.models import decode as jdec
from repro.models import transformer as jtf
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import vx
from repro_torch.core import accessfuse
from repro_torch.kernels import segment
from repro_torch.models import decode as dec
from repro_torch.models.transformer import ModelConfig, params_from_jax
from repro_torch.serve.scheduler import Scheduler

RTOL, ATOL = 5e-4, 1e-5
JIMPL = {"ref": "ref", "kernel": "pallas", "kernel_dynamic": "pallas_dynamic"}
STATE = ("table", "free", "free_top", "ref", "pos")


def _kw(layers=2, hd=16, scan=True, pattern=("attn",), window=None,
        mlp="swiglu", d_ff=64, name="spec-test"):
    """tests/test_speculative.py's ``_cfg`` fields."""
    n = len(pattern)
    return dict(name=name, d_model=2 * hd, n_layers=layers, n_heads=2,
                n_kv_heads=2, d_ff=d_ff, vocab=97, head_dim=hd, mlp=mlp,
                block_pattern=pattern, window_pattern=(window,) * n,
                moe_pattern=(False,) * n, scan_layers=scan, remat="none")


@functools.lru_cache(maxsize=None)
def _pair(impl="ref", seed=0, **kw):
    """(reference cfg, reference params, port cfg, port params)."""
    kw = _kw(**kw)
    jkw, tkw = {}, {}
    if "mamba" in kw["block_pattern"]:
        # tests/test_speculative.py's MambaSpec(d_model=2 * hd)
        from repro.models.ssm import MambaSpec as JMambaSpec
        from repro_torch.models.ssm import MambaSpec
        jkw["mamba"] = JMambaSpec(d_model=kw["d_model"])
        tkw["mamba"] = MambaSpec(d_model=kw["d_model"])
    jcfg = jtf.ModelConfig(**kw, **jkw, kernel_impl=JIMPL[impl])
    cfg = ModelConfig(**kw, **tkw, kernel_impl=impl)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, jparams, cfg, params_from_jax(jax_tree_to_np(jparams), cfg,
                                               device="cpu")


@functools.lru_cache(maxsize=None)
def _jverify(jcfg):
    return jax.jit(lambda p, c, t, n, a: jdec.paged_verify_step(
        p, c, t, jcfg, None, n_draft=n, active=a))


def _state_equal(tc, jc):
    for k in STATE:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                      err_msg=k)


def _oracle(cfg, params, slots, ps, max_len, steps, quantize=None):
    """Greedy single-token streams and per-step logits of the port's plain
    paged step (the ground truth)."""
    oc = dec.init_paged_cache(cfg, slots, max_len, ps, quantize=quantize,
                              device="cpu")
    cur = (torch.arange(slots, dtype=torch.int32) * 7 + 3) % cfg.vocab
    stream = [[int(cur[s])] for s in range(slots)]
    logits = [[] for _ in range(slots)]
    for _ in range(steps):
        lg, oc = dec.paged_decode_step(params, oc, cur, cfg)
        cur = torch.argmax(lg, dim=-1).to(torch.int32)
        for s in range(slots):
            stream[s].append(int(cur[s]))
            logits[s].append(lg[s].numpy())
    return stream, logits


def _lockstep(jcfg, jparams, cfg, params, oracle, K, steps, slots, ps,
              max_len, corrupt_at=frozenset(), nd=None, quantize=None,
              check_logits=True):
    """Drive the port's and the reference's verify steps with the same
    drafts (the oracle's, corrupted at (round, slot, j)) and hold them
    together every round.  Returns the committed streams, the per-round
    commits and the port's cache."""
    tc = dec.init_paged_cache(cfg, slots, max_len, ps, quantize=quantize,
                              device="cpu")
    jc = jdec.init_paged_cache(jcfg, slots, max_len, ps, jnp.float32,
                               quantize=quantize)
    jv = _jverify(jcfg)
    act = np.ones((slots,), bool)
    nd = np.full((slots,), K, np.int32) if nd is None else \
        np.asarray(nd, np.int32)
    stream = [[oracle[0][s][0]] for s in range(slots)]
    commits = []
    rnd = 0
    while min(len(t) for t in stream) < steps and rnd < 80:
        toks = np.zeros((slots, K), np.int32)
        for s in range(slots):
            fed = len(stream[s])
            toks[s, 0] = stream[s][-1]
            for j in range(1, K):
                i = fed - 1 + j
                t = oracle[0][s][i] if i < len(oracle[0][s]) else 0
                if (rnd, s, j) in corrupt_at:
                    t = (t + 1) % cfg.vocab
                toks[s, j] = t
        jl, jo, jcm, jc = jv(jparams, jc, jnp.asarray(toks), jnp.asarray(nd),
                             jnp.asarray(act))
        tl, to, tcm, tc = dec.paged_verify_step(
            params, tc, torch.from_numpy(toks), cfg, n_draft=torch.from_numpy(
                nd), active=torch.from_numpy(act))
        np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
        _state_equal(tc, jc)
        for i, kind in enumerate(cfg.block_pattern):
            if kind != "attn":    # the recurrent state at the accept point
                for a, b in zip(tc["blocks"][f"pos{i}"],
                                jc["blocks"][f"pos{i}"]):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                               rtol=RTOL, atol=ATOL)
        commits.append(tcm.tolist())
        for s in range(slots):
            c = int(tcm[s])
            np.testing.assert_array_equal(to[s, :c].numpy(),
                                          np.asarray(jo)[s, :c])
            np.testing.assert_allclose(tl[s, :c].numpy(),
                                       np.asarray(jl)[s, :c], rtol=RTOL,
                                       atol=ATOL)
            fed = len(stream[s])
            for j in range(c):
                stream[s].append(int(to[s, j]))
                if check_logits and fed - 1 + j < len(oracle[1][s]):
                    np.testing.assert_allclose(
                        tl[s, j].numpy(), oracle[1][s][fed - 1 + j],
                        rtol=RTOL, atol=ATOL)
        assert not dec.paged_invariants(cfg, tc), \
            dec.paged_invariants(cfg, tc)
        rnd += 1
    return stream, commits, tc


def _streams_equal(spec, oracle, steps):
    for s, (a, b) in enumerate(zip(spec, oracle)):
        n = min(steps, len(a))
        assert a[:n] == b[:n], f"slot {s}: {a[:n]} != {b[:n]}"


# ---------------------------------------------------------------------------
# decode level
# ---------------------------------------------------------------------------

def test_k1_degenerates_to_single_step_bit_exact():
    """K=1: the verify step is the plain step plus argmax.  Tokens, commits
    and positions equal the port's plain step's and the reference verify
    step's; logits within the reference's tolerance of both."""
    jcfg, jparams, cfg, params = _pair()
    slots, ps, max_len = 2, 4, 32
    dc = dec.init_paged_cache(cfg, slots, max_len, ps, device="cpu")
    vc = dec.init_paged_cache(cfg, slots, max_len, ps, device="cpu")
    jc = jdec.init_paged_cache(jcfg, slots, max_len, ps, jnp.float32)
    jv = _jverify(jcfg)
    nd = torch.ones((slots,), dtype=torch.int32)
    cur = (torch.arange(slots, dtype=torch.int32) * 7 + 3) % cfg.vocab
    for _ in range(8):
        lg_d, dc = dec.paged_decode_step(params, dc, cur, cfg)
        lg_v, o, cm, vc = dec.paged_verify_step(params, vc, cur[:, None], cfg,
                                                n_draft=nd)
        jl, jo, jcm, jc = jv(jparams, jc, jnp.asarray(cur.numpy()[:, None]),
                             jnp.ones((slots,), jnp.int32),
                             jnp.ones((slots,), bool))
        np.testing.assert_allclose(lg_v[:, 0].numpy(), lg_d.numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lg_v.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        assert cm.tolist() == [1, 1] == np.asarray(jcm).tolist()
        nxt = torch.argmax(lg_d, dim=-1).to(torch.int32)
        assert_bits_equal(o[:, 0], nxt)
        assert_bits_equal(o, np.asarray(jo))
        assert_bits_equal(vc["pos"], dc["pos"])
        _state_equal(vc, jc)
        cur = nxt


def test_accept_all_catches_oracle_k_per_launch():
    jcfg, jparams, cfg, params = _pair()
    K, steps, slots, ps, max_len = 4, 12, 2, 4, 64
    oracle = _oracle(cfg, params, slots, ps, max_len, steps + K + 2)
    stream, commits, _ = _lockstep(jcfg, jparams, cfg, params, oracle, K,
                                   steps, slots, ps, max_len)
    _streams_equal(stream, oracle[0], steps)
    assert all(c == K for row in commits[:-1] for c in row), commits


def test_reject_all_commits_one_per_launch():
    jcfg, jparams, cfg, params = _pair()
    K, steps, slots, ps, max_len = 4, 10, 2, 4, 64
    oracle = _oracle(cfg, params, slots, ps, max_len, steps + K + 2)
    corrupt = {(r, s, 1) for r in range(80) for s in range(slots)}
    stream, commits, _ = _lockstep(jcfg, jparams, cfg, params, oracle, K,
                                   steps, slots, ps, max_len,
                                   corrupt_at=corrupt)
    _streams_equal(stream, oracle[0], steps)
    assert all(c == 1 for row in commits for c in row), commits


def test_mixed_rejections_track_oracle():
    jcfg, jparams, cfg, params = _pair()
    K, steps, slots, ps, max_len = 4, 12, 2, 4, 64
    oracle = _oracle(cfg, params, slots, ps, max_len, steps + K + 2)
    stream, commits, _ = _lockstep(
        jcfg, jparams, cfg, params, oracle, K, steps, slots, ps, max_len,
        corrupt_at={(0, 0, 1), (1, 1, 2), (2, 0, 3), (4, 1, 1)})
    _streams_equal(stream, oracle[0], steps)
    assert commits[0] == [1, K] and commits[1] == [K, 2], commits


def test_rejection_on_page_boundary_returns_page_to_free_stack():
    """One token before a page boundary, the K-wide verify appends across
    it (allocating a fresh page) and every draft is rejected: the page
    must come straight back, as in the reference."""
    jcfg, jparams, cfg, params = _pair()
    K, slots, ps, max_len = 4, 1, 4, 32
    oracle = _oracle(cfg, params, slots, ps, max_len, 2 * ps + K + 2)
    sc = dec.init_paged_cache(cfg, slots, max_len, ps, device="cpu")
    jc = jdec.init_paged_cache(jcfg, slots, max_len, ps, jnp.float32)
    jd = jax.jit(lambda p, c, t: jdec.paged_decode_step(p, c, t, jcfg, None))
    cur = torch.tensor([oracle[0][0][0]], dtype=torch.int32)
    for _ in range(ps - 1):
        lg, sc = dec.paged_decode_step(params, sc, cur, cfg)
        _, jc = jd(jparams, jc, jnp.asarray(cur.numpy()))
        cur = torch.argmax(lg, dim=-1).to(torch.int32)
    assert int(sc["pos"][0]) == ps - 1
    free_before = int(sc["free_top"])
    toks = np.zeros((slots, K), np.int32)
    toks[0, 0] = int(cur[0])
    for j in range(1, K):
        toks[0, j] = (oracle[0][0][ps - 1 + j] + 1) % cfg.vocab
    nd = np.full((slots,), K, np.int32)
    lg, o, cm, sc = dec.paged_verify_step(params, sc, torch.from_numpy(toks),
                                          cfg, n_draft=torch.from_numpy(nd))
    _, jo, jcm, jc = _jverify(jcfg)(jparams, jc, jnp.asarray(toks),
                                    jnp.asarray(nd), jnp.ones((1,), bool))
    assert int(cm[0]) == 1 == int(np.asarray(jcm)[0])
    assert int(sc["pos"][0]) == ps
    assert int(sc["free_top"]) == free_before, \
        "rolled-back page did not return to the free stack"
    _state_equal(sc, jc)
    assert not dec.paged_invariants(cfg, sc), dec.paged_invariants(cfg, sc)
    assert int(o[0, 0]) == oracle[0][0][ps] == int(np.asarray(jo)[0, 0])


def test_windowed_stream_tracks_oracle():
    jcfg, jparams, cfg, params = _pair(window=8)
    K, steps, slots, ps, max_len = 3, 12, 2, 4, 32
    oracle = _oracle(cfg, params, slots, ps, max_len, steps + K + 2)
    stream, _, _ = _lockstep(jcfg, jparams, cfg, params, oracle, K, steps,
                             slots, ps, max_len, nd=[K, K - 1])
    _streams_equal(stream, oracle[0], steps)


def test_recurrent_mix_waits_for_the_recurrent_blocks():
    """The reference's ``test_recurrent_mix_stream_tracks_oracle`` (an
    ``("attn", "mamba")`` stack, K = 3), which waited for the port's
    recurrent blocks: in lockstep with the reference's verify step, with
    drafts corrupted to force rejections, the committed tokens, commits
    and page state equal the reference's every round, the committed
    logits hold to its tolerance, the Mamba state after the accept point
    to the same tolerance, and the stream is the plain step's."""
    jcfg, jparams, cfg, params = _pair(pattern=("attn", "mamba"))
    K, steps, slots, ps, max_len = 3, 10, 2, 4, 64
    oracle = _oracle(cfg, params, slots, ps, max_len, steps + K + 2)
    stream, commits, tc = _lockstep(
        jcfg, jparams, cfg, params, oracle, K, steps, slots, ps, max_len,
        corrupt_at=frozenset({(1, 0, 1), (2, 1, 2)}))
    _streams_equal(stream, oracle[0], steps)
    assert any(c < K for cs in commits for c in cs)
    assert any(c == K for cs in commits for c in cs)
    assert type(tc["blocks"]["pos1"]).__name__ == "MambaCache"


@pytest.mark.parametrize("dt", ["int8", "fp8"])
def test_int8_pool_invariant_green_under_speculation(dt):
    """Quantized pools under speculation: with the same drafts the port's
    commits and page bookkeeping equal the reference's every round, and
    the invariants (scale liveness included) stay green.  Logits hold to
    the reference's quantized-step bound, not to float32 tolerance."""
    jcfg, jparams, cfg, params = _pair()
    K, rounds, slots, ps, max_len = 3, 8, 2, 4, 64
    oracle = _oracle(cfg, params, slots, ps, max_len, (rounds + 1) * K,
                     quantize=dt)
    tc = dec.init_paged_cache(cfg, slots, max_len, ps, quantize=dt,
                              device="cpu")
    jc = jdec.init_paged_cache(jcfg, slots, max_len, ps, jnp.float32,
                               quantize=dt)
    jv = _jverify(jcfg)
    nd = np.asarray([K, K - 1], np.int32)
    stream = [[oracle[0][s][0]] for s in range(slots)]
    for _ in range(rounds):
        toks = np.zeros((slots, K), np.int32)
        for s in range(slots):
            fed = len(stream[s])
            toks[s, 0] = stream[s][-1]
            for j in range(1, K):
                toks[s, j] = oracle[0][s][fed - 1 + j]
        jl, jo, jcm, jc = jv(jparams, jc, jnp.asarray(toks), jnp.asarray(nd),
                             jnp.ones((slots,), bool))
        tl, to, tcm, tc = dec.paged_verify_step(
            params, tc, torch.from_numpy(toks), cfg,
            n_draft=torch.from_numpy(nd))
        np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
        _state_equal(tc, jc)
        for s in range(slots):
            a, b = tl[s, :nd[s]].numpy(), np.asarray(jl)[s, :nd[s]]
            assert np.abs(a - b).max() <= max(0.08, 0.03 * np.abs(b).max())
            stream[s] += to[s, :int(tcm[s])].tolist()
        assert not dec.paged_invariants(cfg, tc), \
            dec.paged_invariants(cfg, tc)


def test_quantized_verify_append_widens_as_the_reference():
    """The verify step's (B*K,) append on a quantized pool (rows repeated
    through the table, pad rows dropped, beats that the rollback will
    reject included) widens the scales and writes the pool bit for bit as
    the reference's lowering on the same beats."""
    from repro import vx as jvx
    from test_torch_quant_pool import _pool_bits, _random_pool, _tpool
    B, K, ps, n_seq, P, Kh, D = 2, 3, 4, 4, 8, 2, 6
    rng = np.random.default_rng(3)
    for dt in ("int8", "fp8"):
        jpool = _random_pool(dt, (P, ps, Kh, D), 4)
        scl = rng.uniform(0.01, 0.5, (P, Kh)).astype(np.float32)
        table = np.asarray([[2, 5, -1, -1], [7, 1, 3, -1]], np.int32)
        wpos = np.asarray([[3, 4, 5], [9, -1, -1]], np.int32).reshape(-1)
        beats = (rng.normal(size=(B * K, Kh, D)) * 3).astype(np.float32)
        tflat = np.repeat(table, K, axis=0)
        spec_j = jvx.Paged(page_size=ps, pages=n_seq, trail=2)
        spec_t = vx.Paged(page_size=ps, pages=n_seq, trail=2)
        jp, js = jvx.scatter(spec_j, jpool, jnp.asarray(beats),
                             table=jnp.asarray(tflat), pos=jnp.asarray(wpos),
                             scales=jnp.asarray(scl))
        tp, ts = _tpool(jpool), torch.from_numpy(scl.copy())
        vx.scatter(spec_t, tp, torch.from_numpy(beats),
                   table=torch.from_numpy(tflat), pos=torch.from_numpy(wpos),
                   scales=ts)
        np.testing.assert_array_equal(_pool_bits(tp), _pool_bits(jp))
        assert_bits_equal(ts, np.asarray(js))


# ---------------------------------------------------------------------------
# lowering level
# ---------------------------------------------------------------------------

def _gate_pair(impl):
    return _pair(impl, layers=4, hd=64, scan=False, pattern=("attn", "attn"),
                 mlp="none", d_ff=0, name=f"spec-gate-{impl}")


def test_verify_fuses_page_gathers_ref(monkeypatch):
    """The fused verify gathers every layer's PRE-append pages in ONE
    paged-gather program; the per-access arm runs one per layer (2
    superblocks x 2 positions: 3 more, the reference's gather-equation
    gap), and both give the same logits bit for bit."""
    from repro_torch.vx import lower
    _, _, cfg, params = _gate_pair("ref")
    seen = []
    real = lower.executor

    def counting(program, specs):
        if program.txn.op == "paged.gather":
            seen.append(program.txn.width)
        return real(program, specs)
    monkeypatch.setattr(lower, "executor", counting)
    toks = torch.tensor([[3, 5, 7, 9], [11, 2, 4, 6]], dtype=torch.int32)
    nd = torch.full((2,), 4, dtype=torch.int32)
    out = {}
    for fuse in (True, False):
        cache = dec.init_paged_cache(cfg, 2, 64, 16, device="cpu")
        seen.clear()
        out[fuse] = dec.paged_verify_step(params, cache, toks, cfg,
                                          n_draft=nd, fuse=fuse)
        out[fuse] = (out[fuse], list(seen))
    assert out[True][1] == [2] and out[False][1] == [1] * 4
    assert len(out[False][1]) - len(out[True][1]) == 3
    assert_bits_equal(out[True][0][0], out[False][0][0])


def test_verify_single_pinned_launch_kernel():
    """With the kernel lowering pinned, one verify step reaches the segment
    kernel's entry exactly once (the fused split); at this width the K
    beats and no GLU stay below the launch threshold.  Logits equal the
    ref policy's bit for bit."""
    _, _, cfg, params = _gate_pair("kernel")
    _, _, rcfg, _ = _gate_pair("ref")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    nd = torch.full((2,), 4, dtype=torch.int32)
    segment.reset_counts()
    with accessfuse.pinned_kernel_lowering():
        lk, *_ = dec.paged_verify_step(
            params, dec.init_paged_cache(cfg, 2, 64, 16, device="cpu"), toks,
            cfg, n_draft=nd)
    assert (segment.deinterleave.calls, segment.interleave.calls) == (1, 0)
    assert segment.deinterleave.launches == 0       # never on the CPU
    lr, *_ = dec.paged_verify_step(
        params, dec.init_paged_cache(rcfg, 2, 64, 16, device="cpu"), toks,
        rcfg, n_draft=nd)
    assert_bits_equal(lk, lr)


def test_plans_steady_across_mixed_n_draft():
    _, _, cfg, params = _pair()
    cache = dec.init_paged_cache(cfg, 2, 16, 4, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    _, _, _, cache = dec.paged_verify_step(
        params, cache, toks, cfg, n_draft=torch.tensor([4, 4]))
    warm = vx.PLANS.stats()["misses"]
    for nd_ in ([1, 4], [2, 3], [4, 1], [3, 3]):
        _, _, _, cache = dec.paged_verify_step(
            params, cache, toks, cfg, n_draft=torch.tensor(nd_))
    assert vx.PLANS.stats()["misses"] == warm, \
        "plan cache missed across mixed per-slot verify widths"


# ---------------------------------------------------------------------------
# paged_truncate
# ---------------------------------------------------------------------------

def _random_state(seed, slots=3, n_seq=6, ps=4, spare=5):
    """A consistent page state: each slot owns ceil(pos / ps) pages of a
    shuffled pool, the rest on the free stack in random order."""
    rng = np.random.default_rng(seed)
    P = slots * n_seq + spare
    ids = rng.permutation(P).astype(np.int32)
    pos = rng.integers(0, n_seq * ps + 1, slots).astype(np.int32)
    table = np.full((slots, n_seq), -1, np.int32)
    ref = np.zeros(P, np.int32)
    k = 0
    for s in range(slots):
        n = -(-int(pos[s]) // ps)
        table[s, :n] = ids[k:k + n]
        ref[ids[k:k + n]] = 1
        k += n
    free = np.zeros(P, np.int32)
    free[:P - k] = ids[k:][::-1]
    return {"pos": pos, "table": table, "free": free,
            "free_top": np.int32(P - k), "ref": ref}


@pytest.mark.parametrize("quantize", [None, "int8", "fp8"])
@pytest.mark.parametrize("seed", range(4))
def test_paged_truncate_matches_reference(seed, quantize):
    jcfg, _, cfg, _ = _pair()
    slots, ps, n_seq = 3, 4, 6
    st = _random_state(seed, slots, n_seq, ps)
    P = st["free"].shape[0]
    jc = jdec.init_paged_cache(jcfg, slots, n_seq * ps, ps, jnp.float32,
                               num_pages=P, quantize=quantize)
    tc = dec.init_paged_cache(cfg, slots, n_seq * ps, ps, num_pages=P,
                              quantize=quantize, device="cpu")
    jc = dict(jc, **{k: jnp.asarray(v) for k, v in st.items()})
    tc = dict(tc, **{k: torch.from_numpy(np.array(v)) for k, v in st.items()})
    if quantize:
        scl = np.random.default_rng(seed).uniform(
            0, 1, tc["blocks"]["scl0"].shape).astype(np.float32)
        tc["blocks"]["scl0"].copy_(torch.from_numpy(scl))
    rng = np.random.default_rng(100 + seed)
    for _ in range(3):
        new_pos = rng.integers(-2, n_seq * ps + 3, slots).astype(np.int32)
        jc = jdec.paged_truncate(jcfg, jc, jnp.asarray(new_pos))
        tc = dec.paged_truncate(cfg, tc, torch.from_numpy(new_pos))
        _state_equal(tc, jc)
        assert not dec.paged_invariants(cfg, tc), \
            dec.paged_invariants(cfg, tc)
    if quantize:                      # the scales stay where they were
        assert_bits_equal(tc["blocks"]["scl0"], scl)


# ---------------------------------------------------------------------------
# serve level
# ---------------------------------------------------------------------------

_PROMPTS = [[3, 5, 7, 11, 13], [2, 4], [17, 19, 23, 29, 31, 37, 41, 2, 3]]


def _sched_pair():
    """The reference's target and draft, and the port's from their
    params."""
    jcfg, jparams, cfg, params = _pair()
    jdcfg, jdparams, dcfg, dparams = _pair(layers=1, hd=8, seed=1,
                                           name="spec-draft")
    return (jcfg, jparams, jdcfg, jdparams), (cfg, params, dcfg, dparams)


def _drain(sched, ticks=120):
    for _ in range(ticks):
        sched.tick()
        if sched.drained():
            return
    raise AssertionError("scheduler did not drain")


def _run(make, submit, cfg_, params_, dcfg, dparams, spec=True, **kw):
    kw = dict(max_len=64, page_size=4, debug_invariants=True, **kw)
    if spec:
        kw.update(speculate=4, draft_cfg=dcfg, draft_params=dparams)
    s = make(cfg_, params_, **kw)
    reqs = submit(s)
    _drain(s)
    return [list(r.tokens) for r in reqs], s.stats(), reqs


def _both(submit, *, slots=3, **kw):
    """The reference's speculative scheduler, the port's, and the port's
    plain scheduler on the same traffic."""
    j, t = _sched_pair()
    port = functools.partial(Scheduler, device="cpu")
    want = _run(JScheduler, submit, *j, slots=slots, **kw)
    got = _run(port, submit, *t, slots=slots, **kw)
    plain = _run(port, submit, *t, spec=False, slots=slots, **kw)
    assert got[0] == want[0] == plain[0]
    for k in ("k", "verify_steps", "proposed", "accepted", "acceptance"):
        assert got[1]["speculative"][k] == want[1]["speculative"][k], k
    return got


def test_scheduler_stream_equality_uniform_k():
    streams, st, _ = _both(lambda s: [s.submit(p, max_new_tokens=12)
                                      for p in _PROMPTS])
    assert st["speculative"]["proposed"] > 0
    assert st["speculative"]["accepted"] > 0
    assert {"ttft_p50_s", "ttft_p99_s", "itl_p50_s",
            "itl_p99_s"} <= set(st["latency"])


def test_scheduler_mixed_per_request_k():
    _both(lambda s: [s.submit(_PROMPTS[0], max_new_tokens=12, speculate=1),
                     s.submit(_PROMPTS[1], max_new_tokens=12, speculate=2),
                     s.submit(_PROMPTS[2], max_new_tokens=12)])


@pytest.mark.parametrize("budget", [5, 7, 10])
def test_scheduler_no_overshoot_of_max_new_tokens(budget):
    _, _, reqs = _both(lambda s: [s.submit(p, max_new_tokens=budget)
                                  for p in _PROMPTS])
    assert [r.generated for r in reqs] == [budget] * len(reqs)


def test_scheduler_preempt_resume_replays_through_verify():
    def submit(s):
        r = s.submit(_PROMPTS[0], max_new_tokens=12)
        for _ in range(3):
            s.tick()
        s.preempt(0)
        return [r]
    _, _, reqs = _both(submit, slots=1)
    assert reqs[0].preemptions == 1


def test_scheduler_prefix_sharing_under_speculation():
    shared = [5, 9, 2, 7, 1, 8, 3, 6]            # two full pages at ps=4
    prompts = [shared + [11], shared + [13], shared + [17]]

    def submit(s):
        reqs = [s.submit(prompts[0], max_new_tokens=10)]
        for _ in range(4):                        # let the donor publish
            s.tick()
        return reqs + [s.submit(p, max_new_tokens=10) for p in prompts[1:]]
    _, st, reqs = _both(submit, prefix_cache=True)
    assert all(r.state.value == "finished" for r in reqs)
    assert st["prefix"]["tokens_reused"] > 0
    assert st["speculative"]["accepted"] > 0


def test_scheduler_speculation_knobs_fail_as_the_reference():
    """The constructor's checks (a draft given, greedy only, an
    attention-only draft, K >= 1) and ``submit(speculate=0)``'s FAILED
    request, against the reference's."""
    (jcfg, jparams, jdcfg, jdparams), (cfg, params, dcfg, dparams) = \
        _sched_pair()
    bad = [dict(speculate=0), dict(speculate=2),
           dict(speculate=2, temperature=0.5)]
    for kw in bad:
        with pytest.raises(ValueError):
            JScheduler(jcfg, jparams, slots=1, max_len=16,
                       **({**kw, "draft_cfg": jdcfg, "draft_params":
                           jdparams} if "temperature" in kw else kw))
        with pytest.raises(ValueError):
            Scheduler(cfg, params, slots=1, max_len=16, device="cpu",
                      **({**kw, "draft_cfg": dcfg, "draft_params": dparams}
                         if "temperature" in kw else kw))
    rec = ModelConfig(**_kw(pattern=("attn", "mamba")), kernel_impl="ref")
    with pytest.raises(ValueError, match="attention-only"):
        Scheduler(cfg, params, slots=1, max_len=16, device="cpu",
                  speculate=2, draft_cfg=rec, draft_params=dparams)
    s = Scheduler(cfg, params, slots=1, max_len=16, device="cpu",
                  speculate=2, draft_cfg=dcfg, draft_params=dparams)
    js = JScheduler(jcfg, jparams, slots=1, max_len=16, speculate=2,
                    draft_cfg=jdcfg, draft_params=jdparams)
    got, want = s.submit([1, 2], speculate=0), js.submit([1, 2], speculate=0)
    assert got.state.value == want.state.value == "failed"
    assert got.error == want.error
