"""Port parity for prefix sharing: the radix trie (``serve/prefix_cache.py``)
and the scheduler with ``prefix_cache=True``.

The trie is held against ``repro.serve.prefix_cache.PrefixCache`` on one
seeded sequence of acquire / publish / release / evict calls: equal
``PrefixMatch``es, evicted ids, page refs and ``stats()``.  The scheduler
with ``prefix_cache=True, chunk_pages=2`` is held against the reference
scheduler on staggered traffic with a shared prefix and a partial-tail
fork: equal greedy streams, and equal page tables, positions, refcounts
and free stacks after every tick.  Then the reference's own cases
(``tests/test_prefix.py``): a K-page prefix occupies K shared pages, the
shared pages survive the donor's release, decode is bit-exact against
the non-shared oracle, a partial tail forks one copy-on-write page,
mid-prefill preemption resumes bit-exactly, the retry hint counts the
prefill backlog, the trie evicts orphans under pressure, and steady state
makes no plan-cache miss.  The chaos cases: seeded plans with forced trie
eviction over the prefix-sharing pool with chunked prefill terminate every
request typed with the refcount audit clean every tick, with the
reference's report, states and streams; the plans do evict.  No tolerance
anywhere: bookkeeping and token streams are exact."""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from _torch_bridge import jax_tree_to_np
from repro.configs import get_arch as jget_arch
from repro.models.transformer import init_params as jinit
from repro.serve import chaos as jchaos
from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import vx
from repro_torch.configs.base import get_arch
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve.chaos import ChaosConfig, FaultPlan, run_plan
from repro_torch.serve.lifecycle import (AdmissionError, RequestState,
                                         TERMINAL_STATES)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Scheduler

# 12 tokens = exactly 3 pages at page_size=4 — the shared system prompt
SHARED = [3, 5, 7, 9, 2, 4, 6, 8, 1, 3, 5, 7]


@functools.lru_cache(maxsize=None)
def _jax():
    cfg = jget_arch("qwen3-0.6b").smoke
    return cfg, jinit(cfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port():
    _, jparams = _jax()
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl="ref")
    return cfg, params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")


def _sched(**kw):
    cfg, params = _port()
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 16)
    kw.setdefault("debug_invariants", True)
    kw.setdefault("prefix_cache", True)
    return Scheduler(cfg, params, device="cpu", **kw)


class _StepClock:
    def __init__(self, dt=0.01):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


# --------------------------- the trie against the reference -----------------

def test_trie_matches_reference_on_a_seeded_sequence():
    """400 seeded calls (acquire on prompts drawn from a few shared stems,
    publish with a table row of fresh page ids, release, evict) on both
    tries: every PrefixMatch, published and evicted id list, page-ref
    vector, page / orphan count and stats() equal."""
    rng = np.random.default_rng(0)
    ps, num_pages = 4, 64
    ours, ref = PrefixCache(ps, num_pages), JPrefixCache(ps, num_pages)
    stems = [rng.integers(0, 6, 16).tolist() for _ in range(3)]
    next_page = 0
    live = set()
    for _ in range(400):
        op = rng.choice(["acquire", "publish", "release", "evict"],
                        p=[0.4, 0.3, 0.2, 0.1])
        slot = int(rng.integers(0, 4))
        if op in ("acquire", "publish"):
            stem = stems[int(rng.integers(0, 3))]
            cut = int(rng.integers(0, len(stem) + 1))
            toks = stem[:cut] + rng.integers(0, 6, int(rng.integers(
                0, 9))).tolist()
            if op == "acquire":
                a, b = ours.acquire(slot, toks), ref.acquire(slot, toks)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                row = np.full(8, -1, np.int32)
                n = len(toks) // ps
                row[:n] = (next_page + np.arange(n)) % num_pages
                next_page += n
                assert ours.publish(slot, toks, row) == \
                    ref.publish(slot, toks, row)
            live.add(slot)
        elif op == "release":
            ours.release(slot)
            ref.release(slot)
        else:
            n = int(rng.integers(1, 4))
            assert ours.evict(n) == ref.evict(n)
        np.testing.assert_array_equal(ours.page_refs(), ref.page_refs())
        assert ours.pages() == ref.pages()
        assert ours.orphan_pages() == ref.orphan_pages()
        assert ours.stats() == ref.stats()
    assert ours.stats()["hits"] > 0 and ours.stats()["evicted"] > 0


# --------------------------- the scheduler against the reference ------------

def _state(sched):
    st = sched.cache.state
    return {k: np.asarray(st[k]) for k in ("table", "pos", "ref", "free",
                                           "free_top")}


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_scheduler_prefix_matches_reference_tick_by_tick(kv_quant):
    """prefix_cache=True, chunk_pages=2, page_size 4: request 0 (a 3-page
    shared prefix and a tail) first; once it has published, three more:
    one sharing the whole prefix, one diverging two tokens into the third
    page (a partial-tail fork), one with no shared prefix.  Every tick the
    page tables, positions, refcounts and free stacks are equal; the
    streams and the trie's stats are equal at the end."""
    jcfg, jparams = _jax()
    cfg, params = _port()
    prompts = [SHARED + [11, 13, 17], SHARED + [12, 10],
               SHARED[:10] + [9, 9, 12], [21, 22, 23, 24, 25, 26, 27]]
    kw = dict(slots=3, max_len=32, page_size=4, num_pages=24,
              prefix_cache=True, chunk_pages=2, kv_quant=kv_quant,
              debug_invariants=True)
    scheds = (JScheduler(jcfg, jparams, **kw),
              Scheduler(cfg, params, device="cpu", **kw))
    reqs = [[s.submit(prompts[0], max_new_tokens=5)] for s in scheds]
    for tick in range(80):
        if tick == 3:
            for s, r in zip(scheds, reqs):
                assert r[0].state is not RequestState.QUEUED
                r += [s.submit(p, max_new_tokens=5) for p in prompts[1:]]
        for s in scheds:
            s.tick()
        want, got = (_state(s) for s in scheds)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"tick {tick} {k}")
        if all(s.drained() for s in scheds):
            break
    assert all(s.drained() for s in scheds)
    assert [r.tokens for r in reqs[1]] == [r.tokens for r in reqs[0]]
    assert scheds[1].stats()["prefix"] == scheds[0].stats()["prefix"]
    assert scheds[1].stats()["prefix"]["hits"] >= 2
    assert scheds[1].cache.forks >= 1


# --------------------------- the reference's own cases ----------------------

def test_k_page_prefix_occupies_k_shared_pages():
    sched = _sched()
    sched.add_request(SHARED + [11, 13])
    ref = sched.cache.page_refcounts()
    assert int((ref == 2).sum()) == 3, ref[ref > 0]
    sb = sched.add_request(SHARED + [12, 10])
    st = sched.stats()
    assert st["prefix"]["hits"] >= 1
    assert st["prefix"]["tokens_reused"] >= 12
    ref = sched.cache.page_refcounts()
    assert int((ref == 3).sum()) == 3, ref[ref > 0]
    assert int((ref > 3).sum()) == 0
    assert st["shared_pages"] == 3
    tail = int(sched.cache.table_row(sb)[3])
    assert tail >= 0 and int(ref[tail]) == 1
    sched.cache.check_invariants()


def test_shared_pages_survive_donor_release():
    sched = _sched()
    sa = sched.add_request(SHARED + [11, 13])
    sb = sched.add_request(SHARED + [12, 10])
    first = sched.step()[sb]
    sched.finish(sa)
    ref = sched.cache.page_refcounts()
    assert int((ref == 2).sum()) == 3
    sched.cache.check_invariants()
    nxt = sched.step()[sb]
    assert int(first) >= 0 and int(nxt) >= 0


def test_prefix_decode_bit_exact_vs_nonshared_oracle():
    pa, pb = SHARED + [11, 13], SHARED + [12, 10]
    shared, oracle = _sched(), _sched(prefix_cache=False)
    outs = {}
    for name, s in (("shared", shared), ("oracle", oracle)):
        a, b = s.add_request(list(pa)), s.add_request(list(pb))
        outs[name] = [(st[a], st[b]) for st in (s.step() for _ in range(6))]
        s.cache.check_invariants()
    assert shared.stats()["prefix"]["hits"] >= 1
    assert oracle.prefix is None
    assert outs["shared"] == outs["oracle"]


def test_partial_tail_fork_is_copy_on_write_and_bit_exact():
    pa = [3, 5, 7, 9, 2, 4, 6, 8, 11]
    pb = [3, 5, 7, 9, 2, 4, 9, 9, 12]
    shared, oracle = _sched(), _sched(prefix_cache=False)
    outs = {}
    for name, s in (("shared", shared), ("oracle", oracle)):
        a, b = s.add_request(list(pa)), s.add_request(list(pb))
        outs[name] = [(st[a], st[b]) for st in (s.step() for _ in range(6))]
        s.cache.check_invariants()
    assert shared.stats()["prefix"]["tokens_reused"] == 6
    assert shared.cache.forks == 1
    ref = shared.cache.page_refcounts()
    assert int((ref == 3).sum()) == 1
    assert outs["shared"] == outs["oracle"]


def test_donor_pages_unchanged_after_borrower_decodes():
    """Copy-on-write under in-place writes: after the borrower adopts the
    donor's pages (and forks its partial tail) and decodes, the donor's
    shared pages hold the same bytes as before."""
    sched = _sched()
    sched.add_request(SHARED + [11, 13])
    donor = [int(p) for p in sched.cache.table_row(0)[:3]]
    before = {k: v[:, donor].clone()
              for k, v in sched.cache.state["blocks"].items()}
    sched.add_request(SHARED[:10] + [9, 9, 12])
    for _ in range(6):
        sched.step()
    for k, v in sched.cache.state["blocks"].items():
        assert (v[:, donor] == before[k]).all(), k


def test_mid_prefill_preempt_then_resume_bit_exact():
    prompt = SHARED + [11]
    oracle = _sched(slots=1, chunk_pages=1, clock=_StepClock())
    ra = oracle.submit(list(prompt), max_new_tokens=4)
    for _ in range(32):
        if ra.terminal:
            break
        oracle.tick()
    assert ra.state is RequestState.FINISHED
    sched = _sched(slots=1, chunk_pages=1, clock=_StepClock())
    rb = sched.submit(list(prompt), max_new_tokens=4)
    preempted = False
    for _ in range(64):
        if rb.terminal:
            break
        if not preempted and rb.state is RequestState.PREFILLING:
            sched.preempt(rb.slot)
            preempted = True
            assert rb.state is RequestState.QUEUED
        sched.tick()
    assert preempted
    assert rb.state is RequestState.FINISHED and rb.preemptions == 1
    assert rb.tokens == ra.tokens
    sched.cache.check_invariants()


def test_retry_after_accounts_for_pending_prefill_chunks():
    sched = _sched(slots=1, chunk_pages=1, queue_depth=2,
                   clock=_StepClock())
    sched.add_request([3, 5, 7])
    sched._step_ewma = 0.01
    h0 = sched._retry_after()
    assert h0 == pytest.approx(0.01)
    sched.submit(SHARED + [11, 13], max_new_tokens=2)
    h1 = sched._retry_after()
    assert h1 > h0
    sched.submit(SHARED + [12, 10], max_new_tokens=2)
    h2 = sched._retry_after()
    assert h2 > h1
    with pytest.raises(AdmissionError) as ei:
        sched.submit(SHARED + [10, 14], max_new_tokens=2)
    assert ei.value.retry_after >= h2 > 0.01


def test_trie_evicts_orphans_under_pool_pressure():
    sched = _sched(slots=2, max_len=16, num_pages=8)
    sa = sched.add_request(SHARED + [11])
    sched.finish(sa)
    ref = sched.cache.page_refcounts()
    assert int((ref == 1).sum()) == 3
    sched.add_request([21, 22, 23, 24, 25, 26, 27, 28, 29, 21, 22, 23, 24])
    sched.add_request([31, 32, 33, 34, 35, 36, 37, 38, 31, 32])
    assert sched.stats()["prefix"]["evicted"] >= 1
    sched.cache.check_invariants()


def test_zero_steady_state_misses_with_prefix_on():
    sched = _sched()
    sched.add_request(SHARED + [11, 13])
    sched.add_request(SHARED + [12, 10])
    sched.step()
    warm = vx.PLANS.stats()
    for _ in range(4):
        sched.step()
    steady = vx.PLANS.stats()
    assert steady["misses"] == warm["misses"], (warm, steady)
    assert steady["evictions"] == warm["evictions"], (warm, steady)


def test_prefix_cache_gated_to_attention_only_stacks():
    """The trie is on only for attention-only stacks, as in the reference
    (every block of the port's models is attention)."""
    sched = _sched()
    assert isinstance(sched.prefix, PrefixCache)
    assert sched.cache.external_ref == sched.prefix.page_refs
    assert _sched(prefix_cache=False).prefix is None


# --------------------------- chaos: refcount conservation --------------------

CHAOS_GEOM = dict(slots=2, max_len=16, page_size=4, num_pages=8,
                  guard_nan=True, queue_depth=3, prefix_cache=True,
                  chunk_pages=1, debug_invariants=True)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_chaos_refcount_conservation_with_prefix_and_chunks(seed):
    """Seeded chaos over the prefix-sharing pool with chunked prefill:
    preempt / kill / evict faults land mid-prefill, yet every request
    terminates typed and the refcount audit (table counts + trie pins ==
    device refcounts) passes every tick; the report, states and streams
    are the reference's."""
    plan_kw = dict(seed=seed, requests=6, steps=32, max_ticks=256,
                   p_evict=0.15)
    sched = _sched(clock=_StepClock(), **CHAOS_GEOM)
    report = run_plan(sched, FaultPlan(ChaosConfig(**plan_kw)))
    assert report.ticks < plan_kw["max_ticks"]
    assert sched.drained()
    assert report.all_terminal, report.states
    for r in report.submitted:
        assert r.state in TERMINAL_STATES
    assert report.invariant_checks >= report.ticks
    jcfg, jparams = _jax()
    jsched = JScheduler(jcfg, jparams, clock=_StepClock(), **CHAOS_GEOM)
    want = jchaos.run_plan(jsched,
                           jchaos.FaultPlan(jchaos.ChaosConfig(**plan_kw)))
    assert (report.ticks, report.states, report.preemptions,
            report.nan_failures, report.backpressured) == \
        (want.ticks, want.states, want.preemptions, want.nan_failures,
         want.backpressured)
    assert [(r.state.value, r.tokens) for r in report.submitted] == \
        [(r.state.value, r.tokens) for r in want.submitted]
    assert sched.stats()["prefix"] == jsched.stats()["prefix"]


def test_chaos_plans_actually_evict():
    """The evict fault fires somewhere across the seed set, and lands on a
    trie that holds pages."""
    kinds = set()
    for seed in (0, 1, 2):
        kinds |= {f.kind for f in FaultPlan(
            ChaosConfig(seed=seed, p_evict=0.15)).faults}
    assert "evict" in kinds
    evicted = 0
    for seed in (0, 1, 2):
        sched = _sched(clock=_StepClock(), **CHAOS_GEOM)
        run_plan(sched, FaultPlan(ChaosConfig(
            seed=seed, requests=6, steps=32, max_ticks=256, p_evict=0.15)))
        evicted += sched.stats()["prefix"]["evicted"]
    assert evicted > 0
