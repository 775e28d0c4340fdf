"""Port parity for serving: the ci.yml smoke (3 requests, prompt length 8,
6 generated tokens, max_len 64) gives identical greedy token streams
through repro.serve.scheduler.Scheduler and the port's Scheduler with the
reference's weights; plus the port scheduler's own contracts (page
reclamation, zero steady-state plan-cache misses, preempt/resume,
seeded sampling)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import jax_tree_to_np
from repro.configs import get_arch as jget_arch
from repro.models.transformer import init_params as jinit
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import vx
from repro_torch.configs.base import get_arch
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve.scheduler import Scheduler

N_REQ, PROMPT_LEN, GEN, MAX_LEN = 3, 8, 6, 64


@functools.lru_cache(maxsize=None)
def _jax():
    cfg = jget_arch("qwen3-0.6b").smoke
    return cfg, jinit(cfg, jax.random.key(0))


def _port(impl="ref"):
    jcfg, jparams = _jax()
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl=impl)
    return cfg, params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")


def _prompts(seed=0, n=N_REQ, length=PROMPT_LEN, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).tolist() for _ in range(n)]


def _serve(sched, prompts, gen=GEN):
    reqs = [sched.submit(p, max_new_tokens=gen) for p in prompts]
    for _ in range(200):
        sched.tick()
        if sched.drained():
            break
    assert sched.drained()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("fuse_step", [True, False])
def test_ci_smoke_streams_match_reference(fuse_step):
    jcfg, jparams = _jax()
    cfg, params = _port()
    prompts = _prompts()
    want = _serve(JScheduler(jcfg, jparams, slots=N_REQ, max_len=MAX_LEN,
                             fuse_step=fuse_step), prompts)
    got = _serve(Scheduler(cfg, params, slots=N_REQ, max_len=MAX_LEN,
                           fuse_step=fuse_step, device="cpu"), prompts)
    assert got == want
    assert all(len(t) == PROMPT_LEN + GEN for t in got)


def test_kernel_policy_streams_match_ref_policy():
    """The kernel policy on the CPU takes the wrappers' plain version: the
    same streams as the ref policy."""
    prompts = _prompts(1)
    cfg, params = _port("ref")
    kcfg, _ = _port("kernel")
    a = _serve(Scheduler(cfg, params, slots=N_REQ, max_len=MAX_LEN,
                         device="cpu"), prompts)
    b = _serve(Scheduler(kcfg, params, slots=N_REQ, max_len=MAX_LEN,
                         device="cpu"), prompts)
    assert a == b


def test_finish_reclaims_pages():
    cfg, params = _port()
    s = Scheduler(cfg, params, slots=2, max_len=32, page_size=4,
                  device="cpu", debug_invariants=True)
    total = s.cache.free_pages()
    slot = s.add_request(list(range(1, 10)))
    for _ in range(5):
        s.step()
    assert s.cache.free_pages() < total
    toks = s.finish(slot)
    assert len(toks) == 9 + 5
    assert s.cache.free_pages() == total
    assert s.finish(slot) == []
    assert int(s.cache.state["table"].max()) == -1


def test_plan_cache_zero_steady_state_misses():
    cfg, params = _port("kernel")
    s = Scheduler(cfg, params, slots=2, max_len=MAX_LEN, device="cpu")
    s.add_request(_prompts(2, 1)[0])
    s.step()
    warm = vx.PLANS.stats()
    for _ in range(4):
        s.step()
    steady = vx.PLANS.stats()
    assert steady["misses"] == warm["misses"], (warm, steady)
    assert steady["evictions"] == warm["evictions"]


def test_preempt_resume_is_bit_exact():
    """A request preempted mid-decode resumes (re-prefill + replay) and
    produces the stream of an uninterrupted run."""
    cfg, params = _port()
    prompt = _prompts(3, 1, 10)[0]
    ref = _serve(Scheduler(cfg, params, slots=2, max_len=MAX_LEN,
                           page_size=4, device="cpu"), [prompt], gen=8)[0]
    s = Scheduler(cfg, params, slots=2, max_len=MAX_LEN, page_size=4,
                  device="cpu", debug_invariants=True)
    req = s.submit(prompt, max_new_tokens=8)
    for _ in range(6):
        s.tick()
    s.preempt(req.slot)
    for _ in range(100):
        s.tick()
        if s.drained():
            break
    assert req.tokens == ref
    assert req.preemptions == 1


def test_sampling_seeded_and_topk1_is_greedy():
    cfg, params = _port()
    prompts = _prompts(4, 2)
    kw = dict(slots=2, max_len=MAX_LEN, device="cpu")
    a = _serve(Scheduler(cfg, params, temperature=0.8, top_k=20, seed=7,
                         **kw), prompts)
    b = _serve(Scheduler(cfg, params, temperature=0.8, top_k=20, seed=7,
                         **kw), prompts)
    assert a == b
    g = _serve(Scheduler(cfg, params, **kw), prompts)
    k1 = _serve(Scheduler(cfg, params, temperature=0.8, top_k=1, seed=3,
                          **kw), prompts)
    assert g == k1


@pytest.mark.parametrize("knob", [dict(speculate=2), dict(prefix_cache=True),
                                  dict(kv_quant="int8"),
                                  dict(kv_quant="fp8")])
def test_waiting_knobs_raise(knob):
    cfg, params = _port()
    with pytest.raises(NotImplementedError):
        Scheduler(cfg, params, slots=1, max_len=16, device="cpu", **knob)


def test_sampling_knobs_validated():
    cfg, params = _port()
    with pytest.raises(ValueError):
        Scheduler(cfg, params, slots=1, max_len=16, device="cpu",
                  temperature=-1.0)
    with pytest.raises(ValueError):
        Scheduler(cfg, params, slots=1, max_len=16, device="cpu", top_k=0)
    free = Scheduler(cfg, params, slots=2, max_len=32, page_size=8,
                     device="cpu").cache.state["free"]
    assert torch.equal(free, torch.arange(7, -1, -1, dtype=torch.int32))


def test_cache_accounting_matches_reference():
    jcfg, jparams = _jax()
    cfg, params = _port()
    j = JScheduler(jcfg, jparams, slots=2, max_len=32, page_size=4)
    t = Scheduler(cfg, params, slots=2, max_len=32, page_size=4,
                  device="cpu")
    prompt = _prompts(5, 1, 9)[0]
    j.add_request(prompt)
    t.add_request(prompt)
    for name in ("page_bytes", "used_cache_bytes", "total_cache_bytes",
                 "pages_in_use", "free_pages"):
        assert getattr(t.cache, name)() == getattr(j.cache, name)(), name


def test_deadlines_expire_queued_and_running_work():
    cfg, params = _port()
    now = [0.0]
    s = Scheduler(cfg, params, slots=1, max_len=MAX_LEN, device="cpu",
                  clock=lambda: now[0])
    running = s.submit(_prompts(6, 1)[0], max_new_tokens=50, ttl=5.0)
    queued = s.submit(_prompts(7, 1)[0], max_new_tokens=2, ttl=1.0)
    s.tick()
    now[0] = 2.0
    done = s.tick()
    assert queued in done and queued.state.value == "timed_out"
    now[0] = 6.0
    done = s.tick()
    assert running in done and running.state.value == "timed_out"
    assert s.drained() and s.cache.free_pages() == s.cache.num_pages
