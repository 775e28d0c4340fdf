"""Port parity for the chaos harness (``serve/chaos.py``) and the
scheduler's NaN guard, against ``repro.serve.chaos`` with the reference's
weights, on the CPU.

``FaultPlan`` equals the reference's fault for fault and workload for
workload on several seeds and configurations (``p_evict`` included).
``run_plan`` on the reference's chaos geometry (slots 2, max_len 16,
page_size 4, 6 pages, queue depth 3, guard on, a step clock) gives the
reference's ``ChaosReport`` (ticks, states, preemptions, NaN failures,
invariant checks, backpressured) and, request by request in submission
order (request ids count per process), the reference's states and token
streams.  Then the reference's own cases (``tests/test_chaos.py``) on the
port: every request terminal with the pool audited every tick, faults and
backpressure exercised, runs reproducible, preempt-resume bit for bit at
the logits level, the NaN guard failing only the offending slot, and no
plan-cache miss in steady state.  No tolerance: streams, states, counts
and logits are exact, but for the windowed (gemma3) and recurrent (xlstm)
resume cases, which hold the reference's allclose bar (their re-prefill
runs at the true length; a recurrent stack rebuilds its state by
re-prefill and replay)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import jax_tree_to_np
from repro.configs import get_arch as jget_arch
from repro.ft.straggler import StepWatchdog as JStepWatchdog
from repro.models.transformer import init_params as jinit
from repro.serve import chaos as jchaos
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import vx
from repro_torch.configs.base import get_arch
from repro_torch.ft.straggler import StepWatchdog
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve.chaos import ChaosConfig, FaultPlan, run_plan
from repro_torch.serve.lifecycle import RequestState, TERMINAL_STATES
from repro_torch.serve.scheduler import Scheduler

SEEDS = (0, 1, 2)
GEOM = dict(slots=2, max_len=16, page_size=4, num_pages=6, guard_nan=True,
            queue_depth=3)
PLAN_KW = dict(requests=6, steps=32, max_ticks=256)


@functools.lru_cache(maxsize=None)
def _jax(arch="qwen3-0.6b"):
    cfg = jget_arch(arch).smoke
    return cfg, jinit(cfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port(impl="ref", arch="qwen3-0.6b"):
    _, jparams = _jax(arch)
    cfg = dataclasses.replace(get_arch(arch).smoke, kernel_impl=impl)
    return cfg, params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")


class _StepClock:
    """Deterministic clock: each call advances a fixed quantum."""

    def __init__(self, dt=0.01):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _chaos_sched(**kw):
    cfg, params = _port()
    kw = {**GEOM, **kw}
    return Scheduler(cfg, params, watchdog=StepWatchdog(),
                     clock=_StepClock(), device="cpu", **kw)


def _ref_chaos_sched(**kw):
    cfg, params = _jax()
    kw = {**GEOM, **kw}
    return JScheduler(cfg, params, watchdog=JStepWatchdog(),
                      clock=_StepClock(), **kw)


def _summary(rep):
    return (rep.ticks, rep.states, rep.preemptions, rep.nan_failures,
            rep.invariant_checks, rep.backpressured)


def _per_request(rep):
    return [(r.state.value, r.tokens, r.error is not None)
            for r in rep.submitted]


# --------------------------- plans against the reference --------------------

PLAN_CASES = [dict(seed=s) for s in range(6)] + [
    dict(seed=3, p_evict=0.15), dict(seed=7, requests=12, steps=80),
    dict(seed=11, max_prompt=12, max_new_tokens=3, p_kill=0.3),
    dict(seed=2, p_evict=0.4, p_preempt=0.0, p_nan=0.0)]


@pytest.mark.parametrize("kw", PLAN_CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_fault_plan_matches_reference(kw):
    got = FaultPlan(ChaosConfig(**kw))
    want = jchaos.FaultPlan(jchaos.ChaosConfig(**kw))
    assert [dataclasses.astuple(f) for f in got.faults] == \
        [dataclasses.astuple(f) for f in want.faults]
    assert got.workload == want.workload
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)


def test_fault_plan_is_deterministic():
    a = FaultPlan(ChaosConfig(seed=3))
    b = FaultPlan(ChaosConfig(seed=3))
    assert a.faults == b.faults
    assert a.workload == b.workload
    c = FaultPlan(ChaosConfig(seed=4))
    assert a.faults != c.faults or a.workload != c.workload


def test_fault_plan_covers_the_vocabulary():
    kinds = set()
    for seed in range(8):
        kinds |= {f.kind for f in FaultPlan(ChaosConfig(seed=seed)).faults}
    assert kinds == {"preempt", "nan", "kill", "spike", "bad_prompt"}


# --------------------------- run_plan against the reference -----------------

@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_run_matches_reference(seed):
    """The same plan through the reference's scheduler and the port's:
    equal reports, and equal states and streams request by request."""
    want = jchaos.run_plan(_ref_chaos_sched(),
                           jchaos.FaultPlan(jchaos.ChaosConfig(
                               seed=seed, **PLAN_KW)))
    sched = _chaos_sched()
    got = run_plan(sched, FaultPlan(ChaosConfig(seed=seed, **PLAN_KW)))
    assert _summary(got) == _summary(want)
    assert _per_request(got) == _per_request(want)
    # liveness, typed terminal states, the audit every tick
    assert got.ticks < PLAN_KW["max_ticks"]
    assert sched.drained()
    assert got.all_terminal, got.states
    assert sum(got.states.values()) == len(got.submitted)
    for r in got.submitted:
        assert r.state in TERMINAL_STATES
        assert r.state is not RequestState.FAILED or r.error
    assert got.invariant_checks >= got.ticks
    assert sched.stats()["nan_failures"] == got.nan_failures


@pytest.mark.parametrize("impl", ["kernel", "kernel_dynamic"])
def test_chaos_run_same_under_every_policy(impl):
    """On the CPU the kernel policies take the wrappers' plain versions:
    the report and streams of the ``ref`` run."""
    cfg, params = _port(impl)
    runs = []
    for c in (cfg, _port()[0]):
        sched = Scheduler(c, params, watchdog=StepWatchdog(),
                          clock=_StepClock(), device="cpu", **GEOM)
        rep = run_plan(sched, FaultPlan(ChaosConfig(seed=0, **PLAN_KW)))
        runs.append((_summary(rep), _per_request(rep)))
    assert runs[0] == runs[1]


def test_chaos_exercises_faults_and_backpressure():
    """The seeded plans must hit the interesting paths."""
    preempts = nans = backpressured = 0
    for seed in SEEDS:
        rep = run_plan(_chaos_sched(),
                       FaultPlan(ChaosConfig(seed=seed, **PLAN_KW)))
        preempts += rep.preemptions
        nans += rep.nan_failures
        backpressured += rep.backpressured
    assert preempts > 0
    assert nans > 0
    assert backpressured > 0


def test_chaos_is_reproducible():
    outs = []
    for _ in range(2):
        rep = run_plan(_chaos_sched(), FaultPlan(ChaosConfig(
            seed=1, requests=5, steps=24, max_ticks=256)))
        outs.append([(r.state.value, tuple(r.tokens))
                     for r in rep.submitted])
    assert outs[0] == outs[1]


# --------------------------- preempt / resume oracle ------------------------

def _drive(sched, req, *, preempt_at=None, cap=64):
    """Tick until the request terminates, recording its slot's logits row
    keyed by the replay cursor; optionally preempt it once."""
    logits_by_pos = {}
    for t in range(cap):
        if req.terminal:
            break
        if preempt_at is not None and t == preempt_at and \
                req.state is RequestState.RUNNING:
            sched.preempt(req.slot)
        sched.tick()
        if req.slot is not None and sched.active[req.slot] and \
                sched.last_logits is not None:
            pos = sched._fed[req.slot]
            logits_by_pos[pos] = np.asarray(
                sched.last_logits[req.slot].float(), np.float32)
    return logits_by_pos


def _resume_oracle(arch, comparer):
    """Preempted once after 3 ticks against uninterrupted: the same stream
    (the reference's), and the logits at every shared replay position
    compared by ``comparer``."""
    cfg, params = _port(arch=arch)
    prompt, gen = [3, 5, 7, 9, 2], 8

    def mk():
        return Scheduler(cfg, params, slots=2, max_len=32, page_size=4,
                         device="cpu")

    a = mk()
    ra = a.submit(prompt, max_new_tokens=gen)
    la = _drive(a, ra)
    b = mk()
    rb = b.submit(prompt, max_new_tokens=gen)
    lb = _drive(b, rb, preempt_at=3)
    assert ra.state is rb.state is RequestState.FINISHED
    assert rb.preemptions == 1
    assert rb.tokens == ra.tokens
    shared = sorted(set(la) & set(lb))
    assert len(shared) >= gen - 1
    for pos in shared:
        comparer(la[pos], lb[pos], pos)
    jcfg, jparams = _jax(arch)
    j = JScheduler(jcfg, jparams, slots=2, max_len=32, page_size=4)
    rj = j.submit(prompt, max_new_tokens=gen)
    while not rj.terminal:
        j.tick()
    assert rb.tokens == rj.tokens


def test_preempt_resume_bit_exact_pad_safe():
    """Re-prefilling the prompt and replaying the generated tokens is the
    computation the uninterrupted run made: logits bit for bit at every
    shared replay position, and the reference's stream."""
    def bit_exact(x, y, pos):
        assert np.array_equal(x, y), \
            f"pos {pos}: maxdiff {np.abs(x - y).max()}"
    _resume_oracle("qwen3-0.6b", bit_exact)


def test_preempt_resume_allclose_windowed():
    """Windowed stack (gemma3 smoke, ring-window layers): allclose, the
    reference's bar (prefill at the true length), and its stream."""
    def close(x, y, pos):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5,
                                   err_msg=f"pos {pos}")
    _resume_oracle("gemma3-12b", close)


def test_preempt_resume_allclose_recurrent():
    """Recurrent stack (xlstm smoke): no page pool to restore; resume
    rebuilds the state by re-prefill and replay.  Allclose, the
    reference's bar, and its stream."""
    def close(x, y, pos):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5,
                                   err_msg=f"pos {pos}")
    _resume_oracle("xlstm-125m", close)


# --------------------------- NaN guard isolation ----------------------------

def _nan_guard_run(mk):
    solo = mk()
    r_solo = solo.submit([11, 13], max_new_tokens=6)
    while not r_solo.terminal:
        solo.tick()
    chaotic = mk()
    victim = chaotic.submit([2, 4, 6], max_new_tokens=6)
    neighbour = chaotic.submit([11, 13], max_new_tokens=6)
    chaotic.tick()                        # both admitted + first step
    taint = np.zeros(2, bool)
    taint[victim.slot] = True
    chaotic._taint = taint                # NaN logits for victim, once
    while not (victim.terminal and neighbour.terminal):
        chaotic.tick()
    return chaotic, victim, neighbour, r_solo


def test_nan_guard_fails_only_offending_slot():
    cfg, params = _port()
    chaotic, victim, neighbour, r_solo = _nan_guard_run(
        lambda: Scheduler(cfg, params, slots=2, max_len=16, page_size=4,
                          guard_nan=True, device="cpu"))
    assert victim.state is RequestState.FAILED
    assert "non-finite" in victim.error
    assert chaotic.nan_failures == 1
    assert chaotic.stats()["nan_failures"] == 1
    assert chaotic._taint is None         # the hook fires once
    assert neighbour.state is RequestState.FINISHED
    assert neighbour.tokens == r_solo.tokens
    assert chaotic.cache.pages_in_use() == 0
    chaotic.cache.check_invariants()
    jcfg, jparams = _jax()
    _, jv, jn, _ = _nan_guard_run(
        lambda: JScheduler(jcfg, jparams, slots=2, max_len=16, page_size=4,
                           guard_nan=True))
    assert (victim.tokens, neighbour.tokens) == (jv.tokens, jn.tokens)


def test_taint_keeps_the_logits_dtype_and_guard_off_changes_nothing():
    """The hook writes NaN in float32 and casts back; without a taint the
    guarded step's streams are the unguarded step's."""
    cfg, params = _port()
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    streams = []
    for guard in (False, True):
        s = Scheduler(bcfg, params, slots=2, max_len=16, page_size=4,
                      guard_nan=guard, device="cpu")
        reqs = [s.submit(p, max_new_tokens=5) for p in ([2, 4, 6], [9])]
        while not s.drained():
            s.tick()
        streams.append([r.tokens for r in reqs])
        assert s.nan_failures == 0
    assert streams[0] == streams[1]
    s = Scheduler(bcfg, params, slots=2, max_len=16, page_size=4,
                  guard_nan=True, device="cpu")
    s.submit([2, 4, 6], max_new_tokens=5)
    s.tick()
    s._taint = np.array([False, True])
    s.step()
    assert s.last_logits.dtype == torch.bfloat16
    assert torch.isnan(s.last_logits[1]).all()
    assert torch.isfinite(s.last_logits[0].float()).all()
    assert s.nan_failures == 0           # slot 1 was idle: nothing failed


# --------------------------- fast path untouched ----------------------------

def test_no_fault_clean_run_zero_steady_state_plan_misses():
    """Lifecycle machinery on (queue, watchdog, guard) but no fault fired:
    after the first step no decode step misses the plan cache."""
    cfg, params = _port("kernel")
    sched = Scheduler(cfg, params, slots=2, max_len=16, page_size=4,
                      watchdog=StepWatchdog(), guard_nan=True, device="cpu")
    r1 = sched.submit([3, 5, 7], max_new_tokens=8)
    r2 = sched.submit([2], max_new_tokens=8)
    sched.tick()
    sched.tick()
    warm = vx.PLANS.stats()
    while not (r1.terminal and r2.terminal):
        sched.tick()
    steady = vx.PLANS.stats()
    assert steady["misses"] == warm["misses"], (warm, steady)
    assert r1.state is RequestState.FINISHED
    assert r2.state is RequestState.FINISHED


# --------------------------- chaos under speculation -------------------------

@functools.lru_cache(maxsize=None)
def _drafts():
    """The reference CLI's draft (the target's arch, weights from seed 1),
    for the reference and the port."""
    cfg, _ = _jax()
    jd = jinit(cfg, jax.random.key(1))
    pcfg, _ = _port()
    return (dict(speculate=4, draft_cfg=cfg, draft_params=jd),
            dict(speculate=4, draft_cfg=pcfg, draft_params=params_from_jax(
                jax_tree_to_np(jd), pcfg, device="cpu")))


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_run_speculative_matches_reference(seed):
    """The seeded plan through K=4 speculative schedulers: the reference's
    report, states and streams, and its speculative counts (preemption
    replays through the verify batch, NaN taints a (B, K) verify)."""
    jkw, kw = _drafts()
    jsched = _ref_chaos_sched(**jkw)
    want = jchaos.run_plan(jsched, jchaos.FaultPlan(jchaos.ChaosConfig(
        seed=seed, **PLAN_KW)))
    sched = _chaos_sched(**kw)
    got = run_plan(sched, FaultPlan(ChaosConfig(seed=seed, **PLAN_KW)))
    assert _summary(got) == _summary(want)
    assert _per_request(got) == _per_request(want)
    assert sched.stats()["speculative"] == jsched.stats()["speculative"]
    assert sched.spec_steps > 0
    assert got.all_terminal and sched.drained()


def test_chaos_run_speculative_int8_holds_the_audit():
    """Speculation over an int8 pool under the seeded plan (rejected beats
    may have widened a surviving page's scale): every request terminal,
    the scale-extended audit every tick, drained."""
    _, kw = _drafts()
    sched = _chaos_sched(kv_quant="int8", debug_invariants=True, **kw)
    rep = run_plan(sched, FaultPlan(ChaosConfig(seed=0, **PLAN_KW)))
    assert rep.all_terminal and sched.drained()
    assert rep.invariant_checks >= rep.ticks
    assert sched.spec_steps > 0
    for r in rep.submitted:
        assert r.state is not RequestState.FAILED or r.error
