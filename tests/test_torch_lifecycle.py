"""Port parity for the request lifecycle (``serve/lifecycle.py``), the pool
audit and the scheduler's lifecycle surface: the cases of the reference's
``tests/test_lifecycle.py`` that no other ``test_torch_*`` file holds, on
the port, with the reference's weights, and where the outcome is a value,
against the reference's.

The state machine's edges equal the reference's table; the admission
queue's order, backpressure, requeue and expiry, the seeded backoff
schedule and ``retry_with_backoff``, the step watchdog's breach after
history, the pool audit catching aliasing, free-stack corruption and a
pos / table divergence, ``submit`` / ``tick`` to ``max_new_tokens``,
malformed prompts, the retry hint, the preemption victim policy and
requeue, double finish, the sampling knobs and ``summarize``.  No
tolerance: every comparison is exact.  Held elsewhere:
``test_watchdog_hard_limit`` (``test_torch_straggler.py``, the
``hard-limit`` case) and ``test_deadline_times_out_queued_and_running``
(``test_torch_serve.py::test_deadlines_expire_queued_and_running_work``)."""
import dataclasses
import functools

import jax
import pytest
import torch

from _torch_bridge import jax_tree_to_np
from repro.configs import get_arch as jget_arch
from repro.ft import straggler as jstraggler
from repro.models.transformer import init_params as jinit
from repro.serve import lifecycle as jlifecycle
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.configs.base import get_arch
from repro_torch.ft.straggler import StepWatchdog, StragglerConfig
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import lifecycle
from repro_torch.serve.lifecycle import (AdmissionError, AdmissionQueue,
                                         LifecycleError, Request,
                                         RequestState, backoff_delays,
                                         retry_with_backoff, summarize)
from repro_torch.serve.paged_cache import InvariantViolation
from repro_torch.serve.scheduler import Scheduler


@functools.lru_cache(maxsize=None)
def _jax():
    cfg = jget_arch("qwen3-0.6b").smoke
    return cfg, jinit(cfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port():
    _, jparams = _jax()
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl="ref")
    return cfg, params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")


def _sched(slots=2, max_len=16, **kw):
    cfg, params = _port()
    kw.setdefault("page_size", 4)
    return Scheduler(cfg, params, slots=slots, max_len=max_len,
                     device="cpu", **kw)


def _ref_sched(slots=2, max_len=16, **kw):
    cfg, params = _jax()
    kw.setdefault("page_size", 4)
    return JScheduler(cfg, params, slots=slots, max_len=max_len, **kw)


# --------------------------- state machine ----------------------------------

def test_transition_table_matches_reference():
    got = {a.value: sorted(b.value for b in bs)
           for a, bs in lifecycle._TRANSITIONS.items()}
    want = {a.value: sorted(b.value for b in bs)
            for a, bs in jlifecycle._TRANSITIONS.items()}
    assert got == want
    assert {s.value for s in lifecycle.TERMINAL_STATES} == \
        {s.value for s in jlifecycle.TERMINAL_STATES}


def test_request_state_machine_legal_path():
    r = Request(prompt=[1, 2, 3], max_new_tokens=4)
    assert r.state is RequestState.QUEUED
    r.to(RequestState.PREFILLING)
    r.to(RequestState.RUNNING)
    r.to(RequestState.PREEMPTED)
    assert r.preemptions == 1
    r.to(RequestState.QUEUED)
    r.to(RequestState.PREFILLING)
    r.to(RequestState.RUNNING)
    r.to(RequestState.MIGRATING)
    assert r.migrations == 1
    r.to(RequestState.QUEUED)
    r.to(RequestState.PREFILLING)
    r.to(RequestState.RUNNING)
    r.to(RequestState.FINISHED)
    assert r.terminal


def test_request_state_machine_rejects_illegal_edges():
    r = Request(prompt=[1])
    with pytest.raises(LifecycleError, match="illegal transition"):
        r.to(RequestState.RUNNING)          # must prefill first
    r.to(RequestState.PREFILLING)
    r.to(RequestState.RUNNING)
    r.to(RequestState.FINISHED)
    for s in RequestState:                  # terminal states are absorbing
        with pytest.raises(LifecycleError):
            r.to(s)


def test_prefilling_preempt_edge_legal_but_not_a_shortcut():
    r = Request(prompt=[1, 2, 3])
    r.to(RequestState.PREFILLING)
    r.to(RequestState.PREEMPTED)
    r.to(RequestState.QUEUED)
    r.to(RequestState.PREFILLING)
    for bad in (RequestState.FINISHED, RequestState.QUEUED):
        with pytest.raises(LifecycleError, match="illegal transition"):
            r.to(bad)


def test_request_generated_and_expiry():
    r = Request(prompt=[1, 2], deadline=5.0)
    assert r.generated == 0
    r.tokens += [7, 8, 9]
    assert r.generated == 3
    assert not r.expired(4.9) and r.expired(5.0)


# --------------------------- admission queue --------------------------------

def test_queue_priority_then_fifo_order():
    q = AdmissionQueue(8)
    lo1 = Request(prompt=[1], priority=0)
    hi = Request(prompt=[2], priority=5)
    lo2 = Request(prompt=[3], priority=0)
    for r in (lo1, hi, lo2):
        q.push(r)
    assert q.peek() is hi
    assert q.pop() is hi
    assert q.pop() is lo1                   # FIFO within a priority
    assert q.pop() is lo2
    assert q.pop() is None and q.peek() is None


def test_queue_backpressure_is_typed_with_retry_after():
    q = AdmissionQueue(2, retry_after_hint=lambda: 0.5)
    q.push(Request(prompt=[1]))
    q.push(Request(prompt=[2]))
    with pytest.raises(AdmissionError) as ei:
        q.push(Request(prompt=[3]))
    assert ei.value.retry_after == pytest.approx(0.5 * 3)
    assert q.rejected == 1
    q.push(Request(prompt=[4]), force=True)
    assert len(q) == 3
    with pytest.raises(ValueError):
        AdmissionQueue(0)


def test_queue_preempted_requeue_keeps_arrival_order():
    q = AdmissionQueue(8)
    a = Request(prompt=[1])
    b = Request(prompt=[2])
    q.push(a), q.push(b)
    got = q.pop()
    assert got is a
    got.to(RequestState.PREFILLING)
    got.to(RequestState.RUNNING)
    got.to(RequestState.PREEMPTED)
    q.push(got, force=True)                 # resumes AHEAD of b
    assert q.pop() is a


def test_queue_expire_times_out_stale_requests():
    q = AdmissionQueue(8)
    fresh = Request(prompt=[1], deadline=10.0)
    stale = Request(prompt=[2], deadline=1.0)
    q.push(fresh), q.push(stale)
    dead = q.expire(now=5.0)
    assert dead == [stale] and stale.state is RequestState.TIMED_OUT
    assert len(q) == 1


# --------------------------- backoff policy ---------------------------------

@pytest.mark.parametrize("kw", [dict(base=0.05, cap=0.4, seed=7),
                                dict(base=0.05, cap=0.4, seed=8),
                                dict(base=0.01, cap=2.0, jitter=0.0),
                                dict(base=0.3, cap=1.0, jitter=0.9, seed=3)])
def test_backoff_schedule_matches_reference(kw):
    got = backoff_delays(6, **kw)
    assert got == jlifecycle.backoff_delays(6, **kw)
    assert all(0 < d <= kw["cap"] for d in got)


def test_backoff_deterministic_and_bounded():
    d1 = backoff_delays(6, base=0.05, cap=0.4, seed=7)
    assert d1 == backoff_delays(6, base=0.05, cap=0.4, seed=7)
    assert d1 != backoff_delays(6, base=0.05, cap=0.4, seed=8)
    assert all(0 < d <= 0.4 for d in d1)


def test_retry_with_backoff_honours_retry_after_and_gives_up():
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise AdmissionError("full", retry_after=0.75)
        return "ok"

    out = retry_with_backoff(flaky, retries=5, base=0.01, seed=0,
                             sleep=slept.append)
    assert out == "ok" and len(calls) == 3
    assert all(s >= 0.75 for s in slept)

    def always():
        raise AdmissionError("full")

    with pytest.raises(AdmissionError):
        retry_with_backoff(always, retries=2, base=1e-6, sleep=slept.append)


# --------------------------- step watchdog ----------------------------------

def test_watchdog_flags_deadline_breach_after_history():
    traces = []
    for mod in (jstraggler, None):
        wd = (mod.StepWatchdog(mod.StragglerConfig(
            window=8, factor=2.0, min_history=3)) if mod else
            StepWatchdog(StragglerConfig(window=8, factor=2.0,
                                         min_history=3)))
        flags = [wd.observe(10.0)] + [wd.observe(1.0) for _ in range(3)]
        deadline = wd.deadline()
        flags.append(wd.observe(50.0))
        traces.append((flags, deadline, wd.breaches, wd.last_breach,
                       wd.median()))
    assert traces[0] == traces[1]
    flags, deadline, breaches, last, median = traces[1]
    assert flags == [False, False, False, False, True]
    assert deadline == pytest.approx(2.0 * median)
    assert breaches == 1 and last == 50.0
    assert median <= 10.0                   # the breach stays out of history


# --------------------------- invariant auditing -----------------------------

def test_check_invariants_clean_engine():
    sched = _sched(slots=2, debug_invariants=True)
    sched.add_request([3, 5, 7])
    for _ in range(4):
        sched.step()
    sched.cache.check_invariants()
    sched.finish(0)
    sched.cache.check_invariants()
    assert sched.cache.invariant_checks > 4


def test_check_invariants_catches_page_aliasing():
    sched = _sched(slots=2)
    sched.add_request(3)
    sched.add_request(5)
    sched.step()
    tbl = sched.cache.state["table"]
    owned = tbl[tbl >= 0]
    tbl[1, 0] = owned[0]                    # alias slot 0's page into slot 1
    with pytest.raises(InvariantViolation, match="aliased"):
        sched.cache.check_invariants()


def test_check_invariants_catches_free_stack_corruption():
    sched = _sched(slots=2)
    sched.add_request(3)
    sched.step()
    st = sched.cache.state
    tbl = st["table"]
    st["free"][int(st["free_top"]) - 1] = int(tbl[tbl >= 0][0])
    with pytest.raises(InvariantViolation, match="both allocated and free"):
        sched.cache.check_invariants()


def test_check_invariants_catches_pos_table_divergence():
    sched = _sched(slots=2)
    sched.add_request(3)
    sched.step()
    sched.cache.state["pos"] = torch.zeros_like(sched.cache.state["pos"])
    with pytest.raises(InvariantViolation, match="pos"):
        sched.cache.check_invariants()


# --------------------------- lifecycle over the engine ----------------------

def test_submit_tick_finishes_at_max_new_tokens():
    got = []
    for sched in (_sched(slots=2), _ref_sched(slots=2)):
        r = sched.submit([3, 5, 7], max_new_tokens=4)
        ticks = 0
        while not r.terminal and ticks < 20:
            sched.tick()
            ticks += 1
        assert r.state.value == "finished"
        assert r.generated == 4
        assert r.tokens[:3] == [3, 5, 7]
        assert sched.drained()
        got.append((ticks, r.tokens))
    assert got[0] == got[1]


def test_submit_malformed_prompts_fail_typed():
    sched = _sched()
    empty = sched.submit([], max_new_tokens=2)
    assert empty.state is RequestState.FAILED and "empty" in empty.error
    big = sched.submit([0] * 99, max_new_tokens=2)
    assert big.state is RequestState.FAILED and "exceeds" in big.error
    bad_budget = sched.submit([1], max_new_tokens=0)
    assert bad_budget.state is RequestState.FAILED
    assert sched.drained() and sched.stats()["failed"] == 3


def test_admission_error_carries_retry_after():
    sched = _sched(slots=1)
    sched.add_request(3)
    sched.step()                            # establishes a step-time EWMA
    with pytest.raises(AdmissionError, match="no free slot") as ei:
        sched.add_request(5)
    assert ei.value.retry_after >= 0.0
    assert issubclass(AdmissionError, RuntimeError)


def test_preemption_victim_policy_priority_then_pages():
    for sched in (_sched(slots=3), _ref_sched(slots=3)):
        lo_small = sched.submit([1], max_new_tokens=50, priority=0)
        lo_big = sched.submit([2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=50,
                              priority=0)
        hi = sched.submit([9, 8], max_new_tokens=50, priority=5)
        sched.tick()
        sched.tick()
        assert all(r.state.value == "running"
                   for r in (lo_small, lo_big, hi))
        assert sched._slot_req[sched._victim()] is lo_big
        assert sched._slot_req[sched._victim(below_priority=1)] is not hi


def test_preempt_requeues_with_accumulated_tokens():
    sched = _sched(slots=1)
    r = sched.submit([3, 5, 7], max_new_tokens=30)
    sched.tick()
    sched.tick()
    got = sched.preempt(0)
    assert got is r
    assert r.state is RequestState.QUEUED and r.preemptions == 1
    assert len(r.tokens) > len(r.prompt)    # generated work preserved
    assert not sched.active[0]
    assert sched.cache.pages_in_use() == 0
    sched.tick()                            # resumes
    assert r.state is RequestState.RUNNING


def test_double_finish_returns_empty_and_clears_tokens():
    sched = _sched(slots=1)
    sched.add_request(42)
    sched.step()
    first = sched.finish(0)
    assert len(first) == 2
    assert sched.finish(0) == []
    assert sched.tokens[0] == []


def test_sampling_knob_validation_at_construction():
    with pytest.raises(ValueError, match="top_k"):
        _sched(top_k=0)
    with pytest.raises(ValueError, match="top_k"):
        _sched(top_k=-3, temperature=0.5)
    with pytest.raises(ValueError, match="temperature"):
        _sched(temperature=-0.1)
    _sched(top_k=1, temperature=0.0)
    _sched(top_k=None, temperature=1.5)


def test_summarize_histogram_matches_reference():
    outs = []
    for mod in (lifecycle, jlifecycle):
        rs = [mod.Request(prompt=[1]), mod.Request(prompt=[2]),
              mod.Request(prompt=[3])]
        rs[0].to(mod.RequestState.PREFILLING)
        rs[0].to(mod.RequestState.RUNNING)
        rs[0].to(mod.RequestState.FINISHED)
        rs[1].to(mod.RequestState.MIGRATING)
        outs.append(mod.summarize(rs))
    assert outs[0] == outs[1]
    h = summarize([Request(prompt=[1])])
    assert h["queued"] == 1 and h["preemptions"] == 0
    assert outs[0]["finished"] == 1 and outs[0]["migrations"] == 1
