"""Port parity for the replica fleet (``serve/fleet.py``, ``engine.make_fleet``)
and fleet chaos (``serve/chaos.py``), against ``repro.serve.fleet`` with the
reference's weights, on the CPU.

The reference's own cases (``tests/test_fleet.py``) run on the port, each
also held against the same calls on the reference's router where the
outcome is observable: least-loaded routing with ties on the index,
backpressure aggregated with the minimum retry-after, pinned submits, kill
and queued-work migration, no live replica, hangs past and inside the
heartbeat bound, the DEGRADED drain and rejoin, 1 replica against 3,
migration == preemption == uninterrupted at the logits level bit for bit,
mid-prefill failover, and the audit catching double residency and a lost
request.  Fleet chaos on seeds 0-2 gives the reference's
``FleetChaosReport`` and its states and streams request by request
(submission order: request ids count per process).  Port-only: every
replica and every respawn reads the one weight copy the router cast, and
a dead replica's scheduler (pool, logits, watchdog) is freed at respawn.
No tolerance: streams, states, counts and logits are exact, except the
windowed and recurrent migration cases (gemma3's and xlstm's smoke
configs), held to the reference's ``rtol 2e-4 / atol 2e-5`` (their prefill
runs at the true length)."""
import dataclasses
import functools
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import jax_tree_to_np
from repro.configs import get_arch as jget_arch
from repro.models.transformer import init_params as jinit
from repro.serve import chaos as jchaos
from repro.serve import fleet as jfleet
from repro_torch import vx
from repro_torch.configs.base import get_arch
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve.chaos import (FleetChaosConfig, FleetFaultPlan,
                                     StepClock, run_fleet_plan)
from repro_torch.serve.engine import BatchedServer, make_fleet
from repro_torch.serve.fleet import (FleetAuditError, FleetRouter,
                                     ReplicaState)
from repro_torch.serve.lifecycle import (AdmissionError, RequestState,
                                         TERMINAL_STATES)

SEEDS = (0, 1, 2)
CHAOS_KW = dict(replicas=3, num_pages=6, queue_depth=3, guard_nan=True,
                hard_breach_limit=1, heartbeat_ticks=4)
CHAOS_PLAN = dict(requests=8, steps=32, max_ticks=512)


@functools.lru_cache(maxsize=None)
def _jax(arch="qwen3-0.6b"):
    cfg = jget_arch(arch).smoke
    return cfg, jinit(cfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port(impl="ref", arch="qwen3-0.6b"):
    _, jparams = _jax(arch)
    cfg = dataclasses.replace(get_arch(arch).smoke, kernel_impl=impl)
    return cfg, params_from_jax(jax_tree_to_np(jparams), cfg, device="cpu")


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 16)
    kw.setdefault("page_size", 4)
    kw.setdefault("clock", StepClock())
    kw.setdefault("watchdog_hard_limit", 30.0)
    return kw


def _fleet(replicas=3, impl="ref", arch="qwen3-0.6b", **kw):
    cfg, params = _port(impl, arch)
    return FleetRouter(cfg, params, replicas=replicas, device="cpu",
                       **_kw(kw))


def _ref_fleet(replicas=3, arch="qwen3-0.6b", **kw):
    cfg, params = _jax(arch)
    kw = _kw(kw)
    kw["clock"] = jchaos.StepClock()
    return jfleet.FleetRouter(cfg, params, replicas=replicas, **kw)


def _drain(fl, reqs, *, cap=256, audit=True):
    ticks = 0
    while not all(r.terminal for r in reqs) and ticks < cap:
        fl.tick()
        if audit:
            fl.audit()
        ticks += 1
    assert ticks < cap, "fleet failed to drain the requests"
    return ticks


def _view(reqs):
    return [(r.state.value, r.replica, r.migrations, r.tokens)
            for r in reqs]


def _fleet_view(fl):
    st = fl.stats()
    return (st["deaths"], st["respawns"], st["drains"], st["rejoins"],
            st["migrated"], st["ticks"], st["replicas"])


# --------------------------- admission routing -------------------------------

def test_least_loaded_routing_spreads_and_breaks_ties_on_index():
    views = []
    for fl in (_fleet(replicas=3), _ref_fleet(replicas=3)):
        reqs = [fl.submit([2, 3], max_new_tokens=4) for _ in range(3)]
        assert sorted(r.replica for r in reqs) == [0, 1, 2]
        r4 = fl.submit([2, 3], max_new_tokens=4)
        assert r4.replica == 0
        _drain(fl, reqs + [r4])
        views.append((_view(reqs + [r4]), _fleet_view(fl)))
    assert views[0] == views[1]


def test_backpressure_aggregates_across_replicas():
    fl = _fleet(replicas=2, slots=1, queue_depth=1)
    ok = [fl.submit([1, 2], max_new_tokens=4) for _ in range(2)]
    with pytest.raises(AdmissionError) as ei:
        fl.submit([1, 2], max_new_tokens=4)
    msg = str(ei.value)
    assert "r0" in msg and "r1" in msg
    assert msg.startswith("all replicas backpressured")
    assert ei.value.retry_after >= 0.0
    _drain(fl, ok)
    jf = _ref_fleet(replicas=2, slots=1, queue_depth=1)
    jok = [jf.submit([1, 2], max_new_tokens=4) for _ in range(2)]
    _drain(jf, jok)
    assert _view(ok) == _view(jok)


def test_backpressure_carries_the_minimum_retry_after():
    fl = _fleet(replicas=2, slots=1, queue_depth=1)
    ok = [fl.submit([1, 2], max_new_tokens=4) for _ in range(2)]
    fl.replicas[0].sched._step_ewma = 0.5
    fl.replicas[1].sched._step_ewma = 0.25
    with pytest.raises(AdmissionError) as ei:
        fl.submit([1, 2], max_new_tokens=4)
    hints = []
    for rep in fl.replicas:
        with pytest.raises(AdmissionError) as e1:
            rep.sched.submit([1, 2], max_new_tokens=4)
        hints.append(e1.value.retry_after)
    assert hints[0] != hints[1]
    assert ei.value.retry_after == min(hints)
    _drain(fl, ok)


def test_pinned_submit_to_unhealthy_replica_is_backpressure():
    fl = _fleet(replicas=2)
    fl.kill_replica(1)
    with pytest.raises(AdmissionError, match="replica 1 is dead"):
        fl.submit([1, 2], max_new_tokens=2, replica=1)
    r = fl.submit([1, 2], max_new_tokens=2)
    assert r.replica == 0
    _drain(fl, [r])


def test_malformed_traffic_comes_back_typed_failed():
    fl = _fleet(replicas=2)
    r = fl.submit([], max_new_tokens=2)
    assert r.state is RequestState.FAILED and r.error
    big = fl.submit([0] * 17, max_new_tokens=2)
    assert big.state is RequestState.FAILED and "exceeds" in big.error
    fl.audit()                               # terminal, never resident


# --------------------------- failover ----------------------------------------

def test_kill_migrates_resident_requests_and_respawns():
    views = []
    for fl in (_fleet(replicas=3), _ref_fleet(replicas=3)):
        reqs = [fl.submit([3 + i, 5, 7], max_new_tokens=8)
                for i in range(3)]
        for _ in range(2):
            fl.tick()
            fl.audit()
        victim = reqs[0].replica
        gen_before = fl.replicas[victim].generation
        fl.kill_replica(victim)
        fl.audit()
        assert reqs[0].migrations == 1
        assert reqs[0].replica != victim
        _drain(fl, reqs)
        assert all(r.state.value == "finished" for r in reqs)
        respawned = fl.replicas[victim]
        assert respawned.state.value == "healthy"
        assert respawned.generation == gen_before + 1
        assert respawned.sched.cache.pages_in_use() == 0
        assert fl.deaths == 1 and fl.respawns == 1
        views.append((_view(reqs), _fleet_view(fl)))
    assert views[0] == views[1]


def test_queued_work_on_dead_replica_migrates_too():
    views = []
    for fl in (_fleet(replicas=2, slots=1, queue_depth=4),
               _ref_fleet(replicas=2, slots=1, queue_depth=4)):
        reqs = [fl.submit([5, 6], max_new_tokens=6, replica=0)
                for _ in range(2)]
        fl.tick()
        fl.audit()
        assert reqs[0].state.value == "running"
        assert reqs[1].state.value == "queued"
        fl.kill_replica(0)
        fl.audit()
        assert {r.replica for r in reqs} == {1}
        assert all(r.migrations == 1 for r in reqs)
        _drain(fl, reqs)
        assert all(r.state.value == "finished" for r in reqs)
        views.append(_view(reqs))
    assert views[0] == views[1]


def test_no_live_replica_fails_typed_never_lost():
    fl = _fleet(replicas=1, respawn=False)
    r = fl.submit([4, 5, 6], max_new_tokens=8)
    fl.tick()
    assert r.state is RequestState.RUNNING
    fl.kill_replica(0)
    assert r.state is RequestState.FAILED
    assert "no live replica" in r.error
    fl.audit()
    assert fl.drained()
    with pytest.raises(AdmissionError, match="no healthy replica"):
        fl.submit([1], max_new_tokens=2)


# --------------------------- health: heartbeat + degraded --------------------

def test_hang_past_heartbeat_bound_is_dead_and_work_survives():
    views = []
    for fl in (_fleet(replicas=2, heartbeat_ticks=3),
               _ref_fleet(replicas=2, heartbeat_ticks=3)):
        reqs = [fl.submit([7, 8, 9], max_new_tokens=8, replica=i)
                for i in range(2)]
        fl.tick()
        victim = reqs[0].replica
        fl.hang_replica(victim, ticks=10)
        for _ in range(5):
            fl.tick()
            fl.audit()
        assert fl.deaths >= 1
        assert fl.replicas[victim].generation >= 1
        assert fl.replicas[victim].death_reason is None   # respawned
        _drain(fl, reqs)
        assert all(r.state.value == "finished" for r in reqs)
        assert reqs[0].migrations >= 1
        views.append((_view(reqs), _fleet_view(fl)))
    assert views[0] == views[1]


def test_short_hang_wakes_degrades_and_rejoins_after_drain():
    views = []
    for fl in (_fleet(replicas=2, heartbeat_ticks=6, hard_breach_limit=1),
               _ref_fleet(replicas=2, heartbeat_ticks=6,
                          hard_breach_limit=1)):
        reqs = [fl.submit([9, 8], max_new_tokens=10, replica=0)
                for _ in range(3)]
        other = fl.submit([4, 4], max_new_tokens=4, replica=1)
        fl.tick()
        fl.audit()
        fl.hang_replica(0, ticks=2)
        for _ in range(3):
            fl.tick()
            fl.audit()
        assert fl.drains == 1
        assert fl.deaths == 0
        resident0 = fl.replicas[0].sched.resident_rids()
        assert all(r.rid not in resident0 or r.slot is not None
                   for r in reqs)
        _drain(fl, reqs + [other])
        assert all(r.state.value == "finished" for r in reqs + [other])
        assert fl.rejoins == 1
        assert fl.replicas[0].state.value == "healthy"
        views.append((_view(reqs + [other]), _fleet_view(fl)))
    assert views[0] == views[1]


def test_degraded_replica_admits_nothing():
    fl = _fleet(replicas=2, hard_breach_limit=1)
    r0 = fl.submit([3, 3], max_new_tokens=12, replica=0)
    fl.tick()
    fl.replicas[0].sched.watchdog.observe(1e9)      # hard-limit breach
    fl.tick()
    assert fl.replicas[0].state is ReplicaState.DEGRADED
    with pytest.raises(AdmissionError, match="replica 0 is degraded"):
        fl.submit([1, 2], max_new_tokens=2, replica=0)
    r = fl.submit([1, 2], max_new_tokens=2)
    assert r.replica == 1
    _drain(fl, [r0, r])


# --------------------------- determinism oracles -----------------------------

def _trace(n=6, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(1, 5))
        out.append(([int(t) for t in rng.integers(0, 97, plen)],
                    int(rng.integers(2, 8))))
    return out


def _run_trace_through(fl, trace):
    reqs = []
    for prompt, gen in trace:
        req = None
        for _ in range(64):
            try:
                req = fl.submit(prompt, max_new_tokens=gen)
                break
            except AdmissionError:
                fl.tick()
        assert req is not None
        reqs.append(req)
    _drain(fl, reqs)
    return [tuple(r.tokens) for r in reqs]


def test_fleet_determinism_one_vs_n_replicas():
    """Same trace, no faults: 1 replica and 3 replicas give the same
    streams, the reference's; after warm-up no replica's step misses the
    plan cache."""
    trace = _trace()
    one = _run_trace_through(_fleet(replicas=1, impl="kernel"), trace)
    fl3 = _fleet(replicas=3, impl="kernel")
    for rep in fl3.replicas:
        rep.sched.step()
    warm = vx.PLANS.stats()
    three = _run_trace_through(fl3, trace)
    assert one == three
    assert vx.PLANS.stats()["misses"] == warm["misses"]
    assert one == _run_trace_through(_ref_fleet(replicas=3), trace)


def test_make_fleet_one_replica_is_the_batched_server():
    cfg, params = _port()
    trace = _trace(4, seed=3)
    fl = make_fleet(cfg, params, replicas=1, slots=2, max_len=16,
                    page_size=4, device="cpu")
    got = _run_trace_through(fl, trace)
    srv = BatchedServer(cfg, params, slots=2, max_len=16, page_size=4,
                        device="cpu")
    reqs = [srv.submit(p, max_new_tokens=g) for p, g in trace]
    while not srv.scheduler.drained():
        srv.tick()
    assert got == [tuple(r.tokens) for r in reqs]


def _logits_drive(fl, req, *, kill_at=None, preempt_at=None, cap=64):
    logits_by_pos = {}
    for t in range(cap):
        if req.terminal:
            break
        if kill_at is not None and t == kill_at and \
                req.state.value == "running":
            fl.kill_replica(req.replica, reason="oracle kill")
        if preempt_at is not None and t == preempt_at and \
                req.state.value == "running":
            fl.replicas[req.replica].sched.preempt(req.slot)
        fl.tick()
        fl.audit()
        rep = fl.replicas[req.replica] if req.replica is not None else None
        if rep is not None and rep.alive and req.slot is not None and \
                rep.sched.active[req.slot] and \
                rep.sched.last_logits is not None:
            pos = rep.sched._fed[req.slot]
            row = rep.sched.last_logits[req.slot]
            logits_by_pos[pos] = np.asarray(
                row.float() if isinstance(row, torch.Tensor) else row,
                np.float32)
    return logits_by_pos


def _migration_oracle(arch, comparer):
    """Kill-then-migrate, preempt-then-resume and uninterrupted: one
    stream (the reference's), and the logits at the shared replay
    positions compared by ``comparer``."""
    prompt, gen = [3, 5, 7, 9, 2], 8
    fa = _fleet(replicas=1, arch=arch)
    ra = fa.submit(prompt, max_new_tokens=gen)
    la = _logits_drive(fa, ra)
    fb = _fleet(replicas=2, arch=arch)
    rb = fb.submit(prompt, max_new_tokens=gen)
    lb = _logits_drive(fb, rb, kill_at=3)
    assert rb.migrations == 1
    fc = _fleet(replicas=1, arch=arch)
    rc = fc.submit(prompt, max_new_tokens=gen)
    lc = _logits_drive(fc, rc, preempt_at=3)
    assert rc.preemptions == 1
    for r in (ra, rb, rc):
        assert r.state is RequestState.FINISHED
    assert rb.tokens == ra.tokens
    assert rc.tokens == ra.tokens
    shared = sorted(set(la) & set(lb) & set(lc))
    assert len(shared) >= gen - 1
    for pos in shared:
        comparer(la[pos], lb[pos], pos)      # migrate == uninterrupted
        comparer(lc[pos], lb[pos], pos)      # migrate == preempt-resume
    jf = _ref_fleet(replicas=2, arch=arch)
    rj = jf.submit(prompt, max_new_tokens=gen)
    _logits_drive(jf, rj, kill_at=3)
    assert rj.tokens == rb.tokens and rj.migrations == 1


def test_migration_equals_preemption_bit_exact_pad_safe():
    """Kill-then-migrate == preempt-then-resume == uninterrupted, at the
    logits level, bit for bit; the stream is the reference's."""
    def bit_exact(x, y, pos):
        assert np.array_equal(x, y), pos
    _migration_oracle("qwen3-0.6b", bit_exact)


def test_migration_allclose_windowed():
    """Windowed stack (gemma3 smoke): allclose, the reference's bar, and
    the reference's stream."""
    def close(x, y, pos):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5,
                                   err_msg=f"pos {pos}")
    _migration_oracle("gemma3-12b", close)


def test_migration_allclose_recurrent():
    """Recurrent stack (xlstm smoke): migration re-prefills and replays
    the state on the other replica.  Allclose, the reference's bar, and
    the reference router's stream."""
    def close(x, y, pos):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5,
                                   err_msg=f"pos {pos}")
    _migration_oracle("xlstm-125m", close)


def test_midprefill_failover_resumes_bit_exact():
    prompt = [3, 5, 7, 9, 2, 4, 6, 8, 1, 3, 5, 7, 9]   # pre = 3 chunks
    gen = 6
    fa = _fleet(replicas=1, max_len=32, chunk_pages=1)
    ra = fa.submit(prompt, max_new_tokens=gen)
    _drain(fa, [ra])
    assert ra.state is RequestState.FINISHED
    fb = _fleet(replicas=2, max_len=32, chunk_pages=1)
    rb = fb.submit(prompt, max_new_tokens=gen)
    killed = False
    for _ in range(64):
        if rb.terminal:
            break
        if not killed and rb.state is RequestState.PREFILLING:
            fb.kill_replica(rb.replica, reason="mid-prefill kill")
            killed = True
        fb.tick()
        fb.audit()
    assert killed, "request never observed mid-prefill"
    assert rb.state is RequestState.FINISHED
    assert rb.migrations == 1
    assert rb.tokens == ra.tokens


# --------------------------- fleet audit negatives ---------------------------

def test_audit_catches_double_residency():
    fl = _fleet(replicas=2)
    r = fl.submit([2, 3], max_new_tokens=8)
    fl.tick()
    fl.replicas[1 - r.replica].sched.queue._q.append(r)
    with pytest.raises(FleetAuditError, match="double-resident"):
        fl.audit()


def test_audit_catches_lost_request():
    fl = _fleet(replicas=2, slots=1)
    fl.submit([2, 3], max_new_tokens=8, replica=0)
    b = fl.submit([2, 3], max_new_tokens=8, replica=0)
    fl.tick()
    assert b.state is RequestState.QUEUED
    fl.replicas[0].sched.queue.drain()
    with pytest.raises(FleetAuditError, match="lost"):
        fl.audit()


def test_audit_catches_terminal_resident_and_stuck_migrating():
    fl = _fleet(replicas=2, slots=1)
    fl.submit([2, 3], max_new_tokens=8, replica=0)
    b = fl.submit([2, 3], max_new_tokens=8, replica=0)
    fl.tick()
    b.to(RequestState.FAILED, error="forced")
    with pytest.raises(FleetAuditError, match="still resident"):
        fl.audit()
    fl2 = _fleet(replicas=2, slots=1)
    fl2.submit([2, 3], max_new_tokens=8, replica=0)
    c = fl2.submit([2, 3], max_new_tokens=8, replica=0)
    fl2.tick()
    fl2.replicas[0].sched.queue.drain()
    c.to(RequestState.MIGRATING)
    with pytest.raises(FleetAuditError, match="stuck MIGRATING"):
        fl2.audit()


# --------------------------- one weight copy, freed pools --------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_replicas_share_one_weight_copy(compute_dtype):
    """The router casts once; every replica, and every respawn, reads the
    same tensors (data_ptr equal leaf for leaf)."""
    cfg, params = _port()
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    fl = FleetRouter(cfg, params, replicas=3, slots=2, max_len=16,
                     page_size=4, device="cpu")
    base = [t.data_ptr() for t in _leaves(fl.params)]
    assert all(t.dtype == cfg.cdtype for t in _leaves(fl.params)
               if t.is_floating_point())
    fl.kill_replica(1)
    fl.tick()
    assert fl.respawns == 1
    for rep in fl.replicas:
        assert [t.data_ptr() for t in _leaves(rep.sched.params)] == base


def test_dead_replica_is_freed_at_respawn():
    fl = _fleet(replicas=2)
    r = fl.submit([3, 5, 7], max_new_tokens=6, replica=0)
    for _ in range(3):
        fl.tick()
    old = weakref.ref(fl.replicas[0].sched)
    old_pool = weakref.ref(fl.replicas[0].sched.cache)
    fl.kill_replica(0)
    assert old_pool().state is None and old().last_logits is None
    fl.tick()
    gc.collect()
    assert old() is None and old_pool() is None
    assert fl.replicas[0].generation == 1
    _drain(fl, [r])
    assert r.state is RequestState.FINISHED


# --------------------------- the chaos gate ----------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_chaos_matches_reference(seed):
    """The seeded fleet plan through the reference's router and the
    port's: equal reports, and equal states and streams request by
    request; every request terminal, the audit every tick, drained."""
    plan_kw = dict(seed=seed, **CHAOS_PLAN)
    fl = _fleet(**CHAOS_KW)
    got = run_fleet_plan(fl, FleetFaultPlan(FleetChaosConfig(**plan_kw)))
    want = jchaos.run_fleet_plan(
        _ref_fleet(**CHAOS_KW),
        jchaos.FleetFaultPlan(jchaos.FleetChaosConfig(**plan_kw)))
    fields = ("ticks", "states", "deaths", "respawns", "migrated", "drains",
              "backpressured", "audits", "recovered")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert [(r.state.value, r.tokens, r.migrations, r.error is not None)
            for r in got.submitted] == \
        [(r.state.value, r.tokens, r.migrations, r.error is not None)
         for r in want.submitted]
    assert got.ticks < CHAOS_PLAN["max_ticks"]
    assert fl.drained()
    assert got.all_terminal, got.states
    for r in got.submitted:
        assert r.state in TERMINAL_STATES
        assert r.state is not RequestState.FAILED or r.error
    assert got.audits == got.ticks
    assert not any((rep.death_reason or "").startswith("tick crashed")
                   for rep in fl.replicas)


def test_fleet_fault_plan_matches_reference():
    for kw in (dict(seed=s) for s in range(5)):
        got = FleetFaultPlan(FleetChaosConfig(**kw))
        want = jchaos.FleetFaultPlan(jchaos.FleetChaosConfig(**kw))
        assert [dataclasses.astuple(f) for f in got.faults] == \
            [dataclasses.astuple(f) for f in want.faults]
        assert got.workload == want.workload


def test_fleet_chaos_exercises_kills_and_migration():
    deaths = migrated = recovered = respawns = 0
    for seed in SEEDS:
        rep = run_fleet_plan(_fleet(**CHAOS_KW), FleetFaultPlan(
            FleetChaosConfig(seed=seed, **CHAOS_PLAN)))
        deaths += rep.deaths
        migrated += rep.migrated
        recovered += rep.recovered
        respawns += rep.respawns
    assert deaths > 0
    assert respawns > 0
    assert migrated > 0
    assert recovered > 0


def test_fleet_chaos_is_reproducible():
    outs = []
    for _ in range(2):
        kw = {k: v for k, v in CHAOS_KW.items() if k != "heartbeat_ticks"}
        rep = run_fleet_plan(_fleet(**kw), FleetFaultPlan(
            FleetChaosConfig(seed=1, requests=6, steps=24, max_ticks=512)))
        outs.append([(r.state.value, tuple(r.tokens))
                     for r in rep.submitted])
    assert outs[0] == outs[1]


def test_fleet_stats_roll_up_prefix_and_latency():
    views = []
    for fl in (_fleet(replicas=2, max_len=32, prefix_cache=True),
               _ref_fleet(replicas=2, max_len=32, prefix_cache=True)):
        shared = [3, 5, 7, 9, 2, 4, 6, 8]
        a = fl.submit(shared + [1], max_new_tokens=3, replica=0)
        _drain(fl, [a])
        b = fl.submit(shared + [2], max_new_tokens=3, replica=0)
        _drain(fl, [b])
        st = fl.stats()
        assert st["prefix_hits"] >= 1
        assert {"ttft_p50_s", "itl_p99_s"} <= set(st["latency"])
        assert "speculative" not in st
        views.append({k: st[k] for k in (
            "prefix_hits", "prefix_misses", "prefix_hit_rate",
            "prefix_tokens_reused", "shared_pages", "finished")})
    assert views[0] == views[1]


# --------------------------- the speculative fleet ---------------------------

@functools.lru_cache(maxsize=None)
def _drafts():
    """The reference CLI's draft (the target's arch, weights from seed 1)
    for the reference and the port."""
    cfg, _ = _jax()
    jd = jinit(cfg, jax.random.key(1))
    pcfg, _ = _port()
    return (dict(speculate=4, draft_cfg=cfg, draft_params=jd),
            dict(speculate=4, draft_cfg=pcfg, draft_params=params_from_jax(
                jax_tree_to_np(jd), pcfg, device="cpu")))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_fleet_chaos_speculative_matches_reference(kv_quant):
    """CI's speculative fleet chaos smoke at the test geometry: the seeded
    plan through K=4 speculative replicas gives the reference's report,
    states and streams, and the fleet's speculative roll-up equals the
    reference router's."""
    jkw, kw = _drafts()
    plan_kw = dict(seed=0, **CHAOS_PLAN)
    fl = _fleet(kv_quant=kv_quant, **CHAOS_KW, **kw)
    jfl = _ref_fleet(kv_quant=kv_quant, **CHAOS_KW, **jkw)
    got = run_fleet_plan(fl, FleetFaultPlan(FleetChaosConfig(**plan_kw)))
    want = jchaos.run_fleet_plan(
        jfl, jchaos.FleetFaultPlan(jchaos.FleetChaosConfig(**plan_kw)))
    fields = ("ticks", "states", "deaths", "respawns", "migrated", "drains",
              "backpressured", "audits", "recovered")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert [(r.state.value, r.tokens) for r in got.submitted] == \
        [(r.state.value, r.tokens) for r in want.submitted]
    assert got.all_terminal and got.audits == got.ticks
    st, jst = fl.stats(), jfl.stats()
    assert st["speculative"] == jst["speculative"]
    assert st["speculative"]["proposed"] > 0


def test_fleet_stats_roll_up_speculative():
    """A speculative fleet without faults: the roll-up of acceptance over
    the live replicas equals the reference router's."""
    jkw, kw = _drafts()
    views = []
    for fl in (_fleet(replicas=2, max_len=32, **kw),
               _ref_fleet(replicas=2, max_len=32, **jkw)):
        reqs = [fl.submit([3, 5, 7, 9, 2], max_new_tokens=6),
                fl.submit([4, 6], max_new_tokens=6)]
        _drain(fl, reqs)
        st = fl.stats()
        views.append((st["speculative"], _view(reqs)))
    assert views[0] == views[1]
    assert views[0][0]["k"] == 4 and views[0][0]["proposed"] > 0


def test_speculative_replicas_share_one_draft_copy():
    """The router casts the draft once too: every replica, and every
    respawn, reads the same draft tensors."""
    _, kw = _drafts()
    cfg, params = _port()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    kw = dict(kw, draft_cfg=dataclasses.replace(kw["draft_cfg"],
                                                compute_dtype="bfloat16"))
    fl = FleetRouter(cfg, params, replicas=3, slots=2, max_len=16,
                     page_size=4, device="cpu", **kw)
    base = [t.data_ptr() for t in _leaves(fl.replicas[0].sched.draft_params)]
    assert all(t.dtype == torch.bfloat16
               for t in _leaves(fl.replicas[0].sched.draft_params)
               if t.is_floating_point())
    fl.kill_replica(1)
    fl.tick()
    assert fl.respawns == 1
    for rep in fl.replicas:
        assert [t.data_ptr() for t in _leaves(rep.sched.draft_params)] == base
