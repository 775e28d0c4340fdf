"""Deterministic chaos harness over the paged serve runtime (port of
``repro``'s ``serve/chaos.py``; plans draw from the same seeded numpy
generator in the same order, so a seed gives the same faults and workload
in both packages).

A :class:`FaultPlan` is drawn ONCE from a seed — every fault (what, when,
to whom) is decided before the run starts, so a failing chaos run replays
from its seed.  :func:`run_plan` drives a
:class:`~repro_torch.serve.scheduler.Scheduler` through a seeded workload
while injecting the plan's faults, auditing the page pool's invariants
(``PagedCache.check_invariants``) after EVERY tick, and the lifecycle
contract: every submitted request reaches a terminal typed state
(FINISHED / TIMED_OUT / FAILED), none is lost or stuck.

Fault vocabulary (all host-side):

  * ``preempt``   — force-evict a running slot (the request requeues with
                    its accumulated tokens and resumes by replay);
  * ``nan``       — taint one slot's logits with NaN for one step (the
                    guard must fail ONLY that slot);
  * ``kill``      — slot death mid-decode (``fail_slot``: pages reclaimed,
                    request -> FAILED, neighbours unharmed);
  * ``spike``     — a burst of high-priority requests, forcing preemption
                    of lower-priority work;
  * ``bad_prompt``— malformed traffic (empty / oversized prompts) that must
                    come back typed-FAILED;
  * ``evict``     — forced prefix-trie eviction (``p_evict``; no-op
                    without the trie) while slots may still share pages.

With chunked prefill the ``preempt`` and ``kill`` draws land on mid-prefill
slots too.

FLEET chaos lifts the same discipline to the replica fleet
(``serve/fleet.py``): a :class:`FleetFaultPlan` adds replica-scoped faults
(``kill``: replica death, its requests migrate and it respawns; ``hang``:
a replica stalls for N ticks, declared DEAD past the heartbeat bound or
DEGRADED on waking; ``storm``: an admission burst pinned to one replica)
on top of ``preempt``, ``nan`` and ``bad_prompt``, and
:func:`run_fleet_plan` runs the fleet audit
(:meth:`~repro_torch.serve.fleet.FleetRouter.audit`) every tick.  Driven
on an injected :class:`StepClock`, a fleet run replays exactly.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from repro_torch.serve.fleet import FleetRouter, ReplicaState
from repro_torch.serve.lifecycle import (AdmissionError, Request,
                                         RequestState, TERMINAL_STATES)
from repro_torch.serve.scheduler import Scheduler


class StepClock:
    """Deterministic clock: each call advances a fixed quantum, so
    deadline / heartbeat / watchdog logic runs without wall time and a
    chaos run replays exactly.  The default quantum is LARGE (10s) so a
    hang observed through it dwarfs any real hard limit while real step
    wall-times stay far below it."""

    def __init__(self, dt: float = 10.0):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    seed: int = 0
    steps: int = 64              # fault-injection horizon (ticks)
    max_ticks: int = 512         # hard cap: the run must DRAIN before it
    requests: int = 8            # background workload size
    max_prompt: int = 6
    max_new_tokens: int = 8
    p_preempt: float = 0.15
    p_nan: float = 0.08
    p_kill: float = 0.05
    p_spike: float = 0.08
    p_bad_prompt: float = 0.08
    # last, so that a 0.0 default preserves the seeded draw sequence of
    # plans without it
    p_evict: float = 0.0         # force prefix-trie eviction


@dataclasses.dataclass(frozen=True)
class Fault:
    tick: int
    kind: str                    # preempt | nan | kill | spike | bad_prompt
    arg: int = 0                 # slot draw / burst size / prompt variant
    arg2: int = 0                # fleet: hang duration / storm burst size


class FaultPlan:
    """The full fault schedule, materialized from a seed up front."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.faults: list[Fault] = []
        for t in range(cfg.steps):
            r = rng.random()
            if r < cfg.p_preempt:
                self.faults.append(Fault(t, "preempt",
                                         int(rng.integers(0, 1 << 16))))
            elif r < cfg.p_preempt + cfg.p_nan:
                self.faults.append(Fault(t, "nan",
                                         int(rng.integers(0, 1 << 16))))
            elif r < cfg.p_preempt + cfg.p_nan + cfg.p_kill:
                self.faults.append(Fault(t, "kill",
                                         int(rng.integers(0, 1 << 16))))
            elif r < cfg.p_preempt + cfg.p_nan + cfg.p_kill + cfg.p_spike:
                self.faults.append(Fault(t, "spike",
                                         int(rng.integers(1, 3))))
            elif r < (cfg.p_preempt + cfg.p_nan + cfg.p_kill
                      + cfg.p_spike + cfg.p_bad_prompt):
                self.faults.append(Fault(t, "bad_prompt",
                                         int(rng.integers(0, 2))))
            elif r < (cfg.p_preempt + cfg.p_nan + cfg.p_kill
                      + cfg.p_spike + cfg.p_bad_prompt + cfg.p_evict):
                self.faults.append(Fault(t, "evict",
                                         int(rng.integers(1, 4))))
        # background workload: (arrival tick, prompt, gen budget)
        self.workload: list[tuple[int, list[int], int]] = []
        for i in range(cfg.requests):
            plen = int(rng.integers(1, cfg.max_prompt + 1))
            prompt = rng.integers(0, 97, plen).tolist()
            gen = int(rng.integers(1, cfg.max_new_tokens + 1))
            arrive = int(rng.integers(0, max(cfg.steps // 2, 1)))
            self.workload.append((arrive, [int(t) for t in prompt], gen))
        self.workload.sort(key=lambda w: w[0])

    def at(self, tick: int) -> list[Fault]:
        return [f for f in self.faults if f.tick == tick]


@dataclasses.dataclass
class ChaosReport:
    submitted: list[Request]
    ticks: int
    states: dict[str, int]
    preemptions: int
    nan_failures: int
    invariant_checks: int
    backpressured: int

    @property
    def all_terminal(self) -> bool:
        return all(r.state in TERMINAL_STATES for r in self.submitted)


def _running_slots(sched: Scheduler) -> list[int]:
    return [s for s in range(sched.slots)
            if sched.active[s] and sched._slot_req[s] is not None]


def run_plan(sched: Scheduler, plan: FaultPlan) -> ChaosReport:
    """Drive the scheduler through the plan's workload + faults until it
    drains (or the tick cap trips — which the caller should treat as a
    liveness failure).  Invariants are audited EVERY tick regardless of
    the scheduler's ``debug_invariants`` flag."""
    cfg = plan.cfg
    submitted: list[Request] = []
    pending = list(plan.workload)
    backpressured = 0
    tick = 0
    while tick < cfg.max_ticks:
        # scheduled arrivals (backpressure requeues for the next tick —
        # the client-side retry loop, without wall-clock sleeps)
        while pending and pending[0][0] <= tick:
            arrive, prompt, gen = pending[0]
            try:
                submitted.append(
                    sched.submit(prompt, max_new_tokens=gen))
                pending.pop(0)
            except AdmissionError:
                backpressured += 1
                pending[0] = (tick + 1, prompt, gen)
                break
        for fault in plan.at(tick):
            running = _running_slots(sched)
            if fault.kind == "preempt" and running:
                sched.preempt(running[fault.arg % len(running)])
            elif fault.kind == "nan" and running:
                taint = np.zeros(sched.slots, bool)
                taint[running[fault.arg % len(running)]] = True
                sched._taint = taint
            elif fault.kind == "kill" and running:
                sched.fail_slot(running[fault.arg % len(running)],
                                "chaos: slot death mid-decode")
            elif fault.kind == "spike":
                for b in range(fault.arg):
                    try:
                        submitted.append(sched.submit(
                            [1 + b, 2, 3], max_new_tokens=2,
                            priority=10))
                    except AdmissionError:
                        backpressured += 1
            elif fault.kind == "bad_prompt":
                bad = [] if fault.arg == 0 else \
                    [0] * (sched.max_len + 1)
                submitted.append(sched.submit(bad, max_new_tokens=2))
            elif fault.kind == "evict":
                # force prefix-trie eviction (no-op without the trie):
                # refcount conservation must survive pages leaving the
                # trie while slots still share them
                sched._evict_prefix(fault.arg)
        sched.tick()
        sched.cache.check_invariants()      # ALWAYS on under chaos
        tick += 1
        if not pending and tick > cfg.steps and sched.drained():
            break
    return ChaosReport(
        submitted=submitted, ticks=tick,
        states=dict(Counter(r.state.value for r in submitted)),
        preemptions=sched.preemptions,
        nan_failures=sched.nan_failures,
        invariant_checks=sched.cache.invariant_checks,
        backpressured=backpressured)


# ---------------------------------------------------------------------------
# Fleet-level chaos (serve/fleet.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetChaosConfig:
    seed: int = 0
    replicas: int = 3
    steps: int = 48              # fault-injection horizon (ticks)
    max_ticks: int = 768         # hard cap: the fleet must DRAIN before it
    requests: int = 10           # background workload size
    max_prompt: int = 6
    max_new_tokens: int = 8
    p_kill: float = 0.06
    p_hang: float = 0.05
    p_storm: float = 0.08
    p_preempt: float = 0.08
    p_nan: float = 0.05
    p_bad_prompt: float = 0.05
    max_hang: int = 6            # hang duration draw (ticks, >= 1)


class FleetFaultPlan:
    """The full fleet fault schedule, materialized from a seed up
    front — replica-scoped faults (kill / hang / storm) on top of the
    per-slot vocabulary (preempt / nan / bad_prompt)."""

    def __init__(self, cfg: FleetChaosConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        kinds = (("kill", cfg.p_kill), ("hang", cfg.p_hang),
                 ("storm", cfg.p_storm), ("preempt", cfg.p_preempt),
                 ("nan", cfg.p_nan), ("bad_prompt", cfg.p_bad_prompt))
        self.faults: list[Fault] = []
        for t in range(cfg.steps):
            r = rng.random()
            acc = 0.0
            for kind, p in kinds:
                acc += p
                if r < acc:
                    self.faults.append(Fault(
                        t, kind, int(rng.integers(0, 1 << 16)),
                        int(rng.integers(1, max(cfg.max_hang, 1) + 1))))
                    break
        self.workload: list[tuple[int, list[int], int]] = []
        for _ in range(cfg.requests):
            plen = int(rng.integers(1, cfg.max_prompt + 1))
            prompt = rng.integers(0, 97, plen).tolist()
            gen = int(rng.integers(1, cfg.max_new_tokens + 1))
            arrive = int(rng.integers(0, max(cfg.steps // 2, 1)))
            self.workload.append((arrive, [int(t) for t in prompt], gen))
        self.workload.sort(key=lambda w: w[0])

    def at(self, tick: int) -> list[Fault]:
        return [f for f in self.faults if f.tick == tick]


@dataclasses.dataclass
class FleetChaosReport:
    submitted: list[Request]
    ticks: int
    states: dict[str, int]
    deaths: int
    respawns: int
    migrated: int
    drains: int
    backpressured: int
    audits: int

    @property
    def all_terminal(self) -> bool:
        return all(r.state in TERMINAL_STATES for r in self.submitted)

    @property
    def recovered(self) -> int:
        """Requests that survived at least one migration to FINISH."""
        return sum(1 for r in self.submitted
                   if r.migrations > 0
                   and r.state is RequestState.FINISHED)


def run_fleet_plan(router: FleetRouter,
                   plan: FleetFaultPlan) -> FleetChaosReport:
    """Drive the fleet through the plan's workload + faults until it
    drains (or the tick cap trips — a liveness failure for the caller to
    assert on).  :meth:`FleetRouter.audit` — residency, MIGRATING
    completion, per-replica pool invariants — runs after EVERY tick."""
    cfg = plan.cfg
    submitted: list[Request] = []
    pending = list(plan.workload)
    backpressured = 0
    audits = 0
    tick = 0
    while tick < cfg.max_ticks:
        while pending and pending[0][0] <= tick:
            arrive, prompt, gen = pending[0]
            try:
                submitted.append(
                    router.submit(prompt, max_new_tokens=gen))
                pending.pop(0)
            except AdmissionError:
                backpressured += 1
                pending[0] = (tick + 1, prompt, gen)
                break
        for fault in plan.at(tick):
            live = [r for r in router.replicas if r.alive]
            healthy = [r for r in router.replicas
                       if r.state is ReplicaState.HEALTHY]
            if fault.kind == "kill" and live:
                router.kill_replica(live[fault.arg % len(live)].idx,
                                    reason="chaos kill")
            elif fault.kind == "hang" and live:
                router.hang_replica(live[fault.arg % len(live)].idx,
                                    fault.arg2)
            elif fault.kind == "storm" and healthy:
                target = healthy[fault.arg % len(healthy)].idx
                for b in range(1 + fault.arg2 % 3):
                    try:
                        submitted.append(router.submit(
                            [1 + b, 2, 3], max_new_tokens=2,
                            priority=10, replica=target))
                    except AdmissionError:
                        backpressured += 1
            elif fault.kind == "preempt" and live:
                rep = live[fault.arg % len(live)]
                running = _running_slots(rep.sched)
                if running:
                    rep.sched.preempt(running[fault.arg2 % len(running)])
            elif fault.kind == "nan" and live:
                rep = live[fault.arg % len(live)]
                running = _running_slots(rep.sched)
                if running:
                    taint = np.zeros(rep.sched.slots, bool)
                    taint[running[fault.arg2 % len(running)]] = True
                    rep.sched._taint = taint
            elif fault.kind == "bad_prompt":
                bad = [] if fault.arg % 2 == 0 else \
                    [0] * (router.max_len + 1)
                try:
                    submitted.append(router.submit(bad, max_new_tokens=2))
                except AdmissionError:   # whole fleet dead/backpressured
                    backpressured += 1
        router.tick()
        router.audit()                     # ALWAYS on under fleet chaos
        audits += 1
        tick += 1
        if not pending and tick > cfg.steps and router.drained():
            break
    return FleetChaosReport(
        submitted=submitted, ticks=tick,
        states=dict(Counter(r.state.value for r in submitted)),
        deaths=router.deaths, respawns=router.respawns,
        migrated=router.migrated, drains=router.drains,
        backpressured=backpressured, audits=audits)
