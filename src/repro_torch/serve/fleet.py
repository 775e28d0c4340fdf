"""Fault-tolerant serve fleet: a health-checked replica router with
replay-based request migration (port of ``repro``'s ``serve/fleet.py``).

A :class:`FleetRouter` owns N in-process
:class:`~repro_torch.serve.scheduler.Scheduler` replicas on one device, each
with its OWN page pool and admission queue, all reading ONE copy of the
weights, and does

  * LEAST-LOADED ADMISSION: ``submit`` routes to the healthy replica with
    the fewest resident requests (queued + slotted), falling through the
    candidates on per-replica backpressure; when every replica refuses,
    the refusals aggregate into one ``AdmissionError`` carrying the
    MINIMUM retry-after hint.

  * HEALTH TRACKING: a replica is HEALTHY, DEGRADED or DEAD.  The router
    stamps a heartbeat after every successful replica tick; staleness
    beyond ``heartbeat_ticks`` router ticks (a hung step, a crashed tick)
    declares the replica DEAD.  A replica whose
    :class:`~repro_torch.ft.straggler.StepWatchdog` accumulates
    ``hard_breach_limit`` hard-limit breaches goes DEGRADED: it stops
    admitting, its QUEUED work migrates, its running requests finish in
    place, and once drained it rejoins HEALTHY.

  * FAILOVER: when a replica dies, every resident request goes through
    the MIGRATING lifecycle edge and is re-admitted on a surviving
    replica.  Resume there is the preemption-and-restore path: the
    original prompt re-prefills and the generated tokens replay through
    the decode step, so a migrated request's stream equals an
    uninterrupted run's.  No pool copy crosses replicas.  A dead replica
    RESPAWNS on the next tick with an empty pool; the router drops every
    reference to the old scheduler, so its pool is freed.

The weights are cast to the compute dtype ONCE, here, and every spawn and
respawn receives that tree (``cast_params`` returns leaves already in the
compute dtype unchanged), so N replicas hold one copy; a speculative
fleet's draft weights (``draft_params`` with ``draft_cfg``) follow the same
rule.  ``device`` follows
the port's rule (cuda unless the caller passes ``device="cpu"``) and goes
to every replica.

The fleet is deterministic under an injected clock: routing ties break on
replica index, death and respawn happen on tick boundaries, and greedy
decode makes a request's stream independent of its batch.  ``stats``
rolls the replicas' speculative acceptance up fleet-wide.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.device import resolve as resolve_device
from repro_torch.ft.straggler import StepWatchdog, StragglerConfig
from repro_torch.models.transformer import ModelConfig, cast_params
from repro_torch.serve.lifecycle import (AdmissionError, Request,
                                         RequestState, summarize)
from repro_torch.serve.scheduler import Scheduler


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"       # draining: no admission, running finish
    DEAD = "dead"               # evacuated; respawns next tick


class FleetAuditError(AssertionError):
    """The fleet-level residency contract broke: a live request resident
    on zero or multiple replicas, or a terminal request still resident.
    Like :class:`~repro_torch.serve.paged_cache.InvariantViolation`, this is a
    control-plane bug, never load — backpressure and failover must not
    trip it."""


@dataclasses.dataclass
class Replica:
    """One scheduler worker plus the router's view of its health."""
    idx: int
    sched: Scheduler
    state: ReplicaState = ReplicaState.HEALTHY
    generation: int = 0                 # respawn count for this index
    heartbeat_tick: int = 0             # last successful sched.tick()
    heartbeat_time: float = 0.0
    hung_until_tick: int | None = None  # chaos: ticks are skipped until
    hang_started: float | None = None
    breach_mark: int = 0                # hard_breaches at last health reset
    death_reason: str | None = None

    @property
    def alive(self) -> bool:
        return self.state is not ReplicaState.DEAD

    def hard_breaches_since_mark(self) -> int:
        wd = self.sched.watchdog
        return 0 if wd is None else wd.hard_breaches - self.breach_mark


class FleetRouter:
    """N in-process Scheduler replicas behind one admission surface.

    Geometry/sampling kwargs (``slots`` / ``max_len`` / ``page_size`` /
    ``num_pages`` / ``temperature`` / ``top_k`` / ``seed`` / lifecycle
    knobs) are passed through to every replica's Scheduler, so a
    1-replica fleet is exactly one scheduler behind a router — the
    determinism oracle tests rely on this.

    Health knobs: ``heartbeat_ticks`` is the staleness bound (a replica
    that has not completed a tick for more than this many router ticks
    is DEAD — deterministic under test clocks, unlike wall-time);
    ``hard_breach_limit`` is how many watchdog hard-limit breaches turn
    a replica DEGRADED; ``watchdog_hard_limit`` (seconds) arms each
    replica's :class:`StepWatchdog` hard limit; ``respawn`` controls
    whether dead replicas are rebuilt (fresh Scheduler from the shared
    params, empty pool) on the tick after death.  ``device`` goes to every
    replica the router spawns or respawns.
    """

    def __init__(self, cfg: ModelConfig, params, *, replicas: int,
                 slots: int, max_len: int,
                 heartbeat_ticks: int = 4, hard_breach_limit: int = 3,
                 watchdog_hard_limit: float | None = None,
                 watchdog_cfg: StragglerConfig | None = None,
                 respawn: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 device=None, **scheduler_kw):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if heartbeat_ticks < 1:
            raise ValueError(f"heartbeat_ticks must be >= 1, "
                             f"got {heartbeat_ticks}")
        self.device = resolve_device(device)
        # cast once: every replica's own cast then finds each leaf in the
        # compute dtype and keeps it, so the fleet holds one weight copy
        self.cfg, self.params = cfg, cast_params(params, cfg)
        self.n_replicas = replicas
        self.slots, self.max_len = slots, max_len
        self.heartbeat_ticks = heartbeat_ticks
        self.hard_breach_limit = hard_breach_limit
        self.watchdog_hard_limit = watchdog_hard_limit
        self.watchdog_cfg = watchdog_cfg
        self.respawn = respawn
        self.clock = clock
        self._sched_kw = dict(scheduler_kw)
        if self._sched_kw.get("draft_params") is not None and \
                self._sched_kw.get("draft_cfg") is not None:
            self._sched_kw["draft_params"] = cast_params(
                self._sched_kw["draft_params"], self._sched_kw["draft_cfg"])
        self.tick_no = 0
        self.requests: dict[int, Request] = {}      # fleet-wide registry
        self._newly_terminal: list[Request] = []    # failed in failover
        self.deaths = 0
        self.respawns = 0
        self.drains = 0          # DEGRADED transitions
        self.rejoins = 0         # DEGRADED -> HEALTHY recoveries
        self.migrated = 0        # requests moved between replicas
        self.replicas = [self._spawn(i, 0) for i in range(replicas)]

    # -- spawning ------------------------------------------------------------
    def _make_watchdog(self) -> StepWatchdog:
        cfg = self.watchdog_cfg or StragglerConfig()
        return StepWatchdog(cfg, hard_limit=self.watchdog_hard_limit)

    def _spawn(self, idx: int, generation: int) -> Replica:
        sched = Scheduler(self.cfg, self.params, slots=self.slots,
                          max_len=self.max_len, clock=self.clock,
                          watchdog=self._make_watchdog(),
                          device=self.device, **self._sched_kw)
        return Replica(idx=idx, sched=sched, generation=generation,
                       heartbeat_tick=self.tick_no,
                       heartbeat_time=self.clock())

    # -- admission -----------------------------------------------------------
    def _healthy(self) -> list[Replica]:
        return [r for r in self.replicas
                if r.state is ReplicaState.HEALTHY]

    def _by_load(self, reps: Sequence[Replica]) -> list[Replica]:
        return sorted(reps, key=lambda r: (r.sched.load(), r.idx))

    def submit(self, prompt: Sequence[int], *, replica: int | None = None,
               **kw) -> Request:
        """Route to the least-loaded healthy replica (ties break on
        index — deterministic), falling through candidates on
        per-replica backpressure.  ``replica=`` pins the target (chaos
        storms, affinity tests); a pinned unhealthy replica is
        backpressure, not an error class of its own.  When every
        candidate refuses, the per-replica errors aggregate into one
        :class:`AdmissionError` with the MINIMUM retry-after."""
        if replica is not None:
            rep = self.replicas[replica]
            if rep.state is not ReplicaState.HEALTHY:
                raise AdmissionError(
                    f"replica {replica} is {rep.state.value}",
                    retry_after=float(self.heartbeat_ticks))
            candidates = [rep]
        else:
            candidates = self._by_load(self._healthy())
        if not candidates:
            raise AdmissionError("no healthy replica",
                                 retry_after=float(self.heartbeat_ticks))
        errors: list[tuple[int, AdmissionError]] = []
        for rep in candidates:
            try:
                req = rep.sched.submit(prompt, **kw)
            except AdmissionError as e:
                errors.append((rep.idx, e))
                continue
            req.replica = rep.idx
            self.requests[req.rid] = req
            return req
        raise AdmissionError(
            "all replicas backpressured: " + "; ".join(
                f"r{i}: {e}" for i, e in errors),
            retry_after=min(e.retry_after for _, e in errors))

    # -- failover ------------------------------------------------------------
    def kill_replica(self, idx: int, *, reason: str = "killed") -> None:
        """Declare a replica dead NOW: every resident request migrates
        (MIGRATING -> re-queued elsewhere, resumed via the replay
        cursor); the replica respawns with an empty pool on the next
        tick (when ``respawn`` is on)."""
        rep = self.replicas[idx]
        if rep.state is ReplicaState.DEAD:
            return
        self._mark_dead(rep, reason)

    def hang_replica(self, idx: int, ticks: int) -> None:
        """Chaos: stall a replica for ``ticks`` router ticks — its step
        never completes, so its heartbeat goes stale.  A hang longer
        than ``heartbeat_ticks`` is declared DEAD mid-hang; a shorter
        one wakes up, its watchdog observes the stall as one giant step
        (a hard-limit breach when armed), and the DEGRADED drain path
        takes over."""
        rep = self.replicas[idx]
        if not rep.alive or ticks < 1:
            return
        rep.hung_until_tick = self.tick_no + ticks
        if rep.hang_started is None:
            rep.hang_started = self.clock()

    def _mark_dead(self, rep: Replica, reason: str) -> None:
        rep.state = ReplicaState.DEAD
        rep.death_reason = reason
        rep.hung_until_tick = None
        rep.hang_started = None
        self.deaths += 1
        self._reassign(rep.sched.evacuate(), reason)
        # the dead pool and logits leave the card now: the scheduler object
        # sits in a reference cycle (its queue's retry hint is a bound
        # method), so Python frees it only at its next collection
        rep.sched.cache.state = None
        rep.sched.last_logits = None

    def _reassign(self, evacuees: list[Request], reason: str) -> None:
        """Re-admit MIGRATING requests on surviving replicas.  With no
        healthy replica left they fail TYPED (never silently lost) —
        the audit counts them, the chaos gate accepts them."""
        for req in evacuees:
            targets = self._by_load(self._healthy())
            if not targets:
                req.to(RequestState.FAILED,
                       error=f"no live replica to migrate to ({reason})")
                self._newly_terminal.append(req)
                continue
            target = targets[0]
            target.sched.adopt(req)
            req.replica = target.idx
            self.migrated += 1

    def _degrade(self, rep: Replica) -> None:
        rep.state = ReplicaState.DEGRADED
        self.drains += 1
        self._reassign(rep.sched.migrate_queued(),
                       f"replica {rep.idx} degraded")

    # -- the fleet pump ------------------------------------------------------
    def tick(self) -> list[Request]:
        """One fleet iteration: respawn dead replicas, tick live ones
        (hung replicas skip — their heartbeat stales), then run the
        health pass (staleness -> DEAD + failover, hard-limit breaches
        -> DEGRADED + drain, drained DEGRADED -> rejoin).  Returns every
        request that went terminal this tick, fleet-wide."""
        self.tick_no += 1
        done: list[Request] = []
        for rep in self.replicas:
            if rep.state is ReplicaState.DEAD:
                if self.respawn:
                    # the old Replica (its scheduler and watchdog) loses
                    # the router's last reference here
                    self.replicas[rep.idx] = self._spawn(
                        rep.idx, rep.generation + 1)
                    self.respawns += 1
                continue
            if rep.hung_until_tick is not None:
                if self.tick_no <= rep.hung_until_tick:
                    continue            # stalled: no tick, no heartbeat
                # the hang ended: the watchdog sees it as ONE giant step
                stall = self.clock() - (rep.hang_started or 0.0)
                if rep.sched.watchdog is not None:
                    rep.sched.watchdog.observe(stall)
                rep.hung_until_tick = None
                rep.hang_started = None
            try:
                done.extend(rep.sched.tick())
            except Exception as e:      # noqa: BLE001 — replica crash
                self._mark_dead(rep, f"tick crashed: {type(e).__name__}: "
                                     f"{e}")
                continue
            rep.heartbeat_tick = self.tick_no
            rep.heartbeat_time = self.clock()
        # -- health pass ----------------------------------------------------
        for rep in self.replicas:
            if rep.state is ReplicaState.DEAD:
                continue
            if self.tick_no - rep.heartbeat_tick > self.heartbeat_ticks:
                self._mark_dead(rep, "heartbeat stale")
                continue
            if (rep.state is ReplicaState.HEALTHY
                    and self.hard_breach_limit is not None
                    and rep.hard_breaches_since_mark()
                    >= self.hard_breach_limit):
                self._degrade(rep)
            if rep.state is ReplicaState.DEGRADED and \
                    not any(rep.sched.active):
                rep.state = ReplicaState.HEALTHY
                if rep.sched.watchdog is not None:
                    rep.breach_mark = rep.sched.watchdog.hard_breaches
                self.rejoins += 1
        done.extend(self._newly_terminal)
        self._newly_terminal.clear()
        return done

    def drained(self) -> bool:
        """Nothing queued or running on any live replica (dead replicas
        hold nothing by construction — death evacuates)."""
        return all(rep.sched.drained() for rep in self.replicas
                   if rep.alive)

    # -- audit ---------------------------------------------------------------
    def audit(self) -> None:
        """The fleet residency contract, checked on a tick boundary:

        * no rid resident on more than one live replica (double
          residency would decode one request twice — and bill twice);
        * every non-terminal fleet-admitted request resident on EXACTLY
          one live replica (zero = a lost request);
        * no terminal request still resident;
        * nothing stuck in MIGRATING between ticks (migration completes
          within the call that started it);
        * every live replica's pool invariants hold
          (:meth:`PagedCache.check_invariants`).

        Raises :class:`FleetAuditError` (pool problems raise their own
        :class:`InvariantViolation`)."""
        owner: dict[int, int] = {}
        for rep in self.replicas:
            if not rep.alive:
                continue
            for rid in rep.sched.resident_rids():
                if rid in owner:
                    raise FleetAuditError(
                        f"request {rid} double-resident: replicas "
                        f"{owner[rid]} and {rep.idx}")
                owner[rid] = rep.idx
        for req in self.requests.values():
            if req.state is RequestState.MIGRATING:
                raise FleetAuditError(
                    f"request {req.rid} stuck MIGRATING at tick boundary")
            if req.terminal:
                if req.rid in owner:
                    raise FleetAuditError(
                        f"terminal request {req.rid} "
                        f"({req.state.value}) still resident on replica "
                        f"{owner[req.rid]}")
            elif req.rid not in owner:
                raise FleetAuditError(
                    f"request {req.rid} ({req.state.value}) lost: "
                    f"resident on no live replica")
        for rep in self.replicas:
            if rep.alive:
                rep.sched.cache.check_invariants()

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        out = summarize(list(self.requests.values()))
        out.update(
            replicas={rep.idx: {
                "state": rep.state.value,
                "generation": rep.generation,
                "load": rep.sched.load() if rep.alive else 0,
                "hard_breaches": (0 if rep.sched.watchdog is None
                                  else rep.sched.watchdog.hard_breaches),
                "pages_in_use": (rep.sched.cache.pages_in_use()
                                 if rep.alive else 0),
            } for rep in self.replicas},
            deaths=self.deaths, respawns=self.respawns,
            drains=self.drains, rejoins=self.rejoins,
            migrated=self.migrated, ticks=self.tick_no)
        # prefix-cache observability: per-replica tries, rolled
        # up fleet-wide — hit rate over all admissions, live shared pages
        live_tries = [rep.sched for rep in self.replicas
                      if rep.alive and rep.sched.prefix is not None]
        if live_tries:
            hits = sum(s.prefix.hits for s in live_tries)
            misses = sum(s.prefix.misses for s in live_tries)
            out.update(
                prefix_hits=hits, prefix_misses=misses,
                prefix_hit_rate=hits / (hits + misses)
                if hits + misses else 0.0,
                prefix_tokens_reused=sum(s.prefix.tokens_reused
                                         for s in live_tries),
                shared_pages=sum(s.stats().get("shared_pages", 0)
                                 for s in live_tries))
        # fleet-wide latency percentiles: RAW samples concatenate
        # across live replicas before taking percentiles — percentiles of
        # per-replica percentiles are not percentiles
        ttft: list[float] = []
        itl: list[float] = []
        for rep in self.replicas:
            if rep.alive:
                samp = rep.sched.latency_samples()
                ttft.extend(samp["ttft"])
                itl.extend(samp["itl"])
        lat: dict[str, float] = {}
        for name, xs in (("ttft", ttft), ("itl", itl)):
            if xs:
                lat[f"{name}_p50_s"] = float(np.percentile(xs, 50))
                lat[f"{name}_p99_s"] = float(np.percentile(xs, 99))
        out["latency"] = lat
        # speculative roll-up: acceptance over every verify step fleet-wide
        live = [rep.sched for rep in self.replicas if rep.alive]
        if any(s.speculate > 1 for s in live):
            proposed = sum(s.spec_proposed for s in live)
            accepted = sum(s.spec_accepted for s in live)
            out["speculative"] = {
                "k": max(s.speculate for s in live),
                "proposed": proposed, "accepted": accepted,
                "acceptance": accepted / proposed if proposed else 0.0,
            }
        return out
