"""Request lifecycle for the hardened serve runtime (a copy of ``repro``'s
``serve/lifecycle.py``: pure Python, kept here so the port never imports
the reference package).  The MIGRATING edges serve the replica fleet,
which waits for a later slice.

The paged scheduler (serve/scheduler.py) owns device state: slots, the
page pool, the jit'd step.  This module owns everything a request goes
through AROUND that device state:

  * :class:`Request` — a typed request record with a validated state
    machine::

        QUEUED -> PREFILLING -> RUNNING -> FINISHED
                                        -> TIMED_OUT
                                        -> FAILED
                                        -> PREEMPTED -> QUEUED (again)
                                        -> MIGRATING -> QUEUED (elsewhere)

    plus the admission-time edges QUEUED -> {FAILED, TIMED_OUT,
    MIGRATING} for rejected / expired / relocated requests, and the
    mid-prefill edges PREFILLING -> {PREEMPTED, MIGRATING,
    TIMED_OUT}: chunked prefill interleaves with decode ticks, so a
    request can be preempted, migrated, or expire BETWEEN chunks —
    it no longer has to fail or hold pages to completion.  Illegal
    transitions raise — the chaos harness (serve/chaos.py) relies on
    this: "every admitted request terminates in a typed state" is only
    meaningful if states cannot be corrupted silently.

    MIGRATING is the fleet failover edge: when a replica dies,
    the router lifts every resident request off it — running slots AND
    queued work — through MIGRATING and re-queues them on a surviving
    replica.  Resume there is the ordinary preemption-and-restore path
    (re-prefill the ORIGINAL prompt, replay generated tokens through
    the jit'd decode step), so a migrated request's post-catch-up
    stream is bit-exact vs an uninterrupted run on pad-safe stacks —
    migration IS preemption pointed at a different page pool.

  * :class:`AdmissionQueue` — a BOUNDED priority queue.  A full queue is
    backpressure, not a crash: ``push`` raises :class:`AdmissionError`
    carrying a ``retry_after`` hint instead of the bare ``RuntimeError``
    a scheduler would otherwise raise on pool exhaustion.  Pop order is
    priority (higher first), then arrival order; a preempted request keeps its
    original arrival sequence so it resumes ahead of later arrivals of
    equal priority.

  * :func:`retry_with_backoff` — client-side exponential backoff with
    deterministic (seeded) jitter, honouring the server's ``retry_after``
    floor.  The clock and sleep are injectable so the policy is
    unit-testable without wall time.

Everything here is pure host Python — no device work — so the
steady-state decode fast path is untouched by construction.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import random
import time
from collections import deque
from typing import Callable, Sequence


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    PREEMPTED = "preempted"
    MIGRATING = "migrating"
    FINISHED = "finished"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.TIMED_OUT,
                             RequestState.FAILED})

# the full legal edge set; Request.to() enforces it
_TRANSITIONS: dict[RequestState, frozenset[RequestState]] = {
    RequestState.QUEUED: frozenset({RequestState.PREFILLING,
                                    RequestState.FAILED,
                                    RequestState.TIMED_OUT,
                                    RequestState.MIGRATING}),
    # PREFILLING -> PREEMPTED / MIGRATING: prefill runs in
    # page-sized chunks interleaved with decode ticks, so a mid-prefill
    # request is preemptible under page pressure and migratable off a
    # dying replica — resume re-runs the chunks (bit-identical: same
    # fixed-width jit) instead of holding pages through the outage.
    # TIMED_OUT covers a deadline expiring between chunks.
    RequestState.PREFILLING: frozenset({RequestState.RUNNING,
                                        RequestState.FAILED,
                                        RequestState.PREEMPTED,
                                        RequestState.MIGRATING,
                                        RequestState.TIMED_OUT}),
    RequestState.RUNNING: frozenset({RequestState.FINISHED,
                                     RequestState.TIMED_OUT,
                                     RequestState.FAILED,
                                     RequestState.PREEMPTED,
                                     RequestState.MIGRATING}),
    RequestState.PREEMPTED: frozenset({RequestState.QUEUED}),
    # MIGRATING -> FAILED: the fleet has nowhere left to re-admit
    # (every replica dead) — still a typed terminal, never a lost request
    RequestState.MIGRATING: frozenset({RequestState.QUEUED,
                                       RequestState.FAILED,
                                       RequestState.TIMED_OUT}),
    RequestState.FINISHED: frozenset(),
    RequestState.TIMED_OUT: frozenset(),
    RequestState.FAILED: frozenset(),
}

_rid_counter = itertools.count()


class AdmissionError(RuntimeError):
    """Typed backpressure: the queue (or the page pool behind it) cannot
    take the request NOW.  ``retry_after`` is the server's estimate (in
    clock seconds) of when capacity may free up — a floor for client
    backoff, not a promise."""

    def __init__(self, msg: str, *, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class LifecycleError(RuntimeError):
    """An illegal state-machine transition was attempted."""


@dataclasses.dataclass
class Request:
    """One serving request and its full lifecycle record.

    ``tokens`` is prompt + generated so far — on preemption it carries
    the accumulated stream back to the queue, and resume replays it
    (see Scheduler._admit_into).  ``deadline`` is ABSOLUTE in the
    scheduler's injectable clock; pass ``ttl`` (relative) at submit and
    the queue resolves it.  ``max_new_tokens=None`` means "until
    finish() is called" (the legacy surface).
    """
    prompt: list[int]
    max_new_tokens: int | None = None
    priority: int = 0                   # higher = more important
    deadline: float | None = None       # absolute, scheduler clock
    speculate: int = 1                  # verify width K (1 = no drafts)
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))
    state: RequestState = RequestState.QUEUED
    tokens: list[int] = dataclasses.field(default_factory=list)
    arrival_seq: int = -1               # stamped by AdmissionQueue.push
    preemptions: int = 0
    migrations: int = 0                 # replica-to-replica relocations
    error: str | None = None
    slot: int | None = None
    replica: int | None = None          # stamped by the fleet router

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.tokens:
            self.tokens = list(self.prompt)

    # -- state machine ------------------------------------------------------
    def to(self, state: RequestState, *, error: str | None = None) -> None:
        if state not in _TRANSITIONS[self.state]:
            raise LifecycleError(
                f"request {self.rid}: illegal transition "
                f"{self.state.value} -> {state.value}")
        self.state = state
        if error is not None:
            self.error = error
        if state is RequestState.PREEMPTED:
            self.preemptions += 1
        elif state is RequestState.MIGRATING:
            self.migrations += 1

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def generated(self) -> int:
        return len(self.tokens) - len(self.prompt)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class AdmissionQueue:
    """Bounded priority queue with typed backpressure.

    ``retry_after_hint`` is a callable returning the current estimate of
    seconds-per-admission-opportunity (the scheduler wires its step-time
    EWMA in); the hint scales with queue depth so a deeper queue tells
    clients to back off longer.
    """

    def __init__(self, maxsize: int, *,
                 retry_after_hint: Callable[[], float] | None = None):
        if maxsize < 1:
            raise ValueError(f"queue maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._q: deque[Request] = deque()
        self._seq = itertools.count()
        self._hint = retry_after_hint or (lambda: 0.0)
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request, *, force: bool = False) -> None:
        """Enqueue (or re-enqueue a preempted request).  Raises
        :class:`AdmissionError` when full — backpressure, not a crash.
        ``force=True`` bypasses the bound: preempted requests carry
        accumulated tokens and dropping them would turn backpressure
        into data loss."""
        if not force and len(self._q) >= self.maxsize:
            self.rejected += 1
            raise AdmissionError(
                f"admission queue full ({self.maxsize} waiting)",
                retry_after=max(self._hint(), 0.0) * (len(self._q) + 1))
        if req.state in (RequestState.PREEMPTED, RequestState.MIGRATING):
            req.to(RequestState.QUEUED)      # keeps its arrival_seq
        if req.arrival_seq < 0:
            req.arrival_seq = next(self._seq)
        self._q.append(req)

    def pop(self) -> Request | None:
        """Highest priority first, then earliest arrival."""
        if not self._q:
            return None
        best = max(self._q, key=lambda r: (r.priority, -r.arrival_seq))
        self._q.remove(best)
        return best

    def peek(self) -> Request | None:
        if not self._q:
            return None
        return max(self._q, key=lambda r: (r.priority, -r.arrival_seq))

    def expire(self, now: float) -> list[Request]:
        """Drop queued requests past their deadline (-> TIMED_OUT)."""
        dead = [r for r in self._q if r.expired(now)]
        for r in dead:
            self._q.remove(r)
            r.to(RequestState.TIMED_OUT, error="deadline expired in queue")
        return dead

    def drain(self) -> list[Request]:
        out = list(self._q)
        self._q.clear()
        return out


def retry_with_backoff(fn: Callable[[], object], *, retries: int = 5,
                       base: float = 0.05, cap: float = 2.0,
                       jitter: float = 0.5, seed: int = 0,
                       sleep: Callable[[float], None] = time.sleep,
                       exceptions: tuple = (AdmissionError,)):
    """Call ``fn`` until it stops raising backpressure.

    Delay for attempt ``k`` is ``min(cap, base * 2**k)`` scaled by a
    deterministic jitter factor in ``[1 - jitter, 1]`` (seeded — two
    clients with different seeds desynchronize, the same seed replays
    exactly), floored at the server's ``retry_after`` hint when the
    exception carries one.  ``sleep`` is injectable for tests."""
    rng = random.Random(seed)
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt == retries:
                raise
            delay = min(cap, base * (2.0 ** attempt))
            delay *= 1.0 - jitter * rng.random()
            delay = max(delay, getattr(e, "retry_after", 0.0))
            sleep(delay)


def backoff_delays(attempts: int, *, base: float = 0.05, cap: float = 2.0,
                   jitter: float = 0.5, seed: int = 0) -> list[float]:
    """The deterministic delay schedule retry_with_backoff would use
    (before retry_after flooring) — for tests and capacity planning."""
    rng = random.Random(seed)
    return [min(cap, base * (2.0 ** k)) * (1.0 - jitter * rng.random())
            for k in range(attempts)]


def summarize(requests: Sequence[Request]) -> dict[str, int]:
    """State histogram of a batch of requests (chaos reports, CLI)."""
    out: dict[str, int] = {s.value: 0 for s in RequestState}
    for r in requests:
        out[r.state.value] += 1
    out["preemptions"] = sum(r.preemptions for r in requests)
    out["migrations"] = sum(r.migrations for r in requests)
    return out
