"""Deadline-based straggler mitigation (coordinator-side logic).

The port's own copy of ``repro``'s ``ft/straggler.py`` (pure Python, the
same classes and rules): :class:`StragglerConfig`, :class:`StragglerPolicy`
and :class:`StepWatchdog`, which the serve scheduler feeds each decode
step's wall time.

At fleet scale the slowest host sets the step time (synchronous SPMD). The
policy here implements the standard mitigation: track per-host step
durations, declare hosts exceeding ``factor x`` the rolling median as
stragglers, and exclude them for a cooldown window — on a real fleet the
exclusion maps to (a) skipping their gradient contribution (scaling the DP
denominator) or (b) triggering elastic restart without them (ft/elastic).

Pure Python with an injectable clock so the logic is unit-testable without
hardware; tests/test_torch_straggler.py holds its verdicts against the
reference's on the same simulated durations.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict, deque


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    window: int = 16           # rolling history per host
    factor: float = 2.0        # slow if > factor * median
    cooldown_steps: int = 8    # exclusion length
    min_history: int = 4       # steps before judging
    max_excluded_frac: float = 0.25


class StragglerPolicy:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.n_hosts = n_hosts
        self.cfg = cfg
        self._hist: dict[int, deque] = defaultdict(
            lambda: deque(maxlen=cfg.window))
        self._excluded_until: dict[int, int] = {}
        self._step = 0

    def record_step(self, durations: dict[int, float]) -> None:
        """durations: host -> seconds for this step (missing = no report,
        treated as infinitely slow)."""
        self._step += 1
        for h in range(self.n_hosts):
            if h in durations:
                self._hist[h].append(durations[h])
            else:
                self._hist[h].append(float("inf"))
        self._update_exclusions()

    def _update_exclusions(self) -> None:
        cfg = self.cfg
        meds = []
        for h in range(self.n_hosts):
            if len(self._hist[h]) >= cfg.min_history:
                finite = [d for d in self._hist[h] if d != float("inf")]
                if finite:
                    meds.append(statistics.median(finite))
        if not meds:
            return
        global_med = statistics.median(meds)
        budget = int(self.n_hosts * cfg.max_excluded_frac)
        current = {h for h, until in self._excluded_until.items()
                   if until > self._step}
        for h in range(self.n_hosts):
            if len(self._hist[h]) < cfg.min_history or h in current:
                continue
            recent = list(self._hist[h])[-cfg.min_history:]
            slow = all(d > cfg.factor * global_med for d in recent)
            if slow and len(current) < budget:
                self._excluded_until[h] = self._step + cfg.cooldown_steps
                current.add(h)

    def excluded(self) -> set[int]:
        return {h for h, until in self._excluded_until.items()
                if until > self._step}

    def active_hosts(self) -> list[int]:
        ex = self.excluded()
        return [h for h in range(self.n_hosts) if h not in ex]

    def gradient_scale(self) -> float:
        """Rescale factor for the DP mean when hosts are excluded."""
        return self.n_hosts / max(1, len(self.active_hosts()))


class StepWatchdog:
    """The StragglerPolicy deadline rule applied to ONE serving replica's
    step wall times: a step is a BREACH when it exceeds ``factor`` x the
    rolling median of recent steps (after ``min_history`` observations),
    or ``hard_limit`` seconds outright.  The serve scheduler records each
    decode step's duration; breaches are counted and surfaced (stats /
    chaos reports) rather than raised — a slow step is a symptom to act
    on (preempt, shed load), not a crash.  The fleet router
    (serve/fleet.py) reads ``hard_breaches`` as a health signal: a
    replica repeatedly blowing the hard limit is DEGRADED and drained.

    Breaching steps are excluded from the history so a stall cannot drag
    the median up and mask itself — but a replica that LEGITIMATELY
    settles into a slower regime (longer contexts, a busier host) would
    then breach forever: the median never sees the new regime.  After
    ``rebaseline_after`` CONSECUTIVE median breaches the window is
    re-baselined onto those breaching durations (the new regime becomes
    the baseline) and ``regime_shifts`` counts the event.  Hard-limit
    breaches never re-baseline — the hard limit is an absolute SLO, not
    a relative one.

    Pure host Python with the same injectable-measurement design as
    :class:`StragglerPolicy` (callers time the step and pass the
    duration), so the policy is unit-testable without wall time.
    """

    def __init__(self, cfg: StragglerConfig = StragglerConfig(), *,
                 hard_limit: float | None = None,
                 rebaseline_after: int = 8):
        if rebaseline_after < 1:
            raise ValueError(f"rebaseline_after must be >= 1, "
                             f"got {rebaseline_after}")
        self.cfg = cfg
        self.hard_limit = hard_limit
        self.rebaseline_after = rebaseline_after
        self._hist: deque = deque(maxlen=cfg.window)
        # the last run of consecutive median-breaching durations — the
        # candidate new baseline if the run reaches rebaseline_after
        self._breach_run: deque = deque(maxlen=max(cfg.window,
                                                   rebaseline_after))
        self.breaches = 0
        self.hard_breaches = 0
        self.observations = 0
        self.regime_shifts = 0
        self.last_breach: float | None = None

    def median(self) -> float | None:
        finite = [d for d in self._hist if d != float("inf")]
        return statistics.median(finite) if finite else None

    def deadline(self) -> float | None:
        """The current per-step budget, or None before enough history."""
        if self.hard_limit is not None:
            return self.hard_limit
        return self._median_deadline()

    def _median_deadline(self) -> float | None:
        if len(self._hist) < self.cfg.min_history:
            return None
        med = self.median()
        return self.cfg.factor * med if med is not None else None

    def observe(self, duration: float) -> bool:
        """Record one step's wall time; True when it breached the
        deadline (hard limit or factor x rolling median)."""
        self.observations += 1
        hard = self.hard_limit is not None and duration > self.hard_limit
        med_limit = self._median_deadline()
        med_breach = med_limit is not None and duration > med_limit
        if hard:
            self.hard_breaches += 1
        if hard or med_breach:
            self.breaches += 1
            self.last_breach = duration
        if med_breach:
            self._breach_run.append(duration)
            if len(self._breach_run) >= self.rebaseline_after:
                # the "stall" is the steady state now: adopt it
                self.regime_shifts += 1
                self._hist.clear()
                self._hist.extend(self._breach_run)
                self._breach_run.clear()
        else:
            self._breach_run.clear()
            if not hard:
                self._hist.append(duration)
        return hard or med_breach
