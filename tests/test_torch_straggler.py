"""Port parity for ft/straggler.py: the port's StragglerPolicy and
StepWatchdog give the reference's verdicts on the same durations — the
cases of tests/test_ft.py (detection, cooldown, budget cap, missing
reports, re-baselining, transient spikes, the hard limit) and seeded
random traces.  Pure Python on both sides: no tolerance, every verdict
and counter equal.
"""
import numpy as np
import pytest

from repro.ft import straggler as ref
from repro_torch.ft import straggler as port


def _policy_trace(mod, n_hosts, cfg_kw, steps):
    pol = mod.StragglerPolicy(n_hosts, mod.StragglerConfig(**cfg_kw))
    out = []
    for d in steps:
        pol.record_step(d)
        out.append((sorted(pol.excluded()), pol.active_hosts(),
                    pol.gradient_scale()))
    return out


def _straggling(n, slow, value, count):
    return [{h: (value if h in slow else 1.0) for h in range(n)}
            for _ in range(count)]


POLICY_CASES = {
    # test_straggler_detection_and_cooldown
    "detection-cooldown": (8, dict(window=8, factor=2.0, cooldown_steps=3,
                                   min_history=2),
                           _straggling(8, {3}, 10.0, 4)
                           + _straggling(8, set(), 1.0, 6)),
    # test_straggler_budget_cap
    "budget-cap": (8, dict(min_history=2, factor=1.5,
                           max_excluded_frac=0.25),
                   _straggling(8, {4, 5, 6, 7}, 50.0, 4)),
    # test_missing_report_treated_as_slow
    "missing-report": (4, dict(min_history=2, factor=2.0),
                       [{0: 1.0, 1: 1.0, 2: 1.0}] * 4),
}


@pytest.mark.parametrize("name", sorted(POLICY_CASES))
def test_straggler_policy_matches_reference(name):
    n, cfg_kw, steps = POLICY_CASES[name]
    got = _policy_trace(port, n, cfg_kw, steps)
    assert got == _policy_trace(ref, n, cfg_kw, steps)
    if name == "detection-cooldown":
        assert 3 in got[3][0] and got[3][2] == 8 / 7
        assert got[-1] == ([], list(range(8)), 1.0)
    if name == "missing-report":
        assert 3 in got[-1][0]


def _watchdog_trace(mod, cfg_kw, wd_kw, durations):
    wd = mod.StepWatchdog(mod.StragglerConfig(**cfg_kw), **wd_kw)
    flags = [wd.observe(d) for d in durations]
    return flags, (wd.breaches, wd.hard_breaches, wd.observations,
                   wd.regime_shifts, wd.last_breach, wd.median(),
                   wd.deadline())


WD = dict(window=8, factor=2.0, min_history=4)
WATCHDOG_CASES = {
    # test_watchdog_rebaselines_after_sustained_regime_shift
    "regime-shift": (WD, dict(rebaseline_after=4), [1.0] * 8 + [5.0] * 12),
    # test_watchdog_transient_spikes_do_not_rebaseline
    "transient-spikes": (WD, dict(rebaseline_after=3),
                         [1.0] * 8 + [9.0, 1.0] * 6),
    # test_watchdog_hard_limit_never_rebaselines
    "hard-limit": (WD, dict(hard_limit=30.0, rebaseline_after=3),
                   [1.0] * 8 + [100.0] * 10),
    "defaults-warmup": ({}, {}, [0.5, 0.6, 3.0, 0.5, 0.55, 2.0, 0.5]),
}


@pytest.mark.parametrize("name", sorted(WATCHDOG_CASES))
def test_step_watchdog_matches_reference(name):
    cfg_kw, wd_kw, durations = WATCHDOG_CASES[name]
    got = _watchdog_trace(port, cfg_kw, wd_kw, durations)
    assert got == _watchdog_trace(ref, cfg_kw, wd_kw, durations)
    flags, (breaches, hard, _, shifts, _, _, deadline) = got
    if name == "regime-shift":
        assert flags[8:12] == [True] * 4 and shifts == 1
        assert not any(flags[14:]) and deadline == pytest.approx(10.0)
    if name == "transient-spikes":
        assert shifts == 0 and breaches == 6
    if name == "hard-limit":
        assert hard == 10 and deadline == 30.0


@pytest.mark.parametrize("seed", range(4))
def test_step_watchdog_random_traces_match_reference(seed):
    """Seeded step-time traces with slow regimes, spikes and stalls."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.01, 0.05, 200)
    base[60:110] *= rng.uniform(2.5, 6.0)          # a slower regime
    spikes = rng.random(200) < 0.08
    base[spikes] *= rng.uniform(3.0, 20.0, int(spikes.sum()))
    durations = [float(d) for d in base]
    cfg_kw = dict(window=int(rng.integers(4, 17)),
                  factor=float(rng.uniform(1.5, 3.0)),
                  min_history=int(rng.integers(2, 6)))
    wd_kw = dict(hard_limit=float(np.quantile(base, 0.97)) if seed % 2
                 else None, rebaseline_after=int(rng.integers(1, 9)))
    got = _watchdog_trace(port, cfg_kw, wd_kw, durations)
    assert got == _watchdog_trace(ref, cfg_kw, wd_kw, durations)
    assert got[1][0] > 0                            # the trace breaches


def test_watchdog_rebaseline_requires_positive_k():
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.StepWatchdog(mod.StragglerConfig(), rebaseline_after=0)
