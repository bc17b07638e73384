"""The port's fault runtime (``repro_torch.runtime.fault``) against the JAX
package's (``repro.runtime.fault``), on the CPU.

Both draw from ``numpy.random.default_rng((seed, step, salt))``, so the
injector's and the solver-fault planner's streams must be bit-equal
without injection; the trackers, the env-var parsing and the supervisor's
restart accounting must agree exactly on the same inputs.
"""
import warnings

import numpy as np
import pytest

from repro.runtime import fault as jfault
from repro_torch.runtime import fault


@pytest.mark.parametrize("p_fail,seed,scheduled", [
    (0.0, 0, ()), (0.05, 3, ()), (0.3, 11, (5, 17, 17, 200)),
])
def test_failure_injector_streams_bit_equal(p_fail, seed, scheduled):
    """``check`` over 400 steps (scheduled steps fire once, even when
    replayed) and ``draw`` under several salts."""
    ours = fault.FailureInjector(p_fail=p_fail, seed=seed,
                                 scheduled=scheduled)
    theirs = jfault.FailureInjector(p_fail=p_fail, seed=seed,
                                    scheduled=scheduled)
    steps = list(range(300)) + list(range(150, 250))  # a restore-replay
    assert [ours.check(s) for s in steps] == [theirs.check(s) for s in steps]
    for salt in (0, 1, 2, 3 * 7 + 2):
        assert [ours.draw(s, salt) for s in range(400)] == \
            [theirs.draw(s, salt) for s in range(400)]


def test_trackers_match():
    rng = np.random.default_rng(0)
    dts = np.abs(rng.normal(1.0, 0.4, 300))
    dts[::37] *= 4  # stragglers
    ours, theirs = fault.StragglerTracker(), jfault.StragglerTracker()
    assert [ours.observe(float(d)) for d in dts] == \
        [theirs.observe(float(d)) for d in dts]
    assert (ours.slow_steps, ours.rate_estimate) == \
        (theirs.slow_steps, theirs.rate_estimate)
    assert ours.slow_steps > 0
    crashes = rng.random(300) < 0.08
    for kw in ({}, dict(alpha=0.5, threshold=0.3)):
        ours, theirs = fault.CrashRateTracker(**kw), jfault.CrashRateTracker(
            **kw)
        trace = [(ours.observe(bool(c)), ours.rate) for c in crashes]
        assert trace == [(theirs.observe(bool(c)), theirs.rate)
                         for c in crashes]
        assert ours.crashes == theirs.crashes == int(crashes.sum())


def test_planned_fault_plans_equal():
    for rate in (0.0, 0.1, 0.5, 1.0):
        for seed in (0, 9):
            for attempt in (0, 1, 2):
                assert [fault.planned_fault(c, rate, seed, attempt)
                        for c in range(200)] == \
                    [jfault.planned_fault(c, rate, seed, attempt)
                     for c in range(200)]
    plan = [fault.planned_fault(c, 0.5, 3) for c in range(200)]
    assert {"launch", "corrupt", None} == set(plan)


@pytest.mark.parametrize("raw,rate,warns", [
    (None, 0.0, False), ("", 0.0, False), ("0.25", 0.25, False),
    ("1", 1.0, False), ("abc", 0.0, True), ("1.5", 0.0, True),
    ("-0.1", 0.0, True),
])
def test_fault_rate_from_env_parses_the_same(monkeypatch, raw, rate, warns):
    assert fault.FAULT_RATE_ENV == jfault.FAULT_RATE_ENV
    assert fault.FAULT_SEED_ENV == jfault.FAULT_SEED_ENV
    if raw is None:
        monkeypatch.delenv(fault.FAULT_RATE_ENV, raising=False)
    else:
        monkeypatch.setenv(fault.FAULT_RATE_ENV, raw)
    for module in (fault, jfault):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert module.fault_rate_from_env() == rate
        assert bool(caught) == warns
        assert all(issubclass(w.category, RuntimeWarning) for w in caught)
    assert issubclass(fault.InjectedFault, RuntimeError)


class _MemoryCheckpoints:
    """A checkpoint manager in memory: what ``TrainSupervisor`` calls."""

    def __init__(self):
        self.saved = {}

    def save(self, step, state, async_=True):
        self.saved[step] = state

    def wait(self):
        pass

    def latest_step(self):
        return max(self.saved) if self.saved else None

    def restore(self, like, step):
        return self.saved[step], step


def _supervise(module, scheduled):
    """A counter state trained over a replayable stream of batches."""
    def step_fn(state, batch):
        return state * 3 + batch, {"loss": float(batch)}

    def make_iterator(start):
        return ((s, (s * 7) % 11) for s in range(start, 10 ** 6))

    sup = module.TrainSupervisor(
        step_fn, _MemoryCheckpoints(),
        module.FailureInjector(seed=4, scheduled=scheduled),
        save_every=10)
    seen = []
    state, final = sup.run(1, make_iterator, total_steps=60,
                           on_metrics=lambda s, m: seen.append((s, m)))
    return state, final, sup.restarts, sup.lost_steps, seen


@pytest.mark.parametrize("scheduled", [(), (17, 33)])
def test_train_supervisor_restarts_as_in_jax(scheduled):
    """Scheduled failures (each fires once, so a replay passes it): the
    same restores, lost steps and final state, which equals the
    failure-free run's (the stream replays exactly)."""
    ours = _supervise(fault, scheduled)
    assert ours == _supervise(jfault, scheduled)
    assert ours[0] == _supervise(fault, ())[0]
    if scheduled:
        assert ours[2:4] == (2, 7 + 3)  # 17 → 10 and 33 → 30
