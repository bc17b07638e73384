"""Fault-tolerance machinery: failure injection, detection, restart policy,
straggler tracking (counterpart of ``repro.runtime.fault``).

The :class:`FailureInjector` models node failures as a seeded,
counter-based random process (``numpy.random.default_rng((seed, step,
salt))``), so its streams are the JAX package's bit for bit.  The
:class:`TrainSupervisor` owns a training loop: step → (maybe) failure →
restore from checkpoint → continue, counting lost steps.
:class:`StragglerTracker` flags slow steps, and :class:`CrashRateTracker`
applies the same pattern to crash events: the failure-aware cluster
runtime (``sched.dispatcher.FailureRuntime``) drives its per-server crash
process with the injector and its detection-driven eligibility with the
tracker.

:func:`planned_fault` / :class:`InjectedFault` and ``$REPRO_DP_FAULT_RATE``
are the deterministic solver-fault hook of the degradation chain
(``core.solvers.FallbackSolver``); both packages plan the same faults.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np

__all__ = [
    "FailureInjector", "StragglerTracker", "CrashRateTracker",
    "TrainSupervisor", "InjectedFault", "planned_fault",
    "fault_rate_from_env", "FAULT_RATE_ENV", "FAULT_SEED_ENV",
]


@dataclasses.dataclass
class FailureInjector:
    """Bernoulli(p) node failure per step + optional deterministic schedule.

    A scheduled failure fires ONCE — node failures are transient; replaying
    through the same step after restore must not re-kill the job (otherwise
    recovery live-locks — caught by test_supervisor_restart_exact).

    The Bernoulli draw is COUNTER-BASED: step t's outcome is a pure function
    of ``(seed, t)``, never of how many times ``check`` was called before.
    A restore-replay through the same steps therefore sees the identical
    failure stream (a stateful generator would silently re-randomize it —
    caught by test_injector_replay_deterministic).
    """
    p_fail: float = 0.0
    seed: int = 0
    scheduled: tuple[int, ...] = ()

    def __post_init__(self):
        self._fired: set[int] = set()

    def check(self, step: int) -> bool:
        if step in self.scheduled and step not in self._fired:
            self._fired.add(step)
            return True
        if self.p_fail <= 0.0:
            return False
        return self.draw(step) < self.p_fail

    def draw(self, step: int, salt: int = 0) -> float:
        """The uniform [0, 1) variate behind step ``step`` (pure in
        ``(seed, step, salt)``).  Consumers needing extra independent
        per-step randomness — e.g. the in-slot crash fraction of the
        failure-aware dispatcher — draw with a distinct ``salt``."""
        return float(
            np.random.default_rng((self.seed, int(step), salt)).random())


@dataclasses.dataclass
class StragglerTracker:
    """EMA of per-step wall time; flags steps slower than k× the EMA."""
    alpha: float = 0.1
    k: float = 2.0
    _ema: Optional[float] = None
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        if self._ema is None:
            self._ema = dt
            return False
        slow = dt > self.k * self._ema
        self._ema = (1 - self.alpha) * self._ema + self.alpha * dt
        self.slow_steps += int(slow)
        return slow

    @property
    def rate_estimate(self) -> float:
        return 1.0 / self._ema if self._ema else 0.0


@dataclasses.dataclass
class CrashRateTracker:
    """EMA of a per-step crash indicator; flags elevated crash rates.

    :class:`StragglerTracker`'s detection pattern applied to failures: the
    failure-aware dispatcher keeps one tracker per server, feeds it the
    server's crash indicator each slot, and masks the edges of servers
    whose estimated rate exceeds ``threshold`` out of eligibility — a
    freshly-repaired crasher sits out a probation window (~4 slots at the
    defaults) instead of immediately receiving work again.
    """
    alpha: float = 0.2
    threshold: float = 0.1
    rate: float = 0.0
    crashes: int = 0

    def observe(self, crashed: bool) -> bool:
        self.rate = (1 - self.alpha) * self.rate + self.alpha * float(crashed)
        self.crashes += int(crashed)
        return self.suspicious

    @property
    def suspicious(self) -> bool:
        return self.rate > self.threshold


# ---------------------------------------------------------------------------
# deterministic solver-fault injection (the CI hook of the fallback chain)
# ---------------------------------------------------------------------------

FAULT_RATE_ENV = "REPRO_DP_FAULT_RATE"
FAULT_SEED_ENV = "REPRO_DP_FAULT_SEED"


class InjectedFault(RuntimeError):
    """Synthetic backend-launch failure raised by the fault hook."""


def fault_rate_from_env() -> float:
    """The injection rate requested by ``$REPRO_DP_FAULT_RATE`` (0.0 when
    unset).  An unparsable value warns and disables injection — a stale
    shell var must never corrupt a production run."""
    raw = os.environ.get(FAULT_RATE_ENV)
    if not raw:
        return 0.0
    try:
        rate = float(raw)
    except ValueError:
        warnings.warn(
            f"ignoring unparsable {FAULT_RATE_ENV}={raw!r}; fault "
            "injection disabled", RuntimeWarning, stacklevel=2)
        return 0.0
    if not 0.0 <= rate <= 1.0:
        warnings.warn(
            f"ignoring out-of-range {FAULT_RATE_ENV}={raw!r} (want "
            "[0, 1]); fault injection disabled", RuntimeWarning,
            stacklevel=2)
        return 0.0
    return rate


def planned_fault(
    call_index: int, rate: float, seed: int = 0, attempt: int = 0
) -> "str | None":
    """The fault (if any) planned for one solver attempt.

    Pure in ``(seed, call_index, attempt)`` — the same run always injects
    the same faults at the same call indices, so a CI leg exercising the
    fallback chain is reproducible.  Returns ``None`` (no fault),
    ``"launch"`` (the attempt should raise :class:`InjectedFault` instead
    of launching) or ``"corrupt"`` (the attempt's value plane should be
    poisoned so output validation has something to catch), split evenly.
    """
    if rate <= 0.0:
        return None
    rng = np.random.default_rng((seed, int(call_index), int(attempt), 0xFA))
    if rng.random() >= rate:
        return None
    return "launch" if rng.random() < 0.5 else "corrupt"


class TrainSupervisor:
    """Checkpoint/restart loop around a step function.

    step_fn(state, batch) -> (state, metrics); ``make_iterator(step)``
    yields ``(step, batch)`` pairs from ``step`` on and must replay the
    same stream from any step, so recovery replays it exactly.  ``ckpt``
    has ``save(step, state, async_=...)``, ``wait()``, ``latest_step()``
    and ``restore(like=..., step=...)``.
    """

    def __init__(
        self,
        step_fn: Callable,
        ckpt,
        injector: FailureInjector,
        save_every: int = 50,
        async_save: bool = True,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.injector = injector
        self.save_every = save_every
        self.async_save = async_save
        self.straggler = StragglerTracker()
        self.restarts = 0
        self.lost_steps = 0

    def run(
        self,
        state,
        make_iterator,
        total_steps: int,
        start_step: int = 0,
        on_metrics: Optional[Callable] = None,
    ):
        step = start_step
        it = make_iterator(step)
        while step < total_steps:
            t0 = time.time()
            if self.injector.check(step):
                # simulate node loss: restore latest checkpoint, rebuild
                # the data iterator at the restored step (restart-exact).
                # An async save may still be in flight — join it first, or
                # latest_step() misses the newest checkpoint and the
                # restart replays more steps than it lost.
                self.restarts += 1
                self.ckpt.wait()
                restored = self.ckpt.latest_step()
                if restored is None:
                    restored = start_step
                    state_r = state  # no checkpoint yet: lose nothing but time
                else:
                    state_r, restored = self.ckpt.restore(like=state,
                                                          step=restored)
                self.lost_steps += max(step - restored, 0)
                step = restored
                it = make_iterator(step)
                state = state_r
                continue
            _, batch = next(it)
            state, metrics = self.step_fn(state, batch)
            self.straggler.observe(time.time() - t0)
            if on_metrics is not None:
                on_metrics(step, metrics)
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, state, async_=self.async_save)
        self.ckpt.wait()
        return state, step
