"""Fault-tolerance machinery: straggler detection, failure injection, and a
restart supervisor (the port's own copy of ``repro/train/fault_tolerance.py``,
pure Python).

The failure modes are (a) hard loss of the process — handled by
checkpoint/auto-resume (checkpoint.py) under ``run_with_restarts``, and (b)
stragglers — detected here by a robust z-score over recent step
wall-times; the report names the slow step.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float
    mad: float
    z: float


class StragglerMonitor:
    """Robust z-score (median/MAD) straggler detector over a sliding window."""

    def __init__(self, window: int = 50, z_threshold: float = 5.0,
                 min_samples: int = 10):
        self.window = window
        self.z_threshold = z_threshold
        self.min_samples = min_samples
        self.times: list[float] = []
        self.events: list[StragglerEvent] = []

    def record(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        history = self.times[-self.window:]
        self.times.append(step_time)
        if len(history) < self.min_samples:
            return None
        med = statistics.median(history)
        mad = statistics.median(abs(t - med) for t in history) or 1e-9
        z = 0.6745 * (step_time - med) / mad
        if z > self.z_threshold:
            ev = StragglerEvent(step, step_time, med, mad, z)
            self.events.append(ev)
            return ev
        return None


class FailureInjector:
    """Deterministic failure injection for tests: raises at given steps."""

    def __init__(self, fail_at: set[int]):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


def run_with_restarts(make_trainer: Callable[[], "object"],
                      total_steps: int, max_restarts: int = 3) -> "object":
    """Supervisor loop: (re)build the trainer (which auto-resumes from the
    newest checkpoint) and run until total_steps, tolerating up to
    max_restarts failures."""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            trainer.train(total_steps)
            return trainer
        except RuntimeError as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts; last error: {e}")
