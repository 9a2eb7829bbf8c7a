"""The scheduler loop's metrics (a trimmed ``kubernetes_tpu/metrics/
scheduler_metrics.py``, pkg/scheduler/metrics/metrics.go): the
``scheduling_attempt_duration_seconds`` histogram by result, timed from a
batch's pop to each pod's commit, and the ``schedule_attempts`` and
``preemption_attempts`` counters. ``run_loop`` reads the p50 / p90 / p99
of a run's measured phase.

The histogram keeps every observation, so its quantiles are exact (the JAX
registry's are bucket estimates); one run's attempts are few enough. The
ring's commit worker observes on its own thread: a counter's increment
takes a lock, and a histogram's observation is one list append.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np

SCHEDULED = "scheduled"
UNSCHEDULABLE = "unschedulable"
ERROR = "error"


class Histogram:
    """Observations per label values; ``quantile`` over those of one
    label set, or over all of them with no labels given."""

    def __init__(self):
        self._obs: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, *labels: str) -> None:
        self._obs.setdefault(labels, []).append(value)

    def values(self, *labels: str) -> List[float]:
        if labels:
            return list(self._obs.get(labels, ()))
        return [v for obs in self._obs.values() for v in obs]

    def count(self, *labels: str) -> int:
        return len(self.values(*labels))

    def quantile(self, q: float, *labels: str, since: int = 0) -> float:
        """The ``q`` quantile (0..1, linear interpolation) of the label
        set's observations from the ``since``-th on; 0.0 when there are
        none."""
        vals = self.values(*labels)[since:]
        return float(np.quantile(vals, q)) if vals else 0.0


class Counter:
    def __init__(self):
        self.by_labels: Dict[Tuple[str, ...], int] = {}
        self._mu = threading.Lock()

    def inc(self, *labels: str, value: int = 1) -> None:
        with self._mu:
            self.by_labels[labels] = self.by_labels.get(labels, 0) + value


class SchedulerMetrics:
    def __init__(self):
        self.schedule_attempts = Counter()             # by (result, profile)
        self.scheduling_attempt_duration = Histogram()  # by (result, profile)
        self.preemption_attempts = Counter()

    def observe_attempt(self, result: str, profile: str, duration_s: float) -> None:
        self.schedule_attempts.inc(result, profile)
        self.scheduling_attempt_duration.observe(duration_s, result, profile)
