"""A Prometheus-style metrics registry: an own copy of
``kubernetes_tpu/metrics/registry.py`` (component-base/metrics'
legacyregistry pattern), so that a scheduler_perf metricsCollector
(``perf/harness.py:MetricsCollector``) looks families up by name and
``expose()`` prints the Prometheus text format.

Counters and gauges are the JAX ones. The histogram keeps the port's design:
it keeps every observation, so ``quantile``, ``percentile`` and
``percentile_since`` are exact (numpy's linear interpolation), where the
JAX registry's are bucket estimates. It also has the JAX family's bucket
bounds (``DEFAULT_BUCKETS`` unless given): ``estimate`` / ``estimate_since``
give the JAX registry's bucket estimate (``percentile`` /
``percentile_since`` there, ``:146-193``), and ``collect`` the JAX bucket
lines, counted from the observations. OpenMetrics exemplars are not ported.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LabelValues = Tuple[str, ...]


def _escape_label_value(v: str) -> str:
    """Prometheus text-format escaping of a label value: backslash, double
    quote and line feed."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: LabelValues) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def _running_sum(values) -> float:
    """The sum as the JAX histogram accumulates it: one float addition per
    observation, in order (``sum`` of floats rounds otherwise)."""
    total = 0.0
    for v in values:
        total += v
    return total


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    """The JAX registry's bucket bounds (``:79``)."""
    return [start * factor ** i for i in range(count)]


# the scheduler's latency buckets: exponential 1 ms to about 16 s (metrics.go)
DEFAULT_BUCKETS = exponential_buckets(0.001, 2, 15)


class Counter:
    def __init__(self, name: str = "", help_: str = "", labels: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self.by_labels: Dict[LabelValues, float] = {}
        self._mu = threading.Lock()

    def inc(self, *labels: str, value: float = 1) -> None:
        with self._mu:
            self.by_labels[labels] = self.by_labels.get(labels, 0) + value

    def labels(self, *labels: str) -> float:
        return self.by_labels.get(labels, 0)

    def label_sets(self) -> List[LabelValues]:
        with self._mu:
            return list(self.by_labels)

    def _lines(self, type_: str, fmt) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {type_}"]
        with self._mu:
            for lv, v in sorted(self.by_labels.items()):
                out.append(f"{self.name}{_fmt_labels(self.label_names, lv)} {fmt(v)}")
        return out

    def collect(self) -> List[str]:
        # the JAX counter accumulates floats from 0.0
        return self._lines("counter", float)


class Gauge(Counter):
    def set(self, *labels: str, value: float = 0.0) -> None:
        with self._mu:
            self.by_labels[labels] = value

    def collect(self) -> List[str]:
        # the JAX gauge prints the value it was set to as it is
        return self._lines("gauge", lambda v: v)


class Histogram:
    """Observations per label values. ``snapshot`` marks a phase;
    ``percentile_since`` / ``count_since`` read what came after it."""

    def __init__(self, name: str = "", help_: str = "", labels: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self.buckets = sorted(buckets or DEFAULT_BUCKETS)
        self._obs: Dict[LabelValues, List[float]] = {}

    def observe(self, value: float, *labels: str) -> None:
        self._obs.setdefault(labels, []).append(value)

    def values(self, *labels: str) -> List[float]:
        if labels:
            return list(self._obs.get(labels, ()))
        return [v for obs in list(self._obs.values()) for v in obs]

    def count(self, *labels: str) -> int:
        return len(self.values(*labels))

    def sum(self, *labels: str) -> float:
        return _running_sum(self.values(*labels))

    def label_sets(self) -> List[LabelValues]:
        return list(self._obs)

    def snapshot(self, *labels: str) -> int:
        """A phase marker: the label set's observation count now."""
        return len(self._obs.get(labels, ()))

    def quantile(self, q: float, *labels: str, since: int = 0) -> float:
        """The exact ``q`` quantile (0..1, linear interpolation) of the
        label set's observations from the ``since``-th on (of all of them
        with no labels given); 0.0 when there are none."""
        vals = self.values(*labels)[since:]
        return float(np.quantile(vals, q)) if vals else 0.0

    def percentile(self, q: float, *labels: str) -> float:
        """The exact ``q`` quantile of the label set (the JAX registry's
        name; its value there is the bucket estimate, ``estimate`` here)."""
        return self.quantile(q, *labels)

    def percentile_since(self, snap: int, q: float, *labels: str) -> float:
        """The exact ``q`` quantile of the label set's observations since
        ``snap``."""
        return self.quantile(q, *labels, since=snap)

    def count_since(self, snap: int, *labels: str) -> int:
        return len(self._obs.get(labels, ())) - snap

    def bucket_counts(self, *labels: str, since: int = 0) -> List[int]:
        """Per-bucket (not cumulative) counts of the label set's
        observations from the ``since``-th on, as the JAX histogram keeps
        them: a value lands in the first bucket whose bound is >= it, and
        one above the last bound in none (only in ``+Inf``)."""
        counts = [0] * len(self.buckets)
        for v in self._obs.get(labels, ())[since:]:
            i = bisect.bisect_left(self.buckets, v)
            if i < len(counts):
                counts[i] += 1
        return counts

    def estimate(self, q: float, *labels: str) -> float:
        """The JAX registry's ``percentile``: linear interpolation inside
        the bucket the ``q`` quantile falls in, from the bucket counts."""
        return self.estimate_since(0, q, *labels)

    def estimate_since(self, snap: int, q: float, *labels: str) -> float:
        """``estimate`` over the observations since ``snap``, as the JAX
        registry's ``percentile_since`` over its bucket-count delta."""
        total = self.count_since(snap, *labels)
        if total <= 0:
            return 0.0
        counts = self.bucket_counts(*labels, since=snap)
        target = q * total
        cum = 0
        for i, b in enumerate(self.buckets):
            below = cum
            cum += counts[i]
            if cum >= target:
                if counts[i] == 0:
                    return b
                lo = self.buckets[i - 1] if i else 0.0
                return lo + (target - below) / counts[i] * (b - lo)
        return self.buckets[-1]

    def collect(self) -> List[str]:
        """The JAX exposition lines: cumulative bucket counts per label set,
        ``+Inf``, ``_sum`` and ``_count``."""
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for lv in sorted(list(self._obs)):
            vals = list(self._obs[lv])
            cum = 0
            for b, n in zip(self.buckets, self.bucket_counts(*lv)):
                cum += n
                labels = _fmt_labels([*self.label_names, "le"], (*lv, repr(b)))
                out.append(f"{self.name}_bucket{labels} {cum}")
            labels = _fmt_labels([*self.label_names, "le"], (*lv, "+Inf"))
            out.append(f"{self.name}_bucket{labels} {len(vals)}")
            out.append(f"{self.name}_sum{_fmt_labels(self.label_names, lv)} "
                       f"{_running_sum(vals)}")
            out.append(f"{self.name}_count{_fmt_labels(self.label_names, lv)} {len(vals)}")
        return out


class Registry:
    """component-base/metrics legacyregistry analog: families by name."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, metric):
        """Add ``metric``; a name already registered returns that family."""
        with self._lock:
            if metric.name in self._metrics:
                return self._metrics[metric.name]
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """The Prometheus text exposition (0.0.4), families by name."""
        with self._lock:
            metrics = dict(self._metrics)
        lines: List[str] = []
        for name in sorted(metrics):
            lines.extend(metrics[name].collect())
        return "\n".join(lines) + "\n"
