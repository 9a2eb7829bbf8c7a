"""The scheduler loop's metrics (a trimmed ``kubernetes_tpu/metrics/
scheduler_metrics.py``, pkg/scheduler/metrics/metrics.go): the
``scheduling_attempt_duration_seconds`` histogram by result, timed from a
batch's pop to each pod's commit, and the ``schedule_attempts`` and
``preemption_attempts`` counters. ``run_loop`` reads the p50 / p90 / p99
of a run's measured phase. The gang, slice and quota parts of the loop
write ``gangs_rejected`` (by reason), ``gang_wait_duration`` and
``slice_wait_duration`` (by result), ``slice_fragmentation`` (by
superpod), the quota gauges ``quota_usage`` and ``quota_borrowed`` (by
namespace and dimension), ``quota_reclaims`` (by outcome: evicted, noop,
or suspended while the reclaim pass's SLO breaker is open) and
``evicted_pods`` (by reason). The relay breaker writes
``backend_circuit_state`` (0 closed, 1 half-open, 2 open) and
``degraded_seconds`` (the seconds the breaker held the batch path open),
and the encoder's reused node slots feed ``device_slot_reuse``. The
observability layer (``backend/telemetry.py``, ``metrics/latency_ledger.py``,
``framework/runtime.py``) writes the JAX families of ``:40-48``,
``:218-270`` and ``:344-370``: ``xla_compilations`` (by program and bucket:
here the ``nvcc`` builds of the fused kernel), ``xla_compile_duration`` and
``xla_retraces`` (by program), ``hbm_bytes`` (by kind: in_use, peak,
limit), ``device_transfer_bytes`` (by direction: upload, fetch),
``flight_events`` (by type), ``device_dispatch_duration`` (by program and
phase: dwell, exec, fetch), ``pod_e2e_duration`` (by result),
``pod_latency_segment`` (by segment), ``tenant_e2e_duration`` (by quota
tenant), ``ledger_evicted`` (``scheduler_pod_ledger_evicted_total``),
``framework_extension_point_duration`` (by point, status and profile) and
``plugin_execution_duration`` (by plugin, point and status; sampled). All
under the JAX metrics' names.

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

    def sum(self, *labels: str) -> float:
        return float(sum(self.values(*labels)))

    def label_sets(self) -> List[Tuple[str, ...]]:
        return list(self._obs)

    def snapshot(self, *labels: str) -> int:
        """A phase marker for ``percentile_since`` and ``count_since``
        (``kubernetes_tpu/metrics/registry.py:154-175``): the label set's
        observation count now."""
        return len(self._obs.get(labels, ()))

    def percentile_since(self, snap: int, q: float, *labels: str) -> float:
        """The exact ``q`` quantile of the label set's observations since
        ``snap`` (the JAX registry's is a bucket estimate)."""
        return self.quantile(q, *labels, since=snap)

    def count_since(self, snap: int, *labels: str) -> int:
        return len(self._obs.get(labels, ())) - snap

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

    def inc(self, *labels: str, value: float = 1) -> None:
        with self._mu:
            self.by_labels[labels] = self.by_labels.get(labels, 0) + value

    def labels(self, *labels: str) -> float:
        return self.by_labels.get(labels, 0)

    def label_sets(self) -> List[Tuple[str, ...]]:
        return list(self.by_labels)


class Gauge(Counter):
    def set(self, *labels: str, value: float) -> None:
        with self._mu:
            self.by_labels[labels] = value


class SchedulerMetrics:
    def __init__(self):
        self.schedule_attempts = Counter()             # by (result, profile)
        self.scheduling_attempt_duration = Histogram()  # by (result, profile)
        self.preemption_attempts = Counter()
        self.gangs_rejected = Counter()                # by reason
        self.gang_wait_duration = Histogram()          # by result
        self.slice_wait_duration = Histogram()         # by result
        self.slice_fragmentation = Gauge()             # by superpod
        self.quota_usage = Gauge()                     # by (namespace, dimension)
        self.quota_borrowed = Gauge()                  # by (namespace, dimension)
        self.quota_reclaims = Counter()                # by outcome
        self.evicted_pods = Counter()                  # by reason
        self.backend_circuit_state = Gauge()           # the relay breaker's STATE_VALUES
        self.degraded_seconds = Counter()              # seconds the breaker held open
        self.device_slot_reuse = Counter()             # tombstoned slots handed to new nodes
        # the device runtime (backend/telemetry.py): kernel builds, device
        # memory, transfers, flight events, the dispatch waterfall
        self.xla_compilations = Counter()              # by (program, bucket)
        self.xla_compile_duration = Histogram()        # by program
        self.xla_retraces = Counter()                  # by program
        self.hbm_bytes = Gauge()                       # by kind
        self.device_transfer_bytes = Counter()         # by direction
        self.flight_events = Counter()                 # by type
        self.device_dispatch_duration = Histogram()    # by (program, phase)
        # the pod-lifetime latency ledger (metrics/latency_ledger.py)
        self.pod_e2e_duration = Histogram()            # by result
        self.pod_latency_segment = Histogram()         # by segment
        self.tenant_e2e_duration = Histogram()         # by quota tenant namespace
        self.ledger_evicted = Counter()                # scheduler_pod_ledger_evicted_total
        # the framework runtime (framework/runtime.py)
        self.framework_extension_point_duration = Histogram()  # by (point, status, profile)
        self.plugin_execution_duration = Histogram()   # by (plugin, point, status), sampled

    def observe_attempt(self, result: str, profile: str, duration_s: float) -> None:
        self.schedule_attempts.inc(result, profile)
        self.scheduling_attempt_duration.observe(duration_s, result, profile)
