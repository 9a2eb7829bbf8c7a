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
registry's are bucket estimates); one run's attempts are few enough. A
histogram given the JAX family's buckets (``tenant_e2e_duration``:
``exponential_buckets(0.005, 2, 16)``) also gives the JAX registry's
estimate (``estimate``, ``estimate_since``), which the rebalancer's SLO
guardrail reads, as the JAX one reads ``percentile``. The continuous
rebalancer (``controllers/rebalance.py``) writes ``rebalance_waves`` (by
result: executed, empty, suspended), ``rebalance_migrations``,
``packing_entropy`` and ``rebalance_suspended`` (0 or 1). The
ring's commit worker observes on its own thread: a counter's increment
takes a lock, and a histogram's observation is one list append.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SCHEDULED = "scheduled"
UNSCHEDULABLE = "unschedulable"
ERROR = "error"


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    """The JAX registry's bucket bounds (``metrics/registry.py:79``)."""
    return [start * factor ** i for i in range(count)]


# the JAX pod e2e families' buckets (scheduler_metrics.py:353), to ~160 s
E2E_BUCKETS = exponential_buckets(0.005, 2, 16)


class Histogram:
    """Observations per label values; ``quantile`` over those of one
    label set, or over all of them with no labels given. ``buckets`` (the
    upper bounds of a JAX registry family) enable the bucket estimate."""

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        self._obs: Dict[Tuple[str, ...], List[float]] = {}
        self.buckets = sorted(buckets) if buckets else None

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

    def estimate(self, q: float, *labels: str) -> float:
        """The JAX registry's ``percentile`` (``kubernetes_tpu/metrics/
        registry.py:146-193``): linear interpolation inside the bucket the
        ``q`` quantile falls in, from the label set's bucket counts."""
        return self.estimate_since(0, q, *labels)

    def estimate_since(self, snap: int, q: float, *labels: str) -> float:
        """``estimate`` over the observations since ``snap``, as the JAX
        registry's ``percentile_since`` over its bucket-count delta."""
        if self.buckets is None:
            raise ValueError("histogram has no buckets")
        vals = self._obs.get(labels, ())[snap:]
        if not vals:
            return 0.0
        counts = [0] * len(self.buckets)
        for v in vals:
            i = bisect.bisect_left(self.buckets, v)
            if i < len(counts):
                counts[i] += 1
        target = q * len(vals)
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
        # the wire path (backend/service.py; the JAX names, :145-210)
        self.wire_retries = Counter()                  # scheduler_wire_retries_total, by op
        self.wire_inflight = Gauge()                   # scheduler_wire_inflight
        self.client_sessions = Gauge()                 # scheduler_client_sessions
        self.ha_takeovers = Counter()                  # scheduler_ha_takeovers_total
        self.commit_conflicts = Counter()              # scheduler_commit_conflicts_total, by client
        # the device fabric (backend/fabric.py): the replica it routes to
        # (an index into its endpoints), failovers by the failing error's
        # family, each replica's health (1 up, 0 down), how many delta
        # generations each standby lags, and the bytes the warm-standby
        # replicator shipped (full seeds and dirty suffixes)
        self.fabric_active_replica = Gauge()           # scheduler_fabric_active_replica
        self.fabric_failovers = Counter()              # by reason: transient, permanent
        self.fabric_replica_health = Gauge()           # by endpoint
        self.standby_replication_lag = Gauge()         # by endpoint
        self.standby_resync_bytes = Counter()          # by kind: full, delta
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
        self.tenant_e2e_duration = Histogram(E2E_BUCKETS)  # by quota tenant namespace
        self.ledger_evicted = Counter()                # scheduler_pod_ledger_evicted_total
        # the continuous rebalancer (controllers/rebalance.py)
        self.rebalance_waves = Counter()               # by result
        self.rebalance_migrations = Counter()
        self.packing_entropy = Gauge()
        self.rebalance_suspended = Gauge()
        # the framework runtime (framework/runtime.py)
        self.framework_extension_point_duration = Histogram()  # by (point, status, profile)
        self.plugin_execution_duration = Histogram()   # by (plugin, point, status), sampled

    def observe_attempt(self, result: str, profile: str, duration_s: float) -> None:
        self.schedule_attempts.inc(result, profile)
        self.scheduling_attempt_duration.observe(duration_s, result, profile)
