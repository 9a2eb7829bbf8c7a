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

Every family sits in ``registry`` (``metrics/registry.py``) under the JAX
family's name, label names and buckets, so ``registry.get(name)`` finds it
(``perf/harness.py:MetricsCollector`` scrapes by name) and
``registry.expose()`` prints it. Beside them, the two families the perf
harness's default scrape reads: ``scheduling_algorithm_duration``
(``scheduler_scheduling_algorithm_duration_seconds``, by profile: the
sequential path's find-a-node time, ``scheduler/scheduler.py``) and
``device_batch_duration`` (``scheduler_tpu_batch_duration_seconds``, by
phase: upload, encode, compute per dispatched batch; commit_wait,
commit_host, commit_reconcile, commit and commit_backpressure per
committed batch, ``backend/tpu_scheduler.py``). The histogram keeps every
observation, so its quantiles are exact (the JAX registry's are bucket
estimates); one run's attempts are few enough. It also gives the JAX
registry's bucket estimate (``estimate``, ``estimate_since``), which the
rebalancer's SLO guardrail reads, as the JAX one reads ``percentile``. The continuous
rebalancer (``controllers/rebalance.py``) writes ``rebalance_waves`` (by
result: executed, empty, suspended), ``rebalance_migrations``,
``packing_entropy`` and ``rebalance_suspended`` (0 or 1). The
ring's commit worker observes on its own thread: a counter's increment
takes a lock, and a histogram's observation is one list append.
"""

from __future__ import annotations

from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry,
                       exponential_buckets)

__all__ = ["Counter", "DEFAULT_BUCKETS", "E2E_BUCKETS", "ERROR", "Gauge", "Histogram",
           "Registry", "SCHEDULED", "SchedulerMetrics", "UNSCHEDULABLE", "exponential_buckets"]

SCHEDULED = "scheduled"
UNSCHEDULABLE = "unschedulable"
ERROR = "error"

# the JAX pod e2e families' buckets (scheduler_metrics.py:353), to ~160 s
E2E_BUCKETS = exponential_buckets(0.005, 2, 16)


class SchedulerMetrics:
    def __init__(self, registry: Registry = None):
        self.registry = registry or Registry()
        r = self.registry

        def counter(name, help_, labels=()):
            return r.register(Counter(name, help_, labels))

        def gauge(name, help_, labels=()):
            return r.register(Gauge(name, help_, labels))

        def histogram(name, help_, labels=(), buckets=None):
            return r.register(Histogram(name, help_, labels, buckets))

        self.schedule_attempts = counter(
            "scheduler_schedule_attempts_total",
            "Number of attempts to schedule pods, by the result.", ["result", "profile"])
        self.scheduling_attempt_duration = histogram(
            "scheduler_scheduling_attempt_duration_seconds",
            "Scheduling attempt latency (algorithm + binding).", ["result", "profile"])
        self.scheduling_algorithm_duration = histogram(
            "scheduler_scheduling_algorithm_duration_seconds",
            "Scheduling algorithm latency.", ["profile"])
        self.preemption_attempts = counter(
            "scheduler_preemption_attempts_total", "Total preemption attempts in the cluster.")
        self.gangs_rejected = counter(
            "scheduler_gangs_rejected_total", "PodGroup gang rejection events by reason.",
            ["reason"])
        self.gang_wait_duration = histogram(
            "scheduler_gang_wait_duration_seconds",
            "Gang wait at Permit from first parked member to release/rejection.", ["result"])
        self.slice_wait_duration = histogram(
            "scheduler_slice_wait_duration_seconds",
            "Slice gang wait from batch pop to contiguous placement commit.", ["result"])
        self.slice_fragmentation = gauge(
            "scheduler_slice_fragmentation",
            "Torus fragmentation score per superpod (0 contiguous, ->1 shredded).",
            ["superpod"])
        self.quota_usage = gauge(
            "scheduler_quota_usage",
            "Scheduler-side quota ledger usage by namespace and dimension.",
            ["namespace", "resource"])
        self.quota_borrowed = gauge(
            "scheduler_quota_borrowed",
            "Ledger usage charged against cohort headroom (loans) by namespace and "
            "dimension.", ["namespace", "resource"])
        self.quota_reclaims = counter(
            "scheduler_quota_reclaims_total", "Cohort reclaim-by-preemption pass outcomes.",
            ["result"])
        self.evicted_pods = counter(
            "scheduler_evicted_pods_total",
            "Pods evicted by the elasticity machinery, by reason (drain|spot|taint).",
            ["reason"])
        # the relay breaker (0 closed, 1 half-open, 2 open) and the seconds
        # it held the batch path open
        self.backend_circuit_state = gauge(
            "scheduler_backend_circuit_state",
            "Device-service circuit breaker state (0 closed, 1 half-open, 2 open).")
        self.degraded_seconds = counter(
            "scheduler_degraded_seconds_total",
            "Seconds spent in breaker-open degraded (oracle fallback) mode.")
        self.device_slot_reuse = counter(
            "scheduler_device_slot_reuse_total",
            "Tombstoned DeviceState row slots handed to new nodes (bounded-capacity churn "
            "instead of monotonic growth).")
        # the wire path (backend/service.py; the JAX names, :145-210)
        self.wire_retries = counter(
            "scheduler_wire_retries_total", "Device-service transport retries by operation.",
            ["op"])
        self.wire_inflight = gauge(
            "scheduler_wire_inflight", "Wire batches in flight on the pipelined transport.")
        self.client_sessions = gauge(
            "scheduler_client_sessions", "Live scheduler sessions on the shared device service.")
        self.ha_takeovers = counter(
            "scheduler_ha_takeovers_total",
            "Peer scheduler sessions fenced and adopted by this replica.")
        self.commit_conflicts = counter(
            "scheduler_commit_conflicts_total", "Ownership-check conflicts at device commit time.",
            ["client"])
        # the device fabric (backend/fabric.py): the replica it routes to
        # (an index into its endpoints), failovers by the failing error's
        # family, each replica's health (1 up, 0 down), how many delta
        # generations each standby lags, and the bytes the warm-standby
        # replicator shipped (full seeds and dirty suffixes)
        self.fabric_active_replica = gauge(
            "scheduler_fabric_active_replica",
            "Index of the device-service replica the fabric routes to.")
        self.fabric_failovers = counter(
            "scheduler_fabric_failovers_total",
            "Device-fabric primary failovers by triggering error family.", ["reason"])
        self.fabric_replica_health = gauge(
            "scheduler_fabric_replica_health",
            "Device-service replica health by endpoint (1 up, 0 down).", ["endpoint"])
        self.standby_replication_lag = gauge(
            "scheduler_standby_replication_lag",
            "Delta generations a standby replica lags the primary stream.", ["endpoint"])
        self.standby_resync_bytes = counter(
            "scheduler_standby_resync_bytes_total",
            "Wire bytes shipped to standbys by the background replicator (full = "
            "seed/reseed, delta = incremental dirty set).", ["kind"])
        # the device runtime (backend/telemetry.py): kernel builds, device
        # memory, transfers, flight events, the dispatch waterfall
        self.xla_compilations = counter(
            "scheduler_xla_compilations_total",
            "XLA backend compilations by program and bucket signature.",
            ["program", "bucket"])
        self.xla_compile_duration = histogram(
            "scheduler_xla_compile_seconds", "XLA backend compile latency by program.",
            ["program"], exponential_buckets(0.01, 2, 14))
        self.xla_retraces = counter(
            "scheduler_xla_retraces_total",
            "XLA compilations beyond a program's first (retraces).", ["program"])
        self.hbm_bytes = gauge(
            "scheduler_device_hbm_bytes", "Device memory stats sample (in_use|peak|limit).",
            ["kind"])
        self.device_transfer_bytes = counter(
            "scheduler_device_transfer_bytes_total",
            "Host<->device transfer volume (upload = row sync, fetch = packed result block).",
            ["direction"])
        self.flight_events = counter(
            "scheduler_flight_recorder_events_total", "Batch flight-recorder events by type.",
            ["type"])
        self.device_dispatch_duration = histogram(
            "scheduler_device_dispatch_seconds",
            "Per-dispatch device-time decomposition by program and phase "
            "(dwell|exec|fetch).", ["program", "phase"], exponential_buckets(0.0002, 2, 16))
        # the loop's phases per batch (backend/tpu_scheduler.py)
        self.device_batch_duration = histogram(
            "scheduler_tpu_batch_duration_seconds", "Device schedule_batch call latency.",
            ["phase"])
        # the pod-lifetime latency ledger (metrics/latency_ledger.py)
        self.pod_e2e_duration = histogram(
            "scheduler_pod_e2e_duration_seconds",
            "Pod end-to-end latency from first enqueue to bind (or terminal delete), across "
            "all attempts.", ["result"], E2E_BUCKETS)
        self.pod_latency_segment = histogram(
            "scheduler_pod_latency_segment_seconds",
            "Per-pod lifetime wall-clock attribution by named segment (observed once per "
            "segment at pod close).", ["segment"], E2E_BUCKETS)
        self.tenant_e2e_duration = histogram(
            "scheduler_tenant_e2e_duration_seconds",
            "Pod end-to-end latency per tenant namespace (quota tenants only — the "
            "fair-share SLO feed).", ["namespace"], E2E_BUCKETS)
        self.ledger_evicted = counter(
            "scheduler_pod_ledger_evicted_total",
            "Latency-ledger entries evicted at the live-entry cap (oldest first; nonzero "
            "means e2e attribution lost pods).")
        # the continuous rebalancer (controllers/rebalance.py)
        self.rebalance_waves = counter(
            "scheduler_rebalance_waves_total",
            "Rebalance wave attempts by outcome (executed / empty / suspended).", ["result"])
        self.rebalance_migrations = counter(
            "scheduler_rebalance_migrations_total",
            "Pods evicted by rebalance migration waves (each re-binds via the normal requeue "
            "path).")
        self.packing_entropy = gauge(
            "scheduler_packing_entropy",
            "Mean normalized bin-packing entropy over live resource axes (the rebalance "
            "trigger's score; lower is better packed).")
        self.rebalance_suspended = gauge(
            "scheduler_rebalance_suspended",
            "1 while the tenant-SLO guardrail breaker holds rebalancing suspended, else 0.")
        # the framework runtime (framework/runtime.py)
        self.framework_extension_point_duration = histogram(
            "scheduler_framework_extension_point_duration_seconds",
            "Latency per extension point.", ["extension_point", "status", "profile"])
        self.plugin_execution_duration = histogram(
            "scheduler_plugin_execution_duration_seconds",
            "Plugin execution latency (sampled).", ["plugin", "extension_point", "status"])

    def observe_attempt(self, result: str, profile: str, duration_s: float) -> None:
        self.schedule_attempts.inc(result, profile)
        self.scheduling_attempt_duration.observe(duration_s, result, profile)
