"""The Scheduler: the store, cache and queue wiring around a batched loop
(``kubernetes_tpu/scheduler/scheduler.py:105-1011``; pkg/scheduler/
scheduler.go, eventhandlers.go, schedule_one.go's failure handling).

The store's nodes and pods are replayed as ADDED events, then the store's
handlers feed the cache and the queue (``_add_all_event_handlers``): an
unbound pod of this scheduler joins the queue, a bound one the cache and a
queue move (``assigned_pod_updated_or_added``); a node event updates the
cache and moves the pods the change may help. A failed pod
(``_handle_scheduling_failure``) runs the profile's PostFilter
(DefaultPreemption) when it failed a filter, persists its nomination in
the store, and returns to the queue unless it is gone or bound meanwhile.
``run_until_settled`` (the reference's ``run_batched_until_settled``,
``:936``, which its ``TPUScheduler.run_until_settled`` calls) drives the
subclass's ``schedule_batch_cycle`` until the queue settles.

The ring's commit worker lands batches on a second thread, so the outcome
counters take an atomic ``inc`` (``:91-98``), and every store event that
can change what the device mirrors bumps ``external_change_seq``
(``:141-142``, ``:446-455``): a node event, and a bound pod's add, update
or delete, except the confirmation of this scheduler's own assumed bind.
The ring rides the device carry only while the sequence holds.

Left out: the sequential per-pod cycle (``schedule_one``) and the
extenders; Permit and its waiting pods, the PreEnqueue gate and quota
release moves, which come with the gang and quota parts of the loop.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from ..api.types import Node, Pod
from ..apiserver.store import ADDED, DELETED, MODIFIED, NotFound, Store
from ..cache.cache import Cache
from ..cache.snapshot import Snapshot
from ..framework.profile import Profile
from ..framework.types import ClusterEvent, Diagnosis, QueuedPodInfo
from ..metrics.scheduler_metrics import SchedulerMetrics
from ..queue import events as qevents
from ..queue.scheduling_queue import SchedulingQueue

MIN_FEASIBLE_NODES_TO_FIND = 100           # schedule_one.go:52
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5  # :56
# the settle loop's bounds: at most this many pods popped, and this many
# cycles without progress, each sleeping IDLE_WAIT_S times its count (at
# most ten times)
SETTLE_MAX_CYCLES = 100000
SETTLE_MAX_NO_PROGRESS = 200
IDLE_WAIT_S = 0.005


def num_feasible_nodes_to_find(num_all_nodes: int, percentage: int = 0) -> int:
    """Adaptive sampling (schedule_one.go:525): every node below 100 nodes;
    else ``percentage`` of them, or the adaptive 50 - N/125 percent, floored
    at 5 percent and at 100 nodes."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND or percentage >= 100:
        return num_all_nodes
    pct = percentage
    if pct == 0:
        pct = int(50 - num_all_nodes / 125)
        if pct < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
            pct = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
    num = num_all_nodes * pct // 100
    if num < MIN_FEASIBLE_NODES_TO_FIND:
        return MIN_FEASIBLE_NODES_TO_FIND
    return num


class SyncCounters(dict):
    """The loop's outcome counters with an atomic ``inc``: the commit worker
    and the scheduling thread both count, and ``d[k] += 1`` from two
    threads can lose an update."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._mu = threading.Lock()

    def inc(self, key: str, n: int = 1) -> None:
        with self._mu:
            self[key] = self.get(key, 0) + n


class Scheduler:
    def __init__(self, store: Store, percentage_of_nodes_to_score: int = 0,
                 now_fn=time.monotonic):
        self.store = store
        self.now_fn = now_fn
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.cache = Cache(now_fn=now_fn)
        self.snapshot = Snapshot()
        self.smetrics = SchedulerMetrics()
        self.metrics = SyncCounters(schedule_attempts=0, scheduled=0, unschedulable=0,
                                    errors=0)
        # external node-truth changes, counted under _ext_mu (a lost bump
        # would keep a stale device carry)
        self._ext_mu = threading.Lock()
        self._external_events = 0
        self.settle_abandoned = False
        self.idle_seconds = 0.0  # slept by run_until_settled after no-progress cycles
        # victim key -> the preemptor that evicted it, and every nomination
        # made, in order: (pod key, node)
        self.preempted: Dict[str, str] = {}
        self.nominations = []
        self._last_cleanup = now_fn()
        self._last_unsched_flush = now_fn()
        self.profile = Profile(store, lambda: self._failure_snapshot().list(), store.ns_labels,
                               self._evict, self._clear_nomination, store.list_pdbs)
        self.queue = SchedulingQueue(less_key=self.profile.sort_key,
                                     cluster_event_map=self.profile.event_map, now_fn=now_fn)
        self._add_all_event_handlers()

    # ----------------------------------------------------------- event wiring

    def _add_all_event_handlers(self) -> None:
        """eventhandlers.go:249: the store's LIST replayed as ADDs, then its
        handlers."""
        for node in list(self.store.nodes.values()):
            self._on_node_event(ADDED, None, node)
        for pod in list(self.store.pods.values()):
            self._on_pod_event(ADDED, None, pod)
        self.store.add_event_handler("Pod", self._on_pod_event)
        self.store.add_event_handler("Node", self._on_node_event)

    def _on_pod_event(self, event: str, old: Optional[Pod], new: Optional[Pod]) -> None:
        if event == ADDED:
            if new.spec.node_name:
                self._bump_external()  # a pod bound elsewhere
                self.cache.add_pod(new)
                self.queue.assigned_pod_updated_or_added(new)
            elif self._responsible_for(new):
                self.queue.add(new)
        elif event == MODIFIED:
            if new.spec.node_name:
                if old is not None and not old.spec.node_name:
                    if not self.cache.is_assumed(new.key()):
                        # another binder's pod; the confirmation of our own
                        # assume is already in the device carry
                        self._bump_external()
                    self.cache.add_pod(new)  # the binding's confirmation
                else:
                    self._bump_external()
                    self.cache.update_pod(old, new)
                self.queue.assigned_pod_updated_or_added(new)
            elif self._responsible_for(new):
                self.queue.update(old, new)
        elif event == DELETED and old is not None:
            if old.spec.node_name:
                self._bump_external()
                self.cache.remove_pod(old)
                self.queue.move_all_to_active_or_backoff_queue(qevents.POD_DELETE)
            else:
                self.queue.delete(old)

    def _on_node_event(self, event: str, old: Optional[Node], new: Optional[Node]) -> None:
        self._bump_external()  # any node event invalidates the device carry
        if event == ADDED:
            self.cache.add_node(new)
            self.queue.move_all_to_active_or_backoff_queue(qevents.NODE_ADD)
        elif event == MODIFIED:
            self.cache.update_node(new)
            ev = self._node_scheduling_properties_change(old, new)
            if ev is not None:
                self.queue.move_all_to_active_or_backoff_queue(ev)
        elif event == DELETED:
            self.cache.remove_node(old.meta.name)

    @staticmethod
    def _node_scheduling_properties_change(old: Optional[Node],
                                           new: Node) -> Optional[ClusterEvent]:
        """eventhandlers.go:423: the event of a node diff, or None."""
        if old is None:
            return qevents.NODE_ADD
        if old.status.allocatable != new.status.allocatable:
            return qevents.NODE_ALLOCATABLE_CHANGE
        if old.meta.labels != new.meta.labels:
            return qevents.NODE_LABEL_CHANGE
        if old.spec.taints != new.spec.taints or old.spec.unschedulable != new.spec.unschedulable:
            return qevents.NODE_TAINT_CHANGE
        if old.status.ready != new.status.ready:
            return qevents.NODE_CONDITION_CHANGE
        return None

    def _responsible_for(self, pod: Pod) -> bool:
        return pod.spec.scheduler_name == self.profile.name

    def _bump_external(self) -> None:
        with self._ext_mu:
            self._external_events += 1

    def external_change_seq(self) -> int:
        """How many external node-truth changes have arrived: the ring's
        carry gate compares it across a chain. A read racing a bump shows
        the bump at the next check: a conservative break, never a miss."""
        return self._external_events

    # ----------------------------------------------------------- preemption writes

    def _evict(self, victim: Pod, preemptor: Pod) -> None:
        """A victim is deleted from the store: its DELETED event takes it out
        of the cache and wakes the pods its node's capacity may help."""
        self.preempted.setdefault(victim.key(), preemptor.key())
        self.store.delete_pod(victim.key())

    def _clear_nomination(self, pod: Pod) -> None:
        """A higher-priority preemptor took the node ``pod`` was nominated
        to: its nomination is cleared in the store."""
        try:
            self.store.update_pod_nominated_node(pod.key(), "")
        except NotFound:
            pass

    # ----------------------------------------------------------- failures

    def _periodic_housekeeping(self, now: Optional[float] = None) -> None:
        """The reference's tickers, driven from the loop: the assume-expiry
        sweep (1 s, cache.go:731) and the unschedulable-timeout flush (30 s,
        scheduling_queue.go:463)."""
        if now is None:
            now = self.now_fn()
        if now - self._last_cleanup >= 1.0:
            self._last_cleanup = now
            for pod in self.cache.cleanup(now):
                current = self.store.get_pod(pod.key())
                if current is not None and not current.spec.node_name:
                    self.queue.add(current)
        if now - self._last_unsched_flush >= 30.0:
            self._last_unsched_flush = now
            self.queue.flush_unschedulable_left_over()

    def _failure_snapshot(self) -> Snapshot:
        """The snapshot the failure path's PostFilter reads."""
        return self.snapshot

    def _handle_scheduling_failure(self, qp: QueuedPodInfo, unschedulable: bool,
                                   diagnosis: Diagnosis, pod_cycle: int, hints=None) -> None:
        """schedule_one.go:812 and MakeDefaultErrorFunc: a pod that failed a
        filter runs the PostFilter (preemption, with the device screen's
        ``hints``) and its nomination is written to the store; then it
        returns to the queue, unless it was deleted or bound meanwhile. A
        pod turned away by an error (``unschedulable`` False) takes the
        backoff queue."""
        pod = qp.pod
        nominated_node = ""
        if unschedulable:
            self.metrics.inc("unschedulable")
            if diagnosis.node_to_status:
                self.smetrics.preemption_attempts.inc()
                node, _reason = self.profile.preemption.post_filter(pod, hints)
                if node:
                    nominated_node = node
        if nominated_node:
            self.profile.nominator.add_nominated_pod(pod, nominated_node)
            self.nominations.append((pod.key(), nominated_node))
            try:
                self.store.update_pod_nominated_node(pod.key(), nominated_node)
            except NotFound:
                self.profile.nominator.delete_nominated_pod_if_exists(pod)
        current = self.store.get_pod(pod.key())
        if current is None or current.spec.node_name:
            return  # gone, or bound by someone else
        qp.pod = current
        qp.unschedulable_plugins = set(diagnosis.unschedulable_plugins)
        self.queue.add_unschedulable_if_not_present(qp, pod_cycle, error=not unschedulable)

    def num_feasible_nodes_to_find(self, num_all_nodes: int) -> int:
        return num_feasible_nodes_to_find(num_all_nodes, self.percentage_of_nodes_to_score)

    # ----------------------------------------------------------- driving

    def schedule_batch_cycle(self) -> int:
        raise NotImplementedError

    def run_until_settled(self) -> int:
        """Drive ``schedule_batch_cycle`` until the queue settles; returns
        the pods popped. A cycle that neither binds nor parks a pod counts
        toward ``SETTLE_MAX_NO_PROGRESS`` and sleeps ``IDLE_WAIT_S`` times
        its count (at most ten times; ``idle_seconds`` sums the sleeps): a
        cycle whose batch is still in the in-flight ring counts so, as in
        the JAX loop. Past the bound the loop gives up and sets
        ``settle_abandoned``. Pods whose backoff is over are flushed
        to the active queue whenever a cycle pops nothing."""
        cycles = 0
        no_progress = 0
        self.settle_abandoned = False
        while cycles < SETTLE_MAX_CYCLES:
            before_sched = self.metrics["scheduled"]
            before_unsched = self.queue.pending_pods()["unschedulable"]
            n = self.schedule_batch_cycle()
            if n == 0:
                self.queue.flush_backoff_completed()
                if self.queue.pending_pods()["active"] > 0:
                    no_progress += 1
                    if no_progress > SETTLE_MAX_NO_PROGRESS:
                        self._abandon_settle()
                        break
                    continue
                break
            cycles += n
            if (self.metrics["scheduled"] > before_sched
                    or self.queue.pending_pods()["unschedulable"] > before_unsched):
                no_progress = 0
            else:
                no_progress += 1
                if no_progress > SETTLE_MAX_NO_PROGRESS:
                    self._abandon_settle()
                    break
                t = time.perf_counter()
                time.sleep(IDLE_WAIT_S * min(no_progress, 10))
                self.idle_seconds += time.perf_counter() - t
        return cycles

    def _abandon_settle(self) -> None:
        self.settle_abandoned = True
        logging.getLogger(__name__).warning(
            "run_until_settled: no progress after bound; %s pods still pending",
            self.queue.pending_pods())
