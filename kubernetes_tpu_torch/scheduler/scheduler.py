"""The Scheduler: the store, cache and queue wiring around a batched loop
(``kubernetes_tpu/scheduler/scheduler.py:105-1011``; pkg/scheduler/
scheduler.go, eventhandlers.go, schedule_one.go's failure handling).

The store's nodes and pods are replayed as ADDED events, then the store's
handlers feed the cache and the queue (``_add_all_event_handlers``): an
unbound pod of this scheduler joins the queue, a bound one the cache and a
queue move (``assigned_pod_updated_or_added``); a node event updates the
cache and moves the pods the change may help. A failed pod
(``_handle_scheduling_failure``) runs its profile's PostFilter
(DefaultPreemption) when it failed a filter and the profile has one,
persists its nomination in the store, and returns to the queue unless it
is gone or bound meanwhile.

Profiles (``:150-240``, ``:428-432``): ``profiles`` maps each scheduler
name to a ``framework/runtime.py:Framework`` or to its spec
(``plugin_config``, ``plugin_args``, ``registry``), built over one handle
of the scheduler's services; without it the one default profile. The
scheduler is responsible for the pods that name one of its profiles
(``framework_for_pod``); the queue takes the union of the profiles' event
maps and the first profile's QueueSort, a pod's PreEnqueue gate is its own
profile's, and every profile's QuotaAdmission charges one ledger
(``share_ledger``), read through ``_quota_plugin``.
``run_until_settled`` (the reference's ``run_batched_until_settled``,
``:936``, which its ``TPUScheduler.run_until_settled`` calls) drives the
subclass's ``schedule_batch_cycle`` until the queue settles.

Gangs and quota (``:54-94``, ``:184-393``, ``:559-662``): the queue gets
Coscheduling's gang key, QuotaAdmission's PreEnqueue gate and the
namespaces' fair-share weights; a quota release fires the targeted move
of the namespace's gated pods (``_on_quota_release``). A pod that Permit
parks waits in ``waiting_pods`` (assumed, not bound) until its gang's
quorum allows it (``allow_waiting_pod``: it lands then, through the
subclass's ``_bind_stage``) or a rejection or its deadline tears it down
(``reject_waiting_pod``:
Unreserve, the assume forgotten, the failure path; one POD_DELETE move per
teardown, however many members it cascades through). The 1 s sweep
rejects the waiters past their deadline, a gang member's whole gang
first, and runs QuotaAdmission's reclaim pass, whose evictions take whole
gangs (``_quota_evict``, through ``controllers/drain.py``'s
``DrainOrchestrator.evict_pods``: delete, then recreate unbound, then one
EVICTION move and an ``evict_wave`` flight event). The pod events charge a pod observed bound, release a deleted
pod's charge before the POD_DELETE wave, and tell Coscheduling of a
member's deletion; the PodGroup and SchedulingQuota events (and the other
kinds the event map names) move the pods whose plugins registered them.

The ring's commit worker lands batches on a second thread, so the outcome
counters take an atomic ``inc`` (``:91-98``), and every store event that
can change what the device mirrors bumps ``external_change_seq``
(``:141-142``, ``:446-455``): a node event, and a bound pod's add, update
or delete, except the confirmation of this scheduler's own assumed bind.
The ring rides the device carry only while the sequence holds.

The sequential path (``:478-912``) is ``schedule_one_pod``: the PreFilters
(their node restriction kept), the pod's nominated node first, then the
Filters over the snapshot's nodes from ``next_start_node_index`` (which
rotates across pods) until ``num_feasible_nodes_to_find`` nodes fit, the
PreScores and Scores (``framework/runtime.py:ScoreRunner``) when more than
one fits, and ``_select_host``: the highest total, ties broken by the
seeded per-(pod, attempt, node) key of ``ops/tiebreak.py``. The chosen
pod goes through the subclass's bind tail as a one-item call (``_assume``,
then ``_commit_bindings``: Reserve, Permit, PreBind, bind, PostBind). A pod
no node fits fails with its Diagnosis (the first failing filter per node,
and which of those statuses are unresolvable); an error fails it to the
backoff queue. It reads the snapshot the failure path reads (the commit
worker's own, with the worker).

Extenders (``:116-123``, ``:693-703``, ``:735-746``, ``:808-840``;
``scheduler/extender.py``): ``extenders`` (built by ``config/factory.py``
from the config's list) are called by the sequential path as the JAX
``Scheduler`` calls them. Filter runs after the plugins' Filters, over the
nodes that passed them, each interested extender in turn
(``_find_nodes_that_pass_extenders``): the nodes it fails go into the
Diagnosis (those it calls unresolvable are kept out of preemption); an
``ExtenderError`` of an ignorable extender skips it, of any other fails
the cycle to the backoff queue. The nominated-node fast path returns before
them. Prioritize adds each interested extender's score times its weight to
the plugins' totals when more than one node is feasible; its errors are
ignored. Bind goes through the first interested binder extender, before
the Bind plugins (``_binder_extender_for``, ``_extender_bind``; the
subclass's ``_bind_stage`` calls them for every pod, batch or sequential).
DefaultPreemption gets the list through the handle. A pod that rides the
batch meets no extender's Filter or Prioritize, as in the JAX loop
(ROADMAP C22).

Observability (``:472``, ``:547-715``, ``:910``): ``schedule_pod`` runs
in a ``scheduling.cycle`` span (``pod``) with a ``Trace`` of its steps
(logged past ``trace_threshold_s``); the framework's points open their
spans under it (``framework/runtime.py``). The latency ledger
(``metrics/latency_ledger.py``) parks a pod Permit holds in
``gang.permit_park``, moves a pod Permit allows to ``commit.host`` and
closes a pod found deleted or bound by someone else at its failure
(``close_skipped``); the bind tail's ``bind`` and the close at bind are the
subclass's. The attempt whose count is 1 modulo
``PLUGIN_METRICS_SAMPLE_PERIOD`` records its per-plugin durations.

Left out: the per-pod cycle ``schedule_one`` (the loop hands pods to
``schedule_one_pod``).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..api.types import Node, Pod
from ..apiserver.store import ADDED, DELETED, MODIFIED, NotFound, Store
from ..cache.cache import Cache
from ..cache.snapshot import Snapshot
from ..framework.plugins import names
from ..framework.plugins.coscheduling import pod_group_key
from ..framework.runtime import (DEFAULT_SCHEDULER_NAME, Framework, PreFilterState,
                                 sampled_attempt)
from ..framework.types import ALL, WILDCARD, ClusterEvent, Diagnosis, NodeInfo, QueuedPodInfo
from ..metrics import latency_ledger
from ..metrics.scheduler_metrics import ERROR, UNSCHEDULABLE, SchedulerMetrics
from ..ops.tiebreak import name_hash, pod_seed, tie_key
from ..queue import events as qevents
from ..queue.scheduling_queue import SchedulingQueue
from ..utils import tracing
from ..utils.trace import Trace
from .extender import ExtenderError

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


@dataclasses.dataclass
class WaitingPod:
    """One pod parked at Permit (runtime/waiting_pods_map.go) by
    Coscheduling, the one plugin that votes WAIT: assumed on
    ``node_name``; ``t0`` is its batch's pop time, ``deadline`` when the
    sweep rejects it, ``state`` its PreFilter state (for its Unreserve)."""

    pod: Pod
    node_name: str
    pod_cycle: int
    t0: float
    deadline: float
    state: Optional[PreFilterState] = None
    sampled: bool = False  # its attempt records the per-plugin durations


@dataclasses.dataclass
class BindItem:
    """A placed pod entering the bind tail, with its profile's framework:
    ``assumed`` is its clone in the cache, once assumed; ``state`` its
    PreFilter state, which the Reserve, Unreserve and PreBind of
    VolumeBinding and DynamicResources read (None for a plain pod of a
    batch, whose PreFilters did not run)."""

    qp: QueuedPodInfo
    node_name: str
    fwk: Framework
    assumed: Optional[Pod] = None
    state: Optional[PreFilterState] = None
    device: bool = True  # the device committed the placement (not the sequential path)
    sampled: bool = False  # its attempt records the per-plugin durations


class FitError(Exception):
    """No node fits the pod (framework/types.go FitError). ``state`` is
    what the cycle's PreFilters left for PostFilter: their state, or the
    first PreFilter's ``Fail``; None when they did not run."""

    def __init__(self, diagnosis: Diagnosis, state=None):
        super().__init__("no node fits the pod")
        self.diagnosis = diagnosis
        self.state = state


class WaitingPods:
    """The handle Permit plugins release or reject parked pods through
    (Handle.IterateOverWaitingPods / GetWaitingPod)."""

    def __init__(self, sched: "Scheduler"):
        self._sched = sched

    def iterate(self) -> List[Tuple[str, Pod]]:
        return [(k, wp.pod) for k, wp in self._sched.waiting_pods.items()]

    def allow(self, pod_key: str) -> bool:
        return self._sched.allow_waiting_pod(pod_key)

    def reject(self, pod_key: str, plugins: Tuple[str, ...]) -> bool:
        return self._sched.reject_waiting_pod(pod_key, plugins)


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
    def __init__(self, store: Store, profiles: Optional[Dict[str, object]] = None,
                 percentage_of_nodes_to_score: int = 0, pod_initial_backoff: float = 1.0,
                 pod_max_backoff: float = 10.0, now_fn=time.monotonic, extenders=None):
        self.store = store
        self.extenders = list(extenders or [])
        self.now_fn = now_fn
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.trace_threshold_s = 0.1  # LogIfLong(100ms), schedule_one.go:313
        self.next_start_node_index = 0  # the sequential path's rotating start
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
        self.waiting_pods: Dict[str, WaitingPod] = {}
        self._reject_depth = 0  # reject_waiting_pod's nesting: the outermost moves
        # the services every profile's plugins are built over (the handle)
        handle_base = {
            "snapshot_fn": lambda: self._failure_snapshot().list(),
            "ns_labels_fn": store.ns_labels,
            "client": store,
            "metrics": self.smetrics,
            "now_fn": now_fn,
            "waiting_pods": WaitingPods(self),
            "bound_pods_fn": self._bound_pods,
            "evict": self._evict,
            "clear_nomination": self._clear_nomination,
            "extenders": self.extenders,
        }
        self.profiles: Dict[str, Framework] = {}
        for name, spec in (profiles or {DEFAULT_SCHEDULER_NAME: {}}).items():
            if isinstance(spec, Framework):
                self.profiles[name] = spec
                continue
            self.profiles[name] = Framework(dict(handle_base),
                                            plugin_config=spec.get("plugin_config"),
                                            plugin_args=spec.get("plugin_args"),
                                            registry=spec.get("registry"), profile_name=name)
        event_map: Dict[ClusterEvent, set] = {}
        for fwk in self.profiles.values():
            for ev, plugins in fwk.cluster_event_map().items():
                event_map.setdefault(ev, set()).update(plugins)
        self.event_map = event_map
        # one quota ledger for every profile: Reserve charges land in the
        # pod's own profile's instance, release and fair share read any
        self._quota = None  # the first profile's QuotaAdmission that has one
        self._reclaim_drainer = None  # the reclaim pass's DrainOrchestrator, built on use
        for fwk in self.profiles.values():
            quota = fwk.plugin(names.QUOTA_ADMISSION)
            if quota is None:
                continue
            quota.on_release = self._on_quota_release
            quota.on_evict = self._quota_evict
            if self._quota is None:
                self._quota = quota
            else:
                quota.share_ledger(self._quota)
        # profile name -> its QuotaAdmission, else the shared one
        self._quota_of = {name: fwk.plugin(names.QUOTA_ADMISSION) or self._quota
                          for name, fwk in self.profiles.items()}
        first = next(iter(self.profiles.values()))
        # one profile's PreEnqueue serves every pod the queue takes
        gate = first.pre_enqueue if len(self.profiles) == 1 else self._pre_enqueue_gate
        self.queue = SchedulingQueue(
            less_key=first.queue_sort_key(), cluster_event_map=event_map, now_fn=now_fn,
            gang_key_fn=pod_group_key, pre_enqueue_fn=gate,
            ns_weight_fn=self._quota.weight_for if self._quota is not None else None,
            initial_backoff=pod_initial_backoff, max_backoff=pod_max_backoff)
        self._add_all_event_handlers()

    def _bound_pods(self):
        return (p for p in self.store.pods.values() if p.spec.node_name)

    def framework_for_pod(self, pod: Pod) -> Framework:
        return self.profiles[pod.spec.scheduler_name]

    # ----------------------------------------------------------- quota admission

    def _quota_plugin(self, pod: Optional[Pod] = None):
        """The pod's profile's QuotaAdmission, else any profile's (the
        ledger is one), else None."""
        if pod is None:
            return self._quota
        return self._quota_of.get(pod.spec.scheduler_name, self._quota)

    def _ns_fair_weight(self, ns: str) -> Optional[float]:
        """The namespace's fair-share weight, None for a namespace that is
        no quota tenant (``:242``): the queue's ``ns_weight_fn`` and the
        latency ledger's ``tenant_fn``."""
        quota = self._quota_plugin()
        return quota.weight_for(ns) if quota is not None else None

    def _pre_enqueue_gate(self, pod: Pod):
        """The queue's admission gate: the pod's profile's PreEnqueue."""
        fwk = self.profiles.get(pod.spec.scheduler_name)
        return fwk.pre_enqueue(pod) if fwk is not None else None

    def _on_quota_release(self, ns: str) -> int:
        """The targeted release move: the namespace's gated pods that the
        freed headroom admits, one freed slot per pod."""
        quota = self._quota_plugin()
        if quota is None:
            return 0
        return self.queue.move_gated_pods(namespace=ns, plugin=names.QUOTA_ADMISSION,
                                          admit_fn=quota.shadow_admitter(ns))

    def _quota_evict(self, pods: List[Pod], reason: str) -> int:
        """The reclaim pass's eviction (``:271-282``): whole gangs through
        the drain orchestrator, built on the first reclaim (delete, then
        create unbound, then one EVICTION move and an ``evict_wave``
        event). Returns the pods evicted."""
        orch = self._reclaim_drainer
        if orch is None:
            from ..controllers.drain import DrainOrchestrator

            orch = DrainOrchestrator(self.store, metrics=self.smetrics, queue=self.queue,
                                     now_fn=self.now_fn)
            self._reclaim_drainer = orch
        return orch.evict_pods(pods, reason=reason)

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
        self._add_dynamic_event_handlers()

    def _add_dynamic_event_handlers(self) -> None:
        """eventhandlers.go:249's dynamic arm (``:316-338``): every other
        kind the event map names gets a handler that moves the pods whose
        failed plugins registered it."""
        wanted = {ev.resource for ev in self.event_map
                  if ev.resource not in ("Pod", "Node", WILDCARD)}
        for resource in sorted(wanted):
            def handler(event, old, new, _res=resource):
                self.queue.move_all_to_active_or_backoff_queue(ClusterEvent(_res, ALL))
            self.store.add_event_handler(resource, handler)

    def _on_pod_event(self, event: str, old: Optional[Pod], new: Optional[Pod]) -> None:
        if event == ADDED:
            if new.spec.node_name:
                self._bump_external()  # a pod bound elsewhere
                self.cache.add_pod(new)
                quota = self._quota_of.get(new.spec.scheduler_name, self._quota)
                if quota is not None:
                    quota.pod_observed_bound(new)
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
                    quota = self._quota_of.get(new.spec.scheduler_name, self._quota)
                    if quota is not None:
                        quota.pod_observed_bound(new)
                else:
                    self._bump_external()
                    self.cache.update_pod(old, new)
                self.queue.assigned_pod_updated_or_added(new)
            elif self._responsible_for(new):
                self.queue.update(old, new)
        elif event == DELETED and old is not None:
            # the quota release first: the POD_DELETE wave below must
            # re-gate against the freed headroom
            quota = self._quota_plugin(old)
            if quota is not None:
                quota.pod_deleted(old)
            if old.spec.node_name:
                self._bump_external()
                self.cache.remove_pod(old)
                self.queue.move_all_to_active_or_backoff_queue(qevents.POD_DELETE)
            else:
                self.queue.delete(old)
            if pod_group_key(old) is not None and self._responsible_for(old):
                cos = self.framework_for_pod(old).plugin(names.COSCHEDULING)
                if cos is not None:
                    cos.pod_deleted(old)

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
        return pod.spec.scheduler_name in self.profiles

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

    # ----------------------------------------------------------- Permit

    def park(self, item: BindItem, pod_cycle: int, t0: float, timeout: float) -> None:
        """Permit voted WAIT: the assumed pod waits until ``timeout`` from
        now for its gang's quorum."""
        self.waiting_pods[item.assumed.key()] = WaitingPod(
            item.assumed, item.node_name, pod_cycle, t0, self.now_fn() + timeout, item.state,
            item.sampled)
        latency_ledger.transition(item.assumed.key(), "gang.permit_park",
                                  namespace=item.assumed.meta.namespace, create=False)

    def allow_waiting_pod(self, pod_key: str) -> bool:
        """Permit allowed a parked pod: it lands now, through the bind
        tail's bind, finish and PostBind stage."""
        wp = self.waiting_pods.pop(pod_key, None)
        if wp is None:
            return False
        latency_ledger.transition(pod_key, "commit.host", namespace=wp.pod.meta.namespace,
                                  create=False)
        self._bind_stage([BindItem(QueuedPodInfo(pod=wp.pod), wp.node_name,
                                   self.framework_for_pod(wp.pod), wp.pod, wp.state,
                                   sampled=wp.sampled)],
                         wp.pod_cycle, wp.t0, per_pod=True)
        return True

    def reject_waiting_pod(self, pod_key: str, plugins: Tuple[str, ...]) -> bool:
        """A parked pod is rejected: Unreserve (a gang member's cascades to
        its parked siblings), the assume forgotten, the failure path with
        ``plugins`` attributed; the outermost rejection of a cascade fires
        one POD_DELETE move for the capacity the forgets freed."""
        wp = self.waiting_pods.pop(pod_key, None)
        if wp is None:
            return False
        self._reject_depth += 1
        try:
            self.framework_for_pod(wp.pod).unreserve(wp.state, wp.pod, wp.node_name)
            self.cache.forget_pod(wp.pod)
            diagnosis = Diagnosis(unschedulable_plugins={p for p in plugins if p})
            self._handle_scheduling_failure(QueuedPodInfo(pod=wp.pod), True, diagnosis,
                                            wp.pod_cycle)
            self.smetrics.observe_attempt(UNSCHEDULABLE, wp.pod.spec.scheduler_name,
                                          self.now_fn() - wp.t0)
        finally:
            self._reject_depth -= 1
        if self._reject_depth == 0:
            self.queue.move_all_to_active_or_backoff_queue(qevents.POD_DELETE)
        return True

    def _sweep_expired_waiting_pods(self, now: float) -> None:
        """The Permit timeout: a parked pod past its deadline is rejected,
        a gang member's whole gang first."""
        expired = [(k, wp) for k, wp in self.waiting_pods.items() if now >= wp.deadline]
        for key, wp in expired:
            if key not in self.waiting_pods:
                continue  # a gang's cascade rejected it already
            gkey = pod_group_key(wp.pod)
            cos = self.framework_for_pod(wp.pod).plugin(names.COSCHEDULING)
            if gkey is not None and cos is not None:
                cos.reject_gang(gkey, "timeout")
            if key in self.waiting_pods:
                self.reject_waiting_pod(key, ("Coscheduling",))

    def _periodic_housekeeping(self, now: Optional[float] = None) -> None:
        """The reference's tickers, driven from the loop: the 1 s sweep
        (Permit timeouts, assume expiry, cache.go:731, and the quota
        reclaim pass) and the unschedulable-timeout flush (30 s,
        scheduling_queue.go:463)."""
        if now is None:
            now = self.now_fn()
        if now - self._last_cleanup >= 1.0:
            self._last_cleanup = now
            self._sweep_expired_waiting_pods(now)
            for pod in self.cache.cleanup(now):
                current = self.store.get_pod(pod.key())
                if current is not None and not current.spec.node_name:
                    self.queue.add(current)
            quota = self._quota_plugin()
            if quota is not None:
                quota.run_reclaim(now)
        if now - self._last_unsched_flush >= 30.0:
            self._last_unsched_flush = now
            self.queue.flush_unschedulable_left_over()

    def _failure_snapshot(self) -> Snapshot:
        """The snapshot the failure path's PostFilter reads."""
        return self.snapshot

    def _handle_scheduling_failure(self, qp: QueuedPodInfo, unschedulable: bool,
                                   diagnosis: Diagnosis, pod_cycle: int, hints=None,
                                   state=None) -> None:
        """schedule_one.go:812 and MakeDefaultErrorFunc: a pod that failed a
        filter runs the PostFilter (preemption, with the device screen's
        ``hints``, and the sequential cycle's PreFilter ``state``, as
        ``FitError.state``: a batch pod's PreFilters did not run, so
        PostFilter runs them) and its nomination is written to the store;
        then it returns to the queue, unless it was deleted or bound
        meanwhile. A pod turned away by an error (``unschedulable`` False)
        takes the backoff queue."""
        pod = qp.pod
        fwk = self.framework_for_pod(pod)
        nominated_node = ""
        if unschedulable:
            self.metrics.inc("unschedulable")
            if diagnosis.node_to_status and fwk.points.get("post_filter"):
                self.smetrics.preemption_attempts.inc()
                node, _reason = fwk.post_filter(pod, hints, diagnosis.unresolvable, state)
                if node:
                    nominated_node = node
        if nominated_node:
            fwk.nominator.add_nominated_pod(pod, nominated_node)
            self.nominations.append((pod.key(), nominated_node))
            try:
                self.store.update_pod_nominated_node(pod.key(), nominated_node)
            except NotFound:
                fwk.nominator.delete_nominated_pod_if_exists(pod)
        current = self.store.get_pod(pod.key())
        if current is None or current.spec.node_name:
            # gone, or bound by someone else: the ledger entry must not linger
            latency_ledger.close_skipped(pod.key(), current)
            return
        qp.pod = current
        qp.unschedulable_plugins = set(diagnosis.unschedulable_plugins)
        self.queue.add_unschedulable_if_not_present(qp, pod_cycle, error=not unschedulable)

    def num_feasible_nodes_to_find(self, num_all_nodes: int) -> int:
        return num_feasible_nodes_to_find(num_all_nodes, self.percentage_of_nodes_to_score)

    # ----------------------------------------------------------- the sequential path

    def schedule_one(self) -> bool:
        """One sequential cycle of the queue's next pod (``:459-476``):
        housekeeping, the pop, then ``schedule_one_pod``; a pod deleted or
        bound meanwhile is skipped. Returns False when the active queue is
        empty."""
        self._periodic_housekeeping()
        qp = self.queue.pop()
        if qp is None:
            return False
        pod = self.store.get_pod(qp.pod.key())
        if pod is None or pod.spec.node_name or not self._responsible_for(pod):
            latency_ledger.close_skipped(qp.pod.key(), pod)
            return True
        qp.pod = pod
        self.schedule_one_pod(qp, self.queue.scheduling_cycle)
        return True

    def schedule_one_pod(self, qp: QueuedPodInfo, pod_cycle: int) -> None:
        """One pod through the sequential cycle (``:478``): find its node,
        then the bind tail as a one-item call; a pod no node fits takes the
        failure path with its Diagnosis, an error the backoff queue."""
        pod = qp.pod
        self.metrics.inc("schedule_attempts")
        sampled = sampled_attempt(self.metrics["schedule_attempts"])
        t0 = self.now_fn()
        try:
            node_name, state = self.schedule_pod(pod, qp.attempts, sampled)
        except FitError as err:
            self.smetrics.observe_attempt(UNSCHEDULABLE, pod.spec.scheduler_name,
                                          self.now_fn() - t0)
            self._handle_scheduling_failure(qp, True, err.diagnosis, pod_cycle,
                                            state=err.state)
            return
        except Exception:  # noqa: BLE001 - a cycle error requeues the pod
            logging.getLogger(__name__).exception("scheduling %s failed", pod.key())
            self.metrics.inc("errors")
            self.smetrics.observe_attempt(ERROR, pod.spec.scheduler_name, self.now_fn() - t0)
            self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
            return
        item = BindItem(qp, node_name, self.framework_for_pod(pod), state=state, device=False,
                        sampled=sampled)
        if self._assume(item, pod_cycle):
            self._commit_bindings([item], pod_cycle, t0, per_pod=True)

    def schedule_pod(self, pod: Pod, attempts: int,
                     sampled: bool = False) -> Tuple[str, PreFilterState]:
        """(``:705``) the chosen node and the pod's PreFilter state, or
        FitError; in a ``scheduling.cycle`` span, with a ``Trace``."""
        with tracing.span("scheduling.cycle", pod=pod.key()):
            return self._schedule_pod_traced(pod, attempts, sampled)

    def _schedule_pod_traced(self, pod: Pod, attempts: int,
                             sampled: bool) -> Tuple[str, PreFilterState]:
        trace = Trace("Scheduling", now_fn=self.now_fn, pod=pod.key())
        snap = self._failure_snapshot()
        self.cache.update_snapshot(snap)
        trace.step("Snapshotting scheduler cache and node infos done")
        all_nodes = snap.list()
        if not all_nodes:
            raise FitError(Diagnosis())
        feasible, diagnosis, state = self.find_nodes_that_fit_pod(pod, all_nodes, sampled)
        trace.step("Computing predicates done")
        if not feasible:
            trace.log_if_long(self.trace_threshold_s)
            raise FitError(diagnosis, state)
        if len(feasible) == 1:
            trace.log_if_long(self.trace_threshold_s)
            return feasible[0].node.meta.name, state
        totals = self.framework_for_pod(pod).scores.score(pod, feasible, state)
        trace.step("Prioritizing done")
        trace.log_if_long(self.trace_threshold_s)
        if self.extenders:
            # prioritizeNodes (:662-691): each extender's raw score times its
            # weight onto the plugins' totals; its errors are ignored
            nodes = [ni.node for ni in feasible]
            for ext in self.extenders:
                if not ext.is_interested(pod):
                    continue
                try:
                    prios = ext.prioritize(pod, nodes)
                except Exception:  # noqa: BLE001 - ignored, as in JAX (:673)
                    continue
                for name, score in prios.items():
                    if name in totals:
                        totals[name] += score * ext.weight()
        return self._select_host(totals, pod, attempts), state

    def find_nodes_that_fit_pod(self, pod: Pod, all_nodes: List[NodeInfo], sampled: bool = False
                                ) -> Tuple[List[NodeInfo], Diagnosis, Optional[PreFilterState]]:
        """(``:751``) the PreFilters, then the nodes they leave: the pod's
        nominated node alone when it fits, else from the rotating start
        until ``num_feasible_nodes_to_find`` nodes fit. A PreFilter failure
        gives every node its status. The Filter point's duration is
        observed once, over the node walk after the PreFilters."""
        diagnosis = Diagnosis()
        fwk = self.framework_for_pod(pod)
        filters = fwk.filters
        state, names, fail = filters.pre_filter_status(pod, sampled=sampled)
        if fail is not None:
            diagnosis.unschedulable_plugins.add(fail.plugin)
            for ni in all_nodes:
                diagnosis.node_to_status[ni.node.meta.name] = fail.reason
                if fail.unresolvable:
                    diagnosis.unresolvable.add(ni.node.meta.name)
            raise FitError(diagnosis, fail)
        t_filter = time.perf_counter()
        status = "Error"  # unless the walk returns
        try:
            feasible = self._filter_nodes(pod, all_nodes, names, state, diagnosis)
            status = "Success" if feasible else "Unschedulable"
            return feasible, diagnosis, state
        finally:
            self.smetrics.framework_extension_point_duration.observe(
                time.perf_counter() - t_filter, "filter", status, fwk.profile_name)

    def _filter_nodes(self, pod: Pod, all_nodes: List[NodeInfo], names: Optional[Set[str]],
                      state: PreFilterState, diagnosis: Diagnosis) -> List[NodeInfo]:
        filters = self.framework_for_pod(pod).filters
        nodes = all_nodes
        if names is not None:
            nodes = [ni for ni in all_nodes if ni.node.meta.name in names]
        nominated = pod.status.nominated_node_name
        if nominated:
            ni = next((n for n in nodes if n.node.meta.name == nominated), None)
            if ni is not None and filters.filter_with_nominated_pods_status(
                    state, pod, ni) is None:
                return [ni]
        num_to_find = self.num_feasible_nodes_to_find(len(nodes))
        feasible: List[NodeInfo] = []
        checked = 0
        start = self.next_start_node_index % len(nodes) if nodes else 0
        for i in range(len(nodes)):
            ni = nodes[(start + i) % len(nodes)]
            checked += 1
            fail = filters.filter_with_nominated_pods_status(state, pod, ni)
            if fail is None:
                feasible.append(ni)
                if len(feasible) >= num_to_find:
                    break
                continue
            name = ni.node.meta.name
            diagnosis.node_to_status[name] = fail.reason
            diagnosis.unschedulable_plugins.add(fail.plugin)
            if fail.unresolvable:
                diagnosis.unresolvable.add(name)
        self.next_start_node_index = (start + checked) % len(nodes) if nodes else 0
        if feasible and self.extenders:
            feasible = self._find_nodes_that_pass_extenders(pod, feasible, diagnosis)
        return feasible

    def _find_nodes_that_pass_extenders(self, pod: Pod, feasible: List[NodeInfo],
                                        diagnosis: Diagnosis) -> List[NodeInfo]:
        """(``:817``; schedule_one.go:547) each interested extender's Filter
        over the nodes left; a failed node's reason goes into the
        Diagnosis, an unresolvable one's too, kept out of preemption. An
        ``ExtenderError`` of an ignorable extender skips it; any other error
        is raised (the cycle fails)."""
        by_name = {ni.node.meta.name: ni for ni in feasible}
        nodes = [ni.node for ni in feasible]
        for ext in self.extenders:
            if not nodes:
                break
            if not ext.is_interested(pod):
                continue
            try:
                nodes, failed, unresolvable = ext.filter(pod, nodes)
            except ExtenderError:
                if ext.is_ignorable():
                    continue
                raise
            for name, reason in failed.items():
                diagnosis.node_to_status[name] = reason
                diagnosis.unresolvable.discard(name)
            for name, reason in unresolvable.items():
                diagnosis.node_to_status[name] = reason
                diagnosis.unresolvable.add(name)
        return [by_name[n.meta.name] for n in nodes]

    def _binder_extender_for(self, pod: Pod):
        """The first binder extender interested in the pod
        (``commit_plane.py:132-136``), or None."""
        for ext in self.extenders:
            if ext.is_binder() and ext.is_interested(pod):
                return ext
        return None

    @staticmethod
    def _extender_bind(ext, pod: Pod, node_name: str) -> Optional[str]:
        """(``:693-703``; schedule_one.go:774) bind through the extender:
        None, or the failure's reason."""
        try:
            ext.bind(pod, node_name)
        except Exception as err:  # noqa: BLE001 - a failed bind fails the pod
            return f"extender bind: {err}"
        return None

    @staticmethod
    def _select_host(totals: Dict[str, int], pod: Pod, attempts: int) -> str:
        """(``:846``) the highest total; a tie goes to the larger seeded
        per-(pod, attempt, node) key, the key the batch program's jitter
        uses."""
        seed = pod_seed(pod.key(), attempts)
        best = None
        for name, score in totals.items():
            key = (score, tie_key(seed, name_hash(name)))
            if best is None or key > best[0]:
                best = (key, name)
        return best[1]

    def _assume(self, item: BindItem, pod_cycle: int) -> bool:
        """Assume the pod on its node (the subclass's); False when the
        assume failed and the pod took the failure path."""
        raise NotImplementedError

    def _commit_bindings(self, items: List[BindItem], pod_cycle: int, t0: float,
                         per_pod: bool = False) -> int:
        """The bind tail after the assume (the subclass's); returns the pods
        bound or parked at Permit. ``per_pod``: one pod of the sequential
        path."""
        raise NotImplementedError

    # ----------------------------------------------------------- driving

    def schedule_batch_cycle(self) -> int:
        raise NotImplementedError

    def _bind_stage(self, items: List[BindItem], pod_cycle: int, t0: float,
                    per_pod: bool = False) -> int:
        """The bind tail's bind, finish and PostBind stage (the subclass's);
        returns the pods bound. ``per_pod``: one pod of the sequential path
        or one Permit allowed."""
        raise NotImplementedError

    def run_until_settled(self) -> int:
        """Drive ``schedule_batch_cycle`` until the queue settles; returns
        the pods popped. A cycle that neither binds nor parks a pod (in the
        unschedulable map, gated or not) counts
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
            before = self.queue.pending_pods()
            before_unsched = before["unschedulable"] + before["gated"]
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
            pending = self.queue.pending_pods()
            if (self.metrics["scheduled"] > before_sched
                    or pending["unschedulable"] + pending["gated"] > before_unsched):
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
