"""A small in-memory object store: the scheduler loop's cluster state and
the objects of the DRA, volume, gang and quota paths.

The part of ``kubernetes_tpu/apiserver/store.py``'s ``ClusterStore`` that
the port reads and writes. Nodes and pods, with the watch handlers the
scheduler loop registers (``add_event_handler(kind, fn)``, called as
``fn(event, old, new)`` with
ADDED, MODIFIED or DELETED, synchronously and in write order), the binding
subresource (``bind`` / ``bind_batch``: set ``spec.node_name`` on a copy of
an unbound pod) and the nomination write; namespaces, whose labels
affinity terms' namespaceSelector reads. Creation timestamps come from the
store's ``now_fn``. Then what the claim and volume screens and their
commit-time checks read and write:
ResourceClass, ResourceClaim, PodSchedulingContext, PodGroup,
SchedulingQuota and the owners SelectorSpread reads (Service,
ReplicationController, ReplicaSet, StatefulSet) through ``create_object`` / ``get_object`` /
``update_object`` / ``delete_object`` (the Coscheduling plugin's status
writes, DynamicResources' PostBind), the storage kinds through their own
accessors, the claim allocation writes of the DynamicResources Reserve and
the PV bind of VolumeBinding's PreBind (``bind_pv``), and the
PodDisruptionBudgets that preemption reads. Every write bumps
the object's ``resource_version`` from one store-wide counter, as the JAX
store does (the volume screen caches by it), and ``kind_version`` gives
the counter of a generic kind's last write (the quota ledger rebuilds its
index when SchedulingQuota's moves).

The watch surface of ``:54-105``, ``:181-230`` and ``:315-346``: every
write that fires handlers also appends to a bounded journal (4096
events; ``WatchEvent.seq`` from a counter of its own, the LIST/WATCH
resourceVersion) and pushes to the live ``Watch``es of its kind, in
write order, beside the synchronous handlers. ``list_objects(kind)``
returns a kind's objects and the journal's sequence, ``watch(kind,
since)`` the events after ``since`` (``Expired`` when the journal no
longer covers it: the reflector relists), ``snapshot_map`` a copy of a
kind's map. One lock covers each write with its journal entry and the
reads of the watch surface, because a ``client/reflector.py`` thread
reads them; the handlers run outside it. Leases (``get_lease``,
``create_lease``, ``update_lease(expect_rv)``) are the leader-election
lock, Secrets, Events and ResourceClaimTemplates generic kinds.

The controller manager's kinds (``:347-400``): Deployment, DaemonSet, Job,
CronJob, Endpoints, EndpointSlice, VolumeAttachment, ConfigMap,
CertificateSigningRequest, HorizontalPodAutoscaler, ClusterRole and
ClusterRoleBinding are generic kinds; ReplicaSet, StatefulSet,
ReplicationController and Service also have the JAX accessors
(``create_replica_set``, ``get_replica_set``, ..., ``:609-650``), which
write without the duplicate check. ``pod_metrics`` (pod key to milli-cpu
usage) stands in for the metrics API the HPA controller reads.

Finalizers (``update_object`` / ``delete_object``, ``:664-729``): deleting
an object that has finalizers only marks it terminating
(``deletion_timestamp`` from ``now_fn``, a MODIFIED event); an update
keeps the stored ``deletion_timestamp`` (but a Namespace's, which its
controller sets), and the update that clears the last finalizer of a
terminating object completes the delete (a DELETED event).

Admission and validation (``:187-248``, ``:405-452``, ``:643-662``,
``:822-836``): ``create_node``, ``create_pod``, ``create_object``,
``create_pv`` and ``create_pvc`` run the admission chain
(``apiserver/admission.py:AdmissionChain``, ``default_chain()``) and then
the field validation (``api/validation.py``) before the write, and the
updates of nodes, pods and generic objects their update halves. The chain
mutates the object it is given, so the handlers see the admitted one. A
pod's quota charge (``AdmissionChain.charge``) runs after the duplicate-key
check and is undone when the insert fails. ``admission = None`` and
``validation_enabled = False`` switch them off, as on the JAX store. The
store holds the kinds the chain reads: PriorityClass, ResourceQuota,
LimitRange, ServiceAccount and RuntimeClass (the last four through
``create_object``). The generic
kinds, the storage kinds and the claim writes fire their handlers too, in
write order, where the JAX store sends its events (the scheduler loop's
PodGroup, SchedulingQuota, claim and volume moves).

The API front's seams (``:192-224``, ``:252-300``, ``:343-400``,
``:505-534``, ``:580-660``), for ``apiserver/http.py`` and
``apiserver/wal.py``: ``_journal_event`` also hands every journaled write to
an attached write-ahead log (``_wal``; ``bind_batch`` parks a batch's
records and appends them as one group-commit line); ``_guarded_update``
admits an update outside the lock and commits it only while the stored
object is still the one admitted against (else it admits again); the
request's identity per thread (``request_user``, ``request_groups``,
``set_request_user``, ``as_user``; in-process writes are
``system:admin``), which NodeRestriction and the owner-reference and
certificate plugins read with ``authorizer`` (set by ``serve_api``);
``KINDS`` and ``_kind_maps`` in the JAX order (a WAL snapshot's order); the
CRD and APIService registry (``create_crd``, which serves a new kind
through the generic verbs, ``crd_for_plural``, ``api_service_for``,
``is_cluster_scoped``) and the admission webhooks' and Ingress kinds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from ..api import validation
from ..api.types import (CSINode, Event, Lease, LimitRange, Namespace, Node, PersistentVolume,
                         PersistentVolumeClaim, Pod, PodDisruptionBudget, PodGroup,
                         PodSchedulingContext, PriorityClass, ReplicaSet, ReplicationController,
                         ResourceClaim, ResourceClaimTemplate, ResourceQuota, RuntimeClass,
                         SchedulingQuota, Secret, Service, ServiceAccount, StatefulSet,
                         StorageClass)
from .admission import AdmissionChain

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

Handler = Callable[[str, Optional[object], Optional[object]], None]


class Conflict(Exception):
    """409: the object exists, or a claim is allocated to another node."""


class NotFound(Exception):
    """404."""


class Expired(Exception):
    """410 Gone: the watch's resourceVersion fell off the journal; the
    client relists."""


@dataclasses.dataclass
class WatchEvent:
    """One event of a Watch (apimachinery pkg/watch/watch.go:29)."""

    seq: int
    type: str  # ADDED | MODIFIED | DELETED
    object: object
    old: Optional[object] = None


class Watch:
    """A watch channel: a thread-safe event queue and ``stop``."""

    def __init__(self, kind: str, store: "Store"):
        self.kind = kind
        self._store = store
        self._events: Deque[WatchEvent] = deque()
        self._cond = threading.Condition()
        self.stopped = False

    def _push(self, ev: WatchEvent) -> None:
        with self._cond:
            if self.stopped:
                return
            self._events.append(ev)
            self._cond.notify_all()

    def next(self, timeout: float = 0.0) -> Optional[WatchEvent]:
        """The next event, or None after ``timeout`` (at once when 0)."""
        with self._cond:
            if not self._events and timeout > 0:
                self._cond.wait(timeout)
            return self._events.popleft() if self._events else None

    def drain(self) -> List[WatchEvent]:
        with self._cond:
            out = list(self._events)
            self._events.clear()
            return out

    def stop(self) -> None:
        with self._cond:
            self.stopped = True
            self._cond.notify_all()
        self._store._stop_watch(self)


# the kinds keyed by bare name (``ClusterStore.CLUSTER_SCOPED_KINDS``, ``:582-588``);
# every other kind by namespace/name
CLUSTER_SCOPED_KINDS = frozenset((
    "Node", "Namespace", "PersistentVolume", "StorageClass", "CSINode", "PriorityClass",
    "VolumeAttachment", "MutatingWebhookConfiguration", "ValidatingWebhookConfiguration",
    "ClusterRole", "ClusterRoleBinding", "CertificateSigningRequest", "RuntimeClass",
    "IngressClass", "ResourceClass"))
JOURNAL_CAPACITY = 4096


class Store:
    CLUSTER_SCOPED_KINDS = CLUSTER_SCOPED_KINDS

    def __init__(self, now_fn=time.time):
        self.now_fn = now_fn
        self._rv = 0
        self._kind_rv: Dict[str, int] = {}
        self._handlers: Dict[str, List[Handler]] = {}
        self.nodes: Dict[str, Node] = {}                        # by name
        self.pods: Dict[str, Pod] = {}                          # by namespace/name
        self.namespaces: Dict[str, Namespace] = {}              # by name
        self.pvs: Dict[str, PersistentVolume] = {}              # by name
        self.pvcs: Dict[str, PersistentVolumeClaim] = {}        # by namespace/name
        self.storage_classes: Dict[str, StorageClass] = {}
        self.csinodes: Dict[str, CSINode] = {}
        self.resource_classes: Dict[str, object] = {}           # by name
        self.resource_claims: Dict[str, ResourceClaim] = {}     # by namespace/name
        self.pdbs: Dict[str, PodDisruptionBudget] = {}          # by namespace/name
        self.pod_groups: Dict[str, PodGroup] = {}               # by namespace/name
        self.scheduling_quotas: Dict[str, SchedulingQuota] = {}  # by namespace/name
        self.pod_scheduling_contexts: Dict[str, PodSchedulingContext] = {}  # by namespace/name
        self.priority_classes: Dict[str, PriorityClass] = {}    # by name
        # the owners SelectorSpread reads, by namespace/name
        self.services: Dict[str, object] = {}
        self.replication_controllers: Dict[str, object] = {}
        self.replica_sets: Dict[str, object] = {}
        self.stateful_sets: Dict[str, object] = {}
        # what the admission chain reads
        self.resource_quotas: Dict[str, ResourceQuota] = {}    # by namespace/name
        self.limit_ranges: Dict[str, LimitRange] = {}          # by namespace/name
        self.service_accounts: Dict[str, ServiceAccount] = {}  # by namespace/name
        self.runtime_classes: Dict[str, RuntimeClass] = {}     # by name
        # the client runtime's, the controllers' and the harness's kinds
        self.leases: Dict[str, Lease] = {}                     # by namespace/name
        self.secrets: Dict[str, Secret] = {}                   # by namespace/name
        self.events: Dict[str, Event] = {}                     # by namespace/name
        self.resource_claim_templates: Dict[str, ResourceClaimTemplate] = {}
        # the controller manager's kinds, by namespace/name (the cluster-
        # scoped VolumeAttachment, CSR and RBAC kinds by name)
        self.deployments: Dict[str, object] = {}
        self.daemon_sets: Dict[str, object] = {}
        self.jobs: Dict[str, object] = {}
        self.cron_jobs: Dict[str, object] = {}
        self.endpoints: Dict[str, object] = {}
        self.endpoint_slices: Dict[str, object] = {}
        self.volume_attachments: Dict[str, object] = {}
        self.config_maps: Dict[str, object] = {}
        self.csrs: Dict[str, object] = {}
        self.hpas: Dict[str, object] = {}
        self.cluster_roles: Dict[str, object] = {}
        self.cluster_role_bindings: Dict[str, object] = {}
        # the API front's kinds: the admission webhooks' configurations,
        # Ingress and IngressClass, the CRDs with one map per served custom
        # kind (and its scope), the aggregated APIServices
        self.mutating_webhooks: Dict[str, object] = {}
        self.validating_webhooks: Dict[str, object] = {}
        self.ingresses: Dict[str, object] = {}
        self.ingress_classes: Dict[str, object] = {}
        self.crds: Dict[str, object] = {}
        self.api_services: Dict[str, object] = {}
        self._custom_kinds: Dict[str, Dict[str, object]] = {}
        self._custom_scope: Dict[str, bool] = {}  # kind -> namespaced
        # the request's identity per thread (the HTTP front pins it) and the
        # authorizer admission asks (None: authorization off)
        self._request_user = threading.local()
        self.authorizer = None
        # the metrics API's stand-in: pod key -> milli-cpu usage (the HPA
        # controller reads it)
        self.pod_metrics: Dict[str, int] = {}
        # the watch journal: (seq, kind, event, old, new), bounded, and the
        # live watches per kind, under the one lock with the map writes
        self._lock = threading.RLock()
        self._event_seq = 0
        self._journal: List[Tuple[int, str, str, object, object]] = []
        self._journal_capacity = JOURNAL_CAPACITY
        self._watchers: Dict[str, List[Watch]] = {}
        # the admission chain and the field validation on the write path;
        # None / False switch them off
        self.admission: Optional[AdmissionChain] = AdmissionChain()
        self.validation_enabled = True
        # the write-ahead log (``wal.attach_wal``; None: memory only) and the
        # group-commit buffer a batched writer holds under the lock
        self._wal = None
        self._wal_group: Optional[list] = None

    def _bump(self, obj) -> None:
        self._rv += 1
        obj.meta.resource_version = self._rv
        if not obj.meta.creation_timestamp:
            obj.meta.creation_timestamp = self.now_fn()

    def add_event_handler(self, kind: str, handler: Handler) -> None:
        self._handlers.setdefault(kind, []).append(handler)

    def _journal_event(self, kind: str, event: str, old, new) -> None:
        """Append to the journal and push to the kind's watches; called
        under ``_lock`` with the map write, so the journal keeps write
        order."""
        self._event_seq += 1
        seq = self._event_seq
        self._journal.append((seq, kind, event, old, new))
        if len(self._journal) > self._journal_capacity:
            del self._journal[: len(self._journal) - self._journal_capacity]
        if self._wal is not None:
            key = self._key_of(kind, new if new is not None else old)
            if self._wal_group is not None:
                self._wal_group.append((seq, kind, event, key, new))
            else:
                self._wal.append(seq, kind, event, key, new)
        for w in self._watchers.get(kind, []):
            w._push(WatchEvent(seq=seq, type=event, old=old,
                               object=new if new is not None else old))

    def list_objects(self, kind: str) -> Tuple[List[object], int]:
        """LIST: the kind's objects and the journal's sequence (the
        reflector's initial sync)."""
        with self._lock:
            return list(self._kind_map(kind).values()), self._event_seq

    def watch(self, kind: str, since: int) -> Watch:
        """WATCH from ``since`` (a sequence from ``list_objects`` or a
        ``WatchEvent``); ``Expired`` when the journal no longer covers it."""
        with self._lock:
            oldest = self._journal[0][0] - 1 if self._journal else self._event_seq
            if since < oldest:
                raise Expired(f"resourceVersion {since} is too old (oldest {oldest})")
            w = Watch(kind, self)
            for seq, k, event, old, new in self._journal:
                if seq > since and k == kind:
                    w._push(WatchEvent(seq=seq, type=event, old=old,
                                       object=new if new is not None else old))
            self._watchers.setdefault(kind, []).append(w)
            return w

    def _stop_watch(self, w: Watch) -> None:
        with self._lock:
            lst = self._watchers.get(w.kind, [])
            if w in lst:
                lst.remove(w)

    def snapshot_map(self, kind: str) -> Dict[str, object]:
        """A copy of a kind's map, safe to iterate while others write."""
        with self._lock:
            return dict(self._kind_map(kind))

    def _notify(self, kind: str, event: str, old, new) -> None:
        for h in self._handlers.get(kind, []):
            h(event, old, new)

    def _admit(self, kind: str, obj) -> None:
        """The chain's admit and validate passes, then the field validation
        of the admitted object (the strategy.Validate position)."""
        if self.admission is not None:
            self.admission.run(self, kind, obj)
        if self.validation_enabled:
            validation.validate(kind, obj)

    def _admit_update(self, kind: str, old, obj) -> None:
        if self.admission is not None:
            self.admission.run_update(self, kind, old, obj)
        if self.validation_enabled:
            validation.validate_update(kind, old, obj)

    def _guarded_update(self, kind: str, obj, lookup, commit):
        """An update admitted outside the lock (a webhook may call out) and
        committed under it only while ``lookup()`` still gives the object it
        was admitted against; else admitted again against the new one, up to
        16 times (GuaranteedUpdate's retry, etcd3/store.go:328). ``commit(old)``
        writes; returns the replaced object."""
        for _ in range(16):
            with self._lock:
                old = lookup()
            self._admit_update(kind, old, obj)
            with self._lock:
                if lookup() is old:
                    commit(old)
                    return old
        raise Conflict(f"{kind} {self._key_of(kind, obj)}: too many concurrent updates")

    # ------------------------------------------------------------- request user
    # (the HTTP front pins the authenticated user for the request; in-process
    # writers are system:admin)

    def request_user(self) -> str:
        return getattr(self._request_user, "name", "") or "system:admin"

    def request_groups(self) -> tuple:
        return getattr(self._request_user, "groups", ())

    def set_request_user(self, name: str, groups: tuple = ()) -> None:
        self._request_user.name = name
        self._request_user.groups = tuple(groups)

    @contextlib.contextmanager
    def as_user(self, name: str, groups: tuple = ()):
        """Writes on this thread as ``name`` with ``groups``; the previous
        identity, groups included, comes back on exit."""
        prev = (getattr(self._request_user, "name", ""),
                getattr(self._request_user, "groups", ()))
        self.set_request_user(name, groups)
        try:
            yield
        finally:
            self._request_user.name, self._request_user.groups = prev

    # ------------------------------------------------------------- nodes

    def create_node(self, node: Node) -> None:
        self._admit("Node", node)
        with self._lock:
            if node.meta.name in self.nodes:
                raise Conflict(f"node {node.meta.name} exists")
            self._bump(node)
            self.nodes[node.meta.name] = node
            self._journal_event("Node", ADDED, None, node)
        self._notify("Node", ADDED, None, node)

    def update_node(self, node: Node) -> None:
        def commit(old):
            if old is None:
                raise NotFound(node.meta.name)
            self._bump(node)
            self.nodes[node.meta.name] = node
            self._journal_event("Node", MODIFIED, old, node)

        old = self._guarded_update("Node", node, lambda: self.nodes.get(node.meta.name), commit)
        self._notify("Node", MODIFIED, old, node)

    def delete_node(self, name: str) -> None:
        with self._lock:
            old = self.nodes.pop(name, None)
            if old is not None:
                self._journal_event("Node", DELETED, old, None)
        if old is not None:
            self._notify("Node", DELETED, old, None)

    # ------------------------------------------------------------- pods

    def create_pod(self, pod: Pod) -> None:
        self._admit("Pod", pod)
        with self._lock:
            if pod.key() in self.pods:
                raise Conflict(f"pod {pod.key()} exists")
            # the quota charge after the duplicate-key check, undone if the
            # insert fails: a refused create leaves no usage behind
            undo_charge = (self.admission.charge(self, "Pod", pod)
                           if self.admission is not None else None)
            try:
                self._bump(pod)
                self.pods[pod.key()] = pod
                self._journal_event("Pod", ADDED, None, pod)
            except BaseException:
                if undo_charge is not None:
                    undo_charge()
                raise
        self._notify("Pod", ADDED, None, pod)

    def update_pod(self, pod: Pod) -> None:
        def commit(old):
            if old is None:
                raise NotFound(pod.key())
            self._bump(pod)
            self.pods[pod.key()] = pod
            self._journal_event("Pod", MODIFIED, old, pod)

        old = self._guarded_update("Pod", pod, lambda: self.pods.get(pod.key()), commit)
        self._notify("Pod", MODIFIED, old, pod)

    def delete_pod(self, key: str) -> None:
        with self._lock:
            old = self.pods.pop(key, None)
            if old is not None:
                self._journal_event("Pod", DELETED, old, None)
        if old is not None:
            self._notify("Pod", DELETED, old, None)

    def get_pod(self, key: str) -> Optional[Pod]:
        return self.pods.get(key)

    def _bind_one(self, pod_key: str, node_name: str) -> Tuple[Pod, Pod]:
        """The bind write, under ``_lock``."""
        pod = self.pods.get(pod_key)
        if pod is None:
            raise NotFound(pod_key)
        if pod.spec.node_name:
            raise Conflict(f"pod {pod_key} is already bound to {pod.spec.node_name}")
        new = pod.clone()
        new.spec.node_name = node_name
        new.status.phase = "Running"
        self._bump(new)
        self.pods[pod_key] = new
        self._journal_event("Pod", MODIFIED, pod, new)
        return pod, new

    def bind(self, pod_key: str, node_name: str) -> None:
        """POST pods/{name}/binding (storage.go:169): NotFound for a gone
        pod, Conflict for a bound one."""
        with self._lock:
            old, new = self._bind_one(pod_key, node_name)
        self._notify("Pod", MODIFIED, old, new)

    def bind_batch(self, bindings: Sequence[Tuple[str, str]]) -> List[Optional[Exception]]:
        """Bind (pod key, node name) pairs in order; each fails alone. Returns
        None or the exception per binding; the MODIFIED events follow all
        the writes, in order. With a WAL the batch's records land as one
        group-commit line, under the lock (``:505-534``)."""
        outcomes: List[Optional[Exception]] = [None] * len(bindings)
        notifies = []
        with self._lock:
            group_owner = self._wal_group is None
            if group_owner:
                self._wal_group = []
            try:
                for i, (key, node_name) in enumerate(bindings):
                    try:
                        notifies.append(self._bind_one(key, node_name))
                    except (NotFound, Conflict) as err:
                        outcomes[i] = err
            finally:
                if group_owner:
                    group, self._wal_group = self._wal_group, None
                    if self._wal is not None and group:
                        self._wal.append_batch(group)
        for old, new in notifies:
            self._notify("Pod", MODIFIED, old, new)
        return outcomes

    def update_pod_nominated_node(self, key: str, node_name: str) -> None:
        """Persist ``status.nominated_node_name`` (schedule_one.go:846) on a
        copy of the pod."""
        with self._lock:
            old = self.pods.get(key)
            if old is None:
                raise NotFound(key)
            new = old.clone()
            new.status.nominated_node_name = node_name
            self._bump(new)
            self.pods[key] = new
            self._journal_event("Pod", MODIFIED, old, new)
        self._notify("Pod", MODIFIED, old, new)

    # ------------------------------------------------------------- namespaces

    def create_namespace(self, ns: Namespace) -> None:
        """A namespace, whose labels affinity terms' namespaceSelector
        reads (``ns_labels``)."""
        with self._lock:
            self.namespaces[ns.meta.name] = ns
            self._journal_event("Namespace", ADDED, None, ns)
        self._notify("Namespace", ADDED, None, ns)

    def ns_labels(self, name: str) -> Dict[str, str]:
        ns = self.namespaces.get(name)
        return dict(ns.meta.labels) if ns else {}

    def kind_version(self, kind: str) -> int:
        """The store counter at the last create or update of ``kind`` (0
        before the first)."""
        return self._kind_rv.get(kind, 0)

    @property
    def KINDS(self) -> Tuple[str, ...]:
        """Every kind the store holds, in the JAX order (a WAL snapshot's)."""
        return tuple(self._kind_maps())

    def _kind_maps(self) -> Dict[str, Dict[str, object]]:
        return {
            "Pod": self.pods, "Node": self.nodes, "Namespace": self.namespaces,
            "PodDisruptionBudget": self.pdbs, "PriorityClass": self.priority_classes,
            "PersistentVolume": self.pvs, "PersistentVolumeClaim": self.pvcs,
            "StorageClass": self.storage_classes, "CSINode": self.csinodes,
            "Service": self.services, "ReplicationController": self.replication_controllers,
            "ReplicaSet": self.replica_sets, "StatefulSet": self.stateful_sets,
            "Lease": self.leases, "Deployment": self.deployments,
            "DaemonSet": self.daemon_sets, "Job": self.jobs, "Endpoints": self.endpoints,
            "ResourceQuota": self.resource_quotas, "LimitRange": self.limit_ranges,
            "CronJob": self.cron_jobs, "EndpointSlice": self.endpoint_slices,
            "VolumeAttachment": self.volume_attachments,
            "ServiceAccount": self.service_accounts,
            "MutatingWebhookConfiguration": self.mutating_webhooks,
            "ValidatingWebhookConfiguration": self.validating_webhooks,
            "ConfigMap": self.config_maps, "Secret": self.secrets,
            "CertificateSigningRequest": self.csrs, "RuntimeClass": self.runtime_classes,
            "Ingress": self.ingresses, "IngressClass": self.ingress_classes,
            "Event": self.events, "HorizontalPodAutoscaler": self.hpas,
            "ClusterRole": self.cluster_roles,
            "ClusterRoleBinding": self.cluster_role_bindings,
            "ResourceClass": self.resource_classes, "ResourceClaim": self.resource_claims,
            "ResourceClaimTemplate": self.resource_claim_templates,
            "PodSchedulingContext": self.pod_scheduling_contexts,
            "PodGroup": self.pod_groups, "SchedulingQuota": self.scheduling_quotas,
            "CustomResourceDefinition": self.crds, "APIService": self.api_services,
            **self._custom_kinds,
        }

    def _kind_map(self, kind: str) -> Dict[str, object]:
        try:
            return self._kind_maps()[kind]
        except KeyError:
            raise NotFound(f"unknown kind {kind!r}") from None

    def is_cluster_scoped(self, kind: str) -> bool:
        """The one scope rule (the keys and the HTTP front's paths): the
        built-in cluster-scoped kinds, CRDs, APIServices and the custom
        kinds registered cluster-scoped."""
        if kind in CLUSTER_SCOPED_KINDS or kind in ("CustomResourceDefinition", "APIService"):
            return True
        return kind in self._custom_scope and not self._custom_scope[kind]

    def _key_of(self, kind: str, obj) -> str:
        return obj.meta.name if self.is_cluster_scoped(kind) else obj.meta.key()

    # ------------------------------------------------------------- dynamic kinds

    def _register_crd_kind(self, crd) -> None:
        """The kind map and scope of a CRD's kind (also WAL restore's step,
        before any object of the kind)."""
        self._custom_kinds.setdefault(crd.kind, {})
        self._custom_scope[crd.kind] = bool(crd.namespaced)

    def create_crd(self, crd) -> None:
        """Register a custom kind (apiextensions' registration step, no
        schema): the generic verbs, watches and informers serve it after
        this as a built-in. Named ``plural.group`` when unnamed."""
        with self._lock:
            crd.meta.name = crd.meta.name or f"{crd.plural}.{crd.group}"
            if crd.kind in self._kind_maps():
                raise Conflict(f"kind {crd.kind!r} already served")
            self._bump(crd)
            self._kind_rv["CustomResourceDefinition"] = self._rv
            self.crds[crd.meta.name] = crd
            self._register_crd_kind(crd)
            self._journal_event("CustomResourceDefinition", ADDED, None, crd)
        self._notify("CustomResourceDefinition", ADDED, None, crd)

    def api_service_for(self, group: str, version: str):
        """The APIService with an endpoint that claims this group/version
        (kube-aggregator handler.go), or None."""
        with self._lock:
            for svc in self.api_services.values():
                if svc.group == group and svc.version == version and svc.service_endpoint:
                    return svc
        return None

    def crd_for_plural(self, group: str, plural: str):
        with self._lock:
            for crd in self.crds.values():
                if crd.group == group and crd.plural == plural:
                    return crd
        return None

    # ------------------------------------------------------------- generic kinds

    def create_object(self, kind: str, obj) -> None:
        if kind == "CustomResourceDefinition":
            return self.create_crd(obj)  # the kind's map and scope too
        if kind == "Pod":
            return self.create_pod(obj)  # the quota charge under the lock
        self._admit(kind, obj)
        m = self._kind_map(kind)
        with self._lock:
            key = self._key_of(kind, obj)
            if key in m:
                raise Conflict(f"{kind} {key} exists")
            self._bump(obj)
            self._kind_rv[kind] = self._rv
            m[key] = obj
            self._journal_event(kind, ADDED, None, obj)
        self._notify(kind, ADDED, None, obj)

    def get_object(self, kind: str, key: str):
        with self._lock:
            return self._kind_map(kind).get(key)

    def list_services(self, namespace: str) -> List[object]:
        return [s for s in self.services.values() if s.meta.namespace == namespace]

    def update_object(self, kind: str, obj) -> None:
        """Replace an existing object; NotFound when there is none. The
        stored ``deletion_timestamp`` wins over the client's (a Namespace
        keeps the client's), and an update that leaves a terminating object
        without finalizers completes its delete."""
        m = self._kind_map(kind)
        key = self._key_of(kind, obj)
        deleted = False

        def commit(old):
            nonlocal deleted
            if old is None:
                raise NotFound(f"{kind} {key}")
            if kind != "Namespace":
                obj.meta.deletion_timestamp = old.meta.deletion_timestamp
            deleted = bool(obj.meta.deletion_timestamp and not obj.meta.finalizers)
            if deleted:
                m.pop(key, None)
                self._journal_event(kind, DELETED, old, None)
            else:
                self._bump(obj)
                self._kind_rv[kind] = self._rv
                m[key] = obj
                self._journal_event(kind, MODIFIED, old, obj)

        old = self._guarded_update(kind, obj, lambda: m.get(key), commit)
        if deleted:
            self._notify(kind, DELETED, old, None)
        else:
            self._notify(kind, MODIFIED, old, obj)

    def delete_object(self, kind: str, key: str) -> None:
        """Remove an object. One with finalizers is only marked terminating
        (on a copy, once); the update that clears its last finalizer
        removes it."""
        m = self._kind_map(kind)
        marked = old = None
        with self._lock:
            cur = m.get(key)
            if cur is not None and cur.meta.finalizers:
                if not cur.meta.deletion_timestamp:
                    marked = dataclasses.replace(cur)
                    marked.meta = dataclasses.replace(cur.meta, deletion_timestamp=self.now_fn())
                    self._bump(marked)
                    m[key] = marked
                    self._journal_event(kind, MODIFIED, cur, marked)
            else:
                old = m.pop(key, None)
                if old is not None:
                    self._journal_event(kind, DELETED, old, None)
        if marked is not None:
            self._notify(kind, MODIFIED, cur, marked)
        if old is not None:
            self._notify(kind, DELETED, old, None)

    # ------------------------------------------------------------- workload kinds
    # (the JAX accessors: a write without the duplicate check or, but for
    # Service, admission)

    def _put(self, kind: str, m: Dict[str, object], obj) -> None:
        with self._lock:
            self._bump(obj)
            self._kind_rv[kind] = self._rv
            m[obj.meta.key()] = obj
            self._journal_event(kind, ADDED, None, obj)
        self._notify(kind, ADDED, None, obj)

    def create_service(self, svc: Service) -> None:
        self._admit("Service", svc)
        self._put("Service", self.services, svc)

    def create_replication_controller(self, rc: ReplicationController) -> None:
        self._put("ReplicationController", self.replication_controllers, rc)

    def get_replication_controller(self, key: str) -> Optional[ReplicationController]:
        with self._lock:
            return self.replication_controllers.get(key)

    def create_replica_set(self, rs: ReplicaSet) -> None:
        self._put("ReplicaSet", self.replica_sets, rs)

    def get_replica_set(self, key: str) -> Optional[ReplicaSet]:
        with self._lock:
            return self.replica_sets.get(key)

    def create_stateful_set(self, ss: StatefulSet) -> None:
        self._put("StatefulSet", self.stateful_sets, ss)

    def get_stateful_set(self, key: str) -> Optional[StatefulSet]:
        with self._lock:
            return self.stateful_sets.get(key)

    # ------------------------------------------------------------- storage kinds

    def create_pv(self, pv: PersistentVolume) -> None:
        self._admit("PersistentVolume", pv)
        with self._lock:
            self._bump(pv)
            self.pvs[pv.meta.name] = pv
            self._journal_event("PersistentVolume", ADDED, None, pv)
        self._notify("PersistentVolume", ADDED, None, pv)

    def create_pvc(self, pvc: PersistentVolumeClaim) -> None:
        self._admit("PersistentVolumeClaim", pvc)
        with self._lock:
            self._bump(pvc)
            self.pvcs[pvc.meta.key()] = pvc
            self._journal_event("PersistentVolumeClaim", ADDED, None, pvc)
        self._notify("PersistentVolumeClaim", ADDED, None, pvc)

    def create_storage_class(self, sc: StorageClass) -> None:
        with self._lock:
            self.storage_classes[sc.meta.name] = sc
            self._journal_event("StorageClass", ADDED, None, sc)
        self._notify("StorageClass", ADDED, None, sc)

    def create_csinode(self, cn: CSINode) -> None:
        with self._lock:
            self.csinodes[cn.meta.name] = cn
            self._journal_event("CSINode", ADDED, None, cn)
        self._notify("CSINode", ADDED, None, cn)

    def bind_pv(self, pv_name: str, pvc_key: str) -> None:
        """The PV controller's bind (VolumeBinding's PreBind write): the
        PV's claimRef and the PVC's volumeName, then the two MODIFIED
        events in that order. NotFound for a missing PV or PVC, Conflict
        for a PV bound to another claim."""
        with self._lock:
            pv = self.pvs.get(pv_name)
            pvc = self.pvcs.get(pvc_key)
            if pv is None or pvc is None:
                raise NotFound(f"{pv_name} / {pvc_key}")
            if pv.bound_pvc and pv.bound_pvc != pvc_key:
                raise Conflict(f"pv {pv_name} already bound to {pv.bound_pvc}")
            new_pv = dataclasses.replace(pv, bound_pvc=pvc_key)
            new_pvc = dataclasses.replace(pvc, bound_pv=pv_name)
            self._bump(new_pv)
            self._bump(new_pvc)
            self.pvs[pv_name] = new_pv
            self.pvcs[pvc_key] = new_pvc
            self._journal_event("PersistentVolume", MODIFIED, pv, new_pv)
            self._journal_event("PersistentVolumeClaim", MODIFIED, pvc, new_pvc)
        self._notify("PersistentVolume", MODIFIED, pv, new_pv)
        self._notify("PersistentVolumeClaim", MODIFIED, pvc, new_pvc)

    def get_pvc(self, key: str) -> Optional[PersistentVolumeClaim]:
        return self.pvcs.get(key)

    def get_pv(self, name: str) -> Optional[PersistentVolume]:
        return self.pvs.get(name)

    def list_pvs(self) -> List[PersistentVolume]:
        return list(self.pvs.values())

    def get_storage_class(self, name: str) -> Optional[StorageClass]:
        return self.storage_classes.get(name)

    def get_csinode(self, name: str) -> Optional[CSINode]:
        return self.csinodes.get(name)

    # ------------------------------------------------------------- policy/v1

    def create_pdb(self, pdb: PodDisruptionBudget) -> None:
        """No resource version, as on the JAX store (``:563-567``)."""
        with self._lock:
            self.pdbs[pdb.meta.key()] = pdb
            self._journal_event("PodDisruptionBudget", ADDED, None, pdb)
        self._notify("PodDisruptionBudget", ADDED, None, pdb)

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        return list(self.pdbs.values())

    # ------------------------------------------------------------- scheduling/v1

    def create_priority_class(self, pc: PriorityClass) -> None:
        """No resource version, as on the JAX store (``:573-577``)."""
        with self._lock:
            self.priority_classes[pc.meta.name] = pc
            self._journal_event("PriorityClass", ADDED, None, pc)
        self._notify("PriorityClass", ADDED, None, pc)

    # ------------------------------------------------------------- resource.k8s.io

    def allocate_claim(self, claim_key: str, node_name: str, pod_key: str) -> None:
        """Allocate a ResourceClaim to a node and reserve it for a pod (the
        DynamicResources Reserve write). A claim allocated to a different
        node raises Conflict; a missing one NotFound."""
        with self._lock:
            claim = self.resource_claims.get(claim_key)
            if claim is None:
                raise NotFound(claim_key)
            if claim.allocated_node and claim.allocated_node != node_name:
                raise Conflict(f"claim {claim_key} already allocated to {claim.allocated_node}")
            reserved = claim.reserved_for
            if pod_key not in reserved:
                reserved = reserved + (pod_key,)
            new = dataclasses.replace(claim, allocated_node=node_name, reserved_for=reserved)
            self._bump(new)
            self.resource_claims[claim_key] = new
            self._journal_event("ResourceClaim", MODIFIED, claim, new)
        self._notify("ResourceClaim", MODIFIED, claim, new)

    def release_claim(self, claim_key: str, pod_key: str) -> None:
        """Drop one pod's reservation; the last one leaving deallocates."""
        with self._lock:
            claim = self.resource_claims.get(claim_key)
            if claim is None or pod_key not in claim.reserved_for:
                return
            reserved = tuple(k for k in claim.reserved_for if k != pod_key)
            new = dataclasses.replace(claim, reserved_for=reserved,
                                      allocated_node=claim.allocated_node if reserved else "")
            self._bump(new)
            self.resource_claims[claim_key] = new
            self._journal_event("ResourceClaim", MODIFIED, claim, new)
        self._notify("ResourceClaim", MODIFIED, claim, new)

    # ------------------------------------------------------------- coordination.k8s.io

    def get_lease(self, key: str) -> Optional[Lease]:
        with self._lock:
            return self.leases.get(key)

    def create_lease(self, lease: Lease) -> None:
        self._admit("Lease", lease)
        with self._lock:
            if lease.meta.key() in self.leases:
                raise Conflict(f"lease {lease.meta.key()} exists")
            self._bump(lease)
            self.leases[lease.meta.key()] = lease
            self._journal_event("Lease", ADDED, None, lease)
        self._notify("Lease", ADDED, None, lease)

    def update_lease(self, lease: Lease, expect_rv: int) -> None:
        """Replace the lease only while the stored one still has
        ``expect_rv`` (optimistic concurrency, etcd3/store.go:328: what
        makes leader election safe); Conflict otherwise."""
        self._admit_update("Lease", self.leases.get(lease.meta.key()), lease)
        with self._lock:
            old = self.leases.get(lease.meta.key())
            if old is None:
                raise NotFound(lease.meta.key())
            if old.meta.resource_version != expect_rv:
                raise Conflict(f"lease {lease.meta.key()}: rv {expect_rv} != "
                               f"{old.meta.resource_version}")
            self._bump(lease)
            self.leases[lease.meta.key()] = lease
            self._journal_event("Lease", MODIFIED, old, lease)
        self._notify("Lease", MODIFIED, old, lease)
