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
the counter of a generic kind's last write: where the JAX store sends a
watch event, a reader of the port's store compares versions (the quota
ledger rebuilds its index when SchedulingQuota's moves). No WAL, watches,
informers or locking: one scheduler thread owns it.

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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import validation
from ..api.types import (CSINode, LimitRange, Namespace, Node, PersistentVolume,
                         PersistentVolumeClaim, Pod, PodDisruptionBudget, PodGroup,
                         PodSchedulingContext, PriorityClass, ResourceClaim, ResourceQuota,
                         RuntimeClass, SchedulingQuota, ServiceAccount, StorageClass)
from .admission import AdmissionChain

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

Handler = Callable[[str, Optional[object], Optional[object]], None]


class Conflict(Exception):
    """409: the object exists, or a claim is allocated to another node."""


class NotFound(Exception):
    """404."""


_CLUSTER_SCOPED = frozenset(("ResourceClass", "RuntimeClass"))


class Store:
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
        # the admission chain and the field validation on the write path;
        # None / False switch them off
        self.admission: Optional[AdmissionChain] = AdmissionChain()
        self.validation_enabled = True

    def _bump(self, obj) -> None:
        self._rv += 1
        obj.meta.resource_version = self._rv
        if not obj.meta.creation_timestamp:
            obj.meta.creation_timestamp = self.now_fn()

    def add_event_handler(self, kind: str, handler: Handler) -> None:
        self._handlers.setdefault(kind, []).append(handler)

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

    # ------------------------------------------------------------- nodes

    def create_node(self, node: Node) -> None:
        self._admit("Node", node)
        if node.meta.name in self.nodes:
            raise Conflict(f"node {node.meta.name} exists")
        self._bump(node)
        self.nodes[node.meta.name] = node
        self._notify("Node", ADDED, None, node)

    def update_node(self, node: Node) -> None:
        old = self.nodes.get(node.meta.name)
        self._admit_update("Node", old, node)
        if old is None:
            raise NotFound(node.meta.name)
        self._bump(node)
        self.nodes[node.meta.name] = node
        self._notify("Node", MODIFIED, old, node)

    def delete_node(self, name: str) -> None:
        old = self.nodes.pop(name, None)
        if old is not None:
            self._notify("Node", DELETED, old, None)

    # ------------------------------------------------------------- pods

    def create_pod(self, pod: Pod) -> None:
        self._admit("Pod", pod)
        if pod.key() in self.pods:
            raise Conflict(f"pod {pod.key()} exists")
        # the quota charge after the duplicate-key check, undone if the
        # insert fails: a refused create leaves no usage behind
        undo_charge = (self.admission.charge(self, "Pod", pod)
                       if self.admission is not None else None)
        try:
            self._bump(pod)
            self.pods[pod.key()] = pod
        except BaseException:
            if undo_charge is not None:
                undo_charge()
            raise
        self._notify("Pod", ADDED, None, pod)

    def update_pod(self, pod: Pod) -> None:
        old = self.pods.get(pod.key())
        self._admit_update("Pod", old, pod)
        if old is None:
            raise NotFound(pod.key())
        self._bump(pod)
        self.pods[pod.key()] = pod
        self._notify("Pod", MODIFIED, old, pod)

    def delete_pod(self, key: str) -> None:
        old = self.pods.pop(key, None)
        if old is not None:
            self._notify("Pod", DELETED, old, None)

    def get_pod(self, key: str) -> Optional[Pod]:
        return self.pods.get(key)

    def _bind_one(self, pod_key: str, node_name: str) -> Tuple[Pod, Pod]:
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
        return pod, new

    def bind(self, pod_key: str, node_name: str) -> None:
        """POST pods/{name}/binding (storage.go:169): NotFound for a gone
        pod, Conflict for a bound one."""
        old, new = self._bind_one(pod_key, node_name)
        self._notify("Pod", MODIFIED, old, new)

    def bind_batch(self, bindings: Sequence[Tuple[str, str]]) -> List[Optional[Exception]]:
        """Bind (pod key, node name) pairs in order; each fails alone. Returns
        None or the exception per binding; the MODIFIED events follow all
        the writes, in order."""
        outcomes: List[Optional[Exception]] = [None] * len(bindings)
        notifies = []
        for i, (key, node_name) in enumerate(bindings):
            try:
                notifies.append(self._bind_one(key, node_name))
            except (NotFound, Conflict) as err:
                outcomes[i] = err
        for old, new in notifies:
            self._notify("Pod", MODIFIED, old, new)
        return outcomes

    def update_pod_nominated_node(self, key: str, node_name: str) -> None:
        """Persist ``status.nominated_node_name`` (schedule_one.go:846) on a
        copy of the pod."""
        old = self.pods.get(key)
        if old is None:
            raise NotFound(key)
        new = old.clone()
        new.status.nominated_node_name = node_name
        self._bump(new)
        self.pods[key] = new
        self._notify("Pod", MODIFIED, old, new)

    # ------------------------------------------------------------- namespaces

    def create_namespace(self, ns: Namespace) -> None:
        """A namespace, whose labels affinity terms' namespaceSelector
        reads (``ns_labels``)."""
        self.namespaces[ns.meta.name] = ns

    def ns_labels(self, name: str) -> Dict[str, str]:
        ns = self.namespaces.get(name)
        return dict(ns.meta.labels) if ns else {}

    def kind_version(self, kind: str) -> int:
        """The store counter at the last create or update of ``kind`` (0
        before the first)."""
        return self._kind_rv.get(kind, 0)

    def _kind_map(self, kind: str) -> Dict[str, object]:
        maps = {"ResourceClass": self.resource_classes, "ResourceClaim": self.resource_claims,
                "PodGroup": self.pod_groups, "SchedulingQuota": self.scheduling_quotas,
                "PodSchedulingContext": self.pod_scheduling_contexts,
                "Service": self.services, "ReplicationController": self.replication_controllers,
                "ReplicaSet": self.replica_sets, "StatefulSet": self.stateful_sets,
                "ResourceQuota": self.resource_quotas, "LimitRange": self.limit_ranges,
                "ServiceAccount": self.service_accounts, "RuntimeClass": self.runtime_classes,
                "PodDisruptionBudget": self.pdbs}
        if kind not in maps:
            raise NotFound(f"unknown kind {kind!r}")
        return maps[kind]

    # ------------------------------------------------------------- generic kinds

    def create_object(self, kind: str, obj) -> None:
        self._admit(kind, obj)
        m = self._kind_map(kind)
        key = obj.meta.name if kind in _CLUSTER_SCOPED else obj.meta.key()
        if key in m:
            raise Conflict(f"{kind} {key} exists")
        self._bump(obj)
        self._kind_rv[kind] = self._rv
        m[key] = obj
        self._notify(kind, ADDED, None, obj)

    def get_object(self, kind: str, key: str):
        return self._kind_map(kind).get(key)

    def list_services(self, namespace: str) -> List[object]:
        return [s for s in self.services.values() if s.meta.namespace == namespace]

    def update_object(self, kind: str, obj) -> None:
        """Replace an existing object; NotFound when there is none."""
        m = self._kind_map(kind)
        key = obj.meta.name if kind in _CLUSTER_SCOPED else obj.meta.key()
        old = m.get(key)
        self._admit_update(kind, old, obj)
        if old is None:
            raise NotFound(f"{kind} {key}")
        self._bump(obj)
        self._kind_rv[kind] = self._rv
        m[key] = obj
        self._notify(kind, MODIFIED, old, obj)

    def delete_object(self, kind: str, key: str) -> None:
        """Remove an object (no finalizers in the port's store)."""
        old = self._kind_map(kind).pop(key, None)
        if old is not None:
            self._notify(kind, DELETED, old, None)

    # ------------------------------------------------------------- storage kinds

    def create_pv(self, pv: PersistentVolume) -> None:
        self._admit("PersistentVolume", pv)
        self._bump(pv)
        self.pvs[pv.meta.name] = pv
        self._notify("PersistentVolume", ADDED, None, pv)

    def create_pvc(self, pvc: PersistentVolumeClaim) -> None:
        self._admit("PersistentVolumeClaim", pvc)
        self._bump(pvc)
        self.pvcs[pvc.meta.key()] = pvc
        self._notify("PersistentVolumeClaim", ADDED, None, pvc)

    def create_storage_class(self, sc: StorageClass) -> None:
        self.storage_classes[sc.meta.name] = sc
        self._notify("StorageClass", ADDED, None, sc)

    def create_csinode(self, cn: CSINode) -> None:
        self.csinodes[cn.meta.name] = cn
        self._notify("CSINode", ADDED, None, cn)

    def bind_pv(self, pv_name: str, pvc_key: str) -> None:
        """The PV controller's bind (VolumeBinding's PreBind write): the
        PV's claimRef and the PVC's volumeName, then the two MODIFIED
        events in that order. NotFound for a missing PV or PVC, Conflict
        for a PV bound to another claim."""
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
        self._bump(pdb)
        self.pdbs[pdb.meta.key()] = pdb

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        return list(self.pdbs.values())

    # ------------------------------------------------------------- scheduling/v1

    def create_priority_class(self, pc: PriorityClass) -> None:
        self._bump(pc)
        self.priority_classes[pc.meta.name] = pc
        self._notify("PriorityClass", ADDED, None, pc)

    # ------------------------------------------------------------- resource.k8s.io

    def allocate_claim(self, claim_key: str, node_name: str, pod_key: str) -> None:
        """Allocate a ResourceClaim to a node and reserve it for a pod (the
        DynamicResources Reserve write). A claim allocated to a different
        node raises Conflict; a missing one NotFound."""
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
        self._notify("ResourceClaim", MODIFIED, claim, new)

    def release_claim(self, claim_key: str, pod_key: str) -> None:
        """Drop one pod's reservation; the last one leaving deallocates."""
        claim = self.resource_claims.get(claim_key)
        if claim is None or pod_key not in claim.reserved_for:
            return
        reserved = tuple(k for k in claim.reserved_for if k != pod_key)
        new = dataclasses.replace(claim, reserved_for=reserved,
                                  allocated_node=claim.allocated_node if reserved else "")
        self._bump(new)
        self.resource_claims[claim_key] = new
        self._notify("ResourceClaim", MODIFIED, claim, new)
