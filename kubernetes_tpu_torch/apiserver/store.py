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
ResourceClass, ResourceClaim, PodGroup and SchedulingQuota through
``create_object`` / ``get_object`` / ``update_object`` (the Coscheduling
plugin's status writes), the storage kinds through their own accessors, the
claim allocation writes of the DynamicResources Reserve, and the
PodDisruptionBudgets that preemption reads. Every write bumps
the object's ``resource_version`` from one store-wide counter, as the JAX
store does (the volume screen caches by it), and ``kind_version`` gives
the counter of a generic kind's last write: where the JAX store sends a
watch event, a reader of the port's store compares versions (the quota
ledger rebuilds its index when SchedulingQuota's moves). No WAL, watches,
informers, admission or locking: one scheduler thread owns it. The generic
kinds fire no handler.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api.types import (CSINode, Namespace, Node, PersistentVolume, PersistentVolumeClaim,
                         Pod, PodDisruptionBudget, PodGroup, ResourceClaim,
                         SchedulingQuota, StorageClass)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

Handler = Callable[[str, Optional[object], Optional[object]], None]


class Conflict(Exception):
    """409: the object exists, or a claim is allocated to another node."""


class NotFound(Exception):
    """404."""


_CLUSTER_SCOPED = frozenset(("ResourceClass",))


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

    # ------------------------------------------------------------- nodes

    def create_node(self, node: Node) -> None:
        if node.meta.name in self.nodes:
            raise Conflict(f"node {node.meta.name} exists")
        self._bump(node)
        self.nodes[node.meta.name] = node
        self._notify("Node", ADDED, None, node)

    def update_node(self, node: Node) -> None:
        old = self.nodes.get(node.meta.name)
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
        if pod.key() in self.pods:
            raise Conflict(f"pod {pod.key()} exists")
        self._bump(pod)
        self.pods[pod.key()] = pod
        self._notify("Pod", ADDED, None, pod)

    def update_pod(self, pod: Pod) -> None:
        old = self.pods.get(pod.key())
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
                "PodGroup": self.pod_groups, "SchedulingQuota": self.scheduling_quotas}
        if kind not in maps:
            raise NotFound(f"unknown kind {kind!r}")
        return maps[kind]

    # ------------------------------------------------------------- generic kinds

    def create_object(self, kind: str, obj) -> None:
        m = self._kind_map(kind)
        key = obj.meta.name if kind in _CLUSTER_SCOPED else obj.meta.key()
        if key in m:
            raise Conflict(f"{kind} {key} exists")
        self._bump(obj)
        self._kind_rv[kind] = self._rv
        m[key] = obj

    def get_object(self, kind: str, key: str):
        return self._kind_map(kind).get(key)

    def update_object(self, kind: str, obj) -> None:
        """Replace an existing object; NotFound when there is none."""
        m = self._kind_map(kind)
        key = obj.meta.name if kind in _CLUSTER_SCOPED else obj.meta.key()
        if key not in m:
            raise NotFound(f"{kind} {key}")
        self._bump(obj)
        self._kind_rv[kind] = self._rv
        m[key] = obj

    # ------------------------------------------------------------- storage kinds

    def create_pv(self, pv: PersistentVolume) -> None:
        self._bump(pv)
        self.pvs[pv.meta.name] = pv

    def create_pvc(self, pvc: PersistentVolumeClaim) -> None:
        self._bump(pvc)
        self.pvcs[pvc.meta.key()] = pvc

    def create_storage_class(self, sc: StorageClass) -> None:
        self.storage_classes[sc.meta.name] = sc

    def create_csinode(self, cn: CSINode) -> None:
        self.csinodes[cn.meta.name] = cn

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
