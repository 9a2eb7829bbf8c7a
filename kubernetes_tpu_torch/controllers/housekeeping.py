"""Housekeeping controllers: PodGC, GarbageCollector, Namespace, Endpoints,
PV binder, ResourceQuota
(pkg/controller/{podgc,garbagecollector,namespace,endpoint,volume,resourcequota});
an own copy of ``kubernetes_tpu/controllers/housekeeping.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..api.types import (
    BINDING_IMMEDIATE,
    EndpointAddress,
    Endpoints,
    Namespace,
    ObjectMeta,
    Service,
)
from .base import Controller

WORKLOAD_KINDS = (
    ("ReplicaSet", "ReplicaSet"),
    ("StatefulSet", "StatefulSet"),
    ("Deployment", "Deployment"),
    ("DaemonSet", "DaemonSet"),
    ("Job", "Job"),
)


class PodGCController(Controller):
    """podgc/gc_controller.go: delete pods bound to nodes that no longer
    exist (gcOrphaned) and terminated pods beyond a threshold
    (gcTerminated, threshold --terminated-pod-gc-threshold)."""

    name = "podgc"
    watch_kinds = ("Pod", "Node")

    def __init__(self, store, factory, terminated_threshold: int = 12500):
        super().__init__(store, factory)
        self.terminated_threshold = terminated_threshold

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return ["gc"]  # single sweep key; the sweep is cheap and level-driven

    def reconcile(self, key: str) -> None:
        nodes = set(self.store.snapshot_map("Node"))
        terminated = []
        for pod in self.store.snapshot_map("Pod").values():
            if pod.spec.node_name and pod.spec.node_name not in nodes:
                self.store.delete_pod(pod.meta.key())
                continue
            if pod.status.phase in ("Succeeded", "Failed"):
                terminated.append(pod)
        excess = len(terminated) - self.terminated_threshold
        if excess > 0:
            terminated.sort(key=lambda p: p.status.start_time)
            for pod in terminated[:excess]:
                self.store.delete_pod(pod.meta.key())


class GarbageCollector(Controller):
    """garbagecollector/garbagecollector.go, ownerRef cascade only: an object
    whose controller owner no longer exists is deleted (attemptToDeleteItem's
    orphan check; no finalizer machinery)."""

    name = "garbagecollector"
    watch_kinds = ("Pod", "ReplicaSet", "StatefulSet", "Job", "Deployment",
                   "DaemonSet", "PersistentVolumeClaim")

    DEPENDENT_KINDS = ("Pod", "ReplicaSet", "StatefulSet", "Job",
                       "PersistentVolumeClaim")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if event == "delete":
            # owner gone: enqueue its dependents (graph_builder's virtual
            # delete propagation)
            out = []
            for dep_kind in self.DEPENDENT_KINDS:
                for key, dep in self.store.snapshot_map(dep_kind).items():
                    ref = dep.meta.controller_of()
                    if (ref is not None and ref.kind == kind
                            and ref.name == obj.meta.name
                            and dep.meta.namespace == obj.meta.namespace):
                        out.append(f"{dep_kind}:{key}")
            return out
        return [f"{kind}:{obj.meta.key()}"]

    def _owner_exists(self, namespace: str, kind: str, name: str) -> bool:
        key = f"{namespace}/{name}"
        lookups = {
            "ReplicaSet": self.store.get_replica_set,
            "StatefulSet": self.store.get_stateful_set,
            "ReplicationController": self.store.get_replication_controller,
            "Deployment": lambda k: self.store.get_object("Deployment", k),
            "DaemonSet": lambda k: self.store.get_object("DaemonSet", k),
            "Job": lambda k: self.store.get_object("Job", k),
            "Pod": self.store.get_pod,  # ephemeral PVCs are pod-owned
        }
        fn = lookups.get(kind)
        if fn is None:
            return True  # unknown owner kinds are left alone
        return fn(key) is not None

    def reconcile(self, key: str) -> None:
        kind, _, obj_key = key.partition(":")
        obj = (self.store.get_pod(obj_key) if kind == "Pod"
               else self.store.get_object(kind, obj_key))
        if obj is None:
            return
        ref = obj.meta.controller_of()
        if ref is None:
            return
        if not self._owner_exists(obj.meta.namespace, ref.kind, ref.name):
            if kind == "Pod":
                self.store.delete_pod(obj_key)
            else:
                self.store.delete_object(kind, obj_key)


class NamespaceController(Controller):
    """namespace/namespace_controller.go: a terminating namespace has its
    contents (pods + workload objects + services) deleted, then is removed."""

    name = "namespace"
    watch_kinds = ("Namespace", "PersistentVolumeClaim")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "PersistentVolumeClaim":
            # a finalizer-protected PVC completing its delete may be the
            # last thing holding a terminating namespace open
            return [obj.meta.namespace] if event == "delete" else []
        return [obj.meta.name]

    # namespaced kinds swept besides pods + workloads (the deletion
    # discovery the reference does dynamically per API group)
    SWEEP_KINDS = ("Service", "Endpoints", "EndpointSlice", "ServiceAccount",
                   "ConfigMap", "HorizontalPodAutoscaler", "ResourceQuota",
                   "LimitRange", "PodDisruptionBudget", "PersistentVolumeClaim",
                   "CronJob")

    def reconcile(self, key: str) -> None:
        ns: Optional[Namespace] = self.store.namespaces.get(key)
        if ns is None or not ns.meta.deletion_timestamp:
            return
        for pod in self.store.snapshot_map("Pod").values():
            if pod.meta.namespace == key:
                self.store.delete_pod(pod.meta.key())
        for kind, _ in WORKLOAD_KINDS:
            for obj_key, obj in self.store.snapshot_map(kind).items():
                if obj.meta.namespace == key:
                    self.store.delete_object(kind, obj_key)
        for kind in self.SWEEP_KINDS:
            for obj_key, obj in self.store.snapshot_map(kind).items():
                if obj.meta.namespace == key:
                    self.store.delete_object(kind, obj_key)
        # finalizer-gated objects (protected PVCs) may survive the sweep as
        # terminating: the namespace stays terminating until their deletes
        # complete (keys_for maps PVC deletions back here)
        if any(o.meta.namespace == key
               for o in self.store.snapshot_map("PersistentVolumeClaim").values()):
            return
        self.store.delete_object("Namespace", key)


def service_keys_for_pod(store, pod) -> List[str]:
    """Services whose selector matches the pod (shared by the Endpoints and
    EndpointSlice controllers' pod→service fan-out)."""
    return [
        svc.meta.key()
        for svc in store.snapshot_map("Service").values()
        if svc.meta.namespace == pod.meta.namespace and svc.selector
        and all(pod.meta.labels.get(k) == v for k, v in svc.selector.items())
    ]


def ready_addresses(store, svc) -> tuple:
    """The Service's ready (Running, selector-matched) pod addresses in
    name order — the address set both endpoint controllers publish."""
    return tuple(
        EndpointAddress(pod_key=p.meta.key(), node_name=p.spec.node_name)
        for p in sorted(store.snapshot_map("Pod").values(), key=lambda p: p.meta.name)
        if p.meta.namespace == svc.meta.namespace
        and p.status.phase == "Running"
        and svc.selector
        and all(p.meta.labels.get(k) == v for k, v in svc.selector.items())
    )


class EndpointsController(Controller):
    """endpoint/endpoints_controller.go: Endpoints object per Service listing
    the Running, selector-matched pods' (pod, node) addresses."""

    name = "endpoints"
    watch_kinds = ("Service", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "Service":
            return [obj.meta.key()]
        return service_keys_for_pod(self.store, obj)

    MANAGED_LABEL = "endpoints.kubernetes.io/managed-by"

    def reconcile(self, key: str) -> None:
        svc: Optional[Service] = self.store.services.get(key)
        existing = self.store.get_object("Endpoints", key)
        if svc is None:
            # delete only controller-managed Endpoints; user-managed ones
            # (selector-less services) are the mirroring controller's input
            if existing is not None and existing.meta.labels.get(self.MANAGED_LABEL):
                self.store.delete_object("Endpoints", key)
            return
        if not svc.selector:
            return  # selector-less services keep their user-managed Endpoints
        addrs = ready_addresses(self.store, svc)
        if existing is None:
            self.store.create_object("Endpoints", Endpoints(
                meta=ObjectMeta(name=svc.meta.name, namespace=svc.meta.namespace,
                                labels={self.MANAGED_LABEL: "endpoint-controller"}),
                addresses=addrs,
            ))
        elif existing.addresses != addrs:
            new = dataclasses.replace(existing, addresses=addrs)
            new.meta = dataclasses.replace(existing.meta)
            self.store.update_object("Endpoints", new)


class PVBinderController(Controller):
    """persistentvolume/pv_controller.go, Immediate binding only: an unbound
    PVC with an Immediate StorageClass binds to the smallest compatible
    unbound PV (WaitForFirstConsumer stays with the scheduler's
    VolumeBinding plugin)."""

    name = "pvbinder"
    watch_kinds = ("PersistentVolumeClaim", "PersistentVolume")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "PersistentVolumeClaim":
            return [obj.meta.key()]
        return [obj.bound_pvc] if obj.bound_pvc else [
            pvc.meta.key()
            for pvc in self.store.snapshot_map("PersistentVolumeClaim").values()
            if not pvc.bound_pv
        ]

    def reconcile(self, key: str) -> None:
        pvc = self.store.get_pvc(key)
        if pvc is None or pvc.bound_pv:
            return
        sc = self.store.get_storage_class(pvc.storage_class)
        mode = sc.volume_binding_mode if sc is not None else BINDING_IMMEDIATE
        if mode != BINDING_IMMEDIATE:
            return
        candidates = [
            pv for pv in self.store.list_pvs()
            if not pv.bound_pvc
            and pv.storage_class == pvc.storage_class
            and pv.capacity_bytes >= pvc.requested_bytes
            and (not pvc.access_modes or set(pvc.access_modes) <= set(pv.access_modes))
        ]
        if not candidates:
            return
        candidates.sort(key=lambda pv: (pv.capacity_bytes, pv.meta.name))
        self.store.bind_pv(candidates[0].meta.name, key)


class ResourceQuotaController(Controller):
    """resourcequota/resource_quota_controller.go: recompute each quota's
    used vector from live pods — repairs the synchronous admission charges
    after deletes/failures (level-driven full recount)."""

    name = "resourcequota"
    watch_kinds = ("ResourceQuota", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "ResourceQuota":
            return [obj.meta.key()]
        return [rq.meta.key()
                for rq in self.store.snapshot_map("ResourceQuota").values()
                if rq.meta.namespace == obj.meta.namespace]

    def reconcile(self, key: str) -> None:
        from ..apiserver.admission import pod_quota_usage

        rq = self.store.get_object("ResourceQuota", key)
        if rq is None:
            return
        used: dict = {}
        for pod in self.store.snapshot_map("Pod").values():
            if (pod.meta.namespace != rq.meta.namespace
                    or pod.status.phase in ("Succeeded", "Failed")):
                continue
            for dim, amount in pod_quota_usage(pod).items():
                used[dim] = used.get(dim, 0) + amount
        tracked = {dim: used.get(dim, 0) for dim in rq.hard}
        if tracked != rq.used:
            new = dataclasses.replace(rq, used=tracked)
            new.meta = dataclasses.replace(rq.meta)
            self.store.update_object("ResourceQuota", new)
