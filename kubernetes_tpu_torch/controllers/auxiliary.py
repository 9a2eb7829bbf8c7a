"""Controller-manager loops (an own copy of
``kubernetes_tpu/controllers/auxiliary.py``): serviceaccount,
root-ca-cert-publisher, ttl-after-finished, pvc/pv-protection, nodeipam,
endpointslicemirroring, ephemeral-volume — more of the ~30
NewControllerInitializers loops
(cmd/kube-controller-manager/app/controllermanager.go:412)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..api.types import (
    ConfigMap,
    EndpointSlice,
    ObjectMeta,
    OwnerReference,
    PersistentVolumeClaim,
    ServiceAccount,
)
from ..apiserver.store import Conflict
from .base import Controller

PVC_PROTECTION_FINALIZER = "kubernetes.io/pvc-protection"
PV_PROTECTION_FINALIZER = "kubernetes.io/pv-protection"
ROOT_CA_CONFIGMAP = "kube-root-ca.crt"


class ServiceAccountController(Controller):
    """serviceaccount_controller: ensure every (non-terminating) namespace
    has a ``default`` ServiceAccount."""

    name = "serviceaccount"
    watch_kinds = ("Namespace", "ServiceAccount")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.namespace if kind == "ServiceAccount" else obj.meta.name]

    def reconcile(self, key: str) -> None:
        ns = self.store.namespaces.get(key)
        if ns is None or ns.meta.deletion_timestamp:
            return
        if f"{key}/default" in self.store.service_accounts:
            return
        try:
            self.store.create_object("ServiceAccount", ServiceAccount(
                meta=ObjectMeta(name="default", namespace=key)))
        except Conflict:
            pass


class RootCACertPublisher(Controller):
    """root-ca-cert-publisher: publish the cluster CA bundle as the
    ``kube-root-ca.crt`` ConfigMap in every namespace (certificates/rootcacertpublisher)."""

    name = "root-ca-cert-publisher"
    watch_kinds = ("Namespace", "ConfigMap")

    def __init__(self, store, factory, ca_bundle: str = "<cluster-ca-bundle>"):
        super().__init__(store, factory)
        self.ca_bundle = ca_bundle

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "ConfigMap":
            if obj.meta.name != ROOT_CA_CONFIGMAP:
                return []
            return [obj.meta.namespace]
        return [obj.meta.name]

    def reconcile(self, key: str) -> None:
        ns = self.store.namespaces.get(key)
        if ns is None or ns.meta.deletion_timestamp:
            return
        cm_key = f"{key}/{ROOT_CA_CONFIGMAP}"
        existing = self.store.get_object("ConfigMap", cm_key)
        if existing is not None and existing.data.get("ca.crt") == self.ca_bundle:
            return
        cm = ConfigMap(meta=ObjectMeta(name=ROOT_CA_CONFIGMAP, namespace=key),
                       data={"ca.crt": self.ca_bundle})
        try:
            if existing is None:
                self.store.create_object("ConfigMap", cm)
            else:
                self.store.update_object("ConfigMap", cm)
        except Conflict:
            pass


class TTLAfterFinishedController(Controller):
    """ttlafterfinished: delete finished Jobs ``ttlSecondsAfterFinished``
    after their completion time (pkg/controller/ttlafterfinished)."""

    name = "ttlafterfinished"
    watch_kinds = ("Job",)

    def __init__(self, store, factory, now_fn=None):
        import time as _time

        super().__init__(store, factory)
        self.now_fn = now_fn or _time.monotonic

    def tick(self) -> None:
        for key, job in self.store.snapshot_map("Job").items():
            if job.condition and job.ttl_seconds_after_finished is not None:
                self.queue.add(key)

    def reconcile(self, key: str) -> None:
        job = self.store.get_object("Job", key)
        if job is None or not job.condition or job.ttl_seconds_after_finished is None:
            return
        finished = job.completion_time or job.start_time
        if self.now_fn() - finished >= job.ttl_seconds_after_finished:
            self.store.delete_object("Job", key)


def _pvc_in_use(store, pvc_key: str) -> bool:
    """Any non-terminal pod referencing the claim — directly via
    spec.volumes or through a generic ephemeral volume whose generated PVC
    name is <pod>-<volume> (pvc_protection's askInformer path, reduced)."""
    ns, _, name = pvc_key.partition("/")
    for p in store.snapshot_map("Pod").values():
        if p.meta.namespace != ns or p.status.phase in ("Succeeded", "Failed"):
            continue
        if name in p.spec.volumes:
            return True
        if any(f"{p.meta.name}-{vol}" == name for vol in p.spec.ephemeral_claims):
            return True
    return False


class PVCProtectionController(Controller):
    """pvcprotection: keep the pvc-protection finalizer on every live PVC;
    remove it from a terminating PVC only once no pod uses the claim — the
    deletion then completes (pkg/controller/volume/pvcprotection)."""

    name = "pvcprotection"
    watch_kinds = ("PersistentVolumeClaim", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "Pod":
            return ([f"{obj.meta.namespace}/{v}" for v in obj.spec.volumes]
                    + [f"{obj.meta.namespace}/{obj.meta.name}-{v}"
                       for v in obj.spec.ephemeral_claims])
        return [obj.meta.key()]

    def reconcile(self, key: str) -> None:
        pvc: Optional[PersistentVolumeClaim] = self.store.get_object(
            "PersistentVolumeClaim", key)
        if pvc is None:
            return
        fins = pvc.meta.finalizers
        if not pvc.meta.deletion_timestamp:
            if PVC_PROTECTION_FINALIZER not in fins:
                new = dataclasses.replace(pvc, meta=dataclasses.replace(
                    pvc.meta, finalizers=fins + (PVC_PROTECTION_FINALIZER,)))
                self.store.update_object("PersistentVolumeClaim", new)
            return
        if PVC_PROTECTION_FINALIZER in fins and not _pvc_in_use(self.store, key):
            new = dataclasses.replace(pvc, meta=dataclasses.replace(
                pvc.meta,
                finalizers=tuple(f for f in fins if f != PVC_PROTECTION_FINALIZER)))
            self.store.update_object("PersistentVolumeClaim", new)


class PVProtectionController(Controller):
    """pvprotection: same pattern for PVs — a PV bound to a claim cannot
    finish deleting (pkg/controller/volume/pvprotection)."""

    name = "pvprotection"
    watch_kinds = ("PersistentVolume",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.name]

    def reconcile(self, key: str) -> None:
        pv = self.store.get_object("PersistentVolume", key)
        if pv is None:
            return
        fins = pv.meta.finalizers
        if not pv.meta.deletion_timestamp:
            if PV_PROTECTION_FINALIZER not in fins:
                new = dataclasses.replace(pv, meta=dataclasses.replace(
                    pv.meta, finalizers=fins + (PV_PROTECTION_FINALIZER,)))
                self.store.update_object("PersistentVolume", new)
            return
        if PV_PROTECTION_FINALIZER in fins and not pv.bound_pvc:
            new = dataclasses.replace(pv, meta=dataclasses.replace(
                pv.meta,
                finalizers=tuple(f for f in fins if f != PV_PROTECTION_FINALIZER)))
            self.store.update_object("PersistentVolume", new)


class NodeIpamController(Controller):
    """nodeipam: allocate a /24 pod CIDR per node out of the cluster CIDR
    (pkg/controller/nodeipam range allocator, reduced to sequential /24s)."""

    name = "nodeipam"
    watch_kinds = ("Node",)

    def __init__(self, store, factory, cluster_cidr: str = "10.0.0.0/16"):
        super().__init__(store, factory)
        base, _, bits = cluster_cidr.partition("/")
        octets = [int(o) for o in base.split(".")]
        self._prefix = (octets[0] << 24) | (octets[1] << 16) | (octets[2] << 8) | octets[3]
        self._max_blocks = 1 << max(0, 24 - int(bits))
        self._next = 0
        self._free: List[int] = []          # released blocks, reused first
        self._assigned: dict = {}           # block -> node name
        self._node_block: dict = {}         # node name -> block

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.name]

    def _block_of(self, cidr: str) -> int:
        octets = [int(o) for o in cidr.split("/")[0].split(".")]
        addr = (octets[0] << 24) | (octets[1] << 16) | (octets[2] << 8) | octets[3]
        return (addr - self._prefix) >> 8

    def _alloc(self, name: str) -> Optional[str]:
        while self._free:
            block = self._free.pop()
            if block not in self._assigned:
                break
        else:
            block = None
            while self._next < self._max_blocks:
                cand = self._next
                self._next += 1
                if cand not in self._assigned:
                    block = cand
                    break
            if block is None:
                return None
        self._assigned[block] = name
        self._node_block[name] = block
        addr = self._prefix + (block << 8)
        return f"{addr >> 24 & 255}.{addr >> 16 & 255}.{addr >> 8 & 255}.0/24"

    def _release(self, name: str) -> None:
        block = self._node_block.pop(name, None)
        if block is not None and self._assigned.get(block) == name:
            del self._assigned[block]
            self._free.append(block)

    def reconcile(self, key: str) -> None:
        node = self.store.nodes.get(key)
        if node is None:
            # node deleted: return its block to the pool (range allocator
            # ReleaseCIDR)
            self._release(key)
            return
        if node.spec.pod_cidr:
            # re-learn allocations on restart (crash-only resync)
            block = self._block_of(node.spec.pod_cidr)
            if 0 <= block < self._max_blocks and key not in self._node_block:
                self._assigned[block] = key
                self._node_block[key] = block
            return
        cidr = self._alloc(key)
        if cidr is None:
            return  # range exhausted; the reference sets a node condition
        new = dataclasses.replace(node)
        new.meta = dataclasses.replace(node.meta)
        new.spec = dataclasses.replace(node.spec, pod_cidr=cidr)
        try:
            self.store.update_node(new)
        except Conflict:
            self._release(key)
            self.queue.add(key)


class EndpointSliceMirroringController(Controller):
    """endpointslicemirroring: user-managed Endpoints (their Service has no
    selector) are mirrored into EndpointSlices so slice consumers see them
    (pkg/controller/endpointslicemirroring)."""

    name = "endpointslicemirroring"
    watch_kinds = ("Endpoints", "Service")

    MIRROR_LABEL = "endpointslice.kubernetes.io/managed-by"

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.key()]

    def reconcile(self, key: str) -> None:
        ep = self.store.get_object("Endpoints", key)
        svc = self.store.get_object("Service", key)
        slice_key = f"{key}-mirror"
        existing = self.store.get_object("EndpointSlice", slice_key)
        # mirror only selector-less services' endpoints
        want = (ep is not None and svc is not None and not svc.selector)
        if not want:
            if existing is not None:
                self.store.delete_object("EndpointSlice", slice_key)
            return
        ns, _, name = key.partition("/")
        sl = EndpointSlice(
            meta=ObjectMeta(
                name=f"{name}-mirror", namespace=ns,
                labels={self.MIRROR_LABEL: "endpointslicemirroring-controller.k8s.io"},
                owner_references=(OwnerReference(
                    kind="Endpoints", name=name, controller=True),),
            ),
            service=key, addresses=ep.addresses)
        try:
            if existing is None:
                self.store.create_object("EndpointSlice", sl)
            elif existing.addresses != ep.addresses:
                sl.meta = dataclasses.replace(sl.meta)
                self.store.update_object("EndpointSlice", sl)
        except Conflict:
            pass


class EphemeralVolumeController(Controller):
    """ephemeral-volume: create the pod-owned PVC for every generic
    ephemeral volume entry; the PVC's lifetime is tied to the pod through
    its owner reference + the garbage collector
    (pkg/controller/volume/ephemeral)."""

    name = "ephemeral-volume"
    watch_kinds = ("Pod",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.key()] if obj.spec.ephemeral_claims else []

    def reconcile(self, key: str) -> None:
        pod = self.store.get_pod(key)
        if pod is None:
            return
        for vol in pod.spec.ephemeral_claims:
            claim_name = f"{pod.meta.name}-{vol}"
            pvc_key = f"{pod.meta.namespace}/{claim_name}"
            if self.store.get_object("PersistentVolumeClaim", pvc_key) is not None:
                continue
            try:
                self.store.create_pvc(PersistentVolumeClaim(meta=ObjectMeta(
                    name=claim_name, namespace=pod.meta.namespace,
                    owner_references=(OwnerReference(
                        kind="Pod", name=pod.meta.name, controller=True),))))
            except Conflict:
                pass

