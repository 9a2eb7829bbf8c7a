"""A small in-memory object store for the DRA, volume and gang paths.

The part of ``kubernetes_tpu/apiserver/store.py``'s ``ClusterStore`` that
the claim and volume screens and their commit-time checks read and write:
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
informers, admission or locking: one scheduler thread owns it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..api.types import (CSINode, PersistentVolume, PersistentVolumeClaim,
                         PodDisruptionBudget, PodGroup, ResourceClaim, SchedulingQuota,
                         StorageClass)


class Conflict(Exception):
    """409: the object exists, or a claim is allocated to another node."""


class NotFound(Exception):
    """404."""


_CLUSTER_SCOPED = frozenset(("ResourceClass",))


class Store:
    def __init__(self):
        self._rv = 0
        self._kind_rv: Dict[str, int] = {}
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
