"""The exact volume filters the batched path re-runs on a chosen node.

An own copy, as plain functions over (store, pod, NodeInfo), of the volume
filters of ``kubernetes_tpu/framework/plugins/volume.py`` that the default
filter list holds, in its order: VolumeRestrictions (and its PreFilter),
NodeVolumeLimits, VolumeBinding's Filter for bound claims (and its
PreFilter), and VolumeZone. Each returns None when it passes, else the
plugin's reason. ``verify_on_node`` runs the four on one node, as
``TPUScheduler._verify_volumes_on_node`` does after the device's
over-admitting screen (``ops/volume_mask.py``).

A pod's volumes are PVC names (api/types.py PodSpec.volumes); PVs carry
topology as required label matches. Delayed (WaitForFirstConsumer) binding
is not here: it needs VolumeBinding's Reserve / PreBind bind tail.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ...api.types import BINDING_WAIT_FOR_FIRST_CONSUMER, RWOP, PersistentVolumeClaim, Pod
from ...ops.volume_mask import ZONE_KEYS
from ..types import NodeInfo

ERR_REASON_NOT_BOUND = "pod has unbound immediate PersistentVolumeClaims"
ERR_REASON_PVC_NOT_FOUND = "persistentvolumeclaim not found"
ERR_REASON_CONFLICT = "node(s) had volume node affinity conflict"
ERR_REASON_RWOP = "pod uses a ReadWriteOncePod PVC already in use"
ERR_REASON_LIMIT = "node(s) exceed max volume count"
ERR_REASON_ZONE = "node(s) had no available volume zone"


def pod_pvcs(client, pod: Pod) -> Tuple[List[PersistentVolumeClaim], Optional[str]]:
    """The pod's PVCs; (claims, the first missing claim name or None)."""
    claims = []
    for name in pod.spec.volumes:
        pvc = client.get_pvc(f"{pod.meta.namespace}/{name}")
        if pvc is None:
            return [], name
        claims.append(pvc)
    return claims, None


# ----------------------------------------------------------------- VolumeZone


def volume_zone_filter(client, pod: Pod, ni: NodeInfo) -> Optional[str]:
    """Every bound PV's zone/region labels must match the node's
    (volume_zone.go:88)."""
    if not pod.spec.volumes:
        return None
    claims, missing = pod_pvcs(client, pod)
    if missing is not None:
        return ERR_REASON_PVC_NOT_FOUND
    labels = ni.node.meta.labels
    for pvc in claims:
        if not pvc.bound_pv:
            continue  # unbound claims are VolumeBinding's
        pv = client.get_pv(pvc.bound_pv)
        if pv is None:
            continue
        for key in ZONE_KEYS:
            pv_val = pv.meta.labels.get(key)
            if pv_val is not None and labels.get(key) not in set(pv_val.split("__")):
                return ERR_REASON_ZONE
    return None


# --------------------------------------------------------- VolumeRestrictions


def volume_restrictions_pre_filter(client, pod: Pod, node_infos: Iterable[NodeInfo]
                                   ) -> Tuple[Set[str], Optional[str]]:
    """(the pod's ReadWriteOncePod claim keys, reason): a RWOP claim in use
    by any pod of the cluster rejects the pod outright
    (volume_restrictions.go:149-152)."""
    claims, missing = pod_pvcs(client, pod)
    if missing is not None:
        return set(), ERR_REASON_PVC_NOT_FOUND
    rwop = {pvc.meta.key() for pvc in claims if RWOP in pvc.access_modes}
    if rwop:
        for ni in node_infos:
            if any(ni.pvc_ref_counts.get(key, 0) > 0 for key in rwop):
                return rwop, ERR_REASON_RWOP
    return rwop, None


def volume_restrictions_filter(rwop: Set[str], ni: NodeInfo) -> Optional[str]:
    """The per-node re-check of the PreFilter's RWOP claims."""
    if any(ni.pvc_ref_counts.get(key, 0) > 0 for key in rwop):
        return ERR_REASON_RWOP
    return None


# ----------------------------------------------------------- NodeVolumeLimits


def _driver_of(client, pvc: PersistentVolumeClaim) -> Optional[str]:
    sc = client.get_storage_class(pvc.storage_class)
    return sc.provisioner if sc else None


def node_volume_limits_filter(client, pod: Pod, ni: NodeInfo) -> Optional[str]:
    """Per-driver attachable-volume limit from the node's CSINode: the
    node's volumes plus the pod's new ones must fit (csi.go:220)."""
    if not pod.spec.volumes:
        return None
    csinode = client.get_csinode(ni.node.meta.name)
    if csinode is None or not csinode.drivers:
        return None  # no limits known for this node
    claims, missing = pod_pvcs(client, pod)
    if missing is not None:
        return ERR_REASON_PVC_NOT_FOUND
    new_by_driver: Dict[str, set] = {}
    for pvc in claims:
        d = _driver_of(client, pvc)
        if d is not None and d in csinode.drivers:
            new_by_driver.setdefault(d, set()).add(pvc.meta.key())
    if not new_by_driver:
        return None
    used_by_driver: Dict[str, set] = {}
    for p in ni.pods:
        for vol in p.spec.volumes:
            pvc = client.get_pvc(f"{p.meta.namespace}/{vol}")
            if pvc is None:
                continue
            d = _driver_of(client, pvc)
            if d is not None and d in csinode.drivers:
                used_by_driver.setdefault(d, set()).add(pvc.meta.key())
    for driver, new_set in new_by_driver.items():
        if len(used_by_driver.get(driver, set()) | new_set) > csinode.drivers[driver]:
            return ERR_REASON_LIMIT
    return None


# -------------------------------------------------------------- VolumeBinding


def volume_binding_pre_filter(client, pod: Pod) -> Tuple[List[PersistentVolumeClaim],
                                                         Optional[str]]:
    """(the pod's bound claims, reason) (volume_binding.go:168): a missing
    claim or an unbound immediate-mode one rejects the pod. A delayed
    (WaitForFirstConsumer) claim raises NotImplementedError: binding it
    needs the bind tail."""
    claims, missing = pod_pvcs(client, pod)
    if missing is not None:
        return [], f'{ERR_REASON_PVC_NOT_FOUND} "{missing}"'
    bound, unbound_immediate, delayed = [], [], []
    for pvc in claims:
        if pvc.bound_pv:
            bound.append(pvc)
            continue
        sc = client.get_storage_class(pvc.storage_class)
        if sc is not None and sc.volume_binding_mode == BINDING_WAIT_FOR_FIRST_CONSUMER:
            delayed.append(pvc)
        else:
            unbound_immediate.append(pvc)
    if unbound_immediate:
        return [], ERR_REASON_NOT_BOUND
    if delayed:
        raise NotImplementedError(
            f"pod {pod.key()}: delayed (WaitForFirstConsumer) claim {delayed[0].meta.key()}")
    return bound, None


def volume_binding_filter(client, bound: List[PersistentVolumeClaim],
                          ni: NodeInfo) -> Optional[str]:
    """Each bound claim's PV must admit the node by its node affinity
    (volume_binding.go:224)."""
    for pvc in bound:
        pv = client.get_pv(pvc.bound_pv)
        if pv is not None and not pv.matches_node(ni.node):
            return ERR_REASON_CONFLICT
    return None


# -------------------------------------------------------------- the commit check


def verify_on_node(client, pod: Pod, ni: NodeInfo, rwop: Set[str],
                   bound: List[PersistentVolumeClaim]) -> Optional[str]:
    """The exact volume filters on one node, in the default filter order:
    VolumeRestrictions, NodeVolumeLimits, VolumeBinding, VolumeZone. ``rwop``
    and ``bound`` are the two PreFilters' results."""
    return (volume_restrictions_filter(rwop, ni)
            or node_volume_limits_filter(client, pod, ni)
            or volume_binding_filter(client, bound, ni)
            or volume_zone_filter(client, pod, ni))
