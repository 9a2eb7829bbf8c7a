"""The volume plugins of the default profile as plain functions, and
VolumeBinding's bind tail.

An own copy, over (store, pod, NodeInfo), of the volume plugins of
``kubernetes_tpu/framework/plugins/volume.py`` that the default filter
list holds, in its order: VolumeRestrictions (and its PreFilter),
NodeVolumeLimits, VolumeBinding (PreFilter ``:284``, Filter ``:304``) and
VolumeZone. Each check returns None when it passes, else the plugin's
reason. ``verify_on_node`` runs the four on one node, as
``TPUScheduler._verify_volumes_on_node`` does after the device's
over-admitting screen (``ops/volume_mask.py``).

VolumeBinding's PreFilter splits the pod's claims into bound ones, whose
PV must admit the node, and delayed (WaitForFirstConsumer) ones; its
Filter matches each delayed claim to the smallest free PV of its class
that fits and admits the node (``find_matching_volumes``), and records
the node's choice. ``VolumeBinding`` holds the bind tail (``:369-391``):
Reserve assumes the chosen node's (PV, PVC) pairs for the pod, Unreserve
forgets them, PreBind writes each through the store's ``bind_pv``. Like
the JAX plugin, the Filter does not see another pod's assumed pairs: two
pods may choose one PV, and the second's PreBind then meets a Conflict.

A pod's volumes are PVC names (api/types.py PodSpec.volumes); PVs carry
topology as required label matches. No plugin reads a pod's generic
ephemeral volumes (``spec.ephemeral_claims``), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ...api.types import (BINDING_WAIT_FOR_FIRST_CONSUMER, RWOP, Node, PersistentVolumeClaim,
                          Pod)
from ...apiserver.store import Conflict, NotFound
from ...ops.volume_mask import ZONE_KEYS
from ..types import NodeInfo

ERR_REASON_NOT_BOUND = "pod has unbound immediate PersistentVolumeClaims"
ERR_REASON_PVC_NOT_FOUND = "persistentvolumeclaim not found"
ERR_REASON_CONFLICT = "node(s) had volume node affinity conflict"
ERR_REASON_RWOP = "pod uses a ReadWriteOncePod PVC already in use"
ERR_REASON_LIMIT = "node(s) exceed max volume count"
ERR_REASON_ZONE = "node(s) had no available volume zone"
ERR_REASON_NO_PV = "node(s) didn't find available persistent volumes to bind"

# a delayed claim's choice on one node: (PV name, PVC key)
Binding = Tuple[str, str]


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


def volume_binding_pre_filter(client, pod: Pod
                              ) -> Tuple[List[PersistentVolumeClaim],
                                         List[PersistentVolumeClaim], Optional[str]]:
    """(the pod's bound claims, its delayed claims, reason)
    (volume_binding.go:168): a missing claim or an unbound immediate-mode
    one rejects the pod."""
    claims, missing = pod_pvcs(client, pod)
    if missing is not None:
        return [], [], f'{ERR_REASON_PVC_NOT_FOUND} "{missing}"'
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
        return [], [], ERR_REASON_NOT_BOUND
    return bound, delayed, None


def find_matching_volumes(client, delayed: List[PersistentVolumeClaim],
                          node: Node) -> Optional[List[Binding]]:
    """binder.go findMatchingVolumes: per delayed claim in order, the
    smallest unbound PV of its class that holds its request and admits the
    node, none taken twice; None when a claim finds none."""
    chosen: List[Binding] = []
    taken: Set[str] = set()
    for pvc in delayed:
        best = None
        for pv in client.list_pvs():
            if pv.bound_pvc or pv.meta.name in taken or pv.storage_class != pvc.storage_class:
                continue
            if pvc.requested_bytes and pv.capacity_bytes < pvc.requested_bytes:
                continue
            if not pv.matches_node(node):
                continue
            if best is None or pv.capacity_bytes < best.capacity_bytes:
                best = pv
        if best is None:
            return None
        taken.add(best.meta.name)
        chosen.append((best.meta.name, pvc.meta.key()))
    return chosen


def volume_binding_filter(client, bound: List[PersistentVolumeClaim], ni: NodeInfo,
                          delayed: List[PersistentVolumeClaim] = (),
                          node_bindings: Optional[Dict[str, List[Binding]]] = None
                          ) -> Optional[str]:
    """Each bound claim's PV must admit the node by its node affinity
    (volume_binding.go:224), and every delayed claim must find a PV on it;
    the node's choice goes to ``node_bindings``."""
    for pvc in bound:
        pv = client.get_pv(pvc.bound_pv)
        if pv is not None and not pv.matches_node(ni.node):
            return ERR_REASON_CONFLICT
    if not delayed:
        return None
    chosen = find_matching_volumes(client, delayed, ni.node)
    if chosen is None:
        return ERR_REASON_NO_PV
    if node_bindings is not None:
        node_bindings[ni.node.meta.name] = chosen
    return None


class VolumeBinding:
    """VolumeBinding's Reserve, Unreserve and PreBind: the (PV, PVC) pairs
    assumed per pod between its Reserve and its PreBind."""

    def __init__(self, client):
        self.client = client
        self._assumed: Dict[str, List[Binding]] = {}

    def reserve(self, pod: Pod, node_name: str,
                node_bindings: Dict[str, List[Binding]]) -> None:
        self._assumed[pod.key()] = node_bindings.get(node_name, [])

    def unreserve(self, pod: Pod) -> None:
        self._assumed.pop(pod.key(), None)

    def pre_bind(self, pod: Pod) -> Optional[str]:
        """Bind the pod's assumed pairs in order; the first failure's
        reason (another pod bound the PV first), else None."""
        for pv_name, pvc_key in self._assumed.pop(pod.key(), []):
            try:
                self.client.bind_pv(pv_name, pvc_key)
            except (Conflict, NotFound) as err:
                return f"binding volumes: {err}"
        return None


# -------------------------------------------------------------- the commit check


def verify_on_node(client, pod: Pod, ni: NodeInfo, rwop: Set[str],
                   bound: List[PersistentVolumeClaim],
                   delayed: List[PersistentVolumeClaim] = (),
                   node_bindings: Optional[Dict[str, List[Binding]]] = None
                   ) -> Optional[Tuple[str, str]]:
    """The exact volume filters on one node, in the default filter order:
    VolumeRestrictions, NodeVolumeLimits, VolumeBinding, VolumeZone; the
    first failure's (plugin, reason), else None. ``rwop``, ``bound`` and
    ``delayed`` are the PreFilters' results; VolumeBinding records the
    node's delayed choice in ``node_bindings``."""
    checks = (
        ("VolumeRestrictions", lambda: volume_restrictions_filter(rwop, ni)),
        ("NodeVolumeLimits", lambda: node_volume_limits_filter(client, pod, ni)),
        ("VolumeBinding", lambda: volume_binding_filter(client, bound, ni, delayed,
                                                        node_bindings)),
        ("VolumeZone", lambda: volume_zone_filter(client, pod, ni)),
    )
    for plugin, check in checks:
        reason = check()
        if reason is not None:
            return plugin, reason
    return None
