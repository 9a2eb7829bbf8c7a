"""The volume plugins: their checks as plain functions, and the plugin
objects with VolumeBinding's bind tail.

An own copy, over (store, pod, NodeInfo), of the volume plugins of
``kubernetes_tpu/framework/plugins/volume.py``: the four of the default
filter list, in its order, VolumeRestrictions (and its PreFilter),
NodeVolumeLimits, VolumeBinding (PreFilter ``:284``, Filter ``:304``) and
VolumeZone, and the in-tree attach limits no default list holds
(``NonCSILimits``: EBSLimits, GCEPDLimits, AzureDiskLimits, CinderLimits,
``:404-500``). Each check returns None when it passes, else the plugin's
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

import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ...api.types import (BINDING_WAIT_FOR_FIRST_CONSUMER, RWOP, Node, PersistentVolumeClaim,
                          Pod)
from ...apiserver.store import Conflict, NotFound
from ...ops.volume_mask import ZONE_KEYS
from ..interface import Fail
from ..types import (ADD, CSI_NODE, DELETE, NODE, PV, PVC, STORAGE_CLASS, UPDATE, ClusterEvent,
                     NodeInfo)
from . import names

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


# ----------------------------------------------------------------- the plugin objects


class VolumeZone:
    def __init__(self, client=None):
        self.client = client

    def name(self) -> str:
        return names.VOLUME_ZONE

    @staticmethod
    def events_to_register():
        return [ClusterEvent(STORAGE_CLASS, ADD), ClusterEvent(NODE, ADD | UPDATE),
                ClusterEvent(PVC, ADD), ClusterEvent(PV, ADD | UPDATE)]

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = volume_zone_filter(self.client, pod, ni)
        return None if reason is None else Fail(names.VOLUME_ZONE, reason, True)


class VolumeRestrictions:
    def __init__(self, client=None, snapshot_fn=None):
        self.client = client
        self.snapshot_fn = snapshot_fn or (lambda: ())

    def name(self) -> str:
        return names.VOLUME_RESTRICTIONS

    @staticmethod
    def events_to_register():
        return [ClusterEvent(PVC, ADD | DELETE), ClusterEvent(NODE, ADD | UPDATE)]

    def pre_filter(self, state, pod: Pod):
        if pod.spec.volumes:
            state.rwop, reason = volume_restrictions_pre_filter(self.client, pod,
                                                                self.snapshot_fn())
            if reason is not None:
                return None, Fail(names.VOLUME_RESTRICTIONS, reason, True)
        return None, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = volume_restrictions_filter(state.rwop, ni)
        return None if reason is None else Fail(names.VOLUME_RESTRICTIONS, reason, True)


class NodeVolumeLimits:
    def __init__(self, client=None):
        self.client = client

    def name(self) -> str:
        return names.NODE_VOLUME_LIMITS

    @staticmethod
    def events_to_register():
        return [ClusterEvent(CSI_NODE, ADD), ClusterEvent(PVC, ADD), ClusterEvent(PV, ADD)]

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = node_volume_limits_filter(self.client, pod, ni)
        if reason is None:
            return None
        return Fail(names.NODE_VOLUME_LIMITS, reason, reason != ERR_REASON_LIMIT)


class VolumeBinding:
    """VolumeBinding's PreFilter and Filter over the functions above, its
    Score, and its bind tail: Reserve assumes the chosen node's (PV, PVC)
    pairs for the pod, Unreserve forgets them, PreBind writes each through
    the store's ``bind_pv``. A pod without PreFilter state (a plain pod of
    a batch) reserves nothing."""

    def __init__(self, client=None):
        self.client = client
        self._assumed: Dict[str, List[Binding]] = {}

    def name(self) -> str:
        return names.VOLUME_BINDING

    @staticmethod
    def events_to_register():
        return [ClusterEvent(PV, ADD | UPDATE), ClusterEvent(PVC, ADD | UPDATE),
                ClusterEvent(STORAGE_CLASS, ADD), ClusterEvent(NODE, ADD | UPDATE),
                ClusterEvent(CSI_NODE, ADD | UPDATE)]

    def pre_filter(self, state, pod: Pod):
        if pod.spec.volumes:
            state.bound, state.delayed, reason = volume_binding_pre_filter(self.client, pod)
            if reason is not None:
                return None, Fail(names.VOLUME_BINDING, reason, True)
        return None, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        if not state.bound and not state.delayed:
            return None
        reason = volume_binding_filter(self.client, state.bound, ni, state.delayed,
                                       state.node_bindings)
        if reason is None:
            return None
        return Fail(names.VOLUME_BINDING, reason, reason != ERR_REASON_NO_PV)

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        """0: the score sits behind the VolumeCapacityPriority feature
        gate, off in the JAX package (volume_binding.go:296)."""
        return 0

    def reserve(self, state, pod: Pod, node_name: str) -> Optional[str]:
        if state is not None:
            self._assumed[pod.key()] = state.node_bindings.get(node_name, [])
        return None

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        self._assumed.pop(pod.key(), None)

    def pre_bind(self, state, pod: Pod, node_name: str) -> Optional[str]:
        """Bind the pod's assumed pairs in order; the first failure's
        reason (another pod bound the PV first), else None."""
        for pv_name, pvc_key in self._assumed.pop(pod.key(), []):
            try:
                self.client.bind_pv(pv_name, pvc_key)
            except (Conflict, NotFound) as err:
                return f"binding volumes: {err}"
        return None


# the in-tree attach limits per volume type (non_csi.go:45-51)
NON_CSI_DEFAULT_LIMITS = {"ebs": 39, "gce-pd": 16, "azure-disk": 16, "cinder": 256}
KUBE_MAX_PD_VOLS = "KUBE_MAX_PD_VOLS"  # the environment override (non_csi.go:66)


class NonCSILimits:
    """The unique volumes of one in-tree type (PVs with ``volume_type``)
    on the node's pods plus the pod's must stay within the node's limit:
    its ``attachable-volumes-<type>`` allocatable, else
    ``$KUBE_MAX_PD_VOLS``, else the type's default (non_csi.go:210)."""

    def __init__(self, name: str, volume_type: str, client=None):
        self._name = name
        self.volume_type = volume_type
        self.client = client

    def name(self) -> str:
        return self._name

    @staticmethod
    def events_to_register():
        return [ClusterEvent(NODE, ADD), ClusterEvent(PVC, ADD), ClusterEvent(PV, ADD)]

    def _typed_pv_of_claim(self, pvc: PersistentVolumeClaim) -> Optional[str]:
        pv = self.client.get_pv(pvc.bound_pv) if pvc.bound_pv else None
        return pv.meta.name if pv is not None and pv.volume_type == self.volume_type else None

    def _max_volumes(self, ni: NodeInfo) -> int:
        from_node = ni.node.status.allocatable.get(f"attachable-volumes-{self.volume_type}")
        if from_node is not None:
            return int(from_node)
        env = os.environ.get(KUBE_MAX_PD_VOLS, "")
        if env.isdigit() and int(env) > 0:
            return int(env)
        return NON_CSI_DEFAULT_LIMITS[self.volume_type]

    def pre_filter(self, state, pod: Pod):
        claims, missing = pod_pvcs(self.client, pod)
        if missing is not None:
            return None, Fail(self._name, ERR_REASON_PVC_NOT_FOUND, True)
        state.data[self._name] = {name for pvc in claims
                                  if (name := self._typed_pv_of_claim(pvc)) is not None}
        return None, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        new_vols = state.data.get(self._name)
        if new_vols is None:
            return Fail(self._name, f"reading {'PreFilter' + self._name!r} from cycleState", True)
        if not new_vols:
            return None
        existing = set()
        for pvc_key in ni.pvc_ref_counts:
            pvc = self.client.get_pvc(pvc_key)
            name = self._typed_pv_of_claim(pvc) if pvc is not None else None
            if name is not None:
                existing.add(name)
        if len(existing | new_vols) > self._max_volumes(ni):
            return Fail(self._name, ERR_REASON_LIMIT, False)
        return None


def make_ebs_limits(client=None) -> NonCSILimits:
    return NonCSILimits(names.EBS_LIMITS, "ebs", client)


def make_gce_pd_limits(client=None) -> NonCSILimits:
    return NonCSILimits(names.GCE_PD_LIMITS, "gce-pd", client)


def make_azure_disk_limits(client=None) -> NonCSILimits:
    return NonCSILimits(names.AZURE_DISK_LIMITS, "azure-disk", client)


def make_cinder_limits(client=None) -> NonCSILimits:
    return NonCSILimits(names.CINDER_LIMITS, "cinder", client)
