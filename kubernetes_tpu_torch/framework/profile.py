"""The default scheduling profile (``default-scheduler``) of the scheduler
loop: its name, its queue-sort key, the cluster events its plugins register
(which failures each event wakes), and the plugin objects the loop calls
(``kubernetes_tpu/scheduler/scheduler.py:154-200`` and
``framework/registry.py:DEFAULT_PLUGINS``). The filters and scores of the
batch itself run on the device; the host keeps the nominator, the filter
runner of the preemption dry run and DefaultPreemption. No plugin registry:
one profile, the default plugin set.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Iterable, Optional

from ..api.types import Pod, PodDisruptionBudget
from ..queue.scheduling_queue import priority_sort_key
from .plugins.defaultpreemption import DefaultPreemption
from .plugins.interpodaffinity import NsLabelsFn
from .runtime import FilterRunner, PodNominator
from .types import (ADD, ALL, CSI_NODE, ClusterEvent, DELETE, NODE, NodeInfo, POD, POD_GROUP, PV,
                    PVC, RESOURCE_CLAIM, RESOURCE_CLASS, SCHEDULING_QUOTA, STORAGE_CLASS,
                    UPDATE_NODE_ALLOCATABLE, UPDATE_NODE_LABEL, UPDATE_NODE_TAINT,
                    WILDCARD_EVENT)

DEFAULT_PROFILE = "default-scheduler"

_ADD_OR_UPDATE = ALL & ~DELETE

# EventsToRegister of the default plugin set: registered event -> the
# plugins whose failures it may resolve (fillEventToPluginMap). Plugins that
# register nothing are moved by any event (the wildcard entry).
DEFAULT_EVENT_MAP: Dict[ClusterEvent, FrozenSet[str]] = {
    WILDCARD_EVENT: frozenset({"DefaultBinder", "DefaultPreemption", "ImageLocality",
                               "NodeName", "SlicePacking"}),
    ClusterEvent(CSI_NODE, ADD): frozenset({"NodeVolumeLimits"}),
    ClusterEvent(CSI_NODE, _ADD_OR_UPDATE): frozenset({"VolumeBinding"}),
    ClusterEvent(NODE, ADD): frozenset({"NodePorts"}),
    ClusterEvent(NODE, ADD | UPDATE_NODE_TAINT): frozenset({"NodeUnschedulable",
                                                             "TaintToleration"}),
    ClusterEvent(NODE, ADD | UPDATE_NODE_ALLOCATABLE): frozenset(
        {"NodeResourcesBalancedAllocation", "NodeResourcesFit"}),
    ClusterEvent(NODE, _ADD_OR_UPDATE): frozenset({"DynamicResources", "VolumeBinding",
                                                    "VolumeRestrictions", "VolumeZone"}),
    ClusterEvent(NODE, ADD | UPDATE_NODE_LABEL): frozenset({"InterPodAffinity", "NodeAffinity",
                                                             "PodTopologySpread"}),
    ClusterEvent(PV, ADD): frozenset({"NodeVolumeLimits"}),
    ClusterEvent(PV, _ADD_OR_UPDATE): frozenset({"VolumeBinding", "VolumeZone"}),
    ClusterEvent(PVC, ADD): frozenset({"NodeVolumeLimits", "VolumeZone"}),
    ClusterEvent(PVC, ADD | DELETE): frozenset({"VolumeRestrictions"}),
    ClusterEvent(PVC, _ADD_OR_UPDATE): frozenset({"VolumeBinding"}),
    ClusterEvent(POD, ADD, "PodAdd"): frozenset({"Coscheduling"}),
    ClusterEvent(POD, DELETE): frozenset({"NodePorts", "NodeResourcesBalancedAllocation",
                                          "NodeResourcesFit"}),
    ClusterEvent(POD, ADD | DELETE): frozenset({"InterPodAffinity", "PodTopologySpread"}),
    ClusterEvent(POD_GROUP, ALL, "PodGroupChange"): frozenset({"Coscheduling"}),
    ClusterEvent(RESOURCE_CLAIM, ALL, "ResourceClaimChange"): frozenset({"DynamicResources"}),
    ClusterEvent(RESOURCE_CLASS, _ADD_OR_UPDATE, "ResourceClassChange"): frozenset(
        {"DynamicResources"}),
    ClusterEvent(SCHEDULING_QUOTA, ALL, "SchedulingQuotaChange"): frozenset({"QuotaAdmission"}),
    ClusterEvent(STORAGE_CLASS, ADD): frozenset({"VolumeBinding", "VolumeZone"}),
}

# the batch program's first-fail ids (backend/batch.py), in filter config
# order: the plugin each names and the reason of its status
ATTRIBUTION_ORDER = (
    ("NodeUnschedulable", "node(s) were unschedulable"),
    ("NodeName", "node(s) didn't match the requested node name"),
    ("TaintToleration", "node(s) had untolerated taint"),
    ("NodeAffinity", "node(s) didn't match Pod's node affinity/selector"),
    ("NodePorts", "node(s) didn't have free ports for the requested pod ports"),
    ("NodeResourcesFit", "Insufficient resources"),
    ("PodTopologySpread", "node(s) didn't match pod topology spread constraints"),
    ("InterPodAffinity", "node(s) didn't match pod affinity/anti-affinity rules"),
    ("VolumeBinding", "node(s) didn't satisfy volume placement"),
    ("DynamicResources", "cannot allocate all claims"),
    ("SlicePacking", "node(s) outside the gang's planned torus slice"),
)


class Profile:
    """The default profile over one scheduler's cluster view. ``client``
    is the store (PDBs, and claims and volumes once the loop takes them);
    ``node_infos_fn`` lists the snapshot's nodes in the order the plugins
    walk them; ``evict(victim, preemptor)`` and ``clear_nomination(pod)``
    are the scheduler's store writes for a preemption."""

    name = DEFAULT_PROFILE
    sort_key = staticmethod(priority_sort_key)
    event_map = DEFAULT_EVENT_MAP

    def __init__(self, client, node_infos_fn: Callable[[], Iterable[NodeInfo]],
                 ns_labels_fn: Optional[NsLabelsFn],
                 evict: Callable[[Pod, Pod], None], clear_nomination: Callable[[Pod], None],
                 pdb_lister: Optional[Callable[[], Iterable[PodDisruptionBudget]]] = None):
        self.nominator = PodNominator()
        self.filters = FilterRunner(client, node_infos_fn, self.nominator, ns_labels_fn)
        self.preemption = DefaultPreemption(self.filters, evict, clear_nomination, pdb_lister)
