"""The default scheduling profile (``default-scheduler``) of the scheduler
loop: its name, its queue-sort key, the cluster events its plugins register
(which failures each event wakes), and the plugin objects the loop calls
(``kubernetes_tpu/scheduler/scheduler.py:154-213`` and
``framework/registry.py:106-176``). The filters and scores of the batch
itself run on the device; the host keeps the rest of the default plugin
set, in its order:

  * QueueSort: Coscheduling (``sort_key``);
  * PreEnqueue: QuotaAdmission (``pre_enqueue``);
  * the batch's host gates at pop: QuotaAdmission's PreFilter, then
    Coscheduling's; the preemption dry run's PreFilters run QuotaAdmission,
    Coscheduling, the rest, then SlicePacking (``filters``);
  * PostFilter: DefaultPreemption (``preemption``);
  * the sequential path's PreScore and Score (``scores``);
  * Reserve: QuotaAdmission, VolumeBinding, DynamicResources, then
    Coscheduling (``reserve``), Unreserve in reverse (``unreserve``);
    VolumeBinding's and DynamicResources' work from the pod's PreFilter
    state, which a plain pod of a batch does not have (the JAX commit runs
    the PreFilters for volume and claim pods only);
  * Permit: Coscheduling; PreBind: VolumeBinding (``pre_bind``); PostBind:
    DynamicResources, then Coscheduling (``post_bind_batch``).

No plugin registry: one profile, the default plugin set.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Tuple

from ..api.types import Pod, PodDisruptionBudget
from ..queue.scheduling_queue import priority_sort_key
from .plugins import dynamicresources
from .plugins.coscheduling import Coscheduling, pod_group_key
from .plugins.defaultpreemption import DefaultPreemption
from .plugins.interpodaffinity import NsLabelsFn
from .plugins.quota import QuotaAdmission
from .plugins.slicepacking import SlicePacking
from .plugins.volume import VolumeBinding
from .runtime import FilterRunner, PodNominator, PreFilterState, ScoreRunner
from .types import (ADD, ALL, CSI_NODE, ClusterEvent, DELETE, NODE, NodeInfo, POD, PV, PVC,
                    RESOURCE_CLAIM, RESOURCE_CLASS, STORAGE_CLASS, UPDATE_NODE_ALLOCATABLE,
                    UPDATE_NODE_LABEL, UPDATE_NODE_TAINT, WILDCARD_EVENT)

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
    ClusterEvent(POD, DELETE): frozenset({"NodePorts", "NodeResourcesBalancedAllocation",
                                          "NodeResourcesFit"}),
    ClusterEvent(POD, ADD | DELETE): frozenset({"InterPodAffinity", "PodTopologySpread"}),
    ClusterEvent(RESOURCE_CLAIM, ALL, "ResourceClaimChange"): frozenset({"DynamicResources"}),
    ClusterEvent(RESOURCE_CLASS, _ADD_OR_UPDATE, "ResourceClassChange"): frozenset(
        {"DynamicResources"}),
    ClusterEvent(STORAGE_CLASS, ADD): frozenset({"VolumeBinding", "VolumeZone"}),
}
for _name, _plugin in (("Coscheduling", Coscheduling), ("QuotaAdmission", QuotaAdmission)):
    for _ev in _plugin.events_to_register():
        DEFAULT_EVENT_MAP[_ev] = DEFAULT_EVENT_MAP.get(_ev, frozenset()) | {_name}

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


# a Permit verdict: (None, None) allow, (None, seconds) wait, (reason, None) reject
PermitVerdict = Tuple[Optional[str], Optional[float]]


class Profile:
    """The default profile over one scheduler's cluster view. ``client``
    is the store (PDBs, PodGroups, SchedulingQuotas and the pods the
    plugins count); ``node_infos_fn`` lists the snapshot's nodes in the
    order the plugins walk them; ``evict(victim, preemptor)`` and
    ``clear_nomination(pod)`` are the scheduler's store writes for a
    preemption; ``bound_pods_fn`` lists the bound pods the quota ledger
    seeds from; ``waiting`` is the scheduler's waiting-pods handle."""

    name = DEFAULT_PROFILE
    sort_key = staticmethod(priority_sort_key)
    event_map = DEFAULT_EVENT_MAP

    def __init__(self, client, node_infos_fn: Callable[[], Iterable[NodeInfo]],
                 ns_labels_fn: Optional[NsLabelsFn],
                 evict: Callable[[Pod, Pod], None], clear_nomination: Callable[[Pod], None],
                 pdb_lister: Optional[Callable[[], Iterable[PodDisruptionBudget]]] = None,
                 bound_pods_fn: Optional[Callable[[], Iterable[Pod]]] = None,
                 metrics=None, now_fn=None, waiting=None):
        self.nominator = PodNominator()
        self.coscheduling = Coscheduling(client, now_fn=now_fn, metrics=metrics, waiting=waiting)
        self.quota = QuotaAdmission(client, bound_pods_fn or (lambda: ()), metrics=metrics,
                                    now_fn=now_fn)
        self.slice_packing = SlicePacking(node_infos_fn, client)
        self.sort_key = self.coscheduling.sort_key
        self.filters = FilterRunner(client, node_infos_fn, self.nominator, ns_labels_fn,
                                    self.quota, self.coscheduling, self.slice_packing)
        self.preemption = DefaultPreemption(self.filters, evict, clear_nomination, pdb_lister)
        self.scores = ScoreRunner(node_infos_fn, ns_labels_fn)
        self.client = client
        self.volume_binding = VolumeBinding(client)

    def pre_enqueue(self, pod: Pod):
        """The PreEnqueue point: None to admit, else the refusal."""
        return self.quota.pre_enqueue_status(pod)

    def reserve(self, pod: Pod, node_name: str,
                state: Optional[PreFilterState] = None) -> Optional[str]:
        """The Reserve point in order; the first refusal's reason, or None.
        A claim Reserve refuses releases what the pod took of its claims."""
        reason = self.quota.reserve(pod)
        if reason is not None or state is None:
            return reason
        self.volume_binding.reserve(pod, node_name, state.node_bindings)
        if state.claims:
            if dynamicresources.reserve(self.client, pod, node_name, state.claims) is not None:
                return dynamicresources.ERR_REASON_CANNOT_ALLOCATE
            state.allocated = [key for key, _claim, _sels in state.claims]
        return None

    def unreserve(self, pod: Pod, node_name: str,
                  state: Optional[PreFilterState] = None) -> None:
        """The Unreserve point, the Reserve plugins in reverse."""
        self.coscheduling.unreserve(pod)
        if state is not None and state.allocated:
            dynamicresources.unreserve(self.client, pod, state.allocated)
            state.allocated = []
        self.volume_binding.unreserve(pod)
        self.quota.unreserve(pod)

    def permit(self, pod: Pod, node_name: str) -> PermitVerdict:
        return self.coscheduling.permit(pod, node_name)

    def pre_bind(self, pod: Pod) -> Optional[str]:
        """The PreBind point: VolumeBinding's PV binds; the refusal's
        reason, or None."""
        return self.volume_binding.pre_bind(pod)

    def post_bind_batch(self, pods: List[Pod]) -> None:
        """The PostBind point for a batch's bound pods, each plugin over
        the batch in turn: each claim pod's PodSchedulingContext, then one
        bound-count bump and one status write per gang."""
        for pod in pods:
            dynamicresources.post_bind(self.client, pod, pod.spec.node_name)
        per_gang: Dict[str, int] = {}
        for pod in pods:
            gkey = pod_group_key(pod)
            if gkey is not None:
                per_gang[gkey] = per_gang.get(gkey, 0) + 1
        if per_gang:
            self.coscheduling.post_bind_batch(per_gang)
