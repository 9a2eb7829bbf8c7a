"""The in-tree plugin registry and the default plugin configuration.

An own copy of ``kubernetes_tpu/framework/registry.py`` (plugins/
registry.go:46, name -> factory; apis/config/v1beta3/default_plugins.go:
32-51, the default set and its weights). A factory takes ``(handle,
args)``: ``handle`` is the profile's dict of the scheduler's services
(``snapshot_fn`` lists the NodeInfos, ``ns_labels_fn``, ``client`` the
store, ``metrics``, ``now_fn``, ``waiting_pods``, ``bound_pods_fn``, the
preemption writes ``evict`` and ``clear_nomination``, and the scheduler's
``extenders``, which DefaultPreemption hands its Evaluator), ``args`` the
profile's pluginConfig block for the plugin, with the JAX registry's
snake_case keys. ``DEFAULT_PLUGINS`` equals the JAX package's, name for
name, order for order, weight for weight: the queue's order, the
Diagnosis and the event map follow it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from .plugins import names
from .plugins.basic import NodeName, NodePorts, NodeUnschedulable, PrioritySort, TaintToleration
from .plugins.coscheduling import Coscheduling
from .plugins.defaultbinder import DefaultBinder
from .plugins.defaultpreemption import DefaultPreemption
from .plugins.dynamicresources import DynamicResources
from .plugins.imagelocality import ImageLocality
from .plugins.interpodaffinity import InterPodAffinity
from .plugins.nodeaffinity import NodeAffinity
from .plugins.noderesources import DEFAULT_RESOURCES, BalancedAllocation, Fit
from .plugins.podtopologyspread import PodTopologySpread
from .plugins.quota import QuotaAdmission
from .plugins.selectorspread import SelectorSpread
from .plugins.slicepacking import SlicePacking
from .plugins.volume import (NodeVolumeLimits, VolumeBinding, VolumeRestrictions, VolumeZone,
                             make_azure_disk_limits, make_cinder_limits, make_ebs_limits,
                             make_gce_pd_limits)

Factory = Callable[[dict, dict], object]  # (handle, args) -> plugin


def _pdb_lister(h: dict):
    client = h.get("client")
    return client.list_pdbs if client is not None and hasattr(client, "list_pdbs") else None


def in_tree_registry() -> Dict[str, Factory]:
    return {
        names.PRIORITY_SORT: lambda h, a: PrioritySort(),
        names.NODE_UNSCHEDULABLE: lambda h, a: NodeUnschedulable(),
        names.NODE_NAME: lambda h, a: NodeName(),
        names.TAINT_TOLERATION: lambda h, a: TaintToleration(),
        names.NODE_PORTS: lambda h, a: NodePorts(),
        names.NODE_AFFINITY: lambda h, a: NodeAffinity(added_affinity=a.get("added_affinity")),
        names.NODE_RESOURCES_FIT: lambda h, a: Fit(
            strategy=a.get("strategy", "LeastAllocated"),
            resources=tuple(a.get("resources", DEFAULT_RESOURCES)),
            shape=tuple(a.get("shape", ()))),
        names.NODE_RESOURCES_BALANCED_ALLOCATION: lambda h, a: BalancedAllocation(
            resources=tuple(a.get("resources", DEFAULT_RESOURCES))),
        names.IMAGE_LOCALITY: lambda h, a: ImageLocality(snapshot_fn=h.get("snapshot_fn")),
        names.POD_TOPOLOGY_SPREAD: lambda h, a: PodTopologySpread(
            snapshot_fn=h.get("snapshot_fn"),
            default_constraints=tuple(a.get("default_constraints", ())),
            system_defaulted=a.get("system_defaulted", False)),
        names.INTER_POD_AFFINITY: lambda h, a: InterPodAffinity(
            snapshot_fn=h.get("snapshot_fn"), ns_labels_fn=h.get("ns_labels_fn"),
            hard_pod_affinity_weight=a.get("hard_pod_affinity_weight", 1)),
        names.DEFAULT_BINDER: lambda h, a: DefaultBinder(client=h.get("client")),
        names.VOLUME_ZONE: lambda h, a: VolumeZone(client=h.get("client")),
        names.VOLUME_RESTRICTIONS: lambda h, a: VolumeRestrictions(
            client=h.get("client"), snapshot_fn=h.get("snapshot_fn")),
        names.NODE_VOLUME_LIMITS: lambda h, a: NodeVolumeLimits(client=h.get("client")),
        names.EBS_LIMITS: lambda h, a: make_ebs_limits(client=h.get("client")),
        names.GCE_PD_LIMITS: lambda h, a: make_gce_pd_limits(client=h.get("client")),
        names.AZURE_DISK_LIMITS: lambda h, a: make_azure_disk_limits(client=h.get("client")),
        names.CINDER_LIMITS: lambda h, a: make_cinder_limits(client=h.get("client")),
        names.SELECTOR_SPREAD: lambda h, a: SelectorSpread(
            store=h.get("client"), snapshot_fn=h.get("snapshot_fn")),
        names.VOLUME_BINDING: lambda h, a: VolumeBinding(client=h.get("client")),
        names.DYNAMIC_RESOURCES: lambda h, a: DynamicResources(client=h.get("client")),
        names.QUOTA_ADMISSION: lambda h, a: QuotaAdmission(
            h.get("client"), h.get("bound_pods_fn") or (lambda: ()), metrics=h.get("metrics"),
            now_fn=h.get("now_fn")),
        names.SLICE_PACKING: lambda h, a: SlicePacking(
            h.get("snapshot_fn") or (lambda: ()), client=h.get("client")),
        names.COSCHEDULING: lambda h, a: Coscheduling(
            h.get("client"), metrics=h.get("metrics"), waiting=h.get("waiting_pods"),
            now_fn=h.get("now_fn"),
            permit_timeout_s=a.get("permit_timeout_s", Coscheduling.DEFAULT_PERMIT_TIMEOUT_S),
            gang_backoff_s=a.get("gang_backoff_s", Coscheduling.DEFAULT_GANG_BACKOFF_S)),
        names.DEFAULT_PREEMPTION: lambda h, a: DefaultPreemption(
            None, h.get("evict"), h.get("clear_nomination"), _pdb_lister(h),
            min_candidate_nodes_percentage=a.get("min_candidate_nodes_percentage", 10),
            min_candidate_nodes_absolute=a.get("min_candidate_nodes_absolute", 100),
            seed=a.get("seed", 0), extenders=h.get("extenders", ())),
    }


# (plugin name, weight) per extension point (default_plugins.go:32-51)
DEFAULT_PLUGINS: Dict[str, List[Tuple[str, int]]] = {
    # Coscheduling's key sorts a gang's members together and degrades to
    # PrioritySort's for a pod without a PodGroup
    "queue_sort": [(names.COSCHEDULING, 0)],
    # the queue's admission gate: an over-quota pod parks gated
    "pre_enqueue": [(names.QUOTA_ADMISSION, 0)],
    "pre_filter": [
        # the namespace-level fast fails first
        (names.QUOTA_ADMISSION, 0),
        (names.COSCHEDULING, 0),
        (names.NODE_AFFINITY, 0),
        (names.NODE_PORTS, 0),
        (names.NODE_RESOURCES_FIT, 0),
        (names.VOLUME_RESTRICTIONS, 0),
        (names.POD_TOPOLOGY_SPREAD, 0),
        (names.INTER_POD_AFFINITY, 0),
        (names.VOLUME_BINDING, 0),
        (names.DYNAMIC_RESOURCES, 0),
        # the slice plan last, after every cheaper fast fail
        (names.SLICE_PACKING, 0),
    ],
    "filter": [
        (names.NODE_UNSCHEDULABLE, 0),
        (names.NODE_NAME, 0),
        (names.TAINT_TOLERATION, 0),
        (names.NODE_AFFINITY, 0),
        (names.NODE_PORTS, 0),
        (names.NODE_RESOURCES_FIT, 0),
        (names.VOLUME_RESTRICTIONS, 0),
        (names.NODE_VOLUME_LIMITS, 0),
        (names.VOLUME_BINDING, 0),
        (names.VOLUME_ZONE, 0),
        (names.POD_TOPOLOGY_SPREAD, 0),
        (names.INTER_POD_AFFINITY, 0),
        (names.DYNAMIC_RESOURCES, 0),
        (names.SLICE_PACKING, 0),
    ],
    "post_filter": [(names.DEFAULT_PREEMPTION, 0)],
    "pre_score": [
        (names.TAINT_TOLERATION, 0),
        (names.NODE_AFFINITY, 0),
        (names.POD_TOPOLOGY_SPREAD, 0),
        (names.INTER_POD_AFFINITY, 0),
        (names.IMAGE_LOCALITY, 0),
    ],
    "score": [
        (names.NODE_RESOURCES_BALANCED_ALLOCATION, 1),
        (names.IMAGE_LOCALITY, 1),
        (names.INTER_POD_AFFINITY, 2),
        (names.NODE_RESOURCES_FIT, 1),
        (names.NODE_AFFINITY, 2),
        (names.POD_TOPOLOGY_SPREAD, 2),
        (names.TAINT_TOLERATION, 3),
    ],
    # the quota charge first, so its Unreserve runs last
    "reserve": [(names.QUOTA_ADMISSION, 0), (names.VOLUME_BINDING, 0),
                (names.DYNAMIC_RESOURCES, 0), (names.COSCHEDULING, 0)],
    "permit": [(names.COSCHEDULING, 0)],
    "pre_bind": [(names.VOLUME_BINDING, 0)],
    "bind": [(names.DEFAULT_BINDER, 0)],
    "post_bind": [(names.DYNAMIC_RESOURCES, 0), (names.COSCHEDULING, 0)],
}
