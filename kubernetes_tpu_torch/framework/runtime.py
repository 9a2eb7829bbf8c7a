"""The pod nominator and the filter chain the preemption dry run runs.

An own copy of the part of ``kubernetes_tpu/framework/runtime.py`` that
preemption reads: ``PodNominator`` (``:37-58``), the PreFilters run once
per pod, the Filters in the default order (``framework/registry.py:116-150``)
and ``filter_with_nominated_pods``, the two-pass filter of
``run_filter_plugins_with_nominated_pods`` (``:331-348``). There is no
plugin registry or cycle state: ``FilterRunner`` calls the plain functions
of ``framework/plugins/`` and carries their PreFilter results in a
``PreFilterState``. Each check returns None when it passes, else its
reason.

The filters run, in order: NodeUnschedulable, NodeName, TaintToleration,
NodeAffinity, NodePorts, NodeResourcesFit, then VolumeRestrictions,
NodeVolumeLimits, VolumeBinding and VolumeZone through
``framework/plugins/volume.py``. Those left out pass on every node the
dry run sees, before and after any pod is added or removed:

* PodTopologySpread and InterPodAffinity, the only plugins with live
  AddPod / RemovePod extensions (``interpodaffinity.py:188``,
  ``podtopologyspread.py:163``). The dry run runs only for pods of a
  topology mode ``off`` batch: no pod of the batch has a spread constraint
  or an (anti-)affinity term, and the signature table registered no term
  of any pod on any node (``SigTable.recount_node`` registers them all), so
  both filters and both extensions have nothing to count. The nominated
  pods the two-pass filter adds are earlier preemptors of such batches.
* DynamicResources: a pod with claims does not preempt in the port (it
  lands in ``BatchScheduler.fallback``), and a pod without claims passes.
* QuotaAdmission, Coscheduling and SlicePacking (PreFilter and Filter):
  gang members raise before they are batched, and the port has no quota
  or slice objects, so all three pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..api.types import ContainerPort, PersistentVolumeClaim, Pod
from .plugins import basic, nodeaffinity, noderesources, volume
from .types import NodeInfo


class PodNominator:
    """Tracks preemption nominations (framework/interface.go:690):
    nominated pods are taken into account by the filters of other pods
    before their victims are gone."""

    def __init__(self):
        self._by_node: Dict[str, List[Pod]] = {}
        self._node_of: Dict[str, str] = {}

    def add_nominated_pod(self, pod: Pod, node_name: str) -> None:
        self.delete_nominated_pod_if_exists(pod)
        if node_name:
            self._by_node.setdefault(node_name, []).append(pod)
            self._node_of[pod.key()] = node_name

    def delete_nominated_pod_if_exists(self, pod: Pod) -> None:
        node = self._node_of.pop(pod.key(), None)
        if node is not None:
            self._by_node[node] = [p for p in self._by_node[node] if p.key() != pod.key()]

    def nominated_pods_for_node(self, node_name: str) -> List[Pod]:
        return self._by_node.get(node_name, [])


@dataclasses.dataclass
class PreFilterState:
    """What the PreFilters computed for one pod. NodeAffinity's node-name
    restriction is not kept: only scheduling reads it, and the Filter
    checks the same terms on every node."""

    ports: Tuple[ContainerPort, ...]        # NodePorts
    request: Dict[str, int]                 # NodeResourcesFit
    rwop: Set[str]                          # VolumeRestrictions
    bound: List[PersistentVolumeClaim]      # VolumeBinding


class FilterRunner:
    """The default PreFilters and Filters over (pod, NodeInfo).
    ``client`` is the object store PVCs resolve in (None: no pod has
    volumes); ``node_infos_fn`` lists the cluster's NodeInfos (the
    VolumeRestrictions PreFilter reads every node)."""

    def __init__(self, client, node_infos_fn: Callable[[], Iterable[NodeInfo]],
                 nominator: PodNominator):
        self.client = client
        self.node_infos_fn = node_infos_fn
        self.nominator = nominator

    def pre_filter(self, pod: Pod) -> Tuple[Optional[PreFilterState], Optional[str]]:
        """The PreFilters in the default order (NodeAffinity, NodePorts,
        NodeResourcesFit, VolumeRestrictions, VolumeBinding); the first
        failure wins."""
        _names, reason = nodeaffinity.node_affinity_pre_filter(pod)
        if reason is not None:
            return None, reason
        rwop: Set[str] = set()
        bound: List[PersistentVolumeClaim] = []
        if pod.spec.volumes:
            rwop, reason = volume.volume_restrictions_pre_filter(
                self.client, pod, self.node_infos_fn())
            if reason is None:
                bound, reason = volume.volume_binding_pre_filter(self.client, pod)
            if reason is not None:
                return None, reason
        return PreFilterState(pod.host_ports(), pod.resource_request(), rwop, bound), None

    def filter(self, state: PreFilterState, pod: Pod, ni: NodeInfo) -> Optional[str]:
        """The Filters in the default order; the first failure wins."""
        reason = (basic.node_unschedulable_filter(pod, ni)
                  or basic.node_name_filter(pod, ni)
                  or basic.taint_toleration_filter(pod, ni)
                  or nodeaffinity.node_affinity_filter(pod, ni)
                  or basic.node_ports_filter(state.ports, ni)
                  or noderesources.fit_filter(state.request, ni))
        if reason is None and pod.spec.volumes:
            reason = volume.verify_on_node(self.client, pod, ni, state.rwop, state.bound)
        return reason

    def filter_with_nominated_pods(self, state: PreFilterState, pod: Pod,
                                   ni: NodeInfo) -> Optional[str]:
        """Two passes (framework.go:791): first with the pods nominated to
        the node at the pod's priority or above added to a copy of the
        NodeInfo, then without; both must pass."""
        name = ni.node.meta.name if ni.node else ""
        nominated = [p for p in self.nominator.nominated_pods_for_node(name)
                     if p.spec.priority >= pod.spec.priority and p.key() != pod.key()]
        if nominated:
            ni2 = ni.clone()
            for p in nominated:
                ni2.add_pod(p)
            reason = self.filter(state, pod, ni2)
            if reason is not None:
                return reason
        return self.filter(state, pod, ni)
