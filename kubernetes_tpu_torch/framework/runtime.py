"""The pod nominator and the filter chain the preemption dry run runs.

An own copy of the part of ``kubernetes_tpu/framework/runtime.py`` that
preemption reads: ``PodNominator`` (``:37-58``), the PreFilters run once
per pod, the Filters, the AddPod / RemovePod extensions and
``filter_with_nominated_pods``, the two-pass filter of
``run_filter_plugins_with_nominated_pods`` (``:331-363``). There is no
plugin registry or cycle state: ``FilterRunner`` calls the plain functions
of ``framework/plugins/`` and carries what their PreFilters computed in a
``PreFilterState``, which the Evaluator clones per dry run. Each check
returns None when it passes, else its reason.

The PreFilters run in the default order of ``kubernetes_tpu/framework/
registry.py``: QuotaAdmission and Coscheduling (when the caller has them),
NodeAffinity, NodePorts, NodeResourcesFit, VolumeRestrictions,
PodTopologySpread, InterPodAffinity, VolumeBinding, DynamicResources, and
SlicePacking (when the caller has it); the first failure wins, and the
node restrictions of NodeAffinity and of claims already allocated must
intersect. The Filters, in order: NodeUnschedulable, NodeName,
TaintToleration, NodeAffinity, NodePorts, NodeResourcesFit,
VolumeRestrictions, NodeVolumeLimits, VolumeBinding and VolumeZone
(``framework/plugins/volume.py``), PodTopologySpread, InterPodAffinity,
DynamicResources, SlicePacking. PodTopologySpread and InterPodAffinity
carry counts that the AddPod / RemovePod extensions move as the dry run
adds and removes pods.

``BatchScheduler`` runs without SlicePacking: a slice gang member preempts
only for a gang the batch rejected, and that rejection arms the gang's
backoff, which fails Coscheduling's PreFilter first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..api.types import ContainerPort, PersistentVolumeClaim, Pod
from .plugins import (basic, dynamicresources, interpodaffinity, nodeaffinity, noderesources,
                      podtopologyspread, volume)
from .types import NodeInfo

ERR_REASON_PREFILTER_RESTRICTION = "node(s) didn't satisfy plugin(s) prefilter restriction"


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
    checks the same terms on every node. ``clone`` copies the two count
    states the extensions move; the rest is read-only."""

    ports: Tuple[ContainerPort, ...]        # NodePorts
    request: Dict[str, int]                 # NodeResourcesFit
    rwop: Set[str]                          # VolumeRestrictions
    bound: List[PersistentVolumeClaim]      # VolumeBinding
    spread: podtopologyspread.PreFilterState
    affinity: interpodaffinity.PreFilterState
    claims: dynamicresources.Claims         # DynamicResources
    slice_target: Optional[str] = None      # SlicePacking: the member's planned node

    def clone(self) -> "PreFilterState":
        return dataclasses.replace(self, spread=self.spread.clone(),
                                   affinity=self.affinity.clone())


class FilterRunner:
    """The default PreFilters and Filters over (pod, NodeInfo).
    ``client`` is the object store PVCs and claims resolve in (None: no
    pod has volumes or claims); ``node_infos_fn`` lists the cluster's
    NodeInfos (several PreFilters read every node); ``quota`` and
    ``coscheduling`` and ``slice_packing`` are the caller's QuotaAdmission,
    Coscheduling and SlicePacking, or None."""

    def __init__(self, client, node_infos_fn: Callable[[], Iterable[NodeInfo]],
                 nominator: PodNominator,
                 ns_labels_fn: Optional[interpodaffinity.NsLabelsFn] = None,
                 quota=None, coscheduling=None, slice_packing=None):
        self.client = client
        self.node_infos_fn = node_infos_fn
        self.nominator = nominator
        self.ns_labels_fn = ns_labels_fn or (lambda ns: {})
        self.quota = quota
        self.coscheduling = coscheduling
        self.slice_packing = slice_packing

    def pre_filter(self, pod: Pod) -> Tuple[Optional[PreFilterState], Optional[str]]:
        """The PreFilters in the default order; the first failure wins."""
        reason = None
        if self.quota is not None:
            reason = self.quota.pre_filter(pod)
        if reason is None and self.coscheduling is not None:
            reason = self.coscheduling.pre_filter(pod)
        if reason is not None:
            return None, reason
        names, reason = nodeaffinity.node_affinity_pre_filter(pod)
        if reason is not None:
            return None, reason
        infos = list(self.node_infos_fn())
        rwop: Set[str] = set()
        if pod.spec.volumes:
            rwop, reason = volume.volume_restrictions_pre_filter(self.client, pod, infos)
            if reason is not None:
                return None, reason
        spread = podtopologyspread.pre_filter(pod, infos)
        affinity = interpodaffinity.pre_filter(pod, infos, self.ns_labels_fn)
        bound: List[PersistentVolumeClaim] = []
        if pod.spec.volumes:
            bound, reason = volume.volume_binding_pre_filter(self.client, pod)
            if reason is not None:
                return None, reason
        claims: dynamicresources.Claims = []
        if pod.spec.resource_claims:
            claims, reason = dynamicresources.pre_filter(self.client, pod)
            if reason is not None:
                return None, reason
            for _key, claim, _sels in claims:
                if claim.allocated_node:
                    names = ({claim.allocated_node} if names is None
                             else names & {claim.allocated_node})
                    if not names:
                        return None, ERR_REASON_PREFILTER_RESTRICTION
        target = None
        if self.slice_packing is not None:
            target, reason = self.slice_packing.pre_filter(pod)
            if reason is not None:
                return None, reason
        return PreFilterState(pod.host_ports(), pod.resource_request(), rwop, bound, spread,
                              affinity, claims, target), None

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
        if reason is None and state.spread.constraints:
            reason = podtopologyspread.filter_node(state.spread, pod, ni)
        if reason is None:
            reason = interpodaffinity.filter_node(state.affinity, pod, ni, self.ns_labels_fn)
        if reason is None and state.claims:
            reason = dynamicresources.filter_node(state.claims, ni.node)
        if reason is None and self.slice_packing is not None:
            reason = self.slice_packing.filter(state.slice_target, pod, ni)
        return reason

    def add_pod(self, state: PreFilterState, pod: Pod, added: Pod, ni: NodeInfo) -> None:
        """The AddPod extensions: ``added`` joins ``ni`` in the dry run."""
        podtopologyspread.update_for_pod(state.spread, pod, added, ni.node, 1)
        interpodaffinity.update_for_pod(state.affinity, pod, added, ni.node, 1,
                                        self.ns_labels_fn)

    def remove_pod(self, state: PreFilterState, pod: Pod, removed: Pod, ni: NodeInfo) -> None:
        """The RemovePod extensions: ``removed`` leaves ``ni``."""
        podtopologyspread.update_for_pod(state.spread, pod, removed, ni.node, -1)
        interpodaffinity.update_for_pod(state.affinity, pod, removed, ni.node, -1,
                                        self.ns_labels_fn)

    def filter_with_nominated_pods(self, state: PreFilterState, pod: Pod,
                                   ni: NodeInfo) -> Optional[str]:
        """Two passes (framework.go:791): first with the pods nominated to
        the node at the pod's priority or above added to a copy of the
        NodeInfo and of the state (the AddPod extensions run for each),
        then without; both must pass."""
        name = ni.node.meta.name if ni.node else ""
        nominated = [p for p in self.nominator.nominated_pods_for_node(name)
                     if p.spec.priority >= pod.spec.priority and p.key() != pod.key()]
        if nominated:
            state2 = state.clone()
            ni2 = ni.clone()
            for p in nominated:
                ni2.add_pod(p)
                self.add_pod(state2, pod, p, ni2)
            reason = self.filter(state2, pod, ni2)
            if reason is not None:
                return reason
        return self.filter(state, pod, ni)
