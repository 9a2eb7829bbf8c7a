"""The pod nominator, the host filter chain and the host score runner.

An own copy of the parts of ``kubernetes_tpu/framework/runtime.py`` that
preemption and the sequential path read: ``PodNominator`` (``:37-58``),
the PreFilters run once per pod, the Filters, the AddPod / RemovePod
extensions and ``filter_with_nominated_pods``, the two-pass filter of
``run_filter_plugins_with_nominated_pods`` (``:331-363``), and the PreScore
and Score runner with normalization and the default weights (``:380-415``;
``framework/registry.py:152-167``). There is no plugin registry or cycle
state: ``FilterRunner`` calls the plain functions of ``framework/plugins/``
and carries what their PreFilters computed in a ``PreFilterState``, which
the Evaluator clones per dry run. Each check returns None when it passes,
else its reason (the preemption dry run's form); the ``*_status`` forms
return a ``Fail`` instead: the plugin, the reason, and whether the status
is UnschedulableAndUnresolvable, as the JAX plugin returns it, which the
sequential path's Diagnosis records.

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
adds and removes pods. VolumeBinding's Filter records each node's choice
of PVs for the pod's delayed claims in the state, which its Reserve reads.

``ScoreRunner`` runs the PreScores (TaintToleration, NodeAffinity,
PodTopologySpread, InterPodAffinity, ImageLocality) and then the Scores in
the default order and weights: BalancedAllocation 1, ImageLocality 1,
InterPodAffinity 2, NodeResourcesFit (LeastAllocated) 1, NodeAffinity 2,
PodTopologySpread 2, TaintToleration 3, each normalized before its weight
applies, in the JAX plugins' host arithmetic.

``BatchScheduler`` runs without SlicePacking: a slice gang member preempts
only for a gang the batch rejected, and that rejection arms the gang's
backoff, which fails Coscheduling's PreFilter first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

from ..api.types import ContainerPort, PersistentVolumeClaim, Pod
from .plugins import (basic, dynamicresources, imagelocality, interpodaffinity, nodeaffinity,
                      noderesources, podtopologyspread, volume)
from .types import (MAX_NODE_SCORE, MIN_NODE_SCORE, NodeInfo, default_normalize_score,
                    nonzero_request)

ERR_REASON_PREFILTER_RESTRICTION = "node(s) didn't satisfy plugin(s) prefilter restriction"


class Fail(NamedTuple):
    """A failed check: the plugin, its reason, and whether its status is
    UnschedulableAndUnresolvable (preemption cannot help on that node)."""

    plugin: str
    reason: str
    unresolvable: bool


# the Filter reasons whose status is plain Unschedulable; every other
# Filter reason of the plugins below is UnschedulableAndUnresolvable
_UNSCHEDULABLE_FILTERS = frozenset(("NodePorts", "NodeResourcesFit", "DynamicResources",
                                    "SlicePacking"))
_UNSCHEDULABLE_REASONS = frozenset((volume.ERR_REASON_LIMIT, volume.ERR_REASON_NO_PV,
                                    podtopologyspread.ERR_REASON_CONSTRAINTS,
                                    interpodaffinity.ERR_ANTI_AFFINITY,
                                    interpodaffinity.ERR_EXISTING_ANTI))


def _fail(plugin: str, reason: Optional[str]) -> Optional[Fail]:
    if reason is None:
        return None
    return Fail(plugin, reason, plugin not in _UNSCHEDULABLE_FILTERS
                and reason not in _UNSCHEDULABLE_REASONS)


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
    restriction is returned apart (``pre_filter_status``). ``clone``
    copies the two count states the extensions move and the delayed
    claims' per-node choice; the rest is read-only, but for
    ``allocated``, the claim keys DynamicResources' Reserve took."""

    ports: Tuple[ContainerPort, ...]        # NodePorts
    request: Dict[str, int]                 # NodeResourcesFit
    rwop: Set[str]                          # VolumeRestrictions
    bound: List[PersistentVolumeClaim]      # VolumeBinding: bound claims
    spread: podtopologyspread.PreFilterState
    affinity: interpodaffinity.PreFilterState
    claims: dynamicresources.Claims         # DynamicResources
    slice_target: Optional[str] = None      # SlicePacking: the member's planned node
    # VolumeBinding: the delayed (WaitForFirstConsumer) claims, and the
    # PVs the Filter chose for them per node
    delayed: List[PersistentVolumeClaim] = dataclasses.field(default_factory=list)
    node_bindings: Dict[str, List[volume.Binding]] = dataclasses.field(default_factory=dict)
    allocated: List[str] = dataclasses.field(default_factory=list)

    def clone(self) -> "PreFilterState":
        return dataclasses.replace(self, spread=self.spread.clone(),
                                   affinity=self.affinity.clone(),
                                   node_bindings=dict(self.node_bindings))


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
        """(the state, None), or (None, the first failure's reason)."""
        state, _names, fail = self.pre_filter_status(pod)
        return state, (fail.reason if fail is not None else None)

    def pre_filter_status(self, pod: Pod, gates: bool = True
                          ) -> Tuple[Optional[PreFilterState], Optional[Set[str]], Optional[Fail]]:
        """The PreFilters in the default order: (the state, the node names
        they restrict the pod to or None for every node, None), or (None,
        None, the first failure). ``gates=False`` leaves out the host gates
        (QuotaAdmission and Coscheduling), which judge the tenant and the
        gang, not the node."""
        for plugin, gate in (("QuotaAdmission", self.quota),
                             ("Coscheduling", self.coscheduling)):
            if gate is not None and gates:
                reason = gate.pre_filter(pod)
                if reason is not None:
                    return None, None, Fail(plugin, reason, True)
        names, reason = nodeaffinity.node_affinity_pre_filter(pod)
        if reason is not None:
            return None, None, Fail("NodeAffinity", reason, True)
        infos = list(self.node_infos_fn())
        rwop: Set[str] = set()
        if pod.spec.volumes:
            rwop, reason = volume.volume_restrictions_pre_filter(self.client, pod, infos)
            if reason is not None:
                return None, None, Fail("VolumeRestrictions", reason, True)
        spread = podtopologyspread.pre_filter(pod, infos)
        affinity = interpodaffinity.pre_filter(pod, infos, self.ns_labels_fn)
        bound: List[PersistentVolumeClaim] = []
        delayed: List[PersistentVolumeClaim] = []
        if pod.spec.volumes:
            bound, delayed, reason = volume.volume_binding_pre_filter(self.client, pod)
            if reason is not None:
                return None, None, Fail("VolumeBinding", reason, True)
        claims: dynamicresources.Claims = []
        if pod.spec.resource_claims:
            claims, reason = dynamicresources.pre_filter(self.client, pod)
            if reason is not None:
                return None, None, Fail("DynamicResources", reason, True)
            for _key, claim, _sels in claims:
                if claim.allocated_node:
                    names = ({claim.allocated_node} if names is None
                             else names & {claim.allocated_node})
                    if not names:
                        return None, None, Fail("DynamicResources",
                                                ERR_REASON_PREFILTER_RESTRICTION, True)
        target = None
        if self.slice_packing is not None:
            target, reason = self.slice_packing.pre_filter(pod)
            if reason is not None:
                return None, None, Fail("SlicePacking", reason, False)
        return PreFilterState(pod.host_ports(), pod.resource_request(), rwop, bound, spread,
                              affinity, claims, target, delayed), names, None

    def filter(self, state: PreFilterState, pod: Pod, ni: NodeInfo) -> Optional[str]:
        """The first failing Filter's reason, or None."""
        fail = self.filter_status(state, pod, ni)
        return fail.reason if fail is not None else None

    def filter_status(self, state: PreFilterState, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        """The Filters in the default order; the first failure, or None."""
        fail = (_fail("NodeUnschedulable", basic.node_unschedulable_filter(pod, ni))
                or _fail("NodeName", basic.node_name_filter(pod, ni))
                or _fail("TaintToleration", basic.taint_toleration_filter(pod, ni))
                or _fail("NodeAffinity", nodeaffinity.node_affinity_filter(pod, ni))
                or _fail("NodePorts", basic.node_ports_filter(state.ports, ni))
                or _fail("NodeResourcesFit", noderesources.fit_filter(state.request, ni)))
        if fail is None and pod.spec.volumes:
            failed = volume.verify_on_node(self.client, pod, ni, state.rwop, state.bound,
                                           state.delayed, state.node_bindings)
            if failed is not None:
                fail = _fail(*failed)
        if fail is None and state.spread.constraints:
            fail = _fail("PodTopologySpread",
                         podtopologyspread.filter_node(state.spread, pod, ni))
        if fail is None:
            fail = _fail("InterPodAffinity",
                         interpodaffinity.filter_node(state.affinity, pod, ni,
                                                      self.ns_labels_fn))
        if fail is None and state.claims:
            fail = _fail("DynamicResources",
                         dynamicresources.filter_node(state.claims, ni.node))
        if fail is None and self.slice_packing is not None:
            fail = _fail("SlicePacking",
                         self.slice_packing.filter(state.slice_target, pod, ni))
        return fail

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
        fail = self.filter_with_nominated_pods_status(state, pod, ni)
        return fail.reason if fail is not None else None

    def filter_with_nominated_pods_status(self, state: PreFilterState, pod: Pod,
                                          ni: NodeInfo) -> Optional[Fail]:
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
            fail = self.filter_status(state2, pod, ni2)
            if fail is not None:
                return fail
        return self.filter_status(state, pod, ni)


class ScoreRunner:
    """The default PreScore and Score points over a pod's feasible nodes
    (``run_pre_score_plugins`` and ``run_score_plugins``): node name ->
    the weighted sum of the normalized scores. ``node_infos_fn`` lists
    the snapshot's nodes, which the PreScores of InterPodAffinity,
    PodTopologySpread and ImageLocality walk."""

    def __init__(self, node_infos_fn: Callable[[], Iterable[NodeInfo]],
                 ns_labels_fn: Optional[interpodaffinity.NsLabelsFn] = None):
        self.node_infos_fn = node_infos_fn
        self.ns_labels_fn = ns_labels_fn or (lambda ns: {})

    def score(self, pod: Pod, feasible: List[NodeInfo]) -> Dict[str, int]:
        infos = list(self.node_infos_fn())
        prefer = basic.taint_toleration_pre_score(pod)
        preferred = nodeaffinity.preferred_terms(pod)
        spread = podtopologyspread.pre_score(pod, [ni.node for ni in feasible], infos)
        topology = interpodaffinity.pre_score(pod, infos, self.ns_labels_fn)
        images = imagelocality.pre_score(infos)
        req = nonzero_request(pod.resource_request())
        plugins = (
            ("NodeResourcesBalancedAllocation", 1,
             lambda ni: noderesources.balanced_allocation_score(req, ni), None),
            ("ImageLocality", 1, lambda ni: imagelocality.score_node(images, pod, ni), None),
            ("InterPodAffinity", 2, lambda ni: interpodaffinity.score_node(topology, ni),
             interpodaffinity.normalize_score),
            ("NodeResourcesFit", 1, lambda ni: noderesources.least_allocated_score(req, ni),
             None),
            ("NodeAffinity", 2, lambda ni: nodeaffinity.node_affinity_score(preferred, ni),
             lambda scores: default_normalize_score(MAX_NODE_SCORE, False, scores)),
            ("PodTopologySpread", 2, lambda ni: podtopologyspread.score_node(spread, pod, ni),
             lambda scores: podtopologyspread.normalize_score(spread, scores)),
            ("TaintToleration", 3, lambda ni: basic.taint_toleration_score(prefer, ni),
             lambda scores: default_normalize_score(MAX_NODE_SCORE, True, scores)),
        )
        totals = {ni.node.meta.name: 0 for ni in feasible}
        for plugin, weight, score_fn, normalize in plugins:
            scores = {ni.node.meta.name: score_fn(ni) for ni in feasible}
            if normalize is not None:
                normalize(scores)
            for name, v in scores.items():
                if not MIN_NODE_SCORE <= v <= MAX_NODE_SCORE:
                    raise RuntimeError(f"plugin {plugin} returned out-of-range score {v}")
                totals[name] += v * weight
        return totals
