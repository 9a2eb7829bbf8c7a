"""Inter-pod affinity: the terms, and the host PreFilter, Filter, PreScore
and Score.

An own copy of the term parsing of ``kubernetes_tpu/framework/plugins/
interpodaffinity.py`` (``AffinityTerm`` and the four term extractors), of
its PreFilter state, AddPod / RemovePod extensions and Filter
(``:117-250``, interpodaffinity/filtering.go), and of its PreScore, Score
and NormalizeScore (``:251-313``, scoring.go), with the existing pods'
preferred terms counted, as plain functions, and the plugin object, whose
``hard_pod_affinity_weight`` argument (default 1) weighs the existing
pods' required affinity terms in PreScore. The batched path evaluates the
terms through ``backend/sig_table.py`` and ``ops/topology.py`` at the
default weight (a profile with another takes the sequential path); the
host dry run and the sequential path (``framework/runtime.py``) read
these.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Tuple

from ...api.types import LABEL_HOSTNAME, MATCH_NOTHING, LabelSelector, Node, Pod, PodAffinityTerm
from ..interface import Fail
from ..types import ADD, DELETE, MAX_NODE_SCORE, NODE, POD, UPDATE_NODE_LABEL, ClusterEvent, NodeInfo
from . import names

ERR_EXISTING_ANTI = "node(s) didn't satisfy existing pods anti-affinity rules"
ERR_AFFINITY = "node(s) didn't match pod affinity rules"
ERR_ANTI_AFFINITY = "node(s) didn't match pod anti-affinity rules"

# the topology key whose domains are single nodes (podtopologyspread.go)
HOSTNAME_KEY = LABEL_HOSTNAME

NsLabelsFn = Callable[[str], Dict[str, str]]


@dataclass(frozen=True)
class AffinityTerm:
    """Pre-parsed term (framework/types.go:193 newAffinityTerm)."""

    selector: LabelSelector
    topology_key: str
    namespaces: FrozenSet[str]
    namespace_selector: Optional[LabelSelector]
    weight: int = 0

    @classmethod
    def build(cls, term: PodAffinityTerm, default_ns: str, weight: int = 0) -> "AffinityTerm":
        ns = frozenset(term.namespaces) if term.namespaces else (
            frozenset() if term.namespace_selector is not None else frozenset({default_ns})
        )
        return cls(
            selector=term.label_selector if term.label_selector is not None else MATCH_NOTHING,
            topology_key=term.topology_key,
            namespaces=ns,
            namespace_selector=term.namespace_selector,
            weight=weight,
        )

    def matches(self, pod: Pod, ns_labels_fn: NsLabelsFn) -> bool:
        if pod.meta.namespace in self.namespaces:
            ns_ok = True
        elif self.namespace_selector is not None:
            ns_ok = self.namespace_selector.matches(ns_labels_fn(pod.meta.namespace))
        else:
            ns_ok = False
        return ns_ok and self.selector.matches(pod.meta.labels)


def _parsed_terms(pod: Pod):
    """The pod's four term lists, parsed once and memoized on the Pod
    instance (clones share the cache through their copied __dict__)."""
    cached = pod.__dict__.get("_ipa_terms")
    if cached is not None:
        return cached
    a = pod.spec.affinity
    ns = pod.meta.namespace
    aff = a.pod_affinity if a else None
    anti = a.pod_anti_affinity if a else None
    cached = (
        [AffinityTerm.build(t, ns) for t in aff.required] if aff else [],
        [AffinityTerm.build(t, ns) for t in anti.required] if anti else [],
        [AffinityTerm.build(w.term, ns, w.weight) for w in aff.preferred] if aff else [],
        [AffinityTerm.build(w.term, ns, w.weight) for w in anti.preferred] if anti else [],
    )
    pod.__dict__["_ipa_terms"] = cached
    return cached


def required_affinity_terms(pod: Pod) -> List[AffinityTerm]:
    return _parsed_terms(pod)[0]


def required_anti_affinity_terms(pod: Pod) -> List[AffinityTerm]:
    return _parsed_terms(pod)[1]


def preferred_affinity_terms(pod: Pod) -> List[AffinityTerm]:
    return _parsed_terms(pod)[2]


def preferred_anti_affinity_terms(pod: Pod) -> List[AffinityTerm]:
    return _parsed_terms(pod)[3]


TopoPair = Tuple[str, str]


@dataclass
class PreFilterState:
    """The pod's required terms and three topology-pair counts
    (filtering.go:86-135): existing pods' anti-affinity terms that match
    the pod, and the existing pods the pod's affinity and anti-affinity
    terms match, each by the domain of the node they are on."""

    affinity_terms: List[AffinityTerm] = field(default_factory=list)
    anti_affinity_terms: List[AffinityTerm] = field(default_factory=list)
    existing_anti: Dict[TopoPair, int] = field(default_factory=dict)
    affinity: Dict[TopoPair, int] = field(default_factory=dict)
    anti_affinity: Dict[TopoPair, int] = field(default_factory=dict)

    def clone(self) -> "PreFilterState":
        return PreFilterState(list(self.affinity_terms), list(self.anti_affinity_terms),
                              dict(self.existing_anti), dict(self.affinity),
                              dict(self.anti_affinity))


def _bump(m: Dict[TopoPair, int], pair: TopoPair, delta: int) -> None:
    v = m.get(pair, 0) + delta
    if v <= 0:
        m.pop(pair, None)
    else:
        m[pair] = v


def pre_filter(pod: Pod, node_infos: Iterable[NodeInfo], ns_labels_fn: NsLabelsFn
               ) -> PreFilterState:
    s = PreFilterState(required_affinity_terms(pod), required_anti_affinity_terms(pod))
    need_scan = s.affinity_terms or s.anti_affinity_terms
    for ni in node_infos:
        node = ni.node
        if node is None:
            continue
        labels = node.meta.labels
        for ep in ni.pods_with_required_anti_affinity:
            for term in required_anti_affinity_terms(ep):
                if term.topology_key in labels and term.matches(pod, ns_labels_fn):
                    _bump(s.existing_anti, (term.topology_key, labels[term.topology_key]), 1)
        if not need_scan:
            continue
        for ep in ni.pods:
            for term in s.affinity_terms:
                if term.topology_key in labels and term.matches(ep, ns_labels_fn):
                    _bump(s.affinity, (term.topology_key, labels[term.topology_key]), 1)
            for term in s.anti_affinity_terms:
                if term.topology_key in labels and term.matches(ep, ns_labels_fn):
                    _bump(s.anti_affinity, (term.topology_key, labels[term.topology_key]), 1)
    return s


def update_for_pod(s: PreFilterState, pod: Pod, other: Pod, node: Optional[Node], delta: int,
                   ns_labels_fn: NsLabelsFn) -> None:
    """The AddPod (``delta`` 1) and RemovePod (-1) extensions: ``other``
    joins or leaves ``node`` in the dry run."""
    if node is None:
        return
    labels = node.meta.labels
    for term in required_anti_affinity_terms(other):
        if term.topology_key in labels and term.matches(pod, ns_labels_fn):
            _bump(s.existing_anti, (term.topology_key, labels[term.topology_key]), delta)
    for term in s.affinity_terms:
        if term.topology_key in labels and term.matches(other, ns_labels_fn):
            _bump(s.affinity, (term.topology_key, labels[term.topology_key]), delta)
    for term in s.anti_affinity_terms:
        if term.topology_key in labels and term.matches(other, ns_labels_fn):
            _bump(s.anti_affinity, (term.topology_key, labels[term.topology_key]), delta)


def filter_node(s: PreFilterState, pod: Pod, ni: NodeInfo, ns_labels_fn: NsLabelsFn
                ) -> Optional[str]:
    """The Filter's three checks in filtering.go:377-387 order: the pod's
    affinity (with the first-pod-in-cluster case), its anti-affinity, the
    existing pods' anti-affinity. None when the node passes."""
    labels = ni.node.meta.labels
    if s.affinity_terms:
        pods_exist = True
        for term in s.affinity_terms:
            tv = labels.get(term.topology_key)
            if tv is None:
                return ERR_AFFINITY
            if s.affinity.get((term.topology_key, tv), 0) <= 0:
                pods_exist = False
        if not pods_exist and (s.affinity or not all(
                t.matches(pod, ns_labels_fn) for t in s.affinity_terms)):
            return ERR_AFFINITY
    for term in s.anti_affinity_terms:
        tv = labels.get(term.topology_key)
        if tv is not None and s.anti_affinity.get((term.topology_key, tv), 0) > 0:
            return ERR_ANTI_AFFINITY
    for (tk, tv), cnt in s.existing_anti.items():
        if cnt > 0 and labels.get(tk) == tv:
            return ERR_EXISTING_ANTI
    return None


def pre_score(pod: Pod, node_infos: Iterable[NodeInfo], ns_labels_fn: NsLabelsFn,
              hard_weight: int = 1) -> Dict[TopoPair, int]:
    """The weight per topology pair: the pod's preferred (anti-)affinity
    terms over the existing pods, and the existing pods' required affinity
    (at ``hard_weight``, the hardPodAffinityWeight argument; none when it
    is 0) and preferred terms toward the pod."""
    pref = preferred_affinity_terms(pod)
    pref_anti = preferred_anti_affinity_terms(pod)
    scores: Dict[TopoPair, int] = {}
    scan_all = bool(pref or pref_anti)

    def add(term, labels, other, sign):
        tv = labels.get(term.topology_key)
        if tv is not None and term.matches(other, ns_labels_fn):
            pair = (term.topology_key, tv)
            scores[pair] = scores.get(pair, 0) + sign

    for ni in node_infos:
        node = ni.node
        if node is None:
            continue
        labels = node.meta.labels
        for ep in (ni.pods if scan_all else ni.pods_with_affinity):
            for term in pref:
                add(term, labels, ep, term.weight)
            for term in pref_anti:
                add(term, labels, ep, -term.weight)
            if hard_weight > 0:
                for term in required_affinity_terms(ep):
                    add(term, labels, pod, hard_weight)
            for term in preferred_affinity_terms(ep):
                add(term, labels, pod, term.weight)
            for term in preferred_anti_affinity_terms(ep):
                add(term, labels, pod, -term.weight)
    return scores


def score_node(topology_score: Dict[TopoPair, int], ni: NodeInfo) -> int:
    labels = ni.node.meta.labels
    return sum(w for (tk, tv), w in topology_score.items() if labels.get(tk) == tv)


def normalize_score(scores: Dict[str, int]) -> None:
    """scoring.go NormalizeScore, in place: [min, max] (floored and ceiled
    at 0) onto [0, 100] through a float."""
    max_count = max([*scores.values(), 0])
    min_count = min([*scores.values(), 0])
    diff = max_count - min_count
    for name, raw in scores.items():
        scores[name] = int(MAX_NODE_SCORE * (raw - min_count) / diff) if diff > 0 else 0


class InterPodAffinity:
    def __init__(self, snapshot_fn=None, ns_labels_fn: Optional[NsLabelsFn] = None,
                 hard_pod_affinity_weight: int = 1):
        self.snapshot_fn = snapshot_fn or (lambda: ())
        self.ns_labels_fn = ns_labels_fn or (lambda ns: {})
        self.hard_pod_affinity_weight = hard_pod_affinity_weight

    def name(self) -> str:
        return names.INTER_POD_AFFINITY

    @staticmethod
    def events_to_register():
        return [ClusterEvent(POD, ADD | DELETE), ClusterEvent(NODE, ADD | UPDATE_NODE_LABEL)]

    def pre_filter(self, state, pod: Pod):
        state.affinity = pre_filter(pod, self.snapshot_fn(), self.ns_labels_fn)
        return None, None

    def add_pod(self, state, pod: Pod, other: Pod, ni: NodeInfo) -> None:
        update_for_pod(state.affinity, pod, other, ni.node, 1, self.ns_labels_fn)

    def remove_pod(self, state, pod: Pod, other: Pod, ni: NodeInfo) -> None:
        update_for_pod(state.affinity, pod, other, ni.node, -1, self.ns_labels_fn)

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = filter_node(state.affinity, pod, ni, self.ns_labels_fn)
        if reason is None:
            return None
        return Fail(names.INTER_POD_AFFINITY, reason,
                    reason not in (ERR_ANTI_AFFINITY, ERR_EXISTING_ANTI))

    def pre_score(self, state, pod: Pod, feasible) -> None:
        state.data[names.INTER_POD_AFFINITY] = pre_score(
            pod, self.snapshot_fn(), self.ns_labels_fn, self.hard_pod_affinity_weight)

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        return score_node(state.data[names.INTER_POD_AFFINITY], ni)

    def normalize_score(self, state, pod: Pod, scores) -> None:
        normalize_score(scores)
