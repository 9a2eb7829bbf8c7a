"""The NodeAffinity plugin: its PreFilter and Filter as plain functions,
and the plugin object.

An own copy of ``kubernetes_tpu/framework/plugins/nodeaffinity.py``
(nodeaffinity/node_affinity.go): the Filter requires every nodeSelector
pair among the node's labels and one matching required term (terms
OR-ed, expressions AND-ed); the PreFilter restricts the candidate nodes
when every required term is a metadata.name matchFields term; the Score
sums the weights of the preferred terms the node matches. The profile's
``added_affinity`` argument (an ``api.types.NodeAffinity``) is enforced
before the pod's own terms, and its preferred terms join the pod's.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

from ...api.types import NodeAffinity as NodeAffinityAPI
from ...api.types import NodeSelector, Pod, PreferredSchedulingTerm
from ..interface import Fail
from ..types import (ADD, MAX_NODE_SCORE, NODE, UPDATE_NODE_LABEL, ClusterEvent, NodeInfo,
                     default_normalize_score)
from . import names

ERR_REASON_POD = "node(s) didn't match Pod's node affinity/selector"
ERR_REASON_ENFORCED = "node(s) didn't match scheduler-enforced node affinity"
ERR_REASON_CONFLICT = "node(s) didn't satisfy plugin's node affinity"


def required_terms(pod: Pod) -> Optional[NodeSelector]:
    a = pod.spec.affinity
    if a and a.node_affinity and a.node_affinity.required:
        return a.node_affinity.required
    return None


def node_affinity_pre_filter(pod: Pod) -> Tuple[Optional[Set[str]], Optional[str]]:
    """(the node names the pod is restricted to, or None for every node;
    reason) (node_affinity.go:98-134)."""
    required = required_terms(pod)
    if required is None or not required.terms:
        return None, None
    names: Set[str] = set()
    for term in required.terms:
        if term.match_fields_name is None or term.match_expressions:
            return None, None  # some term matches by labels: no restriction
        names.add(term.match_fields_name)
    if not names:
        return None, ERR_REASON_CONFLICT
    return names, None


def node_affinity_filter(pod: Pod, ni: NodeInfo) -> Optional[str]:
    node = ni.node
    labels = node.meta.labels
    if not all(labels.get(k) == v for k, v in pod.spec.node_selector.items()):
        return ERR_REASON_POD
    required = required_terms(pod)
    if required is not None and not required.matches(node):
        return ERR_REASON_POD
    return None


def preferred_terms(pod: Pod) -> Tuple[PreferredSchedulingTerm, ...]:
    """The PreScore state: the pod's preferred node affinity terms."""
    a = pod.spec.affinity
    if a and a.node_affinity:
        return tuple(a.node_affinity.preferred)
    return ()


def node_affinity_score(terms: Tuple[PreferredSchedulingTerm, ...], ni: NodeInfo) -> int:
    return sum(t.weight for t in terms if t.weight != 0 and t.preference.matches(ni.node))


class NodeAffinity:
    def __init__(self, added_affinity: Optional[NodeAffinityAPI] = None):
        self.added_affinity = added_affinity

    def name(self) -> str:
        return names.NODE_AFFINITY

    @staticmethod
    def events_to_register():
        return [ClusterEvent(NODE, ADD | UPDATE_NODE_LABEL)]

    def pre_filter(self, state, pod: Pod):
        node_names, reason = node_affinity_pre_filter(pod)
        if reason is not None:
            return None, Fail(names.NODE_AFFINITY, reason, True)
        return node_names, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        added = self.added_affinity
        if added is not None and added.required is not None and not added.required.matches(ni.node):
            return Fail(names.NODE_AFFINITY, ERR_REASON_ENFORCED, True)
        reason = node_affinity_filter(pod, ni)
        return None if reason is None else Fail(names.NODE_AFFINITY, reason, True)

    def pre_score(self, state, pod: Pod, feasible) -> None:
        terms = preferred_terms(pod)
        if self.added_affinity is not None:
            terms = terms + tuple(self.added_affinity.preferred)
        state.data[names.NODE_AFFINITY] = terms

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        return node_affinity_score(state.data[names.NODE_AFFINITY], ni)

    def normalize_score(self, state, pod: Pod, scores) -> None:
        default_normalize_score(MAX_NODE_SCORE, False, scores)
