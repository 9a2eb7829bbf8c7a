"""The NodeAffinity plugin's PreFilter and Filter as plain functions.

An own copy of ``kubernetes_tpu/framework/plugins/nodeaffinity.py``
(nodeaffinity/node_affinity.go) without the per-profile AddedAffinity
argument, which no caller of the port sets: the Filter requires every
nodeSelector pair among the node's labels and one matching required term
(terms OR-ed, expressions AND-ed); the PreFilter restricts the candidate
nodes when every required term is a metadata.name matchFields term; the
Score sums the weights of the preferred terms the node matches.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

from ...api.types import NodeSelector, Pod, PreferredSchedulingTerm
from ..types import NodeInfo

ERR_REASON_POD = "node(s) didn't match Pod's node affinity/selector"
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
