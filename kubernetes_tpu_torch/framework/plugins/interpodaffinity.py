"""Inter-pod affinity terms as the batched path counts them.

An own copy of the term parsing of ``kubernetes_tpu/framework/plugins/
interpodaffinity.py`` (``AffinityTerm`` and the four term extractors),
without the plugin classes: the batched path evaluates the terms through
``backend/sig_table.py`` and ``ops/topology.py`` instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional

from ...api.types import LABEL_HOSTNAME, MATCH_NOTHING, LabelSelector, Pod, PodAffinityTerm

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
