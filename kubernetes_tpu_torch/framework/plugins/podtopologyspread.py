"""PodTopologySpread's host PreFilter, Filter, PreScore and Score.

An own copy of ``kubernetes_tpu/framework/plugins/podtopologyspread.py``
as plain functions. Filtering (``:50-197``, filtering.go): the PreFilter
counts, over the nodes that match the pod's required node affinity and
carry every DoNotSchedule constraint's key, the pods of the pod's
namespace each constraint selects, per topology pair; AddPod / RemovePod
move those counts as the dry run adds and removes pods; the Filter admits
a node when ``matchNum + selfMatch - minMatchNum <= maxSkew`` for every
constraint. Scoring (``:198-279``, scoring.go) over the ScheduleAnyway
constraints: PreScore ignores the filtered nodes without every
constraint's key, weighs each constraint by ``log(domains + 2)`` and
counts the matching pods per pair over all nodes; a node scores
``round(sum(count * weight + maxSkew - 1))``, normalized reversed against
the range. The batched path counts spread through ``ops/topology.py``; the
host dry run and the sequential path read these through the plugin
object. Its arguments: ``default_constraints`` apply to a pod that sets
none, and ``system_defaulted`` (they are the built-in defaults) lets
PreScore count nodes that lack a constraint's key. The batched path has
neither: a profile that sets one takes the sequential path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ...api.types import (DO_NOT_SCHEDULE, LABEL_HOSTNAME, MATCH_NOTHING, SCHEDULE_ANYWAY,
                          LabelSelector, Node, Pod, TopologySpreadConstraint)
from ..interface import Fail
from ..types import ADD, DELETE, MAX_NODE_SCORE, NODE, POD, UPDATE_NODE_LABEL, ClusterEvent, NodeInfo
from . import names

ERR_REASON_CONSTRAINTS = "node(s) didn't match pod topology spread constraints"
ERR_REASON_LABEL = ERR_REASON_CONSTRAINTS + " (missing required label)"


def _selector_of(c: TopologySpreadConstraint) -> LabelSelector:
    return c.label_selector if c.label_selector is not None else MATCH_NOTHING


def _count_matching(pods: Iterable[Pod], sel: LabelSelector, ns: str) -> int:
    return sum(1 for p in pods if p.meta.namespace == ns and sel.matches(p.meta.labels))


def _matches_node_affinity(pod: Pod, node: Node) -> bool:
    """GetRequiredNodeAffinity.Match: the nodeSelector and the required
    terms."""
    if any(node.meta.labels.get(k) != v for k, v in pod.spec.node_selector.items()):
        return False
    a = pod.spec.affinity
    if a and a.node_affinity and a.node_affinity.required:
        return a.node_affinity.required.matches(node)
    return True


@dataclass
class PreFilterState:
    constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    tp_pair_to_match_num: Dict[Tuple[str, str], int] = field(default_factory=dict)
    tp_key_to_domains_num: Dict[str, int] = field(default_factory=dict)

    def clone(self) -> "PreFilterState":
        return PreFilterState(list(self.constraints), dict(self.tp_pair_to_match_num),
                              dict(self.tp_key_to_domains_num))

    def min_match_num(self, tp_key: str, min_domains: Optional[int]) -> int:
        """The smallest count over the key's domains; 0 when fewer domains
        than ``min_domains`` are eligible."""
        vals = [n for (k, _v), n in self.tp_pair_to_match_num.items() if k == tp_key]
        if min_domains is not None and self.tp_key_to_domains_num.get(tp_key, 0) < min_domains:
            return 0
        return min(vals) if vals else 0


def constraints_of(pod: Pod, when: str, defaults: Sequence[TopologySpreadConstraint] = ()
                   ) -> List[TopologySpreadConstraint]:
    """The pod's constraints of one kind, or the defaults' when it sets
    none."""
    own = pod.spec.topology_spread_constraints
    return [c for c in (own or defaults) if c.when_unsatisfiable == when]


def pre_filter(pod: Pod, node_infos: Iterable[NodeInfo],
               defaults: Sequence[TopologySpreadConstraint] = ()) -> PreFilterState:
    constraints = constraints_of(pod, DO_NOT_SCHEDULE, defaults)
    s = PreFilterState(constraints=constraints)
    if not constraints:
        return s
    ns = pod.meta.namespace
    for ni in node_infos:
        node = ni.node
        if node is None or not _matches_node_affinity(pod, node):
            continue
        labels = node.meta.labels
        if any(c.topology_key not in labels for c in constraints):
            continue
        for c in constraints:
            pair = (c.topology_key, labels[c.topology_key])
            cnt = _count_matching(ni.pods, _selector_of(c), ns)
            s.tp_pair_to_match_num[pair] = s.tp_pair_to_match_num.get(pair, 0) + cnt
    for k, _v in s.tp_pair_to_match_num:
        s.tp_key_to_domains_num[k] = s.tp_key_to_domains_num.get(k, 0) + 1
    return s


def update_for_pod(s: PreFilterState, pod: Pod, other: Pod, node: Optional[Node],
                   delta: int) -> None:
    """The AddPod (``delta`` 1) and RemovePod (-1) extensions
    (filtering.go:166,177): only a node counted at PreFilter is updated."""
    if not s.constraints or node is None or not _matches_node_affinity(pod, node):
        return
    if other.meta.namespace != pod.meta.namespace:
        return
    labels = node.meta.labels
    if any(c.topology_key not in labels for c in s.constraints):
        return
    for c in s.constraints:
        if _selector_of(c).matches(other.meta.labels):
            pair = (c.topology_key, labels[c.topology_key])
            s.tp_pair_to_match_num[pair] = s.tp_pair_to_match_num.get(pair, 0) + delta


def filter_node(s: PreFilterState, pod: Pod, ni: NodeInfo) -> Optional[str]:
    """(filtering.go:335) None when the node passes every constraint."""
    labels = ni.node.meta.labels
    for c in s.constraints:
        if c.topology_key not in labels:
            return ERR_REASON_LABEL
        min_match = s.min_match_num(c.topology_key, c.min_domains)
        self_match = 1 if _selector_of(c).matches(pod.meta.labels) else 0
        match_num = s.tp_pair_to_match_num.get((c.topology_key, labels[c.topology_key]), 0)
        if match_num + self_match - min_match > c.max_skew:
            return ERR_REASON_CONSTRAINTS
    return None


@dataclass
class PreScoreState:
    constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    ignored_nodes: Set[str] = field(default_factory=set)
    pair_counts: Dict[Tuple[str, str], int] = field(default_factory=dict)
    weights: List[float] = field(default_factory=list)


def pre_score(pod: Pod, filtered: Sequence[Node], node_infos: Iterable[NodeInfo],
              defaults: Sequence[TopologySpreadConstraint] = (),
              system_defaulted: bool = False) -> PreScoreState:
    constraints = constraints_of(pod, SCHEDULE_ANYWAY, defaults)
    s = PreScoreState(constraints=constraints)
    if not constraints:
        return s
    # system defaults score nodes that lack a key, too (plugin.go systemDefaulted)
    require_all = bool(pod.spec.topology_spread_constraints) or not system_defaulted
    sizes = [0] * len(constraints)
    for node in filtered:
        labels = node.meta.labels
        if require_all and any(c.topology_key not in labels for c in constraints):
            s.ignored_nodes.add(node.meta.name)
            continue
        for i, c in enumerate(constraints):
            if c.topology_key == LABEL_HOSTNAME:
                continue
            pair = (c.topology_key, labels.get(c.topology_key, ""))
            if pair not in s.pair_counts:
                s.pair_counts[pair] = 0
                sizes[i] += 1
    for i, c in enumerate(constraints):
        size = sizes[i]
        if c.topology_key == LABEL_HOSTNAME:
            size = len(filtered) - len(s.ignored_nodes)
        s.weights.append(math.log(size + 2))
    for ni in node_infos:
        node = ni.node
        if node is None or not _matches_node_affinity(pod, node):
            continue
        labels = node.meta.labels
        if require_all and any(c.topology_key not in labels for c in constraints):
            continue
        for c in constraints:
            pair = (c.topology_key, labels.get(c.topology_key, ""))
            if pair in s.pair_counts:
                s.pair_counts[pair] += _count_matching(ni.pods, _selector_of(c),
                                                       pod.meta.namespace)
    return s


def score_node(s: PreScoreState, pod: Pod, ni: NodeInfo) -> int:
    node = ni.node
    if not s.constraints or node.meta.name in s.ignored_nodes:
        return 0
    labels = node.meta.labels
    score = 0.0
    for i, c in enumerate(s.constraints):
        if c.topology_key not in labels:
            continue
        if c.topology_key == LABEL_HOSTNAME:
            cnt = _count_matching(ni.pods, _selector_of(c), pod.meta.namespace)
        else:
            cnt = s.pair_counts.get((c.topology_key, labels[c.topology_key]), 0)
        score += cnt * s.weights[i] + (c.max_skew - 1)
    return round(score)


def normalize_score(s: PreScoreState, scores: Dict[str, int]) -> None:
    """In place: the ignored nodes 0, the others reversed against the
    range of the rest."""
    if not s.constraints:
        return
    valid = [v for name, v in scores.items() if name not in s.ignored_nodes]
    if not valid:
        return
    lo, hi = min(valid), max(valid)
    for name, raw in scores.items():
        if name in s.ignored_nodes:
            scores[name] = 0
        elif hi == 0:
            scores[name] = MAX_NODE_SCORE
        else:
            scores[name] = MAX_NODE_SCORE * (hi + lo - raw) // hi


class PodTopologySpread:
    def __init__(self, snapshot_fn=None,
                 default_constraints: Tuple[TopologySpreadConstraint, ...] = (),
                 system_defaulted: bool = False):
        self.snapshot_fn = snapshot_fn or (lambda: ())
        self.default_constraints = default_constraints
        self.system_defaulted = system_defaulted

    def name(self) -> str:
        return names.POD_TOPOLOGY_SPREAD

    @staticmethod
    def events_to_register():
        return [ClusterEvent(POD, ADD | DELETE), ClusterEvent(NODE, ADD | UPDATE_NODE_LABEL)]

    def pre_filter(self, state, pod: Pod):
        state.spread = pre_filter(pod, self.snapshot_fn(), self.default_constraints)
        return None, None

    def add_pod(self, state, pod: Pod, other: Pod, ni: NodeInfo) -> None:
        update_for_pod(state.spread, pod, other, ni.node, 1)

    def remove_pod(self, state, pod: Pod, other: Pod, ni: NodeInfo) -> None:
        update_for_pod(state.spread, pod, other, ni.node, -1)

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        if not state.spread.constraints:
            return None
        reason = filter_node(state.spread, pod, ni)
        if reason is None:
            return None
        return Fail(names.POD_TOPOLOGY_SPREAD, reason, reason != ERR_REASON_CONSTRAINTS)

    def pre_score(self, state, pod: Pod, feasible) -> None:
        state.data[names.POD_TOPOLOGY_SPREAD] = pre_score(
            pod, [ni.node for ni in feasible], self.snapshot_fn(), self.default_constraints,
            self.system_defaulted)

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        return score_node(state.data[names.POD_TOPOLOGY_SPREAD], pod, ni)

    def normalize_score(self, state, pod: Pod, scores) -> None:
        normalize_score(state.data[names.POD_TOPOLOGY_SPREAD], scores)
