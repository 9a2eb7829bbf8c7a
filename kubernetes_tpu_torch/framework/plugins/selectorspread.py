"""SelectorSpread: spread the pods of one service or controller across
nodes and zones (plugins/selectorspread/selector_spread.go). An own copy
of ``kubernetes_tpu/framework/plugins/selectorspread.py``; no default
profile holds it.

PreScore takes the selectors of the services that select the pod and of
its controller (ReplicationController, ReplicaSet or StatefulSet); a node
scores the pods of the pod's namespace, not terminating, that match every
selector. NormalizeScore inverts against the highest count and, when the
nodes carry zones, blends in the zone's inverted count at 2/3. A pod with
topology spread constraints is skipped.
"""

from __future__ import annotations

from typing import Dict, List

from ...api.types import LabelSelector, Pod, get_zone_key
from ..types import MAX_NODE_SCORE, NodeInfo
from . import names

ZONE_WEIGHTING = 2.0 / 3.0  # selector_spread.go:55
_OWNER_KINDS = ("ReplicationController", "ReplicaSet", "StatefulSet")


def default_selector(pod: Pod, store) -> List[LabelSelector]:
    """helper/spread.go DefaultSelector: the selectors that must all
    match."""
    sels: List[LabelSelector] = []
    for svc in store.list_services(pod.meta.namespace):
        if svc.selector and all(pod.meta.labels.get(k) == v for k, v in svc.selector.items()):
            sels.append(LabelSelector(match_labels=dict(svc.selector)))
    owner = pod.meta.controller_of()
    if owner is not None and owner.kind in _OWNER_KINDS:
        obj = store.get_object(owner.kind, f"{pod.meta.namespace}/{owner.name}")
        sel = obj.selector if obj is not None else None
        if isinstance(sel, dict):
            if sel:
                sels.append(LabelSelector(match_labels=dict(sel)))
        elif sel is not None:
            sels.append(sel)
    return sels


class SelectorSpread:
    def __init__(self, store=None, snapshot_fn=None):
        self.store = store
        self.snapshot_fn = snapshot_fn or (lambda: ())

    def name(self) -> str:
        return names.SELECTOR_SPREAD

    def pre_score(self, state, pod: Pod, feasible) -> None:
        if not pod.spec.topology_spread_constraints:
            state.data[names.SELECTOR_SPREAD] = default_selector(pod, self.store)

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        if pod.spec.topology_spread_constraints:
            return 0
        selectors = state.data[names.SELECTOR_SPREAD]
        if not selectors:
            return 0
        return sum(1 for p in ni.pods
                   if p.meta.namespace == pod.meta.namespace and p.meta.deletion_timestamp == 0.0
                   and all(s.matches(p.meta.labels) for s in selectors))

    def normalize_score(self, state, pod: Pod, scores: Dict[str, int]) -> None:
        if pod.spec.topology_spread_constraints:
            return
        by_name = {ni.node.meta.name: ni for ni in self.snapshot_fn() if ni.node is not None}
        counts_by_zone: Dict[str, int] = {}
        zone_of: Dict[str, str] = {}
        max_by_node = 0
        for name, v in scores.items():
            max_by_node = max(max_by_node, v)
            ni = by_name.get(name)
            zone = get_zone_key(ni.node) if ni is not None else ""
            zone_of[name] = zone
            if zone:
                counts_by_zone[zone] = counts_by_zone.get(zone, 0) + v
        max_by_zone = max(counts_by_zone.values(), default=0)
        for name, v in scores.items():
            f = float(MAX_NODE_SCORE)
            if max_by_node > 0:
                f = MAX_NODE_SCORE * (max_by_node - v) / float(max_by_node)
            zone = zone_of[name]
            if counts_by_zone and zone:
                z = float(MAX_NODE_SCORE)
                if max_by_zone > 0:
                    z = MAX_NODE_SCORE * (max_by_zone - counts_by_zone[zone]) / float(max_by_zone)
                f = f * (1.0 - ZONE_WEIGHTING) + ZONE_WEIGHTING * z
            scores[name] = int(f)
