"""SlicePacking — torus-contiguous placement for slice gangs, host side.

The port's own copy of ``kubernetes_tpu/framework/plugins/slicepacking.py``
(the sequential twin of the batch program's slice planner): at a slice
gang's first member the PreFilter plans one node per member ordinal with
``ops/slice.py:slice_assign_host`` over the live cluster; the Filter
then pins each member to its planned node. Inert for a pod without the
``ktpu.dev/slice`` marker or without a PodGroup. Coordinates come from the
well-known node labels only.

A plan reserves its nodes (later plans skip them) until every ordinal has
been handed out; a gang's rejection drops it (``forget_gang``), so a
retried gang plans again against the cluster as it is then. The scheduler
loop reaches the plugin through the preemption dry run's filter chain
(``framework/runtime.py``) and ``forget_gang`` after a slice gang's
reject.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ...api.types import Pod
from ...ops.slice import TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL, is_slice_pod, slice_assign_host
from ..interface import Fail
from ..types import NodeInfo
from .coscheduling import pod_group_key
from .noderesources import fits_request

NAME = "SlicePacking"
ERR_NO_SLICE = "no contiguous torus slice for gang"
ERR_OUTSIDE = "node(s) outside the gang's planned torus slice"


class SlicePacking:
    """``node_infos_fn`` lists the cluster's NodeInfos; ``client`` holds
    the PodGroups."""

    def __init__(self, node_infos_fn: Callable[[], Iterable[NodeInfo]], client=None):
        self.node_infos_fn = node_infos_fn
        self.client = client
        self._plans: Dict[str, dict] = {}  # gkey -> {"targets", "next", "seen"}
        self._reserved: Set[str] = set()   # nodes held by live plans

    def name(self) -> str:
        return NAME

    def pre_filter(self, state, pod: Pod):
        """Plans the gang at its first member and sets the member's planned
        node on ``state.slice_target``; (None, None), or (None, the
        failure) when no slice fits."""
        state.slice_target = None
        if not is_slice_pod(pod):
            return None, None
        gkey = pod_group_key(pod)
        if gkey is None:
            return None, None
        plan = self._plans.get(gkey)
        if plan is not None and pod.key() in plan["seen"]:
            # the member is back: the gang's first pass failed somewhere
            self.forget_gang(gkey)
            plan = None
        if plan is None:
            plan = self._compute_plan(gkey, pod)
            if plan is None:
                return None, Fail(NAME, ERR_NO_SLICE, False)
            self._plans[gkey] = plan
            self._reserved.update(plan["targets"])
        target = plan["targets"][plan["next"] % len(plan["targets"])]
        plan["next"] += 1
        plan["seen"].add(pod.key())
        if plan["next"] >= len(plan["targets"]):
            # every ordinal handed out: the members hold the nodes now
            self.forget_gang(gkey)
        state.slice_target = target
        return None, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        """Pins a slice member to its planned node."""
        if not is_slice_pod(pod) or pod_group_key(pod) is None:
            return None
        target = state.slice_target
        if target is None:
            return Fail(NAME, ERR_NO_SLICE, False)
        if ni.node is None or ni.node.meta.name != target:
            return Fail(NAME, ERR_OUTSIDE, False)
        return None

    def forget_gang(self, gkey: str) -> None:
        """Drop a gang's plan and its node reservations."""
        plan = self._plans.pop(gkey, None)
        if plan is not None:
            self._reserved.difference_update(plan["targets"])

    def _want(self, gkey: str) -> int:
        pg = self.client.get_object("PodGroup", gkey) if self.client is not None else None
        return int(pg.min_member) if pg is not None and pg.min_member > 0 else 1

    def _compute_plan(self, gkey: str, pod: Pod) -> Optional[dict]:
        coords: List[Tuple[int, int, NodeInfo]] = []
        for ni in self.node_infos_fn():
            node = ni.node
            if node is None:
                continue
            sp_s = node.meta.labels.get(TOPO_SUPERPOD_LABEL)
            pos_s = node.meta.labels.get(TOPO_SLOT_LABEL)
            if sp_s is None or pos_s is None:
                continue
            try:
                sp, pos = int(sp_s), int(pos_s)
            except (ValueError, OverflowError):
                continue
            if sp >= 0 and pos >= 0:
                coords.append((sp, pos, ni))
        if not coords:
            return None
        grid = (max(c[0] for c in coords) + 1, max(c[1] for c in coords) + 1)
        request = pod.resource_request()
        fits = [not ni.node.spec.unschedulable and ni.node.meta.name not in self._reserved
                and not fits_request(request, ni) for _sp, _pos, ni in coords]
        targets, ok = slice_assign_host([c[0] for c in coords], [c[1] for c in coords],
                                        [True] * len(coords), [fits], [self._want(gkey)], grid)
        if not ok[0]:
            return None
        return {"targets": [coords[t][2].node.meta.name for t in targets[0]], "next": 0,
                "seen": set()}
