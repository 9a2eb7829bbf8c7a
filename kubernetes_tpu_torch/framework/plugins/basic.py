"""The simple per-node plugins: PrioritySort, NodeUnschedulable,
NodeName, TaintToleration and NodePorts.

An own copy of ``kubernetes_tpu/framework/plugins/basic.py``: the Filters
as plain functions on NodeInfo (None when the node passes, else the
plugin's reason), TaintToleration's PreScore and Score (the untolerated
PreferNoSchedule taints, normalized reversed), and the plugin objects the
registry builds (``framework/registry.py``), each with exactly the points
of its JAX counterpart. The preemption dry run and the sequential path
run them through ``framework/runtime.py``; the batched path computes the
same predicates on the device (``ops/filters.py``).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from ...api.types import (TAINT_NO_EXECUTE, TAINT_NO_SCHEDULE, TAINT_PREFER_NO_SCHEDULE,
                          ContainerPort, Pod, Taint, Toleration)
from ..interface import Fail
from ..types import (ADD, DELETE, MAX_NODE_SCORE, NODE, POD, UPDATE_NODE_TAINT, ClusterEvent,
                     NodeInfo, default_normalize_score, ports_conflict)
from . import names

ERR_REASON_UNSCHEDULABLE = "node(s) were unschedulable"
ERR_REASON_NODE_NAME = "node(s) didn't match the requested node name"
ERR_REASON_PORTS = "node(s) didn't have free ports for the requested pod ports"
_UNSCHEDULABLE_TAINT = Taint(key="node.kubernetes.io/unschedulable", effect=TAINT_NO_SCHEDULE)


def node_unschedulable_filter(pod: Pod, ni: NodeInfo) -> Optional[str]:
    """nodeunschedulable/node_unschedulable.go: a spec.unschedulable node
    admits only pods that tolerate the unschedulable taint."""
    node = ni.node
    if node is None:
        return "node(s) had unknown conditions"
    if node.spec.unschedulable and not any(
            t.tolerates(_UNSCHEDULABLE_TAINT) for t in pod.spec.tolerations):
        return ERR_REASON_UNSCHEDULABLE
    return None


def node_name_filter(pod: Pod, ni: NodeInfo) -> Optional[str]:
    """nodename/node_name.go: pod.spec.nodeName must match, if set."""
    if pod.spec.node_name and ni.node and pod.spec.node_name != ni.node.meta.name:
        return ERR_REASON_NODE_NAME
    return None


def find_matching_untolerated_taint(taints: Iterable[Taint], tolerations: Iterable[Toleration],
                                    effects) -> Optional[Taint]:
    """v1helper.FindMatchingUntoleratedTaint over the given effects."""
    tolerations = tuple(tolerations)
    for t in taints:
        if t.effect in effects and not any(tol.tolerates(t) for tol in tolerations):
            return t
    return None


def taint_toleration_filter(pod: Pod, ni: NodeInfo) -> Optional[str]:
    """tainttoleration/taint_toleration.go: every NoSchedule / NoExecute
    taint must be tolerated."""
    taint = find_matching_untolerated_taint(
        ni.node.spec.taints if ni.node else (), pod.spec.tolerations,
        (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE))
    if taint is None:
        return None
    return f"node(s) had untolerated taint {{{taint.key}: {taint.value}}}"


def node_ports_filter(wanted: Tuple[ContainerPort, ...], ni: NodeInfo) -> Optional[str]:
    """nodeports/node_ports.go: the wanted host ports (``pod.host_ports()``,
    the PreFilter's state) must not conflict with the node's used ones."""
    if ports_conflict(ni.used_ports, wanted):
        return ERR_REASON_PORTS
    return None


def taint_toleration_pre_score(pod: Pod) -> Tuple[Toleration, ...]:
    """The pod's tolerations that can tolerate a PreferNoSchedule taint."""
    return tuple(t for t in pod.spec.tolerations if t.effect in ("", TAINT_PREFER_NO_SCHEDULE))


def taint_toleration_score(prefer: Tuple[Toleration, ...], ni: NodeInfo) -> int:
    """The node's PreferNoSchedule taints none of ``prefer`` tolerates."""
    return sum(1 for t in ni.node.spec.taints
               if t.effect == TAINT_PREFER_NO_SCHEDULE
               and not any(tol.tolerates(t) for tol in prefer))


# ----------------------------------------------------------------- the plugin objects


class PrioritySort:
    """queuesort/priority_sort.go: higher priority first, then FIFO."""

    def name(self) -> str:
        return names.PRIORITY_SORT

    def less(self, a, b) -> bool:
        p1, p2 = a.pod.spec.priority, b.pod.spec.priority
        return p1 > p2 or (p1 == p2 and a.timestamp < b.timestamp)


class NodeUnschedulable:
    def name(self) -> str:
        return names.NODE_UNSCHEDULABLE

    @staticmethod
    def events_to_register():
        return [ClusterEvent(NODE, ADD | UPDATE_NODE_TAINT)]

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = node_unschedulable_filter(pod, ni)
        return None if reason is None else Fail(names.NODE_UNSCHEDULABLE, reason, True)


class NodeName:
    def name(self) -> str:
        return names.NODE_NAME

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = node_name_filter(pod, ni)
        return None if reason is None else Fail(names.NODE_NAME, reason, True)


class TaintToleration:
    def name(self) -> str:
        return names.TAINT_TOLERATION

    @staticmethod
    def events_to_register():
        return [ClusterEvent(NODE, ADD | UPDATE_NODE_TAINT)]

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = taint_toleration_filter(pod, ni)
        return None if reason is None else Fail(names.TAINT_TOLERATION, reason, True)

    def pre_score(self, state, pod: Pod, feasible) -> None:
        state.data[names.TAINT_TOLERATION] = taint_toleration_pre_score(pod)

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        return taint_toleration_score(state.data[names.TAINT_TOLERATION], ni)

    def normalize_score(self, state, pod: Pod, scores) -> None:
        default_normalize_score(MAX_NODE_SCORE, True, scores)


class NodePorts:
    def name(self) -> str:
        return names.NODE_PORTS

    @staticmethod
    def events_to_register():
        return [ClusterEvent(POD, DELETE), ClusterEvent(NODE, ADD)]

    def pre_filter(self, state, pod: Pod):
        state.ports = pod.host_ports()
        return None, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = node_ports_filter(state.ports, ni)
        return None if reason is None else Fail(names.NODE_PORTS, reason, False)
