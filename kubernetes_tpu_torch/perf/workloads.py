"""The reference's scheduler_perf workloads the port runs, as API objects.

Transcribed from test/integration/scheduler_perf/config/
performance-config.yaml through ``kubernetes_tpu/perf/workloads.py`` (the
op lists) and ``kubernetes_tpu/perf/harness.py`` (``_node_wrapper`` and
``_pod_wrapper``, the node and pod shapes), at the published sizes:

* SchedulingBasic: nodes of cpu 32 / 128Gi / 110 pods in 10 zones with
  hostname labels; pods asking 900m / 2Gi.
* SchedulingPodAntiAffinity (performance-config.yaml:23-50): pods of
  100m / 500Mi carrying color=green and a required anti-affinity to
  color=green on the hostname key, so each node takes at most one.
* SchedulingPodAffinity (:168-198): every node in one zone; pods carrying
  color=blue with a required affinity to color=blue on the zone key.
* TopologySpreading (:283-308): plain init pods, then pods carrying
  spread-app=spread with a maxSkew 1 DoNotSchedule constraint on the zone
  key over spread-app=spread.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..api.types import LABEL_HOSTNAME, LABEL_TOPOLOGY_ZONE, LabelSelector, Pod
from ..api.wrappers import make_node, make_pod
from ..framework.types import NodeInfo

_NODE_CAPACITY = {"cpu": "32", "memory": "128Gi", "pods": 110}
_DEFAULT_REQ = {"cpu": "900m", "memory": "2Gi"}
_SMALL_REQ = {"cpu": "100m", "memory": "500Mi"}


def scheduling_basic_nodes(count: int, zones: int = 10) -> List[NodeInfo]:
    infos = []
    for i in range(count):
        nw = make_node(f"node-{i}").capacity(_NODE_CAPACITY)
        nw.label(LABEL_TOPOLOGY_ZONE, f"zone-{i % zones}")
        nw.label(LABEL_HOSTNAME, f"node-{i}")
        infos.append(NodeInfo(nw.obj()))
    return infos


def scheduling_basic_pods(prefix: str, count: int) -> List[Pod]:
    return [make_pod(f"{prefix}-{i}").req(_DEFAULT_REQ).obj() for i in range(count)]


@dataclasses.dataclass(frozen=True)
class PodShape:
    """The pods of one createPods or measurePods op, named ``{prefix}-{i}``."""

    prefix: str
    req: Dict[str, str] = dataclasses.field(default_factory=lambda: dict(_DEFAULT_REQ))
    # pod-with-pod-(anti-)affinity.yaml: the pod carries the labels its own
    # required term selects on
    affinity_key: Optional[str] = None
    affinity_labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    anti: bool = False
    # pod-with-topology-spreading.yaml: label spread-app=<prefix>, maxSkew 1
    spread_key: Optional[str] = None

    def pods(self, count: int) -> List[Pod]:
        out = []
        for i in range(count):
            pw = make_pod(f"{self.prefix}-{i}").req(self.req)
            if self.affinity_key:
                for k, v in self.affinity_labels.items():
                    pw.label(k, v)
                pw.pod_affinity(self.affinity_key,
                                LabelSelector(match_labels=dict(self.affinity_labels)),
                                anti=self.anti)
            if self.spread_key:
                pw.label("spread-app", self.prefix)
                pw.spread_constraint(1, self.spread_key,
                                     selector=LabelSelector(match_labels={"spread-app": self.prefix}))
            out.append(pw.obj())
        return out


@dataclasses.dataclass(frozen=True)
class Workload:
    """createNodes, createPods (init), barrier, measurePods (measured)."""

    name: str
    nodes: int
    init: PodShape
    init_pods: int
    measured: PodShape
    measured_pods: int
    one_zone: bool = False  # every node in zone1, else 10 zones

    def node_infos(self) -> List[NodeInfo]:
        if not self.one_zone:
            return scheduling_basic_nodes(self.nodes)
        infos = []
        for i in range(self.nodes):
            nw = make_node(f"node-{i}").capacity(_NODE_CAPACITY)
            nw.label(LABEL_TOPOLOGY_ZONE, "zone1")
            nw.label(LABEL_HOSTNAME, f"node-{i}")
            infos.append(NodeInfo(nw.obj()))
        return infos

    def init_pod_list(self) -> List[Pod]:
        return self.init.pods(self.init_pods)

    def measured_pod_list(self) -> List[Pod]:
        return self.measured.pods(self.measured_pods)


def scheduling_basic(nodes: int = 5000, init_pods: int = 1000,
                     measured: int = 1000) -> Workload:
    return Workload(f"SchedulingBasic/{nodes}Nodes", nodes, PodShape("init"), init_pods,
                    PodShape("measured"), measured)


def scheduling_pod_anti_affinity(nodes: int = 5000, init_pods: int = 1000,
                                 measured: int = 1000) -> Workload:
    shape = dict(req=_SMALL_REQ, affinity_key=LABEL_HOSTNAME,
                 affinity_labels={"color": "green"}, anti=True)
    return Workload(f"SchedulingPodAntiAffinity/{nodes}Nodes", nodes,
                    PodShape("init", **shape), init_pods, PodShape("anti", **shape), measured)


def scheduling_pod_affinity(nodes: int = 5000, init_pods: int = 5000,
                            measured: int = 1000) -> Workload:
    shape = dict(req=_SMALL_REQ, affinity_key=LABEL_TOPOLOGY_ZONE,
                 affinity_labels={"color": "blue"})
    return Workload(f"SchedulingPodAffinity/{nodes}Nodes", nodes,
                    PodShape("init", **shape), init_pods, PodShape("aff", **shape), measured,
                    one_zone=True)


def topology_spreading(nodes: int = 5000, init_pods: int = 5000,
                       measured: int = 2000) -> Workload:
    return Workload(f"TopologySpreading/{nodes}Nodes", nodes, PodShape("init"), init_pods,
                    PodShape("spread", spread_key=LABEL_TOPOLOGY_ZONE), measured)
