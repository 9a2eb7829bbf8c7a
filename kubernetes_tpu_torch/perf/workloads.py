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
* SchedulingInTreePVs (:74-97): pods of 100m / 500Mi, each with its own
  pre-bound in-tree EBS PV and PVC (pv-aws.yaml, pvc.yaml; ReadOnlyMany,
  1 GiB), as ``kubernetes_tpu/perf/harness.py:511-535`` creates them.
* SchedulingDRA (``kubernetes_tpu/perf/workloads.py:230-258``): nodes
  publishing tpu.dev/cores in [8, 16] and tpu.dev/gen in [v5, v5, v4, v5]
  (value i % len), pods of 100m / 500Mi with one claim from template
  tpu-claim of class tpu.example.com (class: gen == v5; claim: cores >= 8).
  The store holds one ResourceClaim per pod, ``<pod>-accel``, as the JAX
  resourceclaim controller leaves it.

* PreemptionBasic (``kubernetes_tpu/perf/workloads.py:326-344``;
  performance-config.yaml): 500 unlabelled nodes of cpu 4 / 16Gi / 32
  pods; 2000 init pods of 900m / 2Gi at priority 1 (four per node, 3.6 of
  4 CPUs used); 8 warm pods, then 500 measured preemptors of 2 / 4Gi at
  priority 100, each of which must evict victims to fit.
* PreemptionPVs (``kubernetes_tpu/perf/workloads.py:412-431``;
  performance-config.yaml:409-435): the same, with a pre-bound EBS PV and
  PVC per warm pod and preemptor.

``Workload.store()`` builds a fresh object store for the workloads that
need one (claims and volumes), with every pod's objects in it.
``run_with_preemption`` drives a workload through a BatchScheduler and
resubmits the pods it nominated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..api.types import (LABEL_HOSTNAME, LABEL_TOPOLOGY_ZONE, ROX, LabelSelector, ObjectMeta,
                         PersistentVolume, PersistentVolumeClaim, Pod, ResourceClaim,
                         ResourceClass)
from ..api.wrappers import make_node, make_pod
from ..apiserver.store import Store
from ..framework.types import NodeInfo

_NODE_CAPACITY = {"cpu": "32", "memory": "128Gi", "pods": 110}
_DEFAULT_REQ = {"cpu": "900m", "memory": "2Gi"}
_SMALL_REQ = {"cpu": "100m", "memory": "500Mi"}


def scheduling_basic_nodes(count: int, zones: int = 10,
                           device_attributes: Optional[Dict[str, tuple]] = None,
                           capacity: Optional[Dict[str, object]] = None) -> List[NodeInfo]:
    """``device_attributes``: per key, the values node i publishes value
    ``i % len`` of (harness.py ``_node_wrapper``). ``zones`` 0: no zone or
    hostname label, as the harness makes nodes without a zone count."""
    infos = []
    for i in range(count):
        nw = make_node(f"node-{i}").capacity(capacity or _NODE_CAPACITY)
        if zones:
            nw.label(LABEL_TOPOLOGY_ZONE, f"zone-{i % zones}")
            nw.label(LABEL_HOSTNAME, f"node-{i}")
        if device_attributes:
            nw.device_attrs({k: v[i % len(v)] for k, v in device_attributes.items()})
        infos.append(NodeInfo(nw.obj()))
    return infos


def scheduling_basic_pods(prefix: str, count: int) -> List[Pod]:
    return [make_pod(f"{prefix}-{i}").req(_DEFAULT_REQ).obj() for i in range(count)]


@dataclasses.dataclass(frozen=True)
class ClaimShape:
    """One claim-template entry of a pod (``kubernetes_tpu/perf/workloads.py``
    ``scheduling_dra``): the pod's claim ``<pod>-<name>``, of ``klass``,
    with the template's selectors."""

    name: str
    template: str
    klass: str
    class_selectors: Dict[str, object]
    selectors: Dict[str, object]


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
    # a resource.k8s.io claim from a template, one per pod
    claim: Optional[ClaimShape] = None
    # a pre-bound PV (of this in-tree volume type) and PVC per pod
    pv_volume_type: Optional[str] = None
    priority: int = 0

    def pods(self, count: int) -> List[Pod]:
        out = []
        for i in range(count):
            pw = make_pod(f"{self.prefix}-{i}").req(self.req)
            if self.priority:
                pw.priority(self.priority)
            if self.claim:
                pw.resource_claim(self.claim.name, template_name=self.claim.template)
            if self.pv_volume_type is not None:
                pw.pvc(f"pvc-{self.prefix}-{i}")
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

    def populate(self, store: Store, count: int, namespace: str = "default") -> None:
        """The objects of ``count`` pods of this shape: the claim class and
        each pod's claim, or each pod's bound PV and PVC."""
        c = self.claim
        if c and store.get_object("ResourceClass", c.klass) is None:
            store.create_object("ResourceClass", ResourceClass(
                meta=ObjectMeta(name=c.klass, namespace=""), driver_name=c.klass,
                selectors=dict(c.class_selectors)))
        for i in range(count if c or self.pv_volume_type is not None else 0):
            if c:
                store.create_object("ResourceClaim", ResourceClaim(
                    meta=ObjectMeta(name=f"{self.prefix}-{i}-{c.name}", namespace=namespace),
                    resource_class_name=c.klass, selectors=dict(c.selectors)))
            if self.pv_volume_type is not None:
                pv_name, pvc_name = f"pv-{self.prefix}-{i}", f"pvc-{self.prefix}-{i}"
                store.create_pv(PersistentVolume(
                    meta=ObjectMeta(name=pv_name), capacity_bytes=1 << 30,
                    bound_pvc=f"{namespace}/{pvc_name}", access_modes=(ROX,),
                    volume_type=self.pv_volume_type))
                store.create_pvc(PersistentVolumeClaim(
                    meta=ObjectMeta(name=pvc_name, namespace=namespace,
                                    annotations={"pv.kubernetes.io/bind-completed": "true"}),
                    bound_pv=pv_name, access_modes=(ROX,), requested_bytes=1 << 30))


@dataclasses.dataclass(frozen=True)
class Workload:
    """createNodes, createPods (init, then warm), barrier, measurePods
    (measured)."""

    name: str
    nodes: int
    init: PodShape
    init_pods: int
    measured: PodShape
    measured_pods: int
    one_zone: bool = False  # every node in zone1, else ``zones`` zones
    device_attributes: Optional[Dict[str, tuple]] = None
    zones: int = 10  # 0: nodes without zone or hostname labels
    node_capacity: Optional[Dict[str, object]] = None  # default cpu 32 / 128Gi / 110 pods
    warm: Optional[PodShape] = None
    warm_pods: int = 0

    def node_infos(self) -> List[NodeInfo]:
        if not self.one_zone:
            return scheduling_basic_nodes(self.nodes, self.zones, self.device_attributes,
                                          self.node_capacity)
        infos = []
        for i in range(self.nodes):
            nw = make_node(f"node-{i}").capacity(_NODE_CAPACITY)
            nw.label(LABEL_TOPOLOGY_ZONE, "zone1")
            nw.label(LABEL_HOSTNAME, f"node-{i}")
            infos.append(NodeInfo(nw.obj()))
        return infos

    def init_pod_list(self) -> List[Pod]:
        return self.init.pods(self.init_pods)

    def warm_pod_list(self) -> List[Pod]:
        return self.warm.pods(self.warm_pods) if self.warm else []

    def measured_pod_list(self) -> List[Pod]:
        return self.measured.pods(self.measured_pods)

    def store(self) -> Optional[Store]:
        """A fresh object store with every pod's claims or volumes, or None
        when the workload needs none."""
        shapes = ((self.init, self.init_pods), (self.measured, self.measured_pods))
        if self.warm:
            shapes += ((self.warm, self.warm_pods),)
        if not any(s.claim or s.pv_volume_type is not None for s, _ in shapes):
            return None
        store = Store()
        for shape, count in shapes:
            shape.populate(store, count)
        return store


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


def scheduling_intree_pvs(nodes: int = 5000, init_pods: int = 5000,
                          measured: int = 1000) -> Workload:
    shape = dict(req=_SMALL_REQ, pv_volume_type="ebs")
    return Workload(f"SchedulingInTreePVs/{nodes}Nodes", nodes, PodShape("init", **shape),
                    init_pods, PodShape("pv", **shape), measured)


TPU_CLAIM = ClaimShape("accel", "tpu-claim", "tpu.example.com",
                       class_selectors={"tpu.dev/gen": "v5"},
                       selectors={"tpu.dev/cores": ">=8"})


def scheduling_dra(nodes: int = 5000, init_pods: int = 1000, measured: int = 1000) -> Workload:
    shape = dict(req=_SMALL_REQ, claim=TPU_CLAIM)
    return Workload(f"SchedulingDRA/{nodes}Nodes", nodes, PodShape("init", **shape), init_pods,
                    PodShape("dra", **shape), measured,
                    device_attributes={"tpu.dev/cores": (8, 16),
                                       "tpu.dev/gen": ("v5", "v5", "v4", "v5")})


_PREEMPTION_NODE = {"cpu": "4", "memory": "16Gi", "pods": 32}
_VICTIM = dict(req={"cpu": "900m", "memory": "2Gi"}, priority=1)
_PREEMPTOR = dict(req={"cpu": "2", "memory": "4Gi"}, priority=100)
_WARM_PREEMPTORS = 8
MAX_PREEMPTION_ROUNDS = 8


def preemption_basic(nodes: int = 500, init_pods: int = 2000, measured: int = 500) -> Workload:
    return Workload(f"PreemptionBasic/{nodes}Nodes", nodes, PodShape("victim", **_VICTIM),
                    init_pods, PodShape("preemptor", **_PREEMPTOR), measured, zones=0,
                    node_capacity=_PREEMPTION_NODE, warm=PodShape("warm", **_PREEMPTOR),
                    warm_pods=_WARM_PREEMPTORS)


def preemption_pvs(nodes: int = 500, init_pods: int = 2000, measured: int = 500) -> Workload:
    shape = dict(_PREEMPTOR, pv_volume_type="ebs")
    return Workload(f"PreemptionPVs/{nodes}Nodes", nodes, PodShape("victim", **_VICTIM),
                    init_pods, PodShape("preemptor", **shape), measured, zones=0,
                    node_capacity=_PREEMPTION_NODE, warm=PodShape("warm", **shape),
                    warm_pods=_WARM_PREEMPTORS)


def run_with_preemption(sched, w: Workload
                        ) -> Tuple[Dict[str, Optional[str]], List[Dict[str, str]]]:
    """Schedule the init, warm and measured pods in that order, then
    resubmit the pods ``sched`` nominated, in that order, until none is
    left or ``MAX_PREEMPTION_ROUNDS`` rounds ran. Returns (pod key -> node or None,
    the nominations before each round)."""
    ops = (w.init_pod_list(), w.warm_pod_list(), w.measured_pod_list())
    placed: Dict[str, Optional[str]] = {}
    for op in ops:
        placed.update(sched.schedule(op))
    pods = [p for op in ops for p in op]
    rounds: List[Dict[str, str]] = []
    while sched.nominated and len(rounds) < MAX_PREEMPTION_ROUNDS:
        rounds.append(dict(sched.nominated))
        placed.update(sched.schedule([p for p in pods if p.key() in sched.nominated]))
    return placed, rounds
