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
* SchedulingGangs (``kubernetes_tpu/perf/workloads.py:261-287``): 5000
  nodes in 10 zones; gangs of 8 and of 32 (init 4 of each, measured 8 of
  each), pods of 100m / 500Mi, each with its PodGroup (minMember = the gang
  size) and a required anti-affinity to its own group on the hostname key
  (one worker per host; ``kubernetes_tpu/perf/harness.py:193-217``).
* SchedulingSlices (``kubernetes_tpu/perf/workloads.py:290-323``): 512
  nodes of cpu 4 / 16Gi / 8 pods labelled superpod ``i // 64`` and slot
  ``i % 64`` (``harness.py:177-185``); slice gangs (the ``ktpu.dev/slice``
  marker, no anti-affinity) of 2 (init 2; measured 4), 8 (measured 2) and
  64 (measured 1) hosts, pods of 3500m / 12Gi, so each fills its host.

A workload's pods follow its op list: the ``init`` shape, then each of
``init_extra``, then ``measured`` and each of ``measured_extra``; a gang's
members are consecutive pods of one op (group ``<prefix>-pg<j // size>``
for the op's j-th pod, as the JAX harness's ``_gang_ordinal``).
``Workload.store()`` builds a fresh object store for the workloads that
need one (claims, volumes and PodGroups), with every pod's objects in it,
and ``Workload.caps()`` the Capacities to run it with (the port raises on
CapacityError where the JAX scheduler grows the axis: the gang workloads
need more topology signatures and a wider torus than
``caps_for_cluster`` gives). * PreemptionAll (a seeded case, not a published workload):
  PreemptionBasic's 500 nodes and 2000 priority-1 victims, with
  SchedulingBasic's zone and hostname labels and SchedulingDRA's device
  attributes on the nodes, then 128 priority-100 preemptors of 2 / 4Gi of
  each of three kinds, in this order: with SchedulingDRA's claim (mode
  ``off``), SchedulingPodAntiAffinity's term (mode ``host``) and
  TopologySpreading's zone constraint (mode ``general``).
* SchedulingSoak (``kubernetes_tpu/perf/workloads.py:469-525``, ``Soak``):
  the multi-tenant mix. See ``scheduling_soak`` and ``run_soak``.

``run_loop`` drives a workload through the scheduler loop (the store,
``TPUScheduler.run_until_settled``); ``run_with_preemption`` drives one
through a BatchScheduler and resubmits the pods it nominated;
``slice_stats`` reports contiguity and fragmentation after a run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..api.types import (LABEL_HOSTNAME, LABEL_TOPOLOGY_ZONE, POD_GROUP_LABEL, ROX,
                         LabelSelector, ObjectMeta, PersistentVolume, PersistentVolumeClaim, Pod,
                         PodGroup, ResourceClaim, ResourceClass, SchedulingQuota)
from ..api.wrappers import make_node, make_pod
from ..apiserver.store import Store
from ..backend.device_state import _bucket, caps_for_cluster
from ..framework.plugins.coscheduling import pod_group_key
from ..framework.types import NodeInfo
from ..ops.schema import Capacities
from ..ops.slice import SLICE_LABEL, TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL, fragmentation_host
from ..utils.clock import FakeClock  # noqa: F401  (re-export: Coscheduling's backoff clock)

_NODE_CAPACITY = {"cpu": "32", "memory": "128Gi", "pods": 110}
_DEFAULT_REQ = {"cpu": "900m", "memory": "2Gi"}
_SMALL_REQ = {"cpu": "100m", "memory": "500Mi"}


def scheduling_basic_nodes(count: int, zones: int = 10,
                           device_attributes: Optional[Dict[str, tuple]] = None,
                           capacity: Optional[Dict[str, object]] = None,
                           tpu_slots: int = 0) -> List[NodeInfo]:
    """``device_attributes``: per key, the values node i publishes value
    ``i % len`` of (harness.py ``_node_wrapper``). ``zones`` 0: no zone or
    hostname label, as the harness makes nodes without a zone count.
    ``tpu_slots``: node i is torus host (i // tpu_slots, i % tpu_slots)."""
    infos = []
    for i in range(count):
        nw = make_node(f"node-{i}").capacity(capacity or _NODE_CAPACITY)
        if zones:
            nw.label(LABEL_TOPOLOGY_ZONE, f"zone-{i % zones}")
            nw.label(LABEL_HOSTNAME, f"node-{i}")
        if device_attributes:
            nw.device_attrs({k: v[i % len(v)] for k, v in device_attributes.items()})
        if tpu_slots:
            nw.label(TOPO_SUPERPOD_LABEL, str(i // tpu_slots))
            nw.label(TOPO_SLOT_LABEL, str(i % tpu_slots))
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
    # gang membership: pods i // gang_size share the PodGroup
    # <prefix>-pg<i // gang_size>. A flat gang's members are anti-affine to
    # their own group on the hostname key; a slice gang's (``slice``) carry
    # the slice marker instead
    gang_size: int = 0
    slice: bool = False

    def pods(self, count: int) -> List[Pod]:
        out = []
        for i in range(count):
            pw = make_pod(f"{self.prefix}-{i}").req(self.req)
            if self.gang_size:
                group = f"{self.prefix}-pg{i // self.gang_size}"
                pw.pod_group(group)
                if self.slice:
                    pw.label(SLICE_LABEL, "1")
                else:
                    pw.pod_affinity(LABEL_HOSTNAME,
                                    LabelSelector(match_labels={POD_GROUP_LABEL: group}),
                                    anti=True)
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

    @property
    def needs_store(self) -> bool:
        return bool(self.claim or self.pv_volume_type is not None or self.gang_size)

    def populate(self, store: Store, count: int, namespace: str = "default") -> None:
        """The objects of ``count`` pods of this shape: the claim class and
        each pod's claim, or each pod's bound PV and PVC, and each gang's
        PodGroup (minMember = the gang size)."""
        for g in range(-(-count // self.gang_size) if self.gang_size else 0):
            store.create_object("PodGroup", PodGroup(
                meta=ObjectMeta(name=f"{self.prefix}-pg{g}", namespace=namespace),
                min_member=self.gang_size))
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
    """createNodes, createPods (init and init_extra, then warm), barrier,
    measurePods (measured and measured_extra)."""

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
    # further createPods / measurePods ops, in order: (shape, count)
    init_extra: Tuple[Tuple[PodShape, int], ...] = ()
    measured_extra: Tuple[Tuple[PodShape, int], ...] = ()
    tpu_slots: int = 0  # torus coordinate labels (scheduling_basic_nodes)
    cap_overrides: Optional[Dict[str, int]] = None  # Capacities fields over caps_for_cluster

    @property
    def n_init(self) -> int:
        return self.init_pods + sum(c for _, c in self.init_extra)

    @property
    def n_measured(self) -> int:
        return self.measured_pods + sum(c for _, c in self.measured_extra)

    def caps(self) -> Capacities:
        return dataclasses.replace(caps_for_cluster(self.nodes), **(self.cap_overrides or {}))

    def _ops(self) -> Tuple[Tuple[PodShape, int], ...]:
        ops = ((self.init, self.init_pods),) + self.init_extra
        if self.warm:
            ops += ((self.warm, self.warm_pods),)
        return ops + ((self.measured, self.measured_pods),) + self.measured_extra

    def node_infos(self) -> List[NodeInfo]:
        if not self.one_zone:
            return scheduling_basic_nodes(self.nodes, self.zones, self.device_attributes,
                                          self.node_capacity, self.tpu_slots)
        infos = []
        for i in range(self.nodes):
            nw = make_node(f"node-{i}").capacity(_NODE_CAPACITY)
            nw.label(LABEL_TOPOLOGY_ZONE, "zone1")
            nw.label(LABEL_HOSTNAME, f"node-{i}")
            infos.append(NodeInfo(nw.obj()))
        return infos

    def init_pod_list(self) -> List[Pod]:
        return [p for shape, count in ((self.init, self.init_pods),) + self.init_extra
                for p in shape.pods(count)]

    def warm_pod_list(self) -> List[Pod]:
        return self.warm.pods(self.warm_pods) if self.warm else []

    def measured_pod_list(self) -> List[Pod]:
        return [p for shape, count in ((self.measured, self.measured_pods),) + self.measured_extra
                for p in shape.pods(count)]

    def store(self) -> Optional[Store]:
        """A fresh object store with every pod's claims, volumes and
        PodGroups, or None when the workload needs none."""
        shapes = self._ops()
        if not any(s.needs_store for s, _ in shapes):
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
MAX_PREEMPTION_ROUNDS = 16


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


def preemption_all(nodes: int = 500, init_pods: int = 2000, per_kind: int = 128) -> Workload:
    """The three preemptor kinds in their own batches of ``per_kind`` (a
    multiple of the batch size keeps them apart)."""
    claim = PodShape("pre-claim", claim=TPU_CLAIM, **_PREEMPTOR)
    anti = PodShape("pre-anti", affinity_key=LABEL_HOSTNAME,
                    affinity_labels={"color": "green"}, anti=True, **_PREEMPTOR)
    spread = PodShape("pre-spread", spread_key=LABEL_TOPOLOGY_ZONE, **_PREEMPTOR)
    return Workload(f"PreemptionAll/{nodes}Nodes", nodes, PodShape("victim", **_VICTIM),
                    init_pods, claim, per_kind, node_capacity=_PREEMPTION_NODE,
                    measured_extra=((anti, per_kind), (spread, per_kind)),
                    device_attributes={"tpu.dev/cores": (8, 16),
                                       "tpu.dev/gen": ("v5", "v5", "v4", "v5")})


def scheduling_gangs(nodes: int = 5000, init_gangs: int = 4, measured_gangs: int = 8) -> Workload:
    g8 = dict(req=_SMALL_REQ, gang_size=8)
    g32 = dict(req=_SMALL_REQ, gang_size=32)
    # every group's anti-affinity selector is a signature of its own, and
    # every group's term an existing-pod term (one row each is reserved)
    rows = _bucket(2 * (init_gangs + measured_gangs) + 1)
    return Workload(f"SchedulingGangs/{nodes}Nodes", nodes, PodShape("initg8", **g8),
                    init_gangs * 8, PodShape("g8", **g8), measured_gangs * 8,
                    init_extra=((PodShape("initg32", **g32), init_gangs * 32),),
                    measured_extra=((PodShape("g32", **g32), measured_gangs * 32),),
                    cap_overrides={"sigs": rows, "ex_terms": rows})


def scheduling_slices(nodes: int = 512, slots: int = 64, init_gangs: int = 2,
                      measured_small: int = 4, measured_medium: int = 2,
                      measured_large: int = 1) -> Workload:
    """``measured_large`` gangs of 64 hosts need ``slots`` >= 64."""
    host = dict(req={"cpu": "3500m", "memory": "12Gi"}, slice=True)
    extra = ((PodShape("s32c", gang_size=8, **host), measured_medium * 8),)
    if measured_large:
        extra += ((PodShape("s256c", gang_size=64, **host), measured_large * 64),)
    return Workload(f"SchedulingSlices/{nodes}Nodes", nodes,
                    PodShape("init8c", gang_size=2, **host), init_gangs * 2,
                    PodShape("s8c", gang_size=2, **host), measured_small * 2,
                    zones=0, node_capacity={"cpu": "4", "memory": "16Gi", "pods": 8},
                    measured_extra=extra, tpu_slots=slots,
                    cap_overrides={"sp_slots": max(slots, caps_for_cluster(nodes).sp_slots)})


def slice_stats(node_infos) -> Dict[str, float]:
    """Slice-packing evidence from the cluster after a run (the JAX
    harness's ``collect_slice_stats``): per-superpod fragmentation over the
    pod-less labelled hosts, the bound slice gangs, and the contiguity
    violations among them (members not on consecutive slots of one
    superpod, one per host)."""
    coords: Dict[str, Tuple[int, int]] = {}
    occupied: Dict[str, int] = {}
    gangs: Dict[str, List[str]] = {}
    for ni in node_infos:
        name = ni.node.meta.name
        sp_s = ni.node.meta.labels.get(TOPO_SUPERPOD_LABEL)
        pos_s = ni.node.meta.labels.get(TOPO_SLOT_LABEL)
        if sp_s is not None and pos_s is not None:
            coords[name] = (int(sp_s), int(pos_s))
        occupied[name] = len(ni.pods)
        for p in ni.pods:
            gkey = pod_group_key(p)
            if gkey is not None and p.meta.labels.get(SLICE_LABEL):
                gangs.setdefault(gkey, []).append(name)
    frag = [0.0]
    if coords:
        names = sorted(coords)
        grid = (max(c[0] for c in coords.values()) + 1, max(c[1] for c in coords.values()) + 1)
        rows = fragmentation_host([coords[n][0] for n in names], [coords[n][1] for n in names],
                                  [True] * len(names), [occupied[n] == 0 for n in names], grid)
        frag = [r["frag"] for r in rows] or frag
    violations = 0
    for members in gangs.values():
        cells = sorted(coords.get(n, (-1, -1)) for n in members)
        pos = [c[1] for c in cells]
        if (cells[0][0] < 0 or len({c[0] for c in cells}) != 1 or len(set(pos)) != len(pos)
                or pos[-1] - pos[0] != len(pos) - 1):
            violations += 1
    return {"FragmentationMax": max(frag), "FragmentationMean": sum(frag) / len(frag),
            "ContiguityViolations": float(violations), "BoundSliceGangs": float(len(gangs))}


def run_with_preemption(sched, w: Workload
                        ) -> Tuple[Dict[str, Optional[str]], List[Dict[str, str]]]:
    """Schedule the init, warm and measured pods in that order, then
    resubmit the pods ``sched`` nominated, in that order, until none is
    left or ``MAX_PREEMPTION_ROUNDS`` rounds ran. Returns (pod key -> node
    or None, the nominations before each round)."""
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


def span_overlap_s(a: Sequence[tuple], b: Sequence[tuple]) -> float:
    """Seconds covered by a span of ``a`` and a span of ``b`` at once; each
    list holds (start, end) spans in time order that do not overlap each
    other."""
    total, j = 0.0, 0
    for start, end in a:
        while j < len(b) and b[j][1] <= start:
            j += 1
        k = j
        while k < len(b) and b[k][0] < end:
            total += min(end, b[k][1]) - max(start, b[k][0])
            k += 1
    return total


def run_loop(w: Workload, device, percentage: int = 0, batch_size: int = 128,
             batch_deadline_ms: Optional[float] = 0) -> dict:
    """Drive ``w`` through the scheduler loop, as the JAX harness's Runner
    does (``kubernetes_tpu/perf/harness.py:309-700``): a fresh ``Store``
    and ``TPUScheduler(store, device, ...)``; the nodes created, then the
    init pods (and warm pods) created and settled; then the measured pods
    created and settled, the measured phase timed on the host's clock from
    the first create to the settle. ``percentage`` is
    percentageOfNodesToScore (0: the adaptive default);
    ``batch_deadline_ms`` None takes the loop's default
    (``KTPU_BATCH_DEADLINE_MS``).

    Returns a dict: ``placed`` (pod key -> node, "" when unbound),
    ``pods_per_s`` (measured pods over the measured phase's seconds),
    ``measured_s``, ``attempt_ms`` (p50 / p90 / p99 of the measured phase's
    scheduled attempts, pop to commit), ``batches``, ``paths``, ``modes``
    ``batch_pods`` and ``buckets`` (per batch: its pods, and the pod axis
    its program ran at),
    ``launches`` (fused-kernel launches over the run), ``stage_ms`` (the
    scheduling thread's host stages summed over the run),
    ``measured_stage_ms`` (summed over the measured phase),
    ``measured_commit_ms`` (the commits' wait, bind and reconcile over the
    measured phase, on whichever thread ran them), ``measured_batch_ms``
    (each measured cycle's host ms on the scheduling thread),
    ``measured_idle_ms`` (the settle loop's no-progress sleeps in the
    measured phase), ``measured_dispatch_ms`` (the scheduling thread's
    encode and dispatch spans in the measured phase), ``measured_commit_host_ms``
    (the commits' spans after their read) and ``measured_overlap_ms`` (the
    time in both at once: with the commit worker, its host commit running
    beside the scheduling thread's encode and dispatch), ``measured_batches``, ``carry_batches`` (batches encoded on the ring's
    carry) and ``measured_carry_batches``, ``caps`` (the mirror's final
    capacities) and ``grown`` (those above ``caps_for_cluster``'s),
    ``pipeline_depth``,
    ``commit_worker``, ``cycles`` (pods popped, per settle), ``metrics``,
    ``pending``, ``preempted`` (victim -> preemptor), ``nominations`` (in
    order), ``start`` (the sampling window's final start, or None) and
    ``settle_abandoned``. The loop's commit worker is stopped before it
    returns."""
    import gc
    import time

    from ..backend.device_state import caps_for_cluster
    from ..backend.tpu_scheduler import TPUScheduler
    from ..ops import fused_step

    if w.store() is not None:
        raise NotImplementedError(f"{w.name}: claims, volumes or PodGroups need the loop's "
                                  "gang and quota part")
    store = Store()
    sched = TPUScheduler(store, device=device, batch_size=batch_size,
                         batch_deadline_ms=batch_deadline_ms,
                         percentage_of_nodes_to_score=percentage)
    launches = fused_step.LAUNCHES
    for ni in w.node_infos():
        store.create_node(ni.node)
    cycles = []
    for pods in (w.init_pod_list(), w.warm_pod_list()):
        for pod in pods:
            store.create_pod(pod)
        cycles.append(sched.run_until_settled())
    # collect the garbage of earlier runs in this process before the clock
    # starts, so that its collection pauses do not land in the measured phase
    gc.collect()
    hist = sched.smetrics.scheduling_attempt_duration
    n_before = hist.count("scheduled", sched.profile.name)
    stages0, n_cycles = dict(sched.stage_seconds), len(sched.cycle_seconds)
    commit0, batches0, carry0 = dict(sched.commit_seconds), sched.batch_counter, \
        sched.carry_batches
    idle0 = sched.idle_seconds
    spans0 = (len(sched.dispatch_spans), len(sched.commit_spans))
    t0 = time.perf_counter()
    for pod in w.measured_pod_list():
        store.create_pod(pod)
    cycles.append(sched.run_until_settled())
    measured_s = time.perf_counter() - t0
    sched.close()
    dispatch_spans = sched.dispatch_spans[spans0[0]:]
    commit_spans = [s for s in sched.commit_spans[spans0[1]:] if s[0] >= t0]
    attempt_ms = {f"p{q}": hist.quantile(q / 100, "scheduled", sched.profile.name,
                                          since=n_before) * 1e3 for q in (50, 90, 99)}
    return {
        "placed": {k: p.spec.node_name for k, p in store.pods.items()},
        "pods_per_s": w.n_measured / measured_s, "measured_s": measured_s,
        "attempt_ms": attempt_ms, "batches": sched.batch_counter,
        "paths": list(sched.batch_paths), "modes": list(sched.batch_modes),
        "buckets": list(sched.batch_buckets), "batch_pods": list(sched.batch_pods),
        "launches": fused_step.LAUNCHES - launches,
        "stage_ms": {k: v * 1e3 for k, v in sched.stage_seconds.items()},
        "measured_stage_ms": {k: (v - stages0[k]) * 1e3 for k, v in sched.stage_seconds.items()},
        "measured_commit_ms": {k: (v - commit0[k]) * 1e3
                               for k, v in sched.commit_seconds.items()},
        "measured_batch_ms": [t * 1e3 for t in sched.cycle_seconds[n_cycles:]],
        "measured_batches": sched.batch_counter - batches0,
        "measured_idle_ms": (sched.idle_seconds - idle0) * 1e3,
        "measured_dispatch_ms": sum(b - a for a, b in dispatch_spans) * 1e3,
        "measured_commit_host_ms": sum(b - a for a, b in commit_spans) * 1e3,
        "measured_overlap_ms": span_overlap_s(dispatch_spans, commit_spans) * 1e3,
        "carry_batches": sched.carry_batches,
        "measured_carry_batches": sched.carry_batches - carry0,
        "caps": dataclasses.asdict(sched.state.caps),
        "grown": {k: v for k, v in dataclasses.asdict(sched.state.caps).items()
                  if v != getattr(caps_for_cluster(len(store.nodes), batch=batch_size), k)},
        "pipeline_depth": sched.pipeline_depth,
        "commit_worker": sched.commit_worker is not None,
        "cycles": cycles, "metrics": dict(sched.metrics),
        "pending": sched.queue.pending_pods(), "preempted": dict(sched.preempted),
        "nominations": list(sched.nominations),
        "start": None if sched._start_carry is None else int(sched._start_carry),
        "settle_abandoned": sched.settle_abandoned,
    }


# ----------------------------------------------------------------- SchedulingSoak

# (tenant, weight): quota caps scale with the weight
SOAK_TENANTS = (("soak-a", 4), ("soak-b", 2), ("soak-c", 1))
SOAK_CLAIM = ClaimShape("accel", "soak-claim", "tpu.example.com",
                        class_selectors={"tpu.dev/gen": "v5"},
                        selectors={"tpu.dev/cores": ">=8"})
# the JAX soak's defaults: after each round this share of each tenant's
# soak-bound pods leaves, and Coscheduling's clock advances by
# cycles x tick seconds
SOAK_CHURN_FRAC = 0.25
SOAK_CYCLES_PER_ROUND = 120
SOAK_TICK_S = 0.05


@dataclasses.dataclass(frozen=True)
class SoakArrival:
    """One entry of the soak's per-round mix: ``count`` pods of
    ``namespace`` every ``every`` rounds, named ``<prefix>-m<entry>r<round>-
    <n>`` with ``n`` the soak's running pod count (the JAX harness's
    ``_pod_counter``). A gang entry's pods share one PodGroup per
    ``gang_size`` consecutive pods and are anti-affine to their own group on
    the hostname key (``kubernetes_tpu/perf/harness.py:193-217``)."""

    namespace: str
    count: int
    every: int = 1
    prefix: str = ""
    req: Dict[str, str] = dataclasses.field(default_factory=lambda: dict(_SMALL_REQ))
    gang_size: int = 0
    claim: Optional[ClaimShape] = None
    priority: int = 0

    def pods(self, entry: int, r: int, counter: int) -> List[Pod]:
        prefix = f"{self.prefix or self.namespace}-m{entry}r{r}"
        out = []
        for j in range(self.count):
            pw = make_pod(f"{prefix}-{counter + j}", namespace=self.namespace).req(self.req)
            if self.gang_size:
                group = f"{prefix}-pg{j // self.gang_size}"
                pw.pod_group(group)
                pw.pod_affinity(LABEL_HOSTNAME,
                                LabelSelector(match_labels={POD_GROUP_LABEL: group}), anti=True)
            if self.priority:
                pw.priority(self.priority)
            if self.claim:
                pw.resource_claim(self.claim.name, template_name=self.claim.template)
            out.append(pw.obj())
        return out


@dataclasses.dataclass(frozen=True)
class Soak:
    """SchedulingSoak (``kubernetes_tpu/perf/workloads.py:469-525``): 1000
    nodes of cpu 4 / 16Gi / 32 pods in 10 zones publishing SchedulingDRA's
    device attributes; three tenants with SchedulingQuotas of weights 4 / 2
    / 1 whose caps are ``pods`` = ``requests.cpu`` / 1000 = ``claims`` =
    weight x ``scale``; per round each tenant's weight x ``scale`` / 2
    plain pods of 100m / 500Mi, a gang of 8 in soak-a every 2 rounds,
    ``scale`` / 2 claim pods in soak-b and two preemptors of 2 / 4Gi at
    priority 100 in soak-c every 2 rounds; after each round
    ``SOAK_CHURN_FRAC`` of each tenant's soak-bound pods leave. ``cohort``
    joins the three quotas into one lending pool (the ``/Cohort`` variant);
    a soak without ``gangs`` (``/NoGangs``) registers no anti-affinity term,
    so its batches stay in mode ``off``."""

    name: str
    nodes: int
    rounds: int
    scale: int
    mix: Tuple[SoakArrival, ...]
    cohort: str = ""
    device_attributes: Optional[Dict[str, tuple]] = None

    def node_infos(self) -> List[NodeInfo]:
        return scheduling_basic_nodes(self.nodes, 10, self.device_attributes,
                                      _PREEMPTION_NODE)

    def caps(self) -> Capacities:
        # every gang's anti-affinity selector is a signature of its own, and
        # its term an existing-pod term
        gangs = sum(-(-self.rounds // m.every) * (m.count // m.gang_size)
                    for m in self.mix if m.gang_size)
        rows = _bucket(2 * gangs + 1)
        return dataclasses.replace(caps_for_cluster(self.nodes), sigs=rows, ex_terms=rows)

    def quotas(self) -> List[SchedulingQuota]:
        out = []
        for ns, w in SOAK_TENANTS:
            cap = w * self.scale
            out.append(SchedulingQuota(
                meta=ObjectMeta(name="quota", namespace=ns), weight=w, cohort=self.cohort,
                hard={"pods": cap, "requests.cpu": cap * 1000, "claims": cap}))
        return out

    def store(self) -> Store:
        """A fresh object store with the tenants' SchedulingQuotas."""
        store = Store()
        for q in self.quotas():
            store.create_object("SchedulingQuota", q)
        return store

    def arrivals(self, r: int, counter: int) -> List[Pod]:
        """Round ``r``'s pods, in mix order; ``counter`` pods came before."""
        out: List[Pod] = []
        for entry, m in enumerate(self.mix):
            if r % m.every == 0:
                out += m.pods(entry, r, counter + len(out))
        return out

    def populate(self, store: Store, pods: Iterable[Pod]) -> None:
        """The objects the round's pods need: each gang's PodGroup and each
        claim pod's ResourceClaim (and its class), as the JAX harness and
        its resourceclaim controller make them."""
        for pod in pods:
            gkey = pod_group_key(pod)
            if gkey is not None and store.get_object("PodGroup", gkey) is None:
                size = next(m.gang_size for m in self.mix
                            if m.gang_size and m.namespace == pod.meta.namespace)
                store.create_object("PodGroup", PodGroup(
                    meta=ObjectMeta(name=gkey.split("/", 1)[1], namespace=pod.meta.namespace),
                    min_member=size))
            for entry in pod.spec.resource_claims:
                c = SOAK_CLAIM
                if store.get_object("ResourceClass", c.klass) is None:
                    store.create_object("ResourceClass", ResourceClass(
                        meta=ObjectMeta(name=c.klass, namespace=""), driver_name=c.klass,
                        selectors=dict(c.class_selectors)))
                store.create_object("ResourceClaim", ResourceClaim(
                    meta=ObjectMeta(name=f"{pod.meta.name}-{entry.name}",
                                    namespace=pod.meta.namespace),
                    resource_class_name=c.klass, selectors=dict(c.selectors)))


def scheduling_soak(nodes: int = 1000, rounds: int = 8, scale: int = 24, gangs: bool = True,
                    cohort: str = "") -> Soak:
    """The JAX ``scheduling_soak`` at its published size; ``cohort`` names
    the pool of the ``/Cohort`` variant (the JAX one passes it as is), and
    ``gangs=False`` drops soak-a's gangs, as the JAX one's ``gangs`` does."""
    mix = [SoakArrival(ns, max(w * scale // 2, 2)) for ns, w in SOAK_TENANTS]
    if gangs:
        mix.append(SoakArrival("soak-a", 8, every=2, prefix="gang", gang_size=8))
    mix.append(SoakArrival("soak-b", max(scale // 2, 2), prefix="claim", claim=SOAK_CLAIM))
    mix.append(SoakArrival("soak-c", 2, every=2, prefix="preemptor",
                           req={"cpu": "2", "memory": "4Gi"}, priority=100))
    attrs = {"tpu.dev/cores": (8, 16), "tpu.dev/gen": ("v5", "v5", "v4", "v5")}
    suffix = ("/Cohort" if cohort else "") + ("" if gangs else "/NoGangs")
    return Soak(f"SchedulingSoak/{nodes}Nodes{suffix}", nodes, rounds, scale, tuple(mix),
                cohort, attrs)


def soak_chunks(pods: Sequence[Pod], size: int) -> List[List[Pod]]:
    """``pods`` in order, cut into batches of at most ``size`` so that no
    gang (consecutive pods of one group) straddles a cut."""
    units: List[List[Pod]] = []
    for pod in pods:
        gkey = pod_group_key(pod)
        if units and gkey is not None and pod_group_key(units[-1][0]) == gkey:
            units[-1].append(pod)
        else:
            units.append([pod])
    chunks: List[List[Pod]] = [[]]
    for unit in units:
        if chunks[-1] and len(chunks[-1]) + len(unit) > size:
            chunks.append([])
        chunks[-1].extend(unit)
    return [c for c in chunks if c]


def quota_oversubscription(quota, namespaces: Sequence[str]) -> int:
    """Dimensions over their cap in the ledger, the JAX harness's check
    (``kubernetes_tpu/perf/harness.py:838-864``): a namespace's usage less
    its loans against its own caps, and every pool's usage against the sum
    of its members' caps."""
    bad = 0
    cohorts = set()
    for ns in namespaces:
        hard = quota.effective_hard(ns)
        if not hard:
            continue
        used, loans = quota.usage(ns), quota.borrowed(ns)
        bad += sum(1 for dim, cap in hard.items() if used.get(dim, 0) - loans.get(dim, 0) > cap)
        if quota.cohort_for(ns):
            cohorts.add(quota.cohort_for(ns))
    for cohort in cohorts:
        caps, used = quota.cohort_state(cohort)
        bad += sum(1 for dim, cap in caps.items() if used.get(dim, 0) > cap)
    return bad


def run_soak(sched, w: Soak) -> dict:
    """Drive ``w`` through ``sched`` (a BatchScheduler over ``w.node_infos()``
    with ``client=w.store()`` and ``caps=w.caps()``). Each round: the
    round's arrivals join the pods still pending (in arrival order); all of
    them are submitted in gang-whole batches (``soak_chunks``); then the
    pods in ``retry``, ``quota_rejected`` or ``nominated`` are resubmitted,
    in arrival order, until a pass binds nothing; Coscheduling's clock
    advances by ``SOAK_CYCLES_PER_ROUND * SOAK_TICK_S``; and
    ``SOAK_CHURN_FRAC`` of each tenant's soak-bound pods are deleted,
    oldest first. The ledger is checked for oversubscription after every
    pass and every churn.

    Cut from the JAX soak (``kubernetes_tpu/perf/harness.py:784-990``): no
    device flap (the port has no relay); no DRR queue, tick-driven cycles
    or release moves (the scheduler loop): pods go in arrival order, so
    tenant wait percentiles are not comparable with the JAX harness's.

    Returns a dict: ``placed`` (pod key -> node, each pod as it bound),
    ``bound`` (tenant -> pods bound over the run), ``oversubscription``
    (violations summed over the checks), ``passes``, ``rounds`` (per round:
    the ledger's usage per tenant after the churn, and the round's
    nominations) and ``pending`` (pod keys unbound at the end)."""
    clock = FakeClock()
    if sched.coscheduling is not None:
        sched.coscheduling.now_fn = clock
    tenants = [ns for ns, _w in SOAK_TENANTS]
    counter = 0
    pending: List[Pod] = []
    soak_bound: Dict[str, List[str]] = {ns: [] for ns in tenants}
    placed_all: Dict[str, str] = {}
    bound = dict.fromkeys(tenants, 0)
    oversub = passes = 0
    rounds = []
    for r in range(w.rounds):
        arrivals = w.arrivals(r, counter)
        counter += len(arrivals)
        w.populate(sched.client, arrivals)
        pending += arrivals
        submit = list(pending)
        nominations: Dict[str, str] = {}
        while submit:
            placed: Dict[str, Optional[str]] = {}
            for chunk in soak_chunks(submit, sched.caps.pods):
                placed.update(sched.schedule(chunk))
            passes += 1
            oversub += quota_oversubscription(sched.quota, tenants)
            nominations.update(sched.nominated)
            newly = [p for p in submit if placed.get(p.key())]
            for p in newly:
                placed_all[p.key()] = placed[p.key()]
                if p.meta.namespace in soak_bound:
                    soak_bound[p.meta.namespace].append(p.key())
                    bound[p.meta.namespace] += 1
            pending = [p for p in pending if not placed.get(p.key())]
            if not newly:
                break
            again = set(sched.retry) | set(sched.quota_rejected) | set(sched.nominated)
            submit = [p for p in pending if p.key() in again]
        clock.advance(SOAK_CYCLES_PER_ROUND * SOAK_TICK_S)
        for ns in tenants:
            keys = soak_bound[ns]
            n = int(len(keys) * SOAK_CHURN_FRAC)
            for key in keys[:n]:
                sched.delete_pod(key)
            soak_bound[ns] = keys[n:]
        oversub += quota_oversubscription(sched.quota, tenants)
        rounds.append({"usage": {ns: sched.quota.usage(ns) for ns in tenants},
                       "nominations": nominations})
    return {"placed": placed_all, "bound": bound, "oversubscription": oversub,
            "passes": passes, "rounds": rounds, "pending": [p.key() for p in pending]}
