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
* SchedulingCSIPVs (:136-166; ``kubernetes_tpu/perf/workloads.py:138``):
  as SchedulingInTreePVs with CSI PVs (no in-tree volume type) and, per
  node, a CSINode allowing 39 volumes of ebs.csi.aws.com.
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
* DelayedBinding (a seeded case): WaitForFirstConsumer PVCs, one per pod,
  and fewer zonal PVs than pods; ``run_delayed_binding`` drives it through
  the loop.

``run_loop`` drives a workload through the scheduler loop (the store,
``TPUScheduler.run_until_settled``), gangs and slices included, with the
warm sweep before its measured phase on request; ``run_loop_soak`` the
soak (``soak_rounds``: the JAX harness's soak phase, its device flap and
invariants included); ``run_loop_borrow`` SchedulingBorrow (``Borrow``,
``borrow_rounds``: the JAX harness's borrow phase and its invariants, the
latency ledger's per-tenant e2e); ``run_loop_replay`` SchedulingReplay
(``Replay``, ``replay_rounds``: the JAX harness's replay phase with the
continuous rebalancer and its ReplayInvariants); ``run_loop_elastic``
SchedulingElastic (``Elastic``, ``elastic_rounds``: storms, drain waves
and spot reclamation through the drain orchestrator, and the
ElasticInvariants); ``run_relay_death`` the relay breaker's degrade and
heal at a workload's size (``relay_death``); ``run_with_preemption`` drives one through a BatchScheduler and
resubmits the pods it nominated; ``slice_stats`` reports contiguity and
fragmentation after a run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..api.types import (BINDING_WAIT_FOR_FIRST_CONSUMER, LABEL_HOSTNAME, LABEL_TOPOLOGY_ZONE,
                         POD_GROUP_LABEL, ROX, RWOP, CSINode, LabelSelector, LimitRange,
                         LimitRangeItem, Namespace, ObjectMeta, PersistentVolume,
                         PersistentVolumeClaim, Pod, PodGroup, PriorityClass, ResourceClaim,
                         ResourceClass, ResourceQuota, RuntimeClass, SchedulingQuota,
                         StorageClass, Taint)
from ..api import resource as resource_api
from ..api.validation import ValidationError
from ..api.wrappers import make_node, make_pod
from ..apiserver.admission import UNREACHABLE_TAINT, AdmissionError, PodNodeSelector
from ..apiserver.store import Conflict, Store
from ..scheduler.extender import CallableExtender
from ..backend.device_state import _bucket, caps_for_cluster
from ..backend import telemetry
from ..backend.errors import TransientDeviceError
from ..framework.plugins.coscheduling import pod_group_key
from ..framework.runtime import DEFAULT_SCHEDULER_NAME as DEFAULT_SCHEDULER
from ..framework.types import NodeInfo
from ..ops.schema import Capacities
from ..ops.slice import SLICE_LABEL, TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL, fragmentation_host
from ..utils.clock import FakeClock
from .phases import borrow_loop, elastic_loop, quota_oversubscription, replay_loop, soak_loop

_NODE_CAPACITY = {"cpu": "32", "memory": "128Gi", "pods": 110}
_DEFAULT_REQ = {"cpu": "900m", "memory": "2Gi"}
_SMALL_REQ = {"cpu": "100m", "memory": "500Mi"}
LOOP_BATCH = 128  # the loop's largest batch, the JAX harness's default
CSI_LIMIT = 39  # SchedulingCSIPVs' attachable volumes per node (the EBS default)


def scheduling_basic_nodes(count: int, zones: int = 10,
                           device_attributes: Optional[Dict[str, tuple]] = None,
                           capacity: Optional[Dict[str, object]] = None,
                           tpu_slots: int = 0, first: int = 0) -> List[NodeInfo]:
    """Nodes ``node-<first>`` .. ``node-<first + count - 1>``.
    ``device_attributes``: per key, the values node i publishes value
    ``i % len`` of (harness.py ``_node_wrapper``). ``zones`` 0: no zone or
    hostname label, as the harness makes nodes without a zone count.
    ``tpu_slots``: node i is torus host (i // tpu_slots, i % tpu_slots)."""
    infos = []
    for i in range(first, first + count):
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
class Tenant:
    """A namespace of the admission workload and the objects its pods meet
    in the admission chain: its node-selector annotation (PodNodeSelector),
    a LimitRange whose Container ``default_request`` the pods get in place
    of requests of their own (LimitRanger), a RuntimeClass of ``overhead``
    the pods name (RuntimeClass), and a ResourceQuota of ``quota_pods``
    pods (ResourceQuota; 0: none)."""

    name: str
    node_selector: str = ""
    default_request: Dict[str, str] = dataclasses.field(default_factory=dict)
    runtime_class: str = ""
    overhead: Dict[str, str] = dataclasses.field(default_factory=dict)
    quota_pods: int = 0

    def create(self, store) -> None:
        """The namespace and its objects, through ``store``'s writes."""
        ann = {PodNodeSelector.ANNOTATION: self.node_selector} if self.node_selector else {}
        store.create_namespace(Namespace(meta=ObjectMeta(name=self.name, namespace="",
                                                         annotations=ann)))
        if self.default_request:
            store.create_object("LimitRange", LimitRange(
                meta=ObjectMeta(name="limits", namespace=self.name),
                limits=(LimitRangeItem(default_request=dict(self.default_request)),)))
        if self.runtime_class and store.get_object("RuntimeClass", self.runtime_class) is None:
            store.create_object("RuntimeClass", RuntimeClass(
                meta=ObjectMeta(name=self.runtime_class, namespace=""), handler="runc",
                overhead=dict(self.overhead)))
        if self.quota_pods:
            store.create_object("ResourceQuota", ResourceQuota(
                meta=ObjectMeta(name="quota", namespace=self.name),
                hard={"pods": self.quota_pods}))


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
    # the PriorityClass the pods name (admission gives them its value)
    priority_class: str = ""
    # pod i names scheduler scheduler_names[i % len]; () keeps the default
    scheduler_names: Tuple[str, ...] = ()
    # gang membership: pods i // gang_size share the PodGroup
    # <prefix>-pg<i // gang_size>. A flat gang's members are anti-affine to
    # their own group on the hostname key; a slice gang's (``slice``) carry
    # the slice marker instead
    gang_size: int = 0
    slice: bool = False
    # pod i lives in tenants[i % len]'s namespace and meets its objects
    # (``Tenant``); () keeps every pod in ``default``
    tenants: Tuple["Tenant", ...] = ()

    def pods(self, count: int) -> List[Pod]:
        return [self.pod(i) for i in range(count)]

    def sample(self) -> Pod:
        """A pod of the shape that no op creates (index 10**9, as the JAX
        harness's warm sample): ``warm_buckets``' sample pod."""
        return self.pod(10 ** 9)

    def pod(self, i: int) -> Pod:
        """The shape's ``i``-th pod."""
        tenant = self.tenants[i % len(self.tenants)] if self.tenants else None
        pw = make_pod(f"{self.prefix}-{i}", namespace=tenant.name if tenant else "default")
        if tenant is None or not tenant.default_request:
            pw.req(self.req)  # a LimitRange tenant's pods set no requests
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
        if self.scheduler_names:
            pw.scheduler_name(self.scheduler_names[i % len(self.scheduler_names)])
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
        pod = pw.obj()
        pod.spec.priority_class_name = self.priority_class
        if tenant is not None:
            pod.spec.runtime_class_name = tenant.runtime_class
        return pod

    @property
    def needs_store(self) -> bool:
        return bool(self.claim or self.pv_volume_type is not None or self.gang_size)

    def populate(self, store: Store, count: int, namespace: str = "default",
                 groups: bool = True) -> None:
        """The objects of ``count`` pods of this shape: the claim class and
        each pod's claim, or each pod's bound PV and PVC, and (``groups``)
        each gang's PodGroup (minMember = the gang size)."""
        for g in range(-(-count // self.gang_size) if self.gang_size and groups else 0):
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
    # the PriorityClasses the loop's store holds: (name, value)
    priority_classes: Tuple[Tuple[str, int], ...] = ()
    # a CSINode per node allowing CSI_LIMIT volumes of this driver
    # (nodeAllocatableStrategy.csiNodeAllocatable), or none
    csi_driver: str = ""
    # the admission workload's cluster: nodes [0, not_ready_nodes) are
    # created not Ready, nodes in [unreachable_nodes) carry the unreachable
    # NoExecute taint, node i is labelled pool=node_pools[i * len // nodes],
    # and the tenants' namespaces and objects are created first
    not_ready_nodes: int = 0
    unreachable_nodes: Tuple[int, int] = (0, 0)
    node_pools: Tuple[str, ...] = ()
    tenants: Tuple[Tenant, ...] = ()

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
            infos = scheduling_basic_nodes(self.nodes, self.zones, self.device_attributes,
                                           self.node_capacity, self.tpu_slots)
            for i, ni in enumerate(infos):
                node = ni.node
                if self.node_pools:
                    node.meta.labels["pool"] = self.node_pools[i * len(self.node_pools)
                                                               // self.nodes]
                node.status.ready = i >= self.not_ready_nodes
                if self.unreachable_nodes[0] <= i < self.unreachable_nodes[1]:
                    node.spec.taints = tuple(node.spec.taints) + (
                        Taint(key=UNREACHABLE_TAINT, effect="NoExecute"),)
            return infos
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

    def csinodes(self) -> List[CSINode]:
        return [CSINode(meta=ObjectMeta(name=f"node-{i}", namespace=""),
                        drivers={self.csi_driver: CSI_LIMIT})
                for i in range(self.nodes if self.csi_driver else 0)]

    def store(self) -> Optional[Store]:
        """A fresh object store with every pod's claims, volumes and
        PodGroups and the nodes' CSINodes, or None when the workload needs
        none."""
        shapes = self._ops()
        if not any(s.needs_store for s, _ in shapes) and not self.csi_driver:
            return None
        store = Store()
        for cn in self.csinodes():
            store.create_csinode(cn)
        for shape, count in shapes:
            shape.populate(store, count)
        return store


def scheduling_basic(nodes: int = 5000, init_pods: int = 1000,
                     measured: int = 1000) -> Workload:
    return Workload(f"SchedulingBasic/{nodes}Nodes", nodes, PodShape("init"), init_pods,
                    PodShape("measured"), measured)


# SchedulingBasic's measured pods spread over four namespaces, each meeting
# one more plugin of the admission chain
ADMISSION_TENANTS = (
    Tenant("default"),
    Tenant("team-a", node_selector="pool=b"),
    Tenant("team-b", default_request={"cpu": "500m", "memory": "1Gi"}),
    Tenant("team-c", runtime_class="overhead-250m", overhead={"cpu": "250m"}, quota_pods=200),
)


def admission_basic(nodes: int = 5000, init_pods: int = 1000, measured: int = 1000) -> Workload:
    """SchedulingBasic with the admission chain doing the work: nodes
    0-9.99% created not Ready (TaintNodesByCondition taints them), the next
    5% carrying the unreachable NoExecute taint (which DefaultTolerationSeconds
    lets every pod tolerate), the two halves in pool=a and pool=b; the init
    pods in ``default``, the measured pods spread over ``ADMISSION_TENANTS``
    (team-a's go to pool=b, team-b's get 500m / 1Gi, team-c's a 250m
    overhead under a quota of 200 pods, so its later creates are
    refused). At 5000 nodes: 500 not Ready, 250 unreachable."""
    return Workload(f"SchedulingBasic/{nodes}Nodes/Admission", nodes, PodShape("init"),
                    init_pods, PodShape("measured", tenants=ADMISSION_TENANTS), measured,
                    not_ready_nodes=nodes // 10, unreachable_nodes=(nodes // 10, nodes * 3 // 20),
                    node_pools=("a", "b"), tenants=ADMISSION_TENANTS)


def admission_violations(w: Workload, run: dict) -> List[str]:
    """The rules of ``admission_basic`` that ``run_loop``'s ``run`` breaks:
    a pod on a node created not Ready, no pod on an unreachable node, a
    team-a pod without the pool=b selector or off pool=b, a team-b pod
    whose cpu request is not the LimitRange's, a team-c pod without its
    RuntimeClass's overhead."""
    out = []
    nodes = {k: int(n.rsplit("-", 1)[1]) for k, n in run["placed"].items() if n}
    if any(i < w.not_ready_nodes for i in nodes.values()):
        out.append("a pod on a node created not Ready")
    if not any(w.unreachable_nodes[0] <= i < w.unreachable_nodes[1] for i in nodes.values()):
        out.append("no pod on an unreachable node")
    for key, (selector, cpu, overhead) in run["admitted"].items():
        ns = key.split("/", 1)[0]
        if ns == "team-a" and (selector != {"pool": "b"} or nodes.get(key, 0) < w.nodes // 2):
            out.append(f"{key}: not on pool=b")
        elif ns == "team-b" and cpu != 500:
            out.append(f"{key}: cpu {cpu}m, not the LimitRange's 500m")
        elif ns == "team-c" and (overhead != {"cpu": "250m"} or cpu != 1150):
            out.append(f"{key}: overhead {overhead}, cpu {cpu}m")
    return out


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


def scheduling_csi_pvs(nodes: int = 5000, init_pods: int = 5000,
                       measured: int = 1000) -> Workload:
    """performance-config.yaml:136-166 SchedulingCSIPVs (the JAX
    ``scheduling_csi_pvs``, ``kubernetes_tpu/perf/workloads.py:138``):
    every node's CSINode allows 39 volumes of ``ebs.csi.aws.com``; each pod
    claims a pre-bound CSI PV (no in-tree volume type). As in the JAX
    harness, the PVCs name no storage class, so NodeVolumeLimits counts
    none of them against the limit."""
    shape = dict(req=_SMALL_REQ, pv_volume_type="")
    return Workload(f"SchedulingCSIPVs/{nodes}Nodes", nodes, PodShape("init", **shape),
                    init_pods, PodShape("csi", **shape), measured,
                    csi_driver="ebs.csi.aws.com")


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


# profiles of KubeSchedulerConfiguration (v1beta3) for ``run_loop``'s
# ``config``: ``batch-b`` lists the default set through multiPoint (every
# plugin but VolumeBinding, whose Score no default list holds, so listing
# it would add it there), and its expansion is the default set's;
# ``most-allocated`` keeps the default set and sets NodeResourcesFit's
# MostAllocated (ROADMAP C20); ``no-scoring`` disables every Score plugin
DEFAULT_SET_MULTI_POINT = (
    "PrioritySort", "QuotaAdmission", "Coscheduling", "NodeUnschedulable", "NodeName",
    "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "NodeResourcesBalancedAllocation", "VolumeRestrictions", "NodeVolumeLimits", "VolumeZone",
    "PodTopologySpread", "InterPodAffinity", "DynamicResources", "SlicePacking",
    "ImageLocality", "DefaultPreemption", "DefaultBinder")
PROFILES = {
    DEFAULT_SCHEDULER: {},
    "batch-b": {"plugins": {
        "multiPoint": {"enabled": [{"name": n} for n in DEFAULT_SET_MULTI_POINT]},
        "queueSort": {"disabled": [{"name": "PrioritySort"}]}}},
    "most-allocated": {"pluginConfig": [
        {"name": "NodeResourcesFit", "args": {"strategy": "MostAllocated"}}]},
    "no-scoring": {"plugins": {"score": {"disabled": [{"name": "*"}]}}},
}


def profiles_config(*names: str) -> dict:
    """A v1beta3 config of the ``PROFILES`` named, in order."""
    return {"apiVersion": "kubescheduler.config.k8s.io/v1beta3",
            "kind": "KubeSchedulerConfiguration",
            "profiles": [{"schedulerName": n, **PROFILES[n]} for n in names]}


def with_scheduler_names(w: Workload, names: Sequence[str]) -> Workload:
    """``w`` with its measured pods naming ``names`` in turn."""
    return dataclasses.replace(w, measured=dataclasses.replace(
        w.measured, scheduler_names=tuple(names)))


def preemption_basic(nodes: int = 500, init_pods: int = 2000, measured: int = 500,
                     classes: bool = False) -> Workload:
    """With ``classes``, the victims and the preemptors set no priority and
    name the PriorityClasses ``low`` (1) and ``high`` (100), which the
    loop's store creates before the pods (``run_loop``): admission gives
    them the numbers the default form sets."""
    victim, preemptor, pcs = _VICTIM, _PREEMPTOR, ()
    if classes:
        victim = dict(_VICTIM, priority=0, priority_class="low")
        preemptor = dict(_PREEMPTOR, priority=0, priority_class="high")
        pcs = (("low", _VICTIM["priority"]), ("high", _PREEMPTOR["priority"]))
    return Workload(f"PreemptionBasic/{nodes}Nodes", nodes, PodShape("victim", **victim),
                    init_pods, PodShape("preemptor", **preemptor), measured, zones=0,
                    node_capacity=_PREEMPTION_NODE, warm=PodShape("warm", **preemptor),
                    warm_pods=_WARM_PREEMPTORS, priority_classes=pcs)


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


# the loop's extender runs (``LoopExtender``): Filter drops node-i with
# i % EXTENDER_FILTER_MOD == 0, Prioritize gives EXTENDER_POOL_SCORE to the
# upper half of the nodes (pool=b in ``extender_basic``) at EXTENDER_WEIGHT
EXTENDER_FILTER_MOD = 7
EXTENDER_POOL_SCORE = 10
EXTENDER_WEIGHT = 5
EXTENDER_VERBS = ("filter", "prioritize", "bind", "preempt")


def extender_basic(nodes: int = 1000, init_pods: int = 500, measured: int = 256,
                   scheduler_names: Sequence[str] = ()) -> Workload:
    """SchedulingBasic with its halves in pool=a and pool=b and the
    measured pods naming ``scheduler_names`` in turn: the cluster of the
    loop's extender runs."""
    w = with_scheduler_names(scheduling_basic(nodes, init_pods, measured), scheduler_names)
    return dataclasses.replace(w, name=f"{w.name}/Extender", node_pools=("a", "b"))


def filtered_by_extender(node_name: str) -> bool:
    """Whether ``LoopExtender``'s Filter drops the node."""
    return int(node_name.rsplit("-", 1)[1]) % EXTENDER_FILTER_MOD == 0


class LoopExtender(CallableExtender):
    """The in-process extender of the loop's extender runs, over node names
    only, so that either package's scheduler can call it: Filter drops the
    nodes ``filtered_by_extender`` names, Prioritize gives the upper half of
    ``nodes`` EXTENDER_POOL_SCORE at EXTENDER_WEIGHT, Bind calls
    ``bind(pod key, node name)`` (the store's bind; None: not a binder), and
    with ``preempt`` ProcessPreemption keeps every other candidate node. ``calls`` counts
    each verb; ``wire`` answers the same verbs in the HTTP extender's JSON
    (``serve_extender``)."""

    def __init__(self, nodes: int, bind: Optional[Callable[[str, str], None]],
                 preempt: bool = False):
        bind_fn = None
        if bind is not None:
            def bind_fn(pod, node_name):
                self.bind_pod(pod.key(), node_name)
        super().__init__("loop-extender", filter_fn=self._filter_nodes,
                         prioritize_fn=self._prioritize_nodes, bind_fn=bind_fn,
                         weight=EXTENDER_WEIGHT)
        self.nodes = nodes
        self._bind_to = bind
        self.preempt = preempt
        self.calls = dict.fromkeys(EXTENDER_VERBS, 0)

    def keep(self, names: Sequence[str]) -> Tuple[List[str], Dict[str, str]]:
        self.calls["filter"] += 1
        return ([n for n in names if not filtered_by_extender(n)],
                {n: "node(s) filtered by the extender" for n in names
                 if filtered_by_extender(n)})

    def scores(self, names: Sequence[str]) -> Dict[str, int]:
        self.calls["prioritize"] += 1
        half = self.nodes // 2
        return {n: EXTENDER_POOL_SCORE if int(n.rsplit("-", 1)[1]) >= half else 0
                for n in names}

    def bind_pod(self, key: str, node_name: str) -> None:
        self.calls["bind"] += 1
        self._bind_to(key, node_name)

    def trim(self, node_names: Sequence[str]) -> List[str]:
        self.calls["preempt"] += 1
        return list(node_names)[::2]

    def _filter_nodes(self, pod, nodes):
        kept, failed = self.keep([n.meta.name for n in nodes])
        kept = set(kept)
        return [n for n in nodes if n.meta.name in kept], failed

    def _prioritize_nodes(self, pod, nodes):
        return self.scores([n.meta.name for n in nodes])

    def supports_preemption(self) -> bool:
        return self.preempt

    def process_preemption(self, pod, victims_by_node, node_infos):
        kept = set(self.trim(list(victims_by_node)))
        return {n: v for n, v in victims_by_node.items() if n in kept}

    def wire(self, verb: str, args: dict):
        """One verb's answer in the extender's JSON
        (kube-scheduler/extender/v1/types.go)."""
        if verb == "filter":
            kept, failed = self.keep([item["metadata"]["name"]
                                      for item in args["Nodes"]["Items"]])
            return {"Nodes": {"Items": [{"metadata": {"name": n}} for n in kept]},
                    "FailedNodes": failed, "Error": ""}
        if verb == "prioritize":
            return [{"Host": n, "Score": s} for n, s in self.scores(args["NodeNames"]).items()]
        if verb == "bind":
            try:
                self.bind_pod(f"{args['PodNamespace']}/{args['PodName']}", args["Node"])
            except Exception as err:  # noqa: BLE001 - reported on the wire
                return {"Error": str(err)}
            return {"Error": ""}
        if verb == "preempt":
            victims = args["NodeNameToMetaVictims"]
            return {"NodeNameToMetaVictims": {n: victims[n] for n in self.trim(list(victims))}}
        return {"Error": f"unknown verb {verb!r}"}


def serve_extender(ext: LoopExtender):
    """``ext`` behind a ``ThreadingHTTPServer`` on 127.0.0.1 at a free port,
    each verb at ``/<verb>``. Returns (server, url prefix); stop it with
    ``server.shutdown()`` and ``server.server_close()``."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 - the http.server hook
            args = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            body = json.dumps(ext.wire(self.path.rsplit("/", 1)[-1], args)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def extender_config(url_prefix: str) -> dict:
    """A KubeSchedulerConfiguration ``extenders`` entry naming all four
    verbs at ``url_prefix`` (the JSON form of ``LoopExtender``)."""
    return {"urlPrefix": url_prefix, "filterVerb": "filter", "prioritizeVerb": "prioritize",
            "bindVerb": "bind", "preemptVerb": "preempt", "weight": EXTENDER_WEIGHT}


def create_gang_pod(store, pod: Pod, size: int, convert=lambda obj: obj) -> None:
    """Create ``pod`` in ``store``, and first its PodGroup (minMember
    ``size``) when it is a gang member whose group is missing, as the JAX
    harness's ``_make_pod`` does (``harness.py:469-485``). ``convert``
    turns the port's objects into the store's package's."""
    gkey = pod_group_key(pod)
    if gkey is not None and store.get_object("PodGroup", gkey) is None:
        store.create_object("PodGroup", convert(PodGroup(
            meta=ObjectMeta(name=gkey.split("/", 1)[1], namespace=pod.meta.namespace),
            min_member=size)))
    store.create_pod(convert(pod))


class LoopObserver:
    """The three recorders on for a loop's measured phase: telemetry (fed
    by the loop's metrics), the latency ledger (on the loop's clock, its
    quota tenants, every closed entry kept) and tracing (in memory). They
    replace whatever recorder was on; ``finish`` turns all three off and
    sums up what they saw."""

    def __init__(self, sched):
        from ..backend import telemetry
        from ..metrics import latency_ledger
        from ..ops import fused_step
        from ..utils import tracing

        self.telemetry = telemetry.enable(sched.smetrics)
        self.ledger = latency_ledger.enable(sched.smetrics, now_fn=sched.now_fn,
                                            tenant_fn=sched._ns_fair_weight,
                                            keep_closed=1 << 20)
        self.spans = tracing.InMemoryExporter()
        tracing.enable(self.spans)
        self._launches = fused_step.LAUNCHES

    def finish(self, window_t0: float, window_s: float) -> dict:
        """Turn the recorders off. Returns ``programs`` (the dispatch
        ledger's table per program and bucket), ``records`` (its records),
        ``device_exec_s`` (each batch program's time on the card, CUDA
        events; empty on the CPU), ``busy_share`` (the sum of those
        committed inside the window that starts at ``window_t0``, wall
        clock, over its ``window_s``; None on the CPU), ``launches``
        (fused-kernel launches while observed), ``transfer``, ``hbm``,
        ``compile``,
        ``compilations`` and ``retraces``, ``events`` (flight events per
        type), ``entries`` (the ledger's closed entries: pod, result, e2e,
        segments), ``live`` (entries still open), ``e2e_rel_err`` (the
        largest relative gap between an entry's e2e and the sum of its
        segments), ``cycles`` (``scheduling.cycle`` spans of batches),
        ``waits`` (``device.commit.wait`` spans), ``phase_gap_ns`` (the
        largest gap inside a wait's ``device.dispatch.*`` children, which
        lie end to end) and ``wait_uncovered_us`` (the largest part of a
        wait span its children do not cover: the span's own bookkeeping
        after the read)."""
        from ..backend import telemetry
        from ..metrics import latency_ledger
        from ..ops import fused_step
        from ..utils import tracing

        tracing.disable()
        latency_ledger.disable()
        telemetry.disable()
        disp = self.telemetry.dispatch_ledger.dump()
        dump = self.telemetry.dump(0)
        records = disp["records"]
        exec_s = [r["deviceExecS"] for r in records if "deviceExecS" in r]
        window = [r["deviceExecS"] for r in records
                  if "deviceExecS" in r and r["t"] >= window_t0]
        entries, worst = [], 0.0
        for e in self.ledger.timeline_entries():
            if e["closed"] is None:
                continue
            e2e = e["closed"] - e["opened"]
            total = sum(e["segments"].values())
            worst = max(worst, abs(e2e - total) / max(abs(e2e), 1e-12))
            entries.append({"pod": e["pod"], "result": e["result"], "e2e": e2e,
                            "segments": dict(e["segments"])})
        spans = self.spans.spans
        kids: Dict[str, list] = {}
        for sp in spans:
            kids.setdefault(sp.parent_id, []).append(sp)
        waits = [sp for sp in spans if sp.name == "device.commit.wait"]
        gap = uncovered = 0
        for sp in waits:
            phases = [k for k in kids.get(sp.span_id, ()) if k.name.startswith("device.dispatch.")]
            if phases:
                covered = max(k.end for k in phases) - min(k.start for k in phases)
                gap = max(gap, abs(sum(k.end - k.start for k in phases) - covered))
                uncovered = max(uncovered, (sp.end - sp.start) - covered)
        events: Dict[str, int] = {}
        for ev in self.telemetry.flight.dump():
            events[ev["type"]] = events.get(ev["type"], 0) + 1
        return {
            "programs": disp["programs"], "records": records, "device_exec_s": exec_s,
            "busy_share": sum(window) / window_s if window and window_s > 0 else None,
            "launches": fused_step.LAUNCHES - self._launches,
            "transfer": dump["transfer"], "hbm": dump["hbm"], "compile": dump["compile"],
            "compilations": self.telemetry.ledger.total_compilations(),
            "retraces": self.telemetry.ledger.total_retraces(), "events": events,
            "entries": entries, "live": len(self.ledger), "e2e_rel_err": worst,
            "cycles": sum(1 for sp in spans
                          if sp.name == "scheduling.cycle" and "batch" in sp.attributes),
            "waits": len(waits), "phase_gap_ns": gap, "wait_uncovered_us": uncovered / 1e3,
        }


def run_loop(w: Workload, device, percentage: int = 0, batch_size: int = LOOP_BATCH,
             batch_deadline_ms: Optional[float] = 0, warm: bool = False,
             config: Optional[dict] = None, out_of_tree_registry: Optional[dict] = None,
             extenders: Optional[Callable[[Store], list]] = None,
             admission: bool = True, observe: bool = False) -> dict:
    """Drive ``w`` through the scheduler loop, as the JAX harness's Runner
    does (``kubernetes_tpu/perf/harness.py:309-700``): a fresh ``Store``
    and the ``TPUScheduler`` that ``config.scheduler_from_config`` builds on
    ``device`` from ``config`` (a KubeSchedulerConfiguration dict; None,
    the default profile alone) and ``out_of_tree_registry``; the
    workload's PriorityClasses created, the nodes created, then the
    init pods (and warm pods) created and settled; then the measured pods
    created and settled, the measured phase timed on the host's clock from
    the first create to the settle. A gang's PodGroup is created just
    before its first member (``create_gang_pod``). ``percentage`` is
    percentageOfNodesToScore (0: the adaptive default), unless the config
    sets it;
    ``batch_deadline_ms`` None takes the loop's default
    (``KTPU_BATCH_DEADLINE_MS``). With ``warm``, ``warm_buckets`` runs
    with one sample pod of the measured shape (``PodShape.sample``) after
    the init pods settle and before the measured phase, as the JAX
    harness does before each measured phase (``kubernetes_tpu/perf/
    harness.py:613-629``). ``extenders(store)`` gives in-process extenders
    added to the config's (``ExtenderConfig.instance``). The store runs its
    admission chain and validation unless ``admission`` is False (the JAX
    store's own switches, ``admission = None`` and
    ``validation_enabled = False``); the workload's tenants (``Tenant``)
    are created first, and a create the chain or the validation refuses is
    counted and skipped.

    Returns a dict: ``placed`` (pod key -> node, "" when unbound),
    ``pods_per_s`` (measured pods over the measured phase's seconds),
    ``measured_s``, ``attempt_ms`` (p50 / p90 / p99 of the measured phase's
    scheduled attempts, pop to commit, of the config's first profile) and
    ``attempt_ms_by_profile``, ``scheduled_by_profile`` (the measured
    phase's scheduled attempts per profile), ``batches``, ``paths``, ``modes``
    ``batch_pods`` and ``buckets`` (per batch: its pods, and the pod axis
    its program ran at),
    ``launches`` (fused-kernel launches over the run, the warm sweep's
    left out), ``warmed``, ``warm_s``, ``warm_launches``, ``warm_timings``
    and ``warm_sizer`` (the programs the sweep warmed, its seconds, its
    fused launches, its timed runs and ``_sizer_model`` after it; 0, [] and
    None without ``warm``), ``mirror_unchanged`` (with ``warm``: every
    tensor of the mirror equal before and after the sweep, the mirror the
    same object; None without), ``first_batch_ms`` (bucket -> the host ms
    of the measured phase's first cycle at that bucket, when every
    measured cycle ran one batch),
    ``relay_opens`` and ``relay_degraded_pods`` (``_relay_outcome``), ``stage_ms`` (the
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
    order), ``start`` (the sampling window's final start, or None),
    ``settle_abandoned``; for gangs ``gang_rejected`` (reason -> whole-gang
    rejections), ``pod_groups`` (key -> (phase, scheduled)), ``waiting``
    (the pods parked at Permit at the end), ``gated``, ``gang_ms`` and
    ``gang_reads`` (the flat gangs' verdict calls), ``slice_stats``
    (``slice_stats`` over the cluster at the end, for a torus workload);
    for claims and volumes (each op's objects are created before its
    pods: the claims, the PVs and PVCs, and a CSINode after each node)
    ``fallback_scheduled`` and ``measured_fallback_scheduled`` (pods the
    sequential path bound), ``screen_ms`` and ``measured_screen_ms`` (the
    volume screen, the claim mask and the commit checks) and
    ``_volume_outcome``'s keys; ``refused`` (plugin, or "validation" ->
    the creates refused) and ``refused_pods``, ``measured_create_ms`` (the
    host ms of the measured pods' creates, admission included),
    ``admitted`` (for a workload with tenants: pod key -> its node
    selector, cpu request in milli and overhead after admission),
    ``quota_used`` (ResourceQuota key -> used), ``extender_post_ms`` (an
    HTTP extender's ms per POST, by verb); with ``observe``, ``observed``
    (``LoopObserver.finish``: the recorders on from the first node's
    create to the measured settle, the busy share over the measured phase;
    None without). The loop's commit worker is stopped before it
    returns."""
    import gc
    import time

    from ..backend.device_state import caps_for_cluster
    from ..backend.tpu_scheduler import TPUScheduler
    from ..config import Extender, load_config, scheduler_from_config
    from ..ops import fused_step

    store = Store()
    if not admission:
        store.admission, store.validation_enabled = None, False
    raw = dict(config or {})
    raw.setdefault("percentageOfNodesToScore", percentage)
    cfg = load_config(raw)
    cfg.extenders += [Extender(instance=e) for e in (extenders(store) if extenders else ())]
    sched = scheduler_from_config(store, cfg, out_of_tree_registry=out_of_tree_registry,
                                  scheduler_cls=TPUScheduler, device=device,
                                  batch_size=batch_size, batch_deadline_ms=batch_deadline_ms)
    post_ms = _time_posts(sched.extenders)
    for tenant in w.tenants:
        tenant.create(store)
    refused: Dict[str, int] = {}
    refused_pods: List[str] = []

    def create(pod: Pod) -> None:
        try:
            create_gang_pod(store, pod, sizes.get(pod.key(), 0))
        except (AdmissionError, ValidationError) as err:
            plugin = getattr(err, "plugin", "validation")
            refused[plugin] = refused.get(plugin, 0) + 1
            refused_pods.append(pod.key())

    for name, value in w.priority_classes:
        store.create_priority_class(PriorityClass(meta=ObjectMeta(name=name, namespace=""),
                                                  value=value))
    launches = fused_step.LAUNCHES
    observer = LoopObserver(sched) if observe else None
    csinodes = {cn.meta.name: cn for cn in w.csinodes()}
    for ni in w.node_infos():
        store.create_node(ni.node)
        if ni.node.meta.name in csinodes:
            store.create_csinode(csinodes[ni.node.meta.name])
    sizes = {p.key(): shape.gang_size for shape, count in w._ops() if shape.gang_size
             for p in shape.pods(count)}
    init_ops = ((w.init, w.init_pods),) + w.init_extra
    warm_ops = ((w.warm, w.warm_pods),) if w.warm else ()
    measured_ops = ((w.measured, w.measured_pods),) + w.measured_extra
    cycles = []
    for ops, pods in ((init_ops, w.init_pod_list()), (warm_ops, w.warm_pod_list())):
        for shape, count in ops:
            shape.populate(store, count, groups=False)
        for pod in pods:
            create(pod)
        cycles.append(sched.run_until_settled())
    warmed, warm_s, warm_sizer, mirror_unchanged = 0, 0.0, None, None
    if warm:
        sched.cache.update_snapshot(sched.snapshot)
        sched._sync_grown()  # the sync the sweep starts with
        state = sched.state
        before = _mirror_tensors(state)
        t_warm = time.perf_counter()
        warmed = sched.warm_buckets([w.measured.sample()])
        warm_s = time.perf_counter() - t_warm
        warm_sizer = _sizer_model(sched.sizer)
        after = _mirror_tensors(state)
        mirror_unchanged = (sched.state is state and before.keys() == after.keys()
                            and all(bool((after[k] == v).all()) for k, v in before.items()))
    # collect the garbage of earlier runs in this process before the clock
    # starts, so that its collection pauses do not land in the measured phase
    gc.collect()
    hist = sched.smetrics.scheduling_attempt_duration
    n_before = {name: hist.count("scheduled", name) for name in sched.profiles}
    stages0, n_cycles = dict(sched.stage_seconds), len(sched.cycle_seconds)
    buckets0 = len(sched.batch_buckets)
    commit0, batches0, carry0 = dict(sched.commit_seconds), sched.batch_counter, \
        sched.carry_batches
    idle0 = sched.idle_seconds
    spans0 = (len(sched.dispatch_spans), len(sched.commit_spans))
    screens0, fallback0 = dict(sched.screen_seconds), sched.fallback_scheduled
    for shape, count in measured_ops:
        shape.populate(store, count, groups=False)
    measured_pods = w.measured_pod_list()
    wall0 = time.time()
    t0 = time.perf_counter()
    for pod in measured_pods:
        create(pod)
    create_s = time.perf_counter() - t0
    cycles.append(sched.run_until_settled())
    measured_s = time.perf_counter() - t0
    sched.close()
    observed = observer.finish(wall0, measured_s) if observer is not None else None
    dispatch_spans = sched.dispatch_spans[spans0[0]:]
    commit_spans = [s for s in sched.commit_spans[spans0[1]:] if s[0] >= t0]
    attempt_ms_by_profile = {
        name: {f"p{q}": hist.quantile(q / 100, "scheduled", name, since=n_before[name]) * 1e3
               for q in (50, 90, 99)}
        for name in sched.profiles if hist.count("scheduled", name) > n_before[name]}
    attempt_ms = attempt_ms_by_profile.get(
        next(iter(sched.profiles)), {f"p{q}": 0.0 for q in (50, 90, 99)})
    first_batch_ms: Dict[int, float] = {}
    measured_buckets = sched.batch_buckets[buckets0:]
    measured_cycles = sched.cycle_seconds[n_cycles:]
    if len(measured_cycles) == len(measured_buckets):  # one batch per cycle
        for bucket, t in zip(measured_buckets, measured_cycles):
            first_batch_ms.setdefault(bucket, t * 1e3)
    return {
        "placed": {k: p.spec.node_name for k, p in store.pods.items()},
        "pods_per_s": w.n_measured / measured_s, "measured_s": measured_s,
        "attempt_ms": attempt_ms, "attempt_ms_by_profile": attempt_ms_by_profile,
        "scheduled_by_profile": {name: hist.count("scheduled", name) - n_before[name]
                                 for name in sched.profiles},
        "batches": sched.batch_counter,
        "paths": list(sched.batch_paths), "modes": list(sched.batch_modes),
        "buckets": list(sched.batch_buckets), "batch_pods": list(sched.batch_pods),
        "launches": fused_step.LAUNCHES - launches - sched.warm_launches,
        "warmed": warmed, "warm_s": warm_s, "warm_launches": sched.warm_launches,
        "warm_timings": list(sched.warm_timings), "warm_sizer": warm_sizer,
        "mirror_unchanged": mirror_unchanged, "first_batch_ms": first_batch_ms, **_relay_outcome(sched),
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
        "fallback_scheduled": sched.fallback_scheduled,
        "measured_fallback_scheduled": sched.fallback_scheduled - fallback0,
        "screen_ms": {k: v * 1e3 for k, v in sched.screen_seconds.items()},
        "measured_screen_ms": {k: (v - screens0[k]) * 1e3
                               for k, v in sched.screen_seconds.items()},
        **_volume_outcome(store),
        **_gang_outcome(sched, store, bool(w.tpu_slots)),
        "refused": refused, "refused_pods": refused_pods,
        "measured_create_ms": create_s * 1e3,
        "admitted": {p.key(): (dict(p.spec.node_selector), p.resource_request().get("cpu", 0),
                               dict(p.spec.overhead))
                     for p in store.pods.values() if w.tenants},
        "quota_used": {k: dict(q.used) for k, q in store.resource_quotas.items()},
        "extender_post_ms": post_ms, "observed": observed,
    }


WIRE_STAGES = ("client_encode", "client_push", "transport", "service_decode", "service_sync",
               "service_encode", "service_dispatch", "service_read", "service_commit")
REPLICA_BACKOFF_S = (0.05, 0.2)  # the replicas' pod backoff: a conflicted pod retries soon


def _settle_replicas(scheds, max_rounds: int = 100000,
                     queue_clock: Optional[FakeClock] = None) -> int:
    """Settle several replicas on one thread, one cycle each in turn (their
    pipelined batches overlap on the service); returns the pods popped.
    ``queue_clock`` is the queues' FakeClock: a round in which no replica
    has an active pod advances it past the longest pod backoff, so that
    every backed-off pod returns at once. On the wall clock the pods of one
    failed batch, requeued one after another, return split at whatever
    instant a flush falls, and the batches then depend on the host's load."""
    import time

    popped = 0
    for _ in range(max_rounds):
        n = sum(s.schedule_batch_cycle() for s in scheds)
        popped += n
        if n:
            continue
        for s in scheds:
            s.queue.flush_backoff_completed()
        pending = [s.queue.pending_pods() for s in scheds]
        if all(p["active"] == 0 and p["backoff"] == 0 for p in pending):
            break
        if all(p["active"] == 0 for p in pending):
            if queue_clock is not None:
                queue_clock.advance(REPLICA_BACKOFF_S[1])
            else:
                time.sleep(0.01)
    return popped


def _wire_split(sched, service_log: List[dict]) -> List[dict]:
    """One record per batch the client processed (``WireScheduler.
    wire_log``) joined by batchId with the service's (``DeviceService.
    batch_log``): ms of the client's payload encode and delta push, the
    transport (the client's push and call less the service's handler time
    of both), and the service's decode, sync (the push's and the batch's),
    encode, dispatch, read and commit; with the echoed deviceTime."""
    by_id = {r["batchId"]: r for r in service_log}
    out = []
    for c in sched.wire_log:
        s = by_id.get(c["batchId"])
        if s is None:
            continue  # a replayed reply: the service ran it once, in another record
        handler = s["total"]  # the handler's seconds (HTTP also echoes them as serviceTime)
        out.append({
            "batchId": c["batchId"], "pods": c["pods"], "path": s["path"],
            "client_encode": c["encode"] * 1e3, "client_push": c["push"] * 1e3,
            "transport": max(0.0, c["push"] + c["call"] - s["push"] - handler) * 1e3,
            "service_decode": s["decode"] * 1e3,
            "service_sync": (s["sync"] + s["push_sync"]) * 1e3,
            "service_encode": s["encode"] * 1e3, "service_dispatch": s["dispatch"] * 1e3,
            "service_read": s["read"] * 1e3, "service_commit": s["commit"] * 1e3,
            "deviceTime": c.get("deviceTime"),
        })
    return out


def _serve_wire(service, transport: str):
    """(server, endpoint, stop) of ``service`` on 127.0.0.1 over
    ``transport``."""
    if transport == "grpc":
        from ..backend.grpc_service import serve_grpc

        server, port = serve_grpc(service)
        return server, f"127.0.0.1:{port}", lambda: server.stop(0).wait(10)
    from ..backend.service import serve, stop

    server, port = serve(service)
    return server, f"http://127.0.0.1:{port}", lambda: stop(server)


def run_loop_wire(w: Workload, device, depth: int, batch_size: int = LOOP_BATCH,
                  percentage: int = 0, replicas: int = 1,
                  restart_after: Optional[int] = None, transport: str = "http",
                  fabric_replicas: int = 1, kill_primary_after: Optional[int] = None,
                  standby_replication: bool = False) -> dict:
    """Drive ``w`` through ``WireScheduler`` against ``serve(DeviceService(
    device=device))`` on 127.0.0.1 (``backend/service.py``): the wire
    counterpart of ``run_loop``, as the JAX harness's wire runner
    (``kubernetes_tpu/perf/harness.py``'s ``wire`` mode). One Store; the
    service's pod axis is ``batch_size``, the clients pop ``batch_size``
    at ``depth`` batches in flight (``wire_pipeline_depth``), the deadline
    sizer off; ``percentage`` is the service's percentageOfNodesToScore.
    ``transport`` is ``"http"`` or ``"grpc"`` (``serve_grpc``).
    ``replicas`` > 1 runs that many WireSchedulers on the one store and
    service, one cycle each in turn (``_settle_replicas``; pod backoff
    ``REPLICA_BACKOFF_S``): their batches race for the same pods, and the
    service's ownership check answers the losers with conflicts.
    ``restart_after`` restarts the service (``ServiceBinding.restart``: new
    epoch, empty mirror; HTTP only) once, after the first cycle in which the
    first replica's processed batches reach it. ``fabric_replicas`` > 1
    serves that many DeviceServices on ``device``, each endpoint with its
    own ``FaultPlan``, and one WireScheduler drives them all through the
    device fabric (``standby_replication`` is its warm-standby worker; pod
    backoff ``REPLICA_BACKOFF_S`` on a FakeClock of the queue's own, settled
    by ``_settle_replicas``, which passes it when the queue idles, so that
    the batches do not depend on the host's speed);
    ``kill_primary_after`` kills the first endpoint (``FaultPlan.kill``:
    every call to it fails) once, after the first cycle in which the
    client's processed batches reach it. Telemetry is on for the run (the
    echoed ``deviceTime``) unless a recorder already was.

    Returns ``run_loop``'s keys that apply (``placed``, ``pods_per_s``,
    ``measured_s``, ``attempt_ms``, ``batches`` (batch programs the
    services ran), ``paths``, ``batch_pods`` (pods per batch the client
    sent), ``launches`` (fused-kernel launches over the run), ``cycles``,
    ``metrics``, ``pending``, ``nominations``, ``settle_abandoned``), ``queued``
    (each pod left in the first replica's queue with its unschedulable
    plugins) and:
    ``wire`` (``_wire_split`` per measured batch of the first replica),
    ``wire_split_ms`` (the medians of its stages), ``device_time_ms`` (the
    medians of the echoed dwell, exec, fetch and the CUDA events' exec),
    ``client_batches`` (logical batches the clients sent, summed),
    ``replays`` (the services' idempotent replays), ``resyncs``,
    ``conflicts`` (conflict verdicts the clients counted, summed),
    ``service_conflicts`` (the services' ownership check), ``rejoins``,
    ``restarts``, ``degraded_pods``, ``placements`` (results with a node
    and no conflict verdict that the clients received, summed), ``binds``
    (binds the store took), ``double_binds`` (pods whose bind the store
    refused because they were bound already: must be empty),
    ``over_capacity`` (nodes whose bound
    requests pass their allocatable), ``depth``, ``replicas``,
    ``transport``, ``request_bytes`` (the scheduleBatch requests' encoded
    bytes, summed: JSON over HTTP, the template-deduplicated protobuf over
    gRPC), and with a fabric: ``failovers`` (by reason), ``active`` (the
    active replica's index), ``per_replica`` (each service's ``batches``
    and fused ``launches``, counted around its calls: exact at depth 0),
    ``failover_ms`` (wall ms from the kill to the end of the first batch the
    promoted replica ran: mostly the client's configured retry sleeps; the
    pods' backoff passes on the queue's clock), ``promote_ms`` (wall ms of the fabric's own
    promotion, the first ``_replica_lost``: from the lost replica's error
    reaching the fabric to the flip of the active replica, the standby's
    Health probe included), ``promote_bytes`` (the row bytes the promoted
    service's DeviceState uploaded from the kill to its first batch: the
    resync), ``replication_bytes`` (the warm-standby pushes' JSON bytes by
    kind, ``full`` and ``delta``). Every socket is closed before it
    returns."""
    import gc
    import json
    import time

    from ..backend.service import DeviceService, WireScheduler
    from ..ops import fused_step
    from ..testing.faults import FaultPlan

    if restart_after is not None and transport != "http":
        raise ValueError("restart_after restarts an HTTP binding")
    n_services = max(1, fabric_replicas)
    services = [DeviceService(batch_size=batch_size, percentage_of_nodes_to_score=percentage,
                              device=device) for _ in range(n_services)]
    stops, endpoints, servers = [], [], []
    own_telemetry = telemetry.get() is None
    scheds = []
    try:
        for svc in services:
            server, endpoint, stop_fn = _serve_wire(svc, transport)
            servers.append(server)
            endpoints.append(endpoint)
            stops.append(stop_fn)
        store = Store()
        backoff = {}
        if replicas > 1 or n_services > 1:
            backoff = dict(pod_initial_backoff=REPLICA_BACKOFF_S[0],
                           pod_max_backoff=REPLICA_BACKOFF_S[1])
        plans = [FaultPlan() for _ in services] if n_services > 1 else None
        scheds = [WireScheduler(store, endpoint=endpoints if n_services > 1 else endpoints[0],
                                transport=transport, batch_size=batch_size,
                                wire_pipeline_depth=depth, batch_deadline_ms=0,
                                client_id=f"wire-{r}", fault_plan=plans,
                                standby_replication=standby_replication, **backoff)
                  for r in range(replicas)]
        sched = scheds[0]
        queue_clock = None
        if n_services > 1:
            queue_clock = FakeClock()
            for s in scheds:
                s.queue.now_fn = queue_clock
        if own_telemetry:
            telemetry.enable(sched.smetrics)
        # the placements the service accepted (a result with a node and no
        # conflict verdict), the binds the store took, and those it refused
        # because the pod was bound already: with the ownership check, a
        # pod another replica holds gets a conflict, so that placements ==
        # binds and no bind reaches a bound pod
        tally = {"placements": 0, "binds": 0, "request_bytes": 0}
        double_binds: List[str] = []
        bind_batch, bind_one = store.bind_batch, store.bind

        def counted(pairs):
            out = bind_batch(pairs)
            for (key, _node), err in zip(pairs, out):
                if err is None:
                    tally["binds"] += 1
                elif isinstance(err, Conflict):
                    double_binds.append(key)
            return out

        def counted_one(key, node_name):
            try:
                bind_one(key, node_name)
            except Conflict:
                double_binds.append(key)
                raise
            tally["binds"] += 1

        store.bind_batch, store.bind = counted, counted_one
        for s in scheds:
            process = s._process_wire_results

            def counted_results(batch, res, pod_cycle, t0, _process=process):
                tally["placements"] += sum(1 for r in res["results"]
                                           if r.get("nodeName") and not r.get("conflict"))
                return _process(batch, res, pod_cycle, t0)

            s._process_wire_results = counted_results
        if transport == "grpc":
            from ..backend.grpc_service import _batch_to_proto

            def request_bytes(payload):
                return _batch_to_proto(payload).ByteSize()
        else:
            def request_bytes(payload):
                return len(json.dumps(payload).encode())
        for s in scheds:
            for client in ([rep.client for rep in s.client.replicas] if n_services > 1
                           else [s.client]):
                def sized(payload, _send=client.schedule_batch):
                    tally["request_bytes"] += request_bytes(payload)
                    return _send(payload)

                client.schedule_batch = sized
            if n_services == 1 and s._wire_pipeline is not None:
                s._wire_pipeline._send = s.client.schedule_batch
        kill = {"t": None, "bytes": {}, "first": None, "promote_bytes": None}
        per_replica = [{"batches": 0, "launches": 0} for _ in services]

        def upload_mark(svc):
            state = svc.state
            return (id(state), state.upload_bytes) if state is not None else (None, 0)

        for i, svc in enumerate(services):
            real = svc.schedule_batch

            def counted_batch(req, _real=real, _i=i, _svc=svc):
                if kill["t"] is not None and kill["first"] is None and _i != 0:
                    ident, nbytes = upload_mark(_svc)
                    at_kill = kill["bytes"][_i]
                    kill["promote_bytes"] = nbytes - (at_kill[1] if at_kill[0] == ident else 0)
                before_batches, before = _svc.batch_counter, fused_step.LAUNCHES
                out = _real(req)
                per_replica[_i]["launches"] += fused_step.LAUNCHES - before
                per_replica[_i]["batches"] += _svc.batch_counter - before_batches
                if kill["t"] is not None and kill["first"] is None and _i != 0:
                    kill["first"] = time.perf_counter()
                return out

            svc.schedule_batch = counted_batch
        promote = {"ms": None}
        if n_services > 1:
            lost = sched.client._replica_lost

            def timed_lost(*args, _lost=lost):
                t = time.perf_counter()
                out = _lost(*args)
                if promote["ms"] is None:
                    promote["ms"] = (time.perf_counter() - t) * 1e3
                return out

            sched.client._replica_lost = timed_lost
        if restart_after is not None or kill_primary_after is not None:
            cycle = sched.schedule_batch_cycle

            def cycle_then_fault():
                n = cycle()
                done = len(sched.wire_log)
                if restart_after is not None and len(services) == 1 \
                        and done >= restart_after:
                    services.append(servers[0].binding.restart())
                if kill_primary_after is not None and kill["t"] is None \
                        and done >= kill_primary_after:
                    kill["bytes"] = {i: upload_mark(svc) for i, svc in enumerate(services)}
                    kill["t"] = time.perf_counter()
                    plans[0].kill()
                return n

            sched.schedule_batch_cycle = cycle_then_fault

        def settle() -> int:
            if len(scheds) == 1 and n_services == 1:
                return sched.run_until_settled()
            return _settle_replicas(scheds, queue_clock=queue_clock)

        for name, value in w.priority_classes:
            store.create_priority_class(PriorityClass(meta=ObjectMeta(name=name, namespace=""),
                                                      value=value))
        launches = fused_step.LAUNCHES
        for ni in w.node_infos():
            store.create_node(ni.node)
        sizes = {p.key(): shape.gang_size for shape, count in w._ops() if shape.gang_size
                 for p in shape.pods(count)}
        cycles = []
        init_ops = ((w.init, w.init_pods),) + w.init_extra
        warm_ops = ((w.warm, w.warm_pods),) if w.warm else ()
        for ops, pods in ((init_ops, w.init_pod_list()), (warm_ops, w.warm_pod_list())):
            for shape, count in ops:
                shape.populate(store, count, groups=False)
            for pod in pods:
                create_gang_pod(store, pod, sizes.get(pod.key(), 0))
            cycles.append(settle())
        gc.collect()
        hist = sched.smetrics.scheduling_attempt_duration
        n_before = hist.count("scheduled", DEFAULT_SCHEDULER)
        log0 = len(sched.wire_log)
        for shape, count in ((w.measured, w.measured_pods),) + w.measured_extra:
            shape.populate(store, count, groups=False)
        t0 = time.perf_counter()
        for pod in w.measured_pod_list():
            create_gang_pod(store, pod, sizes.get(pod.key(), 0))
        cycles.append(settle())
        measured_s = time.perf_counter() - t0
        for s in scheds:
            s.close()
        service_log = [r for svc in services for r in svc.batch_log]
        split = _wire_split(sched, service_log)
        init_ids = {c["batchId"] for c in list(sched.wire_log)[:log0]}
        measured = [r for r in split if r["batchId"] not in init_ids]
        device_times = [r["deviceTime"] for r in measured if r["deviceTime"]]
        on_node: Dict[str, List[Pod]] = {}
        for p in store.pods.values():
            if p.spec.node_name:
                on_node.setdefault(p.spec.node_name, []).append(p)
        over = []
        for name, pods in on_node.items():
            ni = NodeInfo(store.nodes[name])
            for p in pods:
                ni.add_pod(p)
            if len(pods) > ni.allocatable.allowed_pod_number or any(
                    v > ni.allocatable.get(k) for k, v in ni.requested.as_map().items()
                    if k != resource_api.PODS):
                over.append(name)
        out = {
            "placed": {k: p.spec.node_name for k, p in store.pods.items()},
            "pods_per_s": w.n_measured / measured_s, "measured_s": measured_s,
            "attempt_ms": {f"p{q}": hist.quantile(q / 100, "scheduled", DEFAULT_SCHEDULER,
                                                  since=n_before) * 1e3
                           for q in (50, 90, 99)}
            if hist.count("scheduled", DEFAULT_SCHEDULER) > n_before else None,
            "batches": sum(svc.batch_counter for svc in services),
            "paths": [p for svc in services for p in svc.batch_paths],
            "batch_pods": [c["pods"] for c in sched.wire_log],
            "launches": fused_step.LAUNCHES - launches, "cycles": cycles,
            "metrics": dict(sched.metrics), "pending": sched.queue.pending_pods(),
            "queued": sorted((qp.pod.key(), tuple(sorted(qp.unschedulable_plugins)))
                             for qp in sched.queue.pending_pod_infos()),
            "nominations": list(sched.nominations),
            "settle_abandoned": any(s.settle_abandoned for s in scheds),
            "wire": measured,
            "wire_split_ms": {k: float(np.median([r[k] for r in measured])) if measured else None
                              for k in WIRE_STAGES},
            "device_time_ms": {k: float(np.median([d[k] for d in device_times if k in d]))
                               for k in ("dwellMs", "execMs", "fetchMs", "deviceExecMs")
                               if any(k in d for d in device_times)},
            "client_batches": sum(s.wire_batches for s in scheds),
            "replays": sum(svc.batch_replays for svc in services),
            "resyncs": sum(s.resyncs for s in scheds),
            "conflicts": sum(s.smetrics.commit_conflicts.labels(s.client_id) for s in scheds),
            "service_conflicts": sum(svc.commit_conflicts for svc in services),
            "rejoins": sum(s.session_rejoins for s in scheds),
            "restarts": len(services) - n_services,
            "degraded_pods": sum(s.degraded_pods for s in scheds),
            "double_binds": sorted(double_binds), **tally,
            "over_capacity": over, "depth": depth, "replicas": replicas,
            "transport": transport,
        }
        if n_services > 1:
            out.update({
                "failovers": dict((k[0], v) for k, v in
                                  sched.smetrics.fabric_failovers.by_labels.items()),
                "active": sched.client.active_replica().index,
                "per_replica": per_replica,
                "failover_ms": ((kill["first"] - kill["t"]) * 1e3
                                if kill["first"] is not None else None),
                "promote_ms": promote["ms"],
                "promote_bytes": kill["promote_bytes"],
                "replication_bytes": dict((k[0], v) for k, v in
                                          sched.smetrics.standby_resync_bytes.by_labels.items()),
            })
        return out
    finally:
        if own_telemetry:
            telemetry.disable()
        for s in scheds:
            close = getattr(s.client, "close", None)
            if close is not None:
                close()
        for stop_fn in stops:
            stop_fn()


def run_fabric_outage(w: Workload, device, batch_size: int = LOOP_BATCH,
                      percentage: int = 0) -> dict:
    """All replicas of a two-replica device fabric down, then one back,
    through ``WireScheduler`` on a FakeClock (every clock of the client:
    retry sleeps, breakers, the probe interval, pod backoff): the JAX
    suite's ``test_all_replicas_down_degrades_to_oracle_then_heals`` at
    ``w``'s size. Both endpoints killed, ``w``'s nodes and init pods
    settle: the breaker opens after three failed batches (its default
    threshold) and the pods take the sequential path. Then the second replica
    heals, the clock passes the breaker's reset, the measured pods arrive:
    the half-open probe rides the fabric's ``health()``, which fails over
    to the replica that answers, and the batched path resumes there.

    Returns ``placed``, ``outage`` and ``healed`` (each: the breaker state,
    the degraded pods, ``dispatched_open`` (fabric scheduleBatch calls made
    while the breaker was open), the services' ``batches``, the fused
    ``launches`` of the step, the active replica, failovers by reason) and
    ``bound``. The servers are stopped before it returns."""
    from ..backend.service import DeviceService, WireScheduler, serve, stop
    from ..ops import fused_step
    from ..testing.faults import FaultPlan

    clock = FakeClock()
    services = [DeviceService(batch_size=batch_size, percentage_of_nodes_to_score=percentage,
                              device=device) for _ in range(2)]
    servers = [serve(svc)[0] for svc in services]
    plans = [FaultPlan().kill(), FaultPlan().kill()]
    sched = None
    try:
        store = Store(now_fn=clock)
        sched = WireScheduler(
            store, endpoint=[f"http://127.0.0.1:{srv.server_address[1]}" for srv in servers],
            batch_size=batch_size, wire_pipeline_depth=0, batch_deadline_ms=0,
            heartbeat_interval_s=0.0,
            standby_replication=False, fault_plan=plans, now_fn=clock, sleep_fn=clock.advance,
            pod_initial_backoff=REPLICA_BACKOFF_S[0], pod_max_backoff=REPLICA_BACKOFF_S[1])
        fabric = sched.client
        dispatched_open = [0]
        send = fabric.schedule_batch

        def watched(payload):
            if sched.breaker.state == "open":
                dispatched_open[0] += 1
            return send(payload)

        fabric.schedule_batch = watched

        def settle() -> None:
            sched.run_until_settled()
            while sched.queue.pending_pods()["backoff"]:
                clock.advance(REPLICA_BACKOFF_S[1])
                sched.run_until_settled()

        def step(pods) -> dict:
            launches = fused_step.LAUNCHES
            for pod in pods:
                store.create_pod(pod)
            settle()
            return {"breaker": sched.breaker.state, "degraded_pods": sched.degraded_pods,
                    "dispatched_open": dispatched_open[0],
                    "batches": [svc.batch_counter for svc in services],
                    "launches": fused_step.LAUNCHES - launches,
                    "active": fabric.active_replica().index,
                    "failovers": dict((k[0], v) for k, v in
                                      sched.smetrics.fabric_failovers.by_labels.items())}

        for ni in w.node_infos():
            store.create_node(ni.node)
        outage = step(w.init_pod_list())
        plans[1].heal()
        clock.advance(sched.breaker.reset_timeout_s + 0.5)
        healed = step(w.measured_pod_list())
        placed = {k: p.spec.node_name for k, p in store.pods.items()}
        return {"placed": placed, "outage": outage, "healed": healed,
                "bound": sum(1 for v in placed.values() if v)}
    finally:
        if sched is not None:
            sched.close()
        for srv in servers:
            stop(srv)


def _time_posts(extenders) -> Dict[str, List[float]]:
    """Wrap each HTTP extender's POST (``HTTPExtender._post``) to record its
    ms by verb; returns the record."""
    out: Dict[str, List[float]] = {}
    for ext in extenders:
        post = getattr(ext, "_post", None)
        if post is None:
            continue

        def timed(verb, payload, _post=post):
            import time

            t = time.perf_counter()
            try:
                return _post(verb, payload)
            finally:
                out.setdefault(verb, []).append((time.perf_counter() - t) * 1e3)

        ext._post = timed
    return out


def _mirror_tensors(state) -> dict:
    """Copies of every tensor of the mirror ``state``, by group and field."""
    return {f"{type(g).__name__}.{f.name}": getattr(g, f.name).clone()
            for g in (state.nt, state.tc) for f in dataclasses.fields(g)
            if hasattr(getattr(g, f.name), "clone")}


def _sizer_model(s) -> dict:
    """The deadline sizer's model: the latency fit ``a`` + ``b`` x bucket,
    the commit-wait fit ``wa`` + ``wb`` x bucket, and the bucket
    ``target`` picks."""
    return {"a": float(s._fit.a), "b": float(s._fit.b), "wa": float(s._wfit.a),
            "wb": float(s._wfit.b), "target": s.target()}


def _volume_outcome(store: Store) -> dict:
    """What a loop run left for claims and volumes (``run_loop``'s keys):
    ``pv_bindings`` (PV -> its claim), ``claims`` (claim key -> (allocated
    node, reserved-for pod keys)), ``csi_over`` (nodes with more volumes of
    a CSINode's driver than its limit; only PVCs with a storage class name
    a driver) and ``rwop_shared`` (ReadWriteOncePod PVCs used by more than
    one bound pod)."""
    users: Dict[str, List[str]] = {}
    on_node: Dict[str, Dict[str, set]] = {}
    for key, pod in store.pods.items():
        if not pod.spec.node_name:
            continue
        for vol in pod.spec.volumes:
            pvc = store.get_pvc(f"{pod.meta.namespace}/{vol}")
            if pvc is None:
                continue
            users.setdefault(pvc.meta.key(), []).append(key)
            sc = store.get_storage_class(pvc.storage_class)
            if sc is not None:
                on_node.setdefault(pod.spec.node_name, {}).setdefault(
                    sc.provisioner, set()).add(pvc.meta.key())
    csi_over = sorted(
        name for name, drivers in on_node.items()
        if (cn := store.get_csinode(name)) is not None
        and any(len(v) > cn.drivers.get(d, len(v)) for d, v in drivers.items()))
    rwop_shared = sorted(k for k, pods in users.items()
                         if len(pods) > 1 and RWOP in store.get_pvc(k).access_modes)
    return {"pv_bindings": {name: pv.bound_pvc for name, pv in store.pvs.items()},
            "claims": {k: (c.allocated_node, c.reserved_for)
                       for k, c in store.resource_claims.items()},
            "csi_over": csi_over, "rwop_shared": rwop_shared}


@dataclasses.dataclass(frozen=True)
class DelayedBinding:
    """A seeded delayed-binding case: ``nodes`` nodes in 10 zones, a
    WaitForFirstConsumer StorageClass, ``pods`` pods (100m / 500Mi) each
    with its own unbound PVC of that class, and ``pvs`` free zonal PVs of
    the class (fewer than the pods: each PV admits the nodes of one zone,
    its zone and its size drawn from seed 0), then ``extra_pvs`` more
    created once the first ones are taken, whose events move the pods
    that found none."""

    nodes: int = 500
    pods: int = 128
    pvs: int = 96
    extra_pvs: int = 16

    @property
    def name(self) -> str:
        return f"DelayedBinding/{self.nodes}Nodes"

    def pv_list(self) -> List[PersistentVolume]:
        rng = np.random.RandomState(0)
        zones = rng.randint(0, 10, self.pvs + self.extra_pvs)
        sizes = rng.randint(1, 5, self.pvs + self.extra_pvs)
        return [PersistentVolume(
            meta=ObjectMeta(name=f"pv-{j}", namespace=""), capacity_bytes=int(sizes[j]) << 30,
            storage_class="wffc", access_modes=(ROX,),
            node_affinity={LABEL_TOPOLOGY_ZONE: (f"zone-{zones[j]}",)})
            for j in range(self.pvs + self.extra_pvs)]


DELAYED_ROUNDS = 32  # settles at most, each after the backoff's 11 s on the clock


def run_delayed_binding(c: DelayedBinding, device) -> dict:
    """Drive ``c`` through the scheduler loop on a FakeClock: the nodes,
    the class, the first PVs, the PVCs and the pods created; settles, each
    after the clock advanced past the backoff, until one binds nothing;
    then the extra PVs and settles again. A pod whose PV a batch sibling
    bound first is refused at PreBind and retried (the pods of one zone
    choose the same smallest free PV, so about one binds per zone and
    settle). Returns ``placed``,
    ``pv_bindings``, ``metrics``, ``batch_pods``, ``modes``, ``paths``,
    ``launches`` (fused-kernel launches), ``fallback_scheduled``,
    ``rounds`` (settles), ``pods_per_s`` (pods bound over the settles'
    wall seconds), ``batch_ms``, ``screen_ms``, ``_relay_outcome``'s and
    ``_volume_outcome``'s keys."""
    import time

    from ..backend.tpu_scheduler import TPUScheduler
    from ..ops import fused_step

    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = TPUScheduler(store, device=device, batch_size=LOOP_BATCH, batch_deadline_ms=0,
                         now_fn=clock, percentage_of_nodes_to_score=100)
    for ni in scheduling_basic_nodes(c.nodes):
        store.create_node(ni.node)
    store.create_storage_class(StorageClass(meta=ObjectMeta(name="wffc", namespace=""),
                                            provisioner="ebs.csi.aws.com",
                                            volume_binding_mode=BINDING_WAIT_FOR_FIRST_CONSUMER))
    pvs = c.pv_list()
    for pv in pvs[:c.pvs]:
        store.create_pv(pv)
    launches = fused_step.LAUNCHES
    t0 = time.perf_counter()
    for i in range(c.pods):
        store.create_pvc(PersistentVolumeClaim(meta=ObjectMeta(name=f"late-{i}"),
                                               storage_class="wffc", access_modes=(ROX,),
                                               requested_bytes=1 << 30))
        store.create_pod(make_pod(f"late-{i}").req(_SMALL_REQ).pvc(f"late-{i}").obj())
    rounds = 0
    for extra in (False, True):
        if extra:
            for pv in pvs[c.pvs:]:
                store.create_pv(pv)
        for _ in range(DELAYED_ROUNDS):
            before = sched.metrics["scheduled"]
            sched.run_until_settled()
            rounds += 1
            clock.advance(11.0)
            sched.queue.flush_backoff_completed()
            if sched.metrics["scheduled"] == before:
                break
    sched.close()
    wall = time.perf_counter() - t0
    return {
        "placed": {k: p.spec.node_name for k, p in store.pods.items()},
        "metrics": dict(sched.metrics), "batch_pods": list(sched.batch_pods),
        "modes": list(sched.batch_modes), "paths": list(sched.batch_paths),
        "launches": fused_step.LAUNCHES - launches,
        "fallback_scheduled": sched.fallback_scheduled, "rounds": rounds,
        "pods_per_s": sched.metrics["scheduled"] / wall,
        "batch_ms": [t * 1e3 for t in sched.cycle_seconds],
        "screen_ms": {k: v * 1e3 for k, v in sched.screen_seconds.items()},
        **_relay_outcome(sched), **_volume_outcome(store),
    }


def _relay_outcome(sched) -> dict:
    """The relay breaker's openings over a loop run and the batchable pods
    it sent down the sequential path: both 0 unless a commit failed."""
    return {"relay_opens": sched.relay_breaker.opens,
            "relay_degraded_pods": sched.relay_degraded_pods}


def _gang_outcome(sched, store: Store, torus: bool) -> dict:
    """What a loop run left for gangs and quota (``run_loop``'s keys)."""
    out = {"gang_rejected": {labels[0]: n for labels, n in
                             sched.smetrics.gangs_rejected.by_labels.items()},
           "pod_groups": {k: (g.phase, g.scheduled) for k, g in store.pod_groups.items()},
           "waiting": sorted(sched.waiting_pods), "gated": sched.queue.pending_pods()["gated"],
           "gang_ms": sched.gang_seconds * 1e3, "gang_reads": sched.gang_reads,
           "flagged": sched.quota_flagged}
    if torus:
        infos = {n: NodeInfo(node) for n, node in store.nodes.items()}
        for p in store.pods.values():
            if p.spec.node_name in infos:
                infos[p.spec.node_name].add_pod(p)
        out["slice_stats"] = slice_stats(infos.values())
    return out


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
# the flap's batch commits that die at their read (the JAX soak's
# ``{"round": rounds // 2, "batches": 3}``)
SOAK_FLAP_BATCHES = 3


def create_quotas(store, quotas: Iterable[SchedulingQuota]) -> None:
    """Each tenant's Namespace and SchedulingQuota, as the JAX harness's
    createQuota op writes them (``kubernetes_tpu/perf/harness.py:
    557-570``): the admission chain's NamespaceLifecycle refuses pods of a
    namespace the store does not hold."""
    for q in quotas:
        if q.meta.namespace not in store.namespaces:
            store.create_namespace(Namespace(meta=ObjectMeta(name=q.meta.namespace,
                                                             namespace="")))
        store.create_object("SchedulingQuota", q)


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


def mix_arrivals(mix: Sequence[SoakArrival], r: int, counter: int) -> List[Pod]:
    """Round ``r``'s pods of ``mix``, in mix order, each entry on its own
    ``every``; ``counter`` pods came before."""
    out: List[Pod] = []
    for entry, m in enumerate(mix):
        if r % m.every == 0:
            out += m.pods(entry, r, counter + len(out))
    return out


def mix_gang_size(mix: Sequence[SoakArrival], pod: Pod) -> int:
    """The gang size of ``pod``'s mix entry (its namespace's gang entry),
    0 for a pod of no gang."""
    if pod_group_key(pod) is None:
        return 0
    return next((m.gang_size for m in mix
                 if m.gang_size and m.namespace == pod.meta.namespace), 0)


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
    so its batches stay in mode ``off``. ``flap`` scripts one device flap
    through the scheduler loop (``soak_rounds``): the first three batch
    commits of round ``rounds // 2`` die at their read, as the JAX
    soak's ``flap`` does."""

    name: str
    nodes: int
    rounds: int
    scale: int
    mix: Tuple[SoakArrival, ...]
    cohort: str = ""
    device_attributes: Optional[Dict[str, tuple]] = None
    flap: bool = True

    def node_infos(self) -> List[NodeInfo]:
        return scheduling_basic_nodes(self.nodes, 10, self.device_attributes,
                                      _PREEMPTION_NODE)

    def gang_size(self, pod: Pod) -> int:
        return mix_gang_size(self.mix, pod)

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

    def create_quotas(self, store) -> None:
        create_quotas(store, self.quotas())

    def store(self) -> Store:
        """A fresh object store with the tenants' Namespaces and
        SchedulingQuotas."""
        store = Store()
        self.create_quotas(store)
        return store

    def arrivals(self, r: int, counter: int) -> List[Pod]:
        """Round ``r``'s pods, in mix order; ``counter`` pods came before."""
        return mix_arrivals(self.mix, r, counter)

    def populate(self, store: Store, pods: Iterable[Pod]) -> None:
        """The objects the round's pods need: each gang's PodGroup and each
        claim pod's ResourceClaim (and its class), as the JAX harness and
        its resourceclaim controller make them."""
        for pod in pods:
            gkey = pod_group_key(pod)
            if gkey is not None and store.get_object("PodGroup", gkey) is None:
                store.create_object("PodGroup", PodGroup(
                    meta=ObjectMeta(name=gkey.split("/", 1)[1], namespace=pod.meta.namespace),
                    min_member=self.gang_size(pod)))
            self.create_claims(store, pod)

    @staticmethod
    def create_claims(store, pod: Pod, convert=lambda obj: obj) -> None:
        """The claim pod's ResourceClaims ``<pod>-<entry>`` (and their class,
        once) in ``store``; ``convert`` turns the port's objects into the
        store's package's."""
        c = SOAK_CLAIM
        for entry in pod.spec.resource_claims:
            if store.get_object("ResourceClass", c.klass) is None:
                store.create_object("ResourceClass", convert(ResourceClass(
                    meta=ObjectMeta(name=c.klass, namespace=""), driver_name=c.klass,
                    selectors=dict(c.class_selectors))))
            store.create_object("ResourceClaim", convert(ResourceClaim(
                meta=ObjectMeta(name=f"{pod.meta.name}-{entry.name}",
                                namespace=pod.meta.namespace),
                resource_class_name=c.klass, selectors=dict(c.selectors))))


def scheduling_soak(nodes: int = 1000, rounds: int = 8, scale: int = 24, gangs: bool = True,
                    cohort: str = "", claims: bool = True, flap: bool = True) -> Soak:
    """The JAX ``scheduling_soak`` at its published size; ``cohort`` names
    the pool of the ``/Cohort`` variant (the JAX one passes it as is),
    ``gangs=False`` drops soak-a's gangs and ``claims=False`` soak-b's
    claim pods with the nodes' device attributes, as the JAX one's
    ``gangs`` and ``claims`` do (``/NoGangs``, ``/NoClaims``); ``flap``
    is the JAX one's too (on by default)."""
    mix = [SoakArrival(ns, max(w * scale // 2, 2)) for ns, w in SOAK_TENANTS]
    if gangs:
        mix.append(SoakArrival("soak-a", 8, every=2, prefix="gang", gang_size=8))
    if claims:
        mix.append(SoakArrival("soak-b", max(scale // 2, 2), prefix="claim", claim=SOAK_CLAIM))
    mix.append(SoakArrival("soak-c", 2, every=2, prefix="preemptor",
                           req={"cpu": "2", "memory": "4Gi"}, priority=100))
    attrs = ({"tpu.dev/cores": (8, 16), "tpu.dev/gen": ("v5", "v5", "v4", "v5")}
             if claims else None)
    suffix = (("/Cohort" if cohort else "") + ("" if gangs else "/NoGangs")
              + ("" if claims else "/NoClaims"))
    return Soak(f"SchedulingSoak/{nodes}Nodes{suffix}", nodes, rounds, scale, tuple(mix),
                cohort, attrs, flap)


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
    device flap (BatchScheduler has no relay breaker; the loop's soak,
    ``soak_rounds``, has the flap); no DRR queue, tick-driven cycles or
    release moves (the scheduler loop): pods go in arrival order, so
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


def round_arrivals(w, create: Callable[[Pod], None]) -> Callable[[int], List[str]]:
    """The phases' ``arrive`` for a workload ``w``: round ``r``'s pods
    (``w.arrivals``, numbered on from the rounds before), each passed to
    ``create`` in order; returns their keys."""
    counter = [0]

    def arrive(r: int) -> List[str]:
        pods = w.arrivals(r, counter[0])
        counter[0] += len(pods)
        for pod in pods:
            create(pod)
        return [p.key() for p in pods]

    return arrive


def soak_rounds(w: Soak, store, sched, quota, clock, convert=lambda obj: obj) -> dict:
    """The JAX harness's soak phase (``phases.soak_loop``) of ``w`` over a
    scheduler loop ``sched`` on ``store`` and ``clock`` (either package's:
    ``convert`` turns the port's pods and PodGroups into the store's
    package's objects; ``quota`` is the loop's QuotaAdmission). Each round
    creates ``w``'s arrivals (a gang's PodGroup just before its first
    member, a claim pod's claims just before it), then runs up to
    ``SOAK_CYCLES_PER_ROUND`` batch cycles with the clock advanced
    ``SOAK_TICK_S`` after each, then churns ``SOAK_CHURN_FRAC``. With
    ``w.flap``, the first ``SOAK_FLAP_BATCHES`` batch commits of round
    ``rounds // 2`` die at their read (``:823-910``).
    Returns ``soak_loop``'s dict but its ``waits``."""
    def create(pod: Pod) -> None:
        w.create_claims(store, pod, convert)
        create_gang_pod(store, pod, w.gang_size(pod), convert)

    out = soak_loop(store, sched, quota, clock, w.rounds, round_arrivals(w, create),
                    [ns for ns, _w in SOAK_TENANTS],
                    cycle=lambda: sched.schedule_batch_cycle() > 0,
                    cycles_per_round=SOAK_CYCLES_PER_ROUND, tick_s=SOAK_TICK_S,
                    churn_frac=SOAK_CHURN_FRAC, breaker=sched.relay_breaker,
                    flap_round=w.rounds // 2 if w.flap else None,
                    flap_batches=SOAK_FLAP_BATCHES)
    del out["waits"]
    return out


def run_loop_soak(w: Soak, device, percentage: int = 0, comparer_every_n: int = 0) -> dict:
    """Drive the soak ``w`` through the port's scheduler loop
    (``soak_rounds``) on a FakeClock: a fresh ``Store`` and
    ``TPUScheduler``, then the nodes and the tenants' SchedulingQuotas
    created through the store, then the rounds (with the device flap when
    ``w.flap``). ``percentage`` is percentageOfNodesToScore (0: the
    adaptive default, which samples on the CPU from 100 nodes on);
    ``comparer_every_n`` the loop's oracle comparer (0: off).

    Returns ``soak_rounds``' dict with ``placed`` (pod key -> node, "" when
    unbound), ``pending``, ``batch_pods``, ``modes``, ``paths``,
    ``launches`` (fused-kernel launches), ``pods_per_s`` (pods bound over
    the wall seconds of the rounds), ``soak_s``, ``attempt_ms`` (p50 / p99
    of the scheduled attempts on the soak's clock, which advances
    ``SOAK_TICK_S`` per cycle), ``batch_ms`` (each cycle's wall ms on the
    scheduling thread), ``stage_ms``, ``commit_ms``, ``evicted`` and
    ``reclaims`` (the reclaim pass's evictions and passes that evicted),
    ``relay_opens`` and ``relay_degraded_pods`` (the relay breaker's
    openings and the batchable pods it sent down the sequential path) and
    ``run_loop``'s gang keys."""
    import time

    from ..backend.tpu_scheduler import TPUScheduler
    from ..ops import fused_step

    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = TPUScheduler(store, device=device, batch_size=LOOP_BATCH, batch_deadline_ms=0,
                         now_fn=clock, percentage_of_nodes_to_score=percentage,
                         comparer_every_n=comparer_every_n)
    for ni in w.node_infos():
        store.create_node(ni.node)
    w.create_quotas(store)
    launches = fused_step.LAUNCHES
    t0 = time.perf_counter()
    out = soak_rounds(w, store, sched, sched._quota_plugin(), clock)
    soak_s = time.perf_counter() - t0
    sched.close()
    hist = sched.smetrics.scheduling_attempt_duration
    out.update({
        "placed": {k: p.spec.node_name for k, p in store.pods.items()},
        "pending": sched.queue.pending_pods(), "batch_pods": list(sched.batch_pods),
        "modes": list(sched.batch_modes), "paths": list(sched.batch_paths),
        "launches": fused_step.LAUNCHES - launches,
        "pods_per_s": sum(out["bound"].values()) / soak_s, "soak_s": soak_s,
        "attempt_ms": {f"p{q}": hist.quantile(q / 100, "scheduled", DEFAULT_SCHEDULER) * 1e3
                       for q in (50, 99)},
        "batch_ms": [t * 1e3 for t in sched.cycle_seconds],
        "stage_ms": {k: v * 1e3 for k, v in sched.stage_seconds.items()},
        "commit_ms": {k: v * 1e3 for k, v in sched.commit_seconds.items()},
        "evicted": sum(sched.smetrics.evicted_pods.by_labels.values()), "reclaims": sched._quota_plugin().reclaims_executed,
        "fallback_scheduled": sched.fallback_scheduled,
        "screen_ms": {k: v * 1e3 for k, v in sched.screen_seconds.items()},
        **_relay_outcome(sched), **_volume_outcome(store),
        **_gang_outcome(sched, store, False),
    })
    return out


# SchedulingBorrow's tenants: (namespace, weight, pods cap in units of scale)
BORROW_TENANTS = (("borrow-lender", 2, 3), ("borrow-hungry", 1, 1))
BORROW_POOL = "pool"


@dataclasses.dataclass(frozen=True)
class Borrow:
    """SchedulingBorrow (``kubernetes_tpu/perf/workloads.py:528-565``), the
    cohort-borrowing A/B: ``nodes`` nodes of cpu 4 / 16Gi / 32 pods in 4
    zones; an idle lender (SchedulingQuota weight 2, ``pods`` cap 3 x
    ``scale``) and a hungry borrower (weight 1, cap ``scale``) in the cohort
    ``cohort`` ("pool"; "" for the ``/NoBorrow`` arm, which drops only the
    cohort: the same caps, the same arrivals). Per round ``scale`` hungry
    pods and one lender pod of 100m / 500Mi; at round ``rounds // 2`` the
    lender wakes with a burst of 2 x ``scale`` - 4, which with borrowing on
    must be funded by reclaiming the borrower's loans. ``cycles_per_round``
    batch cycles per round, the clock advanced ``tick_s`` after each
    (``borrow_rounds``)."""

    name: str
    nodes: int
    rounds: int
    scale: int
    cohort: str = BORROW_POOL
    cycles_per_round: int = 60
    tick_s: float = 0.05

    def node_infos(self) -> List[NodeInfo]:
        return scheduling_basic_nodes(self.nodes, 4, capacity=_PREEMPTION_NODE)

    def caps(self) -> Capacities:
        return caps_for_cluster(self.nodes)

    def tenants(self) -> List[str]:
        return sorted(ns for ns, _w, _m in BORROW_TENANTS)

    def quotas(self) -> List[SchedulingQuota]:
        return [SchedulingQuota(meta=ObjectMeta(name="quota", namespace=ns), weight=w,
                                cohort=self.cohort, hard={"pods": m * self.scale})
                for ns, w, m in BORROW_TENANTS]

    def create_quotas(self, store) -> None:
        create_quotas(store, self.quotas())

    @property
    def mix(self) -> Tuple[SoakArrival, ...]:
        return (SoakArrival("borrow-hungry", self.scale, prefix="hungry"),
                SoakArrival("borrow-lender", 1, prefix="lender"))

    @property
    def burst_round(self) -> int:
        return self.rounds // 2

    def arrivals(self, r: int, counter: int) -> List[Pod]:
        """Round ``r``'s pods in the JAX harness's order: the mix, then at
        the burst round the lender's wake-up burst (the next entry)."""
        out: List[Pod] = []
        for entry, m in enumerate(self.mix):
            out += m.pods(entry, r, counter + len(out))
        if r == self.burst_round:
            burst = SoakArrival("borrow-lender", 2 * self.scale - 4, prefix="wake")
            out += burst.pods(len(self.mix), r, counter + len(out))
        return out


def scheduling_borrow(nodes: int = 1000, rounds: int = 8, scale: int = 100,
                      borrowing: bool = True, cycles_per_round: int = 60,
                      tick_s: float = 0.05) -> Borrow:
    """SchedulingBorrow/<nodes>Nodes, and ``/NoBorrow`` without the cohort."""
    return Borrow(f"SchedulingBorrow/{nodes}Nodes{'' if borrowing else '/NoBorrow'}", nodes,
                  rounds, scale, BORROW_POOL if borrowing else "", cycles_per_round, tick_s)


def borrow_rounds(w: Borrow, store, sched, quota, clock, convert=lambda obj: obj) -> dict:
    """The JAX harness's borrow phase (``phases.borrow_loop``) of ``w``
    over a scheduler loop ``sched`` on ``store`` and ``clock`` (either
    package's, as ``soak_rounds``): ``w.cycles_per_round`` batch cycles a
    round at most, the clock advanced ``w.tick_s`` after each, the pool
    being ``w``'s tenants. Returns ``borrow_loop``'s dict."""
    tenants = w.tenants()
    arrive = round_arrivals(w, lambda pod: store.create_pod(convert(pod)))
    return borrow_loop(store, sched, quota, clock, w.rounds, arrive, tenants, tenants,
                       cycle=lambda: sched.schedule_batch_cycle() > 0,
                       cycles_per_round=w.cycles_per_round, tick_s=w.tick_s,
                       burst_round=w.burst_round)


def run_loop_borrow(w: Borrow, device, percentage: int = 0) -> dict:
    """Drive SchedulingBorrow ``w`` through the port's scheduler loop
    (``borrow_rounds``) on a FakeClock: a fresh ``Store`` and
    ``TPUScheduler``, the nodes and the tenants' quotas created through the
    store, and the latency ledger on (on the loop's clock and metrics, its
    quota tenants) for the run unless one is on already.

    Returns ``borrow_rounds``' dict with ``placed``, ``pods_per_s`` (pods
    bound over the wall seconds of the rounds), ``borrow_s``, ``launches``
    (fused-kernel launches), ``paths``, ``modes``, ``batch_pods``,
    ``e2e`` (namespace -> the ledger's e2e observations of its scheduled
    pods, in close order), ``evicted`` and ``reclaims``."""
    import time

    from ..backend.tpu_scheduler import TPUScheduler
    from ..metrics import latency_ledger
    from ..ops import fused_step

    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = TPUScheduler(store, device=device, batch_size=LOOP_BATCH, batch_deadline_ms=0,
                         now_fn=clock, percentage_of_nodes_to_score=percentage)
    for ni in w.node_infos():
        store.create_node(ni.node)
    w.create_quotas(store)
    own = latency_ledger.get() is None
    if own:
        latency_ledger.enable(sched.smetrics, now_fn=clock, tenant_fn=sched._ns_fair_weight)
    try:
        launches = fused_step.LAUNCHES
        t0 = time.perf_counter()
        out = borrow_rounds(w, store, sched, sched._quota_plugin(), clock)
        borrow_s = time.perf_counter() - t0
        sched.close()
    finally:
        if own:
            latency_ledger.disable()
    hist = sched.smetrics.tenant_e2e_duration
    out.update({
        "placed": {k: p.spec.node_name for k, p in store.pods.items()},
        "pods_per_s": sum(t["Admitted"] for t in out["tenants"].values()) / borrow_s,
        "borrow_s": borrow_s, "launches": fused_step.LAUNCHES - launches,
        "paths": list(sched.batch_paths), "modes": list(sched.batch_modes),
        "batch_pods": list(sched.batch_pods),
        "e2e": {ns: hist.values(ns) for ns in w.tenants()},
        "evicted": sum(sched.smetrics.evicted_pods.by_labels.values()),
        "reclaims": sched._quota_plugin().reclaims_executed,
    })
    return out


# the relay death's breaker (tests/test_faults.py:641's settings): open
# after two failed commits in a row, probed again 5 s later
RELAY_DEATH_THRESHOLD = 2
RELAY_DEATH_PROBE_S = 5.0


def relay_death(store, sched, clock, waves, convert=lambda obj: obj,
                observe=lambda: {}) -> dict:
    """tests/test_faults.py:641's relay death over a scheduler loop
    ``sched`` (either package's, built with ``relay_breaker_threshold=
    RELAY_DEATH_THRESHOLD`` and ``relay_probe_interval_s=
    RELAY_DEATH_PROBE_S``) on ``store`` and ``clock``, with three waves of
    pods (``convert`` as in ``soak_rounds``). Five steps, each: the clock
    advanced and the backoff flushed, the step's wave created, the loop
    settled.

      1. wave 0 arrives and every batch commit dies at its read (a
         ``TransientDeviceError`` from ``relay_fault_fn``): one failure;
      2. 1.1 s on, the retried pods' commits die: the breaker opens;
      3. 2.1 s on, the retried pods take the sequential path (degraded);
      4. the fault cleared, 1 s on, wave 1 arrives while the breaker is
         still open: degraded too;
      5. 2 s on, wave 2 arrives past the probe interval: its batch is the
         probe, commits and closes the breaker.

    Returns ``steps`` (per step the breaker's ``state``, ``opens`` and
    ``failures``, ``degraded_pods``, ``fallback_scheduled``,
    ``batch_scheduled``, ``batches`` (``batch_counter``), ``scheduled``
    and what ``observe()`` returns), ``faults`` (commits that died) and
    ``degraded_s``."""
    faults = 0

    def fault(_op: str):
        nonlocal faults
        faults += 1
        return TransientDeviceError("scripted relay death")

    degraded0 = sched.smetrics.degraded_seconds.labels()
    script = ((0, True, 0.0), (None, True, 1.1), (None, True, 2.1), (1, False, 1.0),
              (2, False, 2.0))
    steps = []
    for wave, on, advance in script:
        sched.relay_fault_fn = fault if on else None
        if advance:
            clock.advance(advance)
            sched.queue.flush_backoff_completed()
        if wave is not None:
            for pod in waves[wave]:
                store.create_pod(convert(pod))
        sched.run_until_settled()
        b = sched.relay_breaker
        steps.append({"state": b.state, "opens": b.opens, "failures": b.consecutive_failures,
                      "degraded_pods": sched.relay_degraded_pods,
                      "fallback_scheduled": sched.fallback_scheduled,
                      "batch_scheduled": sched.batch_scheduled, "batches": sched.batch_counter,
                      "scheduled": sched.metrics["scheduled"], **observe()})
    sched._drain_inflight()
    return {"steps": steps, "faults": faults,
            "degraded_s": sched.smetrics.degraded_seconds.labels() - degraded0}


def run_relay_death(w: Workload, device, percentage: int = 0) -> dict:
    """``relay_death`` through the port's loop at ``w``'s size on a
    FakeClock: ``w``'s nodes and init pods settle with no fault, then the
    measured pods arrive in three waves: one batch (``LOOP_BATCH`` pods),
    half a batch while the breaker is open, and the rest, whose batch is
    the probe. Each step also records ``mirror`` (whether the loop holds a
    device mirror) and ``launches`` (fused-kernel launches since the init
    pods settled). Returns ``relay_death``'s dict with ``placed``,
    ``relay_degraded_pods``, ``fallback_scheduled``, ``relay_opens``,
    ``launches`` and ``seconds`` (the five steps' wall seconds)."""
    import time

    from ..backend.tpu_scheduler import TPUScheduler
    from ..ops import fused_step

    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = TPUScheduler(store, device=device, batch_size=LOOP_BATCH, batch_deadline_ms=0,
                         now_fn=clock, percentage_of_nodes_to_score=percentage,
                         relay_breaker_threshold=RELAY_DEATH_THRESHOLD,
                         relay_probe_interval_s=RELAY_DEATH_PROBE_S)
    for ni in w.node_infos():
        store.create_node(ni.node)
    for pod in w.init_pod_list():
        store.create_pod(pod)
    sched.run_until_settled()
    measured = w.measured_pod_list()
    b = LOOP_BATCH
    waves = (measured[:b], measured[b:b + b // 2], measured[b + b // 2:])
    launches = fused_step.LAUNCHES
    t0 = time.perf_counter()
    out = relay_death(store, sched, clock, waves, observe=lambda: {
        "mirror": sched.state is not None, "launches": fused_step.LAUNCHES - launches})
    seconds = time.perf_counter() - t0
    sched.close()
    out.update({"placed": {k: p.spec.node_name for k, p in store.pods.items()},
                "launches": fused_step.LAUNCHES - launches, "seconds": seconds,
                "fallback_scheduled": sched.fallback_scheduled, **_relay_outcome(sched)})
    return out


# ----------------------------------------------------------------- SchedulingReplay

# the replay's diurnal arrival curve (multipliers cycling over the rounds)
REPLAY_CURVE = (0.4, 0.7, 1.0, 1.4, 1.6, 1.3, 0.9, 0.5)
# the rebalancer's knobs in the JAX workload (``workloads.py:636-638``)
REPLAY_KNOBS = {"cooldown_s": 2.0, "score_interval_s": 0.5, "entropy_high": 0.85,
                "entropy_low": 0.70}


def device_state_of(sched):
    """A scheduler loop's DeviceState: the port loop's ``state`` (its
    ``device`` is the torch device), the JAX loop's ``device``; None before
    its first batch."""
    return sched.state if hasattr(sched, "state") else getattr(sched, "device", None)


@dataclasses.dataclass(frozen=True)
class Replay:
    """SchedulingReplay (``kubernetes_tpu/perf/workloads.py:599-639``), the
    continuous-rebalancing trace: ``nodes`` nodes of cpu 4 / 16Gi / 32 pods
    in 10 zones; SchedulingSoak's three tenants (weights 4 / 2 / 1) with
    quotas that never bind (``pods`` (weight + 2) x ``scale`` x 12,
    ``requests.cpu`` 1000 times that), each landing weight x ``scale`` / 2
    pods of 100m / 500Mi per round times the curve's multiplier, and soak-a
    8 pods in gangs of 4 (arrivals rounded down to whole gangs); bursts of
    2.5x at round ``rounds // 4`` and 2.0x at ``3 * rounds // 4``; from
    round ``rounds // 2`` the tenants' counts rotate (the tenant shift).
    After each round ``churn_frac`` of each tenant's replay-bound pods
    leave. ``rebalance`` is the rebalancer's knobs, None for the
    ``/NoRebalance`` arm."""

    name: str
    nodes: int
    rounds: int
    scale: int
    cycles_per_round: int = 120
    churn_frac: float = 0.3
    tick_s: float = 0.05
    gangs: bool = True
    rebalance: Optional[Dict[str, float]] = None
    shift: bool = True
    bursts: bool = True

    def node_infos(self) -> List[NodeInfo]:
        return scheduling_basic_nodes(self.nodes, 10, capacity=_PREEMPTION_NODE)

    def tenants(self) -> List[str]:
        return sorted(ns for ns, _w in SOAK_TENANTS)

    def quotas(self) -> List[SchedulingQuota]:
        return [SchedulingQuota(meta=ObjectMeta(name="quota", namespace=ns), weight=w,
                                hard={"pods": (w + 2) * self.scale * 12,
                                      "requests.cpu": (w + 2) * self.scale * 12000})
                for ns, w in SOAK_TENANTS]

    def create_quotas(self, store) -> None:
        create_quotas(store, self.quotas())

    @property
    def mix(self) -> Tuple[SoakArrival, ...]:
        mix = [SoakArrival(ns, max(w * self.scale // 2, 2)) for ns, w in SOAK_TENANTS]
        if self.gangs:
            mix.append(SoakArrival("soak-a", 8, prefix="gang", gang_size=4))
        return tuple(mix)

    def gang_size(self, pod: Pod) -> int:
        return mix_gang_size(self.mix, pod)

    def burst_rounds(self) -> Dict[int, float]:
        return {self.rounds // 4: 2.5, (3 * self.rounds) // 4: 2.0} if self.bursts else {}

    def arrivals(self, r: int, counter: int) -> List[Pod]:
        """Round ``r``'s pods, in mix order (``harness.py:1206-1227``);
        ``counter`` pods came before."""
        mix = self.mix
        counts = [m.count for m in mix]
        if self.shift and r >= self.rounds // 2:
            counts = counts[1:] + counts[:1]
        mult = REPLAY_CURVE[r % len(REPLAY_CURVE)] * float(self.burst_rounds().get(r, 1.0))
        out: List[Pod] = []
        for entry, m in enumerate(mix):
            n = int(round(counts[entry] * mult))
            if m.gang_size:
                n -= n % m.gang_size
            out += dataclasses.replace(m, count=n).pods(entry, r, counter + len(out))
        return out


def scheduling_replay(nodes: int = 500, rounds: int = 16, scale: int = 20,
                      cycles_per_round: int = 120, churn_frac: float = 0.3, tick_s: float = 0.05,
                      gangs: bool = True, rebalance=True, shift: bool = True,
                      bursts: bool = True) -> Replay:
    """SchedulingReplay/<nodes>Nodes at the JAX defaults; ``rebalance``
    True for ``REPLAY_KNOBS``, a dict of knobs, or False for the
    ``/NoRebalance`` arm."""
    knobs = (dict(rebalance) if isinstance(rebalance, dict)
             else dict(REPLAY_KNOBS) if rebalance else None)
    arm = "" if knobs else "/NoRebalance"
    return Replay(f"SchedulingReplay/{nodes}Nodes{arm}", nodes, rounds, scale, cycles_per_round,
                  churn_frac, tick_s, gangs, knobs, shift, bursts)


def replay_rounds(w: Replay, store, sched, clock, convert=lambda obj: obj,
                  score_fn=None, sequential: bool = False) -> dict:
    """The JAX harness's replay phase (``phases.replay_loop``) of ``w``
    over a scheduler loop ``sched`` on ``store`` and ``clock`` (either
    package's, as ``soak_rounds``). With ``w.rebalance`` the loop's
    ``enable_rebalancer`` attaches the rebalancer. The packing score is
    ``score_fn(sched)`` of the host snapshot; by default the port's
    ``score_from_snapshot`` on the CPU, so that runs on the card and on the
    CPU are judged by the same measure (the rebalancer's own scores run on
    the loop's device). ``sequential`` drives ``schedule_one`` (one pod per
    cycle, the sequential path: the JAX harness's ``oracle`` backend)
    instead of the batch cycle. Returns ``replay_loop``'s dict."""
    if score_fn is None:
        from ..controllers.rebalance import score_from_snapshot

        def score_fn(s):
            return score_from_snapshot(s, "cpu")
    rb = sched.enable_rebalancer(now_fn=clock, **w.rebalance) if w.rebalance else None
    arrive = round_arrivals(w, lambda pod: create_gang_pod(store, pod, w.gang_size(pod), convert))

    def score():
        sched.cache.update_snapshot(sched.snapshot)
        return score_fn(sched)

    return replay_loop(store, sched, clock, w.rounds, arrive, w.tenants(),
                       cycle=(sched.schedule_one if sequential
                              else lambda: sched.schedule_batch_cycle() > 0),
                       cycles_per_round=w.cycles_per_round, score=score, rebalancer=rb,
                       tick_s=w.tick_s, churn_frac=w.churn_frac)


def run_loop_replay(w: Replay, device, percentage: int = 0, sequential: bool = False) -> dict:
    """Drive SchedulingReplay ``w`` through the port's scheduler loop
    (``replay_rounds``, one pod per cycle with ``sequential``) on a
    FakeClock: a fresh ``Store`` and ``TPUScheduler``, the nodes and quotas
    created through the store, and the latency ledger on for the run (on
    the loop's clock, metrics and quota tenants) unless one is on already.

    Returns ``replay_rounds``' dict with ``placed``, ``pods_per_s`` (pods
    bound over the wall seconds of the trace), ``replay_s``, ``launches``
    (fused-kernel launches), ``paths``, ``batch_pods``, ``e2e`` (namespace
    -> its pods' e2e observations in close order), ``evicted`` (by
    reason) and ``mirror`` (the device mirror's ``requested`` rows and its
    schedulable rows at the end, the rebalancer's score inputs; None
    without a mirror)."""
    import time

    from ..backend.tpu_scheduler import TPUScheduler
    from ..controllers.rebalance import mirror_score_inputs
    from ..metrics import latency_ledger
    from ..ops import fused_step

    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = TPUScheduler(store, device=device, batch_size=LOOP_BATCH, batch_deadline_ms=0,
                         now_fn=clock, percentage_of_nodes_to_score=percentage)
    for ni in w.node_infos():
        store.create_node(ni.node)
    w.create_quotas(store)
    own = latency_ledger.get() is None
    if own:
        latency_ledger.enable(sched.smetrics, now_fn=clock, tenant_fn=sched._ns_fair_weight)
    try:
        launches = fused_step.LAUNCHES
        bound0 = sched.metrics["scheduled"]
        t0 = time.perf_counter()
        out = replay_rounds(w, store, sched, clock, sequential=sequential)
        replay_s = time.perf_counter() - t0
        sched.close()
    finally:
        if own:
            latency_ledger.disable()
    hist = sched.smetrics.tenant_e2e_duration
    out.update({
        "placed": {k: p.spec.node_name for k, p in store.pods.items()},
        "pods_per_s": (sched.metrics["scheduled"] - bound0) / replay_s, "replay_s": replay_s,
        "launches": fused_step.LAUNCHES - launches, "paths": list(sched.batch_paths),
        "batch_pods": list(sched.batch_pods),
        "e2e": {ns: hist.values(ns) for ns in w.tenants()},
        "evicted": dict(sched.smetrics.evicted_pods.by_labels),
        "mirror": mirror_score_inputs(sched.state),
    })
    return out


# ----------------------------------------------------------------- SchedulingElastic


@dataclasses.dataclass(frozen=True)
class Elastic:
    """SchedulingElastic (``kubernetes_tpu/perf/workloads.py:568-596``),
    cluster elasticity under load: ``nodes`` nodes of cpu 4 / 16Gi / 32
    pods in 10 zones; per round ``pods_per_round`` pods of 100m / 500Mi and
    (every second round) 8 pods in gangs of 4; after each round's first
    drive, one chaos step in turn: a storm (``storm_frac`` of the nodes
    drained, deleted, and replaced by nodes of new names), a rolling drain
    of the last ``drain_nodes`` nodes (uncordoned at the next drain), and
    a spot reclamation of ``spot_frac`` of the nodes (NoExecute taint,
    deleted, replaced). Evicted pods are created again unbound."""

    name: str
    nodes: int
    rounds: int = 6
    pods_per_round: int = 150
    storm_frac: float = 0.3
    drain_nodes: int = 8
    spot_frac: float = 0.15
    cycles_per_round: int = 120
    tick_s: float = 0.05
    gangs: bool = True
    settle_rounds: int = 2

    def node_infos(self, first: int = 0, count: Optional[int] = None) -> List[NodeInfo]:
        return scheduling_basic_nodes(self.nodes if count is None else count, 10,
                                      capacity=_PREEMPTION_NODE, first=first)

    @property
    def mix(self) -> Tuple[SoakArrival, ...]:
        mix = [SoakArrival("default", self.pods_per_round, prefix="el")]
        if self.gangs:
            mix.append(SoakArrival("default", 8, every=2, prefix="elg", gang_size=4))
        return tuple(mix)

    def gang_size(self, pod: Pod) -> int:
        return mix_gang_size(self.mix, pod)

    def arrivals(self, r: int, counter: int) -> List[Pod]:
        return mix_arrivals(self.mix, r, counter)


def scheduling_elastic(nodes: int = 1000, rounds: int = 6, pods_per_round: int = 150,
                       storm_frac: float = 0.3, drain_nodes: int = 8, spot_frac: float = 0.15,
                       cycles_per_round: int = 120, tick_s: float = 0.05,
                       gangs: bool = True) -> Elastic:
    """SchedulingElastic/<nodes>Nodes at the JAX defaults."""
    return Elastic(f"SchedulingElastic/{nodes}Nodes", nodes, rounds, pods_per_round, storm_frac,
                   drain_nodes, spot_frac, cycles_per_round, tick_s, gangs)


def elastic_rounds(w: Elastic, store, sched, clock, drain=None,
                   convert=lambda obj: obj) -> dict:
    """The JAX harness's elastic phase (``phases.elastic_loop``) of ``w``
    over a scheduler loop ``sched`` on ``store`` and ``clock`` (either
    package's, as ``soak_rounds``), evicting through ``drain``, a
    DrainOrchestrator of the store's package (the port's on the loop's
    metrics, queue and clock by default). New nodes take the next unused
    ordinal. Returns ``elastic_loop``'s dict."""
    if drain is None:
        from ..controllers.drain import DrainOrchestrator

        drain = DrainOrchestrator(store, metrics=sched.smetrics, queue=sched.queue,
                                  now_fn=clock)
    next_node = [w.nodes]

    def add_nodes(count: int) -> None:
        made = 0
        while made < count:
            i = next_node[0]
            next_node[0] += 1
            if f"node-{i}" in store.nodes:
                continue
            store.create_node(convert(w.node_infos(first=i, count=1)[0].node))
            made += 1

    arrive = round_arrivals(w, lambda pod: create_gang_pod(store, pod, w.gang_size(pod), convert))
    return elastic_loop(store, sched, clock, w.rounds, arrive,
                        cycle=lambda: sched.schedule_batch_cycle() > 0,
                        cycles_per_round=w.cycles_per_round, drain=drain, add_nodes=add_nodes,
                        device_state=lambda: device_state_of(sched), tick_s=w.tick_s,
                        storm_frac=w.storm_frac, drain_nodes=w.drain_nodes,
                        spot_frac=w.spot_frac, settle_rounds=w.settle_rounds)


def run_loop_elastic(w: Elastic, device, percentage: int = 0) -> dict:
    """Drive SchedulingElastic ``w`` through the port's scheduler loop
    (``elastic_rounds``) on a FakeClock: a fresh ``Store`` and
    ``TPUScheduler``, the nodes created through the store.

    Returns ``elastic_rounds``' dict with ``placed``, ``pods_per_s`` (pods
    bound over the wall seconds of the run), ``elastic_s``, ``launches``
    (fused-kernel launches), ``paths`` and ``batch_pods``."""
    import time

    from ..backend.tpu_scheduler import TPUScheduler
    from ..ops import fused_step

    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = TPUScheduler(store, device=device, batch_size=LOOP_BATCH, batch_deadline_ms=0,
                         now_fn=clock, percentage_of_nodes_to_score=percentage)
    for ni in w.node_infos():
        store.create_node(ni.node)
    launches = fused_step.LAUNCHES
    bound0 = sched.metrics["scheduled"]
    t0 = time.perf_counter()
    out = elastic_rounds(w, store, sched, clock)
    elastic_s = time.perf_counter() - t0
    sched.close()
    out.update({
        "placed": {k: p.spec.node_name for k, p in store.pods.items()},
        "pods_per_s": (sched.metrics["scheduled"] - bound0) / elastic_s,
        "elastic_s": elastic_s, "launches": fused_step.LAUNCHES - launches,
        "paths": list(sched.batch_paths), "batch_pods": list(sched.batch_pods),
    })
    return out
