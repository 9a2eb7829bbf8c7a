"""Scheduling-relevant API object model.

Own copy of the scheduling part of ``kubernetes_tpu/api/types.py``: a small,
typed mirror of the parts of k8s.io/api/core/v1 that the scheduler consumes:
Pod spec (resources, affinity, tolerations, topology-spread, priority, ports),
Node (allocatable, taints, labels, images), and label/node selectors.

These are plain dataclasses — the "wire format" of this framework is Python
objects (and, on the hot path, the dense tensors produced by ops/encode.py).
Reference anchors are cited per type.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import resource as resource_api

# ---------------------------------------------------------------------------
# meta


@dataclass(frozen=True)
class OwnerReference:
    """metav1.OwnerReference (kind + name + controller flag); drives both
    SelectorSpread's owner lookup (helper/spread.go DefaultSelector) and the
    garbage collector's ownership graph."""

    kind: str = ""
    name: str = ""
    controller: bool = False
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    creation_timestamp: float = 0.0  # set by the store on create (metav1)
    deletion_timestamp: float = 0.0  # >0 ⇒ terminating (metav1 DeletionTimestamp)
    owner_references: Tuple["OwnerReference", ...] = ()
    # metav1 Finalizers: a delete with finalizers present only marks the
    # object terminating; removal happens when the last finalizer is cleared
    # (the pvc/pv-protection controllers' mechanism)
    finalizers: Tuple[str, ...] = ()

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def controller_of(self) -> Optional["OwnerReference"]:
        """metav1.GetControllerOf: the single ownerReference with controller=true."""
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None


# ---------------------------------------------------------------------------
# selectors (apimachinery pkg/labels + core/v1 node selectors)

# LabelSelector / NodeSelectorRequirement operators
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


@dataclass
class Requirement:
    """One match expression. Semantics of labels.Requirement.Matches
    (apimachinery pkg/labels/selector.go): an absent key matches NotIn and
    DoesNotExist; Gt/Lt parse the label value as an integer."""

    key: str
    operator: str
    values: Tuple[str, ...] = ()

    def matches(self, labels: Dict[str, str]) -> bool:
        has = self.key in labels
        if self.operator == IN:
            return has and labels[self.key] in self.values
        if self.operator == NOT_IN:
            return not has or labels[self.key] not in self.values
        if self.operator == EXISTS:
            return has
        if self.operator == DOES_NOT_EXIST:
            return not has
        if self.operator in (GT, LT):
            if not has:
                return False
            try:
                lhs = int(labels[self.key])
                rhs = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lhs > rhs if self.operator == GT else lhs < rhs
        raise ValueError(f"unknown operator {self.operator!r}")


@dataclass
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions (all must hold).
    An empty selector matches everything; a None selector matches nothing
    (v1helper.LabelSelectorAsSelector convention) — plugins model that with the
    shared MATCH_NOTHING sentinel below (labels.Nothing() analog)."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: Tuple[Requirement, ...] = ()
    match_nothing: bool = False  # labels.Nothing(): unforgeable never-match

    def matches(self, labels: Dict[str, str]) -> bool:
        if self.match_nothing:
            return False
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        return all(r.matches(labels) for r in self.match_expressions)

    def signature(self) -> Tuple:
        """Hashable identity used by the incremental selector-count index
        (backend/sigindex.py)."""
        return (
            tuple(sorted(self.match_labels.items())),
            tuple((r.key, r.operator, tuple(r.values)) for r in self.match_expressions),
            self.match_nothing,
        )


MATCH_NOTHING = LabelSelector(match_nothing=True)


@dataclass
class NodeSelectorTerm:
    """core/v1.NodeSelectorTerm: AND of matchExpressions (+ matchFields, of
    which only metadata.name is legal — modeled via ``match_fields_name``)."""

    match_expressions: Tuple[Requirement, ...] = ()
    match_fields_name: Optional[str] = None  # compiled 'metadata.name' In [x]

    def matches(self, node: "Node") -> bool:
        if self.match_fields_name is not None and node.meta.name != self.match_fields_name:
            return False
        if not self.match_expressions and self.match_fields_name is None:
            return False  # empty term matches nothing (nodeaffinity.go semantics)
        return all(r.matches(node.meta.labels) for r in self.match_expressions)


@dataclass
class NodeSelector:
    """core/v1.NodeSelector: OR of terms."""

    terms: Tuple[NodeSelectorTerm, ...] = ()

    def matches(self, node: "Node") -> bool:
        return any(t.matches(node) for t in self.terms)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: Tuple[PreferredSchedulingTerm, ...] = ()


@dataclass
class PodAffinityTerm:
    """core/v1.PodAffinityTerm. ``namespaces`` empty + selector None ⇒ the
    incoming pod's own namespace (defaulting done at AffinityTerm build time,
    framework/types.go:193 newAffinityTerm)."""

    label_selector: Optional[LabelSelector] = None
    topology_key: str = ""
    namespaces: Tuple[str, ...] = ()
    namespace_selector: Optional[LabelSelector] = None


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required: Tuple[PodAffinityTerm, ...] = ()
    preferred: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass
class PodAntiAffinity:
    required: Tuple[PodAffinityTerm, ...] = ()
    preferred: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# ---------------------------------------------------------------------------
# taints / tolerations

TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

TOLERATION_OP_EQUAL = "Equal"
TOLERATION_OP_EXISTS = "Exists"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    """core/v1.Toleration.ToleratesTaint semantics
    (component-helpers scheduling/corev1 helpers): empty effect matches all
    effects; empty key with Exists matches all taints."""

    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""
    # None = tolerate forever; N = the NoExecute taint manager evicts after
    # N seconds (core/v1 Toleration.TolerationSeconds)
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", TOLERATION_OP_EQUAL):
            return self.value == taint.value
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        return False


# ---------------------------------------------------------------------------
# topology spread

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None


# ---------------------------------------------------------------------------
# pod

PROTO_TCP = "TCP"
PROTO_UDP = "UDP"
PROTO_SCTP = "SCTP"


@dataclass(frozen=True)
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = PROTO_TCP
    host_ip: str = ""


@dataclass
class SecurityContext:
    """core/v1 SecurityContext, reduced to the fields Pod Security admission
    levels check (policy/pkg/api + pod-security-admission checks)."""

    privileged: Optional[bool] = None
    allow_privilege_escalation: Optional[bool] = None
    run_as_non_root: Optional[bool] = None
    run_as_user: Optional[int] = None
    capabilities_add: Tuple[str, ...] = ()
    capabilities_drop: Tuple[str, ...] = ()


@dataclass
class Container:
    name: str = ""
    image: str = ""
    requests: Dict[str, object] = field(default_factory=dict)  # resource -> quantity
    limits: Dict[str, object] = field(default_factory=dict)
    ports: Tuple[ContainerPort, ...] = ()
    security_context: Optional[SecurityContext] = None
    image_pull_policy: str = ""  # "" = kubelet default (IfNotPresent)


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: Tuple[Toleration, ...] = ()
    topology_spread_constraints: Tuple[TopologySpreadConstraint, ...] = ()
    priority: int = 0
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"  # or "Never" (core/v1 PreemptionPolicy)
    scheduler_name: str = "default-scheduler"
    overhead: Dict[str, object] = field(default_factory=dict)
    volumes: Tuple[str, ...] = ()  # PVC names (volume subsystem modeled by claim name)
    # generic ephemeral volume names: the ephemeral-volume controller creates
    # a PVC "<pod>-<name>" per entry, owned by the pod
    ephemeral_claims: Tuple[str, ...] = ()
    # secret/configMap volume sources by object name (core/v1 Volume
    # SecretVolumeSource/ConfigMapVolumeSource). These need no binding and
    # never gate scheduling (the SchedulingSecrets perf row measures exactly
    # that); the kubelet mounts them and the node authorizer limits kubelet
    # reads to objects referenced by pods bound to that node.
    secret_volumes: Tuple[str, ...] = ()
    config_map_volumes: Tuple[str, ...] = ()
    # resource.k8s.io claims consumed by this pod (core/v1
    # PodSpec.ResourceClaims); the DynamicResources plugin gates scheduling
    # on them and the resourceclaim controller materializes template entries
    resource_claims: Tuple["PodResourceClaim", ...] = ()
    service_account_name: str = ""
    host_network: bool = False
    host_pid: bool = False
    host_ipc: bool = False
    security_context: Optional[SecurityContext] = None  # pod-level defaults
    runtime_class_name: str = ""  # node.k8s.io RuntimeClass (overhead source)


@dataclass(frozen=True)
class PodResourceClaim:
    """core/v1 PodResourceClaim (pod.spec.resourceClaims[]): names one
    resource.k8s.io claim the pod consumes. Exactly one source is set:
    ``claim_name`` references an existing ResourceClaim directly;
    ``template_name`` names a ResourceClaimTemplate the resourceclaim
    controller materializes as ``<pod>-<name>`` (the generic-ephemeral-volume
    naming scheme, reused)."""

    name: str = ""
    claim_name: str = ""
    template_name: str = ""


@dataclass
class PodStatus:
    phase: str = "Pending"
    nominated_node_name: str = ""
    start_time: float = 0.0
    reason: str = ""   # machine-readable phase reason, e.g. "Evicted"
    message: str = ""  # human-readable detail


@dataclass
class Pod:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def key(self) -> str:
        return self.meta.key()

    def resource_request(self) -> Dict[str, int]:
        """computePodResourceRequest (noderesources/fit.go:159): canonical-int
        per-resource request = max(sum(containers), max(initContainers)) + overhead.
        Cached on the instance (specs are treated as immutable once created);
        clones share the cache via __dict__ copy. Callers must not mutate the
        returned dict."""
        cached = self.__dict__.get("_req_cache")
        if cached is not None:
            return cached
        total: Dict[str, int] = {}
        for c in self.spec.containers:
            for r, q in c.requests.items():
                total[r] = total.get(r, 0) + resource_api.canonical(r, q)
        for c in self.spec.init_containers:
            for r, q in c.requests.items():
                v = resource_api.canonical(r, q)
                if v > total.get(r, 0):
                    total[r] = v
        for r, q in self.spec.overhead.items():
            total[r] = total.get(r, 0) + resource_api.canonical(r, q)
        self.__dict__["_req_cache"] = total
        return total

    def invalidate_request_cache(self) -> None:
        """Drop the cached resource_request(). Must be called by anything
        that mutates container requests/limits after creation (LimitRanger
        defaulting, mutating-webhook patches) — clones share the cache, so a
        stale entry would silently feed the scheduler and quota accounting
        (ADVICE r3)."""
        self.__dict__.pop("_req_cache", None)

    def host_ports(self) -> Tuple[ContainerPort, ...]:
        return tuple(
            p for c in self.spec.containers for p in c.ports if p.host_port > 0
        )

    def clone(self) -> "Pod":
        """Copy with independent meta/spec/status; container/affinity objects
        are shared (treated as immutable once created — assume/bind only ever
        rewrites spec.node_name and status fields). Hand-rolled __dict__
        copies: this runs twice per scheduled pod (assume + bind) and
        dataclasses.replace() re-runs __init__ each call — ~6× slower."""
        new = object.__new__(Pod)
        new.__dict__.update(self.__dict__)
        meta = object.__new__(ObjectMeta)
        meta.__dict__.update(self.meta.__dict__)
        meta.labels = dict(self.meta.labels)
        spec = object.__new__(PodSpec)
        spec.__dict__.update(self.spec.__dict__)
        status = object.__new__(PodStatus)
        status.__dict__.update(self.status.__dict__)
        new.meta, new.spec, new.status = meta, spec, status
        return new


# ---------------------------------------------------------------------------
# node


@dataclass(frozen=True)
class ContainerImage:
    names: Tuple[str, ...] = ()
    size_bytes: int = 0


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: Tuple[Taint, ...] = ()
    pod_cidr: str = ""  # allocated by the nodeipam controller


@dataclass
class NodeStatus:
    capacity: Dict[str, object] = field(default_factory=dict)
    allocatable: Dict[str, object] = field(default_factory=dict)
    images: Tuple[ContainerImage, ...] = ()
    ready: bool = True
    # pressure conditions (core/v1 NodeConditionType MemoryPressure/
    # DiskPressure/PIDPressure), set by the kubelet eviction manager; the
    # nodelifecycle controller mirrors them as NoSchedule taints
    memory_pressure: bool = False
    disk_pressure: bool = False
    pid_pressure: bool = False
    # node-published device slice (resource.k8s.io structured parameters):
    # the per-node attribute map a DRA driver's kubelet plugin publishes
    # (the NodeResourceSlice object collapsed onto NodeStatus, like
    # allocatable). Values are ints or strings; selectors in
    # ResourceClass/ResourceClaim match against these (api/dra.py).
    device_attributes: Dict[str, object] = field(default_factory=dict)


@dataclass
class Node:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    def name(self) -> str:
        return self.meta.name

    def allocatable_canonical(self) -> Dict[str, int]:
        return {
            r: resource_api.canonical(r, q) for r, q in self.status.allocatable.items()
        }


# zone identity (component-helpers/node/topology/helpers.go GetZoneKey)
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_FAILURE_DOMAIN_BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_FAILURE_DOMAIN_BETA_REGION = "failure-domain.beta.kubernetes.io/region"
LABEL_HOSTNAME = "kubernetes.io/hostname"


def get_zone_key(node: "Node") -> str:
    """Unique per failure-zone id from node labels; '' when zoneless. Beta
    labels take precedence; region and zone are joined with a NUL separator
    (GetZoneKey, component-helpers/node/topology/helpers.go:30)."""
    labels = node.meta.labels
    zone = labels.get(LABEL_FAILURE_DOMAIN_BETA_ZONE, labels.get(LABEL_TOPOLOGY_ZONE, ""))
    region = labels.get(LABEL_FAILURE_DOMAIN_BETA_REGION, labels.get(LABEL_TOPOLOGY_REGION, ""))
    if not zone and not region:
        return ""
    return f"{region}:\x00:{zone}"


# the pod label naming the PodGroup (gang) a pod belongs to
POD_GROUP_LABEL = "scheduling.x-k8s.io/pod-group"

# PodGroup status phases
POD_GROUP_PENDING = "Pending"
POD_GROUP_SCHEDULING = "Scheduling"
POD_GROUP_RUNNING = "Running"


@dataclass
class PodGroup:
    """scheduling.x-k8s.io PodGroup (namespaced): the gang contract for
    all-or-nothing placement. Pods join via the POD_GROUP_LABEL label, and
    the Coscheduling plugin admits a gang only when ``min_member`` of its
    pods exist and places it whole or not at all."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    min_member: int = 1
    # 0 = the Coscheduling plugin's default permit timeout applies
    schedule_timeout_seconds: int = 0
    # status (maintained by the Coscheduling plugin's PostBind and reject)
    phase: str = POD_GROUP_PENDING
    scheduled: int = 0  # members currently bound


# canonical SchedulingQuota dimension names: pod slots, milli-cpu, memory in
# KiB (api/resource.py canonical) and resource.k8s.io claim entries
QUOTA_PODS = "pods"
QUOTA_CPU = "requests.cpu"
QUOTA_MEMORY = "requests.memory"
QUOTA_CLAIMS = "claims"

# the dimension order of every [*, Q] quota row: the ledger's device table
# (framework/plugins/quota.py) and the device screen (ops/quota.py)
QUOTA_DIM_ORDER = (QUOTA_PODS, QUOTA_CPU, QUOTA_MEMORY, QUOTA_CLAIMS)


@dataclass
class SchedulingQuota:
    """scheduling.x-k8s.io SchedulingQuota (namespaced): per-namespace hard
    caps on what the scheduler admits (assumed and bound pods), keyed by the
    QUOTA_* names in canonical ints (an absent key is unlimited), the
    tenant's fair-share ``weight``, and ``cohort``, a lending pool whose
    members may borrow each other's unused guaranteed headroom past their
    own caps ("" = none)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, int] = field(default_factory=dict)
    weight: int = 1
    cohort: str = ""
    used: Dict[str, int] = field(default_factory=dict)  # advisory status


# ---------------------------------------------------------------------------
# storage (core/v1 PersistentVolume(Claim), storage/v1 StorageClass, CSINode)

# volume binding modes (storage/v1 StorageClass.VolumeBindingMode)
BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

# access modes
ROX = "ReadOnlyMany"
RWOP = "ReadWriteOncePod"


@dataclass
class PersistentVolumeClaim:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class: str = ""
    bound_pv: str = ""
    access_modes: Tuple[str, ...] = ()
    requested_bytes: int = 0


@dataclass
class PersistentVolume:
    """storage PV: capacity + node affinity via topology labels (the
    reference keeps zone/region in PV labels; volumezone/volume_zone.go)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    capacity_bytes: int = 0
    storage_class: str = ""
    bound_pvc: str = ""  # claimRef as namespace/name
    access_modes: Tuple[str, ...] = ()
    # in-tree volume source kind (nodevolumelimits/non_csi.go):
    # "ebs" | "gce-pd" | "azure-disk" | "cinder" | ""
    volume_type: str = ""
    # nodeAffinity reduced to required label matches (topology terms)
    node_affinity: Dict[str, Tuple[str, ...]] = field(default_factory=dict)

    def matches_node(self, node: "Node") -> bool:
        for key, allowed in self.node_affinity.items():
            if node.meta.labels.get(key) not in allowed:
                return False
        return True


@dataclass
class StorageClass:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = BINDING_IMMEDIATE


# the default-class marker the DefaultStorageClass admission plugin reads
# (plugin/pkg/admission/storage/storageclass/setdefault)
ANNOTATION_DEFAULT_STORAGE_CLASS = "storageclass.kubernetes.io/is-default-class"


@dataclass
class CSINode:
    """storage/v1 CSINode: per-driver attachable volume limits
    (nodevolumelimits/csi.go reads CSINode.Spec.Drivers[].Allocatable)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: Dict[str, int] = field(default_factory=dict)  # driver name -> max volumes


# ---------------------------------------------------------------------------
# resource.k8s.io (Dynamic Resource Allocation, structured parameters)
#
# Typed attribute selectors instead of opaque driver blobs: a selector map is
# ``attribute key -> expression`` (e.g. {"tpu.dev/cores": ">=4"}; api/dra.py
# parses and evaluates them against NodeStatus.device_attributes). Allocation
# is node-level: a claim allocates to one node, and any number of pods on
# that node may reserve it.


@dataclass
class ResourceClass:
    """resource.k8s.io ResourceClass (cluster-scoped): driver identity plus
    the class-level selectors every claim of this class inherits."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    driver_name: str = ""
    selectors: Dict[str, object] = field(default_factory=dict)


@dataclass
class ResourceClaim:
    """resource.k8s.io ResourceClaim (namespaced): a request for devices
    matching the class + claim selectors, plus the allocation status that
    Reserve writes (``allocated_node``; the consuming pods in
    ``reserved_for``)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    resource_class_name: str = ""
    selectors: Dict[str, object] = field(default_factory=dict)
    # status
    allocated_node: str = ""            # "" = unallocated
    reserved_for: Tuple[str, ...] = ()  # pod keys consuming the claim


# ---------------------------------------------------------------------------
# policy/v1


@dataclass
class PodSchedulingContext:
    """resource.k8s.io PodSchedulingContext (namespaced; name = the pod's
    name): DynamicResources' PostBind persists the selected node here."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selected_node: str = ""
    potential_nodes: Tuple[str, ...] = ()


@dataclass
class Namespace:
    meta: ObjectMeta = field(default_factory=ObjectMeta)


@dataclass
class Service:
    """core/v1 Service, trimmed to the map selector SelectorSpread reads."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class ReplicationController:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class ReplicaSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None


@dataclass
class StatefulSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None


@dataclass
class PriorityClass:
    """scheduling/v1 PriorityClass: the priority that admission gives a pod
    naming it (``apiserver/admission.py``)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0


@dataclass
class PodDisruptionBudget:
    """policy/v1 PodDisruptionBudget, trimmed to what preemption reads
    (``framework/preemption.py``): the selector over pods of its namespace
    and the status's ``disruptionsAllowed``, which the disruption
    controller maintains and the victim selection consumes."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    disruptions_allowed: int = 0


# ---------------------------------------------------------------------------
# the kinds the admission chain reads (``apiserver/admission.py``)


@dataclass
class ResourceQuota:
    """core/v1 ResourceQuota: per-namespace hard caps on the pods' summed
    requests and count, in canonical ints (milli-cpu, KiB; ``api/
    resource.py``). ResourceQuota admission charges ``used`` at create and
    never releases it (the quota controller reconciles in the reference)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, int] = field(default_factory=dict)   # "pods", "requests.cpu", "requests.memory"
    used: Dict[str, int] = field(default_factory=dict)


@dataclass
class LimitRangeItem:
    """core/v1 LimitRangeItem; LimitRanger applies the Container type."""

    type: str = "Container"
    default: Dict[str, object] = field(default_factory=dict)          # limits
    default_request: Dict[str, object] = field(default_factory=dict)  # requests
    max: Dict[str, object] = field(default_factory=dict)
    min: Dict[str, object] = field(default_factory=dict)


@dataclass
class LimitRange:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    limits: Tuple[LimitRangeItem, ...] = ()


@dataclass
class ServiceAccount:
    """core/v1 ServiceAccount: the identity ServiceAccount admission
    defaults onto pods and requires to exist."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    automount_service_account_token: bool = True


@dataclass
class RuntimeClass:
    """node.k8s.io/v1 RuntimeClass (cluster-scoped): RuntimeClass admission
    sets a pod's ``spec.overhead`` from it and merges its scheduling
    constraints into the pod."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    handler: str = ""
    overhead: Dict[str, object] = field(default_factory=dict)  # resource -> quantity
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: Tuple[Toleration, ...] = ()
