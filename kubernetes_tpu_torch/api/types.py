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
    allow_volume_expansion: bool = False  # the persistentvolume-expander's gate


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


# ---------------------------------------------------------------------------
# workload objects (core/v1 Service + ReplicationController, apps/v1
# ReplicaSet + StatefulSet + Deployment + DaemonSet, batch/v1 Job + CronJob):
# SelectorSpread's owner lookup and the controller manager's loops
# (``controllers/``)


@dataclass
class ServicePort:
    """core/v1 ServicePort: one exposed port of a Service; ``node_port`` is
    set for NodePort and LoadBalancer services."""

    name: str = ""
    protocol: str = "TCP"
    port: int = 0          # the ClusterIP-facing port
    target_port: int = 0   # backend pod port (int form only)
    node_port: int = 0     # 0 = not a NodePort


@dataclass
class Service:
    """core/v1 Service: the map selector SelectorSpread and the endpoint
    controllers read, and the proxy surface."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)  # spec.selector (map form)
    external_ips: Tuple[str, ...] = ()  # spec.externalIPs
    type: str = "ClusterIP"            # ClusterIP | NodePort | LoadBalancer
    cluster_ip: str = ""               # virtual IP ("" = none allocated)
    headless: bool = False             # wire form clusterIP: "None"
    ports: Tuple[ServicePort, ...] = ()
    session_affinity: str = "None"     # None | ClientIP
    session_affinity_timeout_s: int = 10800  # ClientIPConfig.TimeoutSeconds default


@dataclass
class ReplicationController:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)  # spec.selector (map form)
    replicas: int = 1
    template: Optional["Pod"] = None


@dataclass
class ReplicaSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 1
    template: Optional["Pod"] = None


@dataclass
class StatefulSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 1
    template: Optional["Pod"] = None


@dataclass
class Deployment:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 1
    template: Optional["Pod"] = None
    # rollout strategy (apps/v1 DeploymentStrategy): RollingUpdate keeps the
    # surge and unavailable windows; Recreate tears the old ReplicaSet down first
    strategy: str = "RollingUpdate"
    max_surge: int = 1
    max_unavailable: int = 1


@dataclass
class DaemonSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    template: Optional["Pod"] = None


@dataclass
class Job:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    completions: int = 1
    parallelism: int = 1
    template: Optional["Pod"] = None
    succeeded: int = 0
    # failure policy (job_controller.go syncJob): stop after backoffLimit pod
    # failures; fail the job past activeDeadlineSeconds
    backoff_limit: int = 6
    active_deadline_seconds: Optional[int] = None
    failed: int = 0
    condition: str = ""  # "" | "Complete" | "Failed" (reason in failed_reason)
    failed_reason: str = ""
    start_time: float = 0.0
    completion_time: float = 0.0  # set when the condition turns terminal
    # the ttl-after-finished controller deletes the job this long after it ends
    ttl_seconds_after_finished: Optional[int] = None


@dataclass
class CronJob:
    """batch/v1 CronJob: spawns Jobs on a five-field cron schedule."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    schedule: str = "* * * * *"
    template: Optional["Pod"] = None  # the spawned Job's pod template
    completions: int = 1
    parallelism: int = 1
    suspend: bool = False
    last_schedule_minute: int = -1  # epoch minute of the last firing


@dataclass
class VolumeAttachment:
    """storage/v1 VolumeAttachment: a PV attached to a node, kept by the
    attach/detach controller."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    pv_name: str = ""
    node_name: str = ""
    attached: bool = True


@dataclass(frozen=True)
class EndpointAddress:
    pod_key: str = ""
    node_name: str = ""


@dataclass
class Endpoints:
    """core/v1 Endpoints: the ready pod addresses behind a Service, kept by
    the endpoints controller."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    addresses: Tuple[EndpointAddress, ...] = ()


@dataclass
class EndpointSlice:
    """discovery.k8s.io/v1 EndpointSlice: a shard of a Service's ready
    addresses (at most 100 per slice), kept by the endpointslice
    controller."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    service: str = ""  # owning Service key
    addresses: Tuple[EndpointAddress, ...] = ()


@dataclass
class PriorityClass:
    """scheduling/v1 PriorityClass: the priority that admission gives a pod
    naming it (``apiserver/admission.py``)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0


@dataclass
class PodDisruptionBudget:
    """policy/v1 PodDisruptionBudget: the spec (minAvailable or
    maxUnavailable, an int or "N%") and the status the disruption controller
    (``controllers/disruption.py``) keeps; preemption
    (``framework/preemption.py``) reads the selector over pods of its
    namespace and ``disruptionsAllowed``."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    # spec: None means unset; one of the two is normally set
    min_available: Optional[object] = None    # int or "N%"
    max_unavailable: Optional[object] = None  # int or "N%"
    # status
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


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


# ---------------------------------------------------------------------------
# the API front's kinds (``kubernetes_tpu/api/types.py:516-555``, ``:903-931``,
# ``:981``): CRDs and their objects, aggregated APIServices, Ingress and its
# class (DefaultIngressClass admission), and the binding subresource's body


@dataclass
class CustomResourceDefinition:
    """apiextensions.k8s.io/v1 CustomResourceDefinition, reduced to the
    registration surface: group, names, served version and scope. Custom
    objects carry free-form spec dicts (no schema)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)  # name = plural.group
    group: str = ""
    version: str = "v1"
    kind: str = ""
    plural: str = ""
    namespaced: bool = True


@dataclass
class CustomResource:
    """An object of a CRD-served kind: typed meta, free-form spec and status
    (the unstructured.Unstructured analog)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    api_version: str = ""
    kind: str = ""
    spec: Dict[str, object] = field(default_factory=dict)
    status: Dict[str, object] = field(default_factory=dict)


@dataclass
class APIService:
    """apiregistration.k8s.io/v1 APIService, reduced to the aggregation
    surface: which group/version is served and where to proxy it; no
    endpoint means served by this apiserver."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)  # name = version.group
    group: str = ""
    version: str = "v1"
    service_endpoint: str = ""  # "host:port" or a full URL; "" = local
    insecure_skip_tls_verify: bool = True
    group_priority_minimum: int = 1000
    version_priority: int = 15


@dataclass
class IngressClass:
    """networking.k8s.io/v1 IngressClass; the is-default-class annotation
    marks the cluster default (DefaultIngressClass admission)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    controller: str = ""


ANNOTATION_DEFAULT_INGRESS_CLASS = "ingressclass.kubernetes.io/is-default-class"


@dataclass
class IngressRule:
    host: str = ""
    service_name: str = ""  # the backend service (one backend per rule)
    service_port: int = 0


@dataclass
class Ingress:
    """networking.k8s.io/v1 Ingress, reduced to class selection and
    host-to-service rules."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    ingress_class_name: str = ""
    rules: Tuple[IngressRule, ...] = ()


@dataclass
class Binding:
    """The pods/{name}/binding subresource's body
    (pkg/registry/core/pod/storage/storage.go:146 BindingREST)."""

    pod_key: str = ""
    node_name: str = ""


# ---------------------------------------------------------------------------
# the kinds the client runtime, the resourceclaim controller and the perf
# harness write (``kubernetes_tpu/api/types.py:725``, ``:854``, ``:871``,
# ``:1029``)


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease: the leader-election lock object
    (``client/leaderelection.py``)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0


@dataclass
class Secret:
    """core/v1 Secret: the SchedulingSecrets perf workload's pods mount one."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = "Opaque"
    data: Dict[str, str] = field(default_factory=dict)


# the bootstrap token secret type (the kubeadm join tokens the bootstrapsigner
# and tokencleaner controllers manage)
SECRET_TYPE_BOOTSTRAP_TOKEN = "bootstrap.kubernetes.io/token"


@dataclass
class ConfigMap:
    """core/v1 ConfigMap (the root-ca-cert-publisher's and the
    bootstrapsigner's target)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class Event:
    """core/v1 Event: an involved object's reason and note with series
    counting, persisted by ``utils/events.py:EventRecorder`` when it is
    given a store."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: str = ""  # "ns/name" of the object the event is about
    reason: str = ""
    message: str = ""
    type: str = "Normal"       # Normal | Warning
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    reporting_controller: str = ""


@dataclass
class ResourceClaimTemplate:
    """resource.k8s.io ResourceClaimTemplate (namespaced): the spec the
    resourceclaim controller (``controllers/resourceclaim.py``) stamps out
    as a pod-owned ResourceClaim for every pod.spec.resourceClaims entry
    naming it."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    resource_class_name: str = ""
    selectors: Dict[str, object] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# the kinds of the certificate, security and autoscaling loops
# (``controllers/certificates.py``, ``controllers/autoscaling.py``)


@dataclass
class CertificateSigningRequest:
    """certificates.k8s.io/v1 CSR, reduced to what the csrapproving,
    csrsigning and csrcleaner controllers drive: approve, sign, clean."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    signer_name: str = ""            # e.g. kubernetes.io/kube-apiserver-client-kubelet
    username: str = ""               # requesting identity
    groups: Tuple[str, ...] = ()
    usages: Tuple[str, ...] = ()     # "client auth" | "server auth" | ...
    request: str = ""                # the CSR blob (opaque here)
    # status
    approved: bool = False
    denied: bool = False
    approval_reason: str = ""
    certificate: str = ""            # issued by the signing controller
    issued_at: float = 0.0


@dataclass
class HorizontalPodAutoscaler:
    """autoscaling/v2-shaped HPA, reduced to a cpu-utilization target over a
    scale-target workload. The metrics API is ``Store.pod_metrics`` (pod key
    to milli-cpu usage)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    target_kind: str = "Deployment"   # scaleTargetRef
    target_name: str = ""
    min_replicas: int = 1
    max_replicas: int = 10
    target_cpu_utilization: int = 80  # usage / per-pod cpu request, percent
    # status
    current_replicas: int = 0
    desired_replicas: int = 0
    last_scale_time: float = 0.0


@dataclass
class PolicyRule:
    """rbac/v1 PolicyRule (verbs x resources x resourceNames; '*' wildcards)."""

    verbs: Tuple[str, ...] = ("*",)
    resources: Tuple[str, ...] = ("*",)       # kind names, e.g. "Pod"
    resource_names: Tuple[str, ...] = ()      # () = any
    subresources: Tuple[str, ...] = ("*",)    # e.g. "binding", "finalizers"

    def matches(self, verb: str, kind: str, name: str, subresource: str) -> bool:
        if "*" not in self.verbs and verb not in self.verbs:
            return False
        if "*" not in self.resources and kind not in self.resources:
            return False
        if self.resource_names and name not in self.resource_names \
                and name.rsplit("/", 1)[-1] not in self.resource_names:
            # resourceNames are bare object names; the HTTP gate passes a
            # namespaced object's store key
            return False
        if subresource and "*" not in self.subresources \
                and subresource not in self.subresources:
            return False
        return True


@dataclass
class ClusterRole:
    """rbac/v1 ClusterRole; ``aggregation_selectors`` is the AggregationRule
    reduced to label-match dicts: when set, the clusterrole-aggregation
    controller overwrites ``rules`` with the union of every matching
    ClusterRole's rules."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    rules: Tuple[PolicyRule, ...] = ()
    aggregation_selectors: Tuple[Dict[str, str], ...] = ()


@dataclass
class ClusterRoleBinding:
    """rbac/v1 ClusterRoleBinding: subjects are "user:NAME" or "group:NAME"."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    role: str = ""                    # ClusterRole name
    subjects: Tuple[str, ...] = ()
