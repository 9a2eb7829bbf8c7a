"""Framework data types: Resource, NodeInfo, and the queue's types
(QueuedPodInfo, ClusterEvent, Diagnosis).

Analog of pkg/scheduler/framework/types.go — the de-facto snapshot row schema
the tensor encoder (ops/encode.py) flattens onto the device. Own copy of the
subset of ``kubernetes_tpu/framework/types.py`` the batched path and the
scheduler loop read.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Set, Tuple

from ..api import resource as resource_api
from ..api.types import ContainerPort, Node, Pod

# ---------------------------------------------------------------------------
# Resource (framework/types.go:414 Resource)


class Resource:
    """Canonical-int resource vector: milli_cpu, memory(KiB), ephemeral(MiB),
    allowed_pod_number, plus scalar resources by name."""

    __slots__ = ("milli_cpu", "memory", "ephemeral_storage", "allowed_pod_number", "scalars")

    def __init__(self):
        self.milli_cpu = 0
        self.memory = 0
        self.ephemeral_storage = 0
        self.allowed_pod_number = 0
        self.scalars: Dict[str, int] = {}

    @classmethod
    def from_map(cls, m: Dict[str, int]) -> "Resource":
        r = cls()
        for name, v in m.items():
            r.set(name, v)
        return r

    def set(self, name: str, v: int) -> None:
        if name == resource_api.CPU:
            self.milli_cpu = v
        elif name == resource_api.MEMORY:
            self.memory = v
        elif name == resource_api.EPHEMERAL_STORAGE:
            self.ephemeral_storage = v
        elif name == resource_api.PODS:
            self.allowed_pod_number = v
        else:
            self.scalars[name] = v

    def get(self, name: str) -> int:
        if name == resource_api.CPU:
            return self.milli_cpu
        if name == resource_api.MEMORY:
            return self.memory
        if name == resource_api.EPHEMERAL_STORAGE:
            return self.ephemeral_storage
        if name == resource_api.PODS:
            return self.allowed_pod_number
        return self.scalars.get(name, 0)

    def add(self, m: Dict[str, int], sign: int = 1) -> None:
        for name, v in m.items():
            self.set(name, self.get(name) + sign * v)

    def clone(self) -> "Resource":
        r = Resource()
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.ephemeral_storage = self.ephemeral_storage
        r.allowed_pod_number = self.allowed_pod_number
        r.scalars = dict(self.scalars)
        return r

    def as_map(self) -> Dict[str, int]:
        m = {
            resource_api.CPU: self.milli_cpu,
            resource_api.MEMORY: self.memory,
            resource_api.EPHEMERAL_STORAGE: self.ephemeral_storage,
            resource_api.PODS: self.allowed_pod_number,
        }
        m.update(self.scalars)
        return m


def nonzero_request(req: Dict[str, int]) -> Dict[str, int]:
    """GetNonzeroRequests (pkg/scheduler/util): scoring-path request with
    nominal defaults for cpu/memory when unset."""
    out = dict(req)
    if out.get(resource_api.CPU, 0) == 0:
        out[resource_api.CPU] = resource_api.DEFAULT_MILLI_CPU_REQUEST
    if out.get(resource_api.MEMORY, 0) == 0:
        out[resource_api.MEMORY] = resource_api.DEFAULT_MEMORY_REQUEST_KIB
    return out


def ports_conflict(used: Set[Tuple[str, str, int]], wanted: Tuple[ContainerPort, ...]) -> bool:
    """HostPortInfo conflict semantics (framework/types.go HostPortInfo):
    0.0.0.0 conflicts with every IP on the same (proto, port)."""
    for w in wanted:
        wip = w.host_ip or "0.0.0.0"
        for (ip, proto, port) in used:
            if proto == w.protocol and port == w.host_port:
                if wip == "0.0.0.0" or ip == "0.0.0.0" or ip == wip:
                    return True
    return False


# ---------------------------------------------------------------------------
# NodeInfo (framework/types.go:363)

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


class NodeInfo:
    """Aggregated per-node scheduling state; monotonic ``generation`` drives
    both the host incremental snapshot (cache.go:198 UpdateSnapshot) and the
    device delta uploads."""

    def __init__(self, node: Optional[Node] = None):
        self.node: Optional[Node] = node
        self.pods: List[Pod] = []
        self.pods_with_affinity: List[Pod] = []
        self.pods_with_required_anti_affinity: List[Pod] = []
        self.used_ports: Set[Tuple[str, str, int]] = set()  # (hostIP, proto, port)
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        # priority-bucketed request sums (incl. a synthetic "pods" count per
        # bucket): incremental source for the device class_req rows (batched
        # preemption screen) so encode never rescans ni.pods
        self.prio_requested: Dict[int, Dict[str, int]] = {}
        self.pvc_ref_counts: Dict[str, int] = {}
        self.image_states: Dict[str, int] = {}  # image name -> size bytes
        self.generation = next_generation()
        if node is not None:
            self.allocatable = Resource.from_map(node.allocatable_canonical())
            for img in node.status.images:
                for name in img.names:
                    self.image_states[name] = img.size_bytes

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = Resource.from_map(node.allocatable_canonical())
        self.image_states = {}
        for img in node.status.images:
            for name in img.names:
                self.image_states[name] = img.size_bytes
        self.generation = next_generation()

    @staticmethod
    def _has_affinity(pod: Pod) -> bool:
        a = pod.spec.affinity
        return a is not None and (a.pod_affinity is not None or a.pod_anti_affinity is not None)

    @staticmethod
    def _has_required_anti_affinity(pod: Pod) -> bool:
        a = pod.spec.affinity
        return a is not None and a.pod_anti_affinity is not None and bool(a.pod_anti_affinity.required)

    def add_pod(self, pod: Pod) -> None:
        self.pods.append(pod)
        if self._has_affinity(pod):
            self.pods_with_affinity.append(pod)
        if self._has_required_anti_affinity(pod):
            self.pods_with_required_anti_affinity.append(pod)
        req = pod.resource_request()
        self.requested.add(req)
        self.requested.allowed_pod_number = 0  # pods tracked via len(self.pods)
        self.non_zero_requested.add(nonzero_request(req))
        self.non_zero_requested.allowed_pod_number = 0
        bucket = self.prio_requested.setdefault(pod.spec.priority, {})
        for r, v in req.items():
            if r != resource_api.PODS:  # pods tracked as the +1 below
                bucket[r] = bucket.get(r, 0) + v
        bucket[resource_api.PODS] = bucket.get(resource_api.PODS, 0) + 1
        for p in pod.host_ports():
            self.used_ports.add((p.host_ip or "0.0.0.0", p.protocol, p.host_port))
        for claim in pod.spec.volumes:
            key = f"{pod.meta.namespace}/{claim}"
            self.pvc_ref_counts[key] = self.pvc_ref_counts.get(key, 0) + 1
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        for i, p in enumerate(self.pods):
            if p.key() == pod.key():
                self.pods.pop(i)
                break
        else:
            return False
        self.pods_with_affinity = [p for p in self.pods_with_affinity if p.key() != pod.key()]
        self.pods_with_required_anti_affinity = [
            p for p in self.pods_with_required_anti_affinity if p.key() != pod.key()
        ]
        req = pod.resource_request()
        self.requested.add(req, sign=-1)
        self.non_zero_requested.add(nonzero_request(req), sign=-1)
        bucket = self.prio_requested.get(pod.spec.priority)
        if bucket is not None:
            for r, v in req.items():
                if r != resource_api.PODS:
                    bucket[r] = bucket.get(r, 0) - v
            bucket[resource_api.PODS] = bucket.get(resource_api.PODS, 0) - 1
            if bucket[resource_api.PODS] <= 0:
                del self.prio_requested[pod.spec.priority]
        for p in pod.host_ports():
            self.used_ports.discard((p.host_ip or "0.0.0.0", p.protocol, p.host_port))
        for claim in pod.spec.volumes:
            key = f"{pod.meta.namespace}/{claim}"
            n = self.pvc_ref_counts.get(key, 0) - 1
            if n <= 0:
                self.pvc_ref_counts.pop(key, None)
            else:
                self.pvc_ref_counts[key] = n
        self.generation = next_generation()
        return True

    def clone(self) -> "NodeInfo":
        ni = NodeInfo()
        ni.node = self.node
        ni.pods = list(self.pods)
        ni.pods_with_affinity = list(self.pods_with_affinity)
        ni.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        ni.used_ports = set(self.used_ports)
        ni.requested = self.requested.clone()
        ni.non_zero_requested = self.non_zero_requested.clone()
        ni.allocatable = self.allocatable.clone()
        ni.prio_requested = {p: dict(b) for p, b in self.prio_requested.items()}
        ni.pvc_ref_counts = dict(self.pvc_ref_counts)
        ni.image_states = dict(self.image_states)
        ni.generation = self.generation
        return ni


# ---------------------------------------------------------------------------
# the scheduling queue's types (framework/types.go:42-85, :215; queue item)


@dataclasses.dataclass
class QueuedPodInfo:
    """A pod in the scheduling queue: ``timestamp`` is when it last entered
    a sub-queue (the PrioritySort tie-break and the backoff base),
    ``attempts`` counts its pops, ``unschedulable_plugins`` the plugins it
    failed (which cluster events wake it)."""

    pod: Pod
    timestamp: float = 0.0
    attempts: int = 0
    unschedulable_plugins: Set[str] = dataclasses.field(default_factory=set)


# ActionType bitmask
ADD = 1
DELETE = 1 << 1
UPDATE_NODE_ALLOCATABLE = 1 << 2
UPDATE_NODE_LABEL = 1 << 3
UPDATE_NODE_TAINT = 1 << 4
UPDATE_NODE_CONDITION = 1 << 5
UPDATE = UPDATE_NODE_ALLOCATABLE | UPDATE_NODE_LABEL | UPDATE_NODE_TAINT | UPDATE_NODE_CONDITION
ALL = ADD | DELETE | UPDATE

# resource kinds of cluster events
POD = "Pod"
NODE = "Node"
PVC = "PersistentVolumeClaim"
PV = "PersistentVolume"
STORAGE_CLASS = "StorageClass"
CSI_NODE = "CSINode"
RESOURCE_CLAIM = "ResourceClaim"
RESOURCE_CLASS = "ResourceClass"
POD_GROUP = "PodGroup"
SCHEDULING_QUOTA = "SchedulingQuota"
WILDCARD = "*"


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    resource: str
    action_type: int
    label: str = ""

    def is_wildcard(self) -> bool:
        return self.resource == WILDCARD and self.action_type == ALL

    def match(self, other: "ClusterEvent") -> bool:
        """Does a registered interest ``self`` cover a fired event ``other``."""
        if self.is_wildcard():
            return True
        return self.resource == other.resource and (self.action_type & other.action_type) != 0


WILDCARD_EVENT = ClusterEvent(WILDCARD, ALL, "UnschedulableTimeout")


@dataclasses.dataclass
class Diagnosis:
    """Why a pod found no node: node name -> the first failing filter's
    reason, and the plugins that failed (they gate the pod's requeue)."""

    node_to_status: Dict[str, str] = dataclasses.field(default_factory=dict)
    unschedulable_plugins: Set[str] = dataclasses.field(default_factory=set)
