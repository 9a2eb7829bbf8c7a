"""Fluent object builders for tests and workload generators.

Analog of pkg/scheduler/testing/wrappers.go:190 (PodWrapper) and :633
(NodeWrapper) — the reference's unit/integration/perf tests all construct
objects through these, and ours do too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from .types import (
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeSelector,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PreferredSchedulingTerm,
    Requirement,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
    DO_NOT_SCHEDULE,
)


class PodWrapper:
    def __init__(self, name: str = "pod", namespace: str = "default"):
        self.pod = Pod(meta=ObjectMeta(name=name, namespace=namespace, uid=f"{namespace}/{name}"))
        self.pod.spec.containers.append(Container(name="c0", image="registry/pause:3.7"))

    def obj(self) -> Pod:
        return self.pod

    def uid(self, uid: str) -> "PodWrapper":
        self.pod.meta.uid = uid
        return self

    def label(self, k: str, v: str) -> "PodWrapper":
        self.pod.meta.labels[k] = v
        return self

    def labels(self, labels: Dict[str, str]) -> "PodWrapper":
        self.pod.meta.labels.update(labels)
        return self

    def req(self, requests: Dict[str, object]) -> "PodWrapper":
        """Set resource requests on the main container (PodWrapper.Req)."""
        self.pod.spec.containers[0].requests = dict(requests)
        return self

    def init_req(self, requests: Dict[str, object]) -> "PodWrapper":
        self.pod.spec.init_containers.append(Container(name=f"init{len(self.pod.spec.init_containers)}", requests=dict(requests)))
        return self

    def overhead(self, overhead: Dict[str, object]) -> "PodWrapper":
        self.pod.spec.overhead = dict(overhead)
        return self

    def container(self, image: str, requests: Optional[Dict[str, object]] = None) -> "PodWrapper":
        self.pod.spec.containers.append(
            Container(name=f"c{len(self.pod.spec.containers)}", image=image, requests=dict(requests or {}))
        )
        return self

    def node(self, name: str) -> "PodWrapper":
        self.pod.spec.node_name = name
        return self

    def pvc(self, claim_name: str) -> "PodWrapper":
        """Add a PVC-backed volume (testing/wrappers.go PVC)."""
        self.pod.spec.volumes = self.pod.spec.volumes + (claim_name,)
        return self

    def resource_claim(self, name: str, claim_name: str = "",
                       template_name: str = "") -> "PodWrapper":
        """Add a pod.spec.resourceClaims entry (resource.k8s.io DRA):
        either a direct claim reference or a template reference the
        resourceclaim controller materializes as ``<pod>-<name>``."""
        from .types import PodResourceClaim

        self.pod.spec.resource_claims = self.pod.spec.resource_claims + (
            PodResourceClaim(name=name, claim_name=claim_name,
                             template_name=template_name),
        )
        return self

    def pod_group(self, name: str) -> "PodWrapper":
        """Join a gang: set the scheduling.x-k8s.io pod-group label the
        Coscheduling plugin keys on (the PodGroup object itself is created
        separately in the pod's namespace)."""
        from .types import POD_GROUP_LABEL

        self.pod.meta.labels[POD_GROUP_LABEL] = name
        return self

    def owner(self, kind: str, name: str) -> "PodWrapper":
        """Set the controller ownerReference (metav1.GetControllerOf)."""
        from .types import OwnerReference

        self.pod.meta.owner_references = self.pod.meta.owner_references + (
            OwnerReference(kind=kind, name=name, controller=True),
        )
        return self

    def priority(self, p: int) -> "PodWrapper":
        self.pod.spec.priority = p
        return self

    def scheduler_name(self, name: str) -> "PodWrapper":
        self.pod.spec.scheduler_name = name
        return self

    def node_selector(self, sel: Dict[str, str]) -> "PodWrapper":
        self.pod.spec.node_selector = dict(sel)
        return self

    def toleration(self, key: str = "", operator: str = "Equal", value: str = "", effect: str = "") -> "PodWrapper":
        self.pod.spec.tolerations = self.pod.spec.tolerations + (
            Toleration(key=key, operator=operator, value=value, effect=effect),
        )
        return self

    def host_port(self, port: int, protocol: str = "TCP", host_ip: str = "") -> "PodWrapper":
        c = self.pod.spec.containers[0]
        c.ports = c.ports + (ContainerPort(host_port=port, container_port=port, protocol=protocol, host_ip=host_ip),)
        return self

    def node_affinity_in(self, key: str, values: Sequence[str]) -> "PodWrapper":
        """Required node affinity: key In values (PodWrapper.NodeAffinityIn)."""
        term = NodeSelectorTerm(match_expressions=(Requirement(key, "In", tuple(values)),))
        return self._add_required_node_term(term)

    def node_affinity_not_in(self, key: str, values: Sequence[str]) -> "PodWrapper":
        term = NodeSelectorTerm(match_expressions=(Requirement(key, "NotIn", tuple(values)),))
        return self._add_required_node_term(term)

    def _add_required_node_term(self, term: NodeSelectorTerm) -> "PodWrapper":
        aff = self.pod.spec.affinity or Affinity()
        na = aff.node_affinity or NodeAffinity()
        req = na.required or NodeSelector()
        na.required = NodeSelector(terms=req.terms + (term,))
        aff.node_affinity = na
        self.pod.spec.affinity = aff
        return self

    def preferred_node_affinity(self, weight: int, key: str, values: Sequence[str]) -> "PodWrapper":
        aff = self.pod.spec.affinity or Affinity()
        na = aff.node_affinity or NodeAffinity()
        na.preferred = na.preferred + (
            PreferredSchedulingTerm(
                weight=weight,
                preference=NodeSelectorTerm(match_expressions=(Requirement(key, "In", tuple(values)),)),
            ),
        )
        aff.node_affinity = na
        self.pod.spec.affinity = aff
        return self

    def pod_affinity(self, topology_key: str, selector: LabelSelector, anti: bool = False) -> "PodWrapper":
        """Required pod (anti-)affinity term (PodWrapper.PodAffinity/PodAntiAffinity)."""
        aff = self.pod.spec.affinity or Affinity()
        term = PodAffinityTerm(label_selector=selector, topology_key=topology_key)
        if anti:
            pa = aff.pod_anti_affinity or PodAntiAffinity()
            pa.required = pa.required + (term,)
            aff.pod_anti_affinity = pa
        else:
            pa = aff.pod_affinity or PodAffinity()
            pa.required = pa.required + (term,)
            aff.pod_affinity = pa
        self.pod.spec.affinity = aff
        return self

    def preferred_pod_affinity(self, weight: int, topology_key: str, selector: LabelSelector, anti: bool = False) -> "PodWrapper":
        aff = self.pod.spec.affinity or Affinity()
        wterm = WeightedPodAffinityTerm(weight=weight, term=PodAffinityTerm(label_selector=selector, topology_key=topology_key))
        if anti:
            pa = aff.pod_anti_affinity or PodAntiAffinity()
            pa.preferred = pa.preferred + (wterm,)
            aff.pod_anti_affinity = pa
        else:
            pa = aff.pod_affinity or PodAffinity()
            pa.preferred = pa.preferred + (wterm,)
            aff.pod_affinity = pa
        self.pod.spec.affinity = aff
        return self

    def spread_constraint(
        self,
        max_skew: int,
        topology_key: str,
        when_unsatisfiable: str = DO_NOT_SCHEDULE,
        selector: Optional[LabelSelector] = None,
        min_domains: Optional[int] = None,
    ) -> "PodWrapper":
        self.pod.spec.topology_spread_constraints = self.pod.spec.topology_spread_constraints + (
            TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=selector,
                min_domains=min_domains,
            ),
        )
        return self


class NodeWrapper:
    def __init__(self, name: str = "node"):
        self.node_ = Node(meta=ObjectMeta(name=name, namespace="", uid=f"node/{name}"))
        self.label("kubernetes.io/hostname", name)

    def obj(self) -> Node:
        return self.node_

    def label(self, k: str, v: str) -> "NodeWrapper":
        self.node_.meta.labels[k] = v
        return self

    def capacity(self, resources: Dict[str, object]) -> "NodeWrapper":
        """Sets capacity AND allocatable (NodeWrapper.Capacity semantics)."""
        self.node_.status.capacity = dict(resources)
        self.node_.status.allocatable = dict(resources)
        return self

    def allocatable(self, resources: Dict[str, object]) -> "NodeWrapper":
        self.node_.status.allocatable = dict(resources)
        return self

    def taint(self, key: str, value: str = "", effect: str = "NoSchedule") -> "NodeWrapper":
        self.node_.spec.taints = self.node_.spec.taints + (Taint(key=key, value=value, effect=effect),)
        return self

    def unschedulable(self, v: bool = True) -> "NodeWrapper":
        self.node_.spec.unschedulable = v
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        self.node_.status.images = self.node_.status.images + (
            ContainerImage(names=(name,), size_bytes=size_bytes),
        )
        return self

    def device_attrs(self, attrs: Dict[str, object]) -> "NodeWrapper":
        """Publish a device slice (NodeStatus.device_attributes): the
        attribute map resource.k8s.io selectors match against."""
        self.node_.status.device_attributes.update(attrs)
        return self


def make_pod(name: str = "pod", namespace: str = "default") -> PodWrapper:
    return PodWrapper(name, namespace)


def make_node(name: str = "node") -> NodeWrapper:
    return NodeWrapper(name)
