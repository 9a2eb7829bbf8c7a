"""The DynamicResources plugin: plain functions and the plugin object.

An own copy of ``kubernetes_tpu/framework/plugins/dynamicresources.py``
over (store, pod, node name): the PreFilter claim resolution, the exact Filter,
Reserve / Unreserve (``:143-174``; each claim allocated to the chosen node
and reserved for the pod through the store, a refused one rolling back
what the pod took) and PostBind (``:176``; the pod's PodSchedulingContext
records the selected node). The batched path screens claims with the
device mask (``backend/claim_mask.py``); at commit it resolves the pod's
claims again (``pre_filter``), which also finds a claim deleted since the
batch's encode, and Reserve allocates them.

Allocation is node-level: claims carry no per-device inventory, so claim
contention inside a batch reduces to the allocated-node restriction, which
Reserve enforces exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ...api import dra
from ...api.types import Node, ObjectMeta, OwnerReference, Pod, PodSchedulingContext, ResourceClaim
from ...apiserver.store import Conflict, NotFound
from ..interface import Fail
from ..types import ADD, ALL, NODE, RESOURCE_CLAIM, RESOURCE_CLASS, UPDATE, ClusterEvent, NodeInfo
from . import names

ERR_REASON_MISSING_CLAIM = "waiting for resource claim to be created"
ERR_REASON_CANNOT_ALLOCATE = "cannot allocate all claims"
ERR_REASON_PREFILTER_RESTRICTION = "node(s) didn't satisfy plugin(s) prefilter restriction"

# a pod's resolved claims: [(claim key, claim, merged selectors)]
Claims = List[Tuple[str, ResourceClaim, List[dra.DeviceSelector]]]


def pre_filter(client, pod: Pod) -> Tuple[Claims, Optional[str]]:
    """(claims, None), or ([], reason) when a claim or its class does not
    resolve (UnschedulableAndUnresolvable in the plugin)."""
    claims: Claims = []
    for entry_name, claim_key in dra.claim_refs_for_pod(pod):
        claim = client.get_object("ResourceClaim", claim_key)
        if claim is None:
            return [], f'{ERR_REASON_MISSING_CLAIM} "{entry_name}"'
        selectors, err = dra.selectors_for_claim(client, claim)
        if err:
            return [], err
        claims.append((claim_key, claim, selectors))
    return claims, None


def filter_node(claims: Claims, node: Optional[Node]) -> Optional[str]:
    """None when ``node`` can take every claim: each claim unallocated or
    allocated to it, and every selector matching its attributes."""
    if node is None:
        return ERR_REASON_CANNOT_ALLOCATE
    attrs = node.status.device_attributes
    for _key, claim, selectors in claims:
        if claim.allocated_node and claim.allocated_node != node.meta.name:
            return ERR_REASON_CANNOT_ALLOCATE
        for sel in selectors:
            if not sel.matches(attrs):
                return ERR_REASON_CANNOT_ALLOCATE
    return None


def reserve(client, pod: Pod, node_name: str, claims: Claims) -> Optional[Exception]:
    """Allocate every claim to ``node_name`` for the pod. On a Conflict (a
    claim allocated to another node) or NotFound (a claim gone), release
    what this pod took and return the exception; None on success."""
    pod_key = pod.key()
    taken: List[str] = []
    for claim_key, _claim, _sels in claims:
        try:
            client.allocate_claim(claim_key, node_name, pod_key)
        except (Conflict, NotFound) as exc:
            unreserve(client, pod, taken)
            return exc
        taken.append(claim_key)
    return None


def unreserve(client, pod: Pod, claim_keys: List[str]) -> None:
    pod_key = pod.key()
    for claim_key in claim_keys:
        client.release_claim(claim_key, pod_key)


def post_bind(client, pod: Pod, node_name: str) -> None:
    """The pod's PodSchedulingContext (owned by the pod) records
    ``node_name``: created, or updated when it names another node."""
    if not pod.spec.resource_claims:
        return
    existing = client.get_object("PodSchedulingContext", pod.key())
    try:
        if existing is None:
            client.create_object("PodSchedulingContext", PodSchedulingContext(
                meta=ObjectMeta(name=pod.meta.name, namespace=pod.meta.namespace,
                                owner_references=(OwnerReference(
                                    kind="Pod", name=pod.meta.name, controller=True),)),
                selected_node=node_name))
        elif existing.selected_node != node_name:
            client.update_object("PodSchedulingContext",
                                 dataclasses.replace(existing, selected_node=node_name))
    except Conflict:
        pass  # another writer; the status is current


class DynamicResources:
    """The plugin object over the functions above; a claim's allocated
    node restricts the pod's nodes at PreFilter. A pod without PreFilter
    state (a plain pod of a batch) reserves nothing."""

    def __init__(self, client=None):
        self.client = client

    def name(self) -> str:
        return names.DYNAMIC_RESOURCES

    @staticmethod
    def events_to_register():
        return [ClusterEvent(RESOURCE_CLAIM, ALL, "ResourceClaimChange"),
                ClusterEvent(RESOURCE_CLASS, ADD | UPDATE, "ResourceClassChange"),
                ClusterEvent(NODE, ADD | UPDATE)]

    def pre_filter(self, state, pod: Pod):
        if not pod.spec.resource_claims:
            return None, None
        claims, reason = pre_filter(self.client, pod)
        if reason is not None:
            return None, Fail(names.DYNAMIC_RESOURCES, reason, True)
        state.claims = claims
        node_names = None
        for _key, claim, _sels in claims:
            if claim.allocated_node:
                node_names = ({claim.allocated_node} if node_names is None
                              else node_names & {claim.allocated_node})
        return node_names, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        if not state.claims:
            return None
        reason = filter_node(state.claims, ni.node)
        return None if reason is None else Fail(names.DYNAMIC_RESOURCES, reason, False)

    def reserve(self, state, pod: Pod, node_name: str) -> Optional[str]:
        """Allocate the pod's claims; a refusal releases what it took."""
        if state is None or not state.claims:
            return None
        if reserve(self.client, pod, node_name, state.claims) is not None:
            return ERR_REASON_CANNOT_ALLOCATE
        state.allocated = [key for key, _claim, _sels in state.claims]
        return None

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        if state is not None and state.allocated:
            unreserve(self.client, pod, state.allocated)
            state.allocated = []

    def post_bind(self, state, pod: Pod, node_name: str) -> None:
        post_bind(self.client, pod, node_name)

    def post_bind_batch(self, pods: List[Pod]) -> None:
        for pod in pods:
            post_bind(self.client, pod, pod.spec.node_name)
