"""The DynamicResources plugin as plain functions.

An own copy of ``kubernetes_tpu/framework/plugins/dynamicresources.py``
over (store, pod, node name), without the plugin runtime (cycle state,
status codes, registry): the PreFilter claim resolution, the exact Filter,
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

ERR_REASON_MISSING_CLAIM = "waiting for resource claim to be created"
ERR_REASON_CANNOT_ALLOCATE = "cannot allocate all claims"

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
