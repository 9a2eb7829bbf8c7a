"""The batched claim-feasibility screen for resource.k8s.io claims.

Own copy of ``kubernetes_tpu/backend/claim_mask.py``, whole. Claims allocate at node granularity, so a pod's claim feasibility
is a static per-batch predicate: the merged class and claim selectors
against the node-published attribute table that ``DeviceState`` keeps on
the device. ``build_dra_mask`` encodes each pod's selectors into int32 rows
and runs ``backend/batch.py:claim_feasibility_mask`` once on the batch's
device; the result joins the static phase as ``dra_mask`` (first-fail id
10, DynamicResources).

Host-side: a claim already allocated pins the pod to its node (a
restriction row built from the encoder's slot map), and the commit path's
Reserve allocates exactly, so two pods of one batch that share an
unallocated claim cannot both allocate it to different nodes: the second
fails Reserve and is retried against the allocation.

On the wire (``backend/service.py``) the client resolves each claim pod's
selectors against its store and ships them as rows
(``wire_claims_for_batch``); the device service decodes them
(``wire_claims_to_entries``) and builds the mask against its own
attribute table.

The screen runs under ``telemetry.dispatch("claim_mask", ...)`` with its
(empty) cost probe, as ``:77-83`` of the JAX module.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..api import dra
from . import telemetry
from .batch import claim_feasibility_mask
from .device_state import _bucket


def build_dra_mask(device_state, entries, pad_to: int) -> Optional[torch.Tensor]:
    """``entries`` is [(pod index, [DeviceSelector...], [allocated node
    names])]. Returns the [pad_to, nodes] bool mask on the device state's
    device, or None without entries. Selector encoding registers attribute
    keys and string operands in the table first (the table may grow here),
    so the mask reads the grown table."""
    if not entries:
        return None
    n_cap = device_state.caps.nodes
    restrict: Optional[np.ndarray] = None
    s_cap = _bucket(max((len(sels) for _p, sels, _a in entries), default=1), floor=4)
    sel_key = np.zeros((pad_to, s_cap), np.int32)
    sel_op = np.full((pad_to, s_cap), -1, np.int32)   # -1 = padding
    sel_kind = np.zeros((pad_to, s_cap), np.int32)
    sel_val = np.zeros((pad_to, s_cap), np.int32)
    for p, sels, allocated in entries:
        if p < 0 or p >= pad_to:
            continue
        for s, sel in enumerate(sels):
            sel_key[p, s] = device_state.attr_slot(sel.key)
            sel_op[p, s] = sel.op
            sel_kind[p, s] = sel.operand_kind
            sel_val[p, s] = (sel.operand if sel.operand_kind == dra.KIND_INT
                             else device_state.attr_value_id(sel.operand))
        for node in allocated:
            if restrict is None:
                restrict = np.ones((pad_to, n_cap), bool)
            slot = device_state.encoder.node_slots.get(node)
            row = np.zeros(n_cap, bool)
            if slot is not None:
                row[slot] = True
            restrict[p] &= row
    dev = device_state.device
    bucket = f"{pad_to}x{sel_key.shape[1]}"
    with telemetry.dispatch("claim_mask", bucket=bucket):
        mask = claim_feasibility_mask(
            *(torch.tensor(a, device=dev) for a in (sel_key, sel_op, sel_kind, sel_val)),
            device_state.attr_kind, device_state.attr_val)
    # the screen has no byte count: its cost slot stays empty
    telemetry.cost_probe("claim_mask", bucket, lambda: None)
    if restrict is not None:
        mask = mask & torch.tensor(restrict, device=dev)
    return mask


def claim_rows_for_pod(client, pod) -> Tuple[List[dra.DeviceSelector], List[str]]:
    """(merged selectors, allocated nodes) across a pod's claims.
    Unresolvable claims are skipped: the commit-time checks own them."""
    sels: List[dra.DeviceSelector] = []
    allocated: List[str] = []
    for _name, claim_key in dra.claim_refs_for_pod(pod):
        claim = client.get_object("ResourceClaim", claim_key)
        if claim is None:
            continue
        merged, err = dra.selectors_for_claim(client, claim)
        if err:
            continue
        sels.extend(merged)
        if claim.allocated_node:
            allocated.append(claim.allocated_node)
    return sels, allocated


def wire_claims_for_batch(client, pods) -> List[dict]:
    """The request form of a batch's claims (``:110``): one entry per
    claim pod, selectors flattened to [key, op, kind, operand] rows."""
    out: List[dict] = []
    for i, pod in enumerate(pods):
        if not pod.spec.resource_claims:
            continue
        sels, allocated = claim_rows_for_pod(client, pod)
        out.append({
            "pod": i,
            "selectors": [[s.key, s.op, s.operand_kind, s.operand] for s in sels],
            "allocatedNodes": allocated,
        })
    return out


def wire_claims_to_entries(claims) -> List[tuple]:
    """``build_dra_mask``'s entries from the request form (``:128``; the
    operand's type follows its kind tag)."""
    entries = []
    for c in claims or ():
        sels = []
        for key, op, kind, operand in c.get("selectors") or ():
            kind = int(kind)
            sels.append(dra.DeviceSelector(
                key=str(key), op=int(op), operand_kind=kind,
                operand=int(operand) if kind == dra.KIND_INT else str(operand)))
        entries.append((int(c.get("pod", -1)), sels,
                        [str(n) for n in c.get("allocatedNodes") or ()]))
    return entries


class ClaimMaskBuilder:
    def __init__(self, client):
        self.client = client

    def batchable(self, pod) -> bool:
        """Every referenced ResourceClaim exists and its class resolves."""
        for _name, claim_key in dra.claim_refs_for_pod(pod):
            claim = self.client.get_object("ResourceClaim", claim_key)
            if claim is None:
                return False
            _sels, err = dra.selectors_for_claim(self.client, claim)
            if err:
                return False
        return True

    def build(self, pods, device_state, pad_to: int) -> Optional[torch.Tensor]:
        """[pad_to, nodes] bool on the device, or None when no pod of the
        batch carries claims. Rows of claim-less and padding pods are
        all-True."""
        entries = [(p, *claim_rows_for_pod(self.client, pod))
                   for p, pod in enumerate(pods) if pod.spec.resource_claims]
        return build_dra_mask(device_state, entries, pad_to)
