"""The NodeResourcesFit plugin's Filter and the default resource scores
as plain functions.

An own copy of the fit check and the default scores of
``kubernetes_tpu/framework/plugins/noderesources.py`` (noderesources/
fit.go, least_allocated.go, balanced_allocation.go): the fit check, the
LeastAllocated score of NodeResourcesFit and BalancedAllocation's score,
over cpu and memory at weight 1 each (the default arguments), in the JAX
plugin's host arithmetic (Python ints and floats). The batched path
computes the same scores on the device (``ops/scores.py``); the
sequential path (``framework/runtime.py:ScoreRunner``) runs these. No
ignored extended resources and no other strategy: plugin arguments the
port has no way to set. Fit's PreFilter extensions (AddPod / RemovePod)
are no-ops there: the node side of the check comes from the NodeInfo, so
a dry run that adds or removes pods needs nothing more.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ...api import resource as resource_api
from ..types import MAX_NODE_SCORE, NodeInfo

# the scored resources and their weights (the plugins' default arguments)
DEFAULT_RESOURCES = ((resource_api.CPU, 1), (resource_api.MEMORY, 1))


def fits_request(request: Dict[str, int], ni: NodeInfo) -> List[str]:
    """fitsRequest (fit.go:252): per resource ``req <= allocatable -
    requested``, and the pod-count check; returns the reason of every
    insufficiency."""
    out: List[str] = []
    if len(ni.pods) + 1 > ni.allocatable.allowed_pod_number:
        out.append("Too many pods")
    core = {k: v for k, v in request.items() if k != resource_api.PODS}
    if all(v == 0 for v in core.values()):
        return out
    for rname, rq in core.items():
        if rq and rq > ni.allocatable.get(rname) - ni.requested.get(rname):
            out.append(f"Insufficient {rname}")
    return out


def fit_filter(request: Dict[str, int], ni: NodeInfo) -> Optional[str]:
    """``request``: the PreFilter's state, ``pod.resource_request()``
    (fit.go:142)."""
    return ", ".join(fits_request(request, ni)) or None


def least_allocated_score(req: Dict[str, int], ni: NodeInfo) -> int:
    """NodeResourcesFit's LeastAllocated score (least_allocated.go:29) of
    a pod whose nonzero request is ``req``: the weighted mean over the
    resources of ``(capacity - requested) * 100 // capacity``."""
    num = den = 0
    for rname, weight in DEFAULT_RESOURCES:
        alloc = ni.allocatable.get(rname)
        requested = ni.non_zero_requested.get(rname) + req.get(rname, 0)
        score = 0
        if alloc != 0 and requested <= alloc:
            score = (alloc - requested) * MAX_NODE_SCORE // alloc
        num += weight * score
        den += weight
    return num // den if den else 0


def balanced_allocation_score(req: Dict[str, int], ni: NodeInfo) -> int:
    """BalancedAllocation (balanced_allocation.go): ``(1 - std) * 100`` of
    the resources' utilization fractions with the pod added."""
    fractions: List[float] = []
    for rname, _w in DEFAULT_RESOURCES:
        alloc = ni.allocatable.get(rname)
        if alloc == 0:
            fractions.append(1.0)
            continue
        requested = ni.non_zero_requested.get(rname) + req.get(rname, 0)
        fractions.append(min(1.0, requested / alloc))
    if len(fractions) == 2:
        std = abs(fractions[0] - fractions[1]) / 2.0
    else:
        mean = sum(fractions) / len(fractions)
        std = math.sqrt(sum((f - mean) ** 2 for f in fractions) / len(fractions))
    return int((1 - std) * MAX_NODE_SCORE)
