"""NodeResourcesFit and BalancedAllocation: the fit check and the
resource scores as plain functions, and the plugin objects.

An own copy of ``kubernetes_tpu/framework/plugins/noderesources.py``
(noderesources/fit.go, least_allocated.go, most_allocated.go,
requested_to_capacity_ratio.go, balanced_allocation.go) in the JAX
plugin's host arithmetic (Python ints and floats). Fit's arguments: the
scoring ``strategy`` (LeastAllocated, MostAllocated or
RequestedToCapacityRatio), the scored ``resources`` with their weights
and the ratio's ``shape``; BalancedAllocation's: its ``resources``. The
batched path computes the default arguments' scores on the device
(``ops/scores.py``): a profile with any other argument takes the
sequential path (``TPUScheduler._framework_batchable``). No ignored
extended resources. Fit's PreFilter extensions (AddPod / RemovePod) are
no-ops in the JAX plugin: the node side of the check comes from the
NodeInfo, so a dry run that adds or removes pods needs nothing more.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ...api import resource as resource_api
from ...api.types import Pod
from ..interface import Fail
from ..types import (ADD, DELETE, MAX_NODE_SCORE, NODE, POD, UPDATE_NODE_ALLOCATABLE,
                     ClusterEvent, NodeInfo, nonzero_request)
from . import names

# the scoring strategies (types_pluginargs.go ScoringStrategyType)
LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"

# the scored resources and their weights (the plugins' default arguments)
DEFAULT_RESOURCES = ((resource_api.CPU, 1), (resource_api.MEMORY, 1))
# RequestedToCapacityRatio's default shape: (utilization %, score 0-10)
DEFAULT_SHAPE = ((0, 0), (100, 10))


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


def least_allocated_score(req: Dict[str, int], ni: NodeInfo,
                          resources=DEFAULT_RESOURCES) -> int:
    """NodeResourcesFit's LeastAllocated score (least_allocated.go:29) of
    a pod whose nonzero request is ``req``: the weighted mean over the
    resources of ``(capacity - requested) * 100 // capacity``."""
    num = den = 0
    for rname, weight in resources:
        alloc = ni.allocatable.get(rname)
        requested = ni.non_zero_requested.get(rname) + req.get(rname, 0)
        score = 0
        if alloc != 0 and requested <= alloc:
            score = (alloc - requested) * MAX_NODE_SCORE // alloc
        num += weight * score
        den += weight
    return num // den if den else 0


def most_allocated_score(req: Dict[str, int], ni: NodeInfo, resources=DEFAULT_RESOURCES) -> int:
    """MostAllocated (most_allocated.go:29): the weighted mean of
    ``requested * 100 // capacity``."""
    num = den = 0
    for rname, weight in resources:
        alloc = ni.allocatable.get(rname)
        requested = ni.non_zero_requested.get(rname) + req.get(rname, 0)
        score = 0
        if alloc != 0 and requested <= alloc:
            score = requested * MAX_NODE_SCORE // alloc
        num += weight * score
        den += weight
    return num // den if den else 0


def piecewise_linear(x: int, shape) -> int:
    """helper.BuildBrokenLinearFunction over the shape's points."""
    if x <= shape[0][0]:
        return shape[0][1]
    for (x0, y0), (x1, y1) in zip(shape, shape[1:]):
        if x <= x1:
            return y0 + (y1 - y0) * (x - x0) // (x1 - x0)
    return shape[-1][1]


def requested_to_capacity_ratio_score(req: Dict[str, int], ni: NodeInfo,
                                      resources=DEFAULT_RESOURCES, shape=DEFAULT_SHAPE) -> int:
    """RequestedToCapacityRatio (requested_to_capacity_ratio.go:41-66): the
    shape's scores scaled by 10 before the interpolation, an over- or
    zero-capacity resource at 100% utilization, a resource's weight counted
    only when it scores above 0, the mean rounded."""
    scaled = tuple((x, y * (MAX_NODE_SCORE // 10)) for x, y in shape)
    num = den = 0
    for rname, weight in resources:
        alloc = ni.allocatable.get(rname)
        requested = ni.non_zero_requested.get(rname) + req.get(rname, 0)
        util = 100 if (alloc == 0 or requested > alloc) else requested * 100 // alloc
        rscore = piecewise_linear(util, scaled)
        if rscore > 0:
            num += weight * rscore
            den += weight
    return round(num / den) if den else 0


def balanced_allocation_score(req: Dict[str, int], ni: NodeInfo,
                              resources=DEFAULT_RESOURCES) -> int:
    """BalancedAllocation (balanced_allocation.go): ``(1 - std) * 100`` of
    the resources' utilization fractions with the pod added."""
    fractions: List[float] = []
    for rname, _w in resources:
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


def _nonzero(state, pod: Pod) -> Dict[str, int]:
    """The pod's nonzero request, computed once per cycle."""
    req = state.data.get("nonzero_request")
    if req is None:
        req = state.data["nonzero_request"] = nonzero_request(pod.resource_request())
    return req


_EVENTS = (ClusterEvent(POD, DELETE), ClusterEvent(NODE, ADD | UPDATE_NODE_ALLOCATABLE))


class Fit:
    def __init__(self, strategy: str = LEAST_ALLOCATED,
                 resources: Tuple[Tuple[str, int], ...] = DEFAULT_RESOURCES,
                 shape: Tuple[Tuple[int, int], ...] = ()):
        self.strategy = strategy
        self.resources = resources
        self.shape = shape or DEFAULT_SHAPE

    def name(self) -> str:
        return names.NODE_RESOURCES_FIT

    @staticmethod
    def events_to_register():
        return list(_EVENTS)

    def pre_filter(self, state, pod: Pod):
        state.request = pod.resource_request()
        return None, None

    def filter(self, state, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        reason = fit_filter(state.request, ni)
        return None if reason is None else Fail(names.NODE_RESOURCES_FIT, reason, False)

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        req = _nonzero(state, pod)
        if self.strategy == REQUESTED_TO_CAPACITY_RATIO:
            return requested_to_capacity_ratio_score(req, ni, self.resources, self.shape)
        if self.strategy == LEAST_ALLOCATED:
            return least_allocated_score(req, ni, self.resources)
        return most_allocated_score(req, ni, self.resources)


class BalancedAllocation:
    def __init__(self, resources: Tuple[Tuple[str, int], ...] = DEFAULT_RESOURCES):
        self.resources = resources

    def name(self) -> str:
        return names.NODE_RESOURCES_BALANCED_ALLOCATION

    @staticmethod
    def events_to_register():
        return list(_EVENTS)

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        return balanced_allocation_score(_nonzero(state, pod), ni, self.resources)
