"""The NodeResourcesFit plugin's Filter as plain functions.

An own copy of the fit check of
``kubernetes_tpu/framework/plugins/noderesources.py`` (noderesources/
fit.go), without the scoring strategies, which the batched path computes
on the device (``ops/scores.py``), and without the ignored extended
resources, a plugin argument the port has no way to set. Fit's PreFilter
extensions (AddPod / RemovePod) are no-ops there: the node side of the
check comes from the NodeInfo, so a dry run that adds or removes pods
needs nothing more.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ...api import resource as resource_api
from ..types import NodeInfo


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
