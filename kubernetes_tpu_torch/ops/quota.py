"""The device over-quota screen: the packed block's quota verdict column.

The PyTorch counterpart of ``kubernetes_tpu/ops/quota.py``. The host gate
(QuotaAdmission's PreFilter, ``framework/plugins/quota.py``) judges each
pod alone against the ledger; a batch can still hold more winners of one
namespace than its headroom. ``quota_screen`` replays the batch's winners
in batch order against the namespace rows of ``DeviceState`` (``nsq_used``,
``nsq_limit``) and flags every winner whose charge would cross its
namespace's limit. A flagged winner surrenders its placement at commit;
Reserve at bind stays authoritative, so a stale row can only turn a pod
away, never oversubscribe.

The charge order is the contract: two winners of one namespace see each
other's charges, in batch order. The JAX program is a ``lax.scan`` over
the batch; here a Python loop runs over the batch's screened rows only,
whose namespaces the host knows, so no step reads a value on the host. The
usage carry is int32 and wraps as the JAX carry does when a sum passes
``QUOTA_NO_LIMIT``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.types import QUOTA_DIM_ORDER
from ..framework.plugins.quota import pod_quota_request

QUOTA_DIMS = len(QUOTA_DIM_ORDER)

# the per-pod verdict word: bit 0 = screened (the pod's namespace has a
# row), bit 1 = its charge fit (or it was not placed). A screened winner
# without bit 1 is over quota on decision-time state. Unscreened pods: 0.
QUOTA_SCREEN_BIT = 1
QUOTA_OK_BIT = 2

# the limit of a dimension no quota declares: never flags
QUOTA_NO_LIMIT = np.int32(2**31 - 1)


def quota_screen(node_idx: torch.Tensor, ns_idx: np.ndarray, req: torch.Tensor,
                 used: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """[P] int32 verdict words for one batch, on ``node_idx``'s device.
    ``node_idx`` [P] int32 the core's placements (< 0 never charges);
    ``ns_idx`` [P] int32 on the host, each pod's row of the namespace axis
    (-1: not screened); ``req`` [P, Q] int32 the per-pod charges; ``used``
    and ``limit`` [NS, Q] int32 the synced rows. Only placed, screened
    pods whose charge fits advance the usage carry."""
    dev = node_idx.device
    p = node_idx.shape[0]
    u = used.clone()
    placed = node_idx >= 0
    fit = torch.zeros(p, dtype=torch.bool, device=dev)
    screened = torch.zeros(p, dtype=torch.bool, device=dev)
    for i in np.flatnonzero(np.asarray(ns_idx)[:p] >= 0).tolist():
        ns = int(ns_idx[i])
        row = u[ns]
        t = row + req[i]
        fits = torch.all(t <= limit[ns])
        row.copy_(torch.where(fits & placed[i], t, row))
        fit[i] = fits
        screened[i].fill_(True)  # a scalar fill: item assignment would copy from the host
    ok = torch.where(fit | ~placed, QUOTA_OK_BIT, 0)
    return torch.where(screened, QUOTA_SCREEN_BIT | ok, 0).to(torch.int32)


def quota_request_row(pod) -> np.ndarray:
    """[Q] int32 charge of one pod in QUOTA_DIM_ORDER, each entry capped at
    the int32 ceiling (the ledger's ``pod_quota_request``)."""
    req = pod_quota_request(pod)
    return np.array([min(int(req.get(d, 0)), int(QUOTA_NO_LIMIT)) for d in QUOTA_DIM_ORDER],
                    np.int32)


def build_quota_batch_args(pods: Sequence, state, table: Optional[Dict[str, Tuple]] = None,
                           pad_to: Optional[int] = None
                           ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(ns_idx [P] int32, req [P, Q] int32) on the host for one batch
    against ``state``'s namespace table (a ``DeviceState``), or (None,
    None) when no pod of the batch is screened. ``table`` (ns -> (used,
    limit) rows) is synced into ``state`` first when given; ``pad_to``
    pads the pod axis with unscreened rows (ns_idx -1)."""
    if table is not None:
        state.set_ns_quota(table)
    if not state.nsq_slots:
        return None, None
    p = max(pad_to or 0, len(pods))
    ns_idx = np.full(p, -1, np.int32)
    req = np.zeros((p, QUOTA_DIMS), np.int32)
    for i, pod in enumerate(pods):
        slot = state.nsq_slots.get(pod.meta.namespace)
        if slot is not None:
            ns_idx[i] = slot
            req[i] = quota_request_row(pod)
    if not (ns_idx >= 0).any():
        return None, None
    return ns_idx, req
