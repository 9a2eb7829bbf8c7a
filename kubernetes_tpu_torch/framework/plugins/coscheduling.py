"""Coscheduling — gang (all-or-nothing) admission over PodGroup.

The port's own copy of ``kubernetes_tpu/framework/plugins/coscheduling.py``,
trimmed to what the batch path uses: pods join a gang through the
``scheduling.x-k8s.io/pod-group`` label, and the plugin

  * PreFilter (``pre_filter``): fails a member while its group sits in
    rejection backoff, when its PodGroup does not exist, or when fewer than
    ``min_member`` members exist;
  * ``reject_gang``: the batch path's whole-gang reject arms the backoff,
    sets the group's phase to Pending and counts the rejection by reason;
  * PostBind (``post_bind_batch``): the bound count per gang, and phase
    Running once it reaches ``min_member``.

QueueSort, Permit's waiting pods and the permit timeout are left out: they
come with the scheduler loop. The store holds no pods here, so the caller
counts a group's members (``members_fn``): ``BatchScheduler`` counts the
pods of the current ``schedule`` call that carry the group's label plus the
group's pods already bound in its snapshot, where the JAX plugin counts the
pods in its store.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from ...api.types import (POD_GROUP_LABEL, POD_GROUP_PENDING, POD_GROUP_RUNNING,
                          POD_GROUP_SCHEDULING, Pod, PodGroup)

ERR_REASON_MISSING_GROUP = "pod group not found"
ERR_REASON_TOO_FEW_MEMBERS = "fewer than minMember sibling pods exist"
ERR_REASON_GANG_BACKOFF = "pod group is in rejection backoff"

# (group key, bound members only) -> member count
MembersFn = Callable[[str, bool], int]


def pod_group_key(pod: Pod) -> Optional[str]:
    """``namespace/name`` PodGroup key for a gang member, else None."""
    name = pod.meta.labels.get(POD_GROUP_LABEL)
    if not name:
        return None
    return f"{pod.meta.namespace}/{name}"


class Coscheduling:
    # how long a rejected group fails its PreFilter (the JAX plugin's default)
    GANG_BACKOFF_S = 5.0

    def __init__(self, client, members_fn: MembersFn,
                 now_fn: Optional[Callable[[], float]] = None):
        self.client = client
        self.members_fn = members_fn
        self.now_fn = now_fn or time.monotonic
        self._bound: Dict[str, int] = {}    # gkey -> bound-member count
        self._denied: Dict[str, float] = {}  # gkey -> end of the rejection backoff
        # reason -> whole-gang rejections (scheduler_gangs_rejected_total)
        self.rejections: Dict[str, int] = {}

    def _group(self, gkey: str) -> Optional[PodGroup]:
        return self.client.get_object("PodGroup", gkey)

    def pre_filter(self, pod: Pod) -> Optional[str]:
        """None when ``pod`` may take a batch row, else why not (the JAX
        PreFilter's unresolvable Status reason)."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return None
        until = self._denied.get(gkey)
        if until is not None:
            if self.now_fn() < until:
                return f'{ERR_REASON_GANG_BACKOFF} "{gkey}"'
            self._denied.pop(gkey, None)
        pg = self._group(gkey)
        if pg is None:
            return f'{ERR_REASON_MISSING_GROUP} "{gkey}"'
        if self.members_fn(gkey, False) < pg.min_member:
            return f'{ERR_REASON_TOO_FEW_MEMBERS} for "{gkey}"'
        return None

    def reject_gang(self, gkey: str, reason: str) -> None:
        """The whole-gang reject of the batch path: count it, arm the
        backoff and set the group Pending."""
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        self._denied[gkey] = self.now_fn() + self.GANG_BACKOFF_S
        self._set_phase(gkey, POD_GROUP_PENDING)

    def post_bind_batch(self, per_gang: Dict[str, int]) -> None:
        """One bound-count bump and one status write per gang of a batch
        (``per_gang``: gkey -> members bound). Call after the binds."""
        for gkey, n in per_gang.items():
            if gkey in self._bound:
                self._bound[gkey] += n
            else:
                # seeded from the cluster, which already holds these binds
                self._bound[gkey] = self.members_fn(gkey, True)
            pg = self._group(gkey)
            if pg is None:
                continue
            bound = self._bound[gkey]
            phase = POD_GROUP_RUNNING if bound >= pg.min_member else POD_GROUP_SCHEDULING
            if phase == POD_GROUP_RUNNING:
                self._denied.pop(gkey, None)
            self._update_status(pg, phase, bound)

    def _set_phase(self, gkey: str, phase: str) -> None:
        pg = self._group(gkey)
        if pg is not None and pg.phase != phase:
            self._update_status(pg, phase, pg.scheduled)

    def _update_status(self, pg: PodGroup, phase: str, scheduled: int) -> None:
        if pg.phase == phase and pg.scheduled == scheduled:
            return
        self.client.update_object("PodGroup", dataclasses.replace(
            pg, phase=phase, scheduled=scheduled))
