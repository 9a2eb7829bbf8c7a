"""Coscheduling — gang (all-or-nothing) admission over PodGroup.

The port's own copy of ``kubernetes_tpu/framework/plugins/coscheduling.py``
(``:89-385``; sigs.k8s.io/scheduler-plugins pkg/coscheduling): pods join a
gang through the ``scheduling.x-k8s.io/pod-group`` label, and the plugin

  * QueueSort (``sort_key``): priority desc, then the gang's first-seen
    queue timestamp, then the group key, so a gang's members sort
    adjacently and drain into one batch; a groupless pod keeps
    PrioritySort's key exactly;
  * PreFilter (``pre_filter``): fails a member while its group sits in
    rejection backoff, when its PodGroup does not exist, or when fewer
    than ``min_member`` members exist;
  * Permit (``permit``): parks a member (WAIT with the group's
    ``schedule_timeout_seconds``, else ``permit_timeout_s``) until
    ``min_member`` of them hold a node (parked, bound, and itself), then
    allows every parked sibling through the scheduler's waiting-pods
    handle;
  * Reserve does nothing; Unreserve (``unreserve``) rejects the gang's
    parked members (``reject_gang`` with ``force`` False); a rejected gang
    fails its PreFilter for ``gang_backoff_s``;
  * ``reject_gang``: tears down the parked members, counts the rejection by
    reason (``gangs_rejected``), arms the backoff and sets the group
    Pending; the scheduler's permit sweep and the batch commit's whole-gang
    verdicts call it too;
  * PostBind (``post_bind`` / ``post_bind_batch``): the bound count per
    gang, and phase Running once it reaches ``min_member``;
  * ``pod_deleted``: a bound member's deletion lowers the count, and the
    last member's deletion drops every per-gang state (``_gc_group``).

``members_fn(gkey, bound_only)`` counts a group's members: by default the
pods in the store (the JAX plugin's ``_members_in_store``);
``BatchScheduler``, whose store holds no pods, counts the pods of its
current ``schedule`` call and those bound in its snapshot.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ...api.types import (POD_GROUP_LABEL, POD_GROUP_PENDING, POD_GROUP_RUNNING,
                          POD_GROUP_SCHEDULING, Pod, PodGroup)
from ...metrics.scheduler_metrics import Counter
from ..interface import Fail
from ..types import ADD, ALL, POD, POD_GROUP, ClusterEvent

NAME = "Coscheduling"
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
    # the JAX plugin's defaults: the Permit park when the PodGroup names no
    # timeout, and how long a rejected group fails its PreFilter
    DEFAULT_PERMIT_TIMEOUT_S = 60.0
    DEFAULT_GANG_BACKOFF_S = 5.0

    def __init__(self, client, members_fn: Optional[MembersFn] = None,
                 now_fn: Optional[Callable[[], float]] = None, metrics=None, waiting=None,
                 permit_timeout_s: float = DEFAULT_PERMIT_TIMEOUT_S,
                 gang_backoff_s: float = DEFAULT_GANG_BACKOFF_S):
        self.client = client
        self.permit_timeout_s = permit_timeout_s
        self.gang_backoff_s = gang_backoff_s
        self.members_fn = members_fn or self._members_in_store
        self.now_fn = now_fn or time.monotonic
        self.metrics = metrics
        # scheduler_gangs_rejected_total by reason: the metrics' counter, or
        # one of the plugin's own
        self.gangs_rejected = metrics.gangs_rejected if metrics is not None else Counter()
        self.waiting = waiting  # the scheduler's waiting-pods handle, or None
        self._group_ts: Dict[str, float] = {}   # gkey -> first queue timestamp
        self._bound: Dict[str, int] = {}        # gkey -> bound-member count
        self._first_wait: Dict[str, float] = {}  # gkey -> first member's park time
        self._denied: Dict[str, float] = {}     # gkey -> end of the rejection backoff
        self._rejecting: Set[str] = set()       # reject_gang's reentrancy guard

    def name(self) -> str:
        return NAME

    @property
    def rejections(self) -> Dict[str, int]:
        """Reason -> whole-gang rejections."""
        return {labels[0]: n for labels, n in self.gangs_rejected.by_labels.items()}

    @staticmethod
    def events_to_register() -> List[ClusterEvent]:
        return [ClusterEvent(POD_GROUP, ALL, "PodGroupChange"), ClusterEvent(POD, ADD, "PodAdd")]

    # ------------------------------------------------------------- queue sort

    def sort_key(self, qp) -> Tuple:
        pod = qp.pod
        name = pod.meta.labels.get(POD_GROUP_LABEL)
        if not name:
            return (-pod.spec.priority, qp.timestamp, "")
        gkey = f"{pod.meta.namespace}/{name}"
        ts = self._group_ts.setdefault(gkey, qp.timestamp)
        return (-pod.spec.priority, ts, gkey)

    def less(self, a, b) -> bool:
        return self.sort_key(a) < self.sort_key(b)

    # ------------------------------------------------------------- helpers

    def _group(self, gkey: str) -> Optional[PodGroup]:
        return self.client.get_object("PodGroup", gkey) if self.client is not None else None

    def _members_in_store(self, gkey: str, bound_only: bool) -> int:
        pods = getattr(self.client, "pods", None)
        if pods is None:
            return 0
        ns, _, name = gkey.partition("/")
        return sum(1 for p in pods.values()
                   if p.meta.namespace == ns and p.meta.labels.get(POD_GROUP_LABEL) == name
                   and (p.spec.node_name or not bound_only))

    def _bound_count(self, gkey: str) -> int:
        n = self._bound.get(gkey)
        if n is None:
            n = self._bound[gkey] = self.members_fn(gkey, True)
        return n

    def _waiting_members(self, gkey: str) -> List[str]:
        if self.waiting is None:
            return []
        return [key for key, pod in self.waiting.iterate() if pod_group_key(pod) == gkey]

    def _observe_wait(self, gkey: str, result: str) -> None:
        t0 = self._first_wait.pop(gkey, None)
        if t0 is not None and self.metrics is not None:
            self.metrics.gang_wait_duration.observe(self.now_fn() - t0, result)

    # ------------------------------------------------------------- extension points

    def pre_filter(self, state, pod: Pod):
        """(None, None) when ``pod`` may take a batch row, else (None, the
        unresolvable failure, with the JAX PreFilter's reason)."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return None, None
        reason = None
        until = self._denied.get(gkey)
        if until is not None and self.now_fn() < until:
            reason = f'{ERR_REASON_GANG_BACKOFF} "{gkey}"'
        else:
            if until is not None:
                self._denied.pop(gkey, None)
            pg = self._group(gkey)
            if pg is None:
                reason = f'{ERR_REASON_MISSING_GROUP} "{gkey}"'
            elif self.members_fn(gkey, False) < pg.min_member:
                reason = f'{ERR_REASON_TOO_FEW_MEMBERS} for "{gkey}"'
        return None, (None if reason is None else Fail(NAME, reason, True))

    def reserve(self, state, pod: Pod, node_name: str) -> Optional[str]:
        return None  # nothing to hold; Unreserve carries the gang semantics

    def permit(self, state, pod: Pod, node_name: str) -> Tuple[Optional[str], Optional[float]]:
        """(None, None) to allow, (None, timeout seconds) to park the pod,
        (reason, None) to reject it."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return None, None
        pg = self._group(gkey)
        if pg is None:
            return f'{ERR_REASON_MISSING_GROUP} "{gkey}"', None
        waiting = self._waiting_members(gkey)
        if len(waiting) + self._bound_count(gkey) + 1 >= pg.min_member:
            self._observe_wait(gkey, "scheduled")
            if self.waiting is not None:
                for key in waiting:
                    self.waiting.allow(key)
            return None, None
        self._first_wait.setdefault(gkey, self.now_fn())
        self._set_phase(gkey, POD_GROUP_SCHEDULING)
        return None, float(pg.schedule_timeout_seconds or self.permit_timeout_s)

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        """A member's failure after Reserve takes its parked siblings down."""
        gkey = pod_group_key(pod)
        if gkey is None or gkey in self._rejecting:
            return
        self.reject_gang(gkey, "member_failure", force=False)

    def reject_gang(self, gkey: str, reason: str, force: bool = True) -> int:
        """Reject every parked member of ``gkey``; unless ``force`` is
        False and the gang had nothing parked and never waited, count the
        rejection, arm the backoff and set the group Pending. Returns the
        members rejected."""
        if gkey in self._rejecting:
            return 0
        self._rejecting.add(gkey)
        try:
            waited = gkey in self._first_wait
            rejected = 0
            if self.waiting is not None:
                for key in self._waiting_members(gkey):
                    if self.waiting.reject(key, (NAME,)):
                        rejected += 1
            if force or rejected or waited:
                self.gangs_rejected.inc(reason)
                self._observe_wait(gkey, "rejected")
                self._denied[gkey] = self.now_fn() + self.gang_backoff_s
                self._set_phase(gkey, POD_GROUP_PENDING)
            return rejected
        finally:
            self._rejecting.discard(gkey)

    def post_bind(self, state, pod: Pod, node_name: str) -> None:
        self.post_bind_batch([pod])

    def post_bind_batch(self, pods: List[Pod]) -> None:
        """PostBind over a batch's bound pods: one bound-count bump and one
        status write per gang. Call after the binds."""
        per_gang: Dict[str, int] = {}
        for pod in pods:
            gkey = pod_group_key(pod)
            if gkey is not None:
                per_gang[gkey] = per_gang.get(gkey, 0) + 1
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
                self._group_ts.pop(gkey, None)
                self._denied.pop(gkey, None)
            self._update_status(pg, phase, bound)

    def pod_deleted(self, pod: Pod) -> None:
        """A member left the store: a bound one lowers the bound count and
        refreshes the status; the last one drops the gang's state."""
        gkey = pod_group_key(pod)
        if gkey is None:
            return
        if pod.spec.node_name and gkey in self._bound:
            self._bound[gkey] = max(self._bound[gkey] - 1, 0)
        if self.members_fn(gkey, False) == 0:
            self._gc_group(gkey)
            return
        if pod.spec.node_name:
            pg = self._group(gkey)
            if pg is not None:
                n = self._bound_count(gkey)
                phase = (POD_GROUP_RUNNING if n >= pg.min_member
                         else POD_GROUP_SCHEDULING if n else POD_GROUP_PENDING)
                self._update_status(pg, phase, n)

    def _gc_group(self, gkey: str) -> None:
        for d in (self._bound, self._group_ts, self._first_wait, self._denied):
            d.pop(gkey, None)
        pg = self._group(gkey)
        if pg is not None:
            self._update_status(pg, POD_GROUP_PENDING, 0)

    def _set_phase(self, gkey: str, phase: str) -> None:
        pg = self._group(gkey)
        if pg is not None and pg.phase != phase:
            self._update_status(pg, phase, pg.scheduled)

    def _update_status(self, pg: PodGroup, phase: str, scheduled: int) -> None:
        if self.client is None or (pg.phase == phase and pg.scheduled == scheduled):
            return
        from ...apiserver.store import NotFound

        try:
            self.client.update_object("PodGroup", dataclasses.replace(
                pg, phase=phase, scheduled=scheduled))
        except NotFound:
            pass  # the group was deleted: its status is advisory
