"""PodGroup controller — out-of-band reconciliation of PodGroup status
(the controller half of scheduler-plugins' pod-group lifecycle; the
plugin-side half lives in framework/plugins/coscheduling.py). An own copy of
``kubernetes_tpu/controllers/podgroup.py``.

The Coscheduling plugin maintains group status from its in-memory caches
along the scheduling hot path; this controller is the level-triggered
truth-keeper that repairs what those caches cannot see:

  * status drift after a scheduler restart — the plugin's bound counts
    start empty, so a group bound before the restart may carry a stale
    ``scheduled``/phase until its next member event; the controller
    recounts from the store and repairs immediately;
  * orphaned-group GC — a group whose members are all gone (job finished
    and its pods were deleted, or the gang was abandoned before any pod
    was created) first has its status reset to Pending/0 and, once it has
    stayed memberless past ``orphan_ttl_s``, is deleted outright (the
    reference controller's ownerless-group reaping).

Non-interference with the plugin is by construction: the controller only
writes status the store truth CONTRADICTS — the bound count is always
store-derivable, but the Pending↔Scheduling distinction below quorum is
transient plugin state (members parked at Permit) the store cannot
witness, so the controller never flips between them. Both writers compute
toward the same fixpoint and tolerate Conflict, so alternating reconciles
converge instead of livelocking.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

from ..api.types import (
    POD_GROUP_LABEL,
    POD_GROUP_PENDING,
    POD_GROUP_RUNNING,
    POD_GROUP_SCHEDULING,
    PodGroup,
)
from ..apiserver.store import Conflict, NotFound
from .base import Controller

DEFAULT_ORPHAN_TTL_S = 1800.0


class PodGroupController(Controller):
    name = "podgroup"
    watch_kinds = ("PodGroup", "Pod")

    def __init__(self, store, factory, now_fn=time.time,
                 orphan_ttl_s: float = DEFAULT_ORPHAN_TTL_S):
        super().__init__(store, factory)
        self.now_fn = now_fn
        self.orphan_ttl_s = orphan_ttl_s
        # group key -> when the controller first saw it memberless (cleared
        # when members appear; the GC clock, kept controller-side so a
        # member blip resets it without a status write)
        self._empty_since: Dict[str, float] = {}

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "PodGroup":
            return [obj.meta.key()]
        # Pod events: member pods reconcile their group
        name = obj.meta.labels.get(POD_GROUP_LABEL)
        return [f"{obj.meta.namespace}/{name}"] if name else []

    def tick(self) -> None:
        """Periodic full resync (the interval syncAll pattern): ages the
        orphan-GC clock even when no pod/group event fires."""
        for key in self.store.snapshot_map("PodGroup"):
            self.queue.add(key)

    # ------------------------------------------------------------- reconcile

    def _members(self, key: str):
        ns, _, name = key.partition("/")
        return [p for p in self.store.snapshot_map("Pod").values()
                if (p.meta.namespace == ns
                    and p.meta.labels.get(POD_GROUP_LABEL) == name)]

    def reconcile(self, key: str) -> None:
        pg: PodGroup = self.store.get_object("PodGroup", key)
        if pg is None:
            self._empty_since.pop(key, None)
            return
        members = self._members(key)
        bound = sum(1 for p in members if p.spec.node_name)

        if not members:
            # the GC clock starts at the first memberless observation (a
            # group created and immediately abandoned starts aging at its
            # first reconcile, not at creation — cheap and restart-safe:
            # a restarted controller just re-ages it once more)
            first_empty = self._empty_since.setdefault(key, self.now_fn())
            if self.now_fn() - first_empty >= self.orphan_ttl_s:
                try:
                    self.store.delete_object("PodGroup", key)
                except (Conflict, NotFound):
                    pass
                self._empty_since.pop(key, None)
                return
            # memberless but not yet expired: status must read Pending/0 (a
            # re-created gang under the same key is judged afresh — the
            # store-side twin of the plugin's _gc_group)
            self._write_status(pg, POD_GROUP_PENDING, 0)
            return

        self._empty_since.pop(key, None)
        if bound >= pg.min_member:
            phase = POD_GROUP_RUNNING
        elif pg.phase == POD_GROUP_RUNNING:
            # restart drift: Running with quorum lost in the store is
            # impossible-by-truth — demote (Scheduling while partially
            # bound, Pending when nothing is)
            phase = POD_GROUP_SCHEDULING if bound else POD_GROUP_PENDING
        else:
            # below quorum, Pending vs Scheduling is transient Permit-park
            # state only the plugin can witness — never flip it here (the
            # non-interference contract)
            phase = pg.phase
        self._write_status(pg, phase, bound)

    def _write_status(self, pg: PodGroup, phase: str, scheduled: int) -> None:
        if pg.phase == phase and pg.scheduled == scheduled:
            return
        try:
            self.store.update_object("PodGroup", dataclasses.replace(
                pg, phase=phase, scheduled=scheduled))
        except (Conflict, NotFound):
            pass  # concurrent writer (the plugin) / group deleted: the next
            # event re-reconciles against the new truth
