"""Disruption controller (pkg/controller/disruption/disruption.go; an own
copy of ``kubernetes_tpu/controllers/disruption.py``).

Maintains PDB status so preemption's PDB-violation counting works against
LIVE numbers instead of whatever the PDB was created with: for each PDB,
count the pods its selector matches (expectedPods), the healthy ones
(currentHealthy — Running-or-bound, not terminating), derive desiredHealthy
from minAvailable/maxUnavailable (percentages resolve against expectedPods,
disruption.go getExpectedPodCountForPDB), and set

    disruptionsAllowed = max(0, currentHealthy - desiredHealthy)

Reconciles on any Pod or PDB event touching the namespace.
"""

from __future__ import annotations

import math
from typing import List

from ..api.types import PodDisruptionBudget
from .base import Controller


def _resolve(value, expected: int, *, round_up: bool) -> int:
    """intstr.GetScaledValueFromIntOrPercent: ints pass through, "N%" scales
    against expectedPods (minAvailable rounds up, maxUnavailable rounds up
    per disruption.go:854)."""
    if isinstance(value, str) and value.endswith("%"):
        pct = float(value[:-1]) / 100.0
        scaled = expected * pct
        return math.ceil(scaled) if round_up else math.floor(scaled)
    return int(value)


class DisruptionController(Controller):
    name = "disruption"
    watch_kinds = ("PodDisruptionBudget", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "PodDisruptionBudget":
            return [obj.meta.key()]
        # a pod event re-reconciles every PDB in its namespace whose selector
        # matches either shape (both shapes enqueued by the base handler)
        keys = []
        for pdb in self.store.pdbs.values():
            if (pdb.meta.namespace == obj.meta.namespace
                    and pdb.selector is not None
                    and pdb.selector.matches(obj.meta.labels)):
                keys.append(pdb.meta.key())
        return keys

    def reconcile(self, key: str) -> None:
        pdb: PodDisruptionBudget = self.store.pdbs.get(key)
        if pdb is None:
            return
        matching = [
            p for p in self.store.pods.values()
            if p.meta.namespace == pdb.meta.namespace
            and pdb.selector is not None
            and pdb.selector.matches(p.meta.labels)
        ]
        expected = len(matching)
        healthy = sum(
            1 for p in matching
            if p.meta.deletion_timestamp == 0
            and (p.spec.node_name or p.status.phase == "Running")
        )
        if pdb.max_unavailable is not None:
            desired = expected - _resolve(pdb.max_unavailable, expected, round_up=True)
        elif pdb.min_available is not None:
            desired = _resolve(pdb.min_available, expected, round_up=True)
        else:
            desired = 0
        allowed = max(0, healthy - desired)
        if (pdb.expected_pods, pdb.current_healthy, pdb.desired_healthy,
                pdb.disruptions_allowed) == (expected, healthy, desired, allowed):
            return  # status already current — no write, no event
        # clone before writing (every store writer does): watch consumers
        # diff old vs new, and in-place mutation would destroy the pre-image
        import dataclasses

        new = dataclasses.replace(
            pdb, expected_pods=expected, current_healthy=healthy,
            desired_healthy=desired, disruptions_allowed=allowed)
        new.meta = dataclasses.replace(pdb.meta)
        self.store.update_object("PodDisruptionBudget", new)
