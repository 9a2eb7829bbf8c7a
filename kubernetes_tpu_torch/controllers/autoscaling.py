"""horizontalpodautoscaling (pkg/controller/podautoscaler): scale a target
workload by observed cpu utilization (an own copy of
``kubernetes_tpu/controllers/autoscaling.py``).

The metrics API (metrics.k8s.io, normally served by metrics-server) is
modeled as ``Store.pod_metrics`` — pod key → milli-cpu usage — fed by
the hollow kubelet or tests. The scale subresource is modeled as writing the
target workload's ``replicas`` field directly (Deployment/ReplicaSet/
StatefulSet/ReplicationController all carry one).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from ..api import resource as resource_api
from ..api.types import HorizontalPodAutoscaler
from ..apiserver.store import Conflict
from .base import Controller
from .workloads import _owned_pods

# scale-down stabilization: skip shrinks within this window of the last scale
# (podautoscaler's downscaleStabilisationWindow, default 5min)
DOWNSCALE_STABILIZATION_S = 300.0
# tolerance band around the target ratio (podautoscaler tolerance, 10%)
TOLERANCE = 0.1


class HorizontalPodAutoscalerController(Controller):
    name = "horizontalpodautoscaling"
    watch_kinds = ("HorizontalPodAutoscaler",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.key()]

    def __init__(self, store, factory, now_fn=None):
        import time as _time

        super().__init__(store, factory)
        self.now_fn = now_fn or _time.monotonic
        self._last_seen: dict = {}   # hpa key -> input fingerprint
        self._held_until: dict = {}  # hpa key -> when a held scale-down re-evaluates
        self._tick_pods: dict = {}   # hpa key -> pods computed by tick (reused once)

    def _target_pods(self, hpa):
        """The pods backing the scale target (Deployment targets go through
        their ReplicaSets, one hop down)."""
        if hpa.target_kind == "Deployment":
            pods = []
            for rs in self.store.snapshot_map("ReplicaSet").values():
                ref = rs.meta.controller_of()
                if (rs.meta.namespace == hpa.meta.namespace and ref is not None
                        and ref.kind == "Deployment" and ref.name == hpa.target_name):
                    pods.extend(_owned_pods(self.store, hpa.meta.namespace,
                                            "ReplicaSet", rs.meta.name))
            return pods
        return _owned_pods(self.store, hpa.meta.namespace, hpa.target_kind,
                           hpa.target_name)

    def tick(self) -> None:
        # metrics change without API events: re-evaluate an HPA when ITS
        # inputs changed (metrics, target replicas, its own pods' phases) —
        # an unconditional re-enqueue would keep settle() from converging,
        # and a cluster-wide fingerprint would re-run every HPA on any
        # unrelated pod churn
        hpas = self.store.snapshot_map("HorizontalPodAutoscaler")
        for stale in set(self._last_seen) - set(hpas):
            self._last_seen.pop(stale, None)  # deleted HPAs: no leak
            self._held_until.pop(stale, None)
        if not hpas:
            return
        for key, hpa in hpas.items():
            target = self.store.get_object(
                hpa.target_kind, f"{hpa.meta.namespace}/{hpa.target_name}")
            pods = self._target_pods(hpa)
            fp = (target.replicas if target is not None else -1,
                  tuple(sorted((p.meta.key(), p.status.phase,
                                self.store.pod_metrics.get(p.meta.key()))
                               for p in pods)))
            if self._last_seen.get(key) != fp:
                self._last_seen[key] = fp
                self._tick_pods[key] = pods  # reconcile reuses this scan
                self.queue.add(key)
            elif key in self._held_until and self.now_fn() >= self._held_until[key]:
                del self._held_until[key]  # stabilization window expired
                self.queue.add(key)

    def _utilization(self, pods):
        """(mean usage/request percent, measured-pod count) over pods with
        metrics+requests (replica_calculator.go GetResourceReplicas — the
        scale basis is the number of pods actually measured, so a scale-up
        that hasn't materialized pods yet doesn't compound)."""
        ratios = []
        for p in pods:
            usage = self.store.pod_metrics.get(p.meta.key())
            if usage is None:
                continue
            request = p.resource_request().get(resource_api.CPU, 0)
            if request <= 0:
                continue
            ratios.append(100.0 * usage / request)
        if not ratios:
            return None, 0
        return sum(ratios) / len(ratios), len(ratios)

    def reconcile(self, key: str) -> None:
        hpa: Optional[HorizontalPodAutoscaler] = self.store.get_object(
            "HorizontalPodAutoscaler", key)
        if hpa is None or not hpa.target_name:
            return
        target_key = f"{hpa.meta.namespace}/{hpa.target_name}"
        target = self.store.get_object(hpa.target_kind, target_key)
        if target is None:
            return
        pods = self._tick_pods.pop(key, None)
        if pods is None:  # event-driven enqueue: compute fresh
            pods = self._target_pods(hpa)
        live = [p for p in pods if p.status.phase in ("Pending", "Running")]
        current = target.replicas
        util, measured = self._utilization(live)
        if util is None:
            desired = current  # no metrics: hold
        else:
            ratio = util / max(hpa.target_cpu_utilization, 1)
            if abs(ratio - 1.0) <= TOLERANCE:
                desired = current
            elif ratio > 1.0:
                # over target can only scale UP: pods without metrics must
                # not shrink an overloaded workload (missing-metrics pods
                # are treated conservatively, replica_calculator.go)
                desired = max(current, math.ceil(measured * ratio))
            else:
                # conservative scale-down: each unmeasured pod is assumed to
                # run AT target (counts 1:1), so missing metrics alone never
                # shrink the workload (replica_calculator.go missing-pods
                # assumption on scale-down)
                unmeasured = max(0, len(live) - measured)
                desired = min(current, math.ceil(measured * ratio) + unmeasured)
        desired = max(hpa.min_replicas, min(hpa.max_replicas, desired))
        now = self.now_fn()
        if desired < current and hpa.last_scale_time and (
                now - hpa.last_scale_time < DOWNSCALE_STABILIZATION_S):
            # stabilization window: hold, and have tick() re-evaluate once
            # the window expires (time is an input the fingerprint can't see)
            self._held_until[key] = hpa.last_scale_time + DOWNSCALE_STABILIZATION_S
            desired = current
        if desired != current:
            new_target = dataclasses.replace(target, replicas=desired)
            new_target.meta = dataclasses.replace(target.meta)
            try:
                self.store.update_object(hpa.target_kind, new_target)
            except Conflict:
                self.queue.add(key)
                return
        observed = len(live)  # status reflects what exists, not what's wanted
        if (hpa.current_replicas != observed or hpa.desired_replicas != desired
                or desired != current):
            new = dataclasses.replace(
                hpa, current_replicas=observed, desired_replicas=desired,
                last_scale_time=now if desired != current else hpa.last_scale_time)
            new.meta = dataclasses.replace(hpa.meta)
            try:
                self.store.update_object("HorizontalPodAutoscaler", new)
            except Conflict:
                self.queue.add(key)
