"""Kubelet eviction manager (pkg/kubelet/eviction/eviction_manager.go); an own copy of
``kubernetes_tpu/kubelet/eviction.py``.

The node agent's self-defense loop: observe resource pressure signals,
report pressure conditions on the Node object, and evict pods — lowest
"value" first — until the signal clears. The reference's synchronize()
(eviction_manager.go:233) runs every 10s:

  1. collect signals (memory.available, nodefs.available, pid.available)
     from the stats provider (summary API; here a pluggable ``stats_fn``);
  2. threshold crossings set node conditions (MemoryPressure/DiskPressure/
     PIDPressure) — the nodelifecycle controller mirrors conditions as
     NoSchedule taints so the scheduler keeps new pods away;
  3. rank active pods for the starved resource (rankMemoryPressure,
     eviction/helpers.go:1144): pods EXCEEDING their request first, then by
     priority ascending, then by usage-over-request descending;
  4. evict ONE pod per pass (evictPod, :570): phase Failed, reason
     "Evicted" — one at a time so the next observation sees the relief.

Pressure conditions persist for a grace period after the signal clears
(pressureTransitionPeriod, default 30s here vs the reference's 5m) to
prevent condition flapping.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from ..api.types import Pod
from ..apiserver.store import Conflict, NotFound, Store

SIGNAL_MEMORY_AVAILABLE = "memory.available"
SIGNAL_NODEFS_AVAILABLE = "nodefs.available"
SIGNAL_PID_AVAILABLE = "pid.available"

# signal -> node condition attribute (core/v1 NodeConditionType)
_CONDITION_OF = {
    SIGNAL_MEMORY_AVAILABLE: "memory_pressure",
    SIGNAL_NODEFS_AVAILABLE: "disk_pressure",
    SIGNAL_PID_AVAILABLE: "pid_pressure",
}

# eviction_manager.go evictionMaxPodGracePeriod default hard-eviction set
DEFAULT_THRESHOLDS = {
    SIGNAL_MEMORY_AVAILABLE: 100 << 20,   # 100Mi
    SIGNAL_NODEFS_AVAILABLE: 1 << 30,     # 10% stand-in: 1Gi
    SIGNAL_PID_AVAILABLE: 300,
}

REASON_EVICTED = "Evicted"


@dataclasses.dataclass
class PodStats:
    """Per-pod usage for ranking (summary API stand-in): bytes for memory/
    disk signals, count for pids."""

    memory_bytes: int = 0
    disk_bytes: int = 0
    pids: int = 0

    def usage_for(self, signal: str) -> int:
        if signal == SIGNAL_MEMORY_AVAILABLE:
            return self.memory_bytes
        if signal == SIGNAL_NODEFS_AVAILABLE:
            return self.disk_bytes
        return self.pids


class EvictionManager:
    def __init__(self, store: Store, node_name: str,
                 stats_fn: Callable[[], Dict[str, int]],
                 pod_stats_fn: Optional[Callable[[str], PodStats]] = None,
                 thresholds: Optional[Dict[str, int]] = None,
                 pressure_transition_period: float = 30.0,
                 now_fn=time.monotonic):
        """``stats_fn`` returns the node's current signal values (available
        amounts); ``pod_stats_fn(pod_key)`` per-pod usage for ranking."""
        self.store = store
        self.node_name = node_name
        self.stats_fn = stats_fn
        self.pod_stats_fn = pod_stats_fn or (lambda key: PodStats())
        self.thresholds = dict(DEFAULT_THRESHOLDS, **(thresholds or {}))
        self.transition_period = pressure_transition_period
        self.now_fn = now_fn
        self._last_observed_pressure: Dict[str, float] = {}
        self.evicted_total = 0

    # -------------------------------------------------------------- signals

    def _crossed(self, signals: Dict[str, int]) -> List[str]:
        out = []
        for sig, threshold in self.thresholds.items():
            if sig in signals and signals[sig] < threshold:
                out.append(sig)
        return out

    def _set_conditions(self, under_pressure: List[str]) -> None:
        """Write pressure conditions (with the anti-flap transition grace)
        onto the Node object."""
        node = self.store.nodes.get(self.node_name)
        if node is None:
            return
        now = self.now_fn()
        for sig in under_pressure:
            self._last_observed_pressure[sig] = now
        want: Dict[str, bool] = {}
        for sig, attr in _CONDITION_OF.items():
            last = self._last_observed_pressure.get(sig)
            want[attr] = last is not None and (now - last) < self.transition_period
        if all(getattr(node.status, a) == v for a, v in want.items()):
            return
        new = node.clone() if hasattr(node, "clone") else dataclasses.replace(node)
        new.status = dataclasses.replace(node.status, **want)
        try:
            self.store.update_node(new)
        except (Conflict, NotFound):
            pass  # raced; next pass reconciles

    # -------------------------------------------------------------- ranking

    def _active_pods(self) -> List[Pod]:
        return [p for p in self.store.snapshot_map("Pod").values()
                if p.spec.node_name == self.node_name
                and p.status.phase in ("Pending", "Running")]

    def _rank(self, pods: List[Pod], signal: str) -> List[Pod]:
        """helpers.go:1144 rankMemoryPressure ordering: exceeds-request
        first, then priority ascending, then usage-over-request descending."""
        req_key = {"memory.available": "memory",
                   "nodefs.available": "ephemeral-storage"}.get(signal)

        def metrics(p: Pod):
            usage = self.pod_stats_fn(p.meta.key()).usage_for(signal)
            req = 0
            if req_key is not None:
                req = p.resource_request().get(req_key, 0)
                if req_key == "memory":
                    req *= 1024  # canonical memory ints are KiB
            exceeds = usage > req
            return (0 if exceeds else 1, p.spec.priority, -(usage - req))

        return sorted(pods, key=metrics)

    # ------------------------------------------------------------- evict

    def _evict(self, pod: Pod, signal: str) -> bool:
        """evictPod (:570): phase Failed + reason Evicted. The workload
        controllers see a Failed pod and replace it; the scheduler places
        the replacement off this node (pressure taint)."""
        new = pod.clone()
        new.status.phase = "Failed"
        new.status.reason = REASON_EVICTED
        new.status.message = (
            f"The node was low on resource: {signal}. "
            f"Threshold: {self.thresholds.get(signal)}.")
        try:
            self.store.update_pod(new)
        except (Conflict, NotFound):
            return False
        self.evicted_total += 1
        return True

    def synchronize(self) -> Optional[str]:
        """One pass (:233): returns the evicted pod's key, or None."""
        signals = self.stats_fn()
        under = self._crossed(signals)
        self._set_conditions(under)
        if not under:
            return None
        # memory pressure outranks disk (the reference evaluates signals in
        # threshold order and picks the first starved resource to reclaim)
        signal = under[0]
        ranked = self._rank(self._active_pods(), signal)
        for pod in ranked:
            if self._evict(pod, signal):
                return pod.meta.key()
        return None
