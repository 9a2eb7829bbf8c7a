"""Node lifecycle controller (pkg/controller/nodelifecycle/
node_lifecycle_controller.go:261; monitorNodeHealth :761); an own copy of
``kubernetes_tpu/controllers/nodelifecycle.py``. The NoExecute taint
manager's eviction (``evict_noexecute_pods``) is shared with the drain
orchestrator's spot reclamation (``drain.py``).

Failure detection: each node heartbeats a Lease in the node-lease namespace
(kubelet side); when renew_time + grace passes, the node is marked NotReady
and the NoExecute ``unreachable`` taint is applied; pods without a matching
toleration are evicted (the taint manager, scheduler/taint-toleration then
keeps new pods off). Recovery removes the taint and restores Ready.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from ..api.types import Lease, Node, TAINT_NO_EXECUTE, Taint
from .base import Controller

NODE_LEASE_NAMESPACE = "kube-node-lease"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_MEMORY_PRESSURE = "node.kubernetes.io/memory-pressure"
TAINT_DISK_PRESSURE = "node.kubernetes.io/disk-pressure"
TAINT_PID_PRESSURE = "node.kubernetes.io/pid-pressure"
DEFAULT_GRACE_PERIOD = 40.0  # --node-monitor-grace-period default

# pressure condition attribute -> mirrored NoSchedule taint
# (node_lifecycle_controller.go nodeConditionToTaintKeyStatusMap)
_PRESSURE_TAINTS = (
    ("memory_pressure", TAINT_MEMORY_PRESSURE),
    ("disk_pressure", TAINT_DISK_PRESSURE),
    ("pid_pressure", TAINT_PID_PRESSURE),
)


def evict_noexecute_pods(store, node: Node, now: float,
                         since: Optional[float] = None,
                         metrics=None, reason: str = "taint",
                         allow_fn=None) -> List:
    """The NoExecute taint manager (taint_manager.go), shared by node-health
    eviction and spot reclamation (controllers/drain.py): a pod on ``node``
    is evicted unless it tolerates EVERY NoExecute taint; a pod whose
    matching tolerations all carry finite tolerationSeconds goes once the
    minimum window elapses past ``since``; an unbounded matching toleration
    keeps the pod forever. ``allow_fn(pod)`` — when given — gates each
    eviction (the PDB budget check of the eviction API): a refused pod
    stays on the tainted node for a LATER sweep to take once the budget
    recovers. Returns the evicted Pod objects (callers that drive rebind
    waves recreate them unbound; health eviction leaves the rest to
    PodGC)."""
    noexec = [t for t in node.spec.taints if t.effect == TAINT_NO_EXECUTE]
    if not noexec:
        return []
    evicted = []
    for pod in list(store.pods.values()):
        if pod.spec.node_name != node.meta.name:
            continue
        windows: List[int] = []
        tolerated = True
        for taint in noexec:
            matching = [tol for tol in pod.spec.tolerations
                        if tol.tolerates(taint)]
            if not matching:
                tolerated = False
                break
            finite = [tol.toleration_seconds for tol in matching]
            if None not in finite:
                windows.append(min(finite))
        if tolerated and (not windows or since is None
                          or now - since <= min(windows)):
            continue
        if allow_fn is not None and not allow_fn(pod):
            continue
        store.delete_pod(pod.meta.key())
        evicted.append(pod)
    if evicted and metrics is not None:
        metrics.evicted_pods.inc(reason, value=len(evicted))
    return evicted


class NodeLifecycleController(Controller):
    name = "nodelifecycle"
    watch_kinds = ("Node", "Lease")

    def __init__(self, store, factory, grace_period: float = DEFAULT_GRACE_PERIOD,
                 now_fn=time.monotonic, evict: bool = True, metrics=None):
        super().__init__(store, factory)
        self.grace_period = grace_period
        self.now_fn = now_fn
        self.evict = evict
        self.metrics = metrics
        self._not_ready_since: dict = {}  # node -> when it went unhealthy

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "Node":
            return [obj.meta.name]
        if obj.meta.namespace == NODE_LEASE_NAMESPACE:
            return [obj.meta.name]
        return []

    def monitor_node_health(self) -> None:
        """Periodic full sweep (monitorNodeHealth is ticker-driven, :761) —
        lease expiry produces no watch event, so health must be polled."""
        for name in list(self.store.nodes):
            self.queue.add(name)
        self.sync_once()

    def _lease_of(self, node_name: str) -> Optional[Lease]:
        return self.store.get_lease(f"{NODE_LEASE_NAMESPACE}/{node_name}")

    def reconcile(self, key: str) -> None:
        node: Optional[Node] = self.store.nodes.get(key)
        if node is None:
            return
        self._sync_pressure_taints(node)
        node = self.store.nodes.get(key) or node  # taint write bumped it
        lease = self._lease_of(key)
        healthy = (
            lease is not None
            and self.now_fn() - lease.renew_time <= self.grace_period
        )
        if lease is None:
            # node never heartbeat (no kubelet): leave as created
            return
        if healthy and not node.status.ready:
            self._not_ready_since.pop(key, None)
            self._set_health(node, ready=True)
        elif not healthy and node.status.ready:
            self._not_ready_since.setdefault(key, self.now_fn())
            self._set_health(node, ready=False)
            if self.evict:
                self._evict_pods(key)
        elif not healthy and self.evict:
            self._not_ready_since.setdefault(key, self.now_fn())
            self._evict_pods(key)

    def _sync_pressure_taints(self, node: Node) -> None:
        """Mirror the kubelet-reported pressure conditions as NoSchedule
        taints (node_lifecycle_controller.go doNoScheduleTaintingPass):
        TaintToleration then keeps new pods off pressured nodes while the
        eviction manager reclaims."""
        want = {taint_key: bool(getattr(node.status, attr))
                for attr, taint_key in _PRESSURE_TAINTS}
        have = {t.key for t in node.spec.taints}
        if all((k in have) == v for k, v in want.items()):
            return
        taints = tuple(t for t in node.spec.taints
                       if t.key not in want or want[t.key])
        for k, v in want.items():
            if v and k not in have:
                taints = taints + (Taint(key=k, effect="NoSchedule"),)
        new = node.clone() if hasattr(node, "clone") else dataclasses.replace(node)
        new.meta = dataclasses.replace(node.meta)
        new.spec = dataclasses.replace(node.spec, taints=taints)
        self.store.update_node(new)

    def _set_health(self, node: Node, ready: bool) -> None:
        taints = tuple(
            t for t in node.spec.taints
            if t.key not in (TAINT_UNREACHABLE, TAINT_NOT_READY)
        )
        if not ready:
            taints = taints + (Taint(key=TAINT_UNREACHABLE, effect=TAINT_NO_EXECUTE),)
        new = node.clone() if hasattr(node, "clone") else dataclasses.replace(node)
        new.meta = dataclasses.replace(node.meta)
        new.spec = dataclasses.replace(node.spec, taints=taints)
        new.status = dataclasses.replace(node.status, ready=ready)
        self.store.update_node(new)

    def _evict_pods(self, node_name: str) -> None:
        """Health-driven NoExecute eviction through the shared taint
        manager (evict_noexecute_pods — the same path drain.py's spot
        storms ride). A node judged unhealthy before _set_health stamped
        the unreachable taint is evaluated AS IF tainted (the reference
        evicts on the condition, not the taint write racing it)."""
        node = self.store.nodes.get(node_name)
        if node is None:
            return
        if not any(t.effect == TAINT_NO_EXECUTE for t in node.spec.taints):
            node = dataclasses.replace(node, spec=dataclasses.replace(
                node.spec, taints=node.spec.taints + (Taint(
                    key=TAINT_UNREACHABLE, effect=TAINT_NO_EXECUTE),)))
        evict_noexecute_pods(self.store, node, self.now_fn(),
                             since=self._not_ready_since.get(node_name),
                             metrics=self.metrics, reason="taint")
