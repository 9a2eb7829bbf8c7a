"""The NoExecute taint manager's eviction (``kubernetes_tpu/controllers/
nodelifecycle.py:37-79``; taint_manager.go), which the drain
orchestrator's spot reclamation runs, and the node lifecycle taint keys.

The node lifecycle controller itself (``NodeLifecycleController``: lease
heartbeats, NotReady marking, the unreachable taint) runs on the JAX
package's controller framework (``controllers/base.py``) and informers
(``client/``), which the port does not have yet; it is not ported here."""

from __future__ import annotations

from typing import List, Optional

from ..api.types import TAINT_NO_EXECUTE, Node

NODE_LEASE_NAMESPACE = "kube-node-lease"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_MEMORY_PRESSURE = "node.kubernetes.io/memory-pressure"
TAINT_DISK_PRESSURE = "node.kubernetes.io/disk-pressure"
TAINT_PID_PRESSURE = "node.kubernetes.io/pid-pressure"
DEFAULT_GRACE_PERIOD = 40.0  # --node-monitor-grace-period default


def evict_noexecute_pods(store, node: Node, now: float, since: Optional[float] = None,
                         metrics=None, reason: str = "taint", allow_fn=None) -> List:
    """Evict the pods bound to ``node`` that do not tolerate every one of
    its NoExecute taints. A pod whose matching tolerations all carry a
    finite ``toleration_seconds`` goes once the shortest window has passed
    since ``since``; an unbounded matching toleration keeps it. ``allow_fn
    (pod)``, when given, gates each eviction (the PDB budget check): a pod
    it refuses stays for a later sweep. The pods are deleted, not
    recreated; returns them. ``metrics.evicted_pods`` counts them under
    ``reason``."""
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
            matching = [tol for tol in pod.spec.tolerations if tol.tolerates(taint)]
            if not matching:
                tolerated = False
                break
            finite = [tol.toleration_seconds for tol in matching]
            if None not in finite:
                windows.append(min(finite))
        if tolerated and (not windows or since is None or now - since <= min(windows)):
            continue
        if allow_fn is not None and not allow_fn(pod):
            continue
        store.delete_pod(pod.meta.key())
        evicted.append(pod)
    if evicted and metrics is not None:
        metrics.evicted_pods.inc(reason, value=len(evicted))
    return evicted
