"""Node agent (L4c): hollow kubelet + kubemark cluster; an own copy of
``kubernetes_tpu/kubelet/__init__.py``.

The reference tests 5k-node scheduling without 5k machines via kubemark
hollow nodes (pkg/kubemark/hollow_kubelet.go:65): a real control plane with
kubelets whose container runtime is fake. Same here: HollowKubelet registers
its Node, heartbeats a Lease + NodeStatus, and runs the pod syncLoop against
a no-op runtime (Pending → Running → Succeeded), which is exactly what the
scheduler/controller stack needs to observe. The checkpoint manager mirrors
pkg/kubelet/checkpointmanager (checksummed state files surviving restarts).
"""

from .checkpoint import CheckpointManager
from .hollow import HollowKubelet
from .kubemark import HollowCluster

__all__ = ["CheckpointManager", "HollowCluster", "HollowKubelet"]
