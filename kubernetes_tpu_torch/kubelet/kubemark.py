"""Kubemark hollow cluster (cmd/kubemark/hollow-node.go + test/kubemark):
N hollow kubelets against one store — how thousand-node scheduling behavior
is exercised without machines; an own copy of
``kubernetes_tpu/kubelet/kubemark.py``."""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..api.types import Node
from ..api.wrappers import make_node
from ..apiserver.store import Store
from .hollow import HollowKubelet


def default_node(i: int) -> Node:
    return (
        make_node(f"hollow-node-{i}")
        .capacity({"cpu": "8", "memory": "32Gi", "pods": 110})
        .label("topology.kubernetes.io/zone", f"zone-{i % 3}")
        .label("kubernetes.io/hostname", f"hollow-node-{i}")
        .obj()
    )


class HollowCluster:
    def __init__(self, store: Store, n_nodes: int,
                 node_fn: Callable[[int], Node] = default_node,
                 now_fn=time.monotonic, startup_delay: float = 0.0,
                 with_runtime: bool = False,
                 with_volume_manager: bool = False):
        """``with_runtime``: each hollow kubelet gets its own
        FakeRuntimeService + PLEG (the hollow-node.go injected-CRI mode);
        ``with_volume_manager``: PVC mounts gate Pending→Running (attach
        treated as instant — kubemark has no attachdetach controller)."""
        self.store = store
        self.kubelets: List[HollowKubelet] = []
        for i in range(n_nodes):
            runtime = None
            if with_runtime:
                from .cri import FakeRuntimeService

                runtime = FakeRuntimeService(now_fn=now_fn)
            k = HollowKubelet(store, node_fn(i), now_fn=now_fn,
                              startup_delay=startup_delay, runtime=runtime)
            if with_volume_manager:
                from .volume_manager import VolumeManager

                k.volume_manager = VolumeManager(store, k.node_name,
                                                 require_attach=False)
            self.kubelets.append(k)

    def register_all(self) -> None:
        for k in self.kubelets:
            k.register()

    def tick(self) -> int:
        """One kubelet round across the fleet; returns status transitions."""
        return sum(k.run_once() for k in self.kubelets)

    def settle(self, max_rounds: int = 20) -> int:
        total = 0
        for _ in range(max_rounds):
            n = self.tick()
            total += n
            if n == 0:
                break
        return total

    def kubelet_for(self, node_name: str) -> Optional[HollowKubelet]:
        for k in self.kubelets:
            if k.node_name == node_name:
                return k
        return None
