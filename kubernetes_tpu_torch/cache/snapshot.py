"""Cache snapshot as the device mirror reads it (internal/cache/snapshot.go:29).

The subset of ``kubernetes_tpu/cache/snapshot.py`` that ``DeviceState.sync``
consumes: NodeInfos keyed by name, a version that bumps on membership
changes, one that bumps whenever a node object is set or removed (the
volume screen's label index keys on both), the names changed since the
device last consumed them, and the lowest priority of a bound pod (the
preemption shortcut's test).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set

from ..framework.types import NodeInfo


class Snapshot:
    def __init__(self, node_infos: Optional[Iterable[NodeInfo]] = None):
        self.node_info_map: Dict[str, NodeInfo] = {}
        self.changed_names: Set[str] = set()
        self.structure_version: int = 0
        self.node_object_version: int = 0
        for ni in node_infos or ():
            self.set(ni)

    def set(self, ni: NodeInfo) -> None:
        """Add or replace a node's NodeInfo."""
        name = ni.node.meta.name
        if name not in self.node_info_map:
            self.structure_version += 1
        self.node_object_version += 1
        self.node_info_map[name] = ni
        self.changed_names.add(name)

    def remove(self, name: str) -> None:
        if self.node_info_map.pop(name, None) is not None:
            self.structure_version += 1
            self.node_object_version += 1
            self.changed_names.add(name)

    def min_pod_priority(self) -> Optional[int]:
        """The lowest priority among the pods on the nodes, or None when no
        pod is bound: a pod at or below it has no preemption victim
        anywhere. Read from each NodeInfo's priority buckets, which
        ``add_pod`` and ``remove_pod`` both maintain (the JAX cache's
        histogram is decremented only while the node entry exists)."""
        return min((p for ni in self.node_info_map.values() for p in ni.prio_requested),
                   default=None)
