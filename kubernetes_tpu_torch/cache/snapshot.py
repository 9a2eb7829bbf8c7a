"""Cache snapshot (``kubernetes_tpu/cache/snapshot.py``; internal/cache/
snapshot.go:29).

NodeInfos keyed by name, as ``DeviceState.sync`` consumes them: a version
that bumps on membership changes, one that bumps whenever a node object is
set or removed (the volume screen's label index keys on both), the names
changed since the device last consumed them, and the lowest priority of a
bound pod (the preemption shortcut's test). ``BatchScheduler`` fills it
itself (``set`` / ``remove``); the scheduler loop's ``Cache.update_snapshot``
fills it from the cache, advancing ``generation`` and keeping the
zone-interleaved node list (``list()``) that the plugins walk.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

from ..api.types import get_zone_key
from ..framework.types import NodeInfo
from .node_tree import zone_interleaved


class Snapshot:
    def __init__(self, node_infos: Optional[Iterable[NodeInfo]] = None):
        self.node_info_map: Dict[str, NodeInfo] = {}
        self.node_info_list: List[NodeInfo] = []
        self.generation = 0
        self.changed_names: Set[str] = set()
        self.structure_version: int = 0
        self.node_object_version: int = 0
        # the interleave order depends only on (name, zone) membership:
        # pod-only churn keeps it and patches the changed positions
        self._order: List[str] = []
        self._pos: Dict[str, int] = {}
        self._zone_of: Dict[str, str] = {}
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

    def list(self) -> List[NodeInfo]:
        """The nodes in zone-interleaved order (as of the last refresh)."""
        return self.node_info_list

    def order_affected_by(self, name: str, node) -> bool:
        """Would replacing ``name``'s NodeInfo (whose node is ``node``)
        change the interleave order? True for new names, removals and zone
        changes."""
        prev_zone = self._zone_of.get(name)
        return node is None or prev_zone is None or get_zone_key(node) != prev_zone

    def refresh_lists(self, structural: bool = True,
                      changed_names: Optional[Set[str]] = None) -> None:
        """Rebuild the node list from ``node_info_map`` in zone-round-robin
        order. ``structural`` False promises that no node was added,
        removed or moved to another zone: the order is kept and only the
        ``changed_names`` positions are patched."""
        if structural or not self._order:
            self.structure_version += 1
            self.node_info_list = zone_interleaved(
                ni for ni in self.node_info_map.values() if ni.node is not None)
            self._order = [ni.node.meta.name for ni in self.node_info_list]
            self._pos = {name: i for i, name in enumerate(self._order)}
            self._zone_of = {ni.node.meta.name: get_zone_key(ni.node)
                             for ni in self.node_info_list}
        elif changed_names is not None:
            lst, m, pos = self.node_info_list, self.node_info_map, self._pos
            for name in changed_names:
                i = pos.get(name)
                if i is not None:
                    lst[i] = m[name]
        else:
            self.node_info_list = [self.node_info_map[name] for name in self._order]

    def min_pod_priority(self) -> Optional[int]:
        """The lowest priority among the pods on the nodes, or None when no
        pod is bound: a pod at or below it has no preemption victim
        anywhere. Read from each NodeInfo's priority buckets, which
        ``add_pod`` and ``remove_pod`` both maintain."""
        return min((p for ni in self.node_info_map.values() for p in ni.prio_requested),
                   default=None)
