"""Zone tree: zone -> node names, with round-robin zone interleaving
(``kubernetes_tpu/cache/node_tree.py``; internal/cache/node_tree.go:32).

The snapshot's node list is materialized in this order, so the plugins
that walk it (preemption's candidate walk) visit the zones in turn."""

from __future__ import annotations

from typing import Dict, Iterable, List

from ..api.types import Node, get_zone_key


class NodeTree:
    """Per-zone node-name lists; ``list()`` yields the names one zone per
    round (node_tree.go updateNodesInTreeOrder)."""

    def __init__(self):
        self._zones: Dict[str, List[str]] = {}
        self._members: set = set()
        self.num_nodes = 0

    def add_node(self, node: Node) -> None:
        if node.meta.name in self._members:
            return
        self._zones.setdefault(get_zone_key(node), []).append(node.meta.name)
        self._members.add(node.meta.name)
        self.num_nodes += 1

    def list(self) -> List[str]:
        out: List[str] = []
        lists = list(self._zones.values())
        i = 0
        while len(out) < self.num_nodes:
            for names in lists:
                if i < len(names):
                    out.append(names[i])
            i += 1
        return out


def zone_interleaved(node_infos: Iterable) -> List:
    """NodeInfos in zone-round-robin order (the visit order of
    ``NodeTree.list()``, through a throwaway tree)."""
    by_name = {}
    tree = NodeTree()
    for ni in node_infos:
        by_name[ni.node.meta.name] = ni
        tree.add_node(ni.node)
    return [by_name[name] for name in tree.list()]
