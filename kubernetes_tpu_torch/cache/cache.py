"""Scheduler cache: the assume / confirm / expire state machine of pods and
the incremental snapshot (``kubernetes_tpu/cache/cache.py``;
internal/cache/cache.go).

    assume_pod -> (finish_binding -> expire after the TTL | add_pod
                   confirms | forget_pod removes)

An assumed pod counts on its node at once, so the next cycle sees it.
``cleanup(now)`` sweeps assumptions whose binding finished but was never
confirmed (cache.go:731, called by the loop's housekeeping). Every
NodeInfo change bumps its generation, and ``update_snapshot`` clones only
the nodes changed since the snapshot's generation (cache.go:198).

Every public method runs under the cache's RLock (``:45``): the ring's
commit worker assumes, binds and reconciles on its own thread while the
scheduling thread updates its snapshot. The histogram of bound pods'
priorities is kept exact: a pod's count leaves with the pod even when its
node entry is already gone (the JAX copy decrements only while the entry
exists).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..api.types import Node, Pod
from ..framework.types import NodeInfo, next_generation
from .snapshot import Snapshot

DEFAULT_ASSUME_TTL = 30.0  # durationToExpireAssumedPod (scheduler.go:311)


def _locked(fn):
    """Run a public method under the cache's RLock (reentrant: the methods
    call each other)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


@dataclasses.dataclass
class _PodState:
    pod: Pod
    assumed: bool = False
    binding_finished: bool = False
    deadline: Optional[float] = None


class Cache:
    def __init__(self, ttl: float = DEFAULT_ASSUME_TTL, now_fn=time.monotonic):
        self._lock = threading.RLock()
        self.ttl = ttl
        self.now_fn = now_fn
        self.nodes: Dict[str, NodeInfo] = {}
        self.pod_states: Dict[str, _PodState] = {}
        self._assumed: Set[str] = set()
        # names changed or removed since the last update_snapshot
        self._dirty: Set[str] = set()
        self._removed: Set[str] = set()
        self._sync_generation = 0
        self._prio_counts: Dict[int, int] = {}  # priority -> bound pods
        self._real_nodes = 0  # entries with a Node object (ghosts excluded)

    # ------------------------------------------------------------- pods

    @_locked
    def assume_pod(self, pod: Pod, node_name: str) -> None:
        """Commit ``pod`` to ``node_name`` ahead of the bind. Takes the
        passed object (callers pass a clone) and sets its ``node_name``."""
        key = pod.key()
        if key in self.pod_states:
            raise KeyError(f"pod {key} already in cache")
        pod.spec.node_name = node_name
        self._add_pod_to_node(pod, node_name)
        self.pod_states[key] = _PodState(pod=pod, assumed=True)
        self._assumed.add(key)

    @_locked
    def finish_binding(self, pod: Pod) -> None:
        ps = self.pod_states.get(pod.key())
        if ps and ps.assumed:
            ps.binding_finished = True
            ps.deadline = self.now_fn() + self.ttl

    @_locked
    def forget_pod(self, pod: Pod) -> None:
        """The bind failed: roll the assumption back (cache.go:416)."""
        ps = self.pod_states.pop(pod.key(), None)
        self._assumed.discard(pod.key())
        if ps is not None:
            self._remove_pod_from_node(ps.pod, ps.pod.spec.node_name)

    @_locked
    def add_pod(self, pod: Pod) -> None:
        """The informer's confirmation of a bound pod (cache.go:497)."""
        key = pod.key()
        ps = self.pod_states.get(key)
        if ps is not None and ps.assumed:
            if ps.pod.spec.node_name != pod.spec.node_name:
                self._remove_pod_from_node(ps.pod, ps.pod.spec.node_name)
                self._add_pod_to_node(pod, pod.spec.node_name)
            self.pod_states[key] = _PodState(pod=pod)
            self._assumed.discard(key)
            return
        if ps is not None:
            return  # a duplicate add
        self._add_pod_to_node(pod, pod.spec.node_name)
        self.pod_states[key] = _PodState(pod=pod)

    @_locked
    def update_pod(self, old: Pod, new: Pod) -> None:
        ps = self.pod_states.get(old.key())
        if ps is None:
            self.add_pod(new)
            return
        self._remove_pod_from_node(ps.pod, ps.pod.spec.node_name)
        self._add_pod_to_node(new, new.spec.node_name)
        self.pod_states[old.key()] = _PodState(pod=new)

    @_locked
    def remove_pod(self, pod: Pod) -> None:
        ps = self.pod_states.pop(pod.key(), None)
        self._assumed.discard(pod.key())
        if ps is not None:
            self._remove_pod_from_node(ps.pod, ps.pod.spec.node_name)

    @_locked
    def is_assumed(self, pod_key: str) -> bool:
        ps = self.pod_states.get(pod_key)
        return bool(ps and ps.assumed)

    @_locked
    def cleanup(self, now: Optional[float] = None) -> List[Pod]:
        """Expire assumed pods whose binding finished and was never
        confirmed; returns them (cleanupAssumedPods, cache.go:735)."""
        now = self.now_fn() if now is None else now
        expired = []
        for key in list(self._assumed):
            ps = self.pod_states.get(key)
            if ps and ps.binding_finished and ps.deadline is not None and now > ps.deadline:
                expired.append(ps.pod)
                self.pod_states.pop(key)
                self._assumed.discard(key)
                self._remove_pod_from_node(ps.pod, ps.pod.spec.node_name)
        return expired

    # ------------------------------------------------------------- nodes

    @_locked
    def add_node(self, node: Node) -> None:
        ni = self.nodes.get(node.meta.name)
        if ni is None:
            ni = NodeInfo()
            self.nodes[node.meta.name] = ni
        if ni.node is None:
            self._real_nodes += 1
        ni.set_node(node)
        self._dirty.add(node.meta.name)
        self._removed.discard(node.meta.name)

    @_locked
    def update_node(self, node: Node) -> None:
        self.add_node(node)

    @_locked
    def remove_node(self, node_name: str) -> None:
        ni = self.nodes.get(node_name)
        if ni is None:
            return
        # a node with pods left stays as a ghost entry until they go
        if ni.node is not None:
            self._real_nodes -= 1
        ni.node = None
        ni.generation = next_generation()
        self._dirty.add(node_name)
        if not ni.pods:
            del self.nodes[node_name]
            self._dirty.discard(node_name)
            self._removed.add(node_name)

    def _add_pod_to_node(self, pod: Pod, node_name: str) -> None:
        if not node_name:
            return
        ni = self.nodes.get(node_name)
        if ni is None:
            ni = NodeInfo()  # the pod arrived before its node: a ghost entry
            self.nodes[node_name] = ni
        ni.add_pod(pod)
        self._dirty.add(node_name)
        self._removed.discard(node_name)
        prio = pod.spec.priority
        self._prio_counts[prio] = self._prio_counts.get(prio, 0) + 1

    def _remove_pod_from_node(self, pod: Pod, node_name: str) -> None:
        if not node_name:
            return
        prio = pod.spec.priority
        left = self._prio_counts.get(prio, 0) - 1
        if left > 0:
            self._prio_counts[prio] = left
        else:
            self._prio_counts.pop(prio, None)
        ni = self.nodes.get(node_name)
        if ni is None:
            return
        ni.remove_pod(pod)
        self._dirty.add(node_name)
        if ni.node is None and not ni.pods:
            self.nodes.pop(node_name, None)
            self._dirty.discard(node_name)
            self._removed.add(node_name)

    # ------------------------------------------------------------- snapshot

    @_locked
    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """Clone into ``snapshot`` only the NodeInfos changed since its
        generation, O(changes); a snapshot older than the dirty set's
        horizon (a new one) gets every node. New names join the map in
        the cache's order on a full update, and in the iteration order of
        the changed-name set on an incremental one, as in the reference:
        that order follows the process's string hashing, and with it the
        device slots (``DeviceState.sync``), so placements that turn on
        the smaller-index tie repeat within one process only."""
        max_gen = snapshot.generation
        changed = False
        full = snapshot.generation < self._sync_generation
        # structural: a node joined, left or changed zone, so the
        # interleave order is rebuilt; pod-only churn keeps it
        structural = full
        batch_changed: Set[str] = set()
        names = self.nodes.keys() if full else (self._dirty | self._removed)
        for name in list(names):
            ni = self.nodes.get(name)
            if ni is None:
                if name in snapshot.node_info_map:
                    del snapshot.node_info_map[name]
                    snapshot.changed_names.add(name)
                    batch_changed.add(name)
                    changed = structural = True
                continue
            if ni.generation > snapshot.generation:
                if not structural and snapshot.order_affected_by(name, ni.node):
                    structural = True
                prev = snapshot.node_info_map.get(name)
                if prev is None or prev.node is not ni.node:
                    snapshot.node_object_version += 1
                snapshot.node_info_map[name] = ni.clone()
                snapshot.changed_names.add(name)
                batch_changed.add(name)
                max_gen = max(max_gen, ni.generation)
                changed = True
        if full:
            for name in [n for n in snapshot.node_info_map if n not in self.nodes]:
                del snapshot.node_info_map[name]
                snapshot.changed_names.add(name)
                batch_changed.add(name)
                changed = True
        self._dirty.clear()
        self._removed.clear()
        self._sync_generation = max_gen
        if changed:
            snapshot.refresh_lists(structural=structural, changed_names=batch_changed)
        snapshot.generation = max_gen
        return snapshot

    @_locked
    def min_pod_priority(self) -> Optional[int]:
        """The lowest priority among the pods bound to nodes, or None."""
        return min(self._prio_counts) if self._prio_counts else None

    @_locked
    def node_count(self) -> int:
        return self._real_nodes

    @_locked
    def missing_real_nodes(self, names: Iterable[str]) -> Set[str]:
        """The names in ``names`` with no live Node object (ghost entries
        count as missing): the commit's check that a winner's node is
        still there."""
        out = set()
        for name in names:
            ni = self.nodes.get(name)
            if ni is None or ni.node is None:
                out.add(name)
        return out

    @_locked
    def stats(self) -> Tuple[int, int, int]:
        """(nodes, pods, assumed pods)."""
        return self._real_nodes, len(self.pod_states), len(self._assumed)
