"""DeltaFIFO (client-go tools/cache/delta_fifo.go:97; an own copy of
``kubernetes_tpu/client/delta_fifo.py``).

A producer/consumer queue keyed by object key where each entry accumulates
the ordered list of deltas (Added/Updated/Deleted/Replaced/Sync) seen since
the consumer last popped that key. Replace() implements the relist
reconciliation: it emits Replaced for every listed object and synthesizes
Deleted for known objects missing from the list (delta_fifo.go:515 Replace).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

ADDED = "Added"
UPDATED = "Updated"
DELETED = "Deleted"
REPLACED = "Replaced"
SYNC = "Sync"


@dataclass(frozen=True)
class Delta:
    type: str
    object: object


class DeltaFIFO:
    def __init__(self, key_fn: Callable[[object], str], known_objects: Optional[Callable[[], List[str]]] = None):
        """key_fn: object → cache key. known_objects: () → keys the consumer's
        store currently holds (for Replace's deleted-object detection)."""
        self._key_fn = key_fn
        self._known = known_objects
        self._lock = threading.Condition()
        self._items: Dict[str, List[Delta]] = {}
        self._queue: List[str] = []
        self.populated = False
        self.initial_population_count = 0

    def _key_of(self, obj) -> str:
        return self._key_fn(obj)

    def _queue_action(self, action: str, obj) -> None:  # ktpu: locked
        key = self._key_of(obj)
        deltas = self._items.get(key)
        if deltas is None:
            self._items[key] = [Delta(action, obj)]
            self._queue.append(key)
        else:
            deltas.append(Delta(action, obj))
            self._dedup(key)
        self._lock.notify_all()

    def _dedup(self, key: str) -> None:  # ktpu: locked
        """Collapse two consecutive Deleted deltas (delta_fifo.go dedupDeltas)."""
        deltas = self._items[key]
        if len(deltas) >= 2 and deltas[-1].type == DELETED and deltas[-2].type == DELETED:
            self._items[key] = deltas[:-2] + [deltas[-1]]

    def add(self, obj) -> None:
        with self._lock:
            self.populated = True
            self._queue_action(ADDED, obj)

    def update(self, obj) -> None:
        with self._lock:
            self.populated = True
            self._queue_action(UPDATED, obj)

    def delete(self, obj) -> None:
        with self._lock:
            self.populated = True
            self._queue_action(DELETED, obj)

    def replace(self, objects: List[object]) -> None:
        """Relist reconciliation (delta_fifo.go:515): Replaced for each listed
        object; synthesized Deleted for known-but-absent objects."""
        with self._lock:
            keys = set()
            for obj in objects:
                keys.add(self._key_of(obj))
                self._queue_action(REPLACED, obj)
            # Union of the consumer store's keys AND keys with queued un-popped
            # deltas: a key whose Added is still queued but which is absent
            # from the relist would otherwise never get a tombstone, leaving a
            # deleted object in the informer cache until the next relist
            # (client-go's Replace scans queued items for exactly this case).
            known = set(self._known()) if self._known is not None else set()
            known.update(self._items.keys())
            for key in known:
                if key not in keys:
                    # deleted while we were disconnected; tombstone carries
                    # the last known object if any
                    deltas = self._items.get(key)
                    last = deltas[-1].object if deltas else None
                    if last is None and self._known is not None:
                        last = key  # DeletedFinalStateUnknown analog: key only
                    if deltas is None:
                        self._items[key] = [Delta(DELETED, last)]
                        self._queue.append(key)
                    else:
                        deltas.append(Delta(DELETED, last))
                        self._dedup(key)
            if not self.populated:
                self.populated = True
                self.initial_population_count = len(self._queue)
            self._lock.notify_all()

    def pop(self, timeout: float = 0.0) -> Optional[List[Delta]]:
        """Pop the oldest key's accumulated deltas; None when empty after
        timeout (the reference blocks; callers here pump)."""
        with self._lock:
            if not self._queue and timeout > 0:
                self._lock.wait(timeout)
            if not self._queue:
                return None
            key = self._queue.pop(0)
            deltas = self._items.pop(key)
            if self.initial_population_count > 0:
                self.initial_population_count -= 1
            return deltas

    def has_synced(self) -> bool:
        """True once the initial Replace has been fully popped
        (delta_fifo.go HasSynced)."""
        with self._lock:
            return self.populated and self.initial_population_count == 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)
