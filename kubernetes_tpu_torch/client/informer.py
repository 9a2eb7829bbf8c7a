"""Shared informers (client-go tools/cache/shared_informer.go:302; an own
copy of ``kubernetes_tpu/client/informer.py`` over the port's ``Store``).

SharedIndexInformer = Reflector → DeltaFIFO → thread-safe indexed store →
handler fan-out. New handlers added after sync receive synthetic Adds for
every cached object (shared_informer.go:397 AddEventHandler). The
SharedInformerFactory dedups informers per kind (informers/factory.go).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .delta_fifo import ADDED, DELETED, REPLACED, SYNC, UPDATED, Delta, DeltaFIFO
from .reflector import Reflector

# handler callbacks: (event, old, new); event one of "add"/"update"/"delete"
EventHandler = Callable[[str, Optional[object], Optional[object]], None]

Indexer = Callable[[object], List[str]]


class ThreadSafeStore:
    """Indexed object cache (tools/cache/thread_safe_store.go)."""

    def __init__(self, indexers: Optional[Dict[str, Indexer]] = None):
        self._lock = threading.RLock()
        self._items: Dict[str, object] = {}
        self._indexers: Dict[str, Indexer] = dict(indexers or {})
        self._indices: Dict[str, Dict[str, set]] = {name: {} for name in self._indexers}

    def _update_index(self, key: str, old, new) -> None:
        for name, fn in self._indexers.items():
            index = self._indices[name]
            if old is not None:
                for v in fn(old):
                    s = index.get(v)
                    if s is not None:
                        s.discard(key)
                        if not s:
                            del index[v]
            if new is not None:
                for v in fn(new):
                    index.setdefault(v, set()).add(key)

    def add(self, key: str, obj) -> None:
        with self._lock:
            old = self._items.get(key)
            self._items[key] = obj
            self._update_index(key, old, obj)

    def delete(self, key: str) -> None:
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._update_index(key, old, None)

    def get(self, key: str):
        with self._lock:
            return self._items.get(key)

    def list(self) -> List[object]:
        with self._lock:
            return list(self._items.values())

    def list_keys(self) -> List[str]:
        with self._lock:
            return list(self._items.keys())

    def by_index(self, index_name: str, value: str) -> List[object]:
        with self._lock:
            keys = self._indices.get(index_name, {}).get(value, set())
            return [self._items[k] for k in keys if k in self._items]


class SharedIndexInformer:
    def __init__(self, store, kind: str, key_fn: Callable[[object], str],
                 indexers: Optional[Dict[str, Indexer]] = None):
        self.kind = kind
        self._key_fn = key_fn
        self.indexer = ThreadSafeStore(indexers)
        self.fifo = DeltaFIFO(key_fn, known_objects=self.indexer.list_keys)
        self.reflector = Reflector(store, kind, self.fifo)
        self._handlers: List[EventHandler] = []
        self._lock = threading.RLock()
        self._started = False

    # -- wiring

    def add_event_handler(self, handler: EventHandler) -> None:
        """Fan-out registration; replays synthetic adds for cached objects
        when registered after sync (shared_informer.go:397)."""
        with self._lock:
            self._handlers.append(handler)
            for obj in self.indexer.list():
                handler("add", None, obj)

    def start(self) -> None:
        # check-and-set under the lock: two consumers starting the shared
        # informer concurrently must not double-list (locks pass finding)
        with self._lock:
            if self._started:
                return
            self._started = True
        self.reflector.list_and_establish_watch()
        self.pump()

    def pump(self, max_items: int = 100000) -> int:
        """Drain reflector watch events + FIFO into the indexer/handlers.
        The synchronous analog of the informer's processLoop; cheap when idle."""
        self.reflector.step()
        n = 0
        while n < max_items:
            deltas = self.fifo.pop()
            if deltas is None:
                break
            n += 1
            self._handle_deltas(deltas)
        return n

    def _handle_deltas(self, deltas: List[Delta]) -> None:
        for d in deltas:
            if isinstance(d.object, str):  # tombstone key only
                key = d.object
                obj = self.indexer.get(key)
            else:
                key = self._key_fn(d.object)
                obj = d.object
            old = self.indexer.get(key)
            if d.type in (ADDED, UPDATED, REPLACED, SYNC):
                self.indexer.add(key, obj)
                event = "update" if old is not None else "add"
                self._fan_out(event, old, obj)
            elif d.type == DELETED:
                self.indexer.delete(key)
                if old is not None:
                    self._fan_out("delete", old, None)

    def _fan_out(self, event: str, old, new) -> None:
        with self._lock:
            handlers = list(self._handlers)
        for h in handlers:
            h(event, old, new)

    def has_synced(self) -> bool:
        with self._lock:  # pairs with start()'s check-and-set
            started = self._started
        return started and self.fifo.has_synced()

    # -- lister surface

    def get(self, key: str):
        return self.indexer.get(key)

    def list(self) -> List[object]:
        return self.indexer.list()


class SharedInformerFactory:
    """One informer per kind, shared by all consumers
    (informers/factory.go NewSharedInformerFactory)."""

    KEY_FNS: Dict[str, Callable[[object], str]] = {}

    def __init__(self, store):
        self.store = store
        self._informers: Dict[str, SharedIndexInformer] = {}
        self._lock = threading.RLock()

    def informer_for(self, kind: str, indexers: Optional[Dict[str, Indexer]] = None) -> SharedIndexInformer:
        # keying must agree with the store's CRUD: cluster-scoped kinds by
        # bare name, namespaced by ns/name (one shared set, the store's)
        from ..apiserver.store import CLUSTER_SCOPED_KINDS

        with self._lock:
            inf = self._informers.get(kind)
            if inf is None:
                key_fn = self.KEY_FNS.get(
                    kind,
                    (lambda o: o.meta.name)
                    if kind in CLUSTER_SCOPED_KINDS
                    else (lambda o: o.meta.key()),
                )
                inf = SharedIndexInformer(self.store, kind, key_fn, indexers)
                self._informers[kind] = inf
            return inf

    def start(self) -> None:
        """Start all registered informers (factory.Start)."""
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            inf.start()

    def pump(self) -> int:
        """Drive all informers one synchronous round; returns events handled."""
        with self._lock:
            informers = list(self._informers.values())
        return sum(inf.pump() for inf in informers)

    def wait_for_cache_sync(self) -> bool:
        self.start()
        self.pump()
        with self._lock:  # registration may race the sync check
            informers = list(self._informers.values())
        return all(inf.has_synced() for inf in informers)
