"""Reflector (client-go tools/cache/reflector.go:49; an own copy of
``kubernetes_tpu/client/reflector.py`` over the port's ``Store``).

ListAndWatch one kind from the store into a DeltaFIFO: LIST at a
resourceVersion, Replace() the FIFO, then stream WATCH events; on a watch
expiry (410 Gone) relist from scratch (reflector.go:254,440).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..apiserver.store import ADDED, DELETED, Expired, MODIFIED, Watch
from .delta_fifo import DeltaFIFO

logger = logging.getLogger(__name__)


class Reflector:
    def __init__(self, store, kind: str, fifo: DeltaFIFO):
        self.store = store
        self.kind = kind
        self.fifo = fifo
        self.last_sync_rv = 0
        self._watch: Optional[Watch] = None
        self._stop = threading.Event()

    # -- the ListAndWatch pieces, callable stepwise (tests/pump) or via run()

    def list_and_establish_watch(self) -> None:
        """LIST → fifo.Replace → open WATCH at the list rv (reflector.go:254)."""
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
        objects, rv = self.store.list_objects(self.kind)
        self.fifo.replace(objects)
        self.last_sync_rv = rv
        self._watch = self.store.watch(self.kind, since=rv)

    def step(self, timeout: float = 0.0) -> int:
        """Drain available watch events into the FIFO; returns count.
        Re-lists transparently on journal expiry (the 410 path)."""
        if self._watch is None:
            self.list_and_establish_watch()
        assert self._watch is not None
        n = 0
        while True:
            ev = self._watch.next(timeout=timeout if n == 0 else 0.0)
            if ev is None:
                return n
            n += 1
            self.last_sync_rv = ev.seq
            if ev.type == ADDED:
                self.fifo.add(ev.object)
            elif ev.type == MODIFIED:
                self.fifo.update(ev.object)
            elif ev.type == DELETED:
                self.fifo.delete(ev.object)

    def relist(self) -> None:
        """Forced relist (watch error / Expired): reconcile via Replace."""
        try:
            self.list_and_establish_watch()
        except Expired:
            logger.warning("reflector %s: relist raced with compaction; retrying", self.kind)
            self.list_and_establish_watch()

    def run(self, poll_interval: float = 0.05) -> threading.Thread:
        """Background ListAndWatch loop (Reflector.Run)."""

        def _loop():
            while not self._stop.is_set():
                try:
                    self.step(timeout=poll_interval)
                except Expired:
                    self.relist()

        t = threading.Thread(target=_loop, name=f"reflector-{self.kind}", daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
