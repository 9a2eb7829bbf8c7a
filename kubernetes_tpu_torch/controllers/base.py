"""Controller base: informer → workqueue → reconcile worker
(the pkg/controller pattern: handlers enqueue keys, N workers drain; an
own copy of ``kubernetes_tpu/controllers/base.py``).
"""

from __future__ import annotations

import logging
from typing import Iterable, List

from ..client.workqueue import RateLimitingQueue

logger = logging.getLogger(__name__)

MAX_RETRIES = 5


class Controller:
    """Level-triggered reconciler. Subclasses set ``watch_kinds``, implement
    ``keys_for(kind, obj)`` (object → reconcile keys) and ``reconcile(key)``."""

    name = "controller"
    watch_kinds: Iterable[str] = ()

    def __init__(self, store, factory):
        self.store = store
        self.factory = factory
        self.queue = RateLimitingQueue()
        for kind in self.watch_kinds:
            inf = factory.informer_for(kind)
            inf.add_event_handler(self._make_handler(kind))

    def _make_handler(self, kind: str):
        def _handle(event, old, new):
            # enqueue for BOTH old and new shapes of the object: an update
            # that changes labels/owners must re-reconcile what the old
            # object mapped to as well (e.g. a pod leaving a service's
            # selector must trigger that service's Endpoints rebuild)
            keys = set()
            for obj in (old, new):
                if obj is not None:
                    keys.update(self.keys_for(kind, obj, event))
            for key in keys:
                self.queue.add(key)

        return _handle

    # -- override points

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        """Map a watched object to the keys this controller reconciles."""
        return [self._key(obj)]

    def reconcile(self, key: str) -> None:
        raise NotImplementedError

    def tick(self) -> None:
        """Time-driven hook, called once per manager sync round (the
        reference's interval syncAll pattern). Default: nothing."""

    # -- driving

    @staticmethod
    def _key(obj) -> str:
        meta = obj.meta
        return meta.key()

    def sync_once(self, max_items: int = 10000) -> int:
        """Drain the queue through reconcile; failed keys requeue with
        backoff up to MAX_RETRIES (the worker-pool processNextWorkItem loop)."""
        self.queue.flush_waiting()
        n = 0
        while n < max_items:
            key = self.queue.get()
            if key is None:
                break
            n += 1
            try:
                self.reconcile(key)
            except Exception:  # noqa: BLE001
                if self.queue.num_requeues(key) < MAX_RETRIES:
                    logger.exception("%s: reconcile %s failed; requeueing", self.name, key)
                    self.queue.add_rate_limited(key)
                else:
                    logger.exception("%s: reconcile %s dropped after retries", self.name, key)
                    self.queue.forget(key)
            else:
                self.queue.forget(key)
            finally:
                self.queue.done(key)
        return n
