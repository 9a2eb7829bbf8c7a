"""Event recorder: user-visible events (an own copy of
``kubernetes_tpu/utils/events.py``).

Analog of client-go tools/events (event_broadcaster.go:162 NewRecorder) with
the series-deduplication the events API performs: repeated (object, reason,
note) tuples within the dedup window increment a count instead of appending.
The scheduler emits 'Scheduled' and 'FailedScheduling' exactly where the
reference does (schedule_one.go:263 bind success, :292 skip, :843 failure).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"


@dataclass
class Event:
    object_key: str
    reason: str
    note: str
    type: str = TYPE_NORMAL
    action: str = ""
    count: int = 1
    first_timestamp: float = field(default_factory=time.time)
    last_timestamp: float = field(default_factory=time.time)


class EventRecorder:
    def __init__(self, dedup_window: float = 600.0, now_fn=time.time,
                 store=None, reporting_controller: str = ""):
        """``store``: when given, events also persist as core/v1 Event
        objects through the store (the events API write path,
        event_broadcaster.go:162 — kubectl get events then shows them and
        the EventRateLimit admission plugin can meter them); series dedup
        updates the stored object's count instead of creating anew."""
        self.events: List[Event] = []
        self._index: Dict[Tuple[str, str, str], int] = {}
        self.dedup_window = dedup_window
        self.now_fn = now_fn
        self.store = store
        self.reporting_controller = reporting_controller
        self._stored_keys: Dict[Tuple[str, str, str], str] = {}

    def eventf(self, object_key: str, ev_type: str, reason: str, action: str, note: str) -> None:
        key = (object_key, reason, note)
        now = self.now_fn()
        i = self._index.get(key)
        if i is not None and now - self.events[i].last_timestamp < self.dedup_window:
            self.events[i].count += 1
            self.events[i].last_timestamp = now
            self._persist(key, self.events[i])
            return
        self._index[key] = len(self.events)
        ev = Event(object_key, reason, note, ev_type, action, 1, now, now)
        self.events.append(ev)
        # a NEW series must create a new stored object — a stale stored-key
        # from an expired series would be overwritten (count reset, history
        # destroyed) by the update path
        self._stored_keys.pop(key, None)
        self._persist(key, ev)

    def _persist(self, key, ev: Event) -> None:
        if self.store is None:
            return
        import dataclasses as _dc

        from ..api import types as api_types

        ns, _, obj_name = ev.object_key.partition("/")
        if not obj_name:
            ns, obj_name = "default", ev.object_key
        store_key = self._stored_keys.get(key)
        try:
            if store_key is not None and self.store.events.get(store_key) is not None:
                cur = self.store.events[store_key]
                new = _dc.replace(cur, count=ev.count,
                                  last_timestamp=ev.last_timestamp)
                new.meta = _dc.replace(cur.meta)
                self.store.update_object("Event", new)
                return
            # reason in the name: two distinct events for one object in the
            # same microsecond must not collide (the silent-Conflict path
            # would drop the second series entirely)
            name = f"{obj_name}.{ev.reason.lower()}.{int(ev.first_timestamp * 1e6):x}"
            obj = api_types.Event(
                meta=api_types.ObjectMeta(name=name, namespace=ns),
                involved_object=ev.object_key, reason=ev.reason,
                message=ev.note, type=ev.type, count=ev.count,
                first_timestamp=ev.first_timestamp,
                last_timestamp=ev.last_timestamp,
                reporting_controller=self.reporting_controller)
            self.store.create_object("Event", obj)
            self._stored_keys[key] = obj.meta.key()
        except Exception:  # noqa: BLE001 — event loss must never break the
            pass           # component emitting it (rate-limited, conflicts)

    def for_object(self, object_key: str) -> List[Event]:
        return [e for e in self.events if e.object_key == object_key]
