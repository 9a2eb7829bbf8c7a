"""The store's write-ahead log and snapshot (an own copy of
``kubernetes_tpu/apiserver/wal.py``): the etcd WAL's role
(etcd3/store.go:72, 328) for the in-memory ``Store``.

* ``WriteAheadLog``: an append-only file of JSON records fed by the store's
  one mutation funnel (``Store._journal_event``, called inside every
  write's critical section), so the log's order is the store's write
  order. Each line is ``<crc32 hex> <json>``: replay tells a torn tail
  (the process died mid-write) from a clean record. ``append_batch`` is the
  group commit: a scheduler batch's binds in one line (one write and flush)
  whose records replay one by one; a batch of one writes the per-record
  form.
* ``snapshot``: the compaction. The store's objects go to ``path + '.snap'``
  and the log is truncated, all under the store's lock. ``maybe_compact``
  runs it once ``KTPU_WAL_COMPACT_LINES`` lines (off by default) have
  accumulated since the last one; the scheduler's 1 s housekeeping calls it.
* ``restore``: a new ``Store`` from the snapshot and the log's replay, its
  counters past every restored resource version and journal sequence,
  with a fresh WAL at the same path, compacted to the restored state.

Records carry an object's wire form (``api/codec.py``) and its type's name,
resolved over ``api.types``, then ``apiserver.auth`` and
``apiserver.admission``. For the same writes both packages write the same
bytes (the codec's wire form is the packages' contract), so each restores
the other's log.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from typing import Iterator, Optional

from ..api.codec import from_wire, to_wire
from ..testing import locktrace

_SNAP_SUFFIX = ".snap"

logger = logging.getLogger(__name__)


def _resolve_type(type_name: str):
    from ..api import types as api_types
    from . import admission, auth

    for module in (api_types, auth, admission):
        cls = getattr(module, type_name, None)
        if cls is not None:
            return cls
    raise TypeError(f"WAL cannot resolve type {type_name!r}")


class WriteAheadLog:
    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self.records_appended = 0
        self.lines_written = 0  # group commits: lines <= records
        self.bytes_written = 0
        # the auto-compaction threshold (KTPU_WAL_COMPACT_LINES; 0 = off)
        self.compact_lines = int(os.environ.get("KTPU_WAL_COMPACT_LINES", "0") or 0)
        self._lines_at_compact = 0

    # ------------------------------------------------------------- appending

    @staticmethod
    def _record(seq: int, kind: str, event: str, key: str, obj) -> dict:
        rec = {"seq": seq, "kind": kind, "event": event, "key": key}
        if obj is not None:
            rec["type"] = type(obj).__name__
            rec["obj"] = to_wire(obj)
            rv = getattr(getattr(obj, "meta", None), "resource_version", None)
            if rv is not None:
                rec["rv"] = rv
        return rec

    def _write_line(self, body: str, n_records: int) -> None:
        # under the store's lock by contract: the log's order is the journal's
        line = f"{zlib.crc32(body.encode()):08x} {body}\n"
        locktrace.note_blocking("wal_append", self.path,
                                allowed="WAL order must match the store journal order")
        with self._lock:
            self._f.write(line)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self.records_appended += n_records
            self.lines_written += 1
            self.bytes_written += len(line.encode())

    def append(self, seq: int, kind: str, event: str, key: str, obj) -> None:
        self._write_line(json.dumps(self._record(seq, kind, event, key, obj)), 1)

    def append_batch(self, records) -> None:
        """One line for ``(seq, kind, event, key, obj)`` records in journal
        order (``{"batch": [...]}``); the crc covers the whole line, so a
        batch torn mid-write replays none of its records. One record writes
        the per-record form."""
        records = list(records)
        if not records:
            return
        if len(records) == 1:
            self.append(*records[0])
            return
        recs = [self._record(*r) for r in records]
        self._write_line(json.dumps({"batch": recs}), len(recs))

    def close(self) -> None:
        with self._lock:
            self._f.close()

    # ------------------------------------------------------------ compaction

    def snapshot(self, store) -> int:
        """The store's objects to ``path + '.snap'``, then the log
        truncated; returns the objects written. Both under the store's lock:
        a write between an unlocked dump and the truncation would be lost."""
        objs = []
        with store._lock:
            rv = store._rv
            seq = store._event_seq
            for kind in store.KINDS:
                for key, obj in store._kind_map(kind).items():
                    objs.append({"kind": kind, "key": key, "type": type(obj).__name__,
                                 "obj": to_wire(obj)})
            tmp = self.path + _SNAP_SUFFIX + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps({"rv": rv, "seq": seq}) + "\n")
                for rec in objs:
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, self.path + _SNAP_SUFFIX)
            with self._lock:
                self._f.close()
                self._f = open(self.path, "w", encoding="utf-8")  # truncate
                self._lines_at_compact = self.lines_written
        return len(objs)

    def maybe_compact(self, store) -> bool:
        """Compact once ``compact_lines`` lines have landed since the last
        compaction (never while the threshold is 0)."""
        if self.compact_lines <= 0:
            return False
        with self._lock:
            grown = self.lines_written - self._lines_at_compact
        if grown < self.compact_lines:
            return False
        self.snapshot(store)
        return True


def _parse_line(line: str) -> Optional[dict]:
    """A line's record, or None when torn or corrupt; a line without a crc
    (the log's first format) parses unguarded."""
    try:
        if len(line) > 9 and line[8] == " ":
            crc, body = line[:8], line[9:]
            try:
                expect = int(crc, 16)
            except ValueError:
                return json.loads(line)
            if zlib.crc32(body.encode()) != expect:
                return None
            return json.loads(body)
        return json.loads(line)
    except ValueError:
        return None


def replay(path: str) -> Iterator[dict]:
    """The log's records in append order, a batch's one by one; stops at the
    first torn or corrupt line (the durable prefix is what precedes it) and
    logs how many lines it drops after it."""
    if not os.path.exists(path):
        return
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            rec = _parse_line(line)
            if rec is None:
                trailing = sum(1 for rest in f if rest.strip())
                if trailing:
                    logger.warning("WAL %s: corrupt record at line %d with %d records after "
                                   "it; replaying the clean prefix only", path, i + 1, trailing)
                else:
                    logger.warning("WAL %s: torn tail at line %d (crash mid-append); "
                                   "stopping replay cleanly", path, i + 1)
                return
            batch = rec.get("batch")
            if isinstance(batch, list):
                yield from batch
                continue
            yield rec


def attach_wal(store, path: str, fsync: bool = False) -> WriteAheadLog:
    """A WAL on ``store``'s mutation funnel; returns it."""
    wal = WriteAheadLog(path, fsync=fsync)
    store._wal = wal
    return wal


def restore(path: str, store_factory=None):
    """A store rebuilt from the snapshot and the log (admission and the WAL
    hook off while replaying: the records passed admission when written),
    with a fresh WAL at ``path`` compacted to the restored state."""
    from .store import Store

    store = (store_factory or Store)()
    saved_admission, store.admission = store.admission, None
    max_rv = 0
    max_seq = 0

    def put(rec) -> None:
        obj = from_wire(_resolve_type(rec["type"]), rec["obj"])
        if rec["kind"] == "CustomResourceDefinition":
            store._register_crd_kind(obj)
        store._kind_map(rec["kind"])[rec["key"]] = obj

    try:
        snap_path = path + _SNAP_SUFFIX
        if os.path.exists(snap_path):
            with open(snap_path, encoding="utf-8") as f:
                header = json.loads(f.readline())
                max_rv = int(header.get("rv", 0))
                max_seq = int(header.get("seq", 0))
                for line in f:
                    put(json.loads(line))
        for rec in replay(path):
            if rec["event"] == "DELETED":
                store._kind_map(rec["kind"]).pop(rec["key"], None)
            else:
                put(rec)
                max_rv = max(max_rv, int(rec.get("rv", 0) or 0))
            max_seq = max(max_seq, int(rec.get("seq", 0) or 0))
    finally:
        store.admission = saved_admission
    store._rv = max(store._rv, max_rv)
    store._event_seq = max(store._event_seq, max_seq)
    # the kinds' write counters (``kind_version``) at their newest object
    for kind in store.KINDS:
        rvs = [getattr(o.meta, "resource_version", 0) or 0
               for o in store._kind_map(kind).values()]
        if rvs:
            store._kind_rv[kind] = max(rvs)
    wal = attach_wal(store, path)
    wal.snapshot(store)  # the restored state is the new baseline
    return store
