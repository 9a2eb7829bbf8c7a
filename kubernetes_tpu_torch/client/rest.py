"""REST list+watch client (client-go rest.Request and the Reflector's
remote half; an own copy of ``kubernetes_tpu/client/rest.py``).

``APIClient`` is store-shaped for the read path: ``list_objects(kind)`` and
``watch(kind, since)`` against the HTTP front (``apiserver/http.py``, the
port's or the JAX package's), so Reflector, SharedInformerFactory and the
controllers run unchanged across a network boundary:

    factory = SharedInformerFactory(APIClient("http://127.0.0.1:6443"))

The watch is the chunked JSON-lines stream resumed at a resourceVersion; a
410 raises ``Expired`` and so does a dropped stream, and the reflector
relists (reflector.go:254). ``token`` (the port's addition) sends
``Authorization: Bearer <token>`` with every request, for a front with
token authentication and RBAC.

``RESTWatch.stop`` shuts the stream's socket down before it closes the
response, so a reader thread blocked on an idle stream wakes at once; the
JAX watch closes the response only, which waits for that read to end
(ROADMAP C34).
"""

from __future__ import annotations

import http.client
import io
import json
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ..api import types as api_types
from ..api.codec import from_wire
from ..apiserver.http import RESOURCES
from ..apiserver.store import Expired, WatchEvent

# kind -> (group path, plural) from the server's routing table
_PATH_OF = {kind: (group, plural) for (group, plural), kind in RESOURCES.items()}


def _decode(kind: str, wire: dict):
    cls = getattr(api_types, kind, None)
    if cls is None:
        raise TypeError(f"unknown kind {kind!r}")
    return from_wire(cls, wire)


class RESTWatch:
    """watch.Interface over the chunked JSON-lines stream: a reader thread
    fills a queue, ``next(timeout)`` pops it; a stream that ended raises
    ``Expired``. The Reflector consumes it as a store's Watch."""

    def __init__(self, url: str, kind: str, headers: Optional[Dict[str, str]] = None):
        self.kind = kind
        self._events: Deque[WatchEvent] = deque()
        self._cond = threading.Condition()
        self.stopped = False
        self._error: Optional[Exception] = None
        parts = urllib.parse.urlsplit(url)
        self._conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=300)
        self._conn.request("GET", f"{parts.path}?{parts.query}", headers=headers or {})
        self._sock = self._conn.sock
        self._resp = self._conn.getresponse()
        if self._resp.status != 200:
            body = self._resp.read()
            self._conn.close()
            raise urllib.error.HTTPError(url, self._resp.status, self._resp.reason,
                                         self._resp.headers, io.BytesIO(body))
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"restwatch-{kind}")
        self._thread.start()

    def _read_loop(self) -> None:
        try:
            # stop() shuts the socket down to end the blocking readline
            while not self.stopped:
                line = self._resp.readline()
                if not line:
                    break  # the server closed the stream
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    continue
                ev = WatchEvent(seq=int(doc.get("resourceVersion", 0)), type=doc["type"],
                                object=_decode(self.kind, doc["object"]))
                with self._cond:
                    self._events.append(ev)
                    self._cond.notify_all()
        except Exception as exc:  # noqa: BLE001 — a dead transport reads as Expired
            self._error = exc
        finally:
            with self._cond:
                self.stopped = True
                self._cond.notify_all()

    def next(self, timeout: float = 0.0) -> Optional[WatchEvent]:
        with self._cond:
            if not self._events and not self.stopped and timeout:
                self._cond.wait(timeout)
            if self._events:
                return self._events.popleft()
            if self.stopped:
                # a dead stream is not "no events": the reflector relists
                raise Expired(f"watch stream for {self.kind} ended"
                              + (f": {self._error}" if self._error else ""))
            return None

    def stop(self) -> None:
        # under the cond: a consumer waiting in next() wakes now
        with self._cond:
            self.stopped = True
            self._cond.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # the server ended the stream first
        self._conn.close()


class APIClient:
    """The store-shaped REST read client (``list_objects``, ``watch``) of
    one server."""

    def __init__(self, server: str, token: str = ""):
        self.server = server.rstrip("/")
        self.headers = {"Authorization": f"Bearer {token}"} if token else {}

    def _collection_url(self, kind: str) -> str:
        group, plural = _PATH_OF[kind]
        return f"{self.server}/{group}/{plural}"

    def list_objects(self, kind: str) -> Tuple[list, int]:
        req = urllib.request.Request(self._collection_url(kind), headers=self.headers)
        with urllib.request.urlopen(req, timeout=30) as r:
            doc = json.loads(r.read())
        rv = int(doc.get("metadata", {}).get("resourceVersion", 0))
        return [_decode(kind, item) for item in doc.get("items", ())], rv

    def watch(self, kind: str, since: int) -> RESTWatch:
        url = f"{self._collection_url(kind)}?watch=1&resourceVersion={since}"
        try:
            return RESTWatch(url, kind, self.headers)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise Expired(f"resourceVersion {since} expired") from e
            raise
