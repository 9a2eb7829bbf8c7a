"""OTel-style span tracing: an own copy of ``kubernetes_tpu/utils/
tracing.py`` (component-base/traces/utils.go NewProvider, the OTLP
exporter seam, without an OTLP endpoint).

A process-global tracer (None = disabled, the default: the disabled check
is one global read on the hot path). Spans nest per thread; finished spans
go to the exporter: in memory for tests, JSON lines for offline analysis
(OTLP-shaped dicts: traceId/spanId/parentSpanId/name/start/end/attributes,
loadable into any OTLP-compatible viewer).

    tracing.enable(JsonFileExporter("spans.jsonl"))
    with tracing.span("scheduling.cycle", pod="ns/p"):
        with tracing.span("device.dispatch"):
            ...

The scheduler loop wraps its cycle phases (snapshot, filter and score on
the sequential path; sync, encode, dispatch and commit on the batch path).
``KTPU_TRACE_FILE=<path>`` turns the JSON-lines export on at setup
(``maybe_enable_from_env``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from typing import List, Optional

_tracer: Optional["Tracer"] = None


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end",
                 "attributes")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attributes: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.start = time.time_ns()
        self.end = 0
        self.attributes = attributes

    def to_otlp(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_id or "",
            "name": self.name,
            "startTimeUnixNano": self.start,
            "endTimeUnixNano": self.end,
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in self.attributes.items()
            ],
        }

    @property
    def duration_s(self) -> float:
        return (self.end - self.start) / 1e9


class InMemoryExporter:
    def __init__(self):
        self.spans: List[Span] = []

    def export(self, span: Span) -> None:
        self.spans.append(span)

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class JsonFileExporter:
    """One OTLP-shaped JSON object per line."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def export(self, span: Span) -> None:
        with self._lock:
            self._f.write(json.dumps(span.to_otlp()) + "\n")
            self._f.flush()

    def close(self) -> None:
        self._f.close()


class Tracer:
    def __init__(self, exporter):
        self.exporter = exporter
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        stack = self._stack()
        if stack:
            trace_id, parent_id = stack[-1].trace_id, stack[-1].span_id
        else:
            trace_id, parent_id = uuid.uuid4().hex, None
        with self._run_span(name, trace_id, parent_id, attributes) as s:
            yield s

    @contextlib.contextmanager
    def span_remote(self, name: str, trace_id: str, parent_id: str,
                    **attributes):
        """A span whose parent lives in ANOTHER process (the W3C
        traceparent seam): the local thread stack starts from the remote
        context, so nested spans chain under the caller's trace."""
        with self._run_span(name, trace_id, parent_id, attributes) as s:
            yield s

    @contextlib.contextmanager
    def _run_span(self, name, trace_id, parent_id, attributes):
        stack = self._stack()
        s = Span(name, trace_id, parent_id, attributes)
        stack.append(s)
        try:
            yield s
        finally:
            s.end = time.time_ns()
            stack.pop()
            try:
                self.exporter.export(s)
            except Exception:  # noqa: BLE001 — tracing must never fail the
                pass           # operation it instruments (a full disk would
                               # otherwise read as device death upstream)


def enable(exporter=None) -> "Tracer":
    """Install the process tracer (None exporter = in-memory)."""
    global _tracer
    _tracer = Tracer(exporter or InMemoryExporter())
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def get() -> Optional[Tracer]:
    return _tracer


@contextlib.contextmanager
def span(name: str, **attributes):
    """No-op when tracing is disabled (one global read)."""
    t = _tracer
    if t is None:
        yield None
    else:
        with t.span(name, **attributes) as s:
            yield s


def current() -> Optional[Span]:
    """The active span on this thread, or None (disabled / no open span)."""
    t = _tracer
    if t is None:
        return None
    stack = t._stack()
    return stack[-1] if stack else None


def annotate(**attributes) -> None:
    """Attach attributes to the active span (no-op when tracing is disabled
    or no span is open — one global read). The device-telemetry layer uses
    this to ride ``device.upload``/``device.fetch`` byte counts on the
    ``device.sync`` / ``device.commit.wait`` spans without the call sites
    having to thread span handles around."""
    s = current()
    if s is None:
        return
    s.attributes.update(attributes)


def emit(name: str, start_ns: int, end_ns: int, **attributes) -> None:
    """Export one ALREADY-FINISHED span with explicit timestamps, parented
    under this thread's active span (no-op when tracing is disabled — one
    global read). The dispatch profiler uses this to back-fill the
    ``device.dispatch.{dwell,exec,fetch}`` waterfall under the still-open
    ``device.commit.wait`` span: the phases are only known once the
    blocking wait returns, after their wall-clock windows have passed."""
    t = _tracer
    if t is None:
        return
    stack = t._stack()
    if stack:
        trace_id, parent_id = stack[-1].trace_id, stack[-1].span_id
    else:
        trace_id, parent_id = uuid.uuid4().hex, None
    s = Span(name, trace_id, parent_id, attributes)
    s.start = int(start_ns)
    s.end = int(end_ns)
    try:
        t.exporter.export(s)
    except Exception:  # noqa: BLE001 — same never-fail rule as _run_span
        pass


def format_traceparent() -> Optional[str]:
    """W3C traceparent of the active span (``00-<trace_id>-<span_id>-01``),
    or None when tracing is disabled or no span is open. Inject this into a
    wire request so the server side parents under the caller's trace."""
    s = current()
    if s is None:
        return None
    return f"00-{s.trace_id}-{s.span_id}-01"


def parse_traceparent(tp) -> Optional[tuple]:
    """``(trace_id, parent_span_id)`` from a traceparent string, or None on
    anything malformed (propagation is best-effort; a bad header just means
    the server span roots its own trace)."""
    if not tp or not isinstance(tp, str):
        return None
    parts = tp.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


@contextlib.contextmanager
def span_from_remote(traceparent, name: str, **attributes):
    """Open a span parented under a remote caller's traceparent (the server
    half of cross-boundary propagation). Falls back to a normal local span
    when the context is absent/malformed; no-op when tracing is disabled."""
    t = _tracer
    if t is None:
        yield None
        return
    parsed = parse_traceparent(traceparent)
    if parsed is None:
        with t.span(name, **attributes) as s:
            yield s
    else:
        with t.span_remote(name, parsed[0], parsed[1], **attributes) as s:
            yield s


def tail(n: int = 256) -> List[Span]:
    """Last ``n`` finished spans when the active exporter keeps them in
    memory (InMemoryExporter); [] otherwise — the /debug/spans feed."""
    t = _tracer
    spans = getattr(getattr(t, "exporter", None), "spans", None) if t else None
    if not spans or n <= 0:  # n=0 means none, not all (spans[-0:] trap)
        return []
    return list(spans[-n:])


def maybe_enable_from_env() -> None:
    """KTPU_TRACE_FILE=<path> turns on JSON-lines span export (the
    --tracing-config-file analog of the cmd binaries)."""
    path = os.environ.get("KTPU_TRACE_FILE")
    if path and _tracer is None:
        enable(JsonFileExporter(path))
