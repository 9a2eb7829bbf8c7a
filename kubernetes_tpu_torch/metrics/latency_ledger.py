"""Pod-lifetime latency ledger: per-segment end-to-end attribution (an
own copy of ``kubernetes_tpu/metrics/latency_ledger.py``, whole).

``scheduling_attempt_duration_seconds`` times one attempt; a pod that
bounces through backoffQ, a quota gate, a gang Permit park, fair-share
contention and a ring-poison requeue is invisible end to end. This module
keeps one entry per pod key, opened at the pod's first queue entry and
closed at bind (or terminal delete), accumulating named wall-clock segments
across every attempt:

  queue.active        activeQ dwell (default bucket / uncontended tenant)
  queue.drr_wait      activeQ dwell inside a contended tenant bucket (the
                      deficit-round-robin rotation is serving other tenants)
  queue.backoff       backoffQ dwell (error requeues, ring poison,
                      move-raced failures)
  queue.unschedulable unschedulable-map park (waiting on a cluster event)
  queue.gated         PreEnqueue park (QuotaAdmission refusing admission)
  cycle.host          pop to dispatch or decision: host work
  gang.permit_park    Permit WAIT park (Coscheduling quorum)
  device.inflight     a dispatched batch's dwell in the in-flight ring and
                      on the card (batchId-correlated with the flight
                      recorder)
  commit.host         claim to the bind tail: assume, Reserve, Permit,
                      PreBind
  bind                the store's bind through finish

``transition`` closes the current segment and opens the next at one clock
read, so ``e2e == sum(segments)`` up to float rounding.

On close the ledger observes ``pod_e2e_duration{result}`` and
``pod_latency_segment{segment}``, and the per-tenant
``tenant_e2e_duration{namespace}`` for namespaces ``tenant_fn`` names (the
loop passes its QuotaAdmission's ``weight_for``, the queue's
``ns_weight_fn``: only namespaces with a SchedulingQuota weight), which
bounds the label set.

Disabled contract: the module recorder is None by default and every hook
returns after one read of the module global. ``KTPU_LEDGER=1`` turns it on
at setup; ``now_fn`` is injectable (a FakeClock drives it in tests), wall
clock by default so that intervals line up with spans and flight events.
Turning it on changes no placement.

Bounded: ``cap`` live entries (oldest evicted, counted on
``ledger_evicted``), a fixed tail of closed entries, and a fixed per-entry
interval history. Entries drop on pod delete, so churn cannot leak.

Thread safety: one plain lock around all state (the port's cache and queue
use plain locks too); hooks run under the queue's lock and on the commit
worker. The ledger never takes another lock while holding its own: metric
observations, the eviction counter and ``tenant_fn`` run after it is
released.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterable, List, Optional

from ..testing import locktrace

# the declared segment registry: every segment observed on
# pod_latency_segment comes from this set
SEGMENTS = frozenset({
    "queue.active",
    "queue.drr_wait",
    "queue.backoff",
    "queue.unschedulable",
    "queue.gated",
    "cycle.host",
    "gang.permit_park",
    "device.inflight",
    "commit.host",
    "bind",
})

DEFAULT_CAP = 16384          # live entries before oldest-evict
DEFAULT_KEEP_CLOSED = 512    # closed-entry tail kept for the timeline
DEFAULT_MAX_INTERVALS = 128  # per-entry interval history (timeline slices)

_ledger: Optional["PodLatencyLedger"] = None


class _Entry:
    __slots__ = ("key", "namespace", "opened", "seg", "seg_start", "acc",
                 "intervals", "batch_id", "closed", "result")

    def __init__(self, key: str, namespace: str, now: float,
                 max_intervals: int):
        self.key = key
        self.namespace = namespace
        self.opened = now
        self.seg: Optional[str] = None
        self.seg_start = now
        self.acc: Dict[str, float] = {}
        self.intervals: deque = deque(maxlen=max_intervals)
        self.batch_id: Optional[str] = None
        self.closed: Optional[float] = None
        self.result: Optional[str] = None


class PodLatencyLedger:
    """The process recorder: entry table + closed tail + metric feeds."""

    def __init__(self, metrics=None, cap: int = DEFAULT_CAP,
                 now_fn: Optional[Callable[[], float]] = None,
                 tenant_fn: Optional[Callable[[str], object]] = None,
                 keep_closed: int = DEFAULT_KEEP_CLOSED,
                 max_intervals: int = DEFAULT_MAX_INTERVALS):
        self.metrics = metrics
        self.cap = cap
        # wall clock by default so ledger intervals line up with span
        # start/end and flight-recorder timestamps on the timeline;
        # tests inject a FakeClock for deterministic waits
        self.now_fn = now_fn or time.time
        # quota tenant index: ns -> weight (truthy = tenant). Bounds the
        # {namespace} label set of the tenant SLO histogram.
        self.tenant_fn = tenant_fn
        self._max_intervals = max_intervals
        self._lock = locktrace.make_lock("LatencyLedger")
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._closed: deque = deque(maxlen=keep_closed)
        self.evicted = 0
        self.opened_total = 0
        self.closed_total = 0

    # ------------------------------------------------------------ internals

    def _entry_locked(self, key: str, namespace: str,
                      now: float) -> _Entry:
        e = self._entries.get(key)
        if e is not None:
            return e
        while len(self._entries) >= self.cap:
            self._entries.popitem(last=False)
            self.evicted += 1  # metric emission happens after lock release
        e = _Entry(key, namespace, now, self._max_intervals)
        self._entries[key] = e
        self.opened_total += 1
        return e

    def _close_segment_locked(self, e: _Entry, now: float) -> None:
        if e.seg is None:
            return
        dur = max(now - e.seg_start, 0.0)
        e.acc[e.seg] = e.acc.get(e.seg, 0.0) + dur
        e.intervals.append((e.seg, e.seg_start, now))

    # ------------------------------------------------------------------ API

    def transition(self, key: str, segment: str, namespace: str = "",
                   batch_id: Optional[str] = None,
                   create: bool = True) -> None:
        """Close the entry's current segment and open ``segment`` at one
        clock read (gap-free). ``create`` governs unknown keys: queue-entry
        hooks create (a pod's lifetime starts at first enqueue); post-queue
        hooks pass ``create=False`` so a pod deleted mid-flight (entry
        already dropped) is never resurrected as a ghost with a bogus
        near-zero e2e."""
        now = self.now_fn()
        with self._lock:
            if not create and key not in self._entries:
                return
            ev0 = self.evicted
            e = self._entry_locked(key, namespace, now)
            if namespace and not e.namespace:
                e.namespace = namespace
            self._close_segment_locked(e, now)
            e.seg = segment
            e.seg_start = now
            if batch_id is not None:
                e.batch_id = batch_id
            evicted = self.evicted - ev0
        self._report_evictions(evicted)

    def transition_many(self, keys: Iterable[str], segment: str,
                        batch_id: Optional[str] = None,
                        create: bool = False) -> None:
        """Batch-path twin: one clock read + one lock round trip for a
        whole dispatched/committed batch. Defaults to ``create=False`` —
        every batch-path segment is post-queue, so an unknown key means
        the pod's entry was dropped (deleted mid-flight) and must stay
        dropped."""
        now = self.now_fn()
        with self._lock:
            ev0 = self.evicted
            for key in keys:
                if not create and key not in self._entries:
                    continue
                e = self._entry_locked(key, "", now)
                self._close_segment_locked(e, now)
                e.seg = segment
                e.seg_start = now
                if batch_id is not None:
                    e.batch_id = batch_id
            evicted = self.evicted - ev0
        self._report_evictions(evicted)

    def _report_evictions(self, n: int) -> None:
        """Eviction-counter emission, outside the ledger lock (leaf-lock
        rule: this call's own evictions, counted under its lock hold)."""
        if n > 0 and self.metrics is not None:
            self.metrics.ledger_evicted.inc(value=float(n))

    def close(self, key: str, result: str = "scheduled") -> Optional[_Entry]:
        now = self.now_fn()
        with self._lock:
            e = self._close_locked(key, result, now)
        if e is not None:
            self._observe_closed(e)
        return e

    def close_many(self, keys: Iterable[str],
                   result: str = "scheduled") -> None:
        now = self.now_fn()
        with self._lock:
            closed = [e for e in (self._close_locked(k, result, now)
                                  for k in keys) if e is not None]
        for e in closed:
            self._observe_closed(e)

    def _close_locked(self, key: str, result: str,
                      now: float) -> Optional[_Entry]:
        e = self._entries.pop(key, None)
        if e is None:
            return None
        self._close_segment_locked(e, now)
        e.seg = None
        e.closed = now
        e.result = result
        self.closed_total += 1
        self._closed.append(e)
        return e

    def _observe_closed(self, e: _Entry) -> None:
        """Metric emission for a just-closed entry — OUTSIDE the ledger
        lock, so it stays a true leaf: metric locks and the arbitrary
        ``tenant_fn`` callback are never entered with the ledger held
        (hooks already run under the queue lock; a tenant_fn reaching
        back into queue-locked state must not close a cycle here)."""
        m = self.metrics
        if m is None:
            return
        e2e = max(e.closed - e.opened, 0.0)
        m.pod_e2e_duration.observe(e2e, e.result)
        for seg, s in e.acc.items():
            m.pod_latency_segment.observe(s, seg)
        # tenant SLO: only quota tenants are labeled (bounded set), and
        # only real schedules count — a deleted pod's lifetime is not a
        # scheduling latency
        if (e.result == "scheduled" and e.namespace
                and self.tenant_fn is not None
                and self.tenant_fn(e.namespace)):
            m.tenant_e2e_duration.observe(e2e, e.namespace)

    def drop(self, key: str) -> Optional[_Entry]:
        """Terminal delete of an unbound pod: close with result="deleted"
        (the entry is removed either way — churn cannot leak)."""
        return self.close(key, result="deleted")

    # ------------------------------------------------------- introspection

    def entry(self, key: str) -> Optional[dict]:
        """Snapshot of one live or recently-closed entry (tests)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = next((c for c in reversed(self._closed)
                          if c.key == key), None)
            if e is None:
                return None
            return self._entry_view_locked(e)

    def _entry_view_locked(self, e: _Entry) -> dict:
        return {
            "pod": e.key,
            "namespace": e.namespace,
            "opened": e.opened,
            "closed": e.closed,
            "result": e.result,
            "segment": e.seg,
            "batchId": e.batch_id,
            "segments": dict(e.acc),
            "intervals": list(e.intervals),
        }

    def timeline_entries(self, limit: Optional[int] = None) -> List[dict]:
        """The newest ``limit`` pods (closed tail first, then live), each
        with its interval history — the ledger half of ``chrome_trace``.
        Live entries' open segment is closed at 'now' for rendering only."""
        now = self.now_fn()
        with self._lock:
            pool = list(self._closed) + list(self._entries.values())
            if limit is not None and limit >= 0:
                pool = pool[-limit:] if limit else []
            out = []
            for e in pool:
                view = self._entry_view_locked(e)
                if e.closed is None and e.seg is not None:
                    view["intervals"] = view["intervals"] + [
                        (e.seg, e.seg_start, now)]
                out.append(view)
            return out

    def dump(self, limit: Optional[int] = None) -> dict:
        with self._lock:
            live = len(self._entries)
            opened, closed = self.opened_total, self.closed_total
            evicted = self.evicted
        return {
            "enabled": True,
            "cap": self.cap,
            "live": live,
            "opened": opened,
            "closed": closed,
            "evicted": evicted,
            "entries": self.timeline_entries(limit),
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ------------------------------------------------------------- timeline export

def chrome_trace(spans=(), flight=(), ledger: Optional[PodLatencyLedger] = None,
                 dispatch=(), limit: Optional[int] = None) -> dict:
    """One Chrome trace-event JSON document (loadable in Perfetto /
    chrome://tracing) unifying four telemetry layers on one time axis:

      pid 1  host/device spans (utils/tracing.py ``tail``) — complete events,
             one track per trace so concurrent cycles don't interleave
      pid 2  flight-recorder events (backend/telemetry.py) — instants
             carrying batchId/client/epoch args
      pid 3  ledger pod segments — one track per pod, slices named by
             segment with pod UID + batchId args
      pid 4  device dispatch track (DispatchLedger records) — each batch's
             dwell/exec/fetch waterfall as back-to-back slices ending at
             the record's commit time, batchId/program-correlated with the
             pid 1/2 rows above it

    All timestamps are microseconds on the wall clock (spans record
    time.time_ns, the flight recorder, the ledger, and dispatch records
    time.time), so a pod's ``device.inflight`` slice visually brackets its
    batch's dispatch→commit events."""
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "host spans"}},
        {"ph": "M", "name": "process_name", "pid": 2, "tid": 0,
         "args": {"name": "flight recorder"}},
        {"ph": "M", "name": "process_name", "pid": 3, "tid": 0,
         "args": {"name": "pod latency ledger"}},
        {"ph": "M", "name": "process_name", "pid": 4, "tid": 0,
         "args": {"name": "device dispatch"}},
    ]
    trace_tids: Dict[str, int] = {}
    for s in spans:
        tid = trace_tids.setdefault(s.trace_id, len(trace_tids) + 1)
        args = {str(k): str(v) for k, v in s.attributes.items()}
        args["traceId"] = s.trace_id
        events.append({
            "name": s.name, "ph": "X", "pid": 1, "tid": tid,
            "ts": s.start / 1e3,
            "dur": max((s.end - s.start) / 1e3, 0.001),
            "cat": "span", "args": args,
        })
    for ev in flight:
        args = {str(k): v for k, v in ev.items()
                if k not in ("t", "type")}
        events.append({
            "name": ev.get("type", "?"), "ph": "i", "s": "p",
            "pid": 2, "tid": 1,
            "ts": float(ev.get("t", 0.0)) * 1e6,
            "cat": "flight", "args": args,
        })
    if ledger is not None:
        for i, view in enumerate(ledger.timeline_entries(limit), start=1):
            events.append({
                "ph": "M", "name": "thread_name", "pid": 3, "tid": i,
                "args": {"name": view["pod"]}})
            args = {"pod": view["pod"]}
            if view.get("batchId"):
                args["batchId"] = view["batchId"]
            if view.get("result"):
                args["result"] = view["result"]
            for seg, t0, t1 in view["intervals"]:
                events.append({
                    "name": seg, "ph": "X", "pid": 3, "tid": i,
                    "ts": t0 * 1e6,
                    "dur": max((t1 - t0) * 1e6, 0.001),
                    "cat": "ledger", "args": args,
                })
    for rec in dispatch:
        # the record's wall stamp is taken as the wait ends; the window
        # partition (dwell+exec+fetch == wait exactly) walks back from it
        end_us = float(rec.get("t", 0.0)) * 1e6
        win = rec.get("window") or {}
        args = {"program": rec.get("program", "?"),
                "bucket": rec.get("bucket", "-"),
                "batchId": rec.get("batchId", "")}
        for phase in ("fetch", "exec", "dwell"):
            dur_us = max(float(win.get(phase, 0.0)), 0.0) * 1e6
            events.append({
                "name": f"{args['program']}.{phase}", "ph": "X",
                "pid": 4, "tid": 1,
                "ts": end_us - dur_us, "dur": max(dur_us, 0.001),
                "cat": "dispatch", "args": args,
            })
            end_us -= dur_us
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --------------------------------------------------------------- module API
#
# Every hook below starts with one read of the module global and returns
# immediately when the ledger is disabled — the same near-zero disabled
# cost contract as backend/telemetry.py, pinned by tests.

def enable(metrics=None, cap: int = DEFAULT_CAP,
           now_fn: Optional[Callable[[], float]] = None,
           tenant_fn: Optional[Callable[[str], object]] = None,
           keep_closed: int = DEFAULT_KEEP_CLOSED) -> PodLatencyLedger:
    """Install the process ledger (idempotent refresh)."""
    global _ledger
    _ledger = PodLatencyLedger(metrics, cap=cap, now_fn=now_fn,
                               tenant_fn=tenant_fn, keep_closed=keep_closed)
    return _ledger


def disable() -> None:
    global _ledger
    _ledger = None


def get() -> Optional[PodLatencyLedger]:
    return _ledger


def maybe_enable_from_env(metrics=None,
                          tenant_fn: Optional[Callable[[str], object]] = None
                          ) -> None:
    """KTPU_LEDGER=1 turns the ledger on at server setup (the KTPU_TELEMETRY
    twin); 0/unset leaves it off (the zero-cost default)."""
    if os.environ.get("KTPU_LEDGER") != "1":
        return
    if _ledger is None:
        enable(metrics, tenant_fn=tenant_fn)
    else:
        if metrics is not None and _ledger.metrics is None:
            _ledger.metrics = metrics
        if tenant_fn is not None and _ledger.tenant_fn is None:
            _ledger.tenant_fn = tenant_fn


def transition(key: str, segment: str, namespace: str = "",
               batch_id: Optional[str] = None, create: bool = True) -> None:
    led = _ledger
    if led is None:
        return
    led.transition(key, segment, namespace=namespace, batch_id=batch_id,
                   create=create)


def transition_many(keys, segment: str, batch_id: Optional[str] = None,
                    create: bool = False) -> None:
    led = _ledger
    if led is None:
        return
    led.transition_many(keys, segment, batch_id=batch_id, create=create)


def close(key: str, result: str = "scheduled") -> None:
    led = _ledger
    if led is None:
        return
    led.close(key, result=result)


def close_many(keys, result: str = "scheduled") -> None:
    led = _ledger
    if led is None:
        return
    led.close_many(keys, result=result)


def drop(key: str) -> None:
    led = _ledger
    if led is None:
        return
    led.drop(key)


def close_skipped(key: str, pod) -> None:
    """The one result classification for a pod found gone or bound after
    its queue dwell (skipPodSchedule and the gone-or-bound failure exit of
    both the batch and the sequential path): bound (by anyone) closes as
    "scheduled", absent as "deleted". No-op when the ledger is off or the
    key unknown."""
    led = _ledger
    if led is None:
        return
    led.close(key, "scheduled" if pod is not None and pod.spec.node_name
              else "deleted")
