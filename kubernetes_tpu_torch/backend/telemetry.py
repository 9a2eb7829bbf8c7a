"""Device-runtime observability: the kernel-build ledger, the dispatch
profiler, device memory and transfer telemetry, and the batch flight
recorder (``kubernetes_tpu/backend/telemetry.py``, whole).

What each JAX concept is on this port:

  * **CompileLedger** counts and times every build of a device program per
    (program, bucket signature). The port has no XLA compile: its one
    build is the ``nvcc`` run of ``csrc/fused_step.cu``
    (``ops/fused_step.py:build_library``), which reports its duration
    through ``compiled`` to the dispatch context open on its thread (the
    first fused launch builds the library inside
    ``dispatch("schedule_batch", ...)``). A library found in ``_build/``
    counts nothing. A *retrace* is a build of a program in a later
    dispatch than its first; the library is built once per process and
    shape-generic, so retraces are 0 by construction here. The storm
    detector (>= STORM_RETRACES retraces within STORM_WINDOW dispatches)
    is kept with the same logic; ``calibration()`` marks ``warm_buckets``.
  * **DispatchLedger** splits every batch's blocking commit wait into
    *dwell* (submit to execution start, inferred from the ring: the card
    runs batch K+1 after batch K's execution ends), *exec* (to the end of
    the batch program: the synchronize of a CUDA event recorded after it,
    JAX's ``block_until_ready``) and *fetch* (to the packed block on the
    host: its staged copy's event). With the recorder on, the loop records
    two timing events around each batch program, and the record carries
    ``deviceExecS``, their ``elapsed_time``: the batch program's own time
    on the card. The **cost ledger** keeps, once per (program, bucket), the
    bytes a program must move: ``schedule_batch`` on the fused path gets
    the fused kernel's inputs and outputs from their shapes
    (``ops/fused_step.py:fused_step_bytes``): the kernel's bytes, not the
    whole batch program's. A program with no count (the scan, the rounds,
    ``claim_mask``) gets no entry, as JAX's probe returns None on a backend
    without cost analysis.
  * **Device memory and transfers**: ``sample_hbm`` reads
    ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
    ``.peak``) and ``torch.cuda.mem_get_info``'s total into the
    ``in_use`` / ``peak`` / ``limit`` gauges; None on the CPU.
    ``transfer(direction, nbytes)`` counts the mirror's row uploads and the
    packed blocks' fetches and annotates the active span.
  * **FlightRecorder**: a bounded ring of batch lifecycle events carrying
    batchId and bucket (``EVENT_KINDS``).

Disabled contract: the process recorder is None by default, and every hook
is one read of the module global before it returns; ``dispatch`` and
``calibration`` then hand back one shared null context manager. Turning
the layer on changes no placement, only counters and rings.
``KTPU_TELEMETRY=1`` turns it on at setup (``maybe_enable_from_env``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils import tracing

_recorder: Optional["DeviceTelemetry"] = None

# builds attributed while no dispatch context is open land here
OTHER_PROGRAM = "(other)"

# retrace-storm detector: >= STORM_RETRACES builds of one program within
# STORM_WINDOW dispatches of that program, after its first
STORM_RETRACES = 3
STORM_WINDOW = 32

# the flight-recorder event kinds the port records
EVENT_KINDS = frozenset({
    # batch lifecycle
    "encode", "dispatch", "commit", "poison", "requeue", "degrade",
    # the wire path: sessions and HA, the pipelined transport, the device
    # time a service echoes
    "conflict", "fence", "takeover", "pipeline_poison", "pipeline_dup_reply",
    "wire_device_time",
    # the device fabric: a replica lost or back, the failover, and the
    # warm-standby replicator's pushes
    "replica_down", "replica_rejoin", "failover", "replication",
    # device runtime
    "retrace_storm",
    # elasticity: slot reuse, node removal, the drain orchestrator's waves
    "slot_reclaim", "node_remove", "evict_wave",
    # slice-topology packing: per-gang torus verdicts, fragmentation alert
    "slice_assign", "slice_reject", "frag_alert",
    # continuous rebalancing: executed migration waves, the SLO guardrail
    # opening, and its half-open probe closing it again
    "rebalance_wave", "rebalance_suspended", "rebalance_resume",
    # cohort quota borrowing: loan grants, reclaim waves, the reclaim
    # breaker opening
    "borrow_grant", "borrow_reclaim", "reclaim_suspended",
})


class FlightRecorder:
    """Bounded ring of batch lifecycle events. ``deque.append`` with a
    maxlen is atomic under the GIL, so the hot path takes no lock."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self.recorded = 0  # total ever recorded (evictions = recorded - len)

    def record(self, etype: str, **fields) -> dict:
        ev = {"seq": next(self._seq), "t": time.time(), "type": etype}
        ev.update(fields)
        self._ring.append(ev)
        # a store of the monotone seq, not +=: concurrent writers could lose
        # an increment
        self.recorded = ev["seq"]
        return ev

    def dump(self, limit: Optional[int] = None) -> List[dict]:
        events = list(self._ring)
        if limit is not None and limit >= 0:
            events = events[-limit:] if limit else []
        return events

    def events(self, etype: Optional[str] = None, batch_id=None) -> List[dict]:
        return [e for e in self._ring
                if (etype is None or e["type"] == etype)
                and (batch_id is None or e.get("batchId") == batch_id)]

    def __len__(self) -> int:
        return len(self._ring)


class CompileLedger:
    """Per-(program, bucket) build counts and times, with the retrace-storm
    detector. Attribution rides a thread-local dispatch context: the build
    reports from the thread that launches the program."""

    def __init__(self, metrics=None, flight: Optional[FlightRecorder] = None):
        # a shared list when owned by DeviceTelemetry, a fresh one standalone
        self.metrics_sets = (metrics if isinstance(metrics, list)
                             else [metrics] if metrics is not None else [])
        self.flight = flight
        self._lock = threading.Lock()
        self._local = threading.local()
        self.compilations: Dict[tuple, int] = {}     # (program, bucket) -> n
        self.compile_seconds: Dict[str, float] = {}  # program -> total s
        self.dispatches: Dict[str, int] = {}         # program -> dispatch count
        self.retraces: Dict[str, int] = {}           # rebuilding dispatches
        self.storms: Dict[str, int] = {}             # storms flagged per program
        # warm_buckets windows: retraces still count, storms do not
        self.calibrating = 0
        # per program: the dispatch ordinal of its first build, and the
        # last dispatch already counted as a retrace
        self._first_compile_disp: Dict[str, int] = {}
        self._retrace_disp: Dict[str, int] = {}
        self._compile_marks: Dict[str, deque] = {}

    @contextlib.contextmanager
    def dispatch(self, program: str, bucket: Optional[str] = None):
        """Mark ``program`` (at ``bucket``) as the owner of any build fired
        while the body runs."""
        prev = getattr(self._local, "ctx", None)
        self._local.ctx = (program, bucket or "-")
        with self._lock:
            self.dispatches[program] = self.dispatches.get(program, 0) + 1
        try:
            yield
        finally:
            self._local.ctx = prev

    @contextlib.contextmanager
    def probe_guard(self):
        """No build accounting on this thread while a cost probe runs."""
        self._local.probing = True
        try:
            yield
        finally:
            self._local.probing = False

    def record_compile(self, duration_s: float) -> None:
        if getattr(self._local, "probing", False):
            return
        program, bucket = getattr(self._local, "ctx", None) or (OTHER_PROGRAM, "-")
        storm = False
        retrace = False
        with self._lock:
            key = (program, bucket)
            self.compilations[key] = self.compilations.get(key, 0) + 1
            self.compile_seconds[program] = self.compile_seconds.get(program, 0.0) + duration_s
            cur_disp = self.dispatches.get(program, 0)
            first = self._first_compile_disp.setdefault(program, cur_disp)
            if cur_disp > first and self._retrace_disp.get(program) != cur_disp:
                retrace = True
                self._retrace_disp[program] = cur_disp
                self.retraces[program] = self.retraces.get(program, 0) + 1
                if not self.calibrating:
                    marks = self._compile_marks.setdefault(program,
                                                           deque(maxlen=STORM_RETRACES))
                    marks.append(cur_disp)
                    if len(marks) == STORM_RETRACES and marks[-1] - marks[0] <= STORM_WINDOW:
                        self.storms[program] = self.storms.get(program, 0) + 1
                        marks.clear()  # one flag per storm, then re-arm
                        storm = True
        for m in self.metrics_sets:
            m.xla_compilations.inc(program, bucket)
            m.xla_compile_duration.observe(duration_s, program)
            if retrace:
                m.xla_retraces.inc(program)
        if storm:
            logging.getLogger(__name__).warning(
                "retrace storm: %d rebuilds of %r within %d dispatches",
                STORM_RETRACES, program, STORM_WINDOW)
            if self.flight is not None:
                self.flight.record("retrace_storm", program=program, bucket=bucket)

    @contextlib.contextmanager
    def calibration(self):
        """A deliberate warm-up window (``warm_buckets``): builds and
        retraces keep counting, storms are not flagged."""
        with self._lock:
            self.calibrating += 1
        try:
            yield
        finally:
            with self._lock:
                self.calibrating -= 1

    def total_compilations(self) -> int:
        with self._lock:
            return sum(self.compilations.values())

    def total_retraces(self) -> int:
        with self._lock:
            return sum(self.retraces.values())

    def dump(self) -> dict:
        with self._lock:
            return {
                "compilations": {f"{p}@{b}": n for (p, b), n
                                 in sorted(self.compilations.items())},
                "compileSeconds": {p: round(s, 4) for p, s
                                   in sorted(self.compile_seconds.items())},
                "dispatches": dict(self.dispatches),
                "retraces": dict(self.retraces),
                "storms": dict(self.storms),
            }


class DispatchLedger:
    """Per-dispatch device-time attribution: a ring of timing records,
    per-(program, bucket) running stats, and the cost ledger.

    The phases of one blocking commit wait:

      * **dwell**: submit to execution start. The card runs the batch
        programs of one stream in order, so batch K+1 cannot start before
        batch K's execution ends: ``exec_start = max(t_submit,
        prev_exec_end)`` (clamped to ``t_exec_done``), a monotone busy
        horizon kept under the ledger's lock.
      * **exec**: execution start to the end of the batch program (the end
        event's synchronize).
      * **fetch**: to the packed block on the host.

    ``window`` clamps the three into the observed wait ``[t_wait0,
    t_wait_end]`` so that they sum to it exactly: that partition backs the
    ``device.dispatch.*`` child spans under ``device.commit.wait``.
    """

    def __init__(self, metrics=None, capacity: int = 2048,
                 compile_ledger: Optional[CompileLedger] = None):
        self.metrics_sets = (metrics if isinstance(metrics, list)
                             else [metrics] if metrics is not None else [])
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.recorded = 0
        self.stats: Dict[tuple, dict] = {}   # (program, bucket) -> sums
        self.costs: Dict[tuple, dict] = {}   # (program, bucket) -> bytes
        self._last_exec_end = 0.0            # the busy horizon (now_fn domain)
        self._compile_ledger = compile_ledger

    def record_window(self, program: str, bucket: Optional[str] = None, *,
                      t_submit: float, t_wait0: float, t_exec_done: float,
                      t_wait_end: float, batch_id: str = "", pods: int = 0,
                      fetch_bytes: int = 0, device_exec_s: Optional[float] = None) -> dict:
        """Record one dispatch from its timestamps (the caller's ``now_fn``
        domain): ``t_submit`` when the dispatch returned, ``t_wait0`` and
        ``t_wait_end`` around the blocking read, ``t_exec_done`` when the
        batch program had ended. ``device_exec_s`` is the program's own
        time on the card (CUDA events), kept as ``deviceExecS``."""
        with self._lock:
            exec_start = min(max(t_submit, self._last_exec_end), t_exec_done)
            if t_exec_done > self._last_exec_end:
                self._last_exec_end = t_exec_done
        dwell = max(0.0, exec_start - t_submit)
        exec_s = max(0.0, t_exec_done - exec_start)
        fetch = max(0.0, t_wait_end - max(t_exec_done, t_wait0))
        wait = max(0.0, t_wait_end - t_wait0)
        a = min(max(exec_start, t_wait0), t_wait_end)
        b = min(max(t_exec_done, a), t_wait_end)
        window = {"dwell": a - t_wait0, "exec": b - a, "fetch": t_wait_end - b}
        return self._commit_record(program, bucket, dwell, exec_s, fetch, wait, window,
                                   batch_id, pods, fetch_bytes, device_exec_s)

    def record_phases(self, program: str, bucket: Optional[str] = None, *,
                      dwell_s: float, exec_s: float, fetch_s: float,
                      wait_s: Optional[float] = None, batch_id: str = "",
                      pods: int = 0, fetch_bytes: int = 0) -> dict:
        """Record one dispatch from phase durations measured elsewhere; the
        busy horizon does not move."""
        if wait_s is None:
            wait_s = dwell_s + exec_s + fetch_s
        window = {"dwell": dwell_s, "exec": exec_s, "fetch": fetch_s}
        return self._commit_record(program, bucket, dwell_s, exec_s, fetch_s, wait_s,
                                   window, batch_id, pods, fetch_bytes, None)

    def _commit_record(self, program, bucket, dwell, exec_s, fetch, wait, window,
                       batch_id, pods, fetch_bytes, device_exec_s) -> dict:
        rec = {
            "t": time.time(), "program": program, "bucket": bucket or "-",
            "batchId": batch_id, "pods": int(pods),
            "dwellS": dwell, "execS": exec_s, "fetchS": fetch,
            "waitS": wait, "fetchBytes": int(fetch_bytes), "window": window,
        }
        if device_exec_s is not None:
            rec["deviceExecS"] = device_exec_s
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1
            st = self.stats.setdefault((program, rec["bucket"]), {
                "count": 0, "dwellS": 0.0, "execS": 0.0, "fetchS": 0.0,
                "waitS": 0.0, "fetchBytes": 0})
            st["count"] += 1
            st["dwellS"] += dwell
            st["execS"] += exec_s
            st["fetchS"] += fetch
            st["waitS"] += wait
            st["fetchBytes"] += int(fetch_bytes)
            if device_exec_s is not None:
                st["deviceExecS"] = st.get("deviceExecS", 0.0) + device_exec_s
        for m in self.metrics_sets:
            m.device_dispatch_duration.observe(dwell, program, "dwell")
            m.device_dispatch_duration.observe(exec_s, program, "exec")
            m.device_dispatch_duration.observe(fetch, program, "fetch")
        return rec

    def maybe_cost(self, program: str, bucket: Optional[str], fn: Callable,
                   args=(), kwargs=None) -> None:
        """Keep ``fn(*args, **kwargs)`` (a dict with ``bytesAccessed`` and
        maybe ``flops``, or None) for (program, bucket) once: the slot is
        claimed before probing, so a probe that gives nothing is never
        retried per batch."""
        key = (program, bucket or "-")
        with self._lock:
            if key in self.costs:
                return
            self.costs[key] = {}
        guard = (self._compile_ledger.probe_guard() if self._compile_ledger is not None
                 else contextlib.nullcontext())
        with guard:
            cost = fn(*args, **(kwargs or {}))
        if cost:
            with self._lock:
                self.costs[key] = dict(cost)

    def dump(self, limit: Optional[int] = None) -> dict:
        """The per-(program, bucket) table (with achieved bytes/s where the
        cost ledger has the program's bytes) and the newest records."""
        with self._lock:
            records = list(self._ring)
            held = len(records)
            recorded = self.recorded
            stats = {k: dict(v) for k, v in self.stats.items()}
            costs = {k: dict(v) for k, v in self.costs.items()}
        if limit is not None and limit >= 0:
            records = records[-limit:] if limit else []
        programs = {}
        for (program, bucket), st in sorted(stats.items()):
            entry = {
                "count": st["count"],
                "dwellS": round(st["dwellS"], 6),
                "execS": round(st["execS"], 6),
                "fetchS": round(st["fetchS"], 6),
                "waitS": round(st["waitS"], 6),
                "fetchBytes": st["fetchBytes"],
            }
            if "deviceExecS" in st:
                entry["deviceExecS"] = round(st["deviceExecS"], 6)
            cost = costs.get((program, bucket))
            if cost:
                entry.update(cost)
                if st["execS"] > 0 and cost.get("flops"):
                    entry["achievedFlopsPerS"] = round(
                        cost["flops"] * st["count"] / st["execS"], 1)
                if st["execS"] > 0 and cost.get("bytesAccessed"):
                    entry["achievedBytesPerS"] = round(
                        cost["bytesAccessed"] * st["count"] / st["execS"], 1)
            programs[f"{program}@{bucket}"] = entry
        out = {
            "enabled": True,
            "ring": {"capacity": self.capacity, "recorded": recorded, "held": held},
            "programs": programs,
            "records": records,
        }
        if len(records) < held:
            out["truncated"] = {"records": held}
        return out


class DeviceTelemetry:
    """The process recorder: the ledgers, the flight recorder and the
    transfer and memory counters, optionally feeding SchedulerMetrics
    sets."""

    def __init__(self, metrics=None, ring_capacity: int = 4096):
        self.metrics_sets = [metrics] if metrics is not None else []
        self.flight = FlightRecorder(ring_capacity)
        # the ledgers share the list object, so attach_metrics reaches all
        self.ledger = CompileLedger(self.metrics_sets, self.flight)
        self.dispatch_ledger = DispatchLedger(self.metrics_sets, compile_ledger=self.ledger)
        self._lock = threading.Lock()
        self.transfer_bytes: Dict[str, int] = {"upload": 0, "fetch": 0}
        self.transfers: Dict[str, int] = {"upload": 0, "fetch": 0}
        self.hbm: dict = {}          # the last memory sample (or {})
        self.hbm_peak: int = 0       # the largest peak ever sampled

    def attach_metrics(self, metrics) -> None:
        """Bind another SchedulerMetrics set (a second scheduler in the
        same process)."""
        if metrics is not None and all(m is not metrics for m in self.metrics_sets):
            self.metrics_sets.append(metrics)

    def event(self, etype: str, **fields) -> None:
        self.flight.record(etype, **fields)
        for m in self.metrics_sets:
            m.flight_events.inc(etype)

    def transfer(self, direction: str, nbytes: int) -> None:
        with self._lock:
            self.transfer_bytes[direction] = self.transfer_bytes.get(direction, 0) + int(nbytes)
            self.transfers[direction] = self.transfers.get(direction, 0) + 1
        for m in self.metrics_sets:
            m.device_transfer_bytes.inc(direction, value=float(nbytes))
        # ride the bytes on the active span (device.sync, device.commit.wait)
        tracing.annotate(**{f"device.{direction}": int(nbytes)})

    def sample_hbm(self, device=None) -> Optional[dict]:
        """One read of the card's allocator statistics (host-side calls, no
        device work): ``bytes_in_use`` and ``peak_bytes_in_use`` from
        ``torch.cuda.memory_stats``, ``bytes_limit`` from
        ``torch.cuda.mem_get_info``. None on the CPU, or when the card
        gives no statistics."""
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        if not stats or "allocated_bytes.all.current" not in stats:
            return None
        sample = {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
                  "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
                  "bytes_limit": int(torch.cuda.mem_get_info(device)[1])}
        with self._lock:
            self.hbm = sample
            self.hbm_peak = max(self.hbm_peak, sample["peak_bytes_in_use"])
        kinds = {"bytes_in_use": "in_use", "peak_bytes_in_use": "peak", "bytes_limit": "limit"}
        for m in self.metrics_sets:
            for k, kind in kinds.items():
                m.hbm_bytes.set(kind, value=float(sample[k]))
        return sample

    def dump(self, limit: Optional[int] = None) -> dict:
        """The flight recorder, the build ledger, transfers and memory."""
        with self._lock:
            transfer = {
                "uploadBytes": self.transfer_bytes.get("upload", 0),
                "fetchBytes": self.transfer_bytes.get("fetch", 0),
                "uploads": self.transfers.get("upload", 0),
                "fetches": self.transfers.get("fetch", 0),
            }
            hbm = dict(self.hbm, peak_ever=self.hbm_peak) if self.hbm else {}
        events = self.flight.dump(limit)
        held = len(self.flight)
        out = {
            "enabled": True,
            "ring": {"capacity": self.flight.capacity, "recorded": self.flight.recorded,
                     "held": held},
            "compile": self.ledger.dump(),
            "transfer": transfer,
            "hbm": hbm,
            "events": events,
        }
        if len(events) < held:
            out["truncated"] = {"events": held}
        return out


# --------------------------------------------------------------- module API
#
# Every hook below starts with one read of the module global and returns at
# once when the layer is off.

_NULL_CM = contextlib.nullcontext()


def enable(metrics=None, ring_capacity: int = 4096) -> DeviceTelemetry:
    """Install the process recorder (a fresh one each call). ``metrics`` is
    a SchedulerMetrics set to feed; None keeps the internal counters only."""
    global _recorder
    _recorder = DeviceTelemetry(metrics, ring_capacity)
    return _recorder


def disable() -> None:
    global _recorder
    _recorder = None


def get() -> Optional[DeviceTelemetry]:
    return _recorder


def maybe_enable_from_env(metrics=None) -> None:
    """``KTPU_TELEMETRY=1`` turns the layer on at setup; 0 or unset leaves
    it off."""
    if os.environ.get("KTPU_TELEMETRY") != "1":
        return
    if _recorder is None:
        enable(metrics)
    elif metrics is not None:
        _recorder.attach_metrics(metrics)


def event(etype: str, **fields) -> None:
    """Record one flight-recorder event."""
    t = _recorder
    if t is None:
        return
    t.event(etype, **fields)


def dispatch(program: str, bucket: Optional[str] = None):
    """The build-attribution context of one dispatch; the shared null
    context manager when the layer is off."""
    t = _recorder
    if t is None:
        return _NULL_CM
    return t.ledger.dispatch(program, bucket)


def calibration():
    """The storm-free warm-up window; the shared null context manager when
    the layer is off."""
    t = _recorder
    if t is None:
        return _NULL_CM
    return t.ledger.calibration()


def compiled(duration_s: float) -> None:
    """One build of a device program (the ``nvcc`` run of a kernel
    library), attributed to the dispatch context open on this thread."""
    t = _recorder
    if t is None:
        return
    t.ledger.record_compile(duration_s)


def dispatch_window(program: str, bucket: Optional[str] = None, **kw) -> Optional[dict]:
    """Record one dispatch's phases from its timestamps
    (``DispatchLedger.record_window``); the record, or None when off."""
    t = _recorder
    if t is None:
        return None
    return t.dispatch_ledger.record_window(program, bucket, **kw)


def dispatch_phases(program: str, bucket: Optional[str] = None, **kw) -> Optional[dict]:
    """Record one dispatch from its phase durations; None when off."""
    t = _recorder
    if t is None:
        return None
    return t.dispatch_ledger.record_phases(program, bucket, **kw)


def cost_probe(program: str, bucket: Optional[str], fn: Callable, args=(),
               kwargs=None) -> None:
    """Keep the program's cost once per (program, bucket)."""
    t = _recorder
    if t is None:
        return
    t.dispatch_ledger.maybe_cost(program, bucket, fn, args, kwargs)


def emit_phase_spans(rec: Optional[dict]) -> None:
    """``device.dispatch.{dwell,exec,fetch}`` child spans of one dispatch
    record, laid so that the window partition ends now: called inside the
    still-open ``device.commit.wait`` span, they parent under it and sum to
    it exactly. No-op without a record or with tracing off."""
    if rec is None or tracing.get() is None:
        return
    anchor = time.time_ns()
    win = rec["window"]
    end_off = 0.0
    for phase in ("fetch", "exec", "dwell"):  # walk back from the wait's end
        start_off = end_off + max(0.0, win[phase])
        tracing.emit(f"device.dispatch.{phase}", anchor - int(start_off * 1e9),
                     anchor - int(end_off * 1e9), program=rec["program"],
                     batchId=rec["batchId"], bucket=rec["bucket"])
        end_off = start_off


def transfer(direction: str, nbytes: int) -> None:
    """Count one host-device transfer (``upload`` or ``fetch``)."""
    t = _recorder
    if t is None:
        return
    t.transfer(direction, nbytes)


def sample_hbm(device=None) -> None:
    t = _recorder
    if t is None:
        return
    t.sample_hbm(device)
