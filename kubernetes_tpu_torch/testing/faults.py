"""Scripted device-fault injection for the device-service seam (own copy
of ``kubernetes_tpu/testing/faults.py``, whole; the chaosmonkey Do/Setup
analog, test/e2e/chaosmonkey/chaosmonkey.go).

A ``FaultPlan`` is a deterministic script of transport/service failures
consumed in order, wired into two interception points:

  * client side (``backend/service.py:WireClient``): a fault fires BEFORE the
    request touches the network — ``drop`` raises the same transient error
    a refused connection would, ``delay`` raises the read-timeout error a
    slow service would (no wall-clock sleep: the injected latency is
    compared against the client's read deadline), ``error`` raises a
    transient error N times (error-once / error-N).
  * server side (``serve``'s handler): ``error`` answers 503 (transient on
    the client's taxonomy), ``crash`` replaces the served DeviceService
    with a FRESH instance — new process epoch, empty DeviceState — and
    severs the connection without a response, exactly what a sidecar
    segfault+restart looks like from the client; ``conflict`` answers the
    409 + ``conflict: true`` cross-client race verdict (HA taxonomy).

HA-fabric primitives (per-ENDPOINT scoping comes from attaching one plan
per endpoint client): ``partition()`` persistently drops the batch-path
verbs while Health still answers (the asymmetric partition a health-only
detector never catches), ``slow()`` injects persistent per-call latency
(below the read deadline = laggy-but-live, at/above = dead), ``kill()``
persistently drops everything, and ``heal()`` lifts persistent faults.

Stream-level primitives (the pipelined-transport failure modes — K batches
in flight, replies matched by batchId):

  * ``torn(op)`` — server side: the request is PROCESSED (the service
    commits) but the connection is severed before the reply leaves — the
    lost-response case whose only safe recovery is the idempotent-batchId
    replay. Distinct from ``crash``: the service survives with its state.
  * ``dup_reply(op)`` — reply side: the reply is DELIVERED TWICE into the
    pipelined reply router (a retransmit duplicate); the router must drop
    the second copy by batchId, never double-process.
  * ``reorder(op)`` — reply side: the next TWO replies swap delivery order
    across pipeline lanes (each lane receives the OTHER call's reply), so
    the router's match-by-batchId is exercised for real, not incidentally.

Reply-side faults live in their own queue (side=``reply``) and are
consumed by the pipelined transport's reply router (``next_reply``), never
by ``raise_injected_fault`` — a request-side script cannot accidentally
swallow them.

Every consumed fault is appended to ``log`` so tests assert the script
actually fired. Thread-safe: handler threads and the scheduling thread
consume concurrently.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

APPLY_DELTAS = "apply_deltas"
SCHEDULE_BATCH = "schedule_batch"
ANY = "*"

CLIENT = "client"
SERVER = "server"
REPLY = "reply"


class _Rendezvous:
    """Two-party reply swap: each party deposits its reply and receives the
    OTHER party's. The first arrival waits (bounded) for the second; if the
    partner never comes — the script fired but only one call happened — the
    party falls back to its own reply so a test bug reads as an assertion
    failure, not a hang."""

    def __init__(self, timeout_s: float = 10.0):
        self.cv = threading.Condition()
        self.slots: List[object] = []
        self.timeout_s = timeout_s

    def swap(self, reply):
        with self.cv:
            idx = len(self.slots)
            self.slots.append(reply)
            if idx == 0:
                self.cv.wait_for(lambda: len(self.slots) >= 2,
                                 timeout=self.timeout_s)
                return self.slots[1] if len(self.slots) >= 2 else reply
            self.cv.notify_all()
            return self.slots[0]


@dataclasses.dataclass
class Fault:
    kind: str            # "error" | "delay" | "drop" | "crash" | "conflict"
    #                    # | "torn" | "dup" | "reorder"
    count: int = 1       # calls this fault applies to; -1 = persistent
    seconds: float = 0.0  # injected latency ("delay" only)
    status: int = 503    # HTTP status for server-side "error"
    rendezvous: object = None  # "reorder" only: the two-party reply swap

    @property
    def persistent(self) -> bool:
        return self.count < 0


class FaultPlan:
    def __init__(self):
        self._lock = threading.Lock()
        # (side, op) -> FIFO of pending faults; ANY matches either op
        self._faults: Dict[Tuple[str, str], List[Fault]] = {}
        self.log: List[Tuple[str, str, str]] = []  # (side, op, kind)

    # ------------------------------------------------------------ authoring

    def inject(self, op: str, fault: Fault, side: str = CLIENT) -> "FaultPlan":
        with self._lock:
            queue = self._faults.setdefault((side, op), [])
            if any(f.persistent for f in queue):
                # a persistent fault never leaves the head of its queue,
                # so anything injected behind it would silently never
                # fire — reject the script instead of losing its intent
                raise ValueError(
                    f"({side}, {op}) already has a persistent fault; "
                    f"heal() it before injecting more")
            queue.append(fault)
        return self

    def error_once(self, op: str = ANY, side: str = CLIENT) -> "FaultPlan":
        return self.inject(op, Fault("error"), side=side)

    def error_n(self, n: int, op: str = ANY, side: str = CLIENT) -> "FaultPlan":
        return self.inject(op, Fault("error", count=n), side=side)

    def delay(self, seconds: float, op: str = ANY, count: int = 1) -> "FaultPlan":
        return self.inject(op, Fault("delay", count=count, seconds=seconds))

    def drop(self, op: str = ANY, count: int = 1) -> "FaultPlan":
        return self.inject(op, Fault("drop", count=count))

    def crash(self, op: str = ANY) -> "FaultPlan":
        return self.inject(op, Fault("crash"), side=SERVER)

    def conflict(self, op: str = ANY, count: int = 1) -> "FaultPlan":
        """Server answers 409 + ``conflict: true`` — the cross-client race
        verdict, scriptable without staging a real two-replica collision."""
        return self.inject(op, Fault("conflict", count=count), side=SERVER)

    # ------------------------------------------------- stream-level primitives

    def torn(self, op: str = ANY, count: int = 1) -> "FaultPlan":
        """Torn mid-stream disconnect: the server PROCESSES the request
        (state committed) but the connection dies before the reply leaves.
        The client sees a transport error for work that actually happened —
        recovery is the transport retry hitting the idempotent-batchId
        replay, never a re-commit."""
        return self.inject(op, Fault("torn", count=count), side=SERVER)

    def dup_reply(self, op: str = ANY, count: int = 1) -> "FaultPlan":
        """Duplicated delivery: the reply router receives the same reply
        twice (a retransmit duplicate on the stream). The router must drop
        the second copy by batchId."""
        return self.inject(op, Fault("dup", count=count), side=REPLY)

    def reorder(self, op: str = ANY) -> "FaultPlan":
        """Reordered replies: the next TWO calls' replies swap delivery
        lanes — each pipeline lane receives the OTHER call's reply, so only
        batchId matching can pair results with requests."""
        return self.inject(op, Fault("reorder", count=2,
                                     rendezvous=_Rendezvous()), side=REPLY)

    # ------------------------------------------------- HA-fabric primitives

    def partition(self, *ops: str) -> "FaultPlan":
        """Asymmetric network partition of ONE endpoint (attach this plan
        to that endpoint's client): batch traffic fails PERSISTENTLY while
        the Health verb still answers — the failure mode where a naive
        health-probe-only detector never fails over. Defaults to both
        batch-path verbs; pass explicit ops to narrow (e.g. only
        ``SCHEDULE_BATCH`` so delta pushes still land). ``heal()`` lifts
        it."""
        for op in (ops or (APPLY_DELTAS, SCHEDULE_BATCH)):
            self.inject(op, Fault("drop", count=-1))
        return self

    def slow(self, seconds: float, op: str = ANY) -> "FaultPlan":
        """Persistently slow endpoint: every matching call carries
        ``seconds`` of injected latency (deterministic — compared against
        the client's read deadline, never slept). Below the deadline the
        calls succeed slow (a laggy-but-live standby must NOT trigger
        failover); at/above it every call times out like a dead one."""
        return self.inject(op, Fault("delay", count=-1, seconds=seconds))

    def kill(self) -> "FaultPlan":
        """Endpoint death: every client-side call — Health included —
        fails persistently, what a killed sidecar process looks like from
        its clients. ``heal()`` is the restart-less recovery (partition
        healed / process back on the same epoch)."""
        return self.inject(ANY, Fault("drop", count=-1))

    def heal(self, op: Optional[str] = None,
             side: Optional[str] = None) -> "FaultPlan":
        """Remove pending faults (all of them by default, or only the
        given op/side): the partition heals, the slow replica catches up,
        the killed process answers again. Healing a specific op while a
        WILDCARD fault still covers it raises — a silent no-op there
        would leave the script believing the op recovered while every
        call keeps matching the ``*`` queue."""
        with self._lock:
            matched = False
            for key in list(self._faults):
                s, o = key
                if (op is None or o == op) and (side is None or s == side):
                    del self._faults[key]
                    matched = True
            if op is not None and op != ANY and not matched:
                wild = [key for key in self._faults
                        if key[1] == ANY and (side is None or key[0] == side)
                        and self._faults[key]]
                if wild:
                    raise ValueError(
                        f"heal(op={op!r}) matched no per-op fault, but a "
                        f"wildcard (op='*') fault still covers it — heal "
                        f"the wildcard (heal() / heal(op='*')) or inject "
                        f"per-op faults instead of kill()")
        return self

    # ------------------------------------------------------------ consuming

    def _take(self, side: str, op: str) -> Optional[Fault]:
        with self._lock:
            for key in ((side, op), (side, ANY)):
                queue = self._faults.get(key)
                if not queue:
                    continue
                fault = queue[0]
                if not fault.persistent:  # persistent faults never expire
                    fault.count -= 1
                    if fault.count <= 0:
                        queue.pop(0)
                self.log.append((side, op, fault.kind))
                return fault
            return None

    def next_client(self, op: str) -> Optional[Fault]:
        return self._take(CLIENT, op)

    def next_server(self, op: str) -> Optional[Fault]:
        return self._take(SERVER, op)

    def next_reply(self, op: str) -> Optional[Fault]:
        """Reply-side faults (dup/reorder), consumed by the pipelined
        transport's reply router only."""
        return self._take(REPLY, op)

    def pending(self) -> int:
        """Finite faults not yet consumed (persistent ones never drain,
        so they are excluded — scripts assert exact finite consumption)."""
        with self._lock:
            return sum(max(f.count, 0)
                       for q in self._faults.values() for f in q)
