"""Dynamic lock-order / blocking-under-lock tracer: an own copy of
``kubernetes_tpu/testing/locktrace.py`` (the ``go test -race`` discipline
for the concurrent device path, in the shape Python affords).

The port's concurrent classes (the cache, the scheduling queue, the latency
ledger, the commit worker and device mutex, the device service, the fabric,
the store and its WAL) build their locks through this module's factories,
under the JAX package's lock names. Two whole families of bugs are invisible
to unit tests there: *lock-order inversions* (thread 1 takes A then B,
thread 2 takes B then A) and *blocking work under a hot lock* (a device
sync, a socket round trip or a retry sleep held under a shared lock).

This module makes both observable at test time:

  * ``make_lock(name)`` / ``make_rlock(name)`` are the lock FACTORY the
    concurrent classes construct their locks through
    (``backend/service.py``, ``queue/scheduling_queue.py``,
    ``cache/cache.py``, ``apiserver/store.py``, ...). With ``KTPU_LOCKTRACE``
    unset they return plain ``threading`` primitives — zero overhead, the
    production path is byte-identical. Under ``KTPU_LOCKTRACE=1`` they
    return traced wrappers that record, per thread, the stack of held lock
    names and fold every (held → acquired) pair into a global lock-order
    graph.

  * ``tracer().cycles()`` returns every order-inversion cycle in that
    graph — the chaos/active-active suites run with tracing on and assert
    it is empty (``assert_clean()``).

  * ``note_blocking(kind, detail)`` marks the known blocking seams (device
    dispatch, socket IO, retry sleeps, WAL fsync). Fired while the thread
    holds any traced lock it records a blocking-under-lock event; the
    deliberate, reviewed holds pass ``allowed="reason"`` and land in a
    separate ledger — an event in ``blocking_violations`` is always a bug.

Determinism note: the tracer observes the interleavings a test actually
drives, so it catches *potential* deadlocks (the A→B plus B→A edges) even
when the run never wedged — edges accumulate across threads and calls, the
cycle check is over the whole graph, not one schedule.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

_ENV = "KTPU_LOCKTRACE"


def enabled() -> bool:
    """Tracing requested via the environment. Read per call (tests flip it
    with monkeypatch.setenv); the cost is one dict lookup and it sits only
    at lock CONSTRUCTION time and inside ``note_blocking``."""
    return os.environ.get(_ENV, "") not in ("", "0")


def _call_site() -> str:
    """file:line of the nearest caller outside this module."""
    for frame in reversed(traceback.extract_stack(limit=12)[:-1]):
        if not frame.filename.endswith("locktrace.py"):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


class LockTracer:
    """Global acquisition recorder: per-thread held-lock stacks feeding one
    process-wide lock-order graph + blocking-event ledgers."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held, acquired) -> {"count", "site"}: "site" is the first place
        # the edge was observed (enough to find the nested acquire)
        self.edges: Dict[Tuple[str, str], Dict[str, object]] = {}
        self.acquisitions: Dict[str, int] = {}
        self.blocking_violations: List[dict] = []
        self.blocking_allowed: List[dict] = []

    # ------------------------------------------------------------ per-thread

    def held(self) -> List[str]:
        """This thread's stack of held traced-lock names (outermost first;
        reentrant RLock acquisitions appear once per acquire)."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def on_acquire(self, name: str) -> None:
        held = self.held()
        new_edges = [(h, name) for h in set(held) if h != name]
        # stack extraction is the expensive part: do it outside _mu and only
        # when some edge looks unseen (GIL-atomic optimistic read; a racing
        # first-observer just means one discarded extraction)
        site = None
        if new_edges and any(e not in self.edges for e in new_edges):  # ktpu: unguarded-ok(optimistic membership probe; the locked section below re-checks and a racing first-observer only costs one discarded stack extraction)
            site = _call_site()
        with self._mu:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            for edge in new_edges:
                rec = self.edges.get(edge)
                if rec is None:
                    self.edges[edge] = {"count": 1,
                                        "site": site or _call_site()}
                else:
                    rec["count"] += 1
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def on_blocking(self, kind: str, detail: str,
                    allowed: Optional[str] = None) -> None:
        held = self.held()
        if not held:
            return
        rec = {"kind": kind, "detail": detail,
               "locks": list(dict.fromkeys(held)),
               "site": _call_site(), "allowed": allowed}
        with self._mu:
            (self.blocking_allowed if allowed
             else self.blocking_violations).append(rec)

    # --------------------------------------------------------------- queries

    def cycles(self) -> List[List[str]]:
        """Every elementary order-inversion cycle in the lock-order graph
        (names in traversal order; a cycle means two threads CAN deadlock
        by taking the cycle's locks in opposite orders)."""
        with self._mu:
            adj: Dict[str, List[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, []).append(b)
        out: List[List[str]] = []
        seen_cycles = set()
        for start in sorted(adj):
            # DFS from each node; report cycles that return to `start` so
            # each cycle is found once (rotated to its smallest member)
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in adj.get(node, ()):
                    if nxt == start:
                        lo = path.index(min(path))
                        canon = tuple(path[lo:] + path[:lo])
                        if canon not in seen_cycles:
                            seen_cycles.add(canon)
                            out.append(list(canon))
                    elif nxt not in path and nxt > start:
                        # only walk nodes > start: every cycle is reported
                        # from its smallest member exactly once
                        stack.append((nxt, path + [nxt]))
        return out

    def report(self) -> dict:
        with self._mu:
            return {
                "acquisitions": dict(self.acquisitions),
                "edges": {f"{a} -> {b}": dict(v)
                          for (a, b), v in sorted(self.edges.items())},
                "blockingViolations": list(self.blocking_violations),
                "blockingAllowed": list(self.blocking_allowed),
            }


_tracer = LockTracer()


def tracer() -> LockTracer:
    return _tracer


def reset() -> None:
    """Fresh tracer (test isolation). Locks constructed earlier keep
    reporting into the new tracer — the wrappers resolve ``tracer()`` per
    call, never capture it."""
    global _tracer
    _tracer = LockTracer()


def assert_clean() -> None:
    """Raise AssertionError naming every lock-order cycle and every
    non-allowed blocking-under-lock event observed so far — the chaos
    suites' one-line postcondition."""
    t = tracer()
    problems = []
    for cyc in t.cycles():
        problems.append("lock-order cycle: " + " -> ".join(cyc + [cyc[0]]))
    for ev in t.blocking_violations:
        problems.append(
            f"blocking under lock: {ev['kind']} ({ev['detail']}) at "
            f"{ev['site']} while holding {ev['locks']}")
    if problems:
        raise AssertionError("locktrace found:\n  " + "\n  ".join(problems))


# ------------------------------------------------------------------ wrappers


class TracedLock:
    """threading.Lock/RLock wrapper reporting acquisitions to the tracer.
    Context-manager and acquire/release compatible; anything else proxies
    to the wrapped primitive."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            tracer().on_acquire(self.name)
        return ok

    def release(self) -> None:
        tracer().on_release(self.name)
        self._inner.release()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def make_lock(name: str):
    """Factory for a class's mutex: plain ``threading.Lock`` in production,
    a traced wrapper under KTPU_LOCKTRACE=1. ``name`` is the lock's node in
    the order graph — one name per protected component."""
    inner = threading.Lock()
    return TracedLock(name, inner) if enabled() else inner


def make_rlock(name: str):
    """``make_lock`` for reentrant locks (reentrant re-acquisition records
    no self-edge; the held stack tracks each level so release balances)."""
    inner = threading.RLock()
    return TracedLock(name, inner) if enabled() else inner


def note_blocking(kind: str, detail: str = "",
                  allowed: Optional[str] = None) -> None:
    """Mark a blocking operation (device dispatch, socket IO, sleep, fsync)
    at its call site. Free when tracing is off (one env read); under
    tracing it records an event IF the calling thread holds any traced
    lock. ``allowed="why"`` documents a reviewed deliberate hold — those
    land in a separate ledger and never fail ``assert_clean()``."""
    if not enabled():
        return
    tracer().on_blocking(kind, detail, allowed=allowed)
