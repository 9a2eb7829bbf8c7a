"""Three-part scheduling queue (``kubernetes_tpu/queue/scheduling_queue.py``;
internal/queue/scheduling_queue.go).

activeQ        heap ordered by the profile's QueueSort key (PrioritySort:
               priority desc, then the queue timestamp, then FIFO)
podBackoffQ    heap ordered by backoff expiry (1 s doubling to 10 s, :766)
unschedulable  map of pods that failed, waiting for a cluster event

A cluster event moves an unschedulable pod only when a plugin it failed
registered interest in the event (:614, :627), or on the wildcard flush.
The ``move_request_cycle`` guard (:163-167) sends a pod that failed during
a cycle that raced with a move to backoffQ instead of the map. A
``coalesce_moves`` window defers the moves its events fire into one scan
at its exit. The flush tickers (:432, :463) are explicit ``flush_*`` calls
of the scheduler loop, on the injected clock.

Left out here (they come with the gang and quota parts of the loop): the
PreEnqueue gate and its gated pods, deficit-round-robin fair share per
namespace, and gang co-activation. ``pending_pods`` still reports the
``gated`` count (always 0). The event-match memo is keyed on the event map
it was filled from: ``set_cluster_event_map`` drops it.

Every public entry point runs under the queue's RLock (``:60-75``): the
ring's commit worker requeues failed pods and fires the moves of its binds
while the scheduling thread pops.
"""

from __future__ import annotations

import functools
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api.types import Pod
from ..framework.types import ClusterEvent, QueuedPodInfo
from . import events

POD_INITIAL_BACKOFF = 1.0
POD_MAX_BACKOFF = 10.0
UNSCHEDULABLE_TIMEOUT = 300.0  # flushUnschedulablePodsLeftover, 5 min

SortKey = Callable[[QueuedPodInfo], object]


def _locked(fn):
    """Run a public method under the queue's RLock (reentrant: the methods
    call each other)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


def priority_sort_key(qp: QueuedPodInfo) -> Tuple:
    """PrioritySort (the default profile's QueueSort for pods without a
    PodGroup): higher priority first, then the earlier queue timestamp."""
    return (-qp.pod.spec.priority, qp.timestamp, "")


class SchedulingQueue:
    def __init__(self, less_key: Optional[SortKey] = None,
                 cluster_event_map: Optional[Dict[ClusterEvent, Set[str]]] = None,
                 now_fn=time.monotonic):
        self._lock = threading.RLock()
        self.less_key = less_key or priority_sort_key
        self.now_fn = now_fn
        self.set_cluster_event_map(cluster_event_map or {})
        # the coalescing window's deferred events (None: no window open)
        self._move_backlog: Optional[List[ClusterEvent]] = None
        self._counter = itertools.count()  # FIFO tie-break inside the heaps
        self._active: List[Tuple[object, int, QueuedPodInfo]] = []
        self._backoff: List[Tuple[float, int, QueuedPodInfo]] = []
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        self._in_queue: Set[str] = set()  # keys in the active or backoff heap
        self.scheduling_cycle = 0
        self.move_request_cycle = -1

    @_locked
    def set_cluster_event_map(self, event_map: Dict[ClusterEvent, Set[str]]) -> None:
        """Which plugins' failures each registered event wakes; the match
        memo belongs to one map and is dropped with it."""
        self.cluster_event_map = {ev: frozenset(p) for ev, p in event_map.items()}
        self._event_match_memo: Dict[tuple, bool] = {}

    # ------------------------------------------------------------- helpers

    def _backoff_duration(self, qp: QueuedPodInfo) -> float:
        """calculateBackoffDuration (:766): initial * 2^(attempts-1), capped."""
        d = POD_INITIAL_BACKOFF
        for _ in range(1, qp.attempts):
            d *= 2
            if d >= POD_MAX_BACKOFF:
                return POD_MAX_BACKOFF
        return d

    def _push_active(self, qp: QueuedPodInfo) -> None:
        key = qp.pod.key()
        if key in self._in_queue:
            return
        heapq.heappush(self._active, (self.less_key(qp), next(self._counter), qp))
        self._in_queue.add(key)

    def _push_backoff(self, qp: QueuedPodInfo) -> None:
        key = qp.pod.key()
        if key in self._in_queue:
            return
        expiry = qp.timestamp + self._backoff_duration(qp)
        heapq.heappush(self._backoff, (expiry, next(self._counter), qp))
        self._in_queue.add(key)

    # ------------------------------------------------------------- API

    @_locked
    def add(self, pod: Pod) -> None:
        """A new unscheduled pod (informer add) enters activeQ (:300)."""
        self._push_active(QueuedPodInfo(pod=pod, timestamp=self.now_fn()))

    @_locked
    def update(self, old: Optional[Pod], new: Pod) -> None:
        """A pod update may make an unschedulable pod schedulable (:525); a
        pod the queue does not hold falls through to ``add`` (the
        reference's final AddNewPod branch: a popped pod whose status the
        scheduler itself updated, its nomination, re-enters activeQ)."""
        key = new.key()
        if key in self._in_queue:
            return  # popped later with the store's fresh object
        qp = self._unschedulable.pop(key, None)
        if qp is not None:
            qp.pod = new
            self._push_backoff(qp)
        else:
            self.add(new)

    @_locked
    def delete(self, pod: Pod) -> None:
        key = pod.key()
        self._unschedulable.pop(key, None)
        if key in self._in_queue:
            self._in_queue.discard(key)
            self._active = [e for e in self._active if e[2].pod.key() != key]
            heapq.heapify(self._active)
            self._backoff = [e for e in self._backoff if e[2].pod.key() != key]
            heapq.heapify(self._backoff)

    @_locked
    def pop(self) -> Optional[QueuedPodInfo]:
        """The next pod to schedule, or None (the reference blocks, :484;
        the loop idles instead). Bumps ``attempts`` and the cycle."""
        self.flush_backoff_completed()
        if not self._active:
            return None
        qp = heapq.heappop(self._active)[2]
        self._in_queue.discard(qp.pod.key())
        qp.attempts += 1
        self.scheduling_cycle += 1
        return qp

    @_locked
    def pop_batch(self, k: int) -> List[QueuedPodInfo]:
        """Up to ``k`` pods in queue order: the batch of one loop cycle."""
        out = []
        for _ in range(k):
            qp = self.pop()
            if qp is None:
                break
            out.append(qp)
        return out

    @_locked
    def add_unschedulable_if_not_present(self, qp: QueuedPodInfo, pod_scheduling_cycle: int,
                                         error: bool = False) -> None:
        """A failed pod joins the unschedulable map, or backoffQ when a move
        request raced with its cycle (:393). ``error`` marks a cycle error
        (a Reserve conflict, a failed bind) rather than a fit verdict: no
        cluster event would wake it, so it takes backoffQ, whose wait grows
        with ``attempts``."""
        key = qp.pod.key()
        if key in self._in_queue or key in self._unschedulable:
            return
        qp.timestamp = self.now_fn()
        if error or self.move_request_cycle >= pod_scheduling_cycle:
            self._push_backoff(qp)
        else:
            self._unschedulable[key] = qp

    @_locked
    def move_all_to_active_or_backoff_queue(self, event: ClusterEvent) -> int:
        """Wake the unschedulable pods whose failed plugins registered
        interest in ``event`` (:614). Inside a ``coalesce_moves`` window the
        scan is deferred to the window's exit (returns 0);
        ``move_request_cycle`` advances at once either way."""
        self.move_request_cycle = self.scheduling_cycle
        if self._move_backlog is not None:
            self._move_backlog.append(event)
            return 0
        return self._move_all((event,))

    def _move_all(self, evs) -> int:
        """One scan of the map against every event of ``evs``; a pod moves
        once."""
        moved = 0
        for key in list(self._unschedulable):
            qp = self._unschedulable[key]
            if any(self._pod_matches_event(qp, ev) for ev in evs):
                del self._unschedulable[key]
                self._requeue(qp)
                moved += 1
        return moved

    def coalesce_moves(self):
        """Context manager: the moves fired inside the window run as one
        union scan at its exit. Windows nest; the outermost flushes."""
        queue = self

        class _Window:
            def __enter__(self):
                with queue._lock:
                    self._owner = queue._move_backlog is None
                    if self._owner:
                        queue._move_backlog = []
                return self

            def __exit__(self, *exc):
                if self._owner:
                    queue._flush_coalesced_moves()
                return False

        return _Window()

    @_locked
    def _flush_coalesced_moves(self) -> None:
        """Close the window: one union scan over its deduplicated events."""
        backlog, self._move_backlog = self._move_backlog, None
        if backlog:
            self._move_all(list(dict.fromkeys(backlog)))

    def _pod_matches_event(self, qp: QueuedPodInfo, event: ClusterEvent) -> bool:
        if event.is_wildcard():
            return True
        failed = frozenset(qp.unschedulable_plugins)
        memo_key = (event, failed)
        hit = self._event_match_memo.get(memo_key)
        if hit is None:
            hit = any(registered.match(event) and (not failed or plugins & failed)
                      for registered, plugins in self.cluster_event_map.items())
            self._event_match_memo[memo_key] = hit
        return hit

    def _requeue(self, qp: QueuedPodInfo) -> None:
        """A woken pod lands in backoffQ unless its backoff already lapsed."""
        if self.now_fn() - qp.timestamp >= self._backoff_duration(qp):
            self._push_active(qp)
        else:
            self._push_backoff(qp)

    @_locked
    def flush_backoff_completed(self) -> None:
        """backoffQ -> activeQ for expired backoffs (:432)."""
        now = self.now_fn()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, qp = heapq.heappop(self._backoff)
            self._in_queue.discard(qp.pod.key())
            self._push_active(qp)

    @_locked
    def flush_unschedulable_left_over(self) -> None:
        """Pods unschedulable longer than the timeout are retried (:463)."""
        now = self.now_fn()
        for key in list(self._unschedulable):
            qp = self._unschedulable[key]
            if now - qp.timestamp > UNSCHEDULABLE_TIMEOUT:
                del self._unschedulable[key]
                self._requeue(qp)

    @_locked
    def assigned_pod_updated_or_added(self, pod: Pod) -> None:
        """An assigned pod changed: pods that failed on affinity or spread
        may fit now."""
        self.move_all_to_active_or_backoff_queue(events.POD_ADD)

    # ------------------------------------------------------------- stats

    @_locked
    def pending_pods(self) -> Dict[str, int]:
        return {"active": len(self._active), "backoff": len(self._backoff),
                "unschedulable": len(self._unschedulable), "gated": 0}

    @_locked
    def pending_pod_infos(self) -> List[QueuedPodInfo]:
        """Every queued pod, across the sub-queues (PendingPods, :530)."""
        return ([e[2] for e in self._active] + [e[2] for e in self._backoff]
                + list(self._unschedulable.values()))
