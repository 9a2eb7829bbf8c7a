"""Three-part scheduling queue (``kubernetes_tpu/queue/scheduling_queue.py``;
internal/queue/scheduling_queue.go).

activeQ        heap ordered by the profile's QueueSort key (Coscheduling's:
               priority desc, then the pod's or its gang's first queue
               timestamp, then the group key, then FIFO)
podBackoffQ    heap ordered by backoff expiry (1 s doubling to 10 s, :766)
unschedulable  map of pods that failed, waiting for a cluster event, and of
               the pods the PreEnqueue gate refused (``gated``)

A cluster event moves an unschedulable pod only when a plugin it failed
registered interest in the event (:614, :627), or on the wildcard flush.
The ``move_request_cycle`` guard (:163-167) sends a pod that failed during
a cycle that raced with a move to backoffQ instead of the map. A
``coalesce_moves`` window defers the moves its events fire into one scan
at its exit. The flush tickers (:432, :463) are explicit ``flush_*`` calls
of the scheduler loop, on the injected clock.

The loop's three hooks, each optional (without them the queue is the
plain three-part queue, in the same order):

- ``pre_enqueue_fn(pod)``: the PreEnqueue gate (``:218-245``), re-run on
  every transition toward activeQ or backoffQ; a pod it refuses parks in
  the map with ``gated`` set and the refusing plugin among its failed
  plugins, so only that plugin's release wakes it. ``move_gated_pods``
  (``:547-590``) is the targeted release move, through a shadow admitter.
- ``gang_key_fn(pod)``: a gang member's arrival or move brings its parked
  siblings along (``activate_gang``, ``:591-615``), at most once per gang
  per ``initial_backoff`` (the starvation guard).
- ``ns_weight_fn(ns)``: namespaces with a weight get activeQ heaps of
  their own, served by deficit round robin (``:163-205``, ``:326-418``) in
  proportion to the weight, a gang keeping its tenant's turn; the other
  namespaces share the default heap, which joins the rotation at weight 1.

Every public entry point runs under the queue's RLock (``:60-75``): the
ring's commit worker requeues failed pods and fires the moves of its binds
while the scheduling thread pops.

The latency ledger (``metrics/latency_ledger.py``) follows each pod at the
JAX queue's six places (``:191``, ``:203``, ``:239``, ``:282``, ``:322``,
``:461``): activeQ (``queue.drr_wait`` in a tenant bucket while another
bucket is live), backoffQ, the gated park, the unschedulable map, the pop
(``cycle.host``) and the terminal delete of an unbound pod (``drop``).
"""

from __future__ import annotations

import bisect
import functools
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api.types import Pod
from ..framework.types import ClusterEvent, QueuedPodInfo
from ..metrics import latency_ledger
from . import events

POD_INITIAL_BACKOFF = 1.0
POD_MAX_BACKOFF = 10.0
UNSCHEDULABLE_TIMEOUT = 300.0  # flushUnschedulablePodsLeftover, 5 min
# pods a weight-1 tenant may drain per rotation turn
DEFAULT_FAIR_QUANTUM = 4.0

SortKey = Callable[[QueuedPodInfo], object]
# pod -> None (admit) or a refusal carrying ``plugin`` (the gate's plugin)
GateFn = Callable[[Pod], Optional[object]]


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
                 now_fn=time.monotonic,
                 gang_key_fn: Optional[Callable[[Pod], Optional[str]]] = None,
                 pre_enqueue_fn: Optional[GateFn] = None,
                 ns_weight_fn: Optional[Callable[[str], Optional[float]]] = None,
                 initial_backoff: float = POD_INITIAL_BACKOFF,
                 max_backoff: float = POD_MAX_BACKOFF):
        self._lock = threading.RLock()
        # podInitialBackoffSeconds and podMaxBackoffSeconds
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.less_key = less_key or priority_sort_key
        self.now_fn = now_fn
        self.set_cluster_event_map(cluster_event_map or {})
        self.gang_key_fn = gang_key_fn
        self._gang_last_co: Dict[str, float] = {}
        self.pre_enqueue_fn = pre_enqueue_fn
        self.ns_weight_fn = ns_weight_fn
        # tenant -> its activeQ heap; _drr_names is sorted(_active_ns),
        # kept by bisect as buckets appear and empty
        self._active_ns: Dict[str, List[Tuple[object, int, QueuedPodInfo]]] = {}
        self._drr_names: List[str] = []
        self._deficit: Dict[str, float] = {}
        self._drr_cur: Optional[str] = None
        self._gang_cont: Optional[Tuple[str, str]] = None  # (tenant, gang) mid-turn
        # the coalescing window's deferred events (None: no window open)
        self._move_backlog: Optional[List[ClusterEvent]] = None
        self._counter = itertools.count()  # FIFO tie-break inside the heaps
        self._active: List[Tuple[object, int, QueuedPodInfo]] = []
        self._backoff: List[Tuple[float, int, QueuedPodInfo]] = []
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        self._in_queue: Set[str] = set()  # keys in an active or the backoff heap
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
        d = self.initial_backoff
        for _ in range(1, qp.attempts):
            d *= 2
            if d >= self.max_backoff:
                return self.max_backoff
        return d

    def _tenant_of(self, pod: Pod) -> Optional[str]:
        """The pod's fair-share bucket: its namespace when that has a
        weight, else None (the default heap)."""
        if self.ns_weight_fn is None:
            return None
        ns = pod.meta.namespace
        return ns if self.ns_weight_fn(ns) is not None else None

    def _push_active(self, qp: QueuedPodInfo) -> None:
        key = qp.pod.key()
        if key in self._in_queue:
            return
        entry = (self.less_key(qp), next(self._counter), qp)
        tenant = self._tenant_of(qp.pod)
        if tenant is None:
            heapq.heappush(self._active, entry)
        else:
            if tenant not in self._active_ns:
                bisect.insort(self._drr_names, tenant)
            heapq.heappush(self._active_ns.setdefault(tenant, []), entry)
        self._in_queue.add(key)
        # a tenant's pod waits on the rotation while another bucket is live
        contended = (tenant is not None
                     and len(self._active_ns) + (1 if self._active else 0) > 1)
        latency_ledger.transition(key, "queue.drr_wait" if contended else "queue.active",
                                  namespace=qp.pod.meta.namespace)

    def _push_backoff(self, qp: QueuedPodInfo) -> None:
        key = qp.pod.key()
        if key in self._in_queue:
            return
        expiry = qp.timestamp + self._backoff_duration(qp)
        heapq.heappush(self._backoff, (expiry, next(self._counter), qp))
        self._in_queue.add(key)
        latency_ledger.transition(key, "queue.backoff", namespace=qp.pod.meta.namespace)

    def _park_gated(self, qp: QueuedPodInfo) -> bool:
        """The PreEnqueue gate for a pod about to enter activeQ or backoffQ:
        True when it refused, and the pod is parked gated in the map with
        the gate's plugin among its failed plugins."""
        if self.pre_enqueue_fn is None:
            return False
        key = qp.pod.key()
        if key in self._in_queue:
            return False
        st = self.pre_enqueue_fn(qp.pod)
        if st is None:
            qp.gated = False
            return False
        qp.gated = True
        qp.timestamp = self.now_fn()
        plugin = getattr(st, "plugin", "")
        if plugin:
            qp.unschedulable_plugins.add(plugin)
        self._unschedulable[key] = qp
        latency_ledger.transition(key, "queue.gated", namespace=qp.pod.meta.namespace)
        return True

    # ------------------------------------------------------------- API

    @_locked
    def add(self, pod: Pod) -> None:
        """A new unscheduled pod (informer add) enters activeQ (:300) unless
        the gate parks it; a gang member's arrival wakes its siblings."""
        qp = QueuedPodInfo(pod=pod, timestamp=self.now_fn())
        if not self._park_gated(qp):
            self._push_active(qp)
        if self.gang_key_fn is not None:
            gkey = self.gang_key_fn(pod)
            if gkey is not None:
                self.activate_gang(gkey)

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
            if not self._park_gated(qp):
                self._push_backoff(qp)
        else:
            self.add(new)

    @_locked
    def delete(self, pod: Pod) -> None:
        key = pod.key()
        latency_ledger.drop(key)  # an unbound pod's terminal delete
        self._unschedulable.pop(key, None)
        if key in self._in_queue:
            self._in_queue.discard(key)
            self._active = [e for e in self._active if e[2].pod.key() != key]
            heapq.heapify(self._active)
            # only the pod's own namespace heap can hold it
            ns = pod.meta.namespace
            heap = self._active_ns.get(ns)
            if heap is not None:
                h = [e for e in heap if e[2].pod.key() != key]
                if h:
                    heapq.heapify(h)
                    self._active_ns[ns] = h
                else:
                    del self._active_ns[ns]
                    self._drop_drr_name(ns)
            self._backoff = [e for e in self._backoff if e[2].pod.key() != key]
            heapq.heapify(self._backoff)

    @_locked
    def pop(self) -> Optional[QueuedPodInfo]:
        """The next pod to schedule, or None (the reference blocks, :484;
        the loop idles instead). Bumps ``attempts`` and the cycle."""
        self.flush_backoff_completed()
        qp = self._pop_active()
        if qp is None:
            return None
        self._in_queue.discard(qp.pod.key())
        qp.attempts += 1
        self.scheduling_cycle += 1
        latency_ledger.transition(qp.pod.key(), "cycle.host", namespace=qp.pod.meta.namespace)
        return qp

    def _pop_active(self) -> Optional[QueuedPodInfo]:
        if not self._active_ns:
            # no tenant heap: the single heap's order
            if not self._active:
                return None
            return heapq.heappop(self._active)[2]
        return self._drr_pop()

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

    # ------------------------------------------------------------- fair share

    def _weight_of(self, ns: str) -> float:
        if not ns:  # the default heap
            return 1.0
        w = self.ns_weight_fn(ns) if self.ns_weight_fn is not None else None
        return max(float(w), 0.0) if w is not None else 1.0

    def _drop_drr_name(self, ns: str) -> None:
        i = bisect.bisect_left(self._drr_names, ns)
        if i < len(self._drr_names) and self._drr_names[i] == ns:
            del self._drr_names[i]

    def _drr_bucket(self, ns: str) -> List:
        return self._active if ns == "" else self._active_ns[ns]

    def _drr_pop(self) -> Optional[QueuedPodInfo]:
        """Deficit round robin over the tenant heaps and the default one
        (""): a lone bucket is served free; a tenant mid-gang keeps its
        turn; the current tenant finishes its credit; else the rotation
        credits each bucket quantum x weight (banked up to two quanta) and
        serves the first with a whole pod of credit."""
        has_default = bool(self._active)
        n_buckets = len(self._active_ns) + (1 if has_default else 0)
        if n_buckets == 0:
            return None
        if n_buckets == 1:
            ns = "" if has_default else self._drr_names[0]
            return self._drr_take(ns, self._drr_bucket(ns), charge=False)
        if self._gang_cont is not None:
            ns, gkey = self._gang_cont
            h = self._active if ns == "" else self._active_ns.get(ns)
            if (h and self.gang_key_fn is not None
                    and self.gang_key_fn(h[0][2].pod) == gkey):
                return self._drr_take(ns, h)
            self._gang_cont = None
        names = ([""] if has_default else []) + self._drr_names
        cur = self._drr_cur
        cur_live = (cur == "" and has_default) or (cur in self._active_ns)
        if cur_live and self._deficit.get(cur, 0.0) >= 1.0:
            return self._drr_take(cur, self._drr_bucket(cur))
        start = (names.index(cur) + 1) if cur_live else 0
        for step in range(len(names)):
            ns = names[(start + step) % len(names)]
            credit = DEFAULT_FAIR_QUANTUM * self._weight_of(ns)
            self._deficit[ns] = min(self._deficit.get(ns, 0.0) + credit,
                                    max(2.0 * credit, 1.0))
            if self._deficit[ns] >= 1.0:
                return self._drr_take(ns, self._drr_bucket(ns))
        # every candidate has weight 0: stay work-conserving, uncharged
        ns = names[start % len(names)]
        return self._drr_take(ns, self._drr_bucket(ns), charge=False)

    def _drr_take(self, ns: str, heap: List, charge: bool = True) -> QueuedPodInfo:
        _k, _c, qp = heapq.heappop(heap)
        if heap:
            if charge:
                self._deficit[ns] = self._deficit.get(ns, 0.0) - 1.0
        else:
            # an emptied bucket forfeits its credit
            self._deficit.pop(ns, None)
            if ns:
                self._active_ns.pop(ns, None)
                self._drop_drr_name(ns)
        self._drr_cur = ns
        gkey = self.gang_key_fn(qp.pod) if self.gang_key_fn is not None else None
        self._gang_cont = (ns, gkey) if gkey is not None else None
        return qp

    # ------------------------------------------------------------- failures and moves

    @_locked
    def add_unschedulable_if_not_present(self, qp: QueuedPodInfo, pod_scheduling_cycle: int,
                                         error: bool = False) -> None:
        """A failed pod joins the unschedulable map, or backoffQ when a move
        request raced with its cycle (:393), each after the gate's re-check.
        ``error`` marks a cycle error (a Reserve conflict, a failed bind)
        rather than a fit verdict: no cluster event would wake it, so it
        takes backoffQ, whose wait grows with ``attempts``."""
        key = qp.pod.key()
        if key in self._in_queue or key in self._unschedulable:
            return
        qp.timestamp = self.now_fn()
        if error or self.move_request_cycle >= pod_scheduling_cycle:
            if not self._park_gated(qp):
                self._push_backoff(qp)
        elif not self._park_gated(qp):
            self._unschedulable[key] = qp
            latency_ledger.transition(key, "queue.unschedulable",
                                      namespace=qp.pod.meta.namespace)

    @_locked
    def move_all_to_active_or_backoff_queue(self, event: ClusterEvent) -> int:
        """Wake the unschedulable pods whose failed plugins registered
        interest in ``event`` (:614), and their gangs. Inside a
        ``coalesce_moves`` window the scan is deferred to the window's exit
        (returns 0); ``move_request_cycle`` advances at once either way."""
        self.move_request_cycle = self.scheduling_cycle
        if self._move_backlog is not None:
            self._move_backlog.append(event)
            return 0
        return self._move_all((event,))

    def _move_all(self, evs) -> int:
        """One scan of the map against every event of ``evs``; a pod moves
        once; a pod the gate still refuses parks again without a move."""
        moved = 0
        gangs_moved: Set[str] = set()
        for key in list(self._unschedulable):
            qp = self._unschedulable[key]
            if any(self._pod_matches_event(qp, ev) for ev in evs):
                del self._unschedulable[key]
                if self._requeue(qp):
                    moved += 1
                    if self.gang_key_fn is not None:
                        gkey = self.gang_key_fn(qp.pod)
                        if gkey is not None:
                            gangs_moved.add(gkey)
        for gkey in gangs_moved:
            moved += self.activate_gang(gkey)
        return moved

    def coalesce_moves(self):
        """Context manager: the moves fired inside the window run as one
        union scan at its exit. Windows nest; the outermost flushes. The
        targeted moves (``move_gated_pods``, ``activate_gang``) stay eager."""
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

    @_locked
    def move_gated_pods(self, namespace: str, plugin: str, admit_fn: GateFn) -> int:
        """The release move of a PreEnqueue gate (headroom opened in
        ``namespace``): gated pods, and pods that failed ``plugin``, go to
        activeQ when ``admit_fn`` (a shadow ledger: one freed slot admits
        one pod) admits them; the others stay parked without a queue
        move."""
        moved = 0
        for key in list(self._unschedulable):
            qp = self._unschedulable.get(key)
            if qp is None:
                continue
            if qp.pod.meta.namespace != namespace:
                continue
            if not qp.gated and plugin not in qp.unschedulable_plugins:
                continue
            if admit_fn(qp.pod) is not None:
                qp.gated = True
                continue
            del self._unschedulable[key]
            qp.gated = False
            self._push_active(qp)
            moved += 1
        if moved:
            self.move_request_cycle = self.scheduling_cycle
        return moved

    @_locked
    def activate_gang(self, gkey: str) -> int:
        """Move every unschedulable member of ``gkey`` toward activeQ, at
        most once per ``initial_backoff`` per gang."""
        if self.gang_key_fn is None:
            return 0
        now = self.now_fn()
        last = self._gang_last_co.get(gkey)
        if last is not None and now - last < self.initial_backoff:
            return 0
        moved = 0
        for key in list(self._unschedulable):
            qp = self._unschedulable[key]
            if self.gang_key_fn(qp.pod) == gkey:
                del self._unschedulable[key]
                if self._requeue(qp):
                    moved += 1
        if moved:
            self._gang_last_co[gkey] = now
            self.move_request_cycle = self.scheduling_cycle
        return moved

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

    def _requeue(self, qp: QueuedPodInfo) -> bool:
        """A woken pod lands in backoffQ unless its backoff already lapsed,
        after the gate's re-check (False: it parked gated again)."""
        if self._park_gated(qp):
            return False
        if self.now_fn() - qp.timestamp >= self._backoff_duration(qp):
            self._push_active(qp)
        else:
            self._push_backoff(qp)
        return True

    @_locked
    def flush_backoff_completed(self) -> None:
        """backoffQ -> activeQ for expired backoffs (:432), through the gate."""
        now = self.now_fn()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, qp = heapq.heappop(self._backoff)
            self._in_queue.discard(qp.pod.key())
            if not self._park_gated(qp):
                self._push_active(qp)

    @_locked
    def flush_unschedulable_left_over(self) -> None:
        """Pods unschedulable longer than the timeout are retried (:463);
        gated pods wait for their release instead."""
        now = self.now_fn()
        for key in list(self._unschedulable):
            qp = self._unschedulable[key]
            if qp.gated:
                continue
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
        gated = sum(1 for qp in self._unschedulable.values() if qp.gated)
        return {"active": len(self._active) + sum(len(h) for h in self._active_ns.values()),
                "backoff": len(self._backoff),
                "unschedulable": len(self._unschedulable) - gated, "gated": gated}

    @_locked
    def pending_pod_infos(self) -> List[QueuedPodInfo]:
        """Every queued pod, across the sub-queues (PendingPods, :530)."""
        return ([e[2] for e in self._active]
                + [e[2] for h in self._active_ns.values() for e in h]
                + [e[2] for e in self._backoff] + list(self._unschedulable.values()))

    @_locked
    def __len__(self) -> int:
        return (len(self._active) + sum(len(h) for h in self._active_ns.values())
                + len(self._backoff) + len(self._unschedulable))
