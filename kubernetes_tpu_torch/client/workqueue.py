"""Workqueue (client-go util/workqueue; an own copy of
``kubernetes_tpu/client/workqueue.py``): dedup FIFO with per-item
exponential-backoff rate limiting, plus the chunked parallel-for that backs
the scheduler's Parallelizer (workqueue.ParallelizeUntil).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional


class RateLimitingQueue:
    """Dedup work queue + per-item exponential backoff
    (workqueue/{queue,delaying_queue,rate_limiting_queue}.go). Items being
    processed that are re-added are marked dirty and requeued on done()
    (queue.go's dirty/processing sets)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0,
                 now_fn=time.monotonic):
        self._lock = threading.Condition()
        self._queue: List[object] = []
        self._dirty: set = set()
        self._processing: set = set()
        self._failures: Dict[object, int] = {}
        self._waiting: List = []  # heap of (ready_at, seq, item)
        self._seq = itertools.count()
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.now_fn = now_fn
        self._shutdown = False

    # -- plain queue

    def add(self, item) -> None:
        with self._lock:
            if self._shutdown or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return  # requeued by done()
            self._queue.append(item)
            self._lock.notify()

    def get(self, timeout: float = 0.0) -> Optional[object]:
        with self._lock:
            self._flush_waiting_locked()
            if not self._queue and timeout > 0:
                self._lock.wait(timeout)
                self._flush_waiting_locked()
            if not self._queue:
                return None
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item) -> None:
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._lock.notify()

    # -- rate-limited add

    def num_requeues(self, item) -> int:
        with self._lock:
            return self._failures.get(item, 0)

    def add_rate_limited(self, item) -> None:
        """Queue after the item's exponential backoff delay
        (rate_limiting_queue.go AddRateLimited + ItemExponentialFailureRateLimiter)."""
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            delay = min(self.base_delay * (2 ** n), self.max_delay)
            heapq.heappush(self._waiting, (self.now_fn() + delay, next(self._seq), item))

    def forget(self, item) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def _flush_waiting_locked(self) -> None:
        now = self.now_fn()
        while self._waiting and self._waiting[0][0] <= now:
            _, _, item = heapq.heappop(self._waiting)
            if item not in self._dirty and item not in self._processing:
                self._dirty.add(item)
                self._queue.append(item)

    def flush_waiting(self) -> None:
        with self._lock:
            self._flush_waiting_locked()
            self._lock.notify_all()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


def chunk_size_for(n: int, parallelism: int) -> int:
    """max(1, min(√n, n/parallelism+1)) — the scheduler Parallelizer's
    chunking (parallelize/parallelism.go:41 chunkSizeFor)."""
    return max(1, min(int(n ** 0.5), n // parallelism + 1))


def parallelize_until(workers: int, pieces: int, do_work: Callable[[int], None],
                      chunk_size: Optional[int] = None) -> None:
    """workqueue.ParallelizeUntil: run do_work(0..pieces-1) over a worker
    pool in chunks. Sequential when workers<=1 or the work is tiny (the
    Python analog: threads only pay off for released-GIL work)."""
    if pieces <= 0:
        return
    if chunk_size is None:
        chunk_size = chunk_size_for(pieces, max(workers, 1))
    if workers <= 1 or pieces <= chunk_size:
        for i in range(pieces):
            do_work(i)
        return
    chunks = [(s, min(s + chunk_size, pieces)) for s in range(0, pieces, chunk_size)]
    idx_lock = threading.Lock()
    pos = itertools.count()

    def _worker():
        while True:
            with idx_lock:
                i = next(pos)
            if i >= len(chunks):
                return
            start, end = chunks[i]
            for j in range(start, end):
                do_work(j)

    threads = [threading.Thread(target=_worker, daemon=True) for _ in range(min(workers, len(chunks)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
