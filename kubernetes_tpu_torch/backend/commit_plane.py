"""The commit side of the scheduler loop (a trimmed copy of
``kubernetes_tpu/backend/commit_plane.py``).

- ``materialize_result``: the one blocking read of a dispatched batch, its
  packed block (``:380-406``), without the telemetry.
- ``CommitWorker`` (whole, ``:456-549``): one thread that commits the
  in-flight batches handed to it, strictly in the order given, so that
  batch K's host commit overlaps batch K+1's encode, dispatch and device
  run. The commit function handles its own failures; anything else it
  raises is kept and raised again by the next ``flush``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np

from .batch import unpack_result_block


def materialize_result(disp, n_nodes: int) -> Tuple[np.ndarray, np.ndarray,
                                                     Optional[np.ndarray],
                                                     Optional[np.ndarray]]:
    """(node_idx, first_fail, slice_words, quota_words) of a dispatched
    batch (``batch_scheduler.DispatchedBatch``): wait for its staged copy's
    event, then unpack the block on the host."""
    if disp.ready is not None:
        disp.ready.synchronize()
    return unpack_result_block(disp.block, n_nodes, quota_col=disp.quota_col)


class CommitWorker:
    """One background thread committing in-flight batches in submission
    order. ``commit_fn`` owns every failure of a commit; an exception that
    still escapes it is kept and raised by the next ``flush``, so a drain
    never loses a batch silently."""

    def __init__(self, commit_fn: Callable[[object], None], name: str = "ktpu-commit"):
        self._commit_fn = commit_fn
        self._name = name
        self._cv = threading.Condition(threading.Lock())
        self._pending: deque = deque()
        self._busy = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._surprise: Optional[BaseException] = None
        self.committed = 0

    def submit(self, item) -> None:
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name=self._name,
                                                daemon=True)
                self._thread.start()
            self._pending.append(item)
            self._cv.notify_all()

    def flush(self) -> None:
        """Block until every submitted batch has committed; raise what a
        commit let escape."""
        with self._cv:
            while self._pending or self._busy:
                self._cv.wait()
            surprise, self._surprise = self._surprise, None
        if surprise is not None:
            raise surprise

    def steal_pending(self) -> list:
        """Take the backlog not yet started (the ring's poison path fails
        those batches without committing them)."""
        with self._cv:
            out = list(self._pending)
            self._pending.clear()
            self._cv.notify_all()
            return out

    def depth(self) -> int:
        with self._cv:
            return len(self._pending) + (1 if self._busy else 0)

    def wait_below(self, n: int) -> None:
        """Backpressure: block until fewer than ``n`` batches are pending or
        running."""
        with self._cv:
            while len(self._pending) + (1 if self._busy else 0) >= n:
                self._cv.wait()

    def idle(self) -> bool:
        with self._cv:
            return not self._pending and not self._busy

    def stop(self) -> None:
        """End the thread once the backlog is committed."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._pending:
                    self._cv.notify_all()
                    return
                item = self._pending.popleft()
                self._busy = True
            try:
                self._commit_fn(item)
            except BaseException as exc:  # noqa: BLE001 - kept for flush, which raises it
                with self._cv:
                    self._surprise = exc
            finally:
                with self._cv:
                    self._busy = False
                    self.committed += 1
                    self._cv.notify_all()
