"""The commit side of the scheduler loop (a trimmed copy of
``kubernetes_tpu/backend/commit_plane.py``).

- ``materialize_result``: the one blocking read of a dispatched batch, its
  packed block (``:380-406``), counted as a ``fetch`` transfer.
- ``materialize_profiled`` (``:409-455``): with telemetry off it is
  ``materialize_result`` after one read of the recorder. With it on, the
  end event the dispatch recorded after the batch program is synchronized
  first (JAX's ``block_until_ready``): the clock after it is the end of
  execution, the clock after the read the end of the wait, and the events'
  ``elapsed_time`` the program's own time on the card (``deviceExecS``).
  The dispatch ledger splits the wait into dwell, exec and fetch, and the
  ``device.dispatch.*`` spans are emitted under the open
  ``device.commit.wait``. Unlike JAX, an exception from that synchronize
  is not swallowed: it is the card failing, and it reaches the loop's
  relay death path as a failed read does.
- ``CommitWorker`` (whole, ``:456-549``): one thread that commits the
  in-flight batches handed to it, strictly in the order given, so that
  batch K's host commit overlaps batch K+1's encode, dispatch and device
  run. The commit function handles its own failures; anything else it
  raises is kept and raised again by the next ``flush``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np

from ..testing import locktrace
from . import telemetry
from .batch import unpack_result_block


def materialize_result(disp, n_nodes: int) -> Tuple[np.ndarray, np.ndarray,
                                                     Optional[np.ndarray],
                                                     Optional[np.ndarray]]:
    """(node_idx, first_fail, slice_words, quota_words) of a dispatched
    batch (``batch_scheduler.DispatchedBatch``): wait for its staged copy's
    event, then unpack the block on the host."""
    if disp.ready is not None:
        disp.ready.synchronize()
    telemetry.transfer("fetch", _nbytes(disp.block))
    return unpack_result_block(disp.block, n_nodes, quota_col=disp.quota_col)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def materialize_profiled(disp, n_nodes: int, *, program: str, bucket: Optional[str] = None,
                         t_submit: Optional[float] = None,
                         now_fn: Callable[[], float] = time.perf_counter,
                         batch_id: str = "", pods: int = 0) -> Tuple[tuple, Optional[dict]]:
    """(``materialize_result``'s tuple, the dispatch record or None when
    telemetry is off)."""
    rec = telemetry.get()
    if rec is None:
        return materialize_result(disp, n_nodes), None
    t_wait0 = now_fn()
    device_exec_s = None
    if disp.exec_events is not None:
        start, end = disp.exec_events
        end.synchronize()  # a failing card raises here, to the relay death path
        device_exec_s = start.elapsed_time(end) / 1e3
    t_exec_done = now_fn()
    out = materialize_result(disp, n_nodes)
    t_wait_end = now_fn()
    record = rec.dispatch_ledger.record_window(
        program, bucket, batch_id=batch_id, pods=pods,
        t_submit=t_submit if t_submit is not None else t_wait0, t_wait0=t_wait0,
        t_exec_done=t_exec_done, t_wait_end=t_wait_end, fetch_bytes=_nbytes(disp.block),
        device_exec_s=device_exec_s)
    telemetry.emit_phase_spans(record)
    return out, record


class CommitWorker:
    """One background thread committing in-flight batches in submission
    order. ``commit_fn`` owns every failure of a commit; an exception that
    still escapes it is kept and raised by the next ``flush``, so a drain
    never loses a batch silently."""

    def __init__(self, commit_fn: Callable[[object], None], name: str = "ktpu-commit"):
        self._commit_fn = commit_fn
        self._name = name
        self._cv = threading.Condition(locktrace.make_lock("CommitWorker"))
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
