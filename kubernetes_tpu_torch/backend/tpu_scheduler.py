"""TPUScheduler: the batched scheduler loop, which on this port runs its
batch program on the CUDA card (``kubernetes_tpu/backend/tpu_scheduler.py
:136-2043``; the class keeps its JAX name so that readers find its
counterpart).

One ``schedule_batch_cycle`` (``:494``):
  1. pop up to ``sizer.target()`` pods in queue order, skipping those that
     are gone, bound or another scheduler's;
  2. encode the batch (tie-break seeds from each pod's key and queue
     attempts, ``seeds_for``; the pod axis padded to the sizer's bucket):
     on the device carry of the newest batch in flight when nothing
     external changed since the chain's last sync (``_try_pipelined_encode``),
     else after landing the ring, updating the cache snapshot and syncing
     the device mirror, growing exactly the capacity axis a CapacityError
     names (``_resync_grown``);
  3. dispatch the batch program once (the fused CUDA kernel for a full
     mode-``off`` batch; the scan for a sampled batch or a topology mode, or
     the speculative rounds, as ``spec_decode_eligible`` picks), adopt its
     carry, start the packed block's copy to the host, and put the batch in
     the in-flight ring;
  4. commit the ring's oldest batches past ``KTPU_PIPELINE_DEPTH`` in
     order (``_commit_inflight``): the one blocking read, the mirror
     advanced, then the JAX commit order (``_commit_batch_coalesced``,
     ``:1217``) in one queue-move window: every unplaced pod gets a
     Diagnosis from its first-fail row and takes the failure path
     (PostFilter with the device preemption screen's hints, nomination,
     requeue); then the winners are assumed in the cache, bound through the
     store and finished; then ``DeviceState.reconcile``.

The ring (``:214-262``): ``KTPU_PIPELINE_DEPTH=0`` commits each batch
right after its dispatch; depth K (default 2) keeps K dispatched batches in
flight. ``KTPU_COMMIT_WORKER=1`` hands each commit to a ``CommitWorker``
thread; the device mutex (``device_mutex``) keeps its adopt, screen and
reconcile apart from the scheduling thread's sync, encode and dispatch.
The worker is off by default on the CPU and on CUDA, where the JAX loop
turns it on: ``run_until_settled`` sleeps on cycles whose batch the worker
has not landed yet, which costs more than its overlap gains (ROADMAP P11).
With the worker, the carry chain holds while ``external_change_seq`` holds
and no commit invalidated a row, and the failure path's PostFilter reads
the worker's own snapshot, refreshed just before it (the JAX loop's reads
the scheduling thread's, as old as the chain's last sync); inline, the
chain holds while ``DeviceState.has_dirty`` finds nothing. A commit that raises
(``relay_fault_fn``, the tests' hook, raises at the read) poisons every
batch in flight back to backoffQ and drops the mirror, which the next
batch rebuilds. With no external events and no failures, placements equal
the synchronous loop's; with failures the requeue order depends on the
worker's timing, as in the JAX package.

percentageOfNodesToScore follows ``:737-764``: an explicit percentage
samples ``num_feasible_nodes_to_find(nodes)``; the default (0) evaluates
the full batch on CUDA and samples on the CPU (``KTPU_FULL_BATCH=1/0``
overrides), and each sampled batch's window starts where the last one's
ended (``final_sample_start``). A preemption victim is deleted in the
store, so its DELETED event wakes the nominated pod, as in the JAX loop.

Left out: the relay breaker, telemetry, tracing and the latency ledger;
the sequential fallback path (a capacity that does not converge raises
PermanentDeviceError); the gang, slice, quota, claim and volume arguments.
Raised as NotImplementedError at pop, before any device work, for what the
loop's gang and quota slice brings: pods with claims or volumes, gang and
slice pods, and a store holding SchedulingQuota objects.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..api.types import Pod
from ..apiserver.store import Store
from ..cache.snapshot import Snapshot
from ..framework.plugins.coscheduling import pod_group_key
from ..framework.profile import ATTRIBUTION_ORDER
from ..framework.types import Diagnosis, QueuedPodInfo
from ..metrics.scheduler_metrics import ERROR, SCHEDULED, UNSCHEDULABLE
from ..ops.encode import CapacityError
from ..ops.slice import is_slice_pod
from ..ops.tiebreak import seeds_for
from ..scheduler.scheduler import Scheduler
from ..utils.device import DeviceLike, resolve_device
from .batch_scheduler import (DeviceBatch, DispatchedBatch, EncodedBatch, adopt_device_batch,
                              dispatch_device_batch, encode_device_batch, preempt_screen)
from .commit_plane import CommitWorker, materialize_result
from .device_state import DeviceState, caps_for_cluster
from .errors import PermanentDeviceError
from .sizer import BatchSizer

# host seconds per stage on the scheduling thread, summed over its cycles:
# the pop, the cache snapshot update (and the carry probe), the device sync
# (and capacity growth), encode, dispatch, and the commits it ran or waited
# for (inline commits, the worker's backpressure, drains)
LOOP_STAGES = ("pop", "snapshot", "sync", "encode", "dispatch", "commit")
# host seconds of the commits, on whichever thread ran them: the blocking
# read of the packed block, the commit itself (failures, preemption,
# assume, bind) and reconcile
COMMIT_STAGES = ("wait", "bind", "reconcile")
# the sync-and-encode attempts, each after one capacity growth
GROW_ATTEMPTS = 8


def _default_full_batch(device: torch.device) -> bool:
    """Whether the adaptive percentageOfNodesToScore default (0) evaluates
    the full batch: on CUDA yes, on the CPU the reference's adaptive sample
    (``tpu_scheduler.py:99``). ``KTPU_FULL_BATCH=1/0`` overrides."""
    env = os.environ.get("KTPU_FULL_BATCH", "")
    if env in ("0", "1"):
        return env == "1"
    return device.type == "cuda"


def loop_unsupported_reason(pod: Pod, store: Store) -> Optional[str]:
    """Why the loop cannot schedule ``pod`` yet, or None."""
    if pod.spec.resource_claims or pod.spec.volumes or pod.spec.ephemeral_claims:
        return ("resource claims or volumes (their commit checks meet the loop's store "
                "with the gang and quota part of the loop)")
    if pod_group_key(pod) is not None or is_slice_pod(pod):
        return "gang or slice membership (Permit and gang activation are not ported yet)"
    if store.scheduling_quotas:
        return ("a store holding SchedulingQuota objects (the PreEnqueue gate and the "
                "release moves are not ported yet)")
    return None


@dataclasses.dataclass
class _Inflight:
    """One dispatched batch not yet committed (``:66-96``). Its result's
    device tensors and its packed block's host copy live until its commit."""

    qps: List[QueuedPodInfo]
    disp: DispatchedBatch
    pod_cycle: int
    t0: float              # the batch's pop time: the attempt-latency clock
    mode_info: tuple       # (mode, vd, host_key): the carry's shape
    bucket: int            # the pod axis the program ran at
    # the DeviceState it was computed on: a commit that finds another one
    # poisons the batch instead of committing it against a rebuilt mirror
    state: DeviceState
    stream: Optional[torch.cuda.Stream]  # the dispatch stream (CUDA)


class _Laps:
    """Adds the time since its last call to a stage of ``seconds``."""

    def __init__(self, seconds: Dict[str, float]):
        self.seconds = seconds
        self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        t = time.perf_counter()
        self.seconds[stage] += t - self.t
        self.t = t


def _on_stream(stream: Optional[torch.cuda.Stream]):
    """The dispatch stream and its device as current on this thread (the
    commit worker's thread starts with neither); nothing on the CPU."""
    if stream is None:
        return contextlib.nullcontext()
    scope = contextlib.ExitStack()
    scope.enter_context(torch.cuda.device(stream.device))
    scope.enter_context(torch.cuda.stream(stream))
    return scope


class TPUScheduler(Scheduler):
    def __init__(self, store: Store, device: DeviceLike = None, batch_size: int = 128,
                 batch_deadline_ms: Optional[float] = None, **kwargs):
        self.device = resolve_device(device)
        super().__init__(store, **kwargs)
        self.batch_size = batch_size
        if batch_deadline_ms is None:
            batch_deadline_ms = float(os.environ.get("KTPU_BATCH_DEADLINE_MS", "500"))
        self.sizer = BatchSizer(batch_size, batch_deadline_ms / 1000.0)
        self.state: Optional[DeviceState] = None
        self.batch_counter = 0
        self.batch_modes: List[str] = []
        self.batch_paths: List[str] = []  # "fused", "scan" or "spec" per batch
        self.batch_pods: List[int] = []     # the pods of each batch
        self.batch_buckets: List[int] = []  # the pod axis each batch ran at
        self.stage_seconds = dict.fromkeys(LOOP_STAGES, 0.0)
        self.commit_seconds = dict.fromkeys(COMMIT_STAGES, 0.0)
        self.cycle_seconds: List[float] = []  # host seconds of each cycle that ran a batch
        # the sampling window's start: a 0-d device tensor chained from each
        # sampled batch's final_sample_start (schedule_one.go:475 rotation)
        self._start_carry: Optional[torch.Tensor] = None
        # a scripted device fault: called with "commit" before each batch's
        # read; an exception it returns is raised there and poisons the ring
        self.relay_fault_fn: Optional[Callable[[str], Optional[BaseException]]] = None
        self.pipeline_depth = max(0, int(os.environ.get("KTPU_PIPELINE_DEPTH", "2")))
        self._inflight: Deque[_Inflight] = deque()
        self.pipelined_batches = 0  # batches committed out of a ring of depth > 0
        self.carry_batches = 0      # batches encoded on the newest batch's carry
        # serializes the scheduling thread's sync, encode and dispatch with
        # a commit's adopt, preemption screen and reconcile
        self.device_mutex = threading.RLock()
        self.commit_worker: Optional[CommitWorker] = None
        if self.pipeline_depth and os.environ.get("KTPU_COMMIT_WORKER", "0") == "1":
            self.commit_worker = CommitWorker(self._commit_inflight)
        # the worker reconciles, and runs PostFilter, against a snapshot of
        # its own: the scheduling thread owns self.snapshot
        self._commit_snapshot = Snapshot()
        # host spans (perf_counter start, end) per batch: the scheduling
        # thread's encode and dispatch, and each commit after its read (on
        # the worker, the part that needs the GIL)
        self.dispatch_spans: List[tuple] = []
        self.commit_spans: List[tuple] = []
        # the carry gate of worker mode: the external-change count at the
        # chain's last full sync, and whether a commit invalidated a row
        self._chain_ext_seq = -1
        self._chain_dirty = False

    def close(self) -> None:
        """Commit every batch in flight and end the commit worker's thread."""
        self._drain_inflight()
        if self.commit_worker is not None:
            self.commit_worker.stop()

    # ------------------------------------------------------------- device

    def _ensure_device(self) -> None:
        """Build the device mirror, or rebuild it with a doubled node axis
        when the cluster outgrew it (after landing the ring: its batches
        belong to the old mirror). Runs on the scheduling thread; the drain
        stays outside the device mutex, which the worker needs to finish."""
        n = max(self.cache.node_count(), 1)
        mutex = self.device_mutex
        with mutex:
            state = self.state
            needs_grow = state is not None and state.caps.nodes < n
        if state is None:
            with mutex:
                if self.state is None:
                    self.state = DeviceState(caps_for_cluster(n, batch=self.batch_size),
                                             self.device, self.store.ns_labels)
                    self.state.sync(self.snapshot)
            return
        if not needs_grow:
            return
        self._drain_inflight()
        if self.state is None:  # the drain's commit dropped the mirror
            self._ensure_device()
            return
        with mutex:
            caps = self.state.caps
            nodes = caps.nodes
            while nodes < n:
                nodes *= 2
            caps = dataclasses.replace(caps, nodes=nodes,
                                       value_words=max(caps.value_words, (nodes + 2 + 31) // 32))
            self.state = DeviceState(caps, self.device, self.store.ns_labels)
            self.state.sync(self.snapshot)

    # CapacityError.dimension -> the Capacities fields to double (the names
    # ops/encode.py and backend/sig_table.py raise; "value vocab for 'key'"
    # by its prefix)
    _GROW_FIELDS = {
        "nodes": ("nodes",),
        "pods": ("pods",),
        "resources": ("resources",),
        "label_keys": ("label_keys",),
        "taints": ("taints",),
        "tolerations": ("tolerations",),
        "exprs": ("exprs",),
        "sel_exprs": ("sel_exprs",),
        "terms": ("terms",),
        "term_exprs": ("term_exprs",),
        "pref_terms": ("pref_terms",),
        "ports": ("ports",),
        "ports vocab": ("port_words",),
        "image vocab": ("image_words", "images"),
        "containers": ("containers",),
        "sigs": ("sigs",),
        "ex_terms": ("ex_terms",),
        "spread_cons": ("spread_cons",),
        "ipa_terms": ("ipa_terms",),
        "ipa_pref": ("ipa_pref",),
        "prio_classes": ("prio_classes",),
        "superpods": ("superpods",),
        "sp_slots": ("sp_slots",),
    }

    def _resync_grown(self, err: CapacityError) -> None:
        """Double exactly the capacity axis ``err`` names until it covers
        ``err.needed``, rebuild the mirror and sync it (``:386-411``).
        Called outside the device mutex: the drain needs the worker."""
        self._drain_inflight()
        if self.state is None:  # the drain's commit dropped the mirror
            self._ensure_device()
            return
        fields = self._GROW_FIELDS.get(err.dimension)
        if fields is None and err.dimension.startswith("value vocab"):
            fields = ("value_words",)
        if fields is None:
            raise PermanentDeviceError(
                f"unknown capacity dimension {err.dimension!r}") from err
        with self.device_mutex:
            caps = self.state.caps
            updates = {}
            for f in fields:
                v = getattr(caps, f)
                while v < err.needed:
                    v *= 2
                updates[f] = v
            self.state = DeviceState(dataclasses.replace(caps, **updates), self.device,
                                     self.store.ns_labels)
            self.state.sync(self.snapshot)

    def _invalidate_device_row(self, name: str) -> None:
        """The host rejects a row the device committed to: the next sync
        repairs it (``DeviceState.invalidate_row``), and the carry chain
        breaks."""
        with self.device_mutex:
            if self.state is not None:
                self.state.invalidate_row(name)
        self._chain_dirty = True

    # ------------------------------------------------------------- the cycle

    def _periodic_housekeeping(self, now: Optional[float] = None) -> None:
        """Land the worker's commits before the 1 s sweep, so that it judges
        settled state (``:596-610``); one clock read serves both."""
        if now is None:
            now = self.now_fn()
        if (self.commit_worker is not None and now - self._last_cleanup >= 1.0
                and not self.commit_worker.idle()):
            self.commit_worker.flush()
        super()._periodic_housekeeping(now)

    def schedule_batch_cycle(self) -> int:
        """Schedule up to one batch; returns the pods popped."""
        laps = _Laps(self.stage_seconds)
        t0 = laps.t
        self._periodic_housekeeping()
        qps = self.queue.pop_batch(self.sizer.target())
        if not qps:
            # nothing to overlap with: land the ring, so its failures are
            # requeued before the caller judges settlement
            self._drain_inflight()
            laps("commit")
            return 0
        t_pop = self.now_fn()
        pod_cycle = self.queue.scheduling_cycle
        live = []
        for qp in qps:
            pod = self.store.get_pod(qp.pod.key())
            if pod is None or pod.spec.node_name or not self._responsible_for(pod):
                continue  # skipPodSchedule
            reason = loop_unsupported_reason(pod, self.store)
            if reason is not None:
                raise NotImplementedError(f"pod {pod.key()}: {reason}")
            live.append((qp, pod))
        self._ensure_device()
        batch: List[QueuedPodInfo] = []
        for qp, pod in live:
            qp.pod = pod
            batch.append(qp)
        laps("pop")
        if batch:
            self._flush_batch(batch, pod_cycle, t_pop, laps)
            self.cycle_seconds.append(time.perf_counter() - t0)
        return len(qps)

    def _sample_args(self):
        """(sample_k, sample_start) of the next batch, or (None, None) for a
        full batch (``tpu_scheduler.py:737-764``)."""
        n_valid = self.cache.node_count()
        if self.percentage_of_nodes_to_score or not _default_full_batch(self.device):
            k = self.num_feasible_nodes_to_find(n_valid)
        else:
            k = n_valid
        if k >= n_valid:
            return None, None
        start = self._start_carry
        if start is None:
            start = torch.zeros((), dtype=torch.int32, device=self.device)
        return k, start

    def _encode(self, batched: List[QueuedPodInfo]) -> EncodedBatch:
        pods = [qp.pod for qp in batched]
        return encode_device_batch(self.state, pods, tie_seeds=seeds_for(batched),
                                   capacity=self.sizer.bucket_for(len(pods)))

    def _flush_batch(self, batched: List[QueuedPodInfo], pod_cycle: int, t_pop: float,
                     laps: _Laps) -> None:
        """Encode, dispatch and ring one batch (``_flush_batch_traced``,
        ``:657-880``), then commit what passed the ring's depth."""
        mutex = self.device_mutex
        t_work = laps.t
        with mutex:
            enc = self._try_pipelined_encode(batched, laps)
            state = self.state
        if enc is not None:
            self.carry_batches += 1
        else:
            self._drain_inflight()
            self._ensure_device()  # the drain's commit may have dropped it
            laps("commit")
            t_work = laps.t
            # the gate's baseline, read before the snapshot update: an event
            # racing in after it reads as a change at the next probe
            ext_seq = self.external_change_seq()
            self.cache.update_snapshot(self.snapshot)
            laps("snapshot")
            for _attempt in range(GROW_ATTEMPTS):
                try:
                    with mutex:
                        self.state.sync(self.snapshot)
                        laps("sync")
                        enc = self._encode(batched)
                        laps("encode")
                        state = self.state
                    break
                except CapacityError as err:
                    # outside the mutex: the growth drains, and the worker
                    # needs the mutex to finish its commits
                    self._resync_grown(err)
                    laps("sync")
            else:
                raise PermanentDeviceError(
                    f"capacities did not converge in {GROW_ATTEMPTS} growths")
            self._chain_ext_seq = ext_seq
            self._chain_dirty = False
        self.batch_counter += 1
        # the cross-batch topology carry: the newest batch in flight's
        # evolved counts (after a drain the host recounted them: no carry)
        prev = self._inflight[-1] if self._inflight else None
        carry = None
        if prev is not None and prev.disp.res.final_sel_counts is not None:
            carry = (prev.disp.res.final_sel_counts, prev.disp.res.final_seg_exist)
        sample_k, sample_start = self._sample_args()
        with mutex:
            if self.state is not state:
                # a commit dropped or rebuilt the mirror between encode and
                # dispatch: requeue the batch as a poisoned one
                with self.queue.coalesce_moves():
                    for qp in batched:
                        self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                return
            disp = dispatch_device_batch(state, enc, sample_k, sample_start, carry)
            if disp.res.final_sample_start is not None:
                self._start_carry = disp.res.final_sample_start
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)
            self._inflight.append(_Inflight(batched, disp, pod_cycle, t_pop,
                                            (enc.mode, enc.vd, enc.host_key),
                                            enc.pb.capacity, state, stream))
        laps("dispatch")
        self.dispatch_spans.append((t_work, laps.t))
        self.batch_modes.append(enc.mode)
        self.batch_paths.append(disp.path)
        self.batch_pods.append(len(batched))
        self.batch_buckets.append(enc.pb.capacity)
        # land the oldest batches past the ring's depth: inline, or handed
        # to the worker behind a bounded backlog
        while len(self._inflight) > self.pipeline_depth:
            fl = self._inflight.popleft()
            if self.pipeline_depth:
                self.pipelined_batches += 1
            if self.commit_worker is not None:
                backlog = max(1, self.pipeline_depth)
                if self.commit_worker.depth() >= backlog:
                    self.commit_worker.wait_below(backlog)
                self.commit_worker.submit(fl)
            else:
                self._commit_inflight(fl)
        laps("commit")

    def _try_pipelined_encode(self, batched: List[QueuedPodInfo],
                              laps: _Laps) -> Optional[EncodedBatch]:
        """Encode the batch on the newest batch in flight's carry, or None
        for the drain-and-sync path (``:882-932``): legal only while nothing
        external changed since the chain's sync and the encode registers no
        signature or term (a new row is backfilled from host counts that
        cannot see the batches in flight) and keeps the carry's shape.
        Caller holds the device mutex."""
        if not self.pipeline_depth or not self._inflight or self.state is None:
            return None
        if self.commit_worker is not None:
            # the worker's own commits dirty the cache: gate on events
            if self._chain_dirty or self.external_change_seq() != self._chain_ext_seq:
                return None
        else:
            self.cache.update_snapshot(self.snapshot)
            dirty = self.state.has_dirty(self.snapshot)
            laps("snapshot")
            if dirty:
                return None
        st = self.state.sig_table
        vocab0 = (st.n_sigs, st.n_terms)
        try:
            enc = self._encode(batched)
        except CapacityError:
            return None  # grown on the drain-and-sync path
        finally:
            laps("encode")
        if (st.n_sigs, st.n_terms) != vocab0:
            return None
        if (enc.mode, enc.vd, enc.host_key) != self._inflight[-1].mode_info:
            return None
        return enc

    def _drain_inflight(self) -> None:
        """Land every batch in flight, oldest first; with the worker, hand
        it the rest of the ring and block on its flush (``:934-946``)."""
        if self.commit_worker is not None:
            while self._inflight:
                self.commit_worker.submit(self._inflight.popleft())
            self.commit_worker.flush()
            return
        while self._inflight:
            self._commit_inflight(self._inflight.popleft())

    # ------------------------------------------------------------- commit

    def _commit_inflight(self, fl: _Inflight) -> None:
        """Land one dispatched batch (``:948-1092``), on the scheduling
        thread or the worker: the one blocking read, the mirror advanced,
        the commit, then ``reconcile`` (against the worker's own snapshot
        on the worker), which refreshes the rows whose only change was a
        commit so the next encode keeps the carry. A failure anywhere here
        poisons the whole ring back to the queue and drops the mirror."""
        mutex = self.device_mutex
        on_worker = self.commit_worker is not None
        if fl.state is not self.state:
            # computed on a mirror since dropped or rebuilt: requeue it
            self._poison_batches((fl,), RuntimeError("device rebuilt while batch in flight"))
            return
        wait: Optional[float] = None
        laps = _Laps(self.commit_seconds)
        try:
            with _on_stream(fl.stream):
                if self.relay_fault_fn is not None:
                    fault = self.relay_fault_fn("commit")
                    if fault is not None:
                        raise fault
                t_wait = self.now_fn()
                read = materialize_result(fl.disp, self.state.caps.nodes)
                wait = self.now_fn() - t_wait
                laps("wait")
                t_host = laps.t
                batch = adopt_device_batch(self.state, fl.disp, read, mutex)
                with self.queue.coalesce_moves():
                    self._commit_batch(fl.qps, batch, fl.pod_cycle, fl.t0)
                laps("bind")
                if self.state is not None:
                    snap = self._commit_snapshot if on_worker else self.snapshot
                    with mutex:
                        self.cache.update_snapshot(snap)
                        left = self.state.reconcile(snap)
                    if left:
                        self._chain_dirty = True
                laps("reconcile")
                self.commit_spans.append((t_host, laps.t))
        except Exception as exc:  # noqa: BLE001 - the loop requeues and rebuilds
            logging.getLogger(__name__).exception("batch commit failed; requeueing the ring")
            with mutex:
                self.state = None  # rebuilt by the next batch
            self._start_carry = None
            if self.commit_worker is not None:
                stale = self.commit_worker.steal_pending()
            else:
                stale = list(self._inflight)
                self._inflight.clear()
            self._poison_batches((fl, *stale), exc)
        # the sizer controls pop-to-commit at the batch's bucket: observed
        # here, where the span ends; the commit wait feeds the stall model
        self.sizer.update(fl.bucket, self.now_fn() - fl.t0)
        if wait is not None:
            self.sizer.update_wait(fl.bucket, wait)

    def _poison_batches(self, batches, exc: BaseException) -> None:
        """Fail batches in flight back to the queue, each pod through the
        error path to backoffQ, in one queue-move window (``:1094-1123``)."""
        logging.getLogger(__name__).warning("requeueing %d batches: %s", len(batches), exc)
        with self.queue.coalesce_moves():
            for fl in batches:
                for qp in fl.qps:
                    self._handle_scheduling_failure(qp, False, Diagnosis(), fl.pod_cycle)

    def _diagnose(self, ff_row: np.ndarray, slot_names: Dict[int, str]) -> Diagnosis:
        """The first failing filter of each node, from the device's
        first-fail ids (``tpu_scheduler.py:1754``)."""
        d = Diagnosis()
        for slot in np.nonzero(ff_row)[0]:
            name = slot_names.get(int(slot))
            if name is None:
                continue
            plugin, reason = ATTRIBUTION_ORDER[int(ff_row[slot]) - 1]
            d.node_to_status[name] = reason
            d.unschedulable_plugins.add(plugin)
        return d

    def _commit_batch(self, qps: List[QueuedPodInfo], batch: DeviceBatch, pod_cycle: int,
                      t0: float) -> None:
        """``_commit_batch_coalesced``: failures in batch order, then the
        winners' assume, bind and finish. The preemption screen runs on the
        adopted carry under the device mutex."""
        node_idx, slot_names = batch.node_idx, batch.slot_names
        n = len(qps)
        winners = {i: slot_names.get(int(node_idx[i])) for i in range(n) if node_idx[i] >= 0}
        missing = self.cache.missing_real_nodes(name for name in winners.values() if name)
        hints = None
        if (node_idx[:n] < 0).any():
            if self.commit_worker is not None:
                # PostFilter reads the worker's snapshot: bring it up to the
                # binds and evictions committed since its last refresh
                self.cache.update_snapshot(self._commit_snapshot)
            with self.device_mutex:
                screen, best = preempt_screen(self.state, [qp.pod for qp in qps], batch,
                                              self.cache.min_pod_priority())
                hints = (screen, best, dict(self.state.encoder.node_slots))
        binds = []
        for i, qp in enumerate(qps):
            self.metrics.inc("schedule_attempts")
            if i in winners:
                name = winners[i]
                if name is None or name in missing:
                    # a stale slot, or its node left while the batch was
                    # decided: requeue, never bind
                    if name is not None:
                        self._invalidate_device_row(name)
                        self.metrics.inc("errors")
                    self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                    self.smetrics.observe_attempt(ERROR, self.profile.name, self.now_fn() - t0)
                    continue
                binds.append((qp, name))
                continue
            diagnosis = self._diagnose(batch.first_fail[i], slot_names)
            screen, best, slot_of = hints
            b = int(best[i])
            pod_hints = (screen[i], slot_of, slot_names.get(b) if b >= 0 else None)
            self._handle_scheduling_failure(qp, True, diagnosis, pod_cycle, pod_hints)
            self.smetrics.observe_attempt(UNSCHEDULABLE, self.profile.name, self.now_fn() - t0)
        if binds:
            self._commit_bindings(binds, pod_cycle, t0)

    def _commit_bindings(self, binds: List[tuple], pod_cycle: int, t0: float) -> None:
        """The bind tail of a batch (``commit_plane.py:155``): every winner
        assumed in the cache, the winners bound through the store in one
        pass, the bound ones finished. ``binds``: (queued pod, node) per
        winner, in batch order. A winner whose assume or bind fails is rolled
        back, takes the error path, and its device row is invalidated (the
        device committed to it)."""
        live = []
        for qp, name in binds:
            assumed = qp.pod.clone()
            try:
                self.cache.assume_pod(assumed, name)
            except KeyError:
                self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                self._invalidate_device_row(name)
                continue
            self.profile.nominator.delete_nominated_pod_if_exists(qp.pod)
            live.append((qp, name, assumed))
        outcomes = self.store.bind_batch([(a.key(), name) for _qp, name, a in live])
        now = self.now_fn()
        for (qp, name, assumed), err in zip(live, outcomes):
            if err is not None:
                self.cache.forget_pod(assumed)
                self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                self._invalidate_device_row(name)
                continue
            self.cache.finish_binding(assumed)
            self.metrics.inc("scheduled")
            self.smetrics.observe_attempt(SCHEDULED, self.profile.name, now - t0)

    def _failure_snapshot(self) -> Snapshot:
        """With the worker, every failure path runs on it, against its own
        snapshot."""
        return self._commit_snapshot if self.commit_worker is not None else self.snapshot
