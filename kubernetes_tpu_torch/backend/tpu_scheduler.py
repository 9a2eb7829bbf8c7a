"""TPUScheduler: the batched scheduler loop, which on this port runs its
batch program on the CUDA card (``kubernetes_tpu/backend/tpu_scheduler.py
:136-2043``; the class keeps its JAX name so that readers find its
counterpart).

One ``schedule_batch_cycle`` (``:494``):
  1. pop up to ``sizer.target()`` pods in queue order, skipping those that
     are gone, bound or another scheduler's;
  2. update the cache snapshot and sync the device mirror;
  3. encode the batch with tie-break seeds from each pod's key and queue
     attempts (``seeds_for``), dispatch the batch program once (the fused
     CUDA kernel for a full mode-``off`` batch; the scan for a sampled
     batch or a topology mode, or the speculative rounds, as
     ``spec_decode_eligible`` picks), read its packed block once;
  4. commit in the JAX order (``_commit_batch_coalesced``, ``:1217``), in
     one queue-move window: every unplaced pod gets a Diagnosis from its
     first-fail row (``_diagnose``, ``:1754``) and takes the failure path
     (PostFilter with the device preemption screen's hints, nomination,
     requeue); then the winners are assumed in the cache, bound through
     the store, and their binding finished.

This is the synchronous path, the JAX package's ``KTPU_PIPELINE=0`` shape:
one batch is encoded, dispatched, read and committed before the next pop.
percentageOfNodesToScore follows ``:737-764``: an explicit percentage
samples ``num_feasible_nodes_to_find(nodes)``; the default (0) evaluates
the full batch on CUDA and samples on the CPU (``KTPU_FULL_BATCH=1/0``
overrides), and each sampled batch's window starts where the last one's
ended (``final_sample_start``). A preemption victim is deleted in the
store, so its DELETED event wakes the nominated pod, as in the JAX loop.

Raised as NotImplementedError at pop, before any device work, for what
the loop's gang and quota slice brings: pods with claims or volumes, gang
and slice pods, and a store holding SchedulingQuota objects. The node axis
grows when the cluster outgrows it; any other CapacityError raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.types import Pod
from ..apiserver.store import Store
from ..framework.plugins.coscheduling import pod_group_key
from ..framework.profile import ATTRIBUTION_ORDER
from ..framework.types import Diagnosis, QueuedPodInfo
from ..metrics.scheduler_metrics import ERROR, SCHEDULED, UNSCHEDULABLE
from ..ops.slice import is_slice_pod
from ..ops.tiebreak import seeds_for
from ..scheduler.scheduler import Scheduler
from ..utils.device import DeviceLike, resolve_device
from .batch_scheduler import DeviceBatch, preempt_screen, run_device_batch
from .device_state import DeviceState, caps_for_cluster
from .sizer import BatchSizer

# host seconds per stage of the loop, summed over its cycles: the pop, the
# cache snapshot update, the device sync, encode, dispatch, the blocking
# read, and the commit (failures, preemption, assume, bind)
LOOP_STAGES = ("pop", "snapshot", "sync", "encode", "dispatch", "read", "bind")


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
        self.stage_seconds = dict.fromkeys(LOOP_STAGES, 0.0)
        self.cycle_seconds: List[float] = []  # host seconds of each cycle that ran a batch
        # the sampling window's start: a 0-d device tensor chained from each
        # sampled batch's final_sample_start (schedule_one.go:475 rotation)
        self._start_carry: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- device

    def _ensure_device(self) -> None:
        """Build the device mirror for the cluster's size, or rebuild it
        with a doubled node axis when the cluster outgrew it."""
        n = max(self.cache.node_count(), 1)
        if self.state is None:
            self.state = DeviceState(caps_for_cluster(n, batch=self.batch_size), self.device,
                                     self.store.ns_labels)
            self.state.sync(self.snapshot)
            return
        caps = self.state.caps
        if caps.nodes >= n:
            return
        nodes = caps.nodes
        while nodes < n:
            nodes *= 2
        caps = dataclasses.replace(caps, nodes=nodes,
                                   value_words=max(caps.value_words, (nodes + 2 + 31) // 32))
        self.state = DeviceState(caps, self.device, self.store.ns_labels)
        self.state.sync(self.snapshot)

    # ------------------------------------------------------------- the cycle

    def schedule_batch_cycle(self) -> int:
        """Schedule up to one batch; returns the pods popped."""
        t0 = time.perf_counter()
        self._periodic_housekeeping()
        qps = self.queue.pop_batch(self.sizer.target())
        if not qps:
            return 0
        t_pop = self.now_fn()
        pod_cycle = self.queue.scheduling_cycle
        batch: List[QueuedPodInfo] = []
        for qp in qps:
            pod = self.store.get_pod(qp.pod.key())
            if pod is None or pod.spec.node_name or not self._responsible_for(pod):
                continue  # skipPodSchedule
            reason = loop_unsupported_reason(pod, self.store)
            if reason is not None:
                raise NotImplementedError(f"pod {pod.key()}: {reason}")
            qp.pod = pod
            batch.append(qp)
        self.stage_seconds["pop"] += time.perf_counter() - t0
        if batch:
            self._flush_batch(batch, pod_cycle, t_pop)
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

    def _flush_batch(self, batched: List[QueuedPodInfo], pod_cycle: int, t_pop: float) -> None:
        self._ensure_device()
        stamps = [time.perf_counter()]
        self.cache.update_snapshot(self.snapshot)
        stamps.append(time.perf_counter())
        self.state.sync(self.snapshot)
        stamps.append(time.perf_counter())
        sample_k, sample_start = self._sample_args()
        pods = [qp.pod for qp in batched]
        batch = run_device_batch(self.state, pods, stamps, tie_seeds=seeds_for(batched),
                                 sample_k=sample_k, sample_start=sample_start)
        if batch.res.final_sample_start is not None:
            self._start_carry = batch.res.final_sample_start
        self.batch_counter += 1
        self.batch_modes.append(batch.mode)
        self.batch_paths.append(batch.path)
        with self.queue.coalesce_moves():
            self._commit_batch(batched, batch, pod_cycle, t_pop)
        stamps.append(time.perf_counter())
        for stage, a, b in zip(LOOP_STAGES[1:], stamps, stamps[1:]):
            self.stage_seconds[stage] += b - a
        bucket = self.sizer.bucket_for(len(batched))
        self.sizer.update(bucket, self.now_fn() - t_pop)

    # ------------------------------------------------------------- commit

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
        winners' assume, bind and finish."""
        node_idx, slot_names = batch.node_idx, batch.slot_names
        n = len(qps)
        winners = {i: slot_names.get(int(node_idx[i])) for i in range(n) if node_idx[i] >= 0}
        missing = self.cache.missing_real_nodes(name for name in winners.values() if name)
        hints = None
        if (node_idx[:n] < 0).any():
            screen, best = preempt_screen(self.state, [qp.pod for qp in qps], batch,
                                          self.cache.min_pod_priority())
            hints = (screen, best, dict(self.state.encoder.node_slots))
        binds = []
        for i, qp in enumerate(qps):
            self.metrics["schedule_attempts"] += 1
            if i in winners:
                name = winners[i]
                if name is None or name in missing:
                    # a stale slot, or its node left while the batch was
                    # decided: requeue, never bind
                    if name is not None:
                        self.state.invalidate_row(name)
                        self.metrics["errors"] += 1
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

    def _commit_bindings(self, binds, pod_cycle: int, t0: float) -> None:
        """The bind tail (``commit_plane.py:155``): assume every winner in the
        cache, bind them through the store in one pass, finish the bound
        ones; a winner whose assume or bind fails is rolled back and takes
        the error path, and its device row is repaired at the next sync."""
        live = []
        for qp, name in binds:
            assumed = qp.pod.clone()
            try:
                self.cache.assume_pod(assumed, name)
            except KeyError:
                self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                self.state.invalidate_row(name)
                continue
            self.profile.nominator.delete_nominated_pod_if_exists(qp.pod)
            live.append((qp, name, assumed))
        outcomes = self.store.bind_batch([(a.key(), name) for _qp, name, a in live])
        now = self.now_fn()
        for (qp, name, assumed), err in zip(live, outcomes):
            if err is not None:
                self.cache.forget_pod(assumed)
                self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                self.state.invalidate_row(name)
                continue
            self.cache.finish_binding(assumed)
            self.metrics["scheduled"] += 1
            self.smetrics.observe_attempt(SCHEDULED, self.profile.name, now - t0)
