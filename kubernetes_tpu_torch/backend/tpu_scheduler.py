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
     the device mirror, growing exactly the capacity axes the CapacityErrors
     name (``_resync_grown``);
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

Profiles (``:442-490``, ``:1140-1160``, ``:1778-1785``): a pod rides the
batch only when its profile's PreFilter, Filter, PreScore and Score lists
equal the default set's, names and weights, and every argument the batch
program has baked in is at its default (``_framework_batchable``, judged
once per profile at construction; ``BAKED_ARGS``). The JAX loop compares names and weights only,
so a profile that changes an argument rides its batch and is scored as if
it had not (ROADMAP C20). Pods of other profiles take the sequential path,
run by their profile's own plugins. A batch may mix pods of several
batchable profiles: each pod's framework is looked up at commit. No
preemption screen runs when no profile has a PostFilter
(``_preemption_wired``). The bind tail runs per profile, in the order a
profile's first pod appears, as the JAX commit plane does
(``_by_framework``).

Gangs, torus slices and namespace quota (``:548-572``, ``:998-1021``,
``:1262-1318``, ``:1385-1753``): at pop, the pod's profile's
QuotaAdmission PreFilter and then its Coscheduling PreFilter are the host
gates; a pod that fails one takes the failure path without a batch row. The batch program gets the slice gangs'
member index (the slice plan pins each member to its torus window) and the
quota screen's columns after the ledger's rows are synced
(``batch_scheduler.slice_batch_kw`` / ``quota_batch_kw``); the slice and
quota words ride the packed block. The commit then follows the JAX order:
the winners the quota screen flagged; the flat gangs' verdicts
(``batch_scheduler.judge_gangs``: one ``gang_verdicts`` call and one
read, the only read besides the packed block's and the preemption
screen's); the slice gangs' from their words, with ``slice_wait_duration``
and ``slice_fragmentation``; a stale or flagged member poisons its whole
gang; each rejected gang's ``reject_gang`` (and SlicePacking's
``forget_gang``); then in batch order a rejected gang's members, stale
winners and flagged winners surrender their rows and take the failure
path, and the other winners go through ``_commit_bindings``: assume,
Reserve, Permit (a gang member short of its quorum waits in
``waiting_pods``, assumed, until a later batch's member allows it), then
``_bind_stage``: bind, finish and PostBind (a parked pod that Permit
allows lands through it too). A pod whose assume, Reserve, Permit or bind
fails surrenders its row too.

Claims and volumes (``:442-471``, ``:670-706``, ``:1455-1505``,
``:2019``): at pop, a pod ``batch_supported`` refuses (a missing PVC, an
unbound immediate-mode PVC, a claim or class that does not resolve) takes
the sequential path (``_schedule_fallback``: ``Scheduler.schedule_one_pod``)
after the batch queued before it is dispatched and the ring has landed, so
pop order holds. The others ride the batch: the encode adds the host
volume screen (``ops/volume_mask.py``, built from the snapshot; with the
worker a batch with volumes takes the drain-and-sync path, as the screen
must read a snapshot the worker is not refreshing) and the claim mask
(``backend/claim_mask.py``, on the device). At commit, in batch order, each
winner is assumed at once, so the checks of a later volume or claim winner
see the batch's earlier winners, as the reference's assume-then-next order
does (the JAX loop assumes them after the loop: ROADMAP C9). A volume or
claim winner first runs every PreFilter (which resolves its claims again
and finds one deleted since the encode) and then the exact volume filters
on its node (``_verify_volumes_on_node``); a plain winner runs none
unless its profile has a Reserve, Permit or PreBind plugin outside the
default bind path (``_bind_path_needs_prefilter``, ``:1153``), which may
read PreFilter state. A pod failing either surrenders
its row and takes the sequential path right there, before the batch's
binds land, and counts in ``fallback_scheduled`` when that path binds it.
The winners then take the bind tail with their PreFilter state: Reserve
(QuotaAdmission, VolumeBinding's assumed PVs, DynamicResources'
allocations), Permit, PreBind (the PV binds), bind, PostBind (the claim
pods' PodSchedulingContext). Generic ephemeral volumes are read by no
plugin, as in the JAX package (ROADMAP C17).

The failure model (``:146-306``, ``:526-588``, ``:1070-1123``,
``:1787-2017``): a commit that raises at its read takes the relay death
path: the ring is poisoned back to backoffQ and the mirror dropped. A
``TransientDeviceError`` then counts against the relay breaker
(``backend/circuit.py``;
``relay_breaker_threshold`` failures in a row, ``KTPU_RELAY_BREAKER_THRESHOLD``,
3). While it is open a cycle touches no device state: every pod that
would have ridden the batch takes the sequential path in pop order
(``relay_degraded_pods``). Past ``relay_probe_interval_s``
(``KTPU_RELAY_PROBE_S``, 0.5 s) the cycle's batch is the half-open probe,
and a probe that commits closes the breaker; ``degraded_seconds`` streams
while it is open and books the rest at the close, ``backend_circuit_state``
follows each transition. A batch computed on a mirror since dropped is
poisoned without counting. Unlike the JAX loop, where any exception at
the read feeds the breaker, every other exception (a sticky CUDA error, a
CUDA out-of-memory, a fault of the commit code) is raised once the ring is
poisoned: the card is local and has no relay to lose, so a probe could
only hide a kernel or commit fault behind the host path. ``comparer_every_n`` checks a batch's landed winners
again with the host PreFilters and Filters (``_compare_with_oracle``).
``warm_buckets`` runs the batch program at every sizer bucket outside the
measured window and seeds the sizer from its timed runs
(``_calibrate_sizer``).

Observability (``:208-212``, ``:584-1123``, ``:1185-1228``, ``:1353``,
``:1427``, ``:1578``, ``:1685-1740``, ``:1832``; ``backend/telemetry.py``,
``metrics/latency_ledger.py``, ``utils/tracing.py``), each off by default
at the cost of one global read per hook, and changing no placement when
on. Each batch gets JAX's id ``b<batch_counter>``. Spans: one
``scheduling.cycle`` (``batch``) per flushed batch, with
``device.encode.pipelined``, ``device.sync`` and ``device.encode``,
``device.dispatch`` (``topo``), ``device.commit.backpressure``, and for
each commit landed inside it ``device.commit.wait`` (with the dispatch
ledger's ``device.dispatch.{dwell,exec,fetch}`` children), ``host.commit``
and ``device.commit.reconcile``; a commit landed by a drain outside a
flush roots its own. Flight events: ``encode``, ``dispatch`` (``sig`` =
``<bucket>/<mode>``), ``commit``, ``poison``, ``requeue``, ``degrade``,
``slot_reclaim``, ``slice_assign``, ``slice_reject``, ``frag_alert``
(edge-triggered at ``KTPU_FRAG_ALERT``, 0.5). Dispatch contexts:
``schedule_batch`` (bucket ``<bucket>/<mode>``) around every dispatch and
warm run, ``gang_verdicts``, ``preempt_screen``, ``claim_mask``,
``apply_rows``; ``warm_buckets`` runs in ``calibration()``. Each commit
reads through ``commit_plane.materialize_profiled`` and samples the card's
memory after it. The latency ledger moves a batch's pods to
``device.inflight`` at dispatch and to ``commit.host`` at the claim; the
bind tail moves them to ``bind`` and closes them. ``KTPU_PROFILE_DIR``
captures a ``torch.profiler`` trace of the first ``KTPU_PROFILE_BATCHES``
(4) batch cycles, exported as a Chrome trace into that directory; a
profiler that cannot start turns profiling off. ``KTPU_TELEMETRY=1``,
``KTPU_LEDGER=1`` and ``KTPU_TRACE_FILE`` turn the recorders on when a
loop is built (``enable_observability_from_env``).

A capacity that does not converge raises PermanentDeviceError.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set

import numpy as np
import torch

from ..api.types import Pod
from ..apiserver.store import Store
from ..cache.snapshot import Snapshot
from ..framework.plugins import names, volume
from ..framework.registry import DEFAULT_PLUGINS
from ..framework.runtime import WAITING, Framework, PreFilterState
from ..framework.types import Diagnosis, QueuedPodInfo
from ..metrics import latency_ledger
from ..metrics.scheduler_metrics import ERROR, SCHEDULED, UNSCHEDULABLE
from ..ops import fused_step
from ..ops.encode import CapacityError
from ..ops.preempt import screen_prefix
from ..ops.quota import QUOTA_OK_BIT, QUOTA_SCREEN_BIT
from ..ops.schema import COL_PODS, Capacities
from ..ops.slice import fragmentation_host
from ..ops.tiebreak import seeds_for
from ..ops.volume_mask import VolumeMaskBuilder
from ..scheduler.scheduler import BindItem, Scheduler
from ..api.wrappers import make_pod
from ..framework.runtime import sampled_attempt
from ..utils import tracing
from ..utils.device import DeviceLike, resolve_device
from . import telemetry
from .batch_scheduler import (DeviceBatch, DispatchedBatch, EncodedBatch,
                              adopt_device_batch, dispatch_device_batch, encode_device_batch,
                              batch_gangs, judge_gangs, preempt_screen, quota_batch_kw,
                              run_batch_program, screen_batch_kw, slice_batch_kw,
                              topo_mode_info)
from .circuit import STATE_VALUES, CircuitBreaker
from .claim_mask import ClaimMaskBuilder
from .commit_plane import CommitWorker, materialize_profiled
from .device_state import DeviceState, caps_for_cluster
from .errors import PermanentDeviceError, TransientDeviceError
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
# host seconds of the claim and volume work: the volume screen's build and
# upload and the claim mask's build and enqueue (encode), and the commit
# checks of the volume and claim winners (PreFilters, exact volume filters)
SCREENS = ("volume_mask", "claim_mask", "commit_checks")
# the sync-and-encode attempts, each after one capacity growth
GROW_ATTEMPTS = 8

# the batch program's first-fail ids (backend/batch.py), in filter config
# order: the plugin each names and the reason of its status
ATTRIBUTION_ORDER = (
    ("NodeUnschedulable", "node(s) were unschedulable"),
    ("NodeName", "node(s) didn't match the requested node name"),
    ("TaintToleration", "node(s) had untolerated taint"),
    ("NodeAffinity", "node(s) didn't match Pod's node affinity/selector"),
    ("NodePorts", "node(s) didn't have free ports for the requested pod ports"),
    ("NodeResourcesFit", "Insufficient resources"),
    ("PodTopologySpread", "node(s) didn't match pod topology spread constraints"),
    ("InterPodAffinity", "node(s) didn't match pod affinity/anti-affinity rules"),
    ("VolumeBinding", "node(s) didn't satisfy volume placement"),
    ("DynamicResources", "cannot allocate all claims"),
    ("SlicePacking", "node(s) outside the gang's planned torus slice"),
)

# the plugin arguments the batch program has baked in, at the values it
# computes with: the scores' strategy, resources and shape
# (ops/scores.py, the fused kernel's LeastAllocated and Balanced terms),
# the spread constraints of the topology scan (ops/topology.py, which reads
# only the pod's own), the hard affinity weight of the symmetric term
# (backend/sig_table.py:encode_topo, called at its default), and the node
# affinity of ops/filters.py (the pod's alone)
BAKED_ARGS = {
    names.NODE_RESOURCES_FIT: (("strategy", "LeastAllocated"),
                               ("resources", (("cpu", 1), ("memory", 1))),
                               ("shape", ((0, 0), (100, 10)))),
    names.NODE_RESOURCES_BALANCED_ALLOCATION: (("resources", (("cpu", 1), ("memory", 1))),),
    names.INTER_POD_AFFINITY: (("hard_pod_affinity_weight", 1),),
    names.POD_TOPOLOGY_SPREAD: (("default_constraints", ()), ("system_defaulted", False)),
    names.NODE_AFFINITY: (("added_affinity", None),),
}
# the points whose lists the batch program implements
BATCH_POINTS = ("pre_filter", "filter", "pre_score", "score")
# the Reserve, Permit and PreBind plugins of the default bind path: each
# reads no PreFilter state of a plain pod (VolumeBinding and
# DynamicResources act on volume and claim pods, which run the PreFilters
# at commit)
DEFAULT_BIND_PATH_PLUGINS = frozenset((names.VOLUME_BINDING, names.DYNAMIC_RESOURCES,
                                       names.COSCHEDULING, names.QUOTA_ADMISSION))


def _as_tuples(v):
    """Lists and tuples alike, nested, for comparing argument values."""
    return tuple(_as_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def _default_full_batch(device: torch.device) -> bool:
    """Whether the adaptive percentageOfNodesToScore default (0) evaluates
    the full batch: on CUDA yes, on the CPU the reference's adaptive sample
    (``tpu_scheduler.py:99``). ``KTPU_FULL_BATCH=1/0`` overrides."""
    env = os.environ.get("KTPU_FULL_BATCH", "")
    if env in ("0", "1"):
        return env == "1"
    return device.type == "cuda"


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
    batch_id: str = ""       # "b<batch_counter>", the flight recorder's key
    t_submit: float = 0.0    # now_fn when its dispatch returned


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
                 batch_deadline_ms: Optional[float] = None, comparer_every_n: int = 0,
                 relay_breaker_threshold: Optional[int] = None,
                 relay_probe_interval_s: Optional[float] = None, **kwargs):
        self.device = resolve_device(device)
        super().__init__(store, **kwargs)
        self.batch_size = batch_size
        # the relay breaker (``:146-175``): repeated commit failures open it,
        # and every pod takes the sequential path, touching no device state,
        # until a probe past ``relay_probe_interval_s`` commits
        if relay_breaker_threshold is None:
            relay_breaker_threshold = int(os.environ.get("KTPU_RELAY_BREAKER_THRESHOLD", "3"))
        if relay_probe_interval_s is None:
            relay_probe_interval_s = float(os.environ.get("KTPU_RELAY_PROBE_S", "0.5"))
        self.relay_breaker = CircuitBreaker(
            failure_threshold=relay_breaker_threshold, reset_timeout_s=relay_probe_interval_s,
            now_fn=self.now_fn, on_state_change=self._relay_state_change)
        self.relay_degraded_pods = 0  # batchable pods the open breaker sent down the sequential path
        self._relay_degraded_since: Optional[float] = None
        # the oracle comparer: every winner of a batch that starts while
        # ``batch_scheduled`` is a multiple of ``comparer_every_n`` is
        # checked again with the host PreFilters and Filters; 0 disables
        self.comparer_every_n = comparer_every_n
        self.comparer_checks = 0
        self.comparer_mismatches = 0
        self.batch_scheduled = 0  # batch winners bound or parked at Permit
        self._slot_reuses_seen = 0  # encoder.slot_reuses already in device_slot_reuse
        self.warm_launches = 0  # fused-kernel launches of warm_buckets
        self.warm_timings: List[tuple] = []  # (bucket, seconds) of the last sweep's timed runs
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
        # read; an exception it returns is raised there and takes the relay
        # death path (ring poison, mirror dropped; a TransientDeviceError is
        # counted by the breaker, any other is raised out of the cycle)
        self.relay_fault_fn: Optional[Callable[[str], Optional[BaseException]]] = None
        self.pipeline_depth = max(0, int(os.environ.get("KTPU_PIPELINE_DEPTH", "2")))
        self._inflight: Deque[_Inflight] = deque()
        self.pipelined_batches = 0  # batches committed out of a ring of depth > 0
        self.carry_batches = 0      # batches encoded on the newest batch's carry
        # serializes the scheduling thread's sync, encode and dispatch with
        # a commit's adopt, preemption screen and reconcile
        self.device_mutex = threading.RLock()
        # the continuous rebalancer, off until enable_rebalancer (:284-287)
        self.rebalancer = None
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
        # the flat gangs' verdict calls: host seconds (the call and its
        # read) and reads
        self.gang_seconds = 0.0
        self.gang_reads = 0
        self.quota_flagged = 0  # winners the device's quota screen flagged
        self._volume_masks = VolumeMaskBuilder(store)
        self._claim_masks = ClaimMaskBuilder(store)
        self.screen_seconds = dict.fromkeys(SCREENS, 0.0)
        self.fallback_scheduled = 0  # pods the sequential path bound
        # profile name -> whether its pods ride the batch, and whether its
        # bind path reads PreFilter state (the profiles are fixed)
        self._batchable = {name: self._framework_batchable(fwk)
                           for name, fwk in self.profiles.items()}
        self._bind_prefilter = {name: self._bind_path_needs_prefilter(fwk)
                                for name, fwk in self.profiles.items()}
        # whether any profile runs a PostFilter (the preemption screen is
        # wasted otherwise)
        self._preempt_wired = any(f.points.get("post_filter") for f in self.profiles.values())
        # KTPU_PROFILE_DIR: a torch.profiler capture of the first
        # KTPU_PROFILE_BATCHES batch cycles, exported as a Chrome trace
        self._profile_dir = os.environ.get("KTPU_PROFILE_DIR", "")
        self._profile_batches = int(os.environ.get("KTPU_PROFILE_BATCHES", "4"))
        self._profiler = None
        self._frag_alerted: Set[int] = set()  # superpods past the alert threshold
        self.enable_observability_from_env()

    def enable_observability_from_env(self) -> None:
        """The recorders the environment asks for, as the JAX server's setup
        turns them on (``cmd/server.py:533-561``): ``KTPU_TRACE_FILE``,
        ``KTPU_TELEMETRY=1`` (feeding this loop's metrics) and
        ``KTPU_LEDGER=1`` (this loop's metrics, its quota tenants)."""
        tracing.maybe_enable_from_env()
        telemetry.maybe_enable_from_env(self.smetrics)
        latency_ledger.maybe_enable_from_env(self.smetrics, tenant_fn=self._ns_fair_weight)

    def close(self) -> None:
        """Commit every batch in flight, end the commit worker's thread and
        flush a profiler capture still open."""
        self._drain_inflight()
        if self.commit_worker is not None:
            self.commit_worker.stop()
        self._stop_profile()

    def run_until_settled(self) -> int:
        """The base settle loop; a profiler capture the settle did not fill
        is flushed at its end (``:2027-2043``)."""
        cycles = super().run_until_settled()
        self._stop_profile()
        return cycles

    def _relay_state_change(self, _old: str, new: str) -> None:
        """A relay breaker transition (``:289-306``): the circuit gauge, and
        the degraded seconds of the open window, booked when it closes (a
        half-open probe neither closes nor restarts the window)."""
        self.smetrics.backend_circuit_state.set(value=STATE_VALUES[new])
        now = self.now_fn()
        if new == "open" and self._relay_degraded_since is None:
            self._relay_degraded_since = now
        elif new == "closed" and self._relay_degraded_since is not None:
            self.smetrics.degraded_seconds.inc(value=now - self._relay_degraded_since)
            self._relay_degraded_since = None

    # ------------------------------------------------------------- device

    def _sync_slot_reuse_metric(self) -> None:
        """The encoder's new slot reuses into ``device_slot_reuse`` (a
        rebuilt mirror's encoder counts from 0 again)."""
        reuses = self.state.encoder.slot_reuses
        if reuses < self._slot_reuses_seen:
            self._slot_reuses_seen = 0
        if reuses > self._slot_reuses_seen:
            self.smetrics.device_slot_reuse.inc(value=reuses - self._slot_reuses_seen)
            self._slot_reuses_seen = reuses

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
                    self._rebuild_mirror(caps_for_cluster(n, batch=self.batch_size))
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
            self._rebuild_mirror(dataclasses.replace(
                caps, nodes=nodes, value_words=max(caps.value_words, (nodes + 2 + 31) // 32)))

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

    def _grown(self, caps: Capacities, err: CapacityError) -> Capacities:
        """``caps`` with exactly the axis ``err`` names doubled until it
        covers ``err.needed``."""
        fields = self._GROW_FIELDS.get(err.dimension)
        if fields is None and err.dimension.startswith("value vocab"):
            fields = ("value_words",)
        if fields is None:
            raise PermanentDeviceError(
                f"unknown capacity dimension {err.dimension!r}") from err
        updates = {}
        for f in fields:
            v = getattr(caps, f)
            while v < err.needed:
                v *= 2
            updates[f] = v
        return dataclasses.replace(caps, **updates)

    def _rebuild_mirror(self, caps: Capacities) -> None:
        """A fresh mirror on ``caps``, synced; each CapacityError its sync
        meets grows that axis and starts again. The sync walks the nodes in
        the snapshot's order, which follows the process's string hashing,
        so the first overflow it meets need not be the largest (torus slot
        17 before slot 62). The caller holds the device mutex."""
        for _attempt in range(GROW_ATTEMPTS):
            self.state = DeviceState(caps, self.device, self.store.ns_labels)
            try:
                self.state.sync(self.snapshot)
                return
            except CapacityError as err:
                caps = self._grown(caps, err)
        raise PermanentDeviceError(f"capacities did not converge in {GROW_ATTEMPTS} growths")

    def _resync_grown(self, err: CapacityError) -> None:
        """Grow the capacity axis ``err`` names, rebuild the mirror and sync
        it (``:386-411``), growing again for any axis that sync outgrows.
        Called outside the device mutex: the drain needs the worker."""
        self._drain_inflight()
        if self.state is None:  # the drain's commit dropped the mirror
            self._ensure_device()
            return
        with self.device_mutex:
            self._rebuild_mirror(self._grown(self.state.caps, err))

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
        if self.rebalancer is not None:
            # after the sweep; the rebalancer gates itself on its score
            # interval and an idle commit worker (:611-614)
            self.rebalancer.maybe_run(now)

    def enable_rebalancer(self, **kwargs):
        """Attach the continuous rebalancer (``controllers/rebalance.py``),
        driven from housekeeping (``:616-624``); ``kwargs`` are its knobs.
        Returns it."""
        from ..controllers.rebalance import Rebalancer

        self.rebalancer = Rebalancer(self, now_fn=kwargs.pop("now_fn", self.now_fn), **kwargs)
        return self.rebalancer

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
        # the relay breaker (``:526-588``): while it is open, no pod rides
        # the batch and nothing touches the device; past the probe interval
        # it admits this cycle's batch as the half-open probe
        relay_ok = self.relay_breaker.allow()
        if self._relay_degraded_since is not None:
            # the degraded seconds stream while the breaker stays open
            now = self.now_fn()
            self.smetrics.degraded_seconds.inc(value=now - self._relay_degraded_since)
            self._relay_degraded_since = now
        live = []
        for qp in qps:
            pod = self.store.get_pod(qp.pod.key())
            if pod is None or pod.spec.node_name or not self._responsible_for(pod):
                latency_ledger.close_skipped(qp.pod.key(), pod)
                continue  # skipPodSchedule
            live.append((qp, pod))
        if relay_ok:
            self._ensure_device()
        buffer: List[QueuedPodInfo] = []
        flushed = False
        for qp, pod in live:
            qp.pod = pod
            fwk = self.profiles[pod.spec.scheduler_name]
            # the host gates (the batch program models neither namespace
            # quota nor gang quorum): a pod that fails one takes no row
            for plugin, gate in fwk.gate_plugins:
                if gate.pre_filter(None, pod)[1] is not None:
                    self.metrics.inc("schedule_attempts")
                    self._handle_scheduling_failure(
                        qp, True, Diagnosis(unschedulable_plugins={plugin}), pod_cycle)
                    self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name,
                                                  self.now_fn() - t_pop)
                    break
            else:
                batchable = self.batch_supported(pod)
                if relay_ok and batchable:
                    buffer.append(qp)
                    continue
                if batchable:
                    self.relay_degraded_pods += 1
                    telemetry.event("degrade", pod=pod.key(), reason="relay breaker open")
                # the sequential path, in pop order: the batch queued before
                # the pod is dispatched and the ring lands first
                laps("pop")
                if buffer:
                    self._flush_batch(buffer, pod_cycle, t_pop, laps)
                    buffer, flushed = [], True
                self._drain_inflight()
                self._schedule_fallback(qp, pod_cycle)
                laps("commit")
        laps("pop")
        if buffer:
            self._flush_batch(buffer, pod_cycle, t_pop, laps)
            flushed = True
        if flushed:
            self.cycle_seconds.append(time.perf_counter() - t0)
        return len(qps)

    def batch_supported(self, pod: Pod) -> bool:
        """Whether the pod rides the batch (``:442``): a pod of a batchable
        profile whose volumes the screen can judge (every PVC exists, bound
        or delayed-binding) and whose claims resolve."""
        if not self._batchable[pod.spec.scheduler_name]:
            return False
        if pod.spec.volumes and not self._volume_masks.batchable(pod):
            return False
        if pod.spec.resource_claims and not self._claim_masks.batchable(pod):
            return False
        return True

    def _framework_batchable(self, fwk: Framework) -> bool:
        """True when the profile's PreFilter, Filter, PreScore and Score
        lists equal the default set's, names and weights (``:473-490``),
        and every argument the batch program has baked in is at its
        default (``BAKED_ARGS``)."""
        ok = all(fwk.point_names(point) == DEFAULT_PLUGINS.get(point, [])
                 for point in BATCH_POINTS)
        for name, args in BAKED_ARGS.items():
            plugin = fwk.plugin(name)
            if ok and plugin is not None:
                ok = all(_as_tuples(getattr(plugin, arg)) == _as_tuples(default)
                         for arg, default in args)
        return ok

    def _bind_path_needs_prefilter(self, fwk: Framework) -> bool:
        """True when the profile has a Reserve, Permit or PreBind plugin
        outside the default bind path (``:1140-1160``): it may read the
        PreFilter state a plain pod of a batch does not have."""
        return any(plugin.name() not in DEFAULT_BIND_PATH_PLUGINS
                   for point in ("reserve", "permit", "pre_bind")
                   for plugin, _w in fwk.points.get(point, []))

    def _schedule_fallback(self, qp: QueuedPodInfo, pod_cycle: int) -> None:
        """The sequential path for one pod (``:2019``)."""
        before = self.metrics["scheduled"]
        self.schedule_one_pod(qp, pod_cycle)
        if self.metrics["scheduled"] > before:
            self.fallback_scheduled += 1

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
        """Encode a batch with its slice gangs' member index, after the
        ledger's rows are synced its quota screen's columns, and its volume
        screen (from the scheduling thread's snapshot) and claim mask."""
        pods = [qp.pod for qp in batched]
        state, quota = self.state, self._quota_plugin()

        def extras(pods, pad_to):
            return {**slice_batch_kw(batch_gangs(pods)[1], state),
                    **(quota_batch_kw(quota, state, pods, pad_to) if quota is not None else {}),
                    **screen_batch_kw(self._volume_masks, self._claim_masks, state,
                                      self.snapshot, pods, pad_to, self.screen_seconds)}

        return encode_device_batch(state, pods, tie_seeds=seeds_for(batched), extras=extras,
                                   capacity=self.sizer.bucket_for(len(pods)))

    def _flush_batch(self, batched: List[QueuedPodInfo], pod_cycle: int, t_pop: float,
                     laps: _Laps) -> None:
        """Encode, dispatch and ring one batch (``_flush_batch_traced``,
        ``:650-880``), then commit what passed the ring's depth, in one
        ``scheduling.cycle`` span."""
        with tracing.span("scheduling.cycle", batch=len(batched)):
            self._flush_batch_traced(batched, pod_cycle, t_pop, laps)

    def _flush_batch_traced(self, batched: List[QueuedPodInfo], pod_cycle: int, t_pop: float,
                            laps: _Laps) -> None:
        self._maybe_profile()
        mutex = self.device_mutex
        t_work = laps.t
        t0 = self.now_fn()  # the phases of device_batch_duration, on the loop's clock
        with tracing.span("device.encode.pipelined", batch=len(batched)):
            with mutex:
                enc = self._try_pipelined_encode(batched, laps)
                state = self.state
        pipelined = enc is not None
        t_sync = t0  # on the carry nothing is uploaded
        if pipelined:
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
                        with tracing.span("device.sync"):
                            self.state.sync(self.snapshot)
                        self._sync_slot_reuse_metric()
                        laps("sync")
                        t_sync = self.now_fn()
                        with tracing.span("device.encode", batch=len(batched)):
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
        t_enc = self.now_fn()
        self.batch_counter += 1
        batch_id = f"b{self.batch_counter}"
        bucket = enc.pb.capacity
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
            telemetry.event("encode", batchId=batch_id, bucket=bucket, pods=len(batched),
                            pipelined=pipelined)
            sig = f"{bucket}/{enc.mode}"
            with tracing.span("device.dispatch", topo=enc.mode):
                with telemetry.dispatch("schedule_batch", bucket=sig):
                    disp = dispatch_device_batch(state, enc, sample_k, sample_start, carry)
            if disp.res.final_sample_start is not None:
                self._start_carry = disp.res.final_sample_start
            t_submit = t_dispatch = self.now_fn()
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)
            self._inflight.append(_Inflight(batched, disp, pod_cycle, t_pop,
                                            (enc.mode, enc.vd, enc.host_key),
                                            bucket, state, stream, batch_id, t_submit))
        telemetry.event("dispatch", batchId=batch_id, bucket=bucket, pods=len(batched),
                        topo=enc.mode, sig=sig, packed=True, inflight=len(self._inflight))
        latency_ledger.transition_many((qp.pod.key() for qp in batched), "device.inflight",
                                       batch_id=batch_id)
        laps("dispatch")
        self.dispatch_spans.append((t_work, laps.t))
        self.batch_modes.append(enc.mode)
        self.batch_paths.append(disp.path)
        self.batch_pods.append(len(batched))
        self.batch_buckets.append(bucket)
        # land the oldest batches past the ring's depth: inline, or handed
        # to the worker behind a bounded backlog
        while len(self._inflight) > self.pipeline_depth:
            fl = self._inflight.popleft()
            if self.pipeline_depth:
                self.pipelined_batches += 1
            if self.commit_worker is not None:
                backlog = max(1, self.pipeline_depth)
                if self.commit_worker.depth() >= backlog:
                    with tracing.span("device.commit.backpressure"):
                        t_bp = self.now_fn()
                        self.commit_worker.wait_below(backlog)
                        self.smetrics.device_batch_duration.observe(
                            self.now_fn() - t_bp, "commit_backpressure")
                self.commit_worker.submit(fl)
            else:
                self._commit_inflight(fl)
        dur = self.smetrics.device_batch_duration
        dur.observe(t_sync - t0, "upload")
        dur.observe(t_enc - t_sync, "encode")
        dur.observe(t_dispatch - t_enc, "compute")
        laps("commit")

    def _maybe_profile(self) -> None:
        """Start a ``torch.profiler`` capture at the first batch cycle and
        stop it past ``KTPU_PROFILE_BATCHES`` (``:626-644``) when
        ``KTPU_PROFILE_DIR`` is set. A profiler that cannot start turns
        profiling off; the batch path is untouched either way."""
        if not self._profile_dir:
            return
        if self._profiler is None and self.batch_counter == 0:
            try:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                self._profiler = profile(activities=activities)
                self._profiler.start()
            except Exception:  # noqa: BLE001 - profiling must never break scheduling
                logging.getLogger(__name__).exception("profiler did not start; profiling off")
                self._profiler = None
                self._profile_dir = ""
        elif self._profiler is not None and self.batch_counter >= self._profile_batches:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """Stop the capture and export it as ``<KTPU_PROFILE_DIR>/
        loop-<pid>.json`` (a Chrome trace)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        path = os.path.join(self._profile_dir, f"loop-{os.getpid()}.json")
        self._profile_dir = ""
        try:
            prof.stop()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception:  # noqa: BLE001 - a torn capture must not fail the loop
            logging.getLogger(__name__).exception("profiler capture not written")

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
            if any(qp.pod.spec.volumes for qp in batched):
                # the volume screen reads self.snapshot, which is refreshed
                # only on the drain-and-sync path while the worker commits
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

    # ------------------------------------------------------------- warm sweep

    def _sync_grown(self) -> None:
        """Sync the mirror to the snapshot, growing each capacity axis the
        sync outgrows (on the scheduling thread, the ring landed)."""
        for _attempt in range(GROW_ATTEMPTS):
            try:
                with self.device_mutex:
                    self.state.sync(self.snapshot)
                return
            except CapacityError as err:
                self._resync_grown(err)
        raise PermanentDeviceError(f"capacities did not converge in {GROW_ATTEMPTS} growths")

    def warm_buckets(self, sample_pods: Optional[List[Pod]] = None) -> int:
        """Run the batch program once at every sizer bucket, outside any
        measured window (``:1812-1985``), so that the first batch at a
        bucket does not pay the card's lazy module loading and allocator
        growth, then seed the sizer's latency model from the measured times
        (``_calibrate_sizer``). ``sample_pods`` are pods shaped like the
        incoming workload, never stored: their signatures and terms are
        registered first, so the warmed program is the topology mode the
        real batches run (default: one pod asking 1m cpu). Per bucket: the
        program and its ``ports_enabled`` twin; with a volume or claim in
        the sample the masked variants (all-True masks), each with its
        carry variant when the program has a topology carry; a second clean
        run, timed with ``now_fn`` up to the host read of its result; the
        carry variant; the preemption screen. Nothing is adopted: the
        mirror, ``batch_counter``, ``batch_modes``, ``batch_paths``,
        ``stage_seconds`` and the sampling carry stay as they were; the
        fused kernel's launches add to ``warm_launches``. Returns the
        programs warmed, counted as the JAX loop counts them. The sweep is
        the build ledger's ``calibration()`` window."""
        with telemetry.calibration():
            return self._warm_buckets(sample_pods)

    def _warm_buckets(self, sample_pods: Optional[List[Pod]]) -> int:
        self._drain_inflight()
        self._ensure_device()
        self.cache.update_snapshot(self.snapshot)
        self._sync_grown()
        pods = list(sample_pods) if sample_pods else [
            make_pod("__bucket_warm__").req({"cpu": "1m"}).obj()]
        launches0 = fused_step.LAUNCHES
        # the registration pass, growing capacities as a batch would
        for _attempt in range(GROW_ATTEMPTS):
            try:
                with self.device_mutex:
                    encode_device_batch(self.state, pods,
                                        capacity=self.sizer.bucket_for(len(pods)))
                break
            except CapacityError as err:
                self._resync_grown(err)
        else:
            logging.getLogger(__name__).warning(
                "warm_buckets: capacities did not converge for the sample; warming with "
                "its topology unregistered")
        self._sync_grown()  # the counts of the signatures just registered
        n_valid = self.cache.node_count()
        if self.percentage_of_nodes_to_score or not _default_full_batch(self.device):
            k = self.num_feasible_nodes_to_find(n_valid)
        else:
            k = n_valid
        sample_k = k if k < n_valid else None
        warmed = 0
        timings = []  # (bucket, seconds of the clean second run)
        with self.device_mutex:
            state = self.state
            mode_info = topo_mode_info(state)
            sample_start = (torch.zeros((), dtype=torch.int32, device=self.device)
                            if sample_k is not None else None)
            for bucket in sorted({self.sizer.bucket_for(b) for b in self.sizer._ladder()}):
                # a sample larger than the bucket is cut: the small buckets
                # are the ones deadline cuts switch to
                warm_slice = pods[:bucket]
                try:
                    enc = encode_device_batch(state, warm_slice, capacity=bucket)
                except CapacityError:
                    continue
                enc = dataclasses.replace(enc, mode=mode_info[0], vd=mode_info[1],
                                          host_key=mode_info[2])

                def run(**kw):
                    with telemetry.dispatch("schedule_batch", bucket=f"{bucket}/{enc.mode}"):
                        res = run_batch_program(state, enc, sample_k, sample_start, **kw)[0]
                    res.node_idx.cpu()  # the host read: the program has run
                    return res

                def carry(res):
                    return (res.final_sel_counts, res.final_seg_exist)

                def ones():
                    return torch.ones((bucket, state.caps.nodes), dtype=torch.bool,
                                      device=self.device)

                res = run()
                run(ports_enabled=not state.encoder.last_has_ports)
                volumes = any(p.spec.volumes for p in warm_slice)
                variants = []
                if volumes:
                    variants.append(dict(extra_mask=ones()))
                if any(p.spec.resource_claims for p in warm_slice):
                    dm = ones()
                    variants.append(dict(dra_mask=dm))
                    if volumes:
                        variants.append(dict(extra_mask=ones(), dra_mask=dm))
                for var in variants:
                    res_m = run(**var)
                    if res_m.final_sel_counts is not None:
                        run(topo_carry=carry(res_m), **var)
                warmed += 1
                t0 = self.now_fn()
                run()
                timings.append((bucket, self.now_fn() - t0))
                if res.final_sel_counts is not None:
                    run(topo_carry=carry(res))
                    warmed += 1
                if res.static_masks and self._preempt_wired:
                    # the failure path's program, when a profile wires a
                    # PostFilter
                    pres = screen_prefix(enc.pb, state.preempt_inputs(), res.static_masks,
                                         np.ones(len(warm_slice), bool))
                    pres.best.cpu()
                    warmed += 1
        self.warm_launches += fused_step.LAUNCHES - launches0
        self.warm_timings = timings
        self._calibrate_sizer(timings)
        return warmed

    def _calibrate_sizer(self, timings) -> None:
        """Seed the sizer's latency model from the warm runs' times per
        bucket (``:1987-2017``): least squares on exec(B) = ea + eb·B. A
        batch's pop-to-commit span covers its own run and the ring's worth
        of batches dispatched after it, so the seed is a = (K+1)·ea + 30 ms
        of host work and b = (K+1)·eb for ring depth K; the commit-wait
        model starts at wait = exec."""
        if len(timings) < 2:
            return
        xs = np.array([float(b) for b, _ in timings])
        ys = np.array([t for _, t in timings])
        eb, ea = np.polyfit(xs, ys, 1)
        if eb <= 0:
            return
        span = self.pipeline_depth + 1
        s = self.sizer
        s._fit.a = max(span * ea, 0.0) + 0.03
        s._fit.b = span * eb
        s._fit.updates = max(s._fit.updates, 3)
        s._fit.outliers = 0
        s._wfit.a = max(ea, 0.0)
        s._wfit.b = eb
        s._wfit.updates = max(s._wfit.updates, 3)
        s._bucket = None  # target() derives the bucket from the seeded model
        s.target()

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
            self._poison_batches((fl,), RuntimeError("device rebuilt while batch in flight"),
                                 count_breaker=False)
            return
        wait: Optional[float] = None
        rec: Optional[dict] = None
        laps = _Laps(self.commit_seconds)
        dur = self.smetrics.device_batch_duration
        t0 = self.now_fn()
        worker = "commit" if on_worker else "inline"
        try:
            with _on_stream(fl.stream):
                if self.relay_fault_fn is not None:
                    fault = self.relay_fault_fn("commit")
                    if fault is not None:
                        raise fault
                with tracing.span("device.commit.wait", batch=len(fl.qps), packed="packed",
                                  worker=worker):
                    t_wait = self.now_fn()
                    read, rec = materialize_profiled(
                        fl.disp, self.state.caps.nodes, program="schedule_batch",
                        bucket=f"{fl.bucket}/{fl.mode_info[0]}", t_submit=fl.t_submit,
                        now_fn=self.now_fn, batch_id=fl.batch_id, pods=len(fl.qps))
                    wait = self.now_fn() - t_wait
                    dur.observe(wait, "commit_wait")
                laps("wait")
                t_host = laps.t
                batch = adopt_device_batch(self.state, fl.disp, read, mutex)
                with tracing.span("host.commit", batch=len(fl.qps), worker=worker):
                    t_host0 = self.now_fn()
                    with self.queue.coalesce_moves():
                        self._commit_batch(fl.qps, batch, fl.pod_cycle, fl.t0, fl.batch_id)
                    dur.observe(self.now_fn() - t_host0, "commit_host")
                laps("bind")
                if self.state is not None:
                    with tracing.span("device.commit.reconcile", batch=len(fl.qps),
                                      worker=worker):
                        t_rec0 = self.now_fn()
                        snap = self._commit_snapshot if on_worker else self.snapshot
                        with mutex:
                            self.cache.update_snapshot(snap)
                            left = self.state.reconcile(snap)
                        if left:
                            self._chain_dirty = True
                        dur.observe(self.now_fn() - t_rec0, "commit_reconcile")
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
            # only a transient device error feeds the breaker; any other
            # (a sticky CUDA error, an out-of-memory, a fault of the commit
            # code) poisons the ring and is raised, so that no probe hides
            # it behind the sequential path
            transient = isinstance(exc, TransientDeviceError)
            self._poison_batches((fl, *stale), exc, count_breaker=transient)
            if not transient:
                raise
        else:
            self.relay_breaker.record_success()
            extra = {}
            if rec is not None:  # the slow-program outlier shows on the event alone
                extra = {"device_ms": round(rec["execS"] * 1e3, 3),
                         "fetch_ms": round(rec["fetchS"] * 1e3, 3)}
            telemetry.event("commit", batchId=fl.batch_id, bucket=fl.bucket, pods=len(fl.qps),
                            packed=True, wait_s=round(wait, 6), **extra)
            telemetry.sample_hbm(self.device)
        dur.observe(self.now_fn() - t0, "commit")
        # the sizer controls pop-to-commit at the batch's bucket: observed
        # here, where the span ends; the commit wait feeds the stall model
        self.sizer.update(fl.bucket, self.now_fn() - fl.t0)
        if wait is not None:
            self.sizer.update_wait(fl.bucket, wait)

    def _poison_batches(self, batches, exc: BaseException, count_breaker: bool = True) -> None:
        """Fail batches in flight back to the queue, each pod through the
        error path to backoffQ, in one queue-move window (``:1094-1123``);
        with ``count_breaker`` the failure counts against the relay breaker
        first."""
        logging.getLogger(__name__).warning("requeueing %d batches: %s", len(batches), exc)
        if count_breaker:
            self.relay_breaker.record_failure(exc)
        with self.queue.coalesce_moves():
            for fl in batches:
                telemetry.event("poison", batchId=fl.batch_id, bucket=fl.bucket,
                                pods=len(fl.qps), error=f"{type(exc).__name__}: {exc}"[:200])
                for qp in fl.qps:
                    self._handle_scheduling_failure(qp, False, Diagnosis(), fl.pod_cycle)
                telemetry.event("requeue", batchId=fl.batch_id, pods=len(fl.qps))

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
                      t0: float, batch_id: str = "") -> None:
        """``_commit_batch_coalesced`` (``:1217-1542``): the batch's
        verdicts (stale winners, the quota screen's flags, the gangs'), the
        preemption screen on the adopted carry under the device mutex when a
        pod is unplaced, then every pod in batch order: the failures, and
        the winners, each assumed at once (a volume or claim winner after
        its commit checks, or down the sequential path), then through
        ``_commit_bindings``. The batch's pods enter ``commit.host`` in the
        latency ledger first."""
        latency_ledger.transition_many((qp.pod.key() for qp in qps), "commit.host",
                                       batch_id=batch_id)
        node_idx, slot_names = batch.node_idx, batch.slot_names
        n = len(qps)
        pods = [qp.pod for qp in qps]
        winners = {i: slot_names.get(int(node_idx[i])) for i in range(n) if node_idx[i] >= 0}
        missing = self.cache.missing_real_nodes(name for name in winners.values() if name)
        # a stale slot, or a node that left while the batch was decided
        stale = {i for i, name in winners.items() if name is None or name in missing}
        flagged: Set[int] = set()
        if batch.quota_words is not None:
            w = batch.quota_words[:n]
            rows = ((node_idx[:n] >= 0) & ((w & QUOTA_SCREEN_BIT) != 0)
                    & ((w & QUOTA_OK_BIT) == 0))
            flagged = set(np.flatnonzero(rows).tolist())
            self.quota_flagged += len(flagged)
        gang_rejected = self._judge(pods, batch, stale | flagged, t0, batch_id)
        hints = None
        if self._preempt_wired and (node_idx[:n] < 0).any():
            if self.commit_worker is not None:
                # PostFilter reads the worker's snapshot: bring it up to the
                # binds and evictions committed since its last refresh
                self.cache.update_snapshot(self._commit_snapshot)
            with self.device_mutex:
                screen, best = preempt_screen(self.state, pods, batch,
                                              self.cache.min_pod_priority())
                hints = (screen, best, dict(self.state.encoder.node_slots))
        items: List[BindItem] = []
        for i, qp in enumerate(qps):
            self.metrics.inc("schedule_attempts")
            name = winners.get(i)
            fwk = self.profiles[qp.pod.spec.scheduler_name]
            if i in gang_rejected:
                # the program placed it, a sibling missed: surrender the row
                if name is not None:
                    self._invalidate_device_row(name)
                    diagnosis = Diagnosis(unschedulable_plugins={"Coscheduling"})
                else:
                    diagnosis = self._diagnose(batch.first_fail[i], slot_names)
                    diagnosis.unschedulable_plugins.add("Coscheduling")
                self._handle_scheduling_failure(qp, True, diagnosis, pod_cycle)
                self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name,
                                              self.now_fn() - t0)
                continue
            if i in stale:
                # requeue, never bind
                if name is not None:
                    self._invalidate_device_row(name)
                slot = int(node_idx[i])
                telemetry.event("slot_reclaim", batchId=batch_id, pod=qp.pod.key(), slot=slot,
                                reason=(f"node {name} removed while batch in flight" if name
                                        else f"slot {slot} reclaimed since dispatch"))
                self.metrics.inc("errors")
                self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                self.smetrics.observe_attempt(ERROR, fwk.profile_name, self.now_fn() - t0)
                continue
            if i in flagged:
                # back behind the quota gate, which judges the host ledger
                self._invalidate_device_row(name)
                self._handle_scheduling_failure(
                    qp, True, Diagnosis(unschedulable_plugins={"QuotaAdmission"}), pod_cycle)
                self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name,
                                              self.now_fn() - t0)
                continue
            if name is not None:
                state = None
                if (qp.pod.spec.volumes or qp.pod.spec.resource_claims
                        or self._bind_prefilter[fwk.profile_name]):
                    state = self._commit_checks(fwk, qp.pod, name)
                    if state is None:
                        # the device's choice fails the exact checks: the
                        # sequential path owns the pod (it re-runs them and
                        # records the pod's proper condition)
                        self._invalidate_device_row(name)
                        self._schedule_fallback(qp, pod_cycle)
                        continue
                if self.comparer_every_n and self.batch_scheduled % self.comparer_every_n == 0:
                    self._compare_with_oracle(fwk, qp.pod, name)
                item = BindItem(qp, name, fwk, state=state,
                                sampled=sampled_attempt(self.metrics["schedule_attempts"]))
                if self._assume(item, pod_cycle):
                    items.append(item)
                continue
            diagnosis = self._diagnose(batch.first_fail[i], slot_names)
            pod_hints = None
            if hints is not None:
                screen, best, slot_of = hints
                b = int(best[i])
                pod_hints = (screen[i], slot_of, slot_names.get(b) if b >= 0 else None)
            self._handle_scheduling_failure(
                qp, True, diagnosis, pod_cycle, pod_hints,
                sampled=sampled_attempt(self.metrics["schedule_attempts"]))
            self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name, self.now_fn() - t0)
        if items:
            self.batch_scheduled += self._commit_bindings(items, pod_cycle, t0)

    def _compare_with_oracle(self, fwk: Framework, pod: Pod, node_name: str) -> None:
        """The device/host comparer (``:1787-1810``): the host PreFilters
        and Filters judge the winner on its node in the failure path's
        snapshot, refreshed first; a node missing there or a check that
        fails counts a mismatch. It judges the placement the device made:
        against the cache with the batch's earlier winners assumed in
        batch order, as the device committed them, and without the host
        gates (QuotaAdmission, Coscheduling), which the batch program does
        not model and Reserve and Permit judge next. The JAX comparer reads
        the snapshot before the batch's winners are assumed and runs the
        gates, so it flags winners that an earlier winner of the batch
        made feasible, and winners whose quota a batch committed from the
        ring since their pop used up, which Reserve then refuses (ROADMAP
        C18)."""
        snap = self._failure_snapshot()
        self.cache.update_snapshot(snap)
        ni = snap.node_info_map.get(node_name)
        self.comparer_checks += 1
        if ni is None or ni.node is None:
            self.comparer_mismatches += 1
            logging.getLogger(__name__).warning(
                "comparer: device placed %s on unknown node %s", pod.key(), node_name)
            return
        filters = fwk.filters
        state, _names, fail = filters.pre_filter_status(pod, gates=False)
        if fail is None:
            fail = filters.filter_status(state, pod, ni)
        if fail is not None:
            self.comparer_mismatches += 1
            logging.getLogger(__name__).warning(
                "comparer: oracle rejects device placement %s -> %s: %s",
                pod.key(), node_name, fail.reason)

    def _commit_checks(self, fwk: Framework, pod: Pod,
                       node_name: str) -> Optional[PreFilterState]:
        """A volume or claim winner's checks on its node (``:1455-1501``),
        or those of a winner whose profile's bind path reads PreFilter
        state, against the failure path's snapshot, refreshed first so that
        it holds the batch's earlier winners: every PreFilter, then the
        exact volume filters (``_verify_volumes_on_node``, which also
        records VolumeBinding's choice of PVs). The pod's PreFilter state,
        or None when a check fails."""
        t = time.perf_counter()
        try:
            snap = self._failure_snapshot()
            self.cache.update_snapshot(snap)
            state, _names, fail = fwk.filters.pre_filter_status(pod)
            if fail is not None:
                return None
            if pod.spec.volumes and not self._verify_volumes_on_node(state, pod, node_name, snap):
                return None
            return state
        finally:
            self.screen_seconds["commit_checks"] += time.perf_counter() - t

    def _verify_volumes_on_node(self, state: PreFilterState, pod: Pod, node_name: str,
                                snap: Snapshot) -> bool:
        """The exact volume filters on the device's chosen node (``:1125``,
        the filters of ``_VOLUME_FILTERS``): the host half of the
        over-admitting volume screen."""
        ni = snap.node_info_map.get(node_name)
        if ni is None or ni.node is None:
            return False  # the chosen node left the snapshot
        return volume.verify_on_node(self.store, pod, ni, state.rwop, state.bound,
                                     state.delayed, state.node_bindings) is None

    def _assume(self, item: BindItem, pod_cycle: int) -> bool:
        """Assume the pod on its node in the cache, so the next pod's
        checks and the sequential path see it; a pod whose node left takes
        the failure path."""
        item.assumed = item.qp.pod.clone()
        try:
            self.cache.assume_pod(item.assumed, item.node_name)
        except KeyError:
            self._handle_scheduling_failure(item.qp, False, Diagnosis(), pod_cycle)
            if item.device:
                self._invalidate_device_row(item.node_name)
            return False
        item.fwk.nominator.delete_nominated_pod_if_exists(item.qp.pod)
        return True

    def _by_framework(self, items: List[BindItem]) -> Dict[Framework, List[BindItem]]:
        """The items grouped by their profile's framework, each group in
        batch order, the groups in order of first appearance."""
        if len(self.profiles) == 1:
            return {items[0].fwk: items} if items else {}
        groups: Dict[Framework, List[BindItem]] = {}
        for item in items:
            groups.setdefault(item.fwk, []).append(item)
        return groups

    def _commit_bindings(self, items: List[BindItem], pod_cycle: int, t0: float,
                         per_pod: bool = False) -> int:
        """The bind tail of assumed pods (``commit_plane.py:155-307``), per
        profile in the order its pods first appear: Reserve over the
        profile's pods (then the refused ones rolled back), Permit over
        the rest (a pod voting WAIT parks at once, so the next member's
        quorum counts it; a quorum allows the parked siblings, which land
        right there), then ``_bind_stage`` over every profile's permitted
        pods. Per pod the plugins see the JAX commit plane's calls in its
        order, and each pod fails alone. The sequential path calls it with
        its one pod (``per_pod``: the JAX per-pod executors' spans).
        Returns the pods bound or parked (JAX's ``stats.bound +
        stats.waiting``)."""
        permitted: List[BindItem] = []
        waiting = 0
        for fwk, group in self._by_framework(items).items():
            refused = fwk.reserve_batch([(item.state, item.assumed, item.node_name)
                                         for item in group], per_pod,
                                        [item.sampled for item in group])
            survivors = []
            for item, reason in zip(group, refused):
                if reason is not None:
                    self._fail_assumed(item, True, pod_cycle)
                else:
                    survivors.append(item)
            verdicts = fwk.permit_batch(
                [(item.state, item.assumed, item.node_name) for item in survivors],
                lambda i, wait_s, _group=survivors: self.park(_group[i], pod_cycle, t0, wait_s),
                per_pod, [item.sampled for item in survivors])
            for item, reason in zip(survivors, verdicts):
                if reason is None:
                    permitted.append(item)
                elif reason == WAITING:
                    waiting += 1
                else:
                    self._fail_assumed(item, True, pod_cycle)
        return waiting + self._bind_stage(permitted, pod_cycle, t0, per_pod)

    def _bind_stage(self, items: List[BindItem], pod_cycle: int, t0: float,
                    per_pod: bool = False) -> int:
        """PreBind each assumed pod per profile (VolumeBinding's PV
        binds), bind the rest (a pod a binder extender is interested in
        through the first such extender, and a pod whose profile's Bind
        point is not DefaultBinder alone through that point, one by one, as
        the JAX commit plane's ``_run_bind`` does, ``commit_plane.py:
        326-343``; then the others through the store in one pass), then
        finish each bound one, count it, and run PostBind over them per
        profile. A failed bind takes ``_fail_assumed``. The latency ledger
        moves the pods to ``bind`` (a batch's after PreBind, as the JAX
        commit plane does; a pod of the sequential path or allowed by Permit
        before, as JAX's ``_binding_cycle`` does) and closes the bound ones.
        Returns the pods bound."""
        if per_pod:
            latency_ledger.transition_many((item.assumed.key() for item in items), "bind")
        live: List[BindItem] = []
        for fwk, group in self._by_framework(items).items():
            refused = fwk.pre_bind_batch([(item.state, item.assumed, item.node_name)
                                          for item in group], per_pod,
                                         [item.sampled for item in group])
            for item, reason in zip(group, refused):
                if reason is not None:
                    self._fail_assumed(item, False, pod_cycle)
                else:
                    live.append(item)
        if not per_pod:
            latency_ledger.transition_many((item.assumed.key() for item in live), "bind")
        bound: List[BindItem] = []
        batched: List[BindItem] = []
        for item in live:
            ext = self._binder_extender_for(item.assumed) if self.extenders else None
            if ext is None and item.fwk.default_binder:
                batched.append(item)
                continue
            if ext is not None:
                fail = self._extender_bind(ext, item.assumed, item.node_name)
            else:
                fail = item.fwk.bind(item.state, item.assumed, item.node_name)
            if fail is not None:
                self._fail_assumed(item, False, pod_cycle)
            else:
                bound.append(item)
        if batched:
            pairs = [(item.assumed.key(), item.node_name) for item in batched]
            t_bind = time.perf_counter()
            if per_pod:
                outcomes = [item.fwk.default_bind(lambda _p=pair: self.store.bind_batch([_p])[0],
                                                  item.sampled)
                            for item, pair in zip(batched, pairs)]
            else:
                outcomes = self.store.bind_batch(pairs)
                failed = sum(err is not None for err in outcomes)
                for fwk, group in self._by_framework(batched).items():
                    fwk.observe_batched_bind(time.perf_counter() - t_bind, failed,
                                             any(item.sampled for item in group))
            for item, err in zip(batched, outcomes):
                if err is not None:
                    self._fail_assumed(item, False, pod_cycle)
                else:
                    bound.append(item)
        if not bound:
            return 0
        now = self.now_fn()
        for item in bound:
            self.cache.finish_binding(item.assumed)
            self.metrics.inc("scheduled")
            self.smetrics.observe_attempt(SCHEDULED, item.fwk.profile_name, now - t0)
        if per_pod:
            latency_ledger.close_many((item.assumed.key() for item in bound), "scheduled")
        for fwk, group in self._by_framework(bound).items():
            fwk.post_bind_batch([item.assumed for item in group], per_pod,
                                [item.sampled for item in group])
        if not per_pod:
            latency_ledger.close_many((item.assumed.key() for item in bound), "scheduled")
        return len(bound)

    def _fail_assumed(self, item: BindItem, unschedulable: bool, pod_cycle: int) -> None:
        """An assumed pod refused after its assume: Unreserve (a refused
        Reserve's too: the whole point unreserves), the assume forgotten,
        the failure path; when the device committed to it, the next sync
        repairs its row."""
        item.fwk.unreserve(item.state, item.assumed, item.node_name)
        self.cache.forget_pod(item.assumed)
        self._handle_scheduling_failure(item.qp, unschedulable, Diagnosis(), pod_cycle)
        if item.device:
            self._invalidate_device_row(item.node_name)

    def _judge(self, pods: List[Pod], batch: DeviceBatch, poisoned: Set[int],
               t0: float, batch_id: str = "") -> Dict[int, str]:
        """The batch's gang verdicts (``judge_gangs``), each rejected
        gang's ``reject_gang`` (and a slice gang's plan forgotten), the
        slice gangs' wait, ``slice_assign`` / ``slice_reject`` events and
        the fragmentation gauges. Returns batch row -> group key for every
        member of a rejected gang."""
        flat, slices = batch_gangs(pods)
        if not flat and not slices:
            return {}
        t = time.perf_counter()
        reasons = judge_gangs(flat, slices, batch.res, batch.node_idx, batch.slice_words,
                              poisoned, self.device)
        if flat:
            self.gang_seconds += time.perf_counter() - t
            self.gang_reads += 1
        now = self.now_fn()
        node_idx = batch.node_idx
        for gkey, rows in slices.items():
            result = "rejected" if gkey in reasons else "scheduled"
            self.smetrics.slice_wait_duration.observe(now - t0, result)
            if all(node_idx[i] >= 0 for i in rows):
                telemetry.event("slice_assign", batchId=batch_id, gang=gkey, members=len(rows))
            else:
                telemetry.event("slice_reject", batchId=batch_id, gang=gkey, members=len(rows),
                                reason=reasons[gkey])
        out: Dict[int, str] = {}
        for gkey, reason in reasons.items():
            members = flat.get(gkey) or slices[gkey]
            fwk = self.framework_for_pod(pods[members[0]])
            cos = fwk.plugin(names.COSCHEDULING)
            if cos is not None:
                cos.reject_gang(gkey, reason)
            packing = fwk.plugin(names.SLICE_PACKING)
            if (gkey in slices and packing is not None
                    and any(node_idx[i] < 0 for i in slices[gkey])):
                # the plan's node reservations go: a retry plans afresh
                packing.forget_gang(gkey)
            for i in members:
                out[i] = gkey
        if slices:
            self._update_slice_frag_metrics()
        return out

    def _update_slice_frag_metrics(self) -> None:
        """``slice_fragmentation`` per superpod from the host mirror (no
        device read): the free run structure of the pod-less nodes; a
        superpod crossing ``KTPU_FRAG_ALERT`` (0.5) records one
        ``frag_alert`` until it drops below again."""
        with self.device_mutex:
            state = self.state
            if state is None:
                return
            m = state._mirror
            valid = m["valid"]
            rows = fragmentation_host(m["topo_sp"], m["topo_pos"], valid,
                                      valid & (m["requested"][:, COL_PODS] == 0),
                                      (state.caps.superpods, state.caps.sp_slots))
        threshold = float(os.environ.get("KTPU_FRAG_ALERT", "0.5"))
        for row in rows:
            self.smetrics.slice_fragmentation.set(str(row["sp"]), value=row["frag"])
            if row["frag"] >= threshold and row["sp"] not in self._frag_alerted:
                self._frag_alerted.add(row["sp"])
                telemetry.event("frag_alert", superpod=row["sp"], frag=round(row["frag"], 4),
                                largestRun=row["largest_run"], free=row["free"])
            elif row["frag"] < threshold:
                self._frag_alerted.discard(row["sp"])

    def _failure_snapshot(self) -> Snapshot:
        """With the worker, every failure path runs on it, against its own
        snapshot."""
        return self._commit_snapshot if self.commit_worker is not None else self.snapshot
