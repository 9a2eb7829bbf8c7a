"""The batched device service over HTTP (``kubernetes_tpu/backend/
service.py``; SURVEY §5.8 hop 6): the out-of-process seam between the
control plane and the card.

The control plane streams generation-keyed node deltas (``applyDeltas``)
and submits whole pod batches (``scheduleBatch``); the service keeps the
encoded mirror across calls, so a steady-state request carries the dirty
rows and the batch. Four pieces:

  * ``DeviceService`` (``:178``): the transport-free server core. It owns a
    ``DeviceState`` on its ``device`` and runs the loop's batch program
    through the loop's own device halves (``batch_scheduler.
    encode_device_batch``, ``dispatch_device_batch``, the packed block's
    one read, ``adopt_device_batch``): a full mode-``off`` batch on CUDA is
    one launch of the fused kernel (``csrc/fused_step.cu``), a topology
    batch goes where ``batch.SPEC_AUTO_CUDA`` sends it, and a sampled
    batch takes the scan. Sampling follows the JAX service: an explicit
    percentage samples, the adaptive default (0) evaluates the full batch
    on CUDA and samples on the CPU. Sessions, leases, holds, fences and the
    idempotency cache are the JAX ones (``ClientSession``, ``_Hold``).
  * ``serve`` / ``ServiceBinding`` (``:1061-1180``): the stdlib HTTP/JSON
    binding on 127.0.0.1 (``ThreadingHTTPServer``: one thread per request;
    409 ``staleEpoch`` / ``conflict``, 500 for a service exception). A
    handler thread's device work runs on the card's default stream (a new
    thread's current stream), and the service lock holds from the sync
    through the ownership check, so batches run one at a time on that
    stream in the order they took the lock: the mirror stays frozen from
    sync to commit, as in JAX.
  * ``WireClient``, ``_WireInflight``, ``WirePipeline`` (``:1183-1428``):
    the client transport with split connect and read deadlines, statuses
    mapped to ``backend/errors.py``'s taxonomy, the retry policy, and the
    pipelined lanes whose replies route by the echoed ``batchId``. As in
    JAX, the service runs pipelined batches in the order their handler
    threads take the lock, so at depth > 1 timing can change what is
    decided (ROADMAP C26); the invariants (ownership, capacity, one bind
    per pod) hold in any order.
  * ``WireScheduler`` (``:1433-2548``): a ``scheduler/scheduler.py:
    Scheduler`` whose filter and score middle goes over the wire. Queue,
    cache, the host gates, the sequential path, failure handling and the
    bind tail stay the port's host machinery (the bind tail is the
    loop's: ``TPUScheduler._assume``, ``_commit_bindings``,
    ``_bind_stage``). It runs nothing on a device and takes no ``device``.
    Its client is a ``WireClient``, a ``grpc_service.GrpcClient``
    (``transport="grpc"``), or, for more than one endpoint, a
    ``fabric.DeviceFabric`` of either, as in JAX.

No fallback hides the card: ``DeviceService(device=None)`` raises without
CUDA, and a failure of the batch program, of the kernel's build or launch,
or of the preemption screen raises out of ``schedule_batch`` (HTTP 500, a
``PermanentDeviceError`` at the client) where the JAX service drops the
screen's hints (``:975``); ``WireScheduler`` raises that error out of its
cycle, where the JAX client counts it against its breaker and, once the
breaker opens, schedules on the host. Only a transport failure
(``TransientDeviceError``, a fabric's ``FailoverError`` from a replica lost
to one) counts against the breaker; a failover from a permanent error raises
that error once the fabric has promoted a standby. The JAX lock tracer is
not ported: plain locks.

Which pods ride the wire (``_wire_supported``): no volumes, claims that
resolve, and a profile the batch program implements (the loop's
``_framework_batchable``: names, weights and ``BAKED_ARGS``, C20; the JAX
client compares names and weights). A pod's claims ride the request as
selector rows (``claim_mask.wire_claims_for_batch``).

Measurement hooks beside the JAX ones: each reply carries ``serviceTime``
(the handler's host ms: decode, sync, encode, dispatch, read, commit) and,
with telemetry on, ``deviceTime`` (the dispatch ledger's dwell / exec /
fetch of the blocking read, and ``deviceExecMs``, the batch program's CUDA
events). ``DeviceService.batch_log`` and ``WireScheduler.wire_log`` keep
one record per batch (``perf/workloads.py:run_loop_wire`` reads both).

Wire envelope: {"apiVersion": "ktpu/v1", ...}; objects use ``api/codec.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import itertools
import json
import os
import socket
import threading
import time
import urllib.parse
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..api.codec import from_wire, to_wire
from ..api.types import Node, Pod
from ..framework.plugins.noderesources import fits_request
from ..framework.types import Diagnosis, NodeInfo, QueuedPodInfo, next_generation
from ..metrics import latency_ledger
from ..testing import locktrace
from ..metrics.scheduler_metrics import ERROR, UNSCHEDULABLE
from ..ops.encode import CapacityError
from ..ops.preempt import screen_prefix
from ..ops.quota import QUOTA_OK_BIT, QUOTA_SCREEN_BIT, build_quota_batch_args
from ..ops.tiebreak import seeds_for
from ..queue import events as qevents
from ..scheduler.scheduler import BindItem, Scheduler, num_feasible_nodes_to_find
from ..framework.runtime import sampled_attempt
from ..utils import tracing
from ..utils.device import DeviceLike, resolve_device
from . import telemetry
from .batch import SLICE_PLAN_OK_BIT, pack_result_block, unpack_result_block
from .batch_scheduler import (adopt_device_batch, batch_gangs, dispatch_device_batch,
                              encode_device_batch, slice_batch_kw)
from .circuit import HALF_OPEN, OPEN, STATE_VALUES, CircuitBreaker
from .claim_mask import (ClaimMaskBuilder, build_dra_mask, wire_claims_for_batch,
                         wire_claims_to_entries)
from .commit_plane import materialize_profiled
from .device_state import DeviceState, caps_for_cluster
from .errors import (ConflictError, DeviceServiceError, FailoverError, PermanentDeviceError,
                     RetryPolicy, StaleEpochError, TransientDeviceError, raise_injected_fault)
from .sizer import BatchSizer
from .tpu_scheduler import ATTRIBUTION_ORDER, GROW_ATTEMPTS, TPUScheduler, _default_full_batch

API_VERSION = "ktpu/v1"

# session lease: a replica that stops heartbeating for this long is fenced
DEFAULT_LEASE_TTL_S = 15.0
# the candidate list a preemption hint ships whole (an exact screen only)
HINT_CANDIDATES_MAX = 1024
# the per-node statuses a failed pod's result carries (payload bound)
STATUS_SAMPLE = 64
# per-batch records kept (DeviceService.batch_log and batch_paths,
# WireScheduler.wire_log): the newest this many
LOG_DEPTH = 4096

# process-epoch minting: unique per DeviceService instance (a restarted
# service is a new instance with a fresh empty DeviceState)
_EPOCH_IDS = itertools.count(1)

_REASON_OF = dict(ATTRIBUTION_ORDER)


def _new_epoch() -> str:
    return f"{os.getpid():x}-{next(_EPOCH_IDS)}"


class ClientSession:
    """One client's sync state (``:94``): the node generations it pushed,
    its delta sequence, its idempotency cache (the last
    ``IDEMPOTENCY_DEPTH`` batches by batchId: a pipelined client retries
    any of them), its lease and its fence."""

    IDEMPOTENCY_DEPTH = 32

    __slots__ = ("client_id", "gen", "created_at", "last_seen", "delta_seq",
                 "sent_gens", "last_batches", "batch_replays", "batches",
                 "fenced", "fenced_seq", "fence_seq_seen", "released_holds",
                 "replicator", "last_push_seq")

    def __init__(self, client_id: str, gen: int, now: float):
        self.client_id = client_id
        # a warm-standby replication session: its claims keep nodes alive
        # but never block a direct client's ghost sweep
        self.replicator = False
        self.last_push_seq = 0  # service delta_seq at its last applied push
        self.gen = gen
        self.created_at = now
        self.last_seen = now
        self.delta_seq = 0
        self.sent_gens: Dict[str, int] = {}
        self.last_batches: "OrderedDict[str, dict]" = OrderedDict()
        self.batch_replays = 0
        self.batches = 0
        self.fenced = False
        self.fenced_seq = 0
        self.fence_seq_seen = 0
        self.released_holds = 0

    @property
    def last_batch(self) -> Optional[tuple]:
        """(batchId, response) of the newest cached batch, or None."""
        if not self.last_batches:
            return None
        bid = next(reversed(self.last_batches))
        return (bid, self.last_batches[bid])

    def cache_batch(self, batch_id: str, response: dict) -> None:
        self.last_batches[batch_id] = response
        while len(self.last_batches) > self.IDEMPOTENCY_DEPTH:
            self.last_batches.popitem(last=False)


class _Hold:
    """One adopted-but-unconfirmed placement (``:157``): while held, every
    delta for its node re-overlays the pod, so a lagging replica's push
    cannot free the capacity twice. ``batch_id`` names the batch that made
    it: the owner's push releases it only once that batch is no longer in
    the owner's ``inflightBatchIds``."""

    __slots__ = ("pod", "node_name", "owner", "seen", "batch_id")

    def __init__(self, pod: Pod, node_name: str, owner: str,
                 batch_id: Optional[str] = None):
        self.pod = pod
        self.node_name = node_name
        self.owner = owner
        self.seen: set = set()  # client ids whose pushed content included it
        self.batch_id = batch_id


class DeviceService:
    """Server core (``:178``): the node mirror, a ``DeviceState`` on
    ``device`` and the batch program, shared by any number of client
    sessions. ``self.state`` is the DeviceState (the JAX ``self.device``),
    ``self.device`` the torch device. Counters: ``batch_counter`` (batch
    programs run), ``batch_replays`` (idempotent replays, no program run),
    ``batch_paths`` ("fused", "scan" or "spec" per batch),
    ``stage_seconds`` and ``batch_log`` (one record per batch run)."""

    def __init__(self, batch_size: int = 512, percentage_of_nodes_to_score: int = 0,
                 lease_ttl_s: float = DEFAULT_LEASE_TTL_S, now_fn=time.monotonic,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.lease_ttl_s = lease_ttl_s
        self.now_fn = now_fn
        # the epoch names this incarnation; delta_seq counts applied pushes
        self.epoch = _new_epoch()
        self.delta_seq = 0
        self.sessions: Dict[str, ClientSession] = {}
        self._session_gens = itertools.count(1)
        self.batch_replays = 0
        self.holds: Dict[str, _Hold] = {}
        # pod key -> node for pods in pushed content (the "already bound"
        # index of the ownership check), and node -> its content's keys
        self._pod_nodes: Dict[str, str] = {}
        self._node_pod_keys: Dict[str, set] = {}
        self._last_direct_full_seq = 0  # the lap marker of replicators
        self._fences: List[tuple] = []  # (seq, client_id)
        self._fence_seq = 0
        self.takeovers = 0
        self.commit_conflicts = 0
        self.infos: Dict[str, NodeInfo] = {}
        # a duck-typed Snapshot: every sync walks every node
        self.snap = SimpleNamespace(node_info_map=self.infos, changed_names=set(),
                                    structure_version=0)
        self.ns_labels: Dict[str, Dict[str, str]] = {}
        # ns -> (used row, limit row): the client's quota ledger export,
        # replaced whole by each push that carries a quotaTable
        self.quota_table: Dict[str, tuple] = {}
        self.state: Optional[DeviceState] = None
        self.batch_counter = 0
        self.batch_paths: Deque[str] = deque(maxlen=LOG_DEPTH)
        self._start_carry: Optional[torch.Tensor] = None  # the sampling window's start
        self.stage_seconds = dict.fromkeys(("decode", "sync", "encode", "dispatch", "read",
                                            "commit"), 0.0)
        self.batch_log: Deque[dict] = deque(maxlen=LOG_DEPTH)
        self._push_seconds = 0.0  # apply_deltas handler seconds since the last batch
        self._push_sync = 0.0     # of which the device sync
        self._lock = locktrace.make_lock("DeviceService")

    def _on_device(self):
        """The service's card as current on the calling (handler) thread."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    # ------------------------------------------------------------- epoch

    def check_epoch(self, req: dict) -> None:
        """Refuse a request stamped with another incarnation's epoch, but a
        full resync, which establishes a new base."""
        expect = req.get("expectEpoch")
        if expect and expect != self.epoch and not req.get("full"):
            raise StaleEpochError(self.epoch)

    def _stamp(self, out: dict) -> dict:
        out["epoch"] = self.epoch
        out["deltaSeq"] = self.delta_seq
        return out

    # ------------------------------------------------------------ sessions

    def _live_sessions(self) -> List[ClientSession]:
        return [s for s in self.sessions.values() if not s.fenced]

    def _session_for(self, req: dict) -> ClientSession:
        """The request's session, created or rejoined as needed, its lease
        touched (``:268``). ConflictError for a fenced or superseded
        incarnation. Caller holds the lock."""
        now = self.now_fn()
        self._sweep_leases(now)
        cid = req.get("clientId") or ""
        gen = req.get("sessionGen")
        s = self.sessions.get(cid)
        if s is None or (s.fenced and gen is None):
            s = ClientSession(cid, next(self._session_gens), now)
            s.fence_seq_seen = self._fence_seq
            self.sessions[cid] = s
        if s.fenced:
            raise ConflictError(
                f"client {cid!r} session {gen} was fenced (lease expired "
                f"after {self.lease_ttl_s}s); rejoin with a full resync")
        if gen is not None and gen != s.gen:
            raise ConflictError(f"client {cid!r} session {gen} superseded by {s.gen}")
        if req.get("replicator"):
            s.replicator = True
        s.last_seen = now
        return s

    def _sweep_leases(self, now: float) -> None:
        """Fence every named session whose lease expired (an anonymous
        session never expires)."""
        for cid, s in list(self.sessions.items()):
            if not cid or s.fenced:
                continue
            if now - s.last_seen > self.lease_ttl_s:
                self._fence(s)

    def _fence(self, s: ClientSession) -> None:
        """Declare a client dead (``:310``): poison its idempotency cache
        and release its never-confirmed holds to the survivors."""
        last_batch_id = s.last_batch[0] if s.last_batch else None
        s.fenced = True
        s.last_batches.clear()
        self._fence_seq += 1
        s.fenced_seq = self._fence_seq
        self._fences.append((self._fence_seq, s.client_id))
        self.takeovers += 1
        released_before = s.released_holds
        for key, hold in list(self.holds.items()):
            if hold.owner != s.client_id:
                continue
            # a hold in the node's pushed content, or ever seen in any
            # client's truth, is bound: releasing it would double-book
            confirmed = key in self._node_pod_keys.get(hold.node_name, ()) or hold.seen
            if not confirmed:
                ni = self.infos.get(hold.node_name)
                if ni is not None:
                    ni.remove_pod(hold.pod)
                s.released_holds += 1
            del self.holds[key]
        telemetry.event("fence", client=s.client_id, epoch=self.epoch,
                        batchId=last_batch_id,
                        releasedHolds=s.released_holds - released_before)

    def _prune_fences(self) -> None:
        """Drop fence-log entries every live session has seen, and dead
        sessions past a grace window (``:343``)."""
        live = [s for s in self.sessions.values() if not s.fenced and s.client_id]
        if not live:
            return
        horizon = min(s.fence_seq_seen for s in live)
        if self._fences and self._fences[0][0] <= horizon:
            self._fences = [(seq, cid) for seq, cid in self._fences if seq > horizon]
        grace = 10.0 * self.lease_ttl_s
        now = self.now_fn()
        for cid, s in list(self.sessions.items()):
            if s.fenced and s.fenced_seq <= horizon and now - s.last_seen > grace:
                del self.sessions[cid]

    def heartbeat(self, req: dict) -> dict:
        """Lease renewal; the answer names every peer fenced since this
        client's last beat (``:369``)."""
        with self._lock:
            s = self._session_for(req)
            fenced = [cid for seq, cid in self._fences
                      if seq > s.fence_seq_seen and cid != s.client_id]
            s.fence_seq_seen = self._fence_seq
            self._prune_fences()
            return self._stamp({"apiVersion": API_VERSION, "sessionGen": s.gen,
                                "leaseTtlS": self.lease_ttl_s,
                                "sessions": len(self._live_sessions()), "fenced": fenced})

    def sessions_dump(self, req: Optional[dict] = None) -> dict:
        """The session table (``:388``, the /debug/sessions body)."""
        with self._lock:
            now = self.now_fn()
            per_owner: Dict[str, int] = {}
            for hold in self.holds.values():
                per_owner[hold.owner] = per_owner.get(hold.owner, 0) + 1
            sessions = []
            for cid in sorted(self.sessions):
                s = self.sessions[cid]
                sessions.append({
                    "clientId": cid, "sessionGen": s.gen,
                    "leaseAgeS": now - s.last_seen,
                    "leaseTtlS": self.lease_ttl_s if cid else None,
                    "deltaSeq": s.delta_seq, "sentNodes": len(s.sent_gens),
                    "batches": s.batches, "batchReplays": s.batch_replays,
                    "inflightHolds": per_owner.get(cid, 0),
                    "releasedHolds": s.released_holds, "fenced": s.fenced,
                })
            return self._stamp({"apiVersion": API_VERSION, "enabled": True,
                                "leaseTtlS": self.lease_ttl_s, "takeovers": self.takeovers,
                                "commitConflicts": self.commit_conflicts,
                                "holds": len(self.holds), "sessions": sessions})

    # ------------------------------------------------------------- deltas

    def apply_deltas(self, req: dict) -> dict:
        self.check_epoch(req)
        t0 = time.perf_counter()
        try:
            with tracing.span_from_remote(req.get("traceparent"), "device.apply_deltas",
                                          nodes=len(req.get("nodes", ()))):
                return self._apply_deltas_traced(req)
        finally:
            with self._lock:
                self._push_seconds += time.perf_counter() - t0

    def _apply_deltas_traced(self, req: dict) -> dict:
        # decode outside the lock: request-local work
        decoded = []
        t_dec = time.perf_counter()
        for e in req.get("nodes", ()):
            node = from_wire(Node, e["node"])
            pods = [from_wire(Pod, pw) for pw in e.get("pods", ())]
            decoded.append((node, pods, e.get("gen")))
        decode_s = time.perf_counter() - t_dec
        inflight_ids = set(req.get("inflightBatchIds") or ())
        with self._lock:
            self.stage_seconds["decode"] += decode_s
            s = self._session_for(req)
            if s.replicator and self._last_direct_full_seq > s.last_push_seq:
                # lapped by a direct client's full resync: reseed
                s.last_push_seq = self.delta_seq
                raise ConflictError("replicator lapped by a direct full resync; reseed")
            if req.get("full"):
                # a full resync replaces this client's contribution only; a
                # node no other live direct session claims is a ghost
                s.sent_gens.clear()
                pushed = {node.meta.name for node, _, _ in decoded}
                others = [o for o in self._live_sessions() if o is not s and o.client_id]
                claimers = [o for o in others if not o.replicator]
                if s.replicator:
                    claimers = [o for o in claimers if o.last_push_seq > s.last_push_seq]
                for name in list(self.infos):
                    if name in pushed:
                        continue
                    if any(name in o.sent_gens for o in claimers):
                        continue
                    self._drop_node(name)
                    for o in others:
                        o.sent_gens.pop(name, None)
                if not others:
                    self.ns_labels.clear()
                    self.quota_table.clear()
                    self.state = None
            live_ids = {o.client_id for o in self._live_sessions()}
            # a replicator's entry at or below a direct session's pushed
            # generation is stale: skipped
            direct = ([o for o in self._live_sessions()
                       if o is not s and not o.replicator and o.client_id]
                      if s.replicator else [])
            direct_newer = [o for o in direct if o.last_push_seq > s.last_push_seq]
            for node, pods, gen in decoded:
                name = node.meta.name
                if s.replicator and gen is not None and any(
                        o.sent_gens.get(name) is not None and o.sent_gens[name] >= gen
                        for o in direct):
                    continue
                ni = NodeInfo(node)
                content_keys = set()
                for pod in pods:
                    ni.add_pod(pod)
                    content_keys.add(pod.key())
                if gen is not None:
                    ni.generation = gen
                    s.sent_gens[name] = gen
                # hold reconciliation (``:541-564``): the pusher's content is
                # the truth for its own holds, but for one from a batch still
                # in its flight; other owners' holds overlay until every
                # live client's truth has them
                for key, hold in list(self.holds.items()):
                    if hold.node_name != name:
                        continue
                    if key in content_keys:
                        hold.seen.add(s.client_id)
                        if live_ids <= hold.seen:
                            del self.holds[key]
                    elif (hold.owner == s.client_id
                          and not (hold.batch_id and hold.batch_id in inflight_ids)):
                        del self.holds[key]
                    else:
                        ni.add_pod(hold.pod)
                for key in self._node_pod_keys.get(name, ()):
                    if self._pod_nodes.get(key) == name:
                        del self._pod_nodes[key]
                self._node_pod_keys[name] = content_keys
                for key in content_keys:
                    self._pod_nodes[key] = name
                self.infos[name] = ni
            for name in req.get("removed", ()):
                if s.replicator and any(name in o.sent_gens for o in direct_newer):
                    s.sent_gens.pop(name, None)
                    continue
                self._drop_node(name)
                s.sent_gens.pop(name, None)
            for ns, labels in (req.get("namespaces") or {}).items():
                self.ns_labels[ns] = dict(labels)
            qt = req.get("quotaTable")
            if qt is not None:
                self.quota_table = {ns: (rows.get("used") or [], rows.get("limit") or [])
                                    for ns, rows in qt.items()}
            t_sync = time.perf_counter()
            with self._on_device():
                self._sync()
            dt = time.perf_counter() - t_sync
            self.stage_seconds["sync"] += dt
            self._push_sync += dt
            self.delta_seq += 1
            s.delta_seq += 1
            s.last_push_seq = self.delta_seq
            if req.get("full") and not s.replicator and s.client_id:
                self._last_direct_full_seq = self.delta_seq
            return self._stamp({"apiVersion": API_VERSION, "nodes": len(self.infos),
                                "sessionGen": s.gen})

    def _drop_node(self, name: str) -> None:
        """Remove a node and every index entry and hold anchored to it."""
        self.infos.pop(name, None)
        for key in self._node_pod_keys.pop(name, ()):
            if self._pod_nodes.get(key) == name:
                del self._pod_nodes[key]
        for key, hold in list(self.holds.items()):
            if hold.node_name == name:
                del self.holds[key]

    def _new_state(self, caps) -> DeviceState:
        return DeviceState(caps, self.device, lambda ns: self.ns_labels.get(ns, {}))

    def _ensure_device(self) -> None:
        """The mirror, built or rebuilt with a doubled node axis when the
        cluster outgrew it (``:618``)."""
        n = max(len(self.infos), 1)
        if self.state is None:
            self.state = self._new_state(caps_for_cluster(n, batch=self.batch_size))
        elif self.state.caps.nodes < n:
            caps = self.state.caps
            nodes = caps.nodes
            while nodes < n:
                nodes *= 2
            self.state = self._new_state(dataclasses.replace(
                caps, nodes=nodes, value_words=max(caps.value_words, (nodes + 2 + 31) // 32)))

    def _sync(self) -> None:
        """Sync the mirror to the node infos, growing as the sync asks
        (``:636``). The mirror stays as synced until the next batch's
        ownership check: both run under the service lock."""
        self._ensure_device()
        for _attempt in range(GROW_ATTEMPTS):
            try:
                # the mirror stays frozen from sync to commit: a deliberate hold
                locktrace.note_blocking("device_sync", "DeviceService.sync",
                                        allowed="mirror must stay frozen from sync to commit")
                with tracing.span("device.sync"):
                    self.state.sync(self.snap)
                return
            except CapacityError as e:
                self._grow(e)
        raise PermanentDeviceError("device capacities refuse to converge")

    def _grow(self, err: CapacityError) -> None:
        """A fresh mirror with the axis ``err`` names doubled until it
        covers ``err.needed`` (the loop's ``_GROW_FIELDS``)."""
        caps = self.state.caps
        fields = TPUScheduler._GROW_FIELDS.get(err.dimension)
        if fields is None and err.dimension.startswith("value vocab"):
            fields = ("value_words",)
        if fields is None:
            raise PermanentDeviceError(f"unknown capacity dimension {err.dimension!r}") from err
        updates = {}
        for f in fields:
            v = getattr(caps, f)
            while v < err.needed:
                v *= 2
            updates[f] = v
        self.state = self._new_state(dataclasses.replace(caps, **updates))

    # --------------------------------------------------------------- health

    def health(self, req: dict) -> dict:
        """The cheap identity verb: no device work, no epoch check."""
        with self._lock:
            return self._stamp({"apiVersion": API_VERSION, "status": "serving",
                                "nodes": len(self.infos)})

    # ------------------------------------------------------------- schedule

    def schedule_batch(self, req: dict) -> dict:
        self.check_epoch(req)
        t0 = time.perf_counter()
        batch_id = req.get("batchId")
        session_req = {"clientId": req.get("clientId"), "sessionGen": req.get("sessionGen")}
        with self._lock:
            s = self._session_for(session_req)
            if batch_id and batch_id in s.last_batches:
                # a retry of a batch this session committed: its stored reply
                s.batch_replays += 1
                self.batch_replays += 1
                return s.last_batches[batch_id]
        pods = [from_wire(Pod, pw) for pw in req.get("pods", ())]
        decode_s = time.perf_counter() - t0
        tie_seeds = req.get("tieSeeds") or None
        with tracing.span_from_remote(req.get("traceparent"), "device.schedule_batch",
                                      batch=len(pods)):
            out = self._schedule_batch_traced(pods, tie_seeds, req.get("claims"),
                                              session_req=session_req, batch_id=batch_id,
                                              t0=t0, decode_s=decode_s)
        if batch_id:
            with self._lock:
                cur = self.sessions.get(session_req.get("clientId") or "")
                if cur is not None and not cur.fenced:
                    cur.cache_batch(batch_id, out)
        return out

    def _validate_placements(self, cid: str, pods: List[Pod], node_idx: np.ndarray,
                             slot_names: Dict[int, str], batch_id=None) -> Dict[int, str]:
        """The ownership check at commit time (``:732``): each proposed
        placement against the current owners and occupancy. Accepted ones
        become holds, overlaid at once; rejected ones return {batch row:
        reason}. Caller holds the lock."""
        conflicts: Dict[int, str] = {}
        for i, pod in enumerate(pods):
            idx = int(node_idx[i])
            if idx < 0 or idx not in slot_names:
                continue
            key = pod.key()
            node_name = slot_names[idx]
            bound = self._pod_nodes.get(key)
            if bound is not None:
                conflicts[i] = f"pod already bound on {bound}"
                continue
            hold = self.holds.get(key)
            if hold is not None and hold.owner != cid:
                conflicts[i] = f"pod already committed by client {hold.owner!r}"
                continue
            ni = self.infos.get(node_name)
            if ni is None:
                conflicts[i] = f"node {node_name} left the mirror"
                continue
            if hold is not None:
                # the owner re-deciding its own pod: the old hold goes first
                old_ni = self.infos.get(hold.node_name)
                if old_ni is not None:
                    old_ni.remove_pod(hold.pod)
                del self.holds[key]
            if fits_request(pod.resource_request(), ni):
                conflicts[i] = f"node {node_name} occupancy changed (capacity raced)"
                continue
            ni.add_pod(pod)
            self.holds[key] = _Hold(pod, node_name, cid, batch_id=batch_id)
        if conflicts:
            self.commit_conflicts += len(conflicts)
            for i, reason in conflicts.items():
                telemetry.event("conflict", client=cid, batchId=batch_id, pod=pods[i].key(),
                                reason=reason)
        return conflicts

    def _sample_args(self):
        """(sample_k, sample_start) of the next batch, or (None, None) for a
        full batch: an explicit percentage samples; the default (0)
        evaluates the full batch on CUDA and samples on the CPU
        (``:810-831``)."""
        n_valid = len(self.infos)
        if self.percentage_of_nodes_to_score:
            k = num_feasible_nodes_to_find(n_valid, self.percentage_of_nodes_to_score)
        elif _default_full_batch(self.device):
            k = n_valid
        else:
            k = num_feasible_nodes_to_find(n_valid, 0)
        if k >= n_valid:
            return None, None
        start = self._start_carry
        if start is None:
            start = torch.zeros((), dtype=torch.int32, device=self.device)
        return k, start

    def _batch_kw(self, state: DeviceState, pods, pad_to: int, claims) -> Dict[str, object]:
        """The batch program's masks and screens (``:832-882``): the claim
        mask from the request's selector rows against this mirror's
        attribute table, the slice gangs' member index, and the quota
        screen's columns after the client's table is synced in."""
        kw: Dict[str, object] = {}
        if claims:
            dra = build_dra_mask(state, wire_claims_to_entries(claims), pad_to)
            if dra is not None:
                kw["dra_mask"] = dra
        kw.update(slice_batch_kw(batch_gangs(pods)[1], state))
        if self.quota_table or state.nsq_slots:
            ns_idx, req = build_quota_batch_args(pods, state, self.quota_table, pad_to)
            if ns_idx is not None:
                kw.update(quota_ns=ns_idx, quota_req=torch.from_numpy(req).to(self.device),
                          quota_used=state.nsq_used, quota_limit=state.nsq_limit)
        return kw

    def _preempt_hints(self, state: DeviceState, pods: List[Pod], batch, bucket: int):
        """(screen [P, N] bool, best [P] slot) of the device preemption
        screen (``ops/preempt.py:screen_prefix``) over the batch's failed
        pods, read once. Its failure raises: the JAX service drops the
        hints (``:975``), which would hide a failing card."""
        failed = batch.node_idx[:len(pods)] < 0
        with telemetry.dispatch("preempt_screen", bucket=str(bucket)):
            pres = screen_prefix(batch.pb, state.preempt_inputs(), batch.res.static_masks,
                                 failed)
        best, screen, _, _ = unpack_result_block(
            pack_result_block(pres.best, pres.screen.to(torch.int8)), state.caps.nodes)
        return screen.astype(bool), best

    def _schedule_batch_traced(self, pods: List[Pod], tie_seeds, claims=None,
                               session_req=None, batch_id=None, t0: float = 0.0,
                               decode_s: float = 0.0) -> dict:
        laps = {"sync": 0.0, "encode": 0.0, "dispatch": 0.0, "read": 0.0, "commit": 0.0}
        with self._lock, self._on_device():
            # the fencing-token rule: re-validate the session at commit time
            s = self._session_for(session_req or {})
            s.batches += 1
            cid = s.client_id
            self._ensure_device()
            for _attempt in range(GROW_ATTEMPTS):
                state = self.state
                try:
                    t = time.perf_counter()
                    with tracing.span("device.sync"):
                        state.sync(self.snap)
                    t1 = time.perf_counter()
                    laps["sync"] += t1 - t
                    with tracing.span("device.encode", batch=len(pods)):
                        enc = encode_device_batch(
                            state, pods, tie_seeds=tie_seeds,
                            extras=lambda p, pad_to: self._batch_kw(state, p, pad_to, claims))
                    laps["encode"] += time.perf_counter() - t1
                    break
                except CapacityError as e:
                    self._grow(e)
            else:
                raise PermanentDeviceError("device capacities refuse to converge")
            t = time.perf_counter()
            self.batch_counter += 1
            bucket = enc.pb.capacity
            sig = f"{bucket}/{enc.mode}"
            sample_k, sample_start = self._sample_args()
            telemetry.event("dispatch", batchId=batch_id, client=cid, epoch=self.epoch,
                            bucket=bucket, sig=sig, pods=len(pods))
            locktrace.note_blocking("device_dispatch", "DeviceService.schedule_batch",
                                    allowed="kernel must judge under the same lock as commit")
            with tracing.span("device.dispatch", batch=len(pods)):
                with telemetry.dispatch("schedule_batch", bucket=sig):
                    disp = dispatch_device_batch(state, enc, sample_k, sample_start)
            t_dispatch = self.now_fn()
            if disp.res.final_sample_start is not None:
                self._start_carry = disp.res.final_sample_start
            self.batch_paths.append(disp.path)
            t1 = time.perf_counter()
            laps["dispatch"] = t1 - t
            with tracing.span("device.commit", batch=len(pods), packed="packed"):
                read, rec = materialize_profiled(
                    disp, state.caps.nodes, program="schedule_batch", bucket=sig,
                    t_submit=t_dispatch, now_fn=self.now_fn, batch_id=batch_id or "",
                    pods=len(pods))
                batch = adopt_device_batch(state, disp, read)
            t2 = time.perf_counter()
            laps["read"] = t2 - t1
            node_idx, slot_names = batch.node_idx, batch.slot_names
            conflicts = self._validate_placements(cid, pods, node_idx, slot_names,
                                                  batch_id=batch_id)
            if telemetry.get() is not None:
                extra = {}
                if rec is not None:
                    extra = {"device_ms": round(rec["execS"] * 1e3, 3),
                             "fetch_ms": round(rec["fetchS"] * 1e3, 3)}
                telemetry.event("commit", batchId=batch_id, client=cid, epoch=self.epoch,
                                bucket=bucket, pods=len(pods),
                                placed=int(sum(1 for i in range(len(pods))
                                               if int(node_idx[i]) >= 0 and i not in conflicts)),
                                conflicts=len(conflicts), **extra)
            failed_any = bool((node_idx[:len(pods)] < 0).any())
            screen = best = None
            if failed_any:
                screen, best = self._preempt_hints(state, pods, batch, bucket)
            results = self._results(pods, batch, conflicts, screen, best)
            laps["commit"] = time.perf_counter() - t2
            self.stage_seconds["decode"] += decode_s
            for k, v in laps.items():
                self.stage_seconds[k] += v
            service_ms = {f"{k}Ms": round(v * 1e3, 3) for k, v in laps.items()}
            service_ms["decodeMs"] = round(decode_s * 1e3, 3)
            total_s = time.perf_counter() - t0
            service_ms["totalMs"] = round(total_s * 1e3, 3)
            self.batch_log.append({"batchId": batch_id, "client": cid, "pods": len(pods),
                                   "path": disp.path, "mode": enc.mode, **laps, "total": total_s,
                                   "decode": decode_s, "push": self._push_seconds,
                                   "push_sync": self._push_sync,
                                   "deviceExecS": rec.get("deviceExecS") if rec else None})
            self._push_seconds = self._push_sync = 0.0
            out = {"apiVersion": API_VERSION, "results": results, "sessionGen": s.gen,
                   "serviceTime": service_ms}
            if batch_id:
                out["batchId"] = batch_id  # a pipelined client routes the reply by it
            if rec is not None:
                out["deviceTime"] = {
                    "dwellMs": round(rec["dwellS"] * 1e3, 3),
                    "execMs": round(rec["execS"] * 1e3, 3),
                    "fetchMs": round(rec["fetchS"] * 1e3, 3),
                    "deviceMs": round((rec["execS"] + rec["fetchS"]) * 1e3, 3),
                }
                if rec.get("deviceExecS") is not None:
                    out["deviceTime"]["deviceExecMs"] = round(rec["deviceExecS"] * 1e3, 4)
            # stamped inside the lock: a peer's push moves deltaSeq
            return self._stamp(out)

    def _results(self, pods: List[Pod], batch, conflicts: Dict[int, str], screen,
                 best) -> List[dict]:
        """The per-pod verdicts (``:977-1034``): the node, a conflict, or the
        failed filters (``unschedulablePlugins`` over the real slots, a
        sample of per-node statuses) with the preemption hint; then the
        slice gangs' verdict words and every screened pod's quota word."""
        node_idx, slot_names, ff = batch.node_idx, batch.slot_names, batch.first_fail
        slots = np.fromiter(slot_names.keys(), np.int64, len(slot_names))
        names = list(slot_names.values())
        results: List[dict] = []
        for i in range(len(pods)):
            idx = int(node_idx[i])
            if i in conflicts:
                results.append({"nodeName": None, "conflict": True, "error": conflicts[i]})
                continue
            if idx >= 0 and idx in slot_names:
                results.append({"nodeName": slot_names[idx]})
                continue
            fids = ff[i][slots].astype(np.int64)
            failing = np.flatnonzero(fids > 0)
            statuses = {names[j]: ATTRIBUTION_ORDER[fids[j] - 1][0]
                        for j in failing[:STATUS_SAMPLE]}
            r = {"nodeName": None,
                 "unschedulablePlugins": [ATTRIBUTION_ORDER[f - 1][0]
                                          for f in sorted(set(fids[failing].tolist()))],
                 "statuses": statuses}
            if screen is not None:
                cands = [names[j] for j in np.flatnonzero(screen[i][slots])]
                best_name = slot_names.get(int(best[i])) if best[i] >= 0 else None
                if len(cands) <= HINT_CANDIDATES_MAX:
                    r["preempt"] = {"candidates": cands, "best": best_name}
                elif best_name is not None:
                    r["preempt"] = {"candidates": None, "best": best_name}
            results.append(r)
        _flat, slices = batch_gangs(pods)
        if batch.slice_words is not None:
            for rows in slices.values():
                for i in rows:
                    results[i]["slice"] = int(batch.slice_words[i])
        if batch.quota_words is not None:
            for i in range(len(pods)):
                w = int(batch.quota_words[i])
                if w:
                    results[i]["quota"] = w
        return results


# ---------------------------------------------------------------- transport


class ServiceBinding:
    """The service slot behind a running server (``:1061``): ``restart``
    swaps in a fresh DeviceService (new epoch, empty mirror, same device
    and settings) without closing the listener."""

    def __init__(self, service: DeviceService, fault_plan=None):
        self.service = service
        self.fault_plan = fault_plan
        self.restarts = 0

    def restart(self) -> DeviceService:
        old = self.service
        self.service = DeviceService(
            batch_size=old.batch_size,
            percentage_of_nodes_to_score=old.percentage_of_nodes_to_score,
            lease_ttl_s=old.lease_ttl_s, now_fn=old.now_fn, device=old.device)
        self.restarts += 1
        return self.service


_OPS = {"/v1/applyDeltas": "apply_deltas", "/v1/scheduleBatch": "schedule_batch",
        "/v1/health": "health", "/v1/heartbeat": "heartbeat",
        "/v1/sessions": "sessions_dump"}


def _sever(handler) -> None:
    handler.close_connection = True
    try:
        handler.connection.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


class _Handler(BaseHTTPRequestHandler):
    binding: ServiceBinding = None  # set by serve()

    def log_message(self, *args):  # quiet
        pass

    def _json(self, code: int, out: dict) -> None:
        payload = json.dumps(out).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):  # noqa: N802 - stdlib naming
        op = _OPS.get(self.path)
        if op is None:
            self.send_error(404)
            return
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        plan = self.binding.fault_plan
        fault = plan.next_server(op) if plan is not None else None
        if fault is not None:
            if fault.kind == "crash":
                # the service dies mid-request and is restarted: a fresh
                # service, and the connection reset without a reply
                self.binding.restart()
                _sever(self)
                return
            if fault.kind == "conflict":
                self._json(409, {"error": "injected conflict", "conflict": True})
                return
            if fault.kind == "torn":
                # processed, then the reply is lost: the client's retry
                # meets the idempotency cache
                try:
                    getattr(self.binding.service, op)(body)
                except Exception:  # noqa: BLE001 - the reply is lost either way
                    pass
                _sever(self)
                return
            self._json(fault.status, {"error": f"injected fault: {fault.kind}"})
            return
        try:
            out = getattr(self.binding.service, op)(body)
        except StaleEpochError as exc:
            self._json(409, {"error": str(exc), "staleEpoch": True, "epoch": exc.epoch})
            return
        except ConflictError as exc:
            self._json(409, {"error": str(exc), "conflict": True})
            return
        except Exception as exc:  # noqa: BLE001 - the error goes back as a 500
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._json(200, out)


def serve(service: DeviceService, port: int = 0, fault_plan=None):
    """Start the HTTP binding on 127.0.0.1 (``:1169``); returns (server,
    port). The caller stops it: ``server.shutdown()`` then
    ``server.server_close()`` (``stop``). ``server.binding`` is the
    restartable service slot; ``fault_plan`` is a ``testing/faults.py``
    FaultPlan."""
    binding = ServiceBinding(service, fault_plan=fault_plan)
    handler = type("BoundHandler", (_Handler,), {"binding": binding})
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    server.binding = binding
    t = threading.Thread(target=server.serve_forever, name="ktpu-device-service", daemon=True)
    t.start()
    server.thread = t
    return server, server.server_address[1]


def stop(server) -> None:
    """Stop a server ``serve`` started: its loop, its listening socket and
    its loop's thread."""
    server.shutdown()
    server.server_close()
    server.thread.join(timeout=10)


class WireClient:
    """The HTTP/JSON transport (``:1183``): split connect and read
    deadlines, statuses mapped to the error taxonomy, retries of transient
    failures inside the RetryPolicy's budget, and the client-side fault
    hook before the socket."""

    def __init__(self, endpoint: str, connect_timeout: float = 5.0,
                 read_timeout: float = 60.0, retry: Optional[RetryPolicy] = None,
                 fault_plan=None):
        self.endpoint = endpoint.rstrip("/")
        u = urllib.parse.urlsplit(self.endpoint)
        scheme = u.scheme or "http"
        if scheme not in ("http", "https") or not u.netloc:
            raise ValueError(f"device-service endpoint must be http(s)://host:port, "
                             f"got {endpoint!r}")
        self._conn_cls = (http.client.HTTPSConnection if scheme == "https"
                          else http.client.HTTPConnection)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if scheme == "https" else 80)
        self._base_path = u.path.rstrip("/")
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout
        self.retry = retry if retry is not None else RetryPolicy()
        self.fault_plan = fault_plan

    def _do_post(self, path: str, data: bytes) -> dict:
        # socket IO never runs under a traced lock
        locktrace.note_blocking("http", path)
        conn = self._conn_cls(self._host, self._port, timeout=self.connect_timeout)
        try:
            try:
                conn.connect()
                conn.sock.settimeout(self.read_timeout)  # connected: the read deadline
                conn.request("POST", self._base_path + path, body=data,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                status = resp.status
                body = resp.read()
            except (ConnectionError, http.client.HTTPException, socket.timeout,
                    TimeoutError, OSError) as e:
                raise TransientDeviceError(
                    f"device service unreachable: {type(e).__name__}: {e}") from e
        finally:
            conn.close()
        try:
            out = json.loads(body or b"{}")
        except ValueError as e:
            if status in (502, 503, 504):
                raise TransientDeviceError(f"device service {status}: non-JSON body") from e
            raise PermanentDeviceError(f"malformed device response: {e}") from e
        if status == 409 and out.get("staleEpoch"):
            raise StaleEpochError(out.get("epoch", ""), out.get("error", ""))
        if status == 409 and out.get("conflict"):
            raise ConflictError(out.get("error", "commit conflict"))
        if status in (502, 503, 504):
            raise TransientDeviceError(f"device service {status}: {out.get('error', '')}")
        if status >= 400:
            # a 500 is a service-side exception: deterministic, never retried
            raise PermanentDeviceError(f"device service {status}: {out.get('error', '')}")
        if "error" in out:
            raise PermanentDeviceError(out["error"])
        return out

    def _post(self, path: str, payload: dict, op: str) -> dict:
        data = json.dumps(payload).encode()

        def attempt():
            raise_injected_fault(self.fault_plan, op, self.read_timeout)
            return self._do_post(path, data)

        return self.retry.run(op, attempt)

    # the JSON transport is schema-free: claim rows ride the request as-is
    supports_dra = True
    supports_health = True
    supports_sessions = True

    def apply_deltas(self, payload: dict) -> dict:
        return self._post("/v1/applyDeltas", payload, "apply_deltas")

    def schedule_batch(self, payload: dict) -> dict:
        return self._post("/v1/scheduleBatch", payload, "schedule_batch")

    def health(self) -> dict:
        return self._post("/v1/health", {"apiVersion": API_VERSION}, "health")

    def heartbeat(self, payload: dict) -> dict:
        return self._post("/v1/heartbeat", payload, "heartbeat")

    def sessions_dump(self) -> dict:
        return self._post("/v1/sessions", {"apiVersion": API_VERSION}, "sessions")


# ---------------------------------------------------------------- pipeline


class _WireInflight:
    """One wire batch submitted, its reply not yet processed (``:1303``);
    ``payload`` is kept whole so a stale-epoch drain re-sends the same
    logical batch (same batchId) after the resync."""

    __slots__ = ("qps", "payload", "batch_id", "pod_cycle", "t0", "t_sent", "era",
                 "encode_s", "push_s")

    def __init__(self, qps: List[QueuedPodInfo], payload: dict, pod_cycle: int, t0: float,
                 t_sent: float, era: int, encode_s: float = 0.0, push_s: float = 0.0):
        self.qps = qps
        self.payload = payload
        self.batch_id = payload["batchId"]
        self.pod_cycle = pod_cycle
        self.t0 = t0          # pop time: the attempt-latency clock
        self.t_sent = t_sent  # submit time: the sizer's service-span clock
        self.era = era        # sync era at submit
        self.encode_s = encode_s
        self.push_s = push_s


class WirePipeline:
    """Concurrent transport lanes (``:1324``): up to ``depth`` calls ride
    their own connections at once; each reply is deposited under the
    batchId the server echoes, so replies out of order, duplicated or on
    the wrong lane still reach the batch they answer. Lanes run transport
    only; every scheduler-state change stays on the scheduling thread,
    which blocks in ``claim``. ``last_call_s`` is the claimed batch's call
    on its lane, in seconds."""

    OP = "schedule_batch"

    def __init__(self, send_fn, depth: int, fault_plan=None):
        self._send = send_fn
        self.depth = max(1, int(depth))
        self.fault_plan = fault_plan
        self._cv = threading.Condition(locktrace.make_lock("WirePipeline"))
        self._submitted: Deque[dict] = deque()
        self._completions: Dict[str, tuple] = {}  # batchId -> ("ok", reply) | ("err", exc)
        self._expected: set = set()
        self._lanes = 0
        self.duplicate_replies = 0
        self.call_seconds: Dict[str, float] = {}  # batchId -> its call's seconds, until claimed
        self.last_call_s = 0.0                     # the last claimed batch's

    def submit(self, payload: dict) -> None:
        with self._cv:
            self._expected.add(payload["batchId"])
            self._submitted.append(payload)
            if self._lanes < self.depth:
                self._lanes += 1
                threading.Thread(target=self._lane, name="ktpu-wire-lane", daemon=True).start()

    def claim(self, batch_id: str, timeout: Optional[float] = None):
        """The reply for ``batch_id`` (or the transport error that ended its
        call), blocking until it arrives."""
        with self._cv:
            self._cv.wait_for(lambda: batch_id in self._completions, timeout=timeout)
            self._expected.discard(batch_id)
            outcome = self._completions.pop(batch_id, None)
            self.last_call_s = self.call_seconds.pop(batch_id, 0.0)
        if outcome is None:
            raise TransientDeviceError(f"pipelined reply for batch {batch_id} never arrived")
        kind, value = outcome
        if kind == "err":
            raise value
        return value

    def inflight(self) -> int:
        with self._cv:
            return len(self._expected)

    def _lane(self) -> None:
        while True:
            with self._cv:
                if not self._submitted:
                    self._lanes -= 1
                    return
                payload = self._submitted.popleft()
            sent_id = payload["batchId"]
            fault = (self.fault_plan.next_reply(self.OP)
                     if self.fault_plan is not None else None)
            t = time.perf_counter()
            try:
                out = self._send(payload)
            except BaseException as exc:  # noqa: BLE001 - routed to its claim
                self._deposit(sent_id, ("err", exc), time.perf_counter() - t)
                continue
            call_s = time.perf_counter() - t
            if fault is not None and fault.kind == "reorder" and fault.rendezvous is not None:
                # this lane receives the other call's reply
                out = fault.rendezvous.swap(out)
            reply_id = out.get("batchId") or sent_id
            self._deposit(reply_id, ("ok", out), call_s)
            if fault is not None and fault.kind == "dup":
                self._deposit(reply_id, ("ok", out), call_s)

    def _deposit(self, batch_id: str, outcome: tuple, call_s: float) -> None:
        with self._cv:
            if batch_id not in self._expected or batch_id in self._completions:
                # nobody waits on it (a duplicate, late or foreign reply)
                self.duplicate_replies += 1
                telemetry.event("pipeline_dup_reply", batchId=batch_id)
                return
            self._completions[batch_id] = outcome
            self.call_seconds[batch_id] = call_s
            self._cv.notify_all()


# ---------------------------------------------------------------- scheduler


class WireScheduler(Scheduler):
    """The control plane driving a device service over the wire
    (``:1433``): the loop's host machinery (queue order, the host gates,
    assume and bind, failure handling and backoff) around remote batches.
    ``endpoint`` is one ``http://host:port`` (``host:port`` over gRPC), a
    comma-separated string of them or a sequence: more than one builds the
    device fabric (``backend/fabric.py``), whose standbys the
    ``standby_replication`` worker keeps warm and whose down replicas are
    re-probed every ``fabric_probe_interval_s``; ``fault_plan`` may then be
    a list, one plan per endpoint. ``transport`` is ``"http"`` or
    ``"grpc"`` (``backend/grpc_service.py``). ``wire_pipeline_depth`` keeps
    that many batches in flight (``KTPU_WIRE_PIPELINE_DEPTH``, 3; 0 is
    synchronous); ``batch_deadline_ms`` feeds the deadline sizer of the
    synchronous pop (``KTPU_BATCH_DEADLINE_MS``, 500; 0 pops ``batch_size``).
    The other arguments are the JAX ones and ``Scheduler``'s."""

    def __init__(self, store, *, endpoint, batch_size: int = 256,
                 transport: str = "http",
                 connect_timeout: float = 5.0, read_timeout: float = 60.0,
                 wire_max_retries: int = 3, wire_backoff_base: float = 0.05,
                 wire_backoff_max: float = 2.0, wire_deadline_s: float = 90.0,
                 breaker_threshold: int = 3, breaker_reset_s: float = 5.0,
                 client_id: Optional[str] = None,
                 heartbeat_interval_s: float = 5.0,
                 fabric_probe_interval_s: float = 5.0,
                 wire_pipeline_depth: Optional[int] = None,
                 batch_deadline_ms: Optional[float] = None,
                 standby_replication: bool = True,
                 fault_plan=None, sleep_fn=None, **kwargs):
        if transport not in ("http", "grpc"):
            raise ValueError(f"unknown transport {transport!r}")
        endpoints = ([e.strip() for e in endpoint.split(",") if e.strip()]
                     if isinstance(endpoint, str) else [str(e) for e in endpoint])
        if not endpoints:
            raise ValueError("WireScheduler needs at least one endpoint")
        plans = (list(fault_plan) if isinstance(fault_plan, (list, tuple))
                 else [fault_plan] * len(endpoints))
        if len(plans) != len(endpoints):
            raise ValueError(f"fault_plan list ({len(plans)}) must match endpoints "
                             f"({len(endpoints)})")
        super().__init__(store, **kwargs)
        sleep_fn = sleep_fn if sleep_fn is not None else time.sleep
        self.retry_policy = RetryPolicy(
            max_retries=wire_max_retries, backoff_base=wire_backoff_base,
            backoff_max=wire_backoff_max, deadline_s=wire_deadline_s,
            sleep_fn=sleep_fn, now_fn=self.now_fn,
            on_retry=lambda op: self.smetrics.wire_retries.inc(op))
        if transport == "grpc":
            from .grpc_service import GrpcClient

            def make_client(ep, plan, retry=None):
                return GrpcClient(ep, read_timeout=read_timeout, retry=retry or self.retry_policy,
                                  fault_plan=plan)
        else:
            def make_client(ep, plan, retry=None):
                return WireClient(ep, connect_timeout=connect_timeout, read_timeout=read_timeout,
                                  retry=retry or self.retry_policy, fault_plan=plan)
        if len(endpoints) > 1:
            from .fabric import DeviceFabric

            # probes of a maybe-dead replica run on the scheduling thread:
            # one attempt each, no backoff sleeps
            probe_retry = RetryPolicy(max_retries=0, backoff_base=wire_backoff_base,
                                      backoff_max=wire_backoff_max, deadline_s=wire_deadline_s,
                                      sleep_fn=sleep_fn, now_fn=self.now_fn)
            self.client = DeviceFabric(
                endpoints, lambda ep, i: make_client(ep, plans[i]),
                probe_client_factory=lambda ep, i: make_client(ep, plans[i], retry=probe_retry),
                metrics=self.smetrics, now_fn=self.now_fn,
                probe_interval_s=fabric_probe_interval_s, replication=standby_replication)
        else:
            self.client = make_client(endpoints[0], plans[0])
        self.batch_size = batch_size
        # N transport failures in a row open the breaker: every pod then
        # takes the sequential path until a half-open probe heals the wire
        self.breaker = CircuitBreaker(failure_threshold=breaker_threshold,
                                      reset_timeout_s=breaker_reset_s, now_fn=self.now_fn,
                                      on_state_change=self._on_breaker_state)
        self.smetrics.backend_circuit_state.set(value=0)
        self._degraded_since: Optional[float] = None
        self.degraded_pods = 0
        self._device_epoch: Optional[str] = None  # the epoch the service last answered
        self.resyncs = 0
        # one idempotency key per logical batch (retries re-send it)
        self._batch_id_prefix = _new_epoch()
        self._batch_ids = itertools.count(1)
        self._sent_gens: Dict[str, int] = {}
        # names ever pushed to the current base: removals are computed from
        # it (an invalidated node's sent gen is popped to force a re-send)
        self._pushed_nodes: set = set()
        self._sent_ns: Dict[str, dict] = {}
        self._sent_quota: Dict[str, dict] = {}
        self._batchable_cache: Dict[str, bool] = {}
        # this replica's identity on a shared service; a ConflictError never
        # counts against the breaker
        self.client_id = client_id or f"ktpu-{_new_epoch()}"
        self.heartbeat_interval_s = heartbeat_interval_s
        self._session_gen: Optional[int] = None
        self._last_heartbeat = self.now_fn()
        self.session_rejoins = 0
        self.ha_takeovers = 0
        self._claim_masks = ClaimMaskBuilder(self.store)
        if wire_pipeline_depth is None:
            if os.environ.get("KTPU_WIRE_PIPELINE", "1") == "0":
                wire_pipeline_depth = 0
            else:
                wire_pipeline_depth = max(0, int(os.environ.get("KTPU_WIRE_PIPELINE_DEPTH",
                                                                "3")))
        self.wire_pipeline_depth = wire_pipeline_depth
        self._wire_inflight: Deque[_WireInflight] = deque()
        self._wire_pipeline: Optional[WirePipeline] = None
        if wire_pipeline_depth:
            # a fabric's reply-side faults are its endpoints' business
            self._wire_pipeline = WirePipeline(
                self.client.schedule_batch, wire_pipeline_depth,
                fault_plan=plans[0] if len(endpoints) == 1 else None)
        self.pipelined_wire_batches = 0
        # bumped by every full resync and rejoin: a reply completed before
        # the bump must not re-adopt its stale epoch and session stamps
        self._wire_sync_era = 0
        if batch_deadline_ms is None:
            batch_deadline_ms = float(os.environ.get("KTPU_BATCH_DEADLINE_MS", "500"))
        self.wire_sizer = BatchSizer(batch_size, batch_deadline_ms / 1000.0)
        self.wire_batches = 0
        # one record per batch whose reply was processed: batchId, pods, and
        # the client's seconds (encode: the payload; push: the delta push
        # before it; call: the scheduleBatch call), with the service's
        # serviceTime and deviceTime echoes
        self.wire_log: Deque[dict] = deque(maxlen=LOG_DEPTH)

    # the loop's bind tail and batchable-profile rule (backend/tpu_scheduler.py)
    _assume = TPUScheduler._assume
    _by_framework = TPUScheduler._by_framework
    _commit_bindings = TPUScheduler._commit_bindings
    _bind_stage = TPUScheduler._bind_stage
    _fail_assumed = TPUScheduler._fail_assumed
    _framework_batchable = TPUScheduler._framework_batchable

    # ------------------------------------------------------- degraded mode

    def _on_breaker_state(self, old: str, new: str) -> None:
        self.smetrics.backend_circuit_state.set(value=STATE_VALUES[new])
        now = self.now_fn()
        if new == "open" and self._degraded_since is None:
            self._degraded_since = now
        elif new == "closed" and self._degraded_since is not None:
            self.smetrics.degraded_seconds.inc(value=now - self._degraded_since)
            self._degraded_since = None

    def _accrue_degraded(self) -> None:
        """Fold the open breaker's elapsed time into the counter."""
        if self._degraded_since is not None:
            now = self.now_fn()
            self.smetrics.degraded_seconds.inc(value=now - self._degraded_since)
            self._degraded_since = now

    def _wire_supported(self, pod: Pod) -> bool:
        """Whether the pod rides the wire (``:1627``): no volumes, claims
        that resolve (their rows ride the request), and a profile the batch
        program implements."""
        if pod.spec.volumes:
            return False
        if pod.spec.resource_claims and not (getattr(self.client, "supports_dra", False)
                                             and self._claim_masks.batchable(pod)):
            return False
        fwk = self.framework_for_pod(pod)
        cached = self._batchable_cache.get(fwk.profile_name)
        if cached is None:
            cached = self._framework_batchable(fwk)
            self._batchable_cache[fwk.profile_name] = cached
        return cached

    def _build_entries(self, skip_unsent_check: bool = False):
        """(entries, pending_gens) over the snapshot: the one wire shape of
        a node delta, shared by the push and the full resync."""
        entries: List[dict] = []
        pending_gens: Dict[str, int] = {}
        for name, ni in self.snapshot.node_info_map.items():
            if ni.node is None:
                continue
            if not skip_unsent_check and self._sent_gens.get(name) == ni.generation:
                continue
            entries.append({"gen": ni.generation, "node": to_wire(ni.node),
                            "pods": [to_wire(p) for p in ni.pods]})
            pending_gens[name] = ni.generation
        return entries, pending_gens

    def _push_deltas(self) -> None:
        """The incremental sync (``:1674``). Its bookkeeping commits only
        after the call succeeds, so a failed push leaves the rows unsent."""
        self.cache.update_snapshot(self.snapshot)
        current = self.snapshot.node_info_map
        removed = [n for n in self._pushed_nodes if n not in current]
        entries, pending_gens = self._build_entries()
        namespaces = {}
        for ns, obj in self.store.namespaces.items():
            labels = dict(obj.meta.labels)
            if self._sent_ns.get(ns) != labels:
                namespaces[ns] = labels
        quota_table = self._wire_quota_table()
        if not (entries or removed or namespaces) and quota_table is None:
            return
        payload = {"apiVersion": API_VERSION, "nodes": entries, "removed": removed,
                   "namespaces": namespaces}
        if quota_table is not None:
            payload["quotaTable"] = quota_table
        self._stamp_session(payload)
        self._stamp_inflight(payload)
        if self._device_epoch:
            payload["expectEpoch"] = self._device_epoch
        else:
            # a fresh client: the first contact is a full sync, which sweeps
            # a predecessor's ghost nodes
            payload["full"] = True
        tp = tracing.format_traceparent()
        if tp:
            payload["traceparent"] = tp
        try:
            out = self.client.apply_deltas(payload)
        except StaleEpochError as exc:
            self._full_resync(exc.epoch)
            return
        self._device_epoch = out.get("epoch", self._device_epoch)
        self._session_gen = out.get("sessionGen", self._session_gen)
        self._sent_gens.update(pending_gens)
        self._pushed_nodes.update(pending_gens)
        for n in removed:
            self._sent_gens.pop(n, None)
            self._pushed_nodes.discard(n)
        for ns, labels in namespaces.items():
            self._sent_ns[ns] = labels
        if quota_table is not None:
            self._sent_quota = quota_table

    def _wire_quota_table(self) -> Optional[Dict[str, dict]]:
        """The whole quota ledger export when it changed since the last
        acknowledged push, else None (``:1728``)."""
        plugin = self._quota_plugin()
        if plugin is None:
            return None
        table = {ns: {"used": [int(x) for x in used], "limit": [int(x) for x in limit]}
                 for ns, (used, limit) in plugin.device_quota_table().items()}
        if table == self._sent_quota:
            return None
        return table

    def _full_resync(self, new_epoch: Optional[str] = None) -> None:
        """The epoch-mismatch recovery (``:1744``): forget what the service
        holds, rejoin fresh, and ship the whole host truth as one ``full``
        push."""
        self.resyncs += 1
        self._wire_sync_era += 1
        self._sent_gens.clear()
        self._pushed_nodes.clear()
        self._sent_ns.clear()
        self._sent_quota = {}
        self._device_epoch = new_epoch
        self._session_gen = None
        self.cache.update_snapshot(self.snapshot)
        entries, pending_gens = self._build_entries(skip_unsent_check=True)
        namespaces = {ns: dict(obj.meta.labels) for ns, obj in self.store.namespaces.items()}
        payload = {"apiVersion": API_VERSION, "full": True, "nodes": entries, "removed": [],
                   "namespaces": namespaces}
        quota_table = self._wire_quota_table()
        if quota_table is not None:
            payload["quotaTable"] = quota_table
        self._stamp_session(payload)
        self._stamp_inflight(payload)
        tp = tracing.format_traceparent()
        if tp:
            payload["traceparent"] = tp
        out = self.client.apply_deltas(payload)
        self._device_epoch = out.get("epoch", new_epoch)
        self._session_gen = out.get("sessionGen", self._session_gen)
        self._sent_gens.update(pending_gens)
        self._pushed_nodes.update(pending_gens)
        self._sent_ns.update(namespaces)
        if quota_table is not None:
            self._sent_quota = quota_table

    # ------------------------------------------------------------ HA session

    def _stamp_session(self, payload: dict) -> None:
        payload["clientId"] = self.client_id
        if self._session_gen is not None:
            payload["sessionGen"] = self._session_gen
        else:
            payload.pop("sessionGen", None)

    def _stamp_inflight(self, payload: dict) -> None:
        """Name the batches whose replies are unprocessed: their holds must
        survive this push."""
        if self._wire_inflight:
            payload["inflightBatchIds"] = [e.batch_id for e in self._wire_inflight]

    def _session_rejoin(self) -> None:
        """Fenced or superseded: forget the session and what the service
        holds for us; the next push rejoins with a full resync."""
        self.session_rejoins += 1
        self._wire_sync_era += 1
        self._session_gen = None
        self._device_epoch = None
        self._sent_gens.clear()
        self._pushed_nodes.clear()
        self._sent_ns.clear()

    def _periodic_housekeeping(self, now: Optional[float] = None) -> None:
        super()._periodic_housekeeping(now)
        if self.breaker.state == OPEN:
            return  # the breaker's probe owns re-discovery
        now = self.now_fn()
        if self.heartbeat_interval_s and now - self._last_heartbeat >= self.heartbeat_interval_s:
            self._last_heartbeat = now
            self._heartbeat()

    def _heartbeat(self) -> None:
        payload = {"apiVersion": API_VERSION}
        self._stamp_session(payload)
        try:
            out = self.client.heartbeat(payload)
        except ConflictError:
            self._session_rejoin()
            return
        except DeviceServiceError:
            return  # the breaker path owns the wire's story
        self._session_gen = out.get("sessionGen", self._session_gen)
        self.smetrics.client_sessions.set(value=out.get("sessions", 1))
        for cid in out.get("fenced", ()):
            self.ha_takeovers += 1
            self.smetrics.ha_takeovers.inc()
            telemetry.event("takeover", client=self.client_id, fencedPeer=cid)
            self._adopt_after_takeover(cid)

    def _adopt_after_takeover(self, dead_client: str) -> None:
        """A peer was fenced (its capacity released server-side): its
        unbound pods this replica is responsible for re-enter the queue,
        and the parked pods get the capacity's wake-up."""
        pending = {qp.pod.key() for qp in self.queue.pending_pod_infos()}
        for pod in list(self.store.pods.values()):
            if pod.spec.node_name or not self._responsible_for(pod):
                continue
            key = pod.key()
            if key in pending or key in self.waiting_pods:
                continue
            self.queue.add(pod)
        self.queue.move_all_to_active_or_backoff_queue(qevents.SCHEDULER_TAKEOVER)

    # ------------------------------------------------------------ the cycle

    def schedule_batch_cycle(self) -> int:
        """One cycle (``:1869``): pop (the deadline sizer's target when
        synchronous, ``batch_size`` when pipelined), the host gates, the
        wire batch, and in pop order the sequential path for the pods that
        do not ride it."""
        if self.informer_factory is not None:
            self.informer_factory.pump()  # the binary's topology, as TPUScheduler
        self._periodic_housekeeping()
        target = (self.batch_size if self._wire_pipeline is not None
                  else min(self.batch_size, self.wire_sizer.target()))
        qps = self.queue.pop_batch(target)
        if not qps:
            self._drain_wire_inflight()
            return 0
        t0 = self.now_fn()
        pod_cycle = self.queue.scheduling_cycle
        buffer: List[QueuedPodInfo] = []
        for qp in qps:
            pod = self.store.get_pod(qp.pod.key())
            if pod is None or pod.spec.node_name or not self._responsible_for(pod):
                latency_ledger.close_skipped(qp.pod.key(), pod)
                continue
            qp.pod = pod
            fwk = self.framework_for_pod(pod)
            gated = False
            for plugin, gate in fwk.gate_plugins:
                if gate.pre_filter(None, pod)[1] is not None:
                    self.metrics.inc("schedule_attempts")
                    self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name,
                                                  self.now_fn() - t0)
                    self._handle_scheduling_failure(
                        qp, True, Diagnosis(unschedulable_plugins={plugin}), pod_cycle)
                    gated = True
                    break
            if gated:
                continue
            if self._wire_supported(pod):
                buffer.append(qp)
                continue
            # strict pop order: the batch before the pod and everything in
            # flight land first
            self._flush_wire(buffer, pod_cycle, t0)
            buffer = []
            self._drain_wire_inflight()
            self.cache.update_snapshot(self.snapshot)
            self.schedule_one_pod(qp, pod_cycle)
        self._flush_wire(buffer, pod_cycle, t0)
        return len(qps)

    def _flush_wire(self, batch: List[QueuedPodInfo], pod_cycle: int, t0: float) -> None:
        if not batch:
            return
        with tracing.span("scheduling.cycle", batch=len(batch),
                          transport=type(self.client).__name__):
            self._flush_wire_traced(batch, pod_cycle, t0)

    def _flush_wire_traced(self, batch: List[QueuedPodInfo], pod_cycle: int, t0: float) -> None:
        if not self.breaker.allow():
            # open: land what is in flight, then the sequential path
            self._drain_wire_inflight()
            self._accrue_degraded()
            self._schedule_degraded(batch, pod_cycle)
            return
        if self.breaker.state == HALF_OPEN:
            # the half-open probe is the cheap health call
            try:
                self.client.health()
            except DeviceServiceError as exc:
                self.breaker.record_failure(exc)
                self._accrue_degraded()
                self._schedule_degraded(batch, pod_cycle)
                return
        try:
            t_push = time.perf_counter()
            self._push_deltas()
            t_enc = time.perf_counter()
            payload = self._build_batch_payload(batch)
            encode_s = time.perf_counter() - t_enc
            push_s = t_enc - t_push
            self.wire_batches += 1
            if self._wire_pipeline is not None:
                entry = _WireInflight(batch, payload, pod_cycle, t0, self.now_fn(),
                                      self._wire_sync_era, encode_s, push_s)
                self._wire_inflight.append(entry)
                if len(self._wire_inflight) > 1:
                    self.pipelined_wire_batches += 1
                self.smetrics.wire_inflight.set(value=len(self._wire_inflight))
                latency_ledger.transition_many([qp.pod.key() for qp in batch],
                                               "device.inflight", batch_id=entry.batch_id)
                self._wire_pipeline.submit(payload)
                while len(self._wire_inflight) > self.wire_pipeline_depth:
                    self._drain_oldest_wire()
                return
            latency_ledger.transition_many([qp.pod.key() for qp in batch], "device.inflight",
                                           batch_id=payload["batchId"])
            t_send = self.now_fn()
            t_call = time.perf_counter()
            res = self._send_batch_payload(payload)
            call_s = time.perf_counter() - t_call
        except ConflictError as exc:
            self._wire_conflict(batch, exc, pod_cycle, t0)
            return
        except DeviceServiceError as exc:
            self._wire_transport_failure(batch, exc, pod_cycle, t0)
            return
        self.breaker.record_success()
        self._note_device_time(res, len(batch), payload["batchId"], self.now_fn() - t_send)
        self._log_batch(res, len(batch), payload["batchId"], encode_s, push_s, call_s)
        self._process_wire_results(batch, res, pod_cycle, t0)
        bucket = self.wire_sizer.bucket_for(len(batch))
        self.wire_sizer.update(bucket, self.now_fn() - t0)

    def _log_batch(self, res: dict, pods: int, batch_id: str, encode_s: float, push_s: float,
                   call_s: float) -> None:
        self.wire_log.append({"batchId": batch_id, "pods": pods, "encode": encode_s,
                              "push": push_s, "call": call_s,
                              "serviceTime": res.get("serviceTime"),
                              "deviceTime": res.get("deviceTime")})

    def _wire_conflict(self, batch: List[QueuedPodInfo], exc: Exception, pod_cycle: int,
                       t0: float) -> None:
        """A conflict verdict: rejoin and requeue through backoff, never a
        breaker count."""
        self.smetrics.commit_conflicts.inc(self.client_id)
        telemetry.event("conflict", client=self.client_id, pods=len(batch),
                        reason=str(exc)[:200])
        self._session_rejoin()
        self._requeue_wire_failure(batch, exc, pod_cycle, t0)

    def _wire_transport_failure(self, batch: List[QueuedPodInfo], exc: Exception,
                                pod_cycle: int, t0: float,
                                batch_id: Optional[str] = None) -> None:
        """A transport failure (``TransientDeviceError``: the connection
        lost or timed out, a 502-504): counted against the breaker, then the
        batch degrades (breaker open) or requeues through backoff. Any other
        failure (``PermanentDeviceError``: a 500 from the batch program, the
        kernel or the screen on the card) requeues the batch and is raised
        out of the cycle, as the loop raises a device error that is not
        transient (``TPUScheduler``'s relay), so that no breaker sends the
        pods to the sequential path on the host in its place; the JAX
        client counts it against the breaker too. A fabric's
        ``FailoverError`` is a transport failure only when the replica it
        left was lost to one: after a permanent error the fabric has already
        promoted a standby (``reason="permanent"``), and the cause is raised
        as a bare ``PermanentDeviceError`` is, so that replicas failing in
        turn never open the breaker."""
        cause = exc.__cause__ if isinstance(exc, FailoverError) else None
        if isinstance(cause, DeviceServiceError) and not isinstance(cause, TransientDeviceError):
            self._requeue_wire_failure(batch, exc, pod_cycle, t0, batch_id=batch_id)
            raise cause
        if not isinstance(exc, TransientDeviceError):
            self._requeue_wire_failure(batch, exc, pod_cycle, t0, batch_id=batch_id)
            raise exc
        self.breaker.record_failure(exc)
        if self.breaker.state == OPEN:
            self._accrue_degraded()
            self._schedule_degraded(batch, pod_cycle)
        else:
            self._requeue_wire_failure(batch, exc, pod_cycle, t0, batch_id=batch_id)

    # ------------------------------------------------------ pipelined drain

    def _drain_wire_inflight(self) -> int:
        """Land every batch in flight, oldest first."""
        n = 0
        while self._wire_inflight:
            n += self._drain_oldest_wire()
        return n

    def _drain_oldest_wire(self) -> int:
        """Claim and process the oldest batch's reply (``:2075``), with the
        synchronous path's recovery: resync and re-send on a stale epoch,
        rejoin on a conflict, breaker and requeue on a transport failure,
        requeue and raise on any other failure."""
        entry = self._wire_inflight.popleft()
        self.smetrics.wire_inflight.set(value=len(self._wire_inflight))
        batch, pod_cycle, t0 = entry.qps, entry.pod_cycle, entry.t0
        t_wait0 = self.now_fn()
        try:
            try:
                res = self._wire_pipeline.claim(entry.batch_id)
                if entry.era == self._wire_sync_era:
                    ep = res.get("epoch")
                    if ep:
                        self._device_epoch = ep
                        self._session_gen = res.get("sessionGen", self._session_gen)
            except StaleEpochError as exc:
                # K batches bounce off one restart: one resync serves them all
                if not (exc.epoch and exc.epoch == self._device_epoch):
                    self._full_resync(exc.epoch)
                self._restamp_batch_payload(entry.payload)
                res = self._send_batch_payload(entry.payload)
        except ConflictError as exc:
            self._wire_conflict(batch, exc, pod_cycle, t0)
            return len(batch)
        except DeviceServiceError as exc:
            telemetry.event("pipeline_poison", batchId=entry.batch_id, pods=len(batch),
                            error=f"{type(exc).__name__}: {exc}"[:200])
            self._wire_transport_failure(batch, exc, pod_cycle, t0, batch_id=entry.batch_id)
            return len(batch)
        wait = self.now_fn() - t_wait0
        self.breaker.record_success()
        self._note_device_time(res, len(batch), entry.batch_id, self.now_fn() - entry.t_sent)
        self._log_batch(res, len(batch), entry.batch_id, entry.encode_s, entry.push_s,
                        self._wire_pipeline.last_call_s)
        self._process_wire_results(batch, res, pod_cycle, t0)
        bucket = self.wire_sizer.bucket_for(len(batch))
        self.wire_sizer.update(bucket, self.now_fn() - entry.t_sent)
        self.wire_sizer.update_wait(bucket, wait)
        return len(batch)

    def _note_device_time(self, res: dict, pods: int, batch_id: str, rtt_s: float) -> None:
        """The echoed device time against this client's round trip: the
        rest is transport (``:2146``). One global read when telemetry is
        off."""
        rec = telemetry.get()
        if rec is None:
            return
        dt = res.get("deviceTime")
        if not isinstance(dt, dict):
            return
        try:
            exec_s = float(dt.get("execMs") or 0.0) / 1e3
            fetch_s = float(dt.get("fetchMs") or 0.0) / 1e3
            device_s = float(dt.get("deviceMs") or 0.0) / 1e3
        except (TypeError, ValueError):
            return
        transport_s = max(0.0, rtt_s - device_s)
        rec.dispatch_ledger.record_phases(
            "wire_schedule_batch", str(self.wire_sizer.bucket_for(pods)),
            dwell_s=transport_s, exec_s=exec_s, fetch_s=fetch_s,
            wait_s=max(rtt_s, device_s), batch_id=batch_id, pods=pods)
        telemetry.event("wire_device_time", batchId=batch_id,
                        device_ms=round(device_s * 1e3, 3),
                        transport_ms=round(transport_s * 1e3, 3))

    def _build_batch_payload(self, batch: List[QueuedPodInfo]) -> dict:
        """The scheduleBatch request of one logical batch with a fresh
        idempotent batchId (``:2175``)."""
        payload = {"apiVersion": API_VERSION,
                   "pods": [to_wire(qp.pod) for qp in batch],
                   "tieSeeds": [int(s) for s in seeds_for(batch)],
                   "batchId": f"{self._batch_id_prefix}-{next(self._batch_ids)}"}
        self._stamp_session(payload)
        claims = wire_claims_for_batch(self.store, [qp.pod for qp in batch])
        if claims:
            payload["claims"] = claims
        tp = tracing.format_traceparent()
        if tp:
            payload["traceparent"] = tp
        if self._device_epoch:
            payload["expectEpoch"] = self._device_epoch
        return payload

    def _send_batch_payload(self, payload: dict) -> dict:
        """Send one payload with the bounded stale-epoch recovery (two
        resyncs, then the error reaches the breaker); on the scheduling
        thread only."""
        stale_retries = 0
        while True:
            try:
                res = self.client.schedule_batch(payload)
                break
            except StaleEpochError as exc:
                stale_retries += 1
                if stale_retries > 2:
                    raise
                self._full_resync(exc.epoch)
                self._restamp_batch_payload(payload)
        self._device_epoch = res.get("epoch", self._device_epoch)
        self._session_gen = res.get("sessionGen", self._session_gen)
        return res

    def _restamp_batch_payload(self, payload: dict) -> None:
        """The epoch and session stamps after a resync or rejoin (the
        batchId stays)."""
        if self._device_epoch:
            payload["expectEpoch"] = self._device_epoch
        else:
            payload.pop("expectEpoch", None)
        self._stamp_session(payload)

    def _schedule_degraded(self, batch: List[QueuedPodInfo], pod_cycle: int) -> None:
        """The breaker is open: the batch takes the sequential path
        (``:2229``)."""
        telemetry.event("degrade", client=self.client_id, pods=len(batch),
                        reason="wire breaker open")
        self.degraded_pods += len(batch)
        self.cache.update_snapshot(self.snapshot)
        for qp in batch:
            self.schedule_one_pod(qp, pod_cycle)

    def _requeue_wire_failure(self, batch: List[QueuedPodInfo], exc: Exception,
                              pod_cycle: int, t0: float,
                              batch_id: Optional[str] = None) -> None:
        telemetry.event("requeue", client=self.client_id, pods=len(batch), batchId=batch_id,
                        error=f"{type(exc).__name__}: {exc}"[:200])
        for qp in batch:
            fwk = self.framework_for_pod(qp.pod)
            self.metrics.inc("schedule_attempts")
            self.metrics.inc("errors")
            self.smetrics.observe_attempt(ERROR, fwk.profile_name, self.now_fn() - t0)
            self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)

    def _invalidate_device_row(self, node_name: str) -> None:
        """Force the node's row back through the delta channel (JAX's
        ``_invalidate_node``, ``:2253``): the service adopted a placement
        the host rejects, and nothing moved the node's generation. The
        bind tail calls it for a refused winner."""
        with self.cache._lock:
            ni = self.cache.nodes.get(node_name)
            if ni is not None:
                ni.generation = next_generation()
                self.cache._dirty.add(node_name)
        self._sent_gens.pop(node_name, None)

    def _process_wire_results(self, batch: List[QueuedPodInfo], res: dict, pod_cycle: int,
                              t0: float) -> None:
        with self.queue.coalesce_moves():
            self._process_wire_results_coalesced(batch, res, pod_cycle, t0)

    def _process_wire_results_coalesced(self, batch: List[QueuedPodInfo], res: dict,
                                        pod_cycle: int, t0: float) -> None:
        """The reply's commit (``:2281``): the quota screen's flags, the
        flat and slice gangs' whole verdicts, then in batch order the
        conflicts, rejected gang members, flagged winners, ghost
        placements, the winners (a claim pod's PreFilters first; a failure
        surrenders the row and takes the sequential path) and the failures
        (PostFilter with the preemption hint over this client's node
        names); then the winners through the loop's bind tail."""
        from ..framework.plugins import names
        from ..framework.plugins.coscheduling import pod_group_key
        from ..ops.slice import is_slice_pod

        latency_ledger.transition_many([qp.pod.key() for qp in batch], "commit.host")
        results = res["results"]
        items: List[BindItem] = []
        hint_slot_of = None
        gang_rejected: Dict[int, str] = {}
        groups: Dict[str, List[int]] = {}
        slice_groups: Dict[str, List[int]] = {}
        quota_rejected: set = set()
        for i, r in enumerate(results):
            w = int(r.get("quota") or 0)
            if r.get("nodeName") and (w & QUOTA_SCREEN_BIT) and not (w & QUOTA_OK_BIT):
                quota_rejected.add(i)
        for i, qp in enumerate(batch):
            gkey = pod_group_key(qp.pod)
            if gkey is not None:
                (slice_groups if is_slice_pod(qp.pod) else groups).setdefault(gkey, []).append(i)
        for gkey, idxs in groups.items():
            # a member unplaced or quota-flagged: the whole gang surrenders
            if any(not results[i].get("nodeName") or i in quota_rejected for i in idxs):
                for i in idxs:
                    gang_rejected[i] = gkey
                cos = self.framework_for_pod(batch[idxs[0]].pod).plugin(names.COSCHEDULING)
                if cos is not None:
                    cos.reject_gang(gkey, "incomplete")
        for gkey, idxs in slice_groups.items():
            now = self.now_fn()
            if all(results[i].get("nodeName") and i not in quota_rejected for i in idxs):
                telemetry.event("slice_assign", client=self.client_id, gang=gkey,
                                members=len(idxs))
                self.smetrics.slice_wait_duration.observe(now - t0, "scheduled")
                continue
            plan_ok = all(results[i].get("slice", SLICE_PLAN_OK_BIT) & SLICE_PLAN_OK_BIT
                          for i in idxs)
            reason = "incomplete" if plan_ok else "infeasible"
            telemetry.event("slice_reject", client=self.client_id, gang=gkey,
                            members=len(idxs), reason=reason)
            self.smetrics.slice_wait_duration.observe(now - t0, "rejected")
            for i in idxs:
                gang_rejected[i] = gkey
            fwk = self.framework_for_pod(batch[idxs[0]].pod)
            cos = fwk.plugin(names.COSCHEDULING)
            if cos is not None:
                cos.reject_gang(gkey, reason)
            packing = fwk.plugin(names.SLICE_PACKING)
            if packing is not None:
                packing.forget_gang(gkey)
        for i, (qp, r) in enumerate(zip(batch, results)):
            fwk = self.framework_for_pod(qp.pod)
            self.metrics.inc("schedule_attempts")
            node_name = r.get("nodeName")
            if r.get("conflict") and i not in gang_rejected:
                # another replica owns the pod or won the capacity
                self.smetrics.commit_conflicts.inc(self.client_id)
                telemetry.event("conflict", client=self.client_id, pod=qp.pod.key(),
                                reason=(r.get("error") or "raced")[:200])
                self.metrics.inc("errors")
                self.smetrics.observe_attempt(ERROR, fwk.profile_name, self.now_fn() - t0)
                self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                continue
            if i in gang_rejected:
                if node_name:
                    self._invalidate_device_row(node_name)
                d = Diagnosis(unschedulable_plugins={names.COSCHEDULING})
                d.unschedulable_plugins.update(r.get("unschedulablePlugins") or ())
                self._handle_scheduling_failure(qp, True, d, pod_cycle)
                self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name,
                                              self.now_fn() - t0)
                continue
            if i in quota_rejected:
                if node_name:
                    self._invalidate_device_row(node_name)
                self._handle_scheduling_failure(
                    qp, True, Diagnosis(unschedulable_plugins={names.QUOTA_ADMISSION}),
                    pod_cycle)
                self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name,
                                              self.now_fn() - t0)
                continue
            if node_name:
                known = self.snapshot.node_info_map.get(node_name)
                if known is None or known.node is None:
                    # a node this client no longer knows
                    self.metrics.inc("errors")
                    self.smetrics.observe_attempt(ERROR, fwk.profile_name, self.now_fn() - t0)
                    self._handle_scheduling_failure(qp, False, Diagnosis(), pod_cycle)
                    continue
                state = None
                if qp.pod.spec.resource_claims or qp.pod.spec.volumes:
                    # Reserve allocates from the PreFilter state, which also
                    # finds a claim deleted since the batch left
                    state, _names, fail = fwk.filters.pre_filter_status(qp.pod)
                    if fail is not None:
                        self._invalidate_device_row(node_name)
                        self.cache.update_snapshot(self.snapshot)
                        self.schedule_one_pod(qp, pod_cycle)
                        continue
                items.append(BindItem(qp, node_name, fwk, state=state,
                                      sampled=sampled_attempt(self.metrics["schedule_attempts"])))
                continue
            d = Diagnosis()
            for name, plugin in (r.get("statuses") or {}).items():
                d.node_to_status[name] = _REASON_OF.get(plugin, "unschedulable")
            d.unschedulable_plugins.update(r.get("unschedulablePlugins") or ())
            hints = None
            hint = r.get("preempt")
            if hint is not None:
                # the screen over this client's node names: listed
                # candidates pass, every other known node fails, a node
                # unknown to the row stays permissive; no list (truncated)
                # passes everything and keeps the ranked best
                if hint_slot_of is None:
                    hint_slot_of = {n: j for j, n in enumerate(self._sent_gens)}
                if hint.get("candidates") is None:
                    row = np.ones(len(hint_slot_of), bool)
                else:
                    row = np.zeros(len(hint_slot_of), bool)
                    for n in hint["candidates"]:
                        if n in hint_slot_of:
                            row[hint_slot_of[n]] = True
                hints = (row, hint_slot_of, hint.get("best"))
            self._handle_scheduling_failure(
                qp, True, d, pod_cycle, hints,
                sampled=sampled_attempt(self.metrics["schedule_attempts"]))
            self.smetrics.observe_attempt(UNSCHEDULABLE, fwk.profile_name, self.now_fn() - t0)
        if items:
            live = [item for item in items if self._assume(item, pod_cycle)]
            if live:
                self._commit_bindings(live, pod_cycle, t0)

    def close(self) -> None:
        """Land every batch in flight, then release the client (a fabric's
        replication worker, a gRPC channel)."""
        self._drain_wire_inflight()
        close = getattr(self.client, "close", None)
        if close is not None:
            close()

    def debug_sessions(self) -> dict:
        """The /debug/sessions body: this replica's session and the
        service's whole session table over the wire."""
        out = {"enabled": True, "clientId": self.client_id, "sessionGen": self._session_gen,
               "sessionRejoins": self.session_rejoins, "haTakeovers": self.ha_takeovers,
               "heartbeatIntervalS": self.heartbeat_interval_s}
        try:
            out["service"] = self.client.sessions_dump()
        except DeviceServiceError as exc:
            out["service"] = {"error": f"{type(exc).__name__}: {exc}"}
        return out

    def debug_fabric(self) -> dict:
        """The /debug/fabric body (``:2516``): the fabric's ``dump()``, or
        ``enabled: False`` and the one endpoint."""
        dump = getattr(self.client, "dump", None)
        if dump is None:
            return {"enabled": False, "endpoint": self.client.endpoint}
        return dump()

    def debug_circuit(self) -> dict:
        """The /debug/circuit body: the breaker, the resync and degradation
        story, the pipelined transport's occupancy."""
        out = self.breaker.dump()
        out.update({
            "enabled": True, "deviceEpoch": self._device_epoch, "resyncs": self.resyncs,
            "degradedPods": self.degraded_pods, "wirePipelineDepth": self.wire_pipeline_depth,
            "wireInflight": len(self._wire_inflight),
            "pipelinedBatches": self.pipelined_wire_batches,
            "duplicateReplies": (self._wire_pipeline.duplicate_replies
                                 if self._wire_pipeline is not None else 0),
            "retryPolicy": {"maxRetries": self.retry_policy.max_retries,
                            "backoffBase": self.retry_policy.backoff_base,
                            "backoffMax": self.retry_policy.backoff_max,
                            "deadlineS": self.retry_policy.deadline_s},
        })
        return out
