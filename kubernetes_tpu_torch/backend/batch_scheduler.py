"""The batched scheduler on the main path: sync → encode → one device call →
one device-to-host read → bind.

The device half of ``kubernetes_tpu/backend/tpu_scheduler.py``'s
``schedule_batch_cycle`` and ``_commit_inflight`` as a library: the caller
hands it pods, without a queue or a store of nodes and pods. The device
step comes in halves: ``encode_device_batch`` and ``dispatch_device_batch``
(the batch program dispatched, its carry adopted, the packed block's copy
to the host started), then ``materialize_device_batch`` (the one blocking
read, the mirror advanced). ``BatchScheduler`` runs them back to back; the
scheduler loop (``backend/tpu_scheduler.py``) keeps dispatched batches in
its in-flight ring between the two. ``BatchScheduler`` keeps
the given NodeInfos as its cache (it binds placed pods into them) and a
``DeviceState`` mirror of them; each
``schedule`` call places pods in batches of ``caps.pods`` in the given
order. Pods with topology spread constraints or inter-pod (anti-)affinity
run in one of two topology modes (``_topo_mode_info``), the rest in mode
``off``. Each batch takes one commit path (``batch.spec_decode_eligible``):
the fused kernel (mode ``off``) or the topology scan, or the speculative
rounds.

DRA claims and bound PVCs need the object store (``client``,
``apiserver/store.py``). The encode stage builds the host volume screen
(``ops/volume_mask.py``) and the device claim mask (``backend/
claim_mask.py``) for the batch, and both join the static phase. At bind, in
batch order, a volume pod re-runs the exact volume filters on its chosen
node and a claim pod resolves its claims again and allocates them there
(Reserve). A pod that fails is not bound and ``schedule`` returns None for
it: a Reserve conflict (a claim that an earlier pod of the batch allocated
to another node) lands in ``retry`` (resubmitted, the pod is pinned to the
allocated node), a failed volume check or a vanished claim in ``fallback``
(the scheduler loop, ``backend/tpu_scheduler.py``, hands such a pod to its
sequential path, as the JAX package does; this class has none). Only what
this path implements is accepted: a claim or volume pod without a store, a
missing claim, class or PVC, an unbound or delayed-binding PVC and
ephemeral volumes raise NotImplementedError (the loop takes them all)
rather than being placed by a path that would ignore them.

Gangs (pods with the ``scheduling.x-k8s.io/pod-group`` label) follow
``tpu_scheduler.py``: before encode, Coscheduling's PreFilter
(``framework/plugins/coscheduling.py``) drops a member whose group is in
rejection backoff, missing from the store or short of ``min_member``
members; it takes no batch row and lands in ``gang_rejected`` (pod key ->
reason). A slice gang (its pods also carry ``ktpu.dev/slice``) goes into
the batch program as a member index, and the program's slice plan pins its
members to one contiguous torus window (``ops/slice.py``). After the one
read, slice gangs are judged from the packed block's slice words and
``node_idx``; flat gangs through one ``gang_verdicts`` device call and one
read of its verdicts. A gang with a member the batch did not place is
rejected whole: every member returns None with the reason "incomplete" (a
cover or window existed at decision time) or "infeasible", ``reject_gang``
arms its backoff, and each member the device placed is surrendered through
``DeviceState.invalidate_row`` (the next sync repairs the row from the
snapshot). A gang that places gets its bound count and phase (PostBind).
``BatchScheduler`` has no Permit and no clock to time one out, so it
raises NotImplementedError for a gang that straddles a batch boundary
within one ``schedule`` call (the scheduler loop, ``backend/
tpu_scheduler.py``, parks the earlier members at Permit), for gang pods
with claims or volumes (their Unreserve needs the loop's bind tail) and
for gang pods without an object store. The verdicts (``judge_gangs``) and the program's slice and quota
arguments (``slice_batch_kw``, ``quota_batch_kw``) are shared with the
loop.

Namespace quota (SchedulingQuota objects in the store) follows
``tpu_scheduler.py``: before encode, QuotaAdmission's PreFilter
(``framework/plugins/quota.py``) is the host gate; an over-quota pod takes
no batch row, returns None and lands in ``quota_rejected`` (pod key ->
reason). The ledger's rows are synced into ``DeviceState`` and the batch
program screens its winners against them in batch order (``ops/
quota.py``); the words ride the packed block. A screened winner without
the ok bit surrenders its row (``invalidate_row``) and lands in
``quota_rejected``; a gang with such a member is rejected whole
("incomplete"). At bind, Reserve charges each winner in batch order, the
authoritative check: a refused pod (two namespaces of one cohort both
borrowing the same headroom in one batch) lands in ``retry`` and its row is
surrendered; a refused gang member turns its whole gang away into
``retry``: the documented difference from the scheduler loop, which, as
the JAX one, fails the member and parks its siblings at Permit until the
PodGroup's timeout (ROADMAP C12). A pod
whose claims then fail Reserve keeps its charge until the batch's reserves
are done, as the JAX commit plane unreserves after them. ``delete_pod``
takes a bound pod off its node and releases its charge.

Preemption follows the JAX package's batched failure path
(``tpu_scheduler.py:1320-1414``, ``scheduler.py:880-903``) in every
topology mode: after the batch's carry is adopted, one device screen
(``ops/preempt.py``) runs over every pod the batch could not place, on the
batch's static masks, and one read brings its screen rows and top-ranked
nodes back; when no failed pod outranks any bound pod, an all-False screen
is made on the host instead. Each failed pod, in batch order, then runs
DefaultPreemption's PostFilter (``framework/plugins/defaultpreemption.py``)
against the cluster as it stood before the batch's binds, with its row as
hints: the dry run's filter chain (``framework/runtime.py``) holds the
topology, claim, quota and gang PreFilters and Filters. A member of a
gang the batch rejected takes the JAX ``_fail`` path: one the device left
unplaced runs its PostFilter without hints (Coscheduling's PreFilter fails
it while the rejection's backoff lasts); one the device placed has only
Coscheduling in its diagnosis and preempts nothing. A quota-rejected pod
never preempts. A pod the PostFilter nominates lands in ``nominated`` (pod
key -> node, ``status.nominated_node_name`` set): the caller resubmits it,
and the nominated bonus steers it to that node. Its victims land in
``preempted`` (victim key -> preemptor key), release their quota at once,
and leave the cluster after the batch's binds; the next ``sync`` uploads
their nodes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..api.types import Pod
from ..apiserver.store import Conflict
from ..cache.snapshot import Snapshot
from ..framework.plugins import dynamicresources, names, volume
from ..framework.plugins.coscheduling import Coscheduling, pod_group_key
from ..framework.plugins.interpodaffinity import HOSTNAME_KEY, NsLabelsFn
from ..framework.plugins.quota import ERR_REASON_QUOTA_EXCEEDED, QuotaAdmission
from ..framework.registry import in_tree_registry
from ..framework.runtime import Framework, PodNominator
from ..framework.types import NodeInfo
from ..ops.preempt import screen_prefix
from ..ops.quota import QUOTA_OK_BIT, QUOTA_SCREEN_BIT, build_quota_batch_args
from ..ops.schema import Capacities, ExprTable, PodBatch, TopoBatch
from ..ops.slice import is_slice_pod
from ..ops.volume_mask import VolumeMaskBuilder
from ..utils.device import DeviceLike
from .batch import (DEFAULT_WEIGHTS, SLICE_PLAN_OK_BIT, BatchResult, gang_member_index,
                    gang_verdicts, pack_result_block, schedule_batch, spec_decode_eligible,
                    unpack_result_block)
from . import telemetry
from .claim_mask import ClaimMaskBuilder
from .commit_plane import materialize_result
from .device_state import DeviceState, caps_for_cluster


STAGES = ("sync", "encode", "dispatch", "read", "bind")
# host seconds inside the stages: the quota gate, Coscheduling's
# PreFilter, the volume screen and the claim mask's build and enqueue, the
# quota table sync and batch columns (all five in encode), the gang
# verdicts (the flat gangs' device call and read, the slice gangs' host
# check), the preemption screen (its device call and read, or the host
# shortcut), the PostFilters of the failed pods, the quota Reserves and the
# commit checks (all five in bind)
SCREENS = ("quota_gate", "gang_prefilter", "volume_mask", "claim_mask", "quota_table",
           "gang_verdicts", "preempt_screen", "preempt_host", "quota_reserve",
           "commit_checks")
QUOTA_SCREEN_REASON = ('{err}: namespace "{ns}" over quota at decision time '
                       '(device screen)')
GANG_REFUSED_REASON = 'gang "{gkey}": a member was refused its quota at Reserve'


def unsupported_reason(pod: Pod, client=None) -> Optional[str]:
    """Why this path cannot place ``pod`` (and the slice that will), or
    None when it can. ``client`` is the object store claims and PVCs
    resolve in."""
    spec = pod.spec
    if spec.ephemeral_claims:
        return "generic ephemeral volumes (the scheduler loop takes them)"
    if pod_group_key(pod) is not None:
        if client is None:
            return "gang membership without an object store to hold its PodGroup"
        if spec.resource_claims or spec.volumes:
            return ("a gang pod with resource claims or volumes (their Unreserve needs the "
                    "scheduler loop's bind tail)")
    if (spec.resource_claims or spec.volumes) and client is None:
        return "resource claims or volumes without an object store"
    if spec.resource_claims and not ClaimMaskBuilder(client).batchable(pod):
        return "a resource claim or its class does not resolve"
    for name in spec.volumes:
        pvc = client.get_pvc(f"{pod.meta.namespace}/{name}")
        if pvc is None:
            return f"persistentvolumeclaim {name!r} does not exist"
        if not pvc.bound_pv:
            return (f"persistentvolumeclaim {name!r} is unbound (the scheduler loop binds "
                    "delayed claims)")
    return None


def topo_mode_info(state: DeviceState) -> Tuple[str, Optional[int], int]:
    """(topo_mode, vd_bucket, host_key) for the sig table as the last
    ``encode_topo`` left it: "off" with no registered signature or term;
    "host" when every involved key is the hostname and every valid node
    has a hostname value of its own (a duplicate falls back, as the
    per-node fast path would count two nodes apart); else "general",
    over a domain axis of the smallest power of two >= 64 that covers
    every value id of the involved keys."""
    if not state.topo_enabled:
        return ("off", None, 0)
    summary = state.sig_table.last_topo_summary
    if summary["hostname_only"]:
        host_slot = state.encoder.key_slot(HOSTNAME_KEY)
        vals = state._mirror["label_val"][state._mirror["valid"], host_slot]
        if len(np.unique(vals)) == len(vals):
            return ("host", None, host_slot)
    vd = 64
    while vd < summary["vd_needed"]:
        vd *= 2
    return ("general", vd, 0)


@dataclasses.dataclass
class EncodedBatch:
    """One batch encoded for the device: what its dispatch reads."""

    pb: PodBatch
    et: ExprTable
    tb: TopoBatch
    host_pb: dict                  # the encoder's host copy of the batch
    mode: str                      # topology mode
    vd: Optional[int]
    host_key: int
    kw: Dict[str, object]          # the caller's masks and screens


@dataclasses.dataclass
class DispatchedBatch:
    """One batch after its dispatch, before its read: the result's device
    tensors, and the packed block's copy on its way to the host."""

    enc: EncodedBatch
    res: BatchResult
    path: str                      # "fused", "scan" or "spec"
    # the packed block on the host (pinned memory on CUDA): valid once
    # ``ready`` has fired; ``ready`` is None when it already is
    block: torch.Tensor
    ready: Optional["torch.cuda.Event"]
    # with telemetry on, on CUDA: timing events recorded just before and
    # just after the batch program on its stream
    exec_events: Optional[Tuple["torch.cuda.Event", "torch.cuda.Event"]] = None

    @property
    def quota_col(self) -> bool:
        return "quota_ns" in self.enc.kw


@dataclasses.dataclass
class DeviceBatch:
    """One batch after its device step: what the commit reads."""

    pb: PodBatch
    res: BatchResult
    node_idx: np.ndarray           # [P] chosen slot, -1 = no node
    first_fail: np.ndarray         # [P, N] int8 first failing filter id, 0 = feasible
    slice_words: Optional[np.ndarray]
    quota_words: Optional[np.ndarray]
    mode: str                      # topology mode
    path: str                      # "fused", "scan" or "spec"
    slot_names: Dict[int, str]


ExtrasFn = Callable[[Sequence[Pod], int], Dict[str, object]]


def encode_device_batch(state: DeviceState, pods: Sequence[Pod],
                        tie_seeds: Optional[Sequence[int]] = None,
                        extras: Optional[ExtrasFn] = None,
                        capacity: Optional[int] = None) -> EncodedBatch:
    """Encode the pods with ``tie_seeds`` (default: their attempt-0 seeds)
    and their topology programs, the pod axis padded to ``capacity`` (the
    loop's sizer bucket; default ``caps.pods``); ``extras(pods, pad_to)``
    adds the caller's masks and screens as ``schedule_batch`` arguments.
    Registers the batch's signatures and terms, so the topology mode is
    read after them. Raises CapacityError when the batch outgrows the
    capacities."""
    pb, et = state.encoder.encode_pods(pods, capacity=capacity, tie_seeds=tie_seeds)
    host_pb = state.encoder.last_host_pb
    tb = state.sig_table.encode_topo(pods, capacity=capacity)
    mode, vd, host_key = topo_mode_info(state)
    kw = extras(pods, pb.capacity) if extras is not None else {}
    return EncodedBatch(pb, et, tb, host_pb, mode, vd, host_key, kw)


def stage_to_host(packed: torch.Tensor) -> Tuple[torch.Tensor, Optional["torch.cuda.Event"]]:
    """Start the packed block's copy to the host, the counterpart of JAX's
    ``copy_to_host_async`` (``tpu_scheduler.py:822-831``): on CUDA a
    non-blocking copy into pinned memory on the current stream and an event
    recorded after it; a CPU block is already there."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(packed.device))
    return host, ready


def dispatch_device_batch(state: DeviceState, enc: EncodedBatch,
                          sample_k: Optional[int] = None,
                          sample_start: Optional[torch.Tensor] = None,
                          topo_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> DispatchedBatch:
    """The dispatch half of one batch (JAX's ``_run_batch_fn(adopt=True)``
    and the staged copy): one dispatch on the path ``spec_decode_eligible``
    picks (``sample_k`` / ``sample_start`` sample the batch, which takes
    the scan; ``topo_carry`` starts the topology counts from the newest
    batch in flight), the evolved carry adopted as the device truth, and
    the packed block's copy to the host started. On the fused path nothing
    here waits for the device. With telemetry on, on CUDA, two timing
    events bracket the batch program on the current stream (the dispatch
    ledger's ``deviceExecS``, ``commit_plane.materialize_profiled``)."""
    events = None
    if telemetry.get() is not None and state.device.type == "cuda":
        stream = torch.cuda.current_stream(state.device)
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record(stream)
    res, spec = run_batch_program(state, enc, sample_k, sample_start, topo_carry)
    if events is not None:
        events[1].record(stream)
    state.adopt_device(res)
    block, ready = stage_to_host(res.packed)
    path = "spec" if spec else "fused" if enc.mode == "off" and sample_k is None else "scan"
    return DispatchedBatch(enc, res, path, block, ready, events)


def run_batch_program(state: DeviceState, enc: EncodedBatch, sample_k: Optional[int] = None,
                      sample_start: Optional[torch.Tensor] = None,
                      topo_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      ports_enabled: Optional[bool] = None,
                      **masks) -> Tuple[BatchResult, bool]:
    """(the result, whether it took the speculative rounds) of one run of
    the batch program on ``enc`` against the mirror, adopting nothing (the
    JAX ``_run_batch_fn(adopt=False)``). ``ports_enabled`` defaults to
    whether the encode saw host ports; ``masks`` (``extra_mask``,
    ``dra_mask``) replace the encode's."""
    mode = enc.mode
    topo = {} if mode == "off" else dict(tc=state.tc, tb=enc.tb, topo_mode=mode,
                                          vd_override=enc.vd, host_key=enc.host_key,
                                          topo_carry=topo_carry)
    spec = spec_decode_eligible(mode, state.device, sampled=sample_k is not None)
    if ports_enabled is None:
        ports_enabled = state.encoder.last_has_ports
    res = schedule_batch(enc.pb, enc.et, state.nt, DEFAULT_WEIGHTS, device=state.device,
                         spec_decode=spec, ports_enabled=ports_enabled,
                         sample_k=sample_k, sample_start=sample_start, **topo,
                         **{**enc.kw, **masks})
    return res, spec


def adopt_device_batch(state: DeviceState, disp: DispatchedBatch, read: tuple,
                       mutex: Optional[threading.RLock] = None) -> DeviceBatch:
    """The host mirror advanced by a dispatched batch's commits, given its
    ``read`` (``commit_plane.materialize_result``), under the loop's device
    ``mutex`` when there is one: what the commit reads."""
    node_idx, first_fail, slice_words, quota_words = read
    with mutex if mutex is not None else contextlib.nullcontext():
        state.adopt_commits(disp.res, disp.enc.host_pb, node_idx)
        return DeviceBatch(disp.enc.pb, disp.res, node_idx, first_fail, slice_words,
                           quota_words, disp.enc.mode, disp.path, state.slot_to_name())


def materialize_device_batch(state: DeviceState, disp: DispatchedBatch) -> DeviceBatch:
    """The materialize half: the one blocking read of the packed block,
    then the host mirror advanced by the batch's commits."""
    return adopt_device_batch(state, disp, materialize_result(disp, state.caps.nodes))


def run_device_batch(state: DeviceState, pods: Sequence[Pod], stamps: List[float],
                     tie_seeds: Optional[Sequence[int]] = None,
                     extras: Optional[ExtrasFn] = None) -> DeviceBatch:
    """``BatchScheduler``'s device half of one batch, after its sync: the
    two halves back to back (encode, dispatch, the read). Appends the end
    of encode, dispatch and read to ``stamps`` (``time.perf_counter``)."""
    enc = encode_device_batch(state, pods, tie_seeds, extras)
    stamps.append(time.perf_counter())
    disp = dispatch_device_batch(state, enc)
    stamps.append(time.perf_counter())
    batch = materialize_device_batch(state, disp)
    stamps.append(time.perf_counter())
    return batch


def preempt_screen(state: DeviceState, pods: Sequence[Pod], batch: DeviceBatch,
                   min_prio: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(screen [P, N] bool, best [P] slot or -1) for the pods the batch left
    unplaced (``tpu_scheduler.py:1320-1360``): the device screen on the
    adopted carry and the batch's static masks, read once; or, when no
    failed pod outranks ``min_prio`` (the lowest priority of a bound pod),
    an all-False screen made on the host, as eviction cannot help."""
    n = len(pods)
    failed = batch.node_idx[:n] < 0
    if min_prio is None or all(pods[i].spec.priority <= min_prio
                               for i in np.flatnonzero(failed)):
        return np.zeros((n, state.caps.nodes), bool), np.full(n, -1, np.int32)
    with telemetry.dispatch("preempt_screen", bucket=str(batch.pb.capacity)):
        pres = screen_prefix(batch.pb, state.preempt_inputs(), batch.res.static_masks, failed)
    best, screen, _, _ = unpack_result_block(
        pack_result_block(pres.best, pres.screen.to(torch.int8)), state.caps.nodes)
    return screen.astype(bool), best


def batch_gangs(pods: Sequence[Pod]) -> Tuple[Dict[str, List[int]], Dict[str, List[int]]]:
    """The batch's flat gangs and slice gangs: group key -> batch rows, in
    batch order (``tpu_scheduler.py:1282-1293``, ``_slice_batch_args``)."""
    flat: Dict[str, List[int]] = {}
    slices: Dict[str, List[int]] = {}
    for i, pod in enumerate(pods):
        gkey = pod_group_key(pod)
        if gkey is not None:
            (slices if is_slice_pod(pod) else flat).setdefault(gkey, []).append(i)
    return flat, slices


def slice_batch_kw(slices: Dict[str, List[int]], state: DeviceState) -> Dict[str, object]:
    """The slice plan's arguments of ``schedule_batch`` for the batch's
    slice gangs (``tpu_scheduler.py:1618-1646``), or {} without one."""
    if not slices:
        return {}
    return dict(slice_members=gang_member_index(list(slices.values()), state.device),
                slice_grid=(state.caps.superpods, state.caps.sp_slots))


def quota_batch_kw(quota: QuotaAdmission, state: DeviceState, pods: Sequence[Pod],
                   pad_to: int) -> Dict[str, object]:
    """The quota screen's arguments of ``schedule_batch`` after the
    ledger's rows are synced into the device (``tpu_scheduler.py:
    1647-1664``), or {} when no pod of the batch is screened."""
    table = quota.device_quota_table()
    if not table and not state.nsq_slots:
        return {}
    ns_idx, req = build_quota_batch_args(pods, state, table, pad_to)
    if ns_idx is None:
        return {}
    return dict(quota_ns=ns_idx, quota_req=torch.from_numpy(req).to(state.device),
                quota_used=state.nsq_used, quota_limit=state.nsq_limit)


def screen_batch_kw(volume_masks: VolumeMaskBuilder, claim_masks: ClaimMaskBuilder,
                    state: DeviceState, snapshot: Snapshot, pods: Sequence[Pod], pad_to: int,
                    seconds: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """The batch's volume screen (built on the host from ``snapshot``,
    uploaded once) and claim mask (built on the batch's device), as
    ``schedule_batch``'s ``extra_mask`` and ``dra_mask``; only those the
    batch needs (``tpu_scheduler.py:670-706``). Their host seconds add to
    ``seconds["volume_mask"]`` and ``seconds["claim_mask"]``."""
    out = {}
    t0 = time.perf_counter()
    vol = volume_masks.build(pods, snapshot, state.encoder, state.caps.nodes, pad_to)
    if vol is not None:
        out["extra_mask"] = torch.tensor(vol, device=state.device)
    t1 = time.perf_counter()
    dra = claim_masks.build(pods, state, pad_to)
    if dra is not None:
        out["dra_mask"] = dra
    seconds["volume_mask"] += t1 - t0
    seconds["claim_mask"] += time.perf_counter() - t1
    return out


def judge_gangs(flat: Dict[str, List[int]], slices: Dict[str, List[int]], res: BatchResult,
                node_idx: np.ndarray, slice_words: Optional[np.ndarray], poisoned: Set[int],
                device) -> Dict[str, str]:
    """Whole-gang verdicts of one batch (``tpu_scheduler.py:1276-1318``,
    ``_judge_gangs``, ``_judge_slice_gangs``): group key -> reason for every
    gang to reject, in the order the JAX loop rejects them. Flat gangs by
    one ``gang_verdicts`` device call on the batch's results and one read:
    "incomplete" when a distinct-node cover existed on the decision-time
    masks but the batch's commits broke it, else "infeasible". Slice gangs
    on the host from their words: "incomplete" when the plan found a window
    that a member lost, else "infeasible". Then a gang placed whole with a
    member in ``poisoned`` (a stale slot, a winner the quota screen
    flagged): "incomplete"."""
    reasons: Dict[str, str] = {}
    if flat:
        member_idx, member_valid = gang_member_index(list(flat.values()), device)
        with telemetry.dispatch("gang_verdicts",
                                bucket=f"{member_idx.shape[0]}x{member_idx.shape[1]}"):
            placed_all, kernel_ok, _assign = gang_verdicts(res.node_idx, res.first_fail,
                                                           member_idx, member_valid)
        verdicts = torch.stack([placed_all, kernel_ok]).cpu().numpy()  # one read
        for g, gkey in enumerate(flat):
            if not verdicts[0, g]:
                reasons[gkey] = "incomplete" if verdicts[1, g] else "infeasible"
    for gkey, rows in slices.items():
        if all(node_idx[i] >= 0 for i in rows):
            continue
        plan_ok = slice_words is None or all(int(slice_words[i]) & SLICE_PLAN_OK_BIT
                                             for i in rows)
        reasons[gkey] = "incomplete" if plan_ok else "infeasible"
    for gkey, rows in {**flat, **slices}.items():
        if gkey not in reasons and any(i in poisoned for i in rows):
            reasons[gkey] = "incomplete"  # a PodGroup never half-admits
    return reasons


class BatchScheduler:
    def __init__(self, node_infos: Iterable[NodeInfo], caps: Optional[Capacities] = None,
                 device: DeviceLike = None, ns_labels_fn: Optional[NsLabelsFn] = None,
                 client=None):
        infos = list(node_infos)
        self.caps = caps or caps_for_cluster(len(infos))
        self.state = DeviceState(self.caps, device, ns_labels_fn)
        self.device = self.state.device
        self.snapshot = Snapshot(infos)
        self.batches = 0
        self.batch_modes: List[str] = []  # topology mode of each batch, in order
        # commit path of each batch: "fused" (the kernel), "scan" or "spec"
        # (the speculative rounds), as ``spec_decode_eligible`` chose it
        self.batch_paths: List[str] = []
        # host seconds per stage of a batch, summed over batches: sync,
        # encode (pods and topology programs), dispatch (count tables
        # uploaded, static phase and the kernel or the scan enqueued), read (the
        # blocking device-to-host read, which waits for the device) and bind
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.screen_seconds = dict.fromkeys(SCREENS, 0.0)
        self.client = client  # the object store of claims and volumes, or None
        self._volume_masks = VolumeMaskBuilder(client)
        self._claim_masks = ClaimMaskBuilder(client)
        # pod key -> reason, for pods the commit checks turned away: retry
        # holds Reserve conflicts (resubmit them), fallback the pods whose
        # volume check failed or whose claim vanished
        self.retry: Dict[str, str] = {}
        self.fallback: Dict[str, str] = {}
        # preemption: the nominations (pod key -> node; resubmit those pods)
        # and the evicted pods (victim key -> preemptor key)
        self.nominated: Dict[str, str] = {}
        self.preempted: Dict[str, str] = {}
        self.nominator = PodNominator()
        self._evicted: List[Pod] = []  # this batch's victims, removed after its binds
        # gangs: pod key -> why its gang took no row or was rejected whole
        self.gang_rejected: Dict[str, str] = {}
        self.coscheduling = (Coscheduling(client, self._gang_members)
                             if client is not None else None)
        self._call_members: Dict[str, Set[str]] = {}  # gkey -> this call's member keys
        # gkey -> keys of its pods bound in the snapshot; built on first use
        self._bound_members: Optional[Dict[str, Set[str]]] = None
        # namespace quota: the ledger, and pod key -> why the gate or the
        # device screen turned the pod away
        self.quota = QuotaAdmission(client, self._bound_pods) if client is not None else None
        self.quota_rejected: Dict[str, str] = {}
        # namespace -> pods the gate turned away and winners the device
        # screen flagged, over all batches
        self.quota_gated: Dict[str, int] = {}
        self.quota_flagged: Dict[str, int] = {}
        # the default profile, its QuotaAdmission and Coscheduling this
        # scheduler's engines (left out without a store) and no SlicePacking
        # (the batch program plans the slices): DefaultPreemption's filters
        registry = in_tree_registry()
        for name, engine in ((names.QUOTA_ADMISSION, self.quota),
                             (names.COSCHEDULING, self.coscheduling),
                             (names.SLICE_PACKING, None)):
            if engine is None:
                del registry[name]
            else:
                registry[name] = lambda h, a, _engine=engine: _engine
        self.framework = Framework(
            {"client": client, "snapshot_fn": lambda: self.snapshot.node_info_map.values(),
             "ns_labels_fn": ns_labels_fn, "nominator": self.nominator,
             "evict": self._evict, "clear_nomination": self._clear_nomination},
            registry=registry)
        self._preemption = self.framework.plugin(names.DEFAULT_PREEMPTION)

    def add_node(self, ni: NodeInfo) -> None:
        """Add or replace a node (its pods come with its NodeInfo)."""
        self.snapshot.set(ni)
        self._bound_members = None

    def remove_node(self, name: str) -> None:
        self.snapshot.remove(name)
        self._bound_members = None

    def _bound_pods(self) -> Iterable[Pod]:
        """The pods bound in the cluster, this batch's victims excepted."""
        gone = {p.key() for p in self._evicted}
        for ni in self.snapshot.node_info_map.values():
            for p in ni.pods:
                if p.key() not in gone:
                    yield p

    def delete_pod(self, key: str) -> bool:
        """Take a bound pod off its node (the next ``sync`` uploads the
        node) and release its quota charge, as a pod deletion in the store
        does; returns whether the pod was found."""
        for name, ni in self.snapshot.node_info_map.items():
            pod = next((p for p in ni.pods if p.key() == key), None)
            if pod is None:
                continue
            ni.remove_pod(pod)
            self.snapshot.changed_names.add(name)
            gkey = pod_group_key(pod)
            if gkey is not None and self._bound_members is not None:
                self._bound_members.get(gkey, set()).discard(key)
            if self.quota is not None:
                self.quota.pod_deleted(pod)
            return True
        return False

    def schedule(self, pods: Sequence[Pod]) -> Dict[str, Optional[str]]:
        """Place ``pods`` in order, in batches; returns pod key -> node name,
        or None when no node fits (or the pod's gang was not placed whole)."""
        for pod in pods:
            reason = unsupported_reason(pod, self.client)
            if reason is not None:
                raise NotImplementedError(f"pod {pod.key()}: {reason}")
        step = self.caps.pods
        chunks = [pods[i:i + step] for i in range(0, len(pods), step)]
        batch_of: Dict[str, int] = {}
        members: Dict[str, Set[str]] = {}
        for b, chunk in enumerate(chunks):
            for pod in chunk:
                gkey = pod_group_key(pod)
                if gkey is None:
                    continue
                if batch_of.setdefault(gkey, b) != b:
                    raise NotImplementedError(
                        f"gang {gkey} straddles a batch boundary (Permit across batches "
                        "is the scheduler loop's: TPUScheduler)")
                members.setdefault(gkey, set()).add(pod.key())
        self._call_members = members
        out: Dict[str, Optional[str]] = {}
        try:
            for chunk in chunks:
                out.update(self._schedule_batch(chunk))
        finally:
            self._call_members = {}
        return out

    def _bound_gang_pods(self) -> Dict[str, Set[str]]:
        """gkey -> the keys of its pods bound in the snapshot."""
        if self._bound_members is None:
            self._bound_members = {}
            for ni in self.snapshot.node_info_map.values():
                for p in ni.pods:
                    gkey = pod_group_key(p)
                    if gkey is not None:
                        self._bound_members.setdefault(gkey, set()).add(p.key())
        return self._bound_members

    def _gang_members(self, gkey: str, bound_only: bool) -> int:
        """Coscheduling's member count: the group's pods bound in the
        snapshot, plus (``bound_only`` False) this call's pods of the group."""
        bound = self._bound_gang_pods().get(gkey, set())
        if bound_only:
            return len(bound)
        return len(bound | self._call_members.get(gkey, set()))

    def _topo_mode_info(self) -> Tuple[str, Optional[int], int]:
        return topo_mode_info(self.state)

    def _schedule_batch(self, pods: Sequence[Pod]) -> Dict[str, Optional[str]]:
        state = self.state
        placed: Dict[str, Optional[str]] = {}
        t = [time.perf_counter()]
        state.sync(self.snapshot)
        t.append(time.perf_counter())
        pods = self._gang_prefilter(self._quota_gate(pods, placed), placed)
        if not pods:
            return placed  # every pod failed a PreFilter: no batch
        flat, slices = batch_gangs(pods)

        def extras(pods: Sequence[Pod], pad_to: int) -> Dict[str, object]:
            return {**self._screens(pods, pad_to), **self._quota_batch_args(pods, pad_to),
                    **slice_batch_kw(slices, state)}

        batch = run_device_batch(state, pods, t, extras=extras)
        res, node_idx, slot_names = batch.res, batch.node_idx, batch.slot_names
        slice_words, quota_words, mode = batch.slice_words, batch.quota_words, batch.mode
        flagged = self._quota_flagged(pods, node_idx, quota_words)
        gang_rows = self._judge_gangs(flat, slices, res, node_idx, slice_words, flagged)
        if (node_idx[:len(pods)] < 0).any() or gang_rows:
            self._preempt(pods, batch, gang_rows)
        rejected: Set[str] = set()  # nodes whose device commit is surrendered
        held: List[Pod] = []  # charged pods whose claims failed Reserve
        refused: Dict[str, Set[str]] = {}  # gang -> its members the quota refused
        gang_bound: Dict[str, List[Pod]] = {}
        for i, pod in enumerate(pods):
            slot = int(node_idx[i])
            key = pod.key()
            placed[key] = None
            if i in gang_rows:
                self.gang_rejected[key] = gang_rows[i]
                if slot >= 0:
                    rejected.add(slot_names[slot])  # the device placed it: surrender
                continue
            if slot < 0:
                continue
            name = slot_names[slot]
            if i in flagged:
                self.quota_rejected[key] = QUOTA_SCREEN_REASON.format(
                    err=ERR_REASON_QUOTA_EXCEEDED, ns=pod.meta.namespace)
                rejected.add(name)
                continue
            gkey = pod_group_key(pod)
            if not self._commit(pod, name, held):
                rejected.add(name)
                if gkey is not None:
                    refused.setdefault(gkey, set()).add(key)
                continue
            self.retry.pop(key, None)  # placed on a resubmission
            self.fallback.pop(key, None)
            self.quota_rejected.pop(key, None)
            bound_pod = pod.clone()
            bound_pod.spec.node_name = name
            self.snapshot.node_info_map[name].add_pod(bound_pod)  # bumps the generation
            self.snapshot.changed_names.add(name)
            placed[key] = name
            self.nominator.delete_nominated_pod_if_exists(pod)
            self.nominated.pop(key, None)
            if gkey is not None:
                gang_bound.setdefault(gkey, []).append(bound_pod)
        # the commit plane unreserves after every winner has reserved
        for pod in held:
            self.quota.unreserve(None, pod, pod.spec.node_name)
        for gkey, keys in refused.items():
            rejected.update(self._turn_gang_away(gkey, keys, pods, placed,
                                                 gang_bound.pop(gkey, [])))
        for gkey, members in gang_bound.items():
            for bound_pod in members:
                self.gang_rejected.pop(bound_pod.key(), None)
                self._bound_gang_pods().setdefault(gkey, set()).add(bound_pod.key())
        # the carry and the mirror hold the commits of the pods turned away
        # and of the surrendered gang members: the next sync uploads those
        # rows again from the snapshot
        for name in rejected:
            state.invalidate_row(name)
        if gang_bound:
            self.coscheduling.post_bind_batch([p for m in gang_bound.values() for p in m])
        self._remove_evicted()
        t.append(time.perf_counter())
        for stage, a, b in zip(STAGES, t, t[1:]):
            self.stage_seconds[stage] += b - a
        self.batches += 1
        self.batch_modes.append(mode)
        self.batch_paths.append(batch.path)
        return placed

    def _quota_gate(self, pods: Sequence[Pod], placed: Dict[str, Optional[str]]) -> List[Pod]:
        """QuotaAdmission's PreFilter over the batch: an over-quota pod
        takes no batch row, returns None and lands in ``quota_rejected``.
        Returns the pods that stay in the batch."""
        if self.quota is None:
            return list(pods)
        t0 = time.perf_counter()
        kept = []
        for pod in pods:
            _restrict, fail = self.quota.pre_filter(None, pod)
            if fail is None:
                kept.append(pod)
            else:
                placed[pod.key()] = None
                self.quota_rejected[pod.key()] = fail.reason
                ns = pod.meta.namespace
                self.quota_gated[ns] = self.quota_gated.get(ns, 0) + 1
        self.screen_seconds["quota_gate"] += time.perf_counter() - t0
        return kept

    def _quota_batch_args(self, pods: Sequence[Pod], pad_to: int) -> Dict[str, object]:
        if self.quota is None:
            return {}
        t0 = time.perf_counter()
        out = quota_batch_kw(self.quota, self.state, pods, pad_to)
        self.screen_seconds["quota_table"] += time.perf_counter() - t0
        return out

    def _quota_flagged(self, pods: Sequence[Pod], node_idx: np.ndarray,
                       quota_words: Optional[np.ndarray]) -> Set[int]:
        """The batch rows the device screen flagged: screened winners
        without the ok bit (``tpu_scheduler.py:1262-1274``)."""
        if quota_words is None:
            return set()
        n = len(pods)
        w = quota_words[:n]
        rows = (node_idx[:n] >= 0) & ((w & QUOTA_SCREEN_BIT) != 0) & ((w & QUOTA_OK_BIT) == 0)
        flagged = set(np.flatnonzero(rows).tolist())
        for i in flagged:
            ns = pods[i].meta.namespace
            self.quota_flagged[ns] = self.quota_flagged.get(ns, 0) + 1
        return flagged

    def _commit(self, pod: Pod, name: str, held: List[Pod]) -> bool:
        """The commit of one winner on its node, in batch order: the volume
        and claim pod's checks before Reserve, QuotaAdmission's Reserve,
        then its claims' Reserve. Returns False when the pod was turned
        away, and records why: ``fallback`` for a failed check, ``retry``
        for a refused Reserve. A pod whose claims fail Reserve keeps its
        quota charge (it joins ``held``) until the batch's winners have all
        reserved."""
        key = pod.key()
        t0 = time.perf_counter()
        claims: dynamicresources.Claims = []
        try:
            if pod.spec.volumes or pod.spec.resource_claims:
                claims, reason = self._commit_prechecks(pod, name)
                if reason is not None:
                    self.fallback[key] = reason
                    return False
            if self.quota is not None:
                tq = time.perf_counter()
                reason = self.quota.reserve(None, pod, name)
                self.screen_seconds["quota_reserve"] += time.perf_counter() - tq
                t0 += time.perf_counter() - tq
                if reason is not None:
                    self.retry[key] = reason
                    return False
            if pod.spec.resource_claims:
                failed = dynamicresources.reserve(self.client, pod, name, claims)
                if failed is not None:
                    target = self.retry if isinstance(failed, Conflict) else self.fallback
                    target[key] = f"{dynamicresources.ERR_REASON_CANNOT_ALLOCATE}: {failed}"
                    if self.quota is not None:
                        held.append(pod)
                    return False
            return True
        finally:
            self.screen_seconds["commit_checks"] += time.perf_counter() - t0

    def _turn_gang_away(self, gkey: str, refused: Set[str], pods: Sequence[Pod],
                        placed: Dict[str, Optional[str]], bound: List[Pod]) -> Set[str]:
        """A gang with members the quota refused at Reserve (``refused``)
        leaves whole: the members this batch bound give their charges back
        and leave their nodes again, and every member lands in ``retry``.
        Returns the nodes whose device commit is surrendered."""
        nodes = set()
        for bound_pod in bound:
            self.quota.unreserve(None, bound_pod, bound_pod.spec.node_name)
            name = bound_pod.spec.node_name
            self.snapshot.node_info_map[name].remove_pod(bound_pod)
            self.snapshot.changed_names.add(name)
            nodes.add(name)
        for pod in pods:
            if pod_group_key(pod) == gkey and pod.key() not in refused:
                placed[pod.key()] = None
                self.retry[pod.key()] = GANG_REFUSED_REASON.format(gkey=gkey)
        return nodes

    def _preempt(self, pods: Sequence[Pod], batch: DeviceBatch,
                 gang_rows: Dict[int, str]) -> None:
        """The failure path of one batch, in the JAX package's order: the
        screen on the adopted carry and the batch's static masks (or the
        host shortcut), its one read, then each failed pod's PostFilter in
        batch order, the nominator updated per pod. Victims stay in the
        snapshot until the batch's binds are done. A member of a rejected
        gang (``gang_rows``) that the device left unplaced runs its
        PostFilter without hints; one it placed preempts nothing."""
        t0 = time.perf_counter()
        failed = batch.node_idx[:len(pods)] < 0
        slot_names = batch.slot_names
        screen = best = None
        if failed.any():
            screen, best = preempt_screen(self.state, pods, batch,
                                          self.snapshot.min_pod_priority())
        t1 = time.perf_counter()
        slot_of = dict(self.state.encoder.node_slots)
        rows = sorted(set(np.flatnonzero(failed).tolist()) | set(gang_rows))
        for i in rows:
            pod = pods[i]
            if i in gang_rows:
                if not failed[i]:
                    continue  # placed, a sibling missed: only Coscheduling failed
                hints = None
            else:
                b = int(best[i])
                hints = (screen[i], slot_of, slot_names.get(b) if b >= 0 else None)
            node, _reason = self._preemption.post_filter(pod, hints)
            if node is not None:
                self.nominator.add_nominated_pod(pod, node)
                pod.status.nominated_node_name = node
                self.nominated[pod.key()] = node
        self.screen_seconds["preempt_screen"] += t1 - t0
        self.screen_seconds["preempt_host"] += time.perf_counter() - t1

    def _gang_prefilter(self, pods: Sequence[Pod],
                        placed: Dict[str, Optional[str]]) -> List[Pod]:
        """Coscheduling's PreFilter over the batch's gang members: a member
        that fails it takes no batch row, returns None and lands in
        ``gang_rejected``. Returns the pods that stay in the batch."""
        if self.coscheduling is None:
            return list(pods)
        t0 = time.perf_counter()
        kept = []
        for pod in pods:
            _restrict, fail = self.coscheduling.pre_filter(None, pod)
            if fail is None:
                kept.append(pod)
            else:
                placed[pod.key()] = None
                self.gang_rejected[pod.key()] = fail.reason
        self.screen_seconds["gang_prefilter"] += time.perf_counter() - t0
        return kept

    def _judge_gangs(self, flat: Dict[str, List[int]], slices: Dict[str, List[int]], res,
                     node_idx: np.ndarray, slice_words: Optional[np.ndarray],
                     flagged: Set[int]) -> Dict[int, str]:
        """Whole-gang verdicts of one batch (``judge_gangs``): {batch row ->
        reason} for every member of a gang the batch did not place whole,
        or with a member the quota screen flagged (``flagged``), with
        ``reject_gang`` called once per such gang."""
        if not flat and not slices:
            return {}
        t0 = time.perf_counter()
        reasons = judge_gangs(flat, slices, res, node_idx, slice_words, flagged, self.device)
        out: Dict[int, str] = {}
        for gkey, reason in reasons.items():
            self.coscheduling.reject_gang(gkey, reason)
            for i in flat.get(gkey) or slices[gkey]:
                out[i] = reason
        self.screen_seconds["gang_verdicts"] += time.perf_counter() - t0
        return out

    def _evict(self, victim: Pod, preemptor: Pod) -> None:
        """A victim leaves the ledger at once, as a deletion in the store
        does; it leaves its node after the batch's binds."""
        self.preempted.setdefault(victim.key(), preemptor.key())
        self._evicted.append(victim)
        if self.quota is not None:
            self.quota.pod_deleted(victim)

    def _clear_nomination(self, pod: Pod) -> None:
        """A higher-priority preemptor took the node ``pod`` was nominated
        to: it must be evaluated again."""
        pod.status.nominated_node_name = ""
        self.nominated.pop(pod.key(), None)

    def _remove_evicted(self) -> None:
        """Take the batch's victims off their nodes, each once."""
        for victim in self._evicted:
            ni = self.snapshot.node_info_map.get(victim.spec.node_name)
            if ni is not None and ni.remove_pod(victim):
                self.snapshot.changed_names.add(victim.spec.node_name)
                gkey = pod_group_key(victim)
                if gkey is not None and self._bound_members is not None:
                    self._bound_members.get(gkey, set()).discard(victim.key())
        self._evicted.clear()

    def _screens(self, pods: Sequence[Pod], pad_to: int) -> Dict[str, torch.Tensor]:
        if self.client is None:
            return {}
        return screen_batch_kw(self._volume_masks, self._claim_masks, self.state, self.snapshot,
                               pods, pad_to, self.screen_seconds)

    def _commit_prechecks(self, pod: Pod, node_name: str
                          ) -> Tuple[dynamicresources.Claims, Optional[str]]:
        """The host checks of a volume or claim pod on its chosen node
        before Reserve, as the JAX commit path runs them: the volume and
        claim PreFilters, then the exact volume filters on the node, whose
        NodeInfo holds the batch's earlier binds. Returns (the pod's
        resolved claims, None), or ([], why the pod goes to ``fallback``)."""
        client = self.client
        ni = self.snapshot.node_info_map[node_name]
        rwop, bound, reason = set(), [], None
        if pod.spec.volumes:
            rwop, reason = volume.volume_restrictions_pre_filter(
                client, pod, self.snapshot.node_info_map.values())
            if reason is None:
                bound, _delayed, reason = volume.volume_binding_pre_filter(client, pod)
        claims = []
        if reason is None and pod.spec.resource_claims:
            claims, reason = dynamicresources.pre_filter(client, pod)
        if reason is None and pod.spec.volumes:
            failed = volume.verify_on_node(client, pod, ni, rwop, bound)
            reason = failed[1] if failed is not None else None
        return claims, reason
