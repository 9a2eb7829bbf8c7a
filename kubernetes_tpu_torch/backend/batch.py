"""The batched scheduling step: one call schedules a pod batch against the
node mirror (PyTorch counterpart of ``kubernetes_tpu/backend/batch.py``).

  0. SLICE plan (batches with slice gangs): the torus planner
     (``ops/slice.py``) picks each slice gang's window and ``_slice_plan``
     lowers it to a per-pod mask and per-pod verdict words.
  1. STATIC phase (once per batch): the selector VM, the static filter masks
     and the raw scores that no intra-batch commit can change (labels,
     taints, affinity, images), the host's volume screen, the device's
     claim-feasibility mask (``claim_feasibility_mask``) and the slice mask
     where the batch has them, the static first-fail table and the seeded
     tie-break jitter.
  2. COMMIT phase, with the scan's sequential semantics, on one of three
     paths (``spec_decode_eligible`` picks one per batch):
     * topology mode ``off`` (no spread constraint, no inter-pod term, no
       registered count row): the fused per-pod step (ops/fused_step.py),
       one launch of the hand-written kernel per batch on CUDA tensors;
     * modes ``host`` and ``general``, and a sampled batch in any mode: the
       per-pod scan ``_topology_scan``, the XLA scan ``step`` written as a
       Python loop over pods on device tensors. It adds PodTopologySpread
       and InterPodAffinity (ops/topology.py) to the fit, ports, scores,
       winner and commit, and carries the topology count tables; with
       ``sample_k`` it keeps only the first ``sample_k`` feasible nodes of a
       rotating window (percentageOfNodesToScore) and carries the window's
       start;
     * any mode: the speculative rounds ``_speculative_core``, a few
       vectorized decide/repair rounds over all the batch's pods, each
       ending in one host read of the loop's condition.
  3. The priority-class table (and, after the scan, the full nonzero
     request table) is advanced by the batch's commits in one post-scan
     scatter.
  4. QUOTA screen (batches with screened namespaces, on every path): the
     winners replayed in batch order against the namespace quota rows
     (``ops/quota.py``).
  5. The winners plus the first-fail table (and the slice and quota words)
     are packed into one int32 block the host reads once.

``gang_verdicts`` judges a batch's flat gangs after that read: one device
call over the batch's ``node_idx`` and ``first_fail`` (``ops/gang.py``).

Node-axis sharding (the JAX ``axis_name``): ``schedule_batch_core`` with a
``mesh`` (``parallel/mesh.py:NodeMesh``) runs one rank's share of the
batch, its node tensors that rank's window of the node axis, and the
collectives of ``ops/topology.py`` make every per-pod decision global:
the winner per scan step or round, the normalizations, the topology
tables. It takes the scan or the rounds in every mode, never the fused
kernel or the sampling window, as the JAX sharded program does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..api.dra import OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, OP_NE
from ..ops import filters, scores, topology
from ..ops.fused_step import (NEG_INF, NOMINATED_BONUS, WEIGHT_ORDER, _normalize,
                              _resource_scores, fused_step_batch, fused_step_bytes)
from ..ops.gang import assign_gangs
from ..ops.quota import quota_screen
from ..ops.slice import plan_slices
from ..ops.schema import ExprTable, NodeTensors, PodBatch, TopoBatch, TopoCounts
from ..ops.tiebreak import jitter_table
from ..ops.topology import _gmax, _gmin, _gsum
from ..utils.device import DeviceLike, check_on, resolve_device
from . import telemetry
from .device_state import _bucket

# default plugin weights on the batched path (default_plugins.go:32-51)
DEFAULT_WEIGHTS = {
    "NodeResourcesBalancedAllocation": 1.0,
    "ImageLocality": 1.0,
    "NodeResourcesFit": 1.0,
    "NodeAffinity": 2.0,
    "TaintToleration": 3.0,
    "PodTopologySpread": 2.0,
    "InterPodAffinity": 2.0,
}

# first-fail ids of the static filters (filter config order; 0 = passes)
STATIC_FILTER_IDS = ((4, "NodeAffinity"), (3, "TaintToleration"),
                     (2, "NodeName"), (1, "NodeUnschedulable"))
# and of the dynamic ones, after ports (5) and fit (6)
SPREAD_FAIL_ID, IPA_FAIL_ID = 7, 8
# the volume screen (VolumeBinding and friends), the claim mask
# (DynamicResources) and the slice mask: static, but after every plugin
# above in filter order
VOLUME_FAIL_ID, DRA_FAIL_ID, SLICE_FAIL_ID = 9, 10, 11

# per-pod slice verdict word (the packed block's column after the
# first-fail words): bit 0 = the pod is a slice-gang member, bit 1 = its
# gang's torus plan was feasible, bits 2+ = the planned node slot + 1 (0 =
# none). The mask pins members to their planned cells, so "every member
# landed" is the contiguity verdict.
SLICE_MEMBER_BIT = 1
SLICE_PLAN_OK_BIT = 2
SLICE_TARGET_SHIFT = 2

TOPO_MODES = ("off", "host", "general")


@dataclasses.dataclass
class BatchResult:
    node_idx: torch.Tensor      # [P] int32 chosen slot, -1 = unschedulable
    best_score: torch.Tensor    # [P] float32 winner total (no jitter)
    any_feasible: torch.Tensor  # [P] bool
    static_masks: Dict[str, torch.Tensor]  # plugin name -> [P, N] bool
    fit_ok: torch.Tensor        # [P, N] resource fit at decision time
    ports_ok: torch.Tensor      # [P, N] port availability at decision time
    spread_ok: torch.Tensor     # [P, N] PodTopologySpread filter at decision time
    ipa_ok: torch.Tensor        # [P, N] InterPodAffinity (all three checks)
    # [P, N] int8: 0 = feasible, else the 1-based filter id of the first
    # failing plugin (static ids 1-4, ports 5, fit 6, spread 7, ipa 8,
    # volumes 9, claims 10, slices 11)
    first_fail: torch.Tensor
    # the evolved carry: the post-batch dynamic node state
    final_requested: torch.Tensor   # [N, R] int32
    final_nonzero: torch.Tensor     # [N, R] int32
    final_ports: torch.Tensor       # [N, W] int32 (uint32 bits)
    final_class_req: torch.Tensor   # [N, C, R] int32
    # the evolved topology carry (None in mode "off")
    final_sel_counts: Optional[torch.Tensor] = None  # [S, N] int32
    # [T, Vd] int32 per-domain term counts in mode "general", [T, N] per-node
    # term counts in mode "host"
    final_seg_exist: Optional[torch.Tensor] = None
    # [P, 1 + ceil(N/4) (+ 1 or 2)] int32: node_idx, first_fail bitcast to
    # words, then the slice words when the batch had slice gangs and the
    # quota words when it had screened namespaces
    packed: Optional[torch.Tensor] = None
    # the sampling window's start after the batch (0-d int32; None when
    # the batch was not sampled)
    final_sample_start: Optional[torch.Tensor] = None


def weight_vector(weights: Dict[str, float]) -> Tuple[float, ...]:
    """The five commit-step weights in kernel order, rounded to float32."""
    return tuple(float(np.float32(weights[k])) for k in WEIGHT_ORDER)


def pack_result_block(node_idx: torch.Tensor, first_fail: torch.Tensor,
                      slice_words: Optional[torch.Tensor] = None,
                      quota_words: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[P, 1 + ceil(N/4) (+ extras)] int32: node_idx in column 0, then the
    int8 first_fail rows reinterpreted as int32 words after padding N to a
    multiple of 4 (little-endian, the bytes of ``lax.bitcast_convert_type``),
    then the trailing verdict columns in fixed order: the slice words, then
    the quota words, each where given."""
    p, n = first_fail.shape
    pad = (-n) % 4
    if pad:
        first_fail = torch.cat(
            [first_fail, first_fail.new_zeros((p, pad))], dim=1)
    words = first_fail.contiguous().view(torch.int32)
    cols = [node_idx.to(torch.int32)[:, None], words]
    for extra in (slice_words, quota_words):
        if extra is not None:
            cols.append(extra.to(torch.int32)[:, None])
    return torch.cat(cols, dim=1)


def unpack_result_block(packed, n_nodes: int, quota_col: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                                   Optional[np.ndarray]]:
    """(node_idx [P] int32, first_fail [P, N] int8, slice_words [P] int32 or
    None, quota_words [P] int32 or None) from the packed block. Two columns
    past the first-fail words are the slice then the quota words; one is
    the quota column when the batch ran the quota screen (``quota_col``,
    known where it was dispatched), else the slice column. Reading a device
    tensor here is THE blocking device read of a batch."""
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    ff_words = (n_nodes + 3) // 4
    extras = arr.shape[1] - 1 - ff_words
    slice_words = quota_words = None
    if extras >= 2:
        slice_words = arr[:, 1 + ff_words].copy()
        quota_words = arr[:, 2 + ff_words].copy()
    elif extras == 1:
        if quota_col:
            quota_words = arr[:, 1 + ff_words].copy()
        else:
            slice_words = arr[:, 1 + ff_words].copy()
    ff = np.ascontiguousarray(arr[:, 1:1 + ff_words]).view(np.int8)
    return (arr[:, 0].copy(), ff.reshape(arr.shape[0], -1)[:, :n_nodes], slice_words,
            quota_words)


def _pod_port_bits(pb: PodBatch, words: int) -> torch.Tensor:
    """[P, W] uint32 bits in int32: each pod's wanted-port ids as a bitset."""
    ids = pb.port_ids
    bit = torch.where(ids > 0, torch.ones_like(ids, dtype=torch.int64) << (ids & 31).long(),
                      torch.zeros_like(ids, dtype=torch.int64))
    out = torch.zeros((ids.shape[0], words), dtype=torch.int64, device=ids.device)
    # ids are deduplicated at encode time, so add == bitwise-or here
    out.scatter_add_(1, (ids >> 5).long(), bit)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def claim_feasibility_mask(sel_key: torch.Tensor, sel_op: torch.Tensor,
                           sel_kind: torch.Tensor, sel_val: torch.Tensor,
                           attr_kind: torch.Tensor, attr_val: torch.Tensor) -> torch.Tensor:
    """[P, N] bool: the node's attribute row satisfies every selector of the
    pod (``kubernetes_tpu/backend/batch.py:88-117``).

    sel_* : [P, S] int32 selector rows, op -1 padding (always matches);
    attr_kind / attr_val : [N, A] cells (kind 0 = absent, 1 = int, 2 =
    interned string id). The predicate is api/dra.py's
    ``DeviceSelector.matches``: an absent attribute never matches, ``==`` and
    ``!=`` need the same kind, the ordering ops need int against int. One
    [P, S, N] compare and an all-reduce over S."""
    keys = sel_key.long()
    ak = attr_kind.t()[keys]                 # [P, S, N]
    av = attr_val.t()[keys]
    op, okind, ov = sel_op[:, :, None], sel_kind[:, :, None], sel_val[:, :, None]
    present = ak > 0
    same = present & (ak == okind)
    num = present & (ak == 1) & (okind == 1)
    ok = torch.zeros_like(present)
    ok = torch.where(op == OP_EQ, same & (av == ov), ok)
    ok = torch.where(op == OP_NE, same & (av != ov), ok)
    ok = torch.where(op == OP_GE, num & (av >= ov), ok)
    ok = torch.where(op == OP_GT, num & (av > ov), ok)
    ok = torch.where(op == OP_LE, num & (av <= ov), ok)
    ok = torch.where(op == OP_LT, num & (av < ov), ok)
    return torch.all(ok | (op < 0), dim=1)


def static_phase(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                 extra_mask: Optional[torch.Tensor] = None,
                 dra_mask: Optional[torch.Tensor] = None,
                 slice_mask: Optional[torch.Tensor] = None, mesh=None):
    """(static_masks, static_ok, static_ff, taint_raw, affinity_raw,
    image_score, jitter): everything about the batch that no intra-batch
    commit can change (``schedule_batch_core`` lines 1042-1104).
    ``extra_mask`` (the volume screen), ``dra_mask`` (the claim mask) and
    ``slice_mask`` (``_slice_plan``) are optional [P, N] bool masks ANDed
    into ``static_ok``; the first-fail id of a cell is its earliest failing
    plugin: 1-4, then 9, then 10, then 11. Under a ``mesh`` ``nt`` is one
    rank's window: NodeName compares global slot ids and ImageLocality
    divides by the valid nodes of every rank (``:1036-1046``, ``:1084``)."""
    expr_match = filters.eval_exprs(et, nt)
    static_masks = {
        "NodeUnschedulable": filters.filter_unschedulable(pb, nt),
        "NodeName": filters.filter_node_name(pb, nt, _slot_offset(nt, mesh)),
        "TaintToleration": filters.filter_taints(pb, nt),
        "NodeAffinity": filters.filter_node_affinity(pb, et, nt, expr_match),
    }
    static_ok = nt.valid[None, :] & pb.valid[:, None]
    for m in static_masks.values():
        static_ok = static_ok & m
    for m in (extra_mask, dra_mask, slice_mask):
        if m is not None:
            static_ok = static_ok & m
    static_ff = torch.zeros(static_ok.shape, dtype=torch.int8, device=static_ok.device)
    # assigned latest plugin first, so the earliest failing plugin wins
    for sid, m in ((SLICE_FAIL_ID, slice_mask), (DRA_FAIL_ID, dra_mask),
                   (VOLUME_FAIL_ID, extra_mask)):
        if m is not None:
            static_ff = torch.where(~m, torch.full_like(static_ff, sid), static_ff)
    for sid, name in STATIC_FILTER_IDS:
        static_ff = torch.where(~static_masks[name], torch.full_like(static_ff, sid), static_ff)
    taint_raw = scores.score_taint_toleration(pb, nt)
    affinity_raw = scores.score_node_affinity(pb, et, nt, expr_match)
    image_score = scores.score_image_locality(pb, nt, mesh=mesh)
    jitter = jitter_table(pb.tie_seed, nt.name_hash)
    return static_masks, static_ok, static_ff, taint_raw, affinity_raw, image_score, jitter


def _slot_offset(nt: NodeTensors, mesh) -> int:
    """The first global slot of this rank's window (0 without a mesh)."""
    return 0 if mesh is None else mesh.rank * nt.capacity


def _commit_scatters(nt: NodeTensors, pb: PodBatch, node_idx: torch.Tensor,
                     nonzero: bool, slot_offset: int = 0):
    """The batch's commits added in one post-scan scatter each: the
    priority-class table [N, C, R] and, when ``nonzero``, the full nonzero
    request table [N, R] (the scan carries only its two scored columns).
    ``index_add_`` on flattened rows: no host read, on any device. Under
    sharding ``node_idx`` holds global slots and ``nt`` the window from
    ``slot_offset``: only the winners inside it are added."""
    n = nt.capacity
    committed = (node_idx >= slot_offset) & (node_idx < slot_offset + n)
    slot = torch.where(committed, node_idx - slot_offset, 0).long()
    _, c, r = nt.class_req.shape
    f_class = nt.class_req.clone(memory_format=torch.contiguous_format)
    f_class.view(n * c, r).index_add_(0, slot * c + pb.prio_class.long(),
                                      torch.where(committed[:, None], pb.req, 0))
    if not nonzero:
        return f_class, None
    f_nz = nt.nonzero_requested.clone(memory_format=torch.contiguous_format)
    f_nz.index_add_(0, slot, torch.where(committed[:, None], pb.nonzero_req, 0))
    return f_class, f_nz


def _sample_window(feasible: torch.Tensor, start: torch.Tensor, sample_k: int,
                   valid: torch.Tensor, nominated: torch.Tensor, iota: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """percentageOfNodesToScore's rotating window (``kubernetes_tpu/backend/
    batch.py:1245-1273``; schedule_one.go:475-545): only the first
    ``sample_k`` feasible slots in the order rotated to ``start`` stay
    eligible, and the start moves past every slot examined (all of them
    when fewer than ``sample_k`` are feasible). A padding pod examines
    nothing. The nominated slot is always eligible. Returns (feasible
    within the window, the next start)."""
    n = feasible.shape[0]
    perm = ((start + iota) % n).long()                 # rotated order -> slot
    f_rot = feasible[perm]
    c = torch.cumsum(f_rot.to(torch.int32), 0, dtype=torch.int32)
    elig_rot = f_rot & (c <= sample_k)
    eligible = elig_rot[((iota - start) % n).long()]  # the inverse rotation
    hit = c >= sample_k
    kth = torch.argmax(hit.to(torch.int32)).to(torch.int32)  # the first reaching k
    processed = torch.where(torch.any(hit), kth + 1, n)
    start = torch.where(valid, (start + processed) % n, start)
    eligible = eligible | (iota == nominated)
    return feasible & eligible, start


def _topology_scan(pb: PodBatch, et: ExprTable, nt: NodeTensors, weights: Dict[str, float],
                   tc: Optional[TopoCounts], tb: Optional[TopoBatch], topo_mode: str,
                   vd_override: Optional[int], host_key: int, static,
                   sample_k: Optional[int] = None,
                   sample_start: Optional[torch.Tensor] = None,
                   topo_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   mesh=None) -> BatchResult:
    """The XLA scan ``step`` (``kubernetes_tpu/backend/batch.py:1202-1392``)
    as a loop over the batch's pods on device tensors: the fit against the
    carried free resources with the ``req == 0`` sentinel, ports, spread
    and inter-pod affinity against the carried counts (modes ``host`` and
    ``general``; mode ``off`` has neither), the sampling window when
    ``sample_k`` is given (its start carried from ``sample_start``, a 0-d
    int32 tensor, default 0, and returned as ``final_sample_start``), the
    scores normalized over the pod's feasible set, the nominated-node
    bonus, the first-maximum argmax, and the commit of the winner to every
    carry. ``topo_carry`` (sel_counts, seg_exist) starts the count carries
    from an earlier batch's final ones in place of ``tc``'s. Nothing in
    the loop reads a device value on the host.

    Under a ``mesh`` the node axis is this rank's window and each step
    picks the global winner (``:1301-1320``) with one all-gather of every
    rank's best (``topology._gfirst_max``): the lowest rank holding the
    maximum owns it, and its row carries the global slot, the score,
    ``any_feasible`` and, in mode general, the winner's domain column. Only
    the owning rank (``mine``) commits the winner to its node columns. The
    sampling window stays single-device."""
    (static_masks, static_ok, static_ff, taint_raw, affinity_raw, image_score,
     jitter) = static
    w = {k: float(np.float32(v)) for k, v in weights.items()}
    n = nt.capacity
    device = nt.valid.device
    offset = _slot_offset(nt, mesh)
    n_global = n if mesh is None else n * mesh.world
    iota = torch.arange(n, dtype=torch.int32, device=device)
    affinity_ok = static_masks["NodeAffinity"]
    pod_bits = _pod_port_bits(pb, nt.port_bits.shape[1])
    alloc2 = nt.allocatable[:, :2].to(torch.float32)
    topo_on = topo_mode != "off"
    host = topo_mode == "host"
    # the value-id domain axis: the involved keys' vocab bucket when the
    # caller computed it, else the full per-key vocab padding
    vd = vd_override if vd_override else int(et.bits.shape[1]) * 32
    sel = seg_exist = None
    if host:
        hostkey_ok = nt.label_val[:, host_key] > 0          # [N] node has a hostname
        seg_exist = tc.term_counts                           # [T, N] per-node counts
    elif topo_on:
        static_topo = topology.make_static(tc.term_counts, tc.term_key, nt.label_val,
                                           nt.valid, vd, mesh)
        seg_exist = static_topo.seg_exist0                   # [T, Vd] domain counts
    if topo_on:
        log_tbl = topology.size_log_table(max(n_global, vd) + 1, device)
        sel = tc.sel_counts
        if topo_carry is not None:
            sel, seg_exist = topo_carry
        tb_fields = {f.name: getattr(tb, f.name) for f in dataclasses.fields(tb)}
    start = None
    if sample_k is not None:
        start = (sample_start.to(device=device, dtype=torch.int32) if sample_start is not None
                 else torch.zeros((), dtype=torch.int32, device=device))
    all_ok = torch.ones(n, dtype=torch.bool, device=device)

    # `req == 0 always fits` as a sentinel, so fit is one compare and reduce
    req_gate = torch.where(pb.req == 0, -(2 ** 30), pb.req)
    free = nt.allocatable - nt.requested
    nz2 = nt.nonzero_requested[:, :2]
    ports = nt.port_bits
    outs = []
    for p in range(pb.capacity):
        fit_ok = torch.all(free >= req_gate[p][None, :], dim=1)
        ports_ok = ~torch.any((ports & pod_bits[p][None, :]) != 0, dim=1)
        spread_ok = ipa_ok = all_ok
        if host:
            xs = {k: v[p] for k, v in tb_fields.items()}
            spread_ok = topology.spread_filter_host(xs, sel, hostkey_ok, nt.valid,
                                                    affinity_ok[p], mesh)
            aff_ok, anti_ok, exist_ok, exist_at = topology.ipa_filter_host(
                xs, sel, seg_exist, hostkey_ok, nt.valid, mesh)
            ipa_ok = aff_ok & anti_ok & exist_ok
        elif topo_on:
            xs = {k: v[p] for k, v in tb_fields.items()}
            spread_ok = topology.spread_filter(xs, sel, nt.label_val, nt.valid,
                                               affinity_ok[p], vd, mesh)
            aff_ok, anti_ok, exist_ok, exist_at = topology.ipa_filter(
                xs, sel, seg_exist, static_topo.dom_t, nt.label_val, nt.valid, vd, mesh)
            ipa_ok = aff_ok & anti_ok & exist_ok
        feasible = static_ok[p] & fit_ok & ports_ok & spread_ok & ipa_ok
        if sample_k is not None:
            feasible, start = _sample_window(feasible, start, sample_k, pb.valid[p],
                                             pb.nominated[p], iota)

        # resource scores on the evolving nonzero request (int32 add first)
        least_alloc, balanced = _resource_scores(
            alloc2, (nz2 + pb.nonzero_req[p, :2][None, :]).to(torch.float32))
        total = (w["NodeResourcesFit"] * least_alloc
                 + w["NodeResourcesBalancedAllocation"] * balanced
                 + w["TaintToleration"] * _normalize(taint_raw[p], feasible, True, mesh=mesh)
                 + w["NodeAffinity"] * _normalize(affinity_raw[p], feasible, False, mesh=mesh)
                 + w["ImageLocality"] * image_score[p])
        if host:
            spread = topology.spread_score_host(xs, sel, hostkey_ok, nt.valid,
                                                affinity_ok[p], feasible, log_tbl, mesh)
            ipa = topology.ipa_score_host(xs, sel, exist_at, hostkey_ok, feasible, mesh)
        elif topo_on:
            spread = topology.spread_score(xs, sel, nt.label_val, nt.valid, affinity_ok[p],
                                           feasible, vd, log_tbl, mesh)
            ipa = topology.ipa_score(xs, sel, exist_at, nt.label_val, nt.valid, feasible, vd,
                                     mesh)
        if topo_on:
            total = total + w["PodTopologySpread"] * spread
            total = total + w["InterPodAffinity"] * ipa

        # the nominated node wins outright when feasible (schedule_one.go:394)
        is_nom = (iota + offset == pb.nominated[p]).to(torch.float32)
        eff = torch.where(feasible, total + jitter[p] + is_nom * NOMINATED_BONUS, NEG_INF)
        idx = torch.argmax(eff)                              # the first maximum wins
        # under a mesh the global first maximum, the owner's row: its global
        # slot, score, feasibility (a feasible node's eff beats NEG_INF, so
        # the owner has one when any rank has) and, in mode general, its
        # winner's domain column
        dom_col = ((static_topo.dom_t.index_select(1, idx.view(1))[:, 0],)
                   if topo_on and not host and mesh is not None else ())
        (win, best, any_feasible, *dom_col), mine = topology._gfirst_max(
            eff.index_select(0, idx.view(1))[0], mesh, idx.to(torch.int32) + offset,
            total.index_select(0, idx.view(1))[0], torch.any(feasible), *dom_col)
        any_feasible = any_feasible & pb.valid[p]

        commit = any_feasible if mine is None else any_feasible & mine
        onehot = (iota == idx) & commit                      # [N]
        free = free - onehot[:, None].to(torch.int32) * pb.req[p][None, :]
        nz2 = nz2 + onehot[:, None].to(torch.int32) * pb.nonzero_req[p, :2][None, :]
        ports = torch.where(onehot[:, None], ports | pod_bits[p][None, :], ports)
        if host:
            sel, seg_exist = topology.commit_update_host(
                sel, seg_exist, idx, any_feasible, xs["pod_sig_mask"], xs["pod_term_mask"],
                mine)
        elif topo_on:
            sel, seg_exist = topology.commit_update(
                sel, seg_exist, static_topo.dom_t, idx, any_feasible, xs["pod_sig_mask"],
                xs["pod_term_mask"], mine, *dom_col)
        ff = static_ff[p]
        for fid, ok in ((5, ports_ok), (6, fit_ok), (SPREAD_FAIL_ID, spread_ok),
                        (IPA_FAIL_ID, ipa_ok)):
            ff = torch.where((ff == 0) & ~ok, fid, ff)
        outs.append((torch.where(any_feasible, win, -1), best, any_feasible,
                     fit_ok, ports_ok, spread_ok, ipa_ok, ff))

    (node_idx, best, any_feasible, fit_ok, ports_ok, spread_ok, ipa_ok,
     first_fail) = (torch.stack(col) for col in zip(*outs))
    f_class, f_nz = _commit_scatters(nt, pb, node_idx, nonzero=True, slot_offset=offset)
    return BatchResult(
        node_idx=node_idx, best_score=best, any_feasible=any_feasible,
        static_masks=static_masks, fit_ok=fit_ok, ports_ok=ports_ok, spread_ok=spread_ok,
        ipa_ok=ipa_ok, first_fail=first_fail, final_requested=nt.allocatable - free,
        final_nonzero=f_nz, final_ports=ports, final_class_req=f_class,
        final_sel_counts=sel, final_seg_exist=seg_exist, final_sample_start=start)


def _whole_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for operands that hold whole numbers, in float64: exact in
    any summation order while the partial sums stay below 2**53 (counts
    and weights here are far below). cuBLAS has no int32 GEMM, and a float32
    GEMM would depend on the process-wide TF32 setting. The caller casts
    the result back to the JAX program's dtype."""
    return a.to(torch.float64) @ b.to(torch.float64)


def _by_node(n: int, choice: torch.Tensor, rows: torch.Tensor,
             take: torch.Tensor) -> torch.Tensor:
    """[N, K]: row p of ``rows`` ([P, K]) at node ``choice[p]`` for every pod
    with ``take[p]``, zero elsewhere. The taken pods' picks are distinct
    nodes, so each node receives at most one row: the JAX code's one-hot
    sum, and for uint32 port bits (held in int32) their bitwise or. An int
    ``index_add_``, so the same on every device and in any order."""
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, choice, torch.where(take[:, None], rows, 0))


# rounds of the speculative decode run on any device; each reads one flag on
# the host. Counted like fused_step.LAUNCHES, for chip_smoke.py and the tests.
ROUNDS = 0


def _speculative_core(pb: PodBatch, nt: NodeTensors, weights: Dict[str, float], static,
                      pod_bits: torch.Tensor, sel0=None, seg0=None, host=None, gen=None,
                      ports_enabled: bool = True, mesh=None) -> BatchResult:
    """Speculative decode, single device (the JAX package's
    ``backend/batch.py:_speculative_core``): a few vectorized decide/repair
    rounds over all the batch's pods in place of the P dependent steps, with
    the scan's sequential semantics exactly.

    Each round every unplaced pod scores every node against the current
    state and picks its argmax; the lowest pod index per chosen node wins
    it. A winner is stable when its argmax is unmoved in its SEQUENTIAL
    view: the round-start state with the commits of lower-index winners
    mixed in on their nodes (the "rival" nodes; picks are distinct, so each
    carries one delta), normalized again per pod. The round finalizes only
    the prefix of pods before the first active pod that is neither a stable
    winner nor a failing pod before the round's first winner, so every
    finalized pod saw exactly the commits of the pods before it.

    ``host`` (the hostname topology mode) mixes the node-local [S, N] and
    [T, N] count tables the same way: keys tb (the TopoBatch field dict),
    hostkey_ok [N], affinity_ok [P, N]. ``gen`` (the general mode) mixes
    the [S, N] table and re-sums each pod's domains from it; its [T, Vd]
    per-domain term table cannot be mixed, so a winner that an earlier
    winner's term commit could touch waits for the next round: keys tb,
    affinity_ok, vd, dom_t [T, N]. Without either the batch is mode
    ``off``. ``ports_enabled`` False skips the [P, N, W] port conflict (no
    pod of the batch wants a host port).

    The loop's condition is a device value: the host reads it once per
    round (``ROUNDS`` counts the rounds), and the batch reads the device
    nowhere else. The first round runs before the first read; on a batch
    with no valid pod it changes nothing and is not counted, so such a
    batch runs zero rounds, as the JAX ``while_loop`` does. The loop stops
    after a round that finalizes no pod, as there.

    Under a ``mesh`` (``:357-460``) the node-axis state is this rank's
    window and every [P] decision vector is made global by an elementwise
    collective: each pod's pick is the global first maximum (its slot id
    global, ``mine`` on the owning rank), a node's lowest contender is
    found on the rank that owns it, the per-pod reductions of the filters,
    scores and normalizations run over every rank, and only the owner
    applies a commit to its node columns (the general mode's replicated
    [T, Vd] table takes every commit on every rank). So every rank runs the
    same rounds and finalizes the same prefix."""
    global ROUNDS
    (static_masks, static_ok, static_ff, taint_raw, affinity_raw, image_score,
     jitter) = static
    P, N = pb.capacity, nt.capacity
    device = nt.valid.device
    offset = _slot_offset(nt, mesh)
    n_global = N if mesh is None else N * mesh.world
    alloc2 = nt.allocatable[:, :2].to(torch.float32)
    iota_p = torch.arange(P, dtype=torch.int64, device=device)
    iota_n = torch.arange(N, dtype=torch.int32, device=device)
    is_nom = (iota_n[None, :] + offset == pb.nominated[:, None]).to(torch.float32)  # [P, N]
    w = {k: float(np.float32(v)) for k, v in weights.items()}
    req_gate = torch.where(pb.req == 0, -(2 ** 30), pb.req)  # `req == 0 always fits`
    valid_n = nt.valid
    topo_on = host is not None or gen is not None
    # Everything a round reads that no commit can change (node labels, the
    # pods' programs) is built once here; each round then gathers the count
    # rows once and shares them, and the existing-term contractions, between
    # its round-start and its mixed view.
    if topo_on:
        spec = host if host is not None else gen
        tbx, affinity_ok = spec["tb"], spec["affinity_ok"]
        sig_mask = tbx["pod_sig_mask"].to(torch.int32)                     # [P, S]
        term_mask = tbx["pod_term_mask"].to(torch.int32)                   # [P, T]
        m_filter = tbx["term_filter_match"]                                # [P, T]
        tsw = tbx["term_score_w"]                                          # [P, T] f32
        vd = gen["vd"] if gen is not None else 0
        log_tbl = topology.size_log_table(max(n_global, vd) + 1, device)
        kinds = ("sf", "ia", "ianti", "ss", "ip")
        rows = {k: tbx[f"{k}_sig"].reshape(-1).long() for k in kinds}

        def v3(name):
            return tbx[name][:, :, None]

        def gather_rows(table):
            """{kind: [P, C, N] rows of an [S, N] count table}."""
            return {k: table.index_select(0, r).view(P, -1, N) for k, r in rows.items()}

        sf_valid, sf_self, sf_skew = v3("sf_valid"), v3("sf_self").to(torch.int32), v3("sf_skew")
        min_dom = tbx["sf_min_domains"]
        ia_valid = v3("ia_valid")
        no_ia = ~torch.any(tbx["ia_valid"], dim=1)[:, None]
        ss_skew1 = v3("ss_skew").to(torch.float32) - 1.0
        ss_has_cons = torch.any(tbx["ss_valid"], dim=1)[:, None]
        ip_w = v3("ip_w").to(torch.float32)
    if host is not None:
        hostkey_ok = host["hostkey_ok"]
        hk_i = hostkey_ok.to(torch.int32)[None, :]
        hk3 = hostkey_ok[None, None, :]
        elig_sf = valid_n[None, :] & affinity_ok & hostkey_ok[None, :]   # & active
        all_keys = torch.all(torch.where(ia_valid, hk3, True), dim=1)
        ia_total_mask = ia_valid & valid_n[None, None, :] & hk3
        anti_mask = v3("ianti_valid") & hk3
        ignored = tbx["ss_require_all"][:, None] & ~hostkey_ok[None, :]   # [P, N]
        ss_mask = v3("ss_valid") & hk3
        ip_mask = v3("ip_valid") & hk3
    if gen is not None:
        dom_t = gen["dom_t"]                                               # [T, N] int64
        label_val_t = nt.label_val.t().contiguous()                        # [L, N]
        # [P, C, N] int64 domain id of every node under each program's key
        dom = {k: label_val_t.index_select(0, tbx[f"{k}_key"].reshape(-1).long()).view(
            P, -1, N).long() for k in kinds}
        has = {k: d > 0 for k, d in dom.items()}
        has_all_sf = torch.all(torch.where(sf_valid, has["sf"], True), dim=1)
        elig_sf = valid_n[None, :] & affinity_ok & has_all_sf               # & active
        all_keys = torch.all(torch.where(ia_valid, has["ia"], True), dim=1)
        valid3 = valid_n[None, None, :]
        ia_add, an_add, ip_add = (valid3 & has[k] for k in ("ia", "ianti", "ip"))
        anti_mask = v3("ianti_valid") & has["ianti"]
        has_all_ss = torch.all(torch.where(v3("ss_valid"), has["ss"], True), dim=1)
        require_all = tbx["ss_require_all"][:, None]
        ignored = require_all & ~has_all_ss                                  # [P, N]
        ss_add = (valid_n[None, :] & affinity_ok
                  & torch.where(require_all, has_all_ss, True))[:, None, :] & has["ss"]
        ss_mask = v3("ss_valid") & has["ss"]
        ss_host = v3("ss_hostname")
        ip_mask = v3("ip_valid") & has["ip"]
        abs_tsw = torch.abs(tsw)
        j_lt_i = iota_p[None, :] < iota_p[:, None]

        def seg_at(values, k):
            """Per-pod domain sums [P, C, Vd] of ``values`` under kind k's keys
            (over every rank), and each node's own domain's sum [P, C, N]."""
            seg = topology._seg_sum(values, dom[k], vd, mesh)
            return seg, torch.gather(seg, 2, dom[k])

    def global_argmax(eff, feasible, *cols):
        """Each pod's first maximum over the global node axis: (choice, its
        global slot; local, its column here; mine, [P] True where this rank
        owns the pick; any_f, a feasible node on any rank; ``cols`` [P, k, N]
        at the pick, from its owner). Ties go to the lowest rank, then the
        first local maximum: the single-device pick. Under a mesh one
        all-gather (``topology._gfirst_max``); the owner has a feasible node
        when any rank has, as a feasible node's eff beats NEG_INF."""
        local = torch.argmax(eff, dim=1)
        at = [torch.gather(c, 2, local[:, None, None].expand(-1, c.shape[1], 1))[..., 0]
              for c in cols]
        (choice, any_f, *at), mine = topology._gfirst_max(
            pick(eff, local), mesh, local + offset, torch.any(feasible, dim=1), *at)
        if mine is None:
            mine = torch.ones((P,), dtype=torch.bool, device=device)
        return choice, local, mine, any_f, at

    def spread_score(cnt, w_log, mask, base_mask):
        """The rounded raw spread score [P, N] from float counts [P, C, N],
        normalized per pod (the constraint axis summed in XLA's order)."""
        contrib = torch.where(mask, cnt * w_log + ss_skew1, 0.0)
        raw = torch.floor(topology._fold_sum(contrib, dim=1) + 0.5)
        return topology._spread_normalize(raw, base_mask, ignored, ss_has_cons, dim=1,
                                          mesh=mesh)

    def eval_host(cnt, viol, active):
        """Host mode: spread and inter-pod affinity filters [P, N] from a view's
        counts ({kind: [P, C, N]}) and existing-term violations ``viol``."""
        elig = elig_sf & active[:, None]   # `active` only masks finalized pods
        minm = _gmin(torch.amin(torch.where(elig[:, None, :], cnt["sf"], topology.INT_MAX),
                                dim=2), mesh)
        ndom = _gsum(torch.sum(elig, dim=1, dtype=torch.int32), mesh)            # [P]
        minm = torch.where((ndom > 0)[:, None], minm, 0)
        minm = torch.where((min_dom >= 0) & (ndom[:, None] < min_dom), 0, minm)
        ok_c = hk3 & (cnt["sf"] + sf_self - minm[:, :, None] <= sf_skew)
        spread_ok = torch.all(torch.where(sf_valid, ok_c, True), dim=1)
        pods_exist = torch.all(torch.where(ia_valid, hk3 & (cnt["ia"] > 0), True), dim=1)
        total = _gsum(torch.sum(torch.where(ia_total_mask, cnt["ia"], 0), dim=(1, 2),
                                dtype=torch.int32), mesh)                        # [P]
        first_ok = (total == 0) & tbx["ia_self_all"]
        aff_ok = no_ia | (all_keys & (pods_exist | first_ok[:, None]))
        anti_ok = ~torch.any(anti_mask & (cnt["ianti"] > 0), dim=1)
        return spread_ok, aff_ok & anti_ok & (viol == 0)

    def scores_host(cnt, sym, feasible):
        """Host mode: spread and inter-pod affinity scores [P, N], normalized
        per pod over its feasible set."""
        base_mask = feasible & ~ignored
        w_log = log_tbl.index_select(0, _gsum(torch.sum(base_mask, dim=1), mesh))[:, None, None]
        spread = spread_score(cnt["ss"].to(torch.float32), w_log, ss_mask, base_mask)
        pref = torch.sum(torch.where(ip_mask, ip_w * cnt["ip"].to(torch.float32), 0.0), dim=1)
        return spread, topology._ipa_normalize(pref + sym, feasible, dim=1, mesh=mesh)

    def eval_gen(cnt, viol, active):
        """General mode: the filters [P, N], every count-derived quantity
        summed again per pod over its domains from the view's counts."""
        elig = elig_sf & active[:, None]
        seg, cnt_at = seg_at(torch.where(elig[:, None, :] & has["sf"], cnt["sf"], 0), "sf")
        pres = topology._seg_sum(elig[:, None, :].expand(dom["sf"].shape), dom["sf"], vd,
                                 mesh) > 0
        minm = torch.amin(torch.where(pres, seg, topology.INT_MAX), dim=2)        # [P, C]
        minm = torch.where(torch.any(pres, dim=2), minm, 0)
        ndom = torch.sum(pres, dim=2, dtype=torch.int32)
        minm = torch.where((min_dom >= 0) & (ndom < min_dom), 0, minm)
        ok_c = has["sf"] & (cnt_at + sf_self - minm[:, :, None] <= sf_skew)
        spread_ok = torch.all(torch.where(sf_valid, ok_c, True), dim=1)
        seg_ia, at_ia = seg_at(torch.where(ia_add, cnt["ia"], 0), "ia")
        pods_exist = torch.all(torch.where(ia_valid, at_ia > 0, True), dim=1)
        total = torch.sum(torch.where(ia_valid, seg_ia, 0), dim=(1, 2), dtype=torch.int32)
        first_ok = (total == 0) & tbx["ia_self_all"]
        aff_ok = no_ia | (all_keys & (pods_exist | first_ok[:, None]))
        _, at_an = seg_at(torch.where(an_add, cnt["ianti"], 0), "ianti")
        anti_ok = ~torch.any(anti_mask & (at_an > 0), dim=1)
        return spread_ok, aff_ok & anti_ok & (viol == 0)

    def scores_gen(cnt, sym, feasible):
        """General mode: the scores [P, N]."""
        base_mask = feasible & ~ignored
        pres = topology._seg_sum(base_mask[:, None, :].expand(dom["ss"].shape), dom["ss"], vd,
                                 mesh) > 0
        sz = torch.where(tbx["ss_hostname"], _gsum(torch.sum(base_mask, dim=1), mesh)[:, None],
                         torch.sum(pres, dim=2))                                  # [P, C]
        w_log = log_tbl.index_select(0, sz.reshape(-1)).view(sz.shape)[:, :, None]
        _, at_ss = seg_at(torch.where(ss_add, cnt["ss"], 0), "ss")
        spread = spread_score(torch.where(ss_host, cnt["ss"], at_ss).to(torch.float32), w_log,
                              ss_mask, base_mask)
        _, at_ip = seg_at(torch.where(ip_add, cnt["ip"], 0), "ip")
        pref = torch.sum(torch.where(ip_mask, ip_w * at_ip.to(torch.float32), 0.0), dim=1)
        return spread, topology._ipa_normalize(pref + sym, feasible, dim=1, mesh=mesh)

    if host is not None:
        t_eval, t_scores = eval_host, scores_host
    elif gen is not None:
        t_eval, t_scores = eval_gen, scores_gen

    def components(req_dyn, nz_dyn, port_dyn):
        """State-dependent per-(pod, node) pieces: fit, ports, LeastAllocated
        and BalancedAllocation, [P, N] each."""
        free = nt.allocatable - req_dyn                                          # [N, R]
        fit = torch.all(free[None, :, :] >= req_gate[:, None, :], dim=2)
        if ports_enabled:
            ports = ~torch.any((port_dyn[None, :, :] & pod_bits[:, None, :]) != 0, dim=2)
        else:
            ports = torch.ones_like(fit)
        nz = (nz_dyn[None, :, :2].to(torch.float32)
              + pb.nonzero_req[:, None, :2].to(torch.float32))                   # [P, N, 2]
        least_alloc, balanced = _resource_scores(alloc2[None, :, :], nz)
        return fit, ports, least_alloc, balanced

    def assemble(fit, ports, least_alloc, balanced, active, view=None):
        """(eff with jitter and the nominated bonus, feasible, total,
        spread_ok, ipa_ok), each [P, N]: the scores normalized per pod over
        its feasible set, in the scan step's order. ``view`` (topology
        modes): (counts {kind: [P, C, N]}, existing-term violations [P, N],
        symmetric existing-term score [P, N]) as one view sees them."""
        feasible = static_ok & fit & ports & active[:, None]
        spread_ok = ipa_ok = None
        if topo_on:
            cnt, viol, sym = view
            spread_ok, ipa_ok = t_eval(cnt, viol, active)
            feasible = feasible & spread_ok & ipa_ok
        total = (w["NodeResourcesFit"] * least_alloc
                 + w["NodeResourcesBalancedAllocation"] * balanced
                 + w["TaintToleration"] * _normalize(taint_raw, feasible, True, dim=1, mesh=mesh)
                 + w["NodeAffinity"] * _normalize(affinity_raw, feasible, False, dim=1,
                                                  mesh=mesh)
                 + w["ImageLocality"] * image_score)
        if topo_on:
            spread, ipa = t_scores(cnt, sym, feasible)
            total = total + w["PodTopologySpread"] * spread + w["InterPodAffinity"] * ipa
        eff = torch.where(feasible, total + jitter + is_nom * NOMINATED_BONUS, NEG_INF)
        return eff, feasible, total, spread_ok, ipa_ok

    def pick(rows, col):
        """rows[p, col[p]] for every pod."""
        return torch.gather(rows, 1, col[:, None])[:, 0]

    req_dyn, nz_dyn, port_dyn = nt.requested, nt.nonzero_requested, nt.port_bits
    sel_dyn, term_dyn = sel0, seg0
    done = ~pb.valid
    out_idx = torch.full((P,), -1, dtype=torch.int32, device=device)
    best = torch.zeros((P,), dtype=torch.float32, device=device)
    anyf_out = torch.zeros((P,), dtype=torch.bool, device=device)
    fit_out = ports_out = spread_out = ipa_out = torch.ones((P, N), dtype=torch.bool,
                                                            device=device)
    ff_out = static_ff
    any_valid = torch.any(pb.valid)
    first = True
    while True:
        active = ~done & pb.valid
        fit, ports, la, bal = components(req_dyn, nz_dyn, port_dyn)
        view = None
        if host is not None:
            cnt0 = gather_rows(sel_dyn)
            term_hk = term_dyn * hk_i
            view = (cnt0, _whole_matmul(m_filter, term_hk),
                    _whole_matmul(tsw, term_hk).to(torch.float32))
        elif gen is not None:
            # the existing-term checks read the round-start [T, Vd] table in
            # both views (the deferral below covers what they cannot see)
            cnt0 = gather_rows(sel_dyn)
            exist_at = torch.where(dom_t > 0, torch.gather(term_dyn, 1, dom_t), 0)  # [T, N]
            view = (cnt0, _whole_matmul(m_filter, exist_at),
                    _whole_matmul(tsw, exist_at).to(torch.float32))
        eff, feasible, _total, _sp, _ip = assemble(fit, ports, la, bal, active, view)
        # first maximum; 0 on an all-NEG_INF row. ``choice`` is the global
        # slot, ``local`` its column on the rank that owns it (``mine``);
        # in mode general ``dcol`` [P, T] is the pick's domain per term
        choice, local, mine, any_f, dcol = global_argmax(
            eff, feasible, *(() if gen is None else (dom_t[None].expand(P, -1, -1),)))
        failing = active & ~any_f

        # tentative winners: the lowest pod index per chosen node, found on
        # the rank that owns the node
        contender = active & any_f
        win = torch.full((N,), P, dtype=torch.int64, device=device).scatter_reduce_(
            0, local, torch.where(contender & mine, iota_p, P), "amin", include_self=True)
        accepted = _gmax(contender & mine & (torch.gather(win, 0, local) == iota_p), mesh)
        owned = accepted & mine

        # each winner's sequential view: the commits of lower-index winners
        # on their nodes (rivals), round-start state elsewhere
        d_req = _by_node(N, local, pb.req, owned)
        d_nz = _by_node(N, local, pb.nonzero_req, owned)
        port_mixed = port_dyn
        if ports_enabled:
            port_mixed = port_dyn | _by_node(N, local, pod_bits, owned)
        fit2, ports2, la2, bal2 = components(req_dyn + d_req, nz_dyn + d_nz, port_mixed)
        # node n is a rival of pod p when a winner j < p committed there
        # (win[n] < P exactly on the nodes some winner took)
        rival = win[None, :] < iota_p[:, None]                                   # [P, N]
        view_mix = None
        if topo_on:
            # the winners' count columns on their nodes, on each pod's rivals
            rival_i = rival.to(torch.int32)
            d_cnt = gather_rows(_by_node(N, local, sig_mask, owned).t())         # [S, N] rows
            cnt_mix = {k: cnt0[k] + d_cnt[k] * rival_i[:, None, :] for k in kinds}
            _, viol, sym = view
            if host is not None:
                cterm_hk = _by_node(N, local, term_mask, owned).t() * hk_i       # [T, N]
                viol = viol + _whole_matmul(m_filter, cterm_hk) * rival_i
                sym = sym + _whole_matmul(tsw, cterm_hk).to(torch.float32) * rival_i
            view_mix = (cnt_mix, viol, sym)
        fit_mix = torch.where(rival, fit2, fit)
        ports_mix = torch.where(rival, ports2, ports)
        eff_mix, feas_mix, tot_mix, sp_mix, ip_mix = assemble(
            fit_mix, ports_mix, torch.where(rival, la2, la), torch.where(rival, bal2, bal),
            active, view_mix)
        choice_mix = global_argmax(eff_mix, feas_mix)[0]
        # the round-start pick's mixed feasibility and score, from its owner
        feas_pick, best_pick = topology._gowned(mine, mesh, mine & pick(feas_mix, local),
                                                pick(tot_mix, local))
        # an infeasible-in-mix winner defers: argmax over an all-NEG_INF row
        # is 0, which would read as stable for a pod whose choice was slot 0
        unstable = accepted & ((choice_mix != choice) | ~feas_pick)
        if gen is not None:
            # a winner whose view an earlier winner's term commit could touch
            # waits a round: add_term[t, j] = accepted j adds term t at a keyed
            # domain; interaction = pod i's anti match or symmetric weight on t.
            # dcol is each pick's domain, read on its owner
            dcol = dcol[0].t()                                                   # [T, P]
            add_term = term_mask.t() * (dcol > 0) * accepted[None, :]            # [T, P]
            interacts = (_whole_matmul(m_filter, add_term) > 0) | (
                _whole_matmul(abs_tsw, add_term) > 0)                             # [P(i), P(j)]
            unstable = unstable | (accepted & torch.any(interacts & j_lt_i, dim=1))
        # decision-time rows: the mixed values are each pod's sequential view
        ff_mix = static_ff
        for fid, ok in ((5, ports_mix), (6, fit_mix), (SPREAD_FAIL_ID, sp_mix),
                        (IPA_FAIL_ID, ip_mix)):
            if ok is not None:
                ff_mix = torch.where((ff_mix == 0) & ~ok, fid, ff_mix)

        # strict prefix: a failing pod finalizes only before the round's
        # first winner, and the cut lands at the first active pod that
        # cannot finalize
        a_min = torch.amin(torch.where(accepted, iota_p, P))
        failing = failing & (iota_p < a_min)
        blocked = active & ~(failing | (accepted & ~unstable))
        in_prefix = iota_p < torch.amin(torch.where(blocked, iota_p, P))
        failing = failing & in_prefix
        accepted = accepted & ~unstable & in_prefix

        # apply the finalized prefix (each pick on the rank that owns it)
        owned = accepted & mine
        req_dyn = req_dyn + _by_node(N, local, pb.req, owned)
        nz_dyn = nz_dyn + _by_node(N, local, pb.nonzero_req, owned)
        if ports_enabled:
            port_dyn = port_dyn | _by_node(N, local, pod_bits, owned)
        if topo_on:
            sel_dyn = sel_dyn + _by_node(N, local, sig_mask, owned).t()
        if host is not None:
            term_dyn = term_dyn + _by_node(N, local, term_mask, owned).t()
        elif gen is not None:
            # each finalized pod's terms land at its node's domains (the
            # deferral block's dcol: the same picks)
            t_rows = torch.arange(dom_t.shape[0], device=device)[:, None] * vd
            add_f = term_mask.t() * (dcol > 0) * accepted[None, :]               # [T, P]
            term_dyn = term_dyn.flatten().scatter_add(
                0, (t_rows + dcol).flatten(), add_f.flatten()).view(term_dyn.shape)
        final = accepted | failing
        out_idx = torch.where(accepted, choice.to(torch.int32), out_idx)
        best = torch.where(final, best_pick, best)
        anyf_out = torch.where(final, accepted, anyf_out)
        fit_out = torch.where(final[:, None], fit_mix, fit_out)
        ports_out = torch.where(final[:, None], ports_mix, ports_out)
        if topo_on:
            spread_out = torch.where(final[:, None], sp_mix, spread_out)
            ipa_out = torch.where(final[:, None], ip_mix, ipa_out)
        ff_out = torch.where(final[:, None], ff_mix, ff_out)
        done = done | final
        more = torch.any(~done & pb.valid) & torch.any(final)
        if first:
            # the one host read of the round; the first also says whether
            # the batch had a valid pod (else this round changed nothing)
            flags = int((any_valid.to(torch.int32) * 2 + more.to(torch.int32)).item())
            first = False
            if flags < 2:
                break
            more_h = bool(flags & 1)
        else:
            more_h = bool(more.item())
        ROUNDS += 1
        if not more_h:
            break

    f_class, _ = _commit_scatters(nt, pb, out_idx, nonzero=False, slot_offset=offset)
    return BatchResult(
        node_idx=out_idx, best_score=best, any_feasible=anyf_out, static_masks=static_masks,
        fit_ok=fit_out, ports_ok=ports_out, spread_ok=spread_out, ipa_ok=ipa_out,
        first_fail=ff_out, final_requested=req_dyn, final_nonzero=nz_dyn, final_ports=port_dyn,
        final_class_req=f_class, final_sel_counts=sel_dyn if topo_on else None,
        final_seg_exist=term_dyn if topo_on else None)


def schedule_batch_core(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                        weights: Dict[str, float], tc: Optional[TopoCounts] = None,
                        tb: Optional[TopoBatch] = None, topo_mode: str = "off",
                        vd_override: Optional[int] = None, host_key: int = 0,
                        spec_decode: bool = False, ports_enabled: bool = True,
                        extra_mask: Optional[torch.Tensor] = None,
                        dra_mask: Optional[torch.Tensor] = None,
                        slice_mask: Optional[torch.Tensor] = None,
                        sample_k: Optional[int] = None,
                        sample_start: Optional[torch.Tensor] = None,
                        topo_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        mesh=None) -> BatchResult:
    """Static phase, the commit phase of ``topo_mode`` and the post-scan
    scatters. ``weights`` are the plugin weights by name (every key of
    DEFAULT_WEIGHTS). Modes ``host`` and ``general`` need ``tc`` and ``tb``;
    ``host_key`` is the hostname key slot (mode ``host``) and
    ``vd_override`` the domain-axis size (mode ``general``; default: the
    full value vocab). ``spec_decode`` runs the speculative rounds
    (``_speculative_core``) in place of the fused kernel or the scan;
    ``ports_enabled`` False tells them that no pod of the batch wants a host
    port; ``extra_mask``, ``dra_mask`` and ``slice_mask`` join the static
    phase on every path (the JAX names and meanings). ``sample_k`` (with the
    window's ``sample_start``) samples the batch: it takes the scan in every
    mode, as in the JAX package, never the kernel or the rounds.
    ``topo_carry`` is the cross-batch topology carry (``kubernetes_tpu/
    backend/batch.py:1139``, ``:1367``): (final_sel_counts,
    final_seg_exist) of the newest batch in flight, which replace ``tc``'s
    sel_counts and the initial seg_exist (the per-node term counts in mode
    ``host``, the per-domain ones in mode ``general``) on the scan and the
    rounds. ``mesh`` (``parallel/mesh.py``) runs this rank's share of the
    sharded program (``nt``, ``tc``'s count tables, the masks and
    ``topo_carry``'s node-axis tables are its window; ``node_idx`` holds
    global slots): the scan, or the rounds with ``spec_decode``, in every
    mode, never the fused kernel, and no sampling window."""
    if topo_mode not in TOPO_MODES:
        raise ValueError(f"topo_mode must be one of {TOPO_MODES}, not {topo_mode!r}")
    if spec_decode and sample_k is not None:
        raise ValueError("the speculative rounds have no sampling window: a sampled batch "
                         "takes the scan")
    if mesh is not None and sample_k is not None:
        raise ValueError("the sharded program has no sampling window")
    static = static_phase(pb, et, nt, extra_mask, dra_mask, slice_mask, mesh)
    if topo_mode != "off" and (tc is None or tb is None):
        raise ValueError(f"topo_mode {topo_mode!r} needs tc and tb")
    if spec_decode:
        pod_bits = _pod_port_bits(pb, nt.port_bits.shape[1])
        tb_fields = None if tb is None else {
            f.name: getattr(tb, f.name) for f in dataclasses.fields(tb)}
        affinity_ok = static[0]["NodeAffinity"]
        if topo_mode == "host":
            sel0, seg0 = topo_carry or (tc.sel_counts, tc.term_counts)
            return _speculative_core(
                pb, nt, weights, static, pod_bits, sel0, seg0,
                host=dict(tb=tb_fields, hostkey_ok=nt.label_val[:, host_key] > 0,
                          affinity_ok=affinity_ok), ports_enabled=ports_enabled, mesh=mesh)
        if topo_mode == "general":
            vd = vd_override if vd_override else int(et.bits.shape[1]) * 32
            static_topo = topology.make_static(tc.term_counts, tc.term_key, nt.label_val,
                                               nt.valid, vd, mesh)
            sel0, seg0 = topo_carry or (tc.sel_counts, static_topo.seg_exist0)
            return _speculative_core(
                pb, nt, weights, static, pod_bits, sel0, seg0,
                gen=dict(tb=tb_fields, affinity_ok=affinity_ok, vd=vd,
                         dom_t=static_topo.dom_t), ports_enabled=ports_enabled, mesh=mesh)
        return _speculative_core(pb, nt, weights, static, pod_bits,
                                 ports_enabled=ports_enabled, mesh=mesh)
    if topo_mode != "off" or sample_k is not None or mesh is not None:
        return _topology_scan(pb, et, nt, weights, tc, tb, topo_mode, vd_override,
                              host_key, static, sample_k, sample_start, topo_carry, mesh)
    (static_masks, static_ok, static_ff, taint_raw, affinity_raw, image_score,
     jitter) = static
    pod_bits = _pod_port_bits(pb, nt.port_bits.shape[1])
    out = fused_step_batch(
        nt.allocatable, nt.requested, nt.nonzero_requested, nt.port_bits,
        pb.req, pb.nonzero_req, pod_bits, static_ok.contiguous(),
        static_ff.contiguous(), taint_raw.contiguous(),
        affinity_raw.contiguous(), image_score.contiguous(),
        jitter.contiguous(), pb.nominated, pb.valid, weight_vector(weights))
    # nothing in the kernel reads the priority-class table
    f_class, _ = _commit_scatters(nt, pb, out.node_idx, nonzero=False)
    all_ok = torch.ones((), dtype=torch.bool, device=out.fit_ok.device).expand(out.fit_ok.shape)
    return BatchResult(
        node_idx=out.node_idx, best_score=out.best, any_feasible=out.any_feasible,
        static_masks=static_masks, fit_ok=out.fit_ok, ports_ok=out.ports_ok,
        spread_ok=all_ok, ipa_ok=all_ok, first_fail=out.first_fail,
        final_requested=out.requested, final_nonzero=out.nonzero, final_ports=out.ports,
        final_class_req=f_class)


def schedule_batch(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                   weights: Optional[Dict[str, float]] = None,
                   device: DeviceLike = None, tc: Optional[TopoCounts] = None,
                   tb: Optional[TopoBatch] = None, topo_mode: str = "off",
                   vd_override: Optional[int] = None, host_key: int = 0,
                   spec_decode: bool = False, ports_enabled: bool = True,
                   extra_mask: Optional[torch.Tensor] = None,
                   dra_mask: Optional[torch.Tensor] = None,
                   slice_members: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   slice_grid: Optional[Tuple[int, int]] = None,
                   quota_ns: Optional[np.ndarray] = None,
                   quota_req: Optional[torch.Tensor] = None,
                   quota_used: Optional[torch.Tensor] = None,
                   quota_limit: Optional[torch.Tensor] = None,
                   sample_k: Optional[int] = None,
                   sample_start: Optional[torch.Tensor] = None,
                   topo_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> BatchResult:
    """Schedule one encoded batch on ``device`` (default: the CUDA card;
    ``device="cpu"`` runs the plain versions). Every tensor input must
    already lie there, the masks included. The topology, ``spec_decode``,
    ``ports_enabled`` and mask arguments are those of
    ``schedule_batch_core``. ``slice_members`` ([G, M] member rows, [G, M]
    valid) and ``slice_grid`` (superpods, slots) run the slice plan ahead
    of the core, as the JAX ``schedule_batch`` does: its mask joins the
    static phase and its words the packed block. ``quota_ns`` ([P] int32
    namespace rows, on the host; ``ops/quota.build_quota_batch_args``),
    ``quota_req`` ([P, Q]) and the namespace rows ``quota_used`` /
    ``quota_limit`` ([NS, Q]) run the quota screen after the core, on
    every path: its words join the packed block after the slice words.
    ``sample_k`` and ``sample_start`` (a 0-d int32 tensor on ``device``,
    the last batch's ``final_sample_start``) sample the batch.
    ``topo_carry`` (on ``device``) is ``schedule_batch_core``'s. Returns
    the BatchResult with the packed block filled in."""
    device = resolve_device(device)
    member_idx, member_valid = slice_members if slice_members is not None else (None, None)
    check_on(device, valid=nt.valid, allocatable=nt.allocatable,
             pod_valid=pb.valid, pod_req=pb.req, expr_op=et.op,
             sel_counts=tc.sel_counts if tc is not None else None,
             tb_sf_valid=tb.sf_valid if tb is not None else None,
             extra_mask=extra_mask, dra_mask=dra_mask, slice_member_idx=member_idx,
             slice_member_valid=member_valid, quota_req=quota_req, quota_used=quota_used,
             quota_limit=quota_limit, sample_start=sample_start,
             carry_sel=topo_carry[0] if topo_carry is not None else None,
             carry_seg=topo_carry[1] if topo_carry is not None else None)
    slice_mask = slice_words = None
    if slice_members is not None and slice_grid is not None:
        slice_mask, slice_words = _slice_plan(pb, nt, slice_members, slice_grid)
    res = schedule_batch_core(pb, et, nt, {**DEFAULT_WEIGHTS, **(weights or {})}, tc, tb,
                              topo_mode, vd_override, host_key, spec_decode, ports_enabled,
                              extra_mask, dra_mask, slice_mask, sample_k, sample_start,
                              topo_carry)
    quota_words = None
    if quota_ns is not None and quota_used is not None:
        quota_words = quota_screen(res.node_idx, quota_ns, quota_req, quota_used, quota_limit)
    res.packed = pack_result_block(res.node_idx, res.first_fail, slice_words, quota_words)
    if (topo_mode == "off" and not spec_decode and sample_k is None
            and telemetry.get() is not None):
        # the cost ledger (``:1576-1583``): the fused kernel's bytes, from
        # its shapes, once per bucket
        telemetry.cost_probe("schedule_batch", f"{pb.capacity}/off", _fused_cost, (pb, nt))
    return res


def _fused_cost(pb: PodBatch, nt: NodeTensors) -> Dict[str, float]:
    n, r = nt.allocatable.shape
    return {"bytesAccessed": float(fused_step_bytes(pb.req.shape[0], n, r,
                                                    nt.port_bits.shape[1]))}


def _slice_plan(pb: PodBatch, nt: NodeTensors,
                slice_members: Tuple[torch.Tensor, torch.Tensor],
                slice_grid: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slice_mask [P, N] bool, slice_words [P] int32): the torus plan
    (``ops/slice.py``) lowered to the per-pod form the core and the packed
    block take (``kubernetes_tpu/backend/batch.py:1425-1452``). A non-member
    gets an all-True mask row and word 0; a member of a rejected gang an
    all-False row. Padding members write to a spill row past the batch,
    which is dropped; each member row is written once."""
    member_idx, member_valid = slice_members
    targets, ok = plan_slices(nt, pb.req, member_idx, member_valid, slice_grid)
    p, n = pb.capacity, nt.capacity
    act = member_valid.reshape(-1)
    tgt = targets.reshape(-1)
    okf = ok[:, None].expand(member_idx.shape).reshape(-1)
    rows = torch.where(act, member_idx.reshape(-1), p).long()
    iota = torch.arange(n, dtype=torch.int32, device=tgt.device)
    row_mask = (okf & (tgt >= 0))[:, None] & (iota[None, :] == tgt[:, None])
    mask = torch.ones((p + 1, n), dtype=torch.bool, device=tgt.device)
    mask = mask.index_put_((rows,), row_mask)[:p]
    word = (SLICE_MEMBER_BIT | torch.where(okf, SLICE_PLAN_OK_BIT, 0)
            | ((tgt + 1) << SLICE_TARGET_SHIFT)).to(torch.int32)
    words = torch.zeros(p + 1, dtype=torch.int32, device=tgt.device)
    words = words.index_put_((rows,), torch.where(act, word, 0))[:p]
    return mask, words


def gang_member_index(groups, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(member_idx [G, M] int32, member_valid [G, M] bool) on ``device`` for
    ``groups``, each a list of batch rows in batch order, with G and M
    bucketed to powers of two (floor 2) as the JAX scheduler's
    ``_judge_gangs`` and ``_slice_batch_args`` bucket them; -1 pads."""
    g_cap = _bucket(len(groups), floor=2)
    m_cap = _bucket(max(len(rows) for rows in groups), floor=2)
    member_idx = np.full((g_cap, m_cap), -1, np.int32)
    for g, rows in enumerate(groups):
        member_idx[g, :len(rows)] = rows
    idx = torch.from_numpy(member_idx).to(resolve_device(device))
    return idx, idx >= 0


def gang_verdicts(node_idx: torch.Tensor, first_fail: torch.Tensor, member_idx: torch.Tensor,
                  member_valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batch's flat-gang verdicts from its device results
    (``kubernetes_tpu/backend/batch.py:127-145``). ``member_idx`` [G, M]
    int32 rows into the pod axis (-1 padding), ``member_valid`` [G, M]
    bool. Returns (placed_all [G] bool: the batch placed every member, the
    commit verdict; kernel_ok [G] bool: a distinct-node cover exists on the
    decision-time masks, ``first_fail == 0``; assign [G, M] int32: the
    greedy cover, equal to the batch's choices where they are distinct and
    feasible). Nothing here reads a value on the host."""
    p = node_idx.shape[0]
    safe = member_idx.clamp(0, p - 1).long()
    feasible = (first_fail[safe] == 0) & member_valid[..., None]
    chosen = node_idx[safe]
    prefer = torch.where(member_valid, chosen, -1)
    assign, kernel_ok = assign_gangs(feasible, prefer, member_valid)
    placed_all = torch.all((chosen >= 0) | ~member_valid, dim=1)
    return placed_all, kernel_ok, assign


# The path "auto" takes on CUDA tensors, per topology mode: True = the
# speculative rounds, False = the fused kernel (mode "off") or the scan.
# Chosen from the H100 run of chip_smoke.py recorded in PERF.md §6, which
# times the three paths per workload in one call.
SPEC_AUTO_CUDA = {"off": False, "host": True, "general": True}


def spec_decode_eligible(topo_mode: str, device: DeviceLike, sampled: bool = False) -> bool:
    """Whether a batch runs the speculative rounds (the JAX package's
    ``spec_decode_eligible``). A ``sampled`` batch never does: it takes the
    scan. ``KTPU_SPEC=0`` forces the fused kernel or the scan, any other
    value but ``auto`` forces the rounds in every mode. Under ``auto`` (the
    default) the CPU takes the fused kernel's plain version or the scan, as
    in the JAX package, and CUDA takes ``SPEC_AUTO_CUDA[topo_mode]``."""
    flag = os.environ.get("KTPU_SPEC", "auto")
    if flag == "0" or sampled:
        return False
    if flag == "auto":
        return torch.device(device).type == "cuda" and SPEC_AUTO_CUDA[topo_mode]
    return True
