"""The batched scheduling step: one call schedules a pod batch against the
node mirror (PyTorch counterpart of ``kubernetes_tpu/backend/batch.py``,
without sampling, speculative decode, sharding or DRA/volume/slice/quota
inputs).

  1. STATIC phase (once per batch): the selector VM, the static filter masks
     and the raw scores that no intra-batch commit can change (labels,
     taints, affinity, images), the static first-fail table and the seeded
     tie-break jitter.
  2. COMMIT phase, in queue order, by topology mode:
     * ``off`` (no spread constraint, no inter-pod term, no registered
       count row): the fused per-pod step (ops/fused_step.py), one launch of
       the hand-written kernel per batch on CUDA tensors;
     * ``host`` and ``general``: the per-pod scan ``_topology_scan``, the
       XLA scan ``step`` written as a Python loop over pods on device
       tensors. It adds PodTopologySpread and InterPodAffinity
       (ops/topology.py) to the fit, ports, scores, winner and commit, and
       carries the topology count tables.
  3. The priority-class table (and, after the scan, the full nonzero
     request table) is advanced by the batch's commits in one post-scan
     scatter, and the winners plus the first-fail table are packed into one
     int32 block the host reads once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import filters, scores, topology
from ..ops.fused_step import (NEG_INF, NOMINATED_BONUS, WEIGHT_ORDER, _normalize,
                              _resource_scores, fused_step_batch)
from ..ops.schema import ExprTable, NodeTensors, PodBatch, TopoBatch, TopoCounts
from ..ops.tiebreak import jitter_table
from ..utils.device import DeviceLike, check_on, resolve_device

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
    # failing plugin (static ids 1-4, ports 5, fit 6, spread 7, ipa 8)
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
    # [P, 1 + ceil(N/4)] int32: node_idx, then first_fail bitcast to words
    packed: Optional[torch.Tensor] = None


def weight_vector(weights: Dict[str, float]) -> Tuple[float, ...]:
    """The five commit-step weights in kernel order, rounded to float32."""
    return tuple(float(np.float32(weights[k])) for k in WEIGHT_ORDER)


def pack_result_block(node_idx: torch.Tensor, first_fail: torch.Tensor) -> torch.Tensor:
    """[P, 1 + ceil(N/4)] int32: node_idx in column 0, then the int8
    first_fail rows reinterpreted as int32 words after padding N to a
    multiple of 4 (little-endian, the bytes of ``lax.bitcast_convert_type``)."""
    p, n = first_fail.shape
    pad = (-n) % 4
    if pad:
        first_fail = torch.cat(
            [first_fail, first_fail.new_zeros((p, pad))], dim=1)
    words = first_fail.contiguous().view(torch.int32)
    return torch.cat([node_idx.to(torch.int32)[:, None], words], dim=1)


def unpack_result_block(packed, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(node_idx [P] int32, first_fail [P, N] int8) from the packed block.
    Reading a device tensor here is THE blocking device read of a batch."""
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    ff_words = (n_nodes + 3) // 4
    ff = np.ascontiguousarray(arr[:, 1:1 + ff_words]).view(np.int8)
    return arr[:, 0].copy(), ff.reshape(arr.shape[0], -1)[:, :n_nodes]


def _pod_port_bits(pb: PodBatch, words: int) -> torch.Tensor:
    """[P, W] uint32 bits in int32: each pod's wanted-port ids as a bitset."""
    ids = pb.port_ids
    bit = torch.where(ids > 0, torch.ones_like(ids, dtype=torch.int64) << (ids & 31).long(),
                      torch.zeros_like(ids, dtype=torch.int64))
    out = torch.zeros((ids.shape[0], words), dtype=torch.int64, device=ids.device)
    # ids are deduplicated at encode time, so add == bitwise-or here
    out.scatter_add_(1, (ids >> 5).long(), bit)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def static_phase(pb: PodBatch, et: ExprTable, nt: NodeTensors):
    """(static_masks, static_ok, static_ff, taint_raw, affinity_raw,
    image_score, jitter): everything about the batch that no intra-batch
    commit can change (``schedule_batch_core`` lines 1042-1104)."""
    expr_match = filters.eval_exprs(et, nt)
    static_masks = {
        "NodeUnschedulable": filters.filter_unschedulable(pb, nt),
        "NodeName": filters.filter_node_name(pb, nt),
        "TaintToleration": filters.filter_taints(pb, nt),
        "NodeAffinity": filters.filter_node_affinity(pb, et, nt, expr_match),
    }
    static_ok = nt.valid[None, :] & pb.valid[:, None]
    for m in static_masks.values():
        static_ok = static_ok & m
    static_ff = torch.zeros(static_ok.shape, dtype=torch.int8, device=static_ok.device)
    for sid, name in STATIC_FILTER_IDS:  # earliest failing plugin wins
        static_ff = torch.where(~static_masks[name], torch.full_like(static_ff, sid), static_ff)
    taint_raw = scores.score_taint_toleration(pb, nt)
    affinity_raw = scores.score_node_affinity(pb, et, nt, expr_match)
    total_nodes = torch.clamp_min(torch.sum(nt.valid), 1)
    image_score = scores.score_image_locality(pb, nt, total_nodes=total_nodes)
    jitter = jitter_table(pb.tie_seed, nt.name_hash)
    return static_masks, static_ok, static_ff, taint_raw, affinity_raw, image_score, jitter


def _commit_scatters(nt: NodeTensors, pb: PodBatch, node_idx: torch.Tensor,
                     nonzero: bool):
    """The batch's commits added in one post-scan scatter each: the
    priority-class table [N, C, R] and, when ``nonzero``, the full nonzero
    request table [N, R] (the scan carries only its two scored columns).
    ``index_add_`` on flattened rows: no host read, on any device."""
    committed = node_idx >= 0
    slot = torch.where(committed, node_idx, 0).long()
    n, c, r = nt.class_req.shape
    f_class = nt.class_req.clone(memory_format=torch.contiguous_format)
    f_class.view(n * c, r).index_add_(0, slot * c + pb.prio_class.long(),
                                      torch.where(committed[:, None], pb.req, 0))
    if not nonzero:
        return f_class, None
    f_nz = nt.nonzero_requested.clone(memory_format=torch.contiguous_format)
    f_nz.index_add_(0, slot, torch.where(committed[:, None], pb.nonzero_req, 0))
    return f_class, f_nz


def _topology_scan(pb: PodBatch, et: ExprTable, nt: NodeTensors, weights: Dict[str, float],
                   tc: TopoCounts, tb: TopoBatch, topo_mode: str, vd_override: Optional[int],
                   host_key: int, static) -> BatchResult:
    """The XLA scan ``step`` (``kubernetes_tpu/backend/batch.py:1202-1392``)
    as a loop over the batch's pods on device tensors, without sampling: the
    fit against the carried free resources with the ``req == 0`` sentinel,
    ports, spread and inter-pod affinity against the carried counts, the
    scores normalized over the pod's feasible set, the nominated-node bonus,
    the first-maximum argmax, and the commit of the winner to every carry.
    Nothing in the loop reads a device value on the host."""
    (static_masks, static_ok, static_ff, taint_raw, affinity_raw, image_score,
     jitter) = static
    w = {k: float(np.float32(v)) for k, v in weights.items()}
    n = nt.capacity
    device = nt.valid.device
    iota = torch.arange(n, dtype=torch.int32, device=device)
    affinity_ok = static_masks["NodeAffinity"]
    pod_bits = _pod_port_bits(pb, nt.port_bits.shape[1])
    alloc2 = nt.allocatable[:, :2].to(torch.float32)
    host = topo_mode == "host"
    # the value-id domain axis: the involved keys' vocab bucket when the
    # caller computed it, else the full per-key vocab padding
    vd = vd_override if vd_override else int(et.bits.shape[1]) * 32
    if host:
        hostkey_ok = nt.label_val[:, host_key] > 0          # [N] node has a hostname
        seg_exist = tc.term_counts                           # [T, N] per-node counts
    else:
        static_topo = topology.make_static(tc.term_counts, tc.term_key, nt.label_val,
                                           nt.valid, vd)
        seg_exist = static_topo.seg_exist0                   # [T, Vd] domain counts
    log_tbl = topology.size_log_table(max(n, vd) + 1, device)

    # `req == 0 always fits` as a sentinel, so fit is one compare and reduce
    req_gate = torch.where(pb.req == 0, -(2 ** 30), pb.req)
    free = nt.allocatable - nt.requested
    nz2 = nt.nonzero_requested[:, :2]
    ports = nt.port_bits
    sel = tc.sel_counts
    tb_fields = {f.name: getattr(tb, f.name) for f in dataclasses.fields(tb)}
    outs = []
    for p in range(pb.capacity):
        xs = {k: v[p] for k, v in tb_fields.items()}
        fit_ok = torch.all(free >= req_gate[p][None, :], dim=1)
        ports_ok = ~torch.any((ports & pod_bits[p][None, :]) != 0, dim=1)
        if host:
            spread_ok = topology.spread_filter_host(xs, sel, hostkey_ok, nt.valid,
                                                    affinity_ok[p])
            aff_ok, anti_ok, exist_ok, exist_at = topology.ipa_filter_host(
                xs, sel, seg_exist, hostkey_ok, nt.valid)
        else:
            spread_ok = topology.spread_filter(xs, sel, nt.label_val, nt.valid,
                                               affinity_ok[p], vd)
            aff_ok, anti_ok, exist_ok, exist_at = topology.ipa_filter(
                xs, sel, seg_exist, static_topo.dom_t, nt.label_val, nt.valid, vd)
        ipa_ok = aff_ok & anti_ok & exist_ok
        feasible = static_ok[p] & fit_ok & ports_ok & spread_ok & ipa_ok

        # resource scores on the evolving nonzero request (int32 add first)
        least_alloc, balanced = _resource_scores(
            alloc2, (nz2 + pb.nonzero_req[p, :2][None, :]).to(torch.float32))
        total = (w["NodeResourcesFit"] * least_alloc
                 + w["NodeResourcesBalancedAllocation"] * balanced
                 + w["TaintToleration"] * _normalize(taint_raw[p], feasible, True)
                 + w["NodeAffinity"] * _normalize(affinity_raw[p], feasible, False)
                 + w["ImageLocality"] * image_score[p])
        if host:
            spread = topology.spread_score_host(xs, sel, hostkey_ok, nt.valid,
                                                affinity_ok[p], feasible, log_tbl)
            ipa = topology.ipa_score_host(xs, sel, exist_at, hostkey_ok, feasible)
        else:
            spread = topology.spread_score(xs, sel, nt.label_val, nt.valid, affinity_ok[p],
                                           feasible, vd, log_tbl)
            ipa = topology.ipa_score(xs, sel, exist_at, nt.label_val, nt.valid, feasible, vd)
        total = total + w["PodTopologySpread"] * spread
        total = total + w["InterPodAffinity"] * ipa

        # the nominated node wins outright when feasible (schedule_one.go:394)
        is_nom = (iota == pb.nominated[p]).to(torch.float32)
        eff = torch.where(feasible, total + jitter[p] + is_nom * NOMINATED_BONUS, NEG_INF)
        idx = torch.argmax(eff)                              # the first maximum wins
        any_feasible = torch.any(feasible) & pb.valid[p]
        best = total.index_select(0, idx.view(1))[0]

        onehot = (iota == idx) & any_feasible                # [N]
        free = free - onehot[:, None].to(torch.int32) * pb.req[p][None, :]
        nz2 = nz2 + onehot[:, None].to(torch.int32) * pb.nonzero_req[p, :2][None, :]
        ports = torch.where(onehot[:, None], ports | pod_bits[p][None, :], ports)
        if host:
            sel, seg_exist = topology.commit_update_host(
                sel, seg_exist, idx, any_feasible, xs["pod_sig_mask"], xs["pod_term_mask"])
        else:
            sel, seg_exist = topology.commit_update(
                sel, seg_exist, static_topo.dom_t, idx, any_feasible, xs["pod_sig_mask"],
                xs["pod_term_mask"])
        ff = static_ff[p]
        for fid, ok in ((5, ports_ok), (6, fit_ok), (SPREAD_FAIL_ID, spread_ok),
                        (IPA_FAIL_ID, ipa_ok)):
            ff = torch.where((ff == 0) & ~ok, fid, ff)
        outs.append((torch.where(any_feasible, idx.to(torch.int32), -1), best, any_feasible,
                     fit_ok, ports_ok, spread_ok, ipa_ok, ff))

    (node_idx, best, any_feasible, fit_ok, ports_ok, spread_ok, ipa_ok,
     first_fail) = (torch.stack(col) for col in zip(*outs))
    f_class, f_nz = _commit_scatters(nt, pb, node_idx, nonzero=True)
    return BatchResult(
        node_idx=node_idx, best_score=best, any_feasible=any_feasible,
        static_masks=static_masks, fit_ok=fit_ok, ports_ok=ports_ok, spread_ok=spread_ok,
        ipa_ok=ipa_ok, first_fail=first_fail, final_requested=nt.allocatable - free,
        final_nonzero=f_nz, final_ports=ports, final_class_req=f_class,
        final_sel_counts=sel, final_seg_exist=seg_exist)


def schedule_batch_core(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                        weights: Dict[str, float], tc: Optional[TopoCounts] = None,
                        tb: Optional[TopoBatch] = None, topo_mode: str = "off",
                        vd_override: Optional[int] = None, host_key: int = 0) -> BatchResult:
    """Static phase, the commit phase of ``topo_mode`` and the post-scan
    scatters. ``weights`` are the plugin weights by name (every key of
    DEFAULT_WEIGHTS). Modes ``host`` and ``general`` need ``tc`` and ``tb``;
    ``host_key`` is the hostname key slot (mode ``host``) and
    ``vd_override`` the domain-axis size (mode ``general``; default: the
    full value vocab)."""
    if topo_mode not in TOPO_MODES:
        raise ValueError(f"topo_mode must be one of {TOPO_MODES}, not {topo_mode!r}")
    static = static_phase(pb, et, nt)
    if topo_mode != "off":
        if tc is None or tb is None:
            raise ValueError(f"topo_mode {topo_mode!r} needs tc and tb")
        return _topology_scan(pb, et, nt, weights, tc, tb, topo_mode, vd_override,
                              host_key, static)
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
                   vd_override: Optional[int] = None, host_key: int = 0) -> BatchResult:
    """Schedule one encoded batch on ``device`` (default: the CUDA card;
    ``device="cpu"`` runs the plain versions). Every input must already lie
    there. The topology arguments are those of ``schedule_batch_core``.
    Returns the BatchResult with the packed block filled in."""
    device = resolve_device(device)
    check_on(device, valid=nt.valid, allocatable=nt.allocatable,
             pod_valid=pb.valid, pod_req=pb.req, expr_op=et.op,
             sel_counts=tc.sel_counts if tc is not None else None,
             tb_sf_valid=tb.sf_valid if tb is not None else None)
    res = schedule_batch_core(pb, et, nt, {**DEFAULT_WEIGHTS, **(weights or {})}, tc, tb,
                              topo_mode, vd_override, host_key)
    res.packed = pack_result_block(res.node_idx, res.first_fail)
    return res
