"""The batched scheduling step: one call schedules a pod batch against the
node mirror (PyTorch counterpart of ``kubernetes_tpu/backend/batch.py``,
main path: topology off, no sampling, no DRA/volume/slice/quota inputs).

  1. STATIC phase (once per batch): the selector VM, the static filter masks
     and the raw scores that no intra-batch commit can change (labels,
     taints, affinity, images), the static first-fail table and the seeded
     tie-break jitter.
  2. COMMIT phase: the fused per-pod step (ops/fused_step.py) in queue
     order — dynamic fit and ports against the evolving carry, scores,
     normalization over each pod's feasible set, the winner, and its commit.
     On CUDA tensors it is one launch of the hand-written kernel.
  3. The priority-class table is advanced by the batch's commits in one
     post-scan scatter, and the winners plus the first-fail table are packed
     into one int32 block the host reads once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import filters, scores
from ..ops.fused_step import (WEIGHT_ORDER, _normalize, _resource_scores,  # noqa: F401
                              fused_step_batch)
from ..ops.schema import ExprTable, NodeTensors, PodBatch
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


@dataclasses.dataclass
class BatchResult:
    node_idx: torch.Tensor      # [P] int32 chosen slot, -1 = unschedulable
    best_score: torch.Tensor    # [P] float32 winner total (no jitter)
    any_feasible: torch.Tensor  # [P] bool
    static_masks: Dict[str, torch.Tensor]  # plugin name -> [P, N] bool
    fit_ok: torch.Tensor        # [P, N] resource fit at decision time
    ports_ok: torch.Tensor      # [P, N] port availability at decision time
    # [P, N] int8: 0 = feasible, else the 1-based filter id of the first
    # failing plugin (static ids 1-4, ports 5, fit 6)
    first_fail: torch.Tensor
    # the evolved carry: the post-batch dynamic node state
    final_requested: torch.Tensor   # [N, R] int32
    final_nonzero: torch.Tensor     # [N, R] int32
    final_ports: torch.Tensor       # [N, W] int32 (uint32 bits)
    final_class_req: torch.Tensor   # [N, C, R] int32
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


def schedule_batch_core(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                        weights: Sequence[float]) -> BatchResult:
    """Static phase, the fused commit step, and the post-scan class scatter.
    ``weights`` are the five commit-step weights (``weight_vector``)."""
    (static_masks, static_ok, static_ff, taint_raw, affinity_raw, image_score,
     jitter) = static_phase(pb, et, nt)
    pod_bits = _pod_port_bits(pb, nt.port_bits.shape[1])
    out = fused_step_batch(
        nt.allocatable, nt.requested, nt.nonzero_requested, nt.port_bits,
        pb.req, pb.nonzero_req, pod_bits, static_ok.contiguous(),
        static_ff.contiguous(), taint_raw.contiguous(),
        affinity_raw.contiguous(), image_score.contiguous(),
        jitter.contiguous(), pb.nominated, pb.valid, weights)

    # the priority-class table, advanced by the batch's commits in ONE
    # post-scan scatter (nothing in the scan reads it)
    committed = out.node_idx >= 0
    slot = torch.where(committed, out.node_idx, torch.zeros_like(out.node_idx)).long()
    add = torch.where(committed[:, None], pb.req, torch.zeros_like(pb.req))
    f_class = nt.class_req.clone()
    f_class.index_put_((slot, pb.prio_class.long()), add, accumulate=True)
    return BatchResult(
        node_idx=out.node_idx, best_score=out.best, any_feasible=out.any_feasible,
        static_masks=static_masks, fit_ok=out.fit_ok, ports_ok=out.ports_ok,
        first_fail=out.first_fail, final_requested=out.requested,
        final_nonzero=out.nonzero, final_ports=out.ports, final_class_req=f_class)


def schedule_batch(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                   weights: Optional[Dict[str, float]] = None,
                   device: DeviceLike = None) -> BatchResult:
    """Schedule one encoded batch on ``device`` (default: the CUDA card;
    ``device="cpu"`` runs the plain versions). Every input must already lie
    there. Returns the BatchResult with the packed block filled in."""
    device = resolve_device(device)
    check_on(device, valid=nt.valid, allocatable=nt.allocatable,
             pod_valid=pb.valid, pod_req=pb.req, expr_op=et.op)
    res = schedule_batch_core(pb, et, nt, weight_vector(weights or DEFAULT_WEIGHTS))
    res.packed = pack_result_block(res.node_idx, res.first_fail)
    return res
