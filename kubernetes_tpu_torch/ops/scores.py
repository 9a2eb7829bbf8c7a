"""Batched raw scores: [P, N] float32 per plugin + normalization (PyTorch).

Counterparts of ``kubernetes_tpu/ops/scores.py``, float32 throughout (never
float64) so every value has the JAX program's bits: floors where the
reference floor-divides, the same evaluation order, and sums over small axes
written out left to right.

Normalization runs over the *feasible* node set only (prioritizeNodes scores
only filtered nodes, schedule_one.go:605).
"""

from __future__ import annotations

import torch

from . import schema
from .filters import _bit, _taint_tolerated, eval_exprs
from .schema import ExprTable, NodeTensors, PodBatch

MAX_NODE_SCORE = 100.0


def score_taint_toleration(pb: PodBatch, nt: NodeTensors) -> torch.Tensor:
    """Raw score: count of PreferNoSchedule taints NOT tolerated by the pod's
    {empty, PreferNoSchedule}-effect tolerations (taint_toleration.go:147)."""
    tolerated = _taint_tolerated(pb, nt, pb.tol_prefer)  # [P, N, T]
    prefer = (nt.taint_effect == schema.EFFECT_PREFER_NO_SCHEDULE)[None]
    bad = prefer & (nt.taint_key > 0)[None] & ~tolerated
    return torch.sum(bad, dim=-1).to(torch.float32)


def score_node_affinity(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                        expr_match=None) -> torch.Tensor:
    """Σ weights of matching preferred terms (node_affinity.go:260)."""
    if expr_match is None:
        expr_match = eval_exprs(et, nt)
    per_term = torch.all(expr_match[pb.pref_idx.long()], dim=2)  # [P, PT, N]
    w = pb.pref_weight[:, :, None].to(torch.float32)
    terms = per_term.to(torch.float32) * w
    out = terms[:, 0]
    for t in range(1, terms.shape[1]):
        out = out + terms[:, t]
    return out


_MB = 1024.0 * 1024.0
_MIN_THRESHOLD = 23.0 * _MB
_MAX_CONTAINER_THRESHOLD = 1000.0 * _MB


def score_image_locality(pb: PodBatch, nt: NodeTensors, total_nodes=None,
                         mesh=None) -> torch.Tensor:
    """imagelocality: Σ_present size·numNodes/totalNodes, clamped+scaled.
    totalNodes defaults to the valid nodes, summed over the ``mesh``'s
    ranks when ``nt`` is one rank's window (``parallel/mesh.py``)."""
    ids = pb.image_ids                                   # [P, C]
    idl = ids.long()
    word = nt.image_bits[:, (ids >> 5).long()]           # [N, P, C]
    present = _bit(word, ids).to(torch.float32).permute(1, 0, 2)  # [P, N, C]
    if total_nodes is None:
        valid = torch.sum(nt.valid)
        if mesh is not None:
            valid = mesh.all_reduce(valid, "sum")
        total_nodes = torch.clamp_min(valid, 1)
    total_nodes = torch.as_tensor(total_nodes).to(torch.float32)
    spread = nt.image_num_nodes[idl].to(torch.float32) / total_nodes  # [P, C]
    contrib = torch.floor(nt.image_sizes[idl].to(torch.float32) * spread)
    terms = present * contrib[:, None, :]                # [P, N, C]
    sum_scores = torch.zeros(terms.shape[:2], dtype=torch.float32, device=terms.device)
    for c in range(terms.shape[2]):
        sum_scores = sum_scores + terms[:, :, c]
    max_threshold = _MAX_CONTAINER_THRESHOLD * torch.clamp_min(
        pb.num_containers, 1)[:, None].to(torch.float32)
    clamped = torch.minimum(torch.clamp_min(sum_scores, _MIN_THRESHOLD), max_threshold)
    return torch.floor(MAX_NODE_SCORE * (clamped - _MIN_THRESHOLD)
                       / (max_threshold - _MIN_THRESHOLD))


def normalize_default(raw: torch.Tensor, feasible: torch.Tensor, reverse: bool) -> torch.Tensor:
    """helper.DefaultNormalizeScore over the feasible set per pod:
    scale to [0,100], flip when reverse; all-zero max ⇒ 100s when reversed."""
    masked = torch.where(feasible, raw, torch.zeros_like(raw))
    max_score = torch.amax(masked, dim=1, keepdim=True)
    scaled = torch.floor(raw * MAX_NODE_SCORE / torch.clamp_min(max_score, 1.0))
    if reverse:
        return torch.where(max_score == 0, torch.full_like(scaled, MAX_NODE_SCORE),
                           MAX_NODE_SCORE - scaled)
    return torch.where(max_score == 0, torch.zeros_like(scaled), scaled)
