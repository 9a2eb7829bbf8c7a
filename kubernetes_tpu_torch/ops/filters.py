"""Batched filter predicates: [P pods, N nodes] boolean masks (PyTorch).

Counterparts of ``kubernetes_tpu/ops/filters.py``: each function mirrors one
Filter plugin evaluated for the whole pod batch × node snapshot at once (the
reference runs them per (pod, node), schedule_one.go:449). Everything is
gather-based — no O(P·N·V) intermediates. uint32 bitsets are int32 tensors
(ops/schema.py); a bit test ``(word >> b) & 1`` gives the same bit on both.
"""

from __future__ import annotations

import torch

from . import schema
from .schema import ExprTable, NodeTensors, PodBatch


def _bit(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Bit ``ids & 31`` of ``words`` as bool (arithmetic shift, then & 1)."""
    return ((words >> (ids & 31)) & 1).bool()


def eval_exprs(et: ExprTable, nt: NodeTensors) -> torch.Tensor:
    """Evaluate the batch's unique selector expressions → [E, N] bool."""
    key = et.key.long()
    vals = nt.label_val[:, key].T          # [E, N] value-id of node for expr's key
    nums = nt.label_num[:, key].T          # [E, N]
    # IN-set membership: bit `vals` of et.bits[e]
    word = torch.gather(et.bits, 1, (vals >> 5).long())
    in_set = _bit(word, vals)

    has_key = vals > 0
    has_num = nums != int(schema.INT_NONE)
    op = et.op[:, None]
    val = et.val[:, None]
    n_idx = torch.arange(nt.capacity, dtype=torch.int32, device=vals.device)[None, :]

    out = torch.ones_like(in_set)  # OP_TRUE
    out = torch.where(op == schema.OP_IN, in_set, out)
    out = torch.where(op == schema.OP_NOT_IN, ~in_set, out)
    out = torch.where(op == schema.OP_EXISTS, has_key, out)
    out = torch.where(op == schema.OP_NOT_EXISTS, ~has_key, out)
    out = torch.where(op == schema.OP_GT, has_num & (nums > val), out)
    out = torch.where(op == schema.OP_LT, has_num & (nums < val), out)
    out = torch.where(op == schema.OP_NODE_NAME, n_idx == val, out)
    return out


def eval_and_program(expr_match: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """AND over expr slots (slot 0 = TRUE is the neutral pad). idx [P,S] → [P,N]."""
    return torch.all(expr_match[idx.long()], dim=1)


def eval_term_program(expr_match: torch.Tensor, term_idx: torch.Tensor,
                      term_valid: torch.Tensor) -> torch.Tensor:
    """OR over valid terms of AND over each term's exprs; no valid terms ⇒ True.
    term_idx [P,T,E'] → [P,N]. (NodeSelector term OR-semantics.)"""
    per_term = torch.all(expr_match[term_idx.long()], dim=2)        # [P, T, N]
    any_term = torch.any(per_term & term_valid[:, :, None], dim=1)
    has_terms = torch.any(term_valid, dim=1)
    return torch.where(has_terms[:, None], any_term, torch.ones_like(any_term))


def filter_node_name(pb: PodBatch, nt: NodeTensors, slot_offset: int = 0) -> torch.Tensor:
    """NodeName: the pod's target slot, or any node (-1). Under node-axis
    sharding ``nt`` is one rank's window and ``slot_offset`` its first
    global slot: the target is a global slot id."""
    n_idx = torch.arange(nt.capacity, dtype=torch.int32, device=pb.node_name.device)[None, :]
    if slot_offset:
        n_idx = n_idx + slot_offset
    want = pb.node_name[:, None]
    return (want == -1) | (want == n_idx)


def filter_unschedulable(pb: PodBatch, nt: NodeTensors) -> torch.Tensor:
    return (~nt.unschedulable)[None, :] | pb.tolerates_unschedulable[:, None]


def _taint_tolerated(pb: PodBatch, nt: NodeTensors, tol_mask: torch.Tensor) -> torch.Tensor:
    """tolerated[p, n, t] = any toleration (restricted by tol_mask [P,L])
    tolerates node n's taint t (Toleration.ToleratesTaint semantics)."""
    tk = nt.taint_key[None, :, :, None]      # [1, N, T, 1]
    tv = nt.taint_val[None, :, :, None]
    te = nt.taint_effect[None, :, :, None]
    lk = pb.tol_key[:, None, None, :]        # [P, 1, 1, L]
    lv = pb.tol_val[:, None, None, :]
    lo = pb.tol_op[:, None, None, :]
    le = pb.tol_effect[:, None, None, :]
    key_ok = (lk == 0) | (lk == tk)
    eff_ok = (le == schema.EFFECT_NONE) | (le == te)
    val_ok = (lo == schema.TOL_EXISTS) | ((lo == schema.TOL_EQUAL) & (lv == tv) & (lk == tk))
    live = (lo != 0) & tol_mask[:, None, None, :]
    return torch.any(key_ok & eff_ok & val_ok & live, dim=-1)   # [P, N, T]


def filter_taints(pb: PodBatch, nt: NodeTensors) -> torch.Tensor:
    """TaintToleration Filter: every NoSchedule/NoExecute taint tolerated."""
    tolerated = _taint_tolerated(pb, nt, torch.ones_like(pb.tol_prefer))
    relevant = (nt.taint_effect == schema.EFFECT_NO_SCHEDULE) | (
        nt.taint_effect == schema.EFFECT_NO_EXECUTE
    )                                                          # [N, T]
    bad = relevant[None] & (nt.taint_key > 0)[None] & ~tolerated
    return ~torch.any(bad, dim=-1)


def filter_node_affinity(pb: PodBatch, et: ExprTable, nt: NodeTensors,
                         expr_match=None) -> torch.Tensor:
    """NodeAffinity Filter: nodeSelector map AND required terms."""
    if expr_match is None:
        expr_match = eval_exprs(et, nt)
    sel_ok = eval_and_program(expr_match, pb.sel_idx)
    aff_ok = eval_term_program(expr_match, pb.term_idx, pb.term_valid)
    return sel_ok & aff_ok


def filter_node_ports(pb: PodBatch, nt: NodeTensors) -> torch.Tensor:
    """NodePorts: no wanted-port vocab bit set on the node (wildcard-exact)."""
    ids = pb.port_ids                                          # [P, MP]
    word = nt.port_bits[:, (ids >> 5).long()]                  # [N, P, MP]
    conflict = torch.any(_bit(word, ids) & (ids > 0)[None], dim=-1)  # [N, P]
    return ~conflict.T
