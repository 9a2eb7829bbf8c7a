"""Batched preemption screen and candidate ranking on the device.

PyTorch counterpart of ``kubernetes_tpu/ops/preempt.py``. Each node's pods
are bucketed by priority class (``NodeTensors.class_req``); per (failed pod,
node) the screen computes the least number of classes, in ascending
priority, whose eviction makes the pod fit (a prefix-sum fit check, exact
for the resource and pod-count columns), and ranks the viable nodes by the
evicted prefix's highest priority, its priority sum and its pod count
(``pickOneNodeForPreemption`` criteria 2-4). A greedy pass over the failed
pods, in batch order, spreads their picks over unclaimed nodes. The host
then runs the exact victim selection on the picked node
(``framework/preemption.py``): the device proposes, the host verifies.

Where PyTorch differs from ``jnp`` and would break exactness:

* integer ``cumsum`` and ``sum`` give int64 unless told: ``cum``,
  ``cum_cnt``, ``k_needed`` and ``elig`` are int32 as in JAX (integer sums
  are exact in any order, so only the type matters);
* ``argsort`` of the class priorities is stable, as ``jnp.argsort``:
  unused classes all hold ``2**31 - 1`` and tie;
* ``cum_psum`` is a float32 prefix sum of count x priority, exact only
  below 2**24 while priorities reach 2e9, so its rounding depends on the
  order of the additions. XLA on the CPU evaluates ``jnp.cumsum`` over an
  axis longer than 16 as a two-level scan: a left fold inside blocks of 16,
  plus the inclusive sum of the earlier blocks' totals (itself scanned the
  same way). ``_xla_cumsum_f32`` makes exactly those additions;
* ``argmax`` of a bool row: CUDA has no bool kernel, so the row is cast to
  int32 first (the first maximal index wins, as ``jnp.argmax``);
* the greedy ``claim_step`` scan runs on the host over the failed rows
  only (a row that is not failed neither claims nor picks, so skipping it
  is exact); every choice inside it stays on the device, and
  ``preempt_screen`` neither reads from nor copies to the host.

``_BIG`` (the key of a masked-out node, and ``-_BIG`` the highest victim
priority when nothing is evicted) is the float32 value 1e18, as in JAX.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from .schema import COL_PODS, NodeTensors, PodBatch

_BIG = float(np.float32(1e18))
_SCAN_BASE = 16  # XLA's block length for a cumulative reduce-window on the CPU


class PreemptResult(NamedTuple):
    screen: torch.Tensor  # [P, N] bool: the pod could fit after evicting lower classes
    best: torch.Tensor    # [P] int32 top-ranked candidate slot (-1 = none)


def _left_fold(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis, added left to right from 0."""
    acc = torch.zeros_like(x[..., 0])
    cols = []
    for c in range(x.shape[-1]):
        acc = acc + x[..., c]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _xla_cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(x, axis=1)`` of a float32 [N, C] array with XLA's CPU
    order of additions: a left fold when C <= 16, else a fold inside each
    block of 16 (the last one padded with zeros) plus the inclusive sum of
    the earlier blocks' totals, scanned the same way."""
    n, c = x.shape
    if c <= _SCAN_BASE:
        return _left_fold(x)
    nb = -(-c // _SCAN_BASE)
    if nb * _SCAN_BASE != c:
        x = torch.cat([x, x.new_zeros((n, nb * _SCAN_BASE - c))], dim=1)
    within = _left_fold(x.reshape(n, nb, _SCAN_BASE))          # [N, nb, 16]
    totals = _xla_cumsum_f32(within[:, :, -1])                 # [N, nb] inclusive
    offset = torch.cat([x.new_zeros((n, 1)), totals[:, :-1]], dim=1)
    return (within + offset[:, :, None]).reshape(n, -1)[:, :c]


def screen_prefix(pb: PodBatch, nt: NodeTensors, static_masks: Dict[str, torch.Tensor],
                  failed_prefix) -> PreemptResult:
    """The screen for an [n]-bool per-pod failure prefix (host; the pods
    past it did not fail): the one construction every caller shares."""
    rows = np.flatnonzero(np.asarray(failed_prefix, bool)).tolist()
    return preempt_screen(pb, nt, static_masks, rows)


def preempt_screen(pb: PodBatch, nt: NodeTensors, static_masks: Dict[str, torch.Tensor],
                   rows: Sequence[int]) -> PreemptResult:
    """``static_masks``: the batch's static filter masks [P, N]
    (unschedulable, node name, taints, affinity); eviction cannot fix
    those, as ``nodesWherePreemptionMightHelp`` skips unresolvable nodes.
    ``rows``: the failed pods' batch indices, ascending (host ints; JAX
    takes a [P] bool ``failed``, whose other rows neither claim nor pick)."""
    static_ok = pb.valid[:, None] & nt.valid[None, :]
    for m in static_masks.values():
        static_ok = static_ok & m
    alloc, req = nt.allocatable, nt.requested           # [N, R]
    class_req, class_prio = nt.class_req, nt.class_prio  # [N, C, R], [C]
    P = pb.capacity
    N, C, R = class_req.shape

    order = torch.argsort(class_prio, stable=True)       # ascending priority
    cprio = class_prio[order]                            # [C]
    creq = class_req[:, order, :]                        # [N, C, R]
    cum = torch.cumsum(creq, dim=1, dtype=torch.int32)   # [N, C, R]

    # deficit per resource: how much must be freed for pod p on node n
    deficit = pb.req[:, None, :] - (alloc - req)[None, :, :]    # [P, N, R]

    # classes needed per resource: deficit <= 0 -> 0; else 1 + the number
    # of prefixes whose cumulative freed amount falls short
    k_needed = torch.zeros((P, N), dtype=torch.int32, device=cum.device)
    for r in range(R):
        d = deficit[:, :, r]
        cnt = torch.sum(cum[None, :, :, r] < d[:, :, None], dim=-1, dtype=torch.int32)
        k_needed = torch.maximum(k_needed, torch.where(d > 0, cnt + 1, 0))

    # classes a pod may evict: those of lower priority (a prefix of the order)
    elig = torch.sum(cprio[None, :] < pb.priority[:, None], dim=-1, dtype=torch.int32)
    viable = (k_needed <= elig[:, None]) & static_ok & nt.valid[None, :]

    # ranking statistics of the evicted prefix (k = k_needed)
    pods = creq[..., COL_PODS]                                    # [N, C]
    cum_cnt = torch.cumsum(pods, dim=1, dtype=torch.int32)
    cum_psum = _xla_cumsum_f32(pods.to(torch.float32) * cprio[None, :].to(torch.float32))
    k = k_needed
    k_idx = torch.clamp(k - 1, 0, C - 1).long()
    n_idx = torch.arange(N, device=k.device)[None, :]
    victims = torch.where(k > 0, cum_cnt[n_idx, k_idx], 0)
    psum = torch.where(k > 0, cum_psum[n_idx, k_idx], 0.0)
    maxprio = torch.where(k > 0, cprio[k_idx].to(torch.float32), -_BIG)
    victims_f = victims.to(torch.float32)

    # greedy claim: each failed pod prefers viable nodes no earlier failed
    # pod of the batch picked, falling back to the claimed ones
    slots = torch.arange(N, device=k.device)
    claimed = torch.zeros(N, dtype=torch.bool, device=k.device)
    best = torch.full((P,), -1, dtype=torch.int32, device=k.device)
    for p in rows:
        v_row = viable[p]
        prefer = v_row & ~claimed
        row = torch.where(torch.any(prefer), prefer, v_row)
        # staged masked argmin: exact lexicographic order over (highest
        # victim priority, victim priority sum, victim count)
        for key_row in (maxprio[p], psum[p], victims_f[p]):
            masked = torch.where(row, key_row, _BIG)
            row = row & (masked == torch.min(masked))
        idx = torch.argmax(row.to(torch.int32))
        ok = torch.any(v_row)
        claimed = claimed | ((slots == idx) & ok)
        best[p] = torch.where(ok, idx, -1)
    return PreemptResult(screen=viable, best=best)
