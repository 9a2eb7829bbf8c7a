"""Slice-topology packing: contiguous torus windows for slice gangs.

PyTorch counterpart of ``kubernetes_tpu/ops/slice.py``. A slice gang (a
PodGroup whose pods carry the ``ktpu.dev/slice`` marker label) must land on
a run of consecutive torus positions inside one superpod, one member per
host. ``plan_slices`` runs in the batch program ahead of the commit: it
picks one window of ``k`` free cells per gang, and the batch's slice mask
then pins every member to its cell, so "every member landed" is the
contiguity verdict.

Coordinate model: every node carries ``(topo_sp, topo_pos)``, its superpod
and its linear position in that superpod's torus (``ops/encode.py`` parses
them from the well-known labels, or derives them from the node slot).
Windows never span superpods and never wrap. Among the feasible windows the
planner minimizes the free cells it strands on either side (best fit), then
the superpod, then the start position.

Gangs plan one after another against a taken-cell bitmap on the device, so
no two gangs of a batch share a cell; nothing in the loop reads a value on
the host.

Two nodes may carry the same (superpod, slot) labels. The cell then holds
the node of the HIGHEST slot index: ``grid_node`` is built with a max
reduction, which gives the same cell on every device. XLA's CPU scatter in
the JAX package writes the duplicates in index order, so there too the last
(highest) index wins, and so does the JAX host oracle's loop.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .encode import TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL  # noqa: F401 — re-export

# marker label: a PodGroup whose pods carry it is slice-placed (contiguous
# torus window) instead of flat gang-assigned
SLICE_LABEL = "ktpu.dev/slice"

_BIG = 2 ** 31 - 1


def is_slice_pod(pod) -> bool:
    return bool(pod.meta.labels.get(SLICE_LABEL))


def _row_runs(fg: torch.Tensor) -> torch.Tensor:
    """[S, P] bool -> [S, P] int32: the length of the free run ENDING at each
    cell (0 where blocked): the distance to the last blocked cell, through a
    cummax over the blocked positions."""
    p = fg.shape[1]
    iota = torch.arange(p, dtype=torch.int32, device=fg.device)[None, :]
    last_blocked = torch.cummax(torch.where(fg, -1, iota), dim=1).values
    return torch.where(fg, iota - last_blocked, 0)


def _shift_right(t: torch.Tensor) -> torch.Tensor:
    """[S, P] -> [S, P]: column c holds column c - 1, column 0 holds 0."""
    return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)


def plan_slices(nt, req: torch.Tensor, member_idx: torch.Tensor, member_valid: torch.Tensor,
                slice_grid: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plan every slice gang of a batch onto a contiguous torus window.

    ``nt``: the node tensors before the batch (valid, unschedulable,
    allocatable, requested, topo_sp, topo_pos are read). ``req``: [P, R]
    int32 per-pod requests. ``member_idx``: [G, M] int32 rows into the pod
    axis (-1 padding); ``member_valid``: [G, M] bool. ``slice_grid``:
    (superpods, slots per superpod). Returns (targets [G, M] int32 node
    slots, -1 for padding and for rejected gangs; ok [G] bool).

    A gang's request is the elementwise max over its members. A node fits
    when it is valid, schedulable and its free resources cover that
    request at the batch's start (``req == 0`` always fits)."""
    s_pods, ps = slice_grid
    cells = s_pods * ps
    if ps * (cells + 1) >= _BIG:
        raise ValueError(f"slice grid {slice_grid} overflows the int32 window score")
    g, m = member_idx.shape
    p = req.shape[0]
    n = nt.valid.shape[0]
    device = req.device

    safe = member_idx.clamp(0, p - 1).long()
    mreq = torch.where(member_valid[..., None], req[safe], 0)      # [G, M, R]
    req_g = mreq.amax(dim=1)                                        # [G, R]
    want = member_valid.sum(dim=1, dtype=torch.int32)              # [G]

    # node -> linearized grid cell; nodes without in-range coordinates land
    # in a spill cell past the grid and never take part
    has_coord = ((nt.topo_sp >= 0) & (nt.topo_sp < s_pods) & (nt.topo_pos >= 0)
                 & (nt.topo_pos < ps) & nt.valid)
    cell = torch.where(has_coord, nt.topo_sp * ps + nt.topo_pos, cells).long()
    grid_node = torch.full((cells + 1,), -1, dtype=torch.int32, device=device).scatter_reduce_(
        0, cell, torch.arange(n, dtype=torch.int32, device=device), "amax",
        include_self=True)[:cells]
    node_of_cell = grid_node.clamp(0, n - 1).long()
    has_node = grid_node >= 0

    free = nt.allocatable - nt.requested                           # [N, R]
    ok_node = nt.valid & ~nt.unschedulable
    iota_ps = torch.arange(ps, dtype=torch.int32, device=device)
    iota_cells = torch.arange(cells, dtype=torch.int32, device=device)
    cell_rank = iota_cells.view(s_pods, ps)

    # what does not depend on the cells earlier gangs took, for every gang
    # at once: the fit (`req == 0 always fits`, as in the batch program) and
    # each window start's geometry for the gang's length k
    gate = torch.where(req_g == 0, -(2 ** 30), req_g)
    fits = torch.all(free[None, :, :] >= gate[:, None, :], dim=2) & ok_node[None, :]  # [G, N]
    base = has_node[None, :] & fits[:, node_of_cell]                                  # [G, cells]
    end = iota_ps[None, :] + want[:, None]                          # [G, ps]: b + k
    hi_idx = (end - 1).clamp(0, ps - 1).long()
    right_idx = end.clamp(0, ps - 1).long()
    fits_row = (want[:, None] > 0) & (end <= ps)
    right_in = end < ps

    taken = torch.zeros(cells, dtype=torch.bool, device=device)
    bests, oks = [], []
    for gi in range(g):
        fg = (base[gi] & ~taken).view(s_pods, ps)
        # window [b, b + k) is free iff its row prefix sums differ by k
        csum = torch.cumsum(fg.to(torch.int32), dim=1, dtype=torch.int32)
        win_ok = fits_row[gi] & (csum.index_select(1, hi_idx[gi]) - _shift_right(csum)
                                 == want[gi])
        # the free cells the window strands: the run left of b plus the run
        # right of b + k - 1
        run_end = _row_runs(fg)
        run_start = torch.flip(_row_runs(torch.flip(fg, dims=[1])), dims=[1])
        right = torch.where(right_in[gi], run_start.index_select(1, right_idx[gi]), 0)
        # (leftover, superpod, start) as one int32 key; argmin takes the
        # first minimum, as jnp.argmin does
        score = torch.where(win_ok, (_shift_right(run_end) + right) * cells + cell_rank,
                            _BIG).view(-1)
        best = torch.argmin(score)
        okg = score.gather(0, best.view(1)) < _BIG                  # [1]
        taken = taken | (okg & (iota_cells >= best) & (iota_cells < best + want[gi]))
        bests.append(best)
        oks.append(okg)
    ok = torch.cat(oks)
    off = torch.cumsum(member_valid.to(torch.int32), dim=1, dtype=torch.int32) - 1  # [G, M]
    tcell = (torch.stack(bests)[:, None] + off).clamp(0, cells - 1).long()
    targets = torch.where(member_valid & ok[:, None], grid_node[tcell], -1)
    return targets, ok


def slice_assign_host(topo_sp, topo_pos, valid, fits, want, slice_grid: Tuple[int, int],
                      taken_cells=None) -> Tuple[List[List[int]], List[bool]]:
    """The host oracle of ``plan_slices`` (``kubernetes_tpu/ops/slice.py:
    152-210``), which the SlicePacking plugin plans with: the same greedy
    best-fit walk in plain Python. ``fits`` [G, N] bool (node n fits gang
    g's request and is schedulable), ``want`` [G] member counts,
    ``taken_cells`` seeds the taken-cell bitmap. Returns (per gang its node
    slots, empty when rejected; per gang its ok flag)."""
    s_pods, ps = slice_grid
    cells = s_pods * ps
    grid_node = np.full(cells, -1, np.int64)
    for nidx in range(len(topo_sp)):
        sp, pos = int(topo_sp[nidx]), int(topo_pos[nidx])
        if valid[nidx] and 0 <= sp < s_pods and 0 <= pos < ps:
            grid_node[sp * ps + pos] = nidx
    taken = np.zeros(cells, bool)
    for c in taken_cells or ():
        if 0 <= c < cells:
            taken[c] = True
    out_targets: List[List[int]] = []
    out_ok: List[bool] = []
    for gi in range(len(want)):
        k = int(want[gi])
        best, best_score = -1, None
        if k > 0:
            feas = np.array([grid_node[c] >= 0 and bool(fits[gi][grid_node[c]]) and not taken[c]
                             for c in range(cells)])
            fg = feas.reshape(s_pods, ps)
            for s in range(s_pods):
                row = fg[s]
                for b in range(ps - k + 1):
                    if not row[b:b + k].all():
                        continue
                    left, q = 0, b - 1
                    while q >= 0 and row[q]:
                        left, q = left + 1, q - 1
                    right, q = 0, b + k
                    while q < ps and row[q]:
                        right, q = right + 1, q + 1
                    cand = (left + right, s, b)
                    if best_score is None or cand < best_score:
                        best_score, best = cand, s * ps + b
        if best < 0:
            out_targets.append([])
            out_ok.append(False)
            continue
        out_targets.append([int(grid_node[best + o]) for o in range(k)])
        taken[best:best + k] = True
        out_ok.append(True)
    return out_targets, out_ok


def fragmentation_host(topo_sp, topo_pos, valid, node_free,
                       slice_grid: Tuple[int, int]) -> List[Dict[str, object]]:
    """Per-superpod fragmentation on the host (numpy, no device read).
    ``node_free`` [N] bool marks the nodes whose whole capacity is free for
    a slice. One dict per superpod that has a mapped node: {sp, free, used,
    largest_run, frag}, with frag = 1 - largest free run / free count (0.0
    when nothing is free: an exhausted superpod is full, not fragmented)."""
    s_pods, ps = slice_grid
    rows: List[Dict[str, object]] = []
    free_grid = np.zeros((s_pods, ps), bool)
    present = np.zeros((s_pods, ps), bool)
    for nidx in range(len(topo_sp)):
        sp, pos = int(topo_sp[nidx]), int(topo_pos[nidx])
        if valid[nidx] and 0 <= sp < s_pods and 0 <= pos < ps:
            present[sp, pos] = True
            free_grid[sp, pos] = bool(node_free[nidx])
    for s in range(s_pods):
        if not present[s].any():
            continue
        free = int(free_grid[s].sum())
        used = int(present[s].sum()) - free
        largest = run = 0
        for cell_free in free_grid[s]:
            run = run + 1 if cell_free else 0
            largest = max(largest, run)
        frag = 0.0 if free == 0 else 1.0 - largest / free
        rows.append({"sp": s, "free": free, "used": used, "largest_run": largest,
                     "frag": frag})
    return rows
