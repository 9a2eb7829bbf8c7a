"""Batched gang placement: the greedy all-or-nothing distinct-node cover.

PyTorch counterpart of ``kubernetes_tpu/ops/gang.py``. A gang is a set of
pods that must place together or not at all, one member per host. For each
gang the assigner walks its members in batch order: a member takes its
preferred node (the batch program's own choice) when that node is feasible
for it and still untaken, else the first feasible untaken node, and the
gang's result is either a full assignment or all -1.

The JAX package scans the members of one gang and ``vmap``s the scan over
the gangs. Here the loop runs over the M member positions and every step
treats the G gangs at once, with the taken bitmap [G, N] kept on the
device: nothing in the loop reads a value on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch


def assign_gangs(feasible: torch.Tensor, prefer: torch.Tensor,
                 active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``feasible`` [G, M, N] bool, ``prefer`` [G, M] int32 (-1 = no
    preference), ``active`` [G, M] bool (False = padding member). Returns
    (idx [G, M] int32, ok [G] bool); a gang's idx row is all -1 unless every
    active member got a distinct feasible node."""
    g, m, n = feasible.shape
    device = feasible.device
    iota = torch.arange(n, dtype=torch.int32, device=device)
    taken = torch.zeros((g, n), dtype=torch.bool, device=device)
    pref_ok = prefer >= 0
    pref_c = prefer.clamp(0, n - 1)
    pref_rows = pref_c.long()
    cols = []
    for j in range(m):
        avail = feasible[:, j] & ~taken                                     # [G, N]
        has_pref = pref_ok[:, j] & torch.gather(avail, 1, pref_rows[:, j:j + 1])[:, 0]
        # argmax over the 0/1 row takes the FIRST available slot (argmax
        # returns the first maximum, as jnp.argmax does; 0 when none is)
        fallback = torch.argmax(avail.to(torch.uint8), dim=1).to(torch.int32)
        choice = torch.where(has_pref, pref_c[:, j], torch.where(avail.any(dim=1), fallback, -1))
        choice = torch.where(active[:, j], choice, -1)
        taken = taken | (iota[None, :] == choice[:, None])   # -1 marks nothing
        cols.append(choice)
    idx = torch.stack(cols, dim=1)
    ok = torch.all((idx >= 0) | ~active, dim=1)
    return torch.where(ok[:, None], idx, -1), ok
