"""DefaultPreemption, the PostFilter of a pod no node fits.

An own copy of ``kubernetes_tpu/framework/plugins/defaultpreemption.py``
(plugins/defaultpreemption/default_preemption.go) over the port's filter
runner. ``post_filter`` runs the pod's PreFilters (the batched path skips
them), reads the device screen's hints, and runs the Evaluator
(``framework/preemption.py``) against the cluster as the filter runner
lists it. One ``random.Random(seed)`` lives as long as the plugin, as in
the JAX plugin: it draws the candidate walk's offsets. Its arguments:
``min_candidate_nodes_percentage`` (10), ``min_candidate_nodes_absolute``
(100) and ``seed`` (0). The registry builds it without a filter runner;
the profile's ``Framework`` hands it its own (``set_framework``), and the
scheduler's store writes (``evict``, ``clear_nomination``) and its
extenders come from the handle (JAX ``scheduler/scheduler.py:157``).
"""

from __future__ import annotations

import random
from typing import Callable, Collection, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from ...api.types import Pod, PodDisruptionBudget
from ..preemption import (MIN_CANDIDATE_NODES_ABSOLUTE, MIN_CANDIDATE_NODES_PERCENTAGE,
                          Evaluator)
from ..interface import Fail
from . import names

# the device screen's hints for one pod: (its screen row over the node
# slots, node name -> slot, the top-ranked node's name or None)
Hints = Tuple[np.ndarray, Dict[str, int], Optional[str]]


class DefaultPreemption:
    def __init__(self, filters, evict: Callable[[Pod, Pod], None],
                 clear_nomination: Callable[[Pod], None],
                 pdb_lister: Optional[Callable[[], Iterable[PodDisruptionBudget]]] = None,
                 min_candidate_nodes_percentage: int = MIN_CANDIDATE_NODES_PERCENTAGE,
                 min_candidate_nodes_absolute: int = MIN_CANDIDATE_NODES_ABSOLUTE,
                 seed: int = 0, extenders: Sequence = ()):
        self.filters = filters  # framework/runtime.py:FilterRunner
        self.extenders = extenders  # the scheduler's list, read at each attempt
        self.evict = evict
        self.clear_nomination = clear_nomination
        self.pdb_lister = pdb_lister or (lambda: [])
        self.min_pct = min_candidate_nodes_percentage
        self.min_abs = min_candidate_nodes_absolute
        self.rng = random.Random(seed)

    def name(self) -> str:
        return names.DEFAULT_PREEMPTION

    def set_framework(self, fwk) -> None:
        self.filters = fwk.filters

    def post_filter(self, pod: Pod, hints: Optional[Hints] = None,
                    unresolvable: Collection[str] = (), state=None
                    ) -> Tuple[Optional[str], Optional[str]]:
        """(the node the pod is nominated to, or None and the reason).
        ``unresolvable``: the nodes whose filter status was
        UnschedulableAndUnresolvable (none on the batched path). ``state``:
        the sequential cycle's PreFilter state, or its PreFilter's ``Fail``;
        None on the batch path, whose PreFilters did not run, so they run
        here (the JAX plugin's ``if not state.prefilter_ran``, ``:52-58``)."""
        if isinstance(state, Fail):
            return None, state.reason
        if state is None:
            state, reason = self.filters.pre_filter(pod)
            if reason is not None:
                return None, reason
        node_infos = list(self.filters.node_infos_fn())
        pdbs = list(self.pdb_lister())
        screen_fn = preferred = None
        if hints is not None:
            screen_row, slot_of, best_name = hints
            if not screen_row.any() and all(
                    ni.node is None or ni.node.meta.name in slot_of for ni in node_infos):
                # the screen proved no node can be freed and it covers every
                # node (one added after the encode has no slot and must be
                # dry-run): preemption.go:205's '0 nodes' outcome at O(1)
                return None, f"preemption: 0/{len(node_infos)} nodes are available"

            def screen_fn(name, _row=screen_row, _slots=slot_of):
                slot = _slots.get(name)
                return True if slot is None else bool(_row[slot])
            # the device ranking ignores PDB violations (criterion 1): with
            # PDBs, keep the screen and let the host rank
            if not pdbs:
                preferred = best_name
        ev = Evaluator(self.filters, state, pdbs, self.evict, self.clear_nomination, self.rng,
                       screen_fn=screen_fn, preferred_node=preferred,
                       min_candidate_nodes_percentage=self.min_pct,
                       min_candidate_nodes_absolute=self.min_abs,
                       extenders=self.extenders)
        return ev.preempt(pod, node_infos, unresolvable)
