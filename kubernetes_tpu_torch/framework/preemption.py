"""The preemption engine behind the DefaultPreemption PostFilter.

An own copy of ``kubernetes_tpu/framework/preemption.py``
(pkg/scheduler/framework/preemption/preemption.go) without metrics:

* ``preempt`` (:138): the eligibility check, the device-proposed node
  verified exactly first (and handed to the extenders: when they drop it,
  the walk runs), else the candidate walk over the nodes where preemption
  might help (not those whose filter status was
  UnschedulableAndUnresolvable, :363), trimmed by the extenders, one node
  picked, the victims evicted and lower nominations on it cleared;
* ``_call_extenders`` (:237-260): each interested extender that supports
  preemption rewrites the node -> victims map in turn; an error of an
  ignorable one skips it, of any other leaves no candidate;
* ``select_victims_on_node`` (default_preemption.go:226): on a copy of the
  node and of the PreFilter state remove every lower-priority pod (the
  RemovePod extensions move the state's counts), check the pod fits, then
  reprieve victims highest priority first (AddPod, or RemovePod again when
  one stays a victim), the pods whose eviction keeps every matching PDB
  within budget after those that would violate one;
* ``select_candidate`` (pickOneNodeForPreemption, :397): fewest PDB
  violations, lowest highest victim priority, smallest priority sum,
  fewest victims, latest start of the highest-priority victims, first in
  the walk;
* the candidate count (:172): max(minCandidateNodesPercentage of the
  nodes, minCandidateNodesAbsolute) (DefaultPreemption's arguments, 10%
  and 100 by default), at most every node, from a random offset.

The filters come from ``framework/runtime.py:FilterRunner``; statuses are
reason strings. ``prepare_candidate`` evicts through the ``evict``
callback and clears nominations through ``clear_nomination``, both the
caller's (``backend/batch_scheduler.py``).
"""

from __future__ import annotations

import random
from typing import Callable, Collection, Dict, List, Optional, Sequence, Tuple

from ..api import resource as resource_api
from ..api.types import Pod, PodDisruptionBudget
from .runtime import FilterRunner, PreFilterState
from .types import NodeInfo

POLICY_NEVER = "Never"
# the default minCandidateNodesPercentage and minCandidateNodesAbsolute
MIN_CANDIDATE_NODES_PERCENTAGE = 10
MIN_CANDIDATE_NODES_ABSOLUTE = 100


class Candidate:
    __slots__ = ("node_name", "victims", "num_pdb_violations")

    def __init__(self, node_name: str, victims: List[Pod], num_pdb_violations: int):
        self.node_name = node_name
        self.victims = victims
        self.num_pdb_violations = num_pdb_violations


def pdbs_for_pod(pod: Pod, pdbs: Sequence[PodDisruptionBudget]) -> List[PodDisruptionBudget]:
    return [p for p in pdbs
            if p.meta.namespace == pod.meta.namespace
            and p.selector is not None and p.selector.matches(pod.meta.labels)]


class Evaluator:
    """One preemption attempt for one unschedulable pod.

    ``screen_fn(name)``: the device screen's verdict for a node (replaces
    the host ``_max_free_prescreen``); ``preferred_node``: the device's
    top-ranked node, verified exactly before use."""

    def __init__(self, filters: FilterRunner, state: PreFilterState,
                 pdbs: Sequence[PodDisruptionBudget], evict: Callable[[Pod, Pod], None],
                 clear_nomination: Callable[[Pod], None], rng: random.Random,
                 screen_fn: Optional[Callable[[str], bool]] = None,
                 preferred_node: Optional[str] = None,
                 min_candidate_nodes_percentage: int = MIN_CANDIDATE_NODES_PERCENTAGE,
                 min_candidate_nodes_absolute: int = MIN_CANDIDATE_NODES_ABSOLUTE,
                 extenders: Sequence = ()):
        self.filters = filters
        self.extenders = extenders
        self.min_pct = min_candidate_nodes_percentage
        self.min_abs = min_candidate_nodes_absolute
        self.state = state
        self.pdbs = list(pdbs)
        self.evict = evict
        self.clear_nomination = clear_nomination
        self.rng = rng
        self.screen_fn = screen_fn
        self.preferred_node = preferred_node

    def preempt(self, pod: Pod, node_infos: List[NodeInfo], unresolvable: Collection[str] = ()
                ) -> Tuple[Optional[str], Optional[str]]:
        """(:138) (the nominated node, or None and the reason).
        ``unresolvable``: the nodes whose filter status was
        UnschedulableAndUnresolvable, which the walk skips."""
        by_name = {ni.node.meta.name: ni for ni in node_infos if ni.node is not None}
        if not self._pod_eligible_to_preempt_others(pod, by_name):
            return None, "preemption is not helpful for scheduling"
        if self.preferred_node is not None and self.preferred_node in by_name:
            victims, n_viol, ok = self.select_victims_on_node(pod, by_name[self.preferred_node])
            if ok:
                cands = self._call_extenders(
                    pod, [Candidate(self.preferred_node, victims, n_viol)])
                if cands:
                    self.prepare_candidate(cands[0], pod)
                    return cands[0].node_name, None
        candidates = self.find_candidates(pod, node_infos, unresolvable)
        if not candidates:
            return None, f"preemption: 0/{len(node_infos)} nodes are available"
        best = self.select_candidate(candidates)
        self.prepare_candidate(best, pod)
        return best.node_name, None

    def _pod_eligible_to_preempt_others(self, pod: Pod, by_name: Dict[str, NodeInfo]) -> bool:
        """PodEligibleToPreemptOthers (:319): a Never-policy pod cannot
        preempt; a pod nominated somewhere waits while a lower-priority pod
        there is still terminating."""
        if pod.spec.preemption_policy == POLICY_NEVER:
            return False
        nominated = pod.status.nominated_node_name
        if nominated and nominated in by_name:
            for p in by_name[nominated].pods:
                if p.meta.deletion_timestamp > 0 and p.spec.priority < pod.spec.priority:
                    return False
        return True

    def _offset_and_num_candidates(self, num_nodes: int) -> Tuple[int, int]:
        """(:172) a random offset; the count is max(pct * N, abs), at most N."""
        n = num_nodes * self.min_pct // 100
        if n < self.min_abs:
            n = self.min_abs
        if n > num_nodes:
            n = num_nodes
        return self.rng.randrange(num_nodes) if num_nodes else 0, n

    @staticmethod
    def _max_free_prescreen(pod: Pod, potential: List[NodeInfo]) -> List[bool]:
        """Whether the pod could fit on each node with every lower-priority
        pod removed: evicting pods frees at most their requests. Exact for
        the resource columns, conservative overall."""
        preq = pod.resource_request()
        p_cpu = preq.get(resource_api.CPU, 0)
        p_mem = preq.get(resource_api.MEMORY, 0)
        p_eph = preq.get(resource_api.EPHEMERAL_STORAGE, 0)
        out = []
        for ni in potential:
            free_cpu = ni.allocatable.milli_cpu - ni.requested.milli_cpu
            free_mem = ni.allocatable.memory - ni.requested.memory
            free_eph = ni.allocatable.ephemeral_storage - ni.requested.ephemeral_storage
            n_lower = 0
            for p in ni.pods:
                if p.spec.priority < pod.spec.priority:
                    r = p.resource_request()
                    free_cpu += r.get(resource_api.CPU, 0)
                    free_mem += r.get(resource_api.MEMORY, 0)
                    free_eph += r.get(resource_api.EPHEMERAL_STORAGE, 0)
                    n_lower += 1
            pods_free = ni.allocatable.allowed_pod_number - len(ni.pods) + n_lower
            out.append(p_cpu <= free_cpu and p_mem <= free_mem and p_eph <= free_eph
                       and pods_free >= 1)
        return out

    def find_candidates(self, pod: Pod, node_infos: List[NodeInfo],
                        unresolvable: Collection[str] = ()) -> List[Candidate]:
        """Dry runs from a random offset over the nodes the screen admits,
        until ``num`` candidates are found, among the nodes where
        preemption might help (``nodesWherePreemptionMightHelp``, :363).
        The batched path reports each failing node as unschedulable, so
        there it leaves none out."""
        potential = [ni for ni in node_infos
                     if ni.node is not None and ni.node.meta.name not in unresolvable]
        if not potential:
            return []
        offset, num = self._offset_and_num_candidates(len(potential))
        if self.screen_fn is not None:
            feasible = [self.screen_fn(ni.node.meta.name) for ni in potential]
        else:
            feasible = self._max_free_prescreen(pod, potential)
        candidates: List[Candidate] = []
        for i in range(len(potential)):
            k = (offset + i) % len(potential)
            if not feasible[k]:
                continue
            ni = potential[k]
            victims, n_viol, ok = self.select_victims_on_node(pod, ni)
            if ok:
                candidates.append(Candidate(ni.node.meta.name, victims, n_viol))
                if len(candidates) >= num:
                    break
        return self._call_extenders(pod, candidates)

    def _call_extenders(self, pod: Pod, candidates: List[Candidate]) -> List[Candidate]:
        """(:241) the interested extenders that support preemption trim the
        node -> victims map in turn; the candidates are the nodes left, in
        the map's order, each with its trimmed victims."""
        extenders = [e for e in self.extenders
                     if e.supports_preemption() and e.is_interested(pod)]
        if not extenders or not candidates:
            return candidates
        victims_by_node = {c.node_name: list(c.victims) for c in candidates}
        by_node = {c.node_name: c for c in candidates}
        for ext in extenders:
            try:
                victims_by_node = ext.process_preemption(pod, victims_by_node, None)
            except Exception:  # noqa: BLE001 - as JAX: any error, ignorable or not
                if ext.is_ignorable():
                    continue
                return []
        return [Candidate(n, v, by_node[n].num_pdb_violations)
                for n, v in victims_by_node.items() if n in by_node]

    def select_victims_on_node(self, pod: Pod, node_info: NodeInfo) -> Tuple[List[Pod], int, bool]:
        """(victims most important first, PDB violations, whether the pod
        fits), on copies of the node and of the PreFilter state."""
        ni = node_info.clone()
        state = self.state.clone()
        filters = self.filters
        remove = [p for p in ni.pods if p.spec.priority < pod.spec.priority]
        if not remove and not self._fits(state, pod, ni):
            return [], 0, False
        for victim in remove:
            ni.remove_pod(victim)
            filters.remove_pod(state, pod, victim, ni)
        if not self._fits(state, pod, ni):
            return [], 0, False
        # a pod violates when any matching PDB has no budget left; budgets
        # are consumed by the earlier non-violating victims
        violating, non_violating = [], []
        consumed: Dict[str, int] = {}
        for p in remove:
            matching = pdbs_for_pod(p, self.pdbs)
            is_viol = any(pdb.disruptions_allowed - consumed.get(pdb.meta.key(), 0) <= 0
                          for pdb in matching)
            if not is_viol:
                for pdb in matching:
                    k = pdb.meta.key()
                    consumed[k] = consumed.get(k, 0) + 1
            (violating if is_viol else non_violating).append(p)
        # most important first (util.MoreImportantPod: higher priority, then
        # earlier start)
        violating.sort(key=lambda p: (-p.spec.priority, p.status.start_time))
        non_violating.sort(key=lambda p: (-p.spec.priority, p.status.start_time))

        victims: List[Pod] = []

        def reprieve(p: Pod) -> bool:
            ni.add_pod(p)
            filters.add_pod(state, pod, p, ni)
            if self._fits(state, pod, ni):
                return True
            ni.remove_pod(p)
            filters.remove_pod(state, pod, p, ni)
            victims.append(p)
            return False

        num_violating = sum(not reprieve(p) for p in violating)
        for p in non_violating:
            reprieve(p)
        victims.sort(key=lambda p: (-p.spec.priority, p.status.start_time))
        return victims, num_violating, True

    def _fits(self, state: PreFilterState, pod: Pod, ni: NodeInfo) -> bool:
        return self.filters.filter_with_nominated_pods(state, pod, ni) is None

    @staticmethod
    def select_candidate(candidates: List[Candidate]) -> Candidate:
        """pickOneNodeForPreemption (:397), lexicographic on five keys; a
        candidate without victims wins outright (:404)."""
        if len(candidates) == 1:
            return candidates[0]

        def keys(c: Candidate):
            if not c.victims:
                return (0, -(1 << 62), -(1 << 62), 0, float("-inf"))
            highest = max(p.spec.priority for p in c.victims)
            total = sum(p.spec.priority for p in c.victims)
            hp_start = min(p.status.start_time for p in c.victims
                           if p.spec.priority == highest)
            # a later start of the highest-priority victims is preferred
            return (c.num_pdb_violations, highest, total, len(c.victims), -hp_start)

        return min(candidates, key=keys)

    def prepare_candidate(self, c: Candidate, pod: Pod) -> None:
        """(:331) evict the victims (a terminating one is already going) and
        clear the nominations of lower-priority pods to the node: they must
        be evaluated again."""
        for victim in c.victims:
            if victim.meta.deletion_timestamp > 0:
                continue
            self.evict(victim, pod)
        nominator = self.filters.nominator
        for p in list(nominator.nominated_pods_for_node(c.node_name)):
            if p.spec.priority < pod.spec.priority:
                nominator.delete_nominated_pod_if_exists(p)
                self.clear_nomination(p)
