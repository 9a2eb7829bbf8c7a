"""The drain orchestrator (``kubernetes_tpu/controllers/drain.py``): cordon
and uncordon, gang-aware drain waves, targeted evictions and spot
reclamation, all written through the store.

* ``cordon`` sets ``spec.unschedulable`` and adds the
  ``node.kubernetes.io/unschedulable:NoSchedule`` taint (kubectl's dual
  write), so NodeUnschedulable and TaintToleration both keep new pods off.
* ``drain_wave`` cordons a window of nodes and evicts their bound pods,
  each gang whole: a gang with a member on a draining node loses every
  bound member, wherever it is, so it binds again as a unit. Evicted pods
  are deleted and (by default) created again unbound, and the queue gets
  one EVICTION move per wave.
* ``evict_pods`` is the same eviction without a cordon; the quota reclaim
  pass evicts borrowers through it.
* ``spot_reclaim`` stamps the ``node.kubernetes.io/spot-reclaiming``
  NoExecute taint and evicts through the taint manager
  (``nodelifecycle.evict_noexecute_pods``).

Every wave records an ``evict_wave`` flight event and feeds
``evicted_pods`` (by reason) when a metrics set is attached.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Sequence

from ..api.types import TAINT_NO_EXECUTE, TAINT_NO_SCHEDULE, Node, Pod, PodStatus, Taint
from ..backend import telemetry
from ..framework.plugins.coscheduling import pod_group_key
from ..ops.encode import TOPO_SUPERPOD_LABEL
from ..ops.slice import is_slice_pod
from ..queue import events as qevents
from .nodelifecycle import evict_noexecute_pods

TAINT_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
TAINT_SPOT_RECLAIM = "node.kubernetes.io/spot-reclaiming"


def _with_taints(node: Node, taints: tuple) -> Node:
    new = dataclasses.replace(node)
    new.meta = dataclasses.replace(node.meta)
    new.spec = dataclasses.replace(node.spec, taints=taints)
    return new


def _unbound_clone(pod: Pod) -> Pod:
    clone = pod.clone()
    clone.spec.node_name = ""
    clone.status = PodStatus()
    return clone


class DrainOrchestrator:
    """The drain and reclaim ladder over ``store``. ``queue`` (a
    SchedulingQueue), when given, gets one EVICTION move per wave that
    evicted, so parked pods look again at the freed capacity."""

    def __init__(self, store, metrics=None, queue=None, now_fn=time.monotonic,
                 recreate: bool = True):
        self.store = store
        self.metrics = metrics
        self.queue = queue
        self.now_fn = now_fn
        self.recreate = recreate
        self.waves = 0
        self.evicted = 0
        # migrate-then-reopen: the waves drained with ``uncordon_after``,
        # each {"nodes", "pods", "since"}, until every evicted pod has bound
        # elsewhere or left the store (``poll_pending_uncordons``)
        self.pending_uncordons: List[Dict] = []

    # ------------------------------------------------------------- cordon

    def cordon(self, node_name: str) -> bool:
        node = self.store.nodes.get(node_name)
        if node is None or node.spec.unschedulable:
            return False
        taints = node.spec.taints
        if not any(t.key == TAINT_UNSCHEDULABLE for t in taints):
            taints = taints + (Taint(key=TAINT_UNSCHEDULABLE, effect=TAINT_NO_SCHEDULE),)
        new = _with_taints(node, taints)
        new.spec = dataclasses.replace(new.spec, unschedulable=True)
        self.store.update_node(new)
        return True

    def uncordon(self, node_name: str) -> bool:
        node = self.store.nodes.get(node_name)
        if node is None or not node.spec.unschedulable:
            return False
        new = _with_taints(node, tuple(t for t in node.spec.taints
                                       if t.key != TAINT_UNSCHEDULABLE))
        new.spec = dataclasses.replace(new.spec, unschedulable=False)
        self.store.update_node(new)
        return True

    # ------------------------------------------------------------- eviction

    def _gang_closure(self, pods: List[Pod]) -> List[Pod]:
        """The set grown to whole gangs: every bound member of a gang it
        touches."""
        groups = {pod_group_key(p) for p in pods} - {None}
        if not groups:
            return pods
        keys = {p.key() for p in pods}
        out = list(pods)
        for p in self.store.pods.values():
            if p.spec.node_name and p.key() not in keys and pod_group_key(p) in groups:
                out.append(p)
                keys.add(p.key())
        return out

    def _evict(self, pods: Sequence[Pod], reason: str) -> List[str]:
        """Delete the set, then create each pod again unbound (with
        ``recreate``). Every delete lands before any create: a gang is torn
        down whole before a member comes back, or its quorum would be
        judged against a half-deleted gang. Returns the keys evicted."""
        evicted: List[str] = []
        recreations: List[Pod] = []
        for pod in pods:
            key = pod.key()
            if self.store.get_pod(key) is None:
                continue
            self.store.delete_pod(key)
            evicted.append(key)
            if self.recreate:
                recreations.append(_unbound_clone(pod))
        for clone in recreations:
            self.store.create_pod(clone)
        if evicted:
            self.evicted += len(evicted)
            if self.metrics is not None:
                self.metrics.evicted_pods.inc(reason, value=len(evicted))
        return evicted

    def evict_pods(self, pods: Sequence[Pod], reason: str = "quota_reclaim") -> int:
        """The eviction without a cordon, each gang whole: the quota reclaim
        pass evicts borrowers through it. Returns the pods evicted."""
        closure = self._gang_closure(list(pods))
        evicted = self._evict(closure, reason)
        gangs = len({pod_group_key(p) for p in closure} - {None})
        self._wave_done(reason, 0, evicted, gangs)
        return len(evicted)

    def _wave_done(self, reason: str, nodes: int, evicted: List[str], gangs: int,
                   slice_gangs: int = 0) -> Dict[str, int]:
        self.waves += 1
        telemetry.event("evict_wave", reason=reason, nodes=nodes, pods=len(evicted),
                        gangs=gangs, sliceGangs=slice_gangs)
        if self.queue is not None and evicted:
            self.queue.move_all_to_active_or_backoff_queue(qevents.EVICTION)
        return {"nodes": nodes, "evicted": len(evicted), "gangs": gangs}

    def _pdb_disruption_gate(self):
        """A wave's PDB gate, ``fn(pod) -> bool``: a pod passes when every
        PodDisruptionBudget matching it has ``disruptions_allowed`` left
        after what this wave has already charged, and each pass charges one
        disruption to each of them. Pods no PDB matches pass freely."""
        spent: Dict[str, int] = {}

        def allow(pod: Pod) -> bool:
            matched = []
            for pdb in self.store.pdbs.values():
                if (pdb.meta.namespace == pod.meta.namespace and pdb.selector is not None
                        and pdb.selector.matches(pod.meta.labels)):
                    key = pdb.meta.key()
                    if pdb.disruptions_allowed - spent.get(key, 0) <= 0:
                        return False
                    matched.append(key)
            for key in matched:
                spent[key] = spent.get(key, 0) + 1
            return True

        return allow

    # ------------------------------------------------------------- waves

    def drain_wave(self, node_names: Iterable[str], gang_aware: bool = True, allow_fn=None,
                   uncordon_after: bool = False) -> Dict[str, int]:
        """Cordon every node of the window, then evict its bound pods (whole
        gangs when ``gang_aware``). ``allow_fn`` is a per-pod disruption
        gate (``_pdb_disruption_gate``), applied gang by gang: a gang goes
        only when every member passes. With ``uncordon_after`` the nodes
        stay cordoned until every evicted pod has bound elsewhere or left
        the store (``poll_pending_uncordons``)."""
        names = [n for n in node_names if n in self.store.nodes]
        for name in names:
            self.cordon(name)
        victims = [p for p in list(self.store.pods.values()) if p.spec.node_name in names]
        if gang_aware:
            victims = self._gang_closure(victims)
        if allow_fn is not None:
            victims = self._gate_whole_gangs(victims, allow_fn)
        gangs = len({pod_group_key(p) for p in victims} - {None})
        # slice gangs are evicted whole by the closure; counted apart for
        # the flight event
        slice_gangs = len({pod_group_key(p) for p in victims if is_slice_pod(p)} - {None})
        evicted = self._evict(victims, "drain")
        if uncordon_after:
            self.pending_uncordons.append({"nodes": list(names), "pods": list(evicted),
                                           "since": self.now_fn()})
        return self._wave_done("drain", len(names), evicted, gangs, slice_gangs=slice_gangs)

    def _gate_whole_gangs(self, victims: List[Pod], allow_fn) -> List[Pod]:
        """The gate applied per gang (a solo pod is a gang of one): a group
        passes when ``allow_fn`` passes every member, charged in order, so
        a refused group may have spent budget on its earlier members
        (conservative, never over budget)."""
        groups: Dict[object, List[Pod]] = {}
        for p in victims:
            groups.setdefault(pod_group_key(p) or p.key(), []).append(p)
        out: List[Pod] = []
        for members in groups.values():
            if all(allow_fn(p) for p in members):
                out.extend(members)
        return out

    def poll_pending_uncordons(self) -> List[str]:
        """Uncordon the nodes of each pending wave whose evicted pods have
        all bound to a node outside the wave or left the store. Returns the
        nodes reopened."""
        reopened: List[str] = []
        still: List[Dict] = []
        for wave in self.pending_uncordons:
            done = True
            for key in wave["pods"]:
                pod = self.store.get_pod(key)
                if pod is not None and (not pod.spec.node_name
                                        or pod.spec.node_name in wave["nodes"]):
                    done = False
                    break
            if done:
                for name in wave["nodes"]:
                    if self.uncordon(name):
                        reopened.append(name)
            else:
                still.append(wave)
        self.pending_uncordons = still
        return reopened

    def drain_superpod(self, superpod: int, gang_aware: bool = True) -> Dict[str, int]:
        """One wave over every host labelled with torus superpod
        ``superpod``: its slice gangs go whole and pack again elsewhere."""
        names = [n for n, node in self.store.nodes.items()
                 if node.meta.labels.get(TOPO_SUPERPOD_LABEL) == str(superpod)]
        return self.drain_wave(names, gang_aware=gang_aware)

    def spot_reclaim(self, node_names: Iterable[str], delete_nodes: bool = False,
                     gang_aware: bool = True) -> Dict[str, int]:
        """Stamp the NoExecute reclaim taint on the nodes and evict through
        the taint manager, PDB-gated: a pod that tolerates the taint (an
        unbounded toleration, or a finite window not yet over) stays, and
        so does one whose budget is spent (a later sweep takes it). With
        ``delete_nodes`` the nodes are deleted too, and every pod still
        bound to them goes first, tolerations and budgets notwithstanding.
        With ``gang_aware`` the gangs of the evicted pods lose their other
        bound members too."""
        names = [n for n in node_names if n in self.store.nodes]
        now = self.now_fn()
        taken: List[Pod] = []
        pdb_gate = self._pdb_disruption_gate()
        for name in names:
            node = self.store.nodes.get(name)
            taints = node.spec.taints
            if not any(t.key == TAINT_SPOT_RECLAIM for t in taints):
                node = _with_taints(node, taints + (Taint(key=TAINT_SPOT_RECLAIM,
                                                          effect=TAINT_NO_EXECUTE),))
                self.store.update_node(node)
            taken.extend(evict_noexecute_pods(self.store, node, now, since=now,
                                              metrics=self.metrics, reason="spot",
                                              allow_fn=pdb_gate))
        if delete_nodes:
            survivors = [p for p in list(self.store.pods.values())
                         if p.spec.node_name in names]
            for pod in survivors:
                self.store.delete_pod(pod.meta.key())
                taken.append(pod)
            if survivors and self.metrics is not None:
                self.metrics.evicted_pods.inc("spot", value=len(survivors))
        evicted = [p.key() for p in taken]
        self.evicted += len(evicted)
        gangs = 0
        if gang_aware and taken:
            groups = {pod_group_key(p) for p in taken} - {None}
            gangs = len(groups)
            survivors = [p for p in list(self.store.pods.values())
                         if p.spec.node_name and pod_group_key(p) in groups]
            evicted.extend(self._evict(survivors, "spot"))
        if self.recreate:
            # the taint manager's deletes bypass _evict: create their pods
            # again unbound
            for pod in taken:
                self.store.create_pod(_unbound_clone(pod))
        if delete_nodes:
            for name in names:
                self.store.delete_node(name)
        return self._wave_done("spot", len(names), evicted, gangs)
