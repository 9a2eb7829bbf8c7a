"""Kubelet container/resource managers (pkg/kubelet/cm/ — the last L4c
internals gap: cpumanager, devicemanager, topologymanager); an own copy of
``kubernetes_tpu/kubelet/cm.py``.

Reduced to the decision surfaces that change pod outcomes:

  * ``CPUManager`` (cm/cpumanager/policy_static.go): the static policy
    gives GUARANTEED pods with integer CPU requests exclusive cores drawn
    from the shared pool, preferring cores packed on one NUMA node;
    everything else runs on the shared pool. Assignments checkpoint
    through the checksummed CheckpointManager (cpu_manager_state file) so
    they survive kubelet restarts.
  * ``DeviceManager`` (cm/devicemanager/manager.go): device plugins
    register allocatable device IDs per extended resource; pods requesting
    the resource get specific device IDs allocated, checkpointed
    (kubelet_internal_checkpoint), and released on pod removal.
  * ``TopologyManager`` (cm/topologymanager/): merges the NUMA affinity
    hints the other managers provide; policies none / best-effort /
    restricted / single-numa-node; restricted+single-numa reject pods
    whose merged hint is not preferred (the TopologyAffinityError path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..api.types import Pod
from .checkpoint import CheckpointManager

CPU_STATE_CHECKPOINT = "cpu_manager_state"
DEVICE_STATE_CHECKPOINT = "kubelet_internal_checkpoint"

POLICY_NONE = "none"
POLICY_BEST_EFFORT = "best-effort"
POLICY_RESTRICTED = "restricted"
POLICY_SINGLE_NUMA = "single-numa-node"


class TopologyAffinityError(Exception):
    """topologymanager admission failure (scope.go Admit): the pod's
    resource hints cannot be satisfied under the configured policy."""


@dataclasses.dataclass(frozen=True)
class TopologyHint:
    """cm/topologymanager/topology_hints.go: a NUMA-node set that can
    satisfy a request, and whether it is the minimal (preferred) one."""

    numa_nodes: Tuple[int, ...]
    preferred: bool


def _is_guaranteed_integer_cpu(pod: Pod) -> Optional[int]:
    """policy_static.go: exclusive cores only for Guaranteed QoS pods whose
    cpu request is a whole number of cores (requests == limits)."""
    from ..api import resource as resource_api

    total = 0
    for c in pod.spec.containers:
        req = c.requests.get("cpu")
        if req is None:
            return None
        lim = c.limits.get("cpu", req)
        r = resource_api.canonical("cpu", req)
        if r != resource_api.canonical("cpu", lim) or r % 1000:
            return None
        total += r // 1000
    return total or None


class CPUManager:
    def __init__(self, checkpoints: CheckpointManager,
                 cores_per_numa: Sequence[int] = (4, 4)):
        """``cores_per_numa``: core count per NUMA node; core ids are
        assigned sequentially (node 0: 0..n-1, node 1: n.., ...)."""
        self.checkpoints = checkpoints
        self.numa_of: Dict[int, int] = {}
        core = 0
        for node, n in enumerate(cores_per_numa):
            for _ in range(n):
                self.numa_of[core] = node
                core += 1
        self.assignments: Dict[str, List[int]] = {}  # pod key -> cores
        self._restore()

    # ------------------------------------------------------------ state

    def _restore(self) -> None:
        doc = self.checkpoints.get_checkpoint(CPU_STATE_CHECKPOINT)
        if doc:
            self.assignments = {k: list(v) for k, v in doc["entries"].items()}

    def _persist(self) -> None:
        self.checkpoints.create_checkpoint(
            CPU_STATE_CHECKPOINT, {"entries": self.assignments})

    # ------------------------------------------------------------ pool

    def _free_cores(self) -> List[int]:
        used = {c for cores in self.assignments.values() for c in cores}
        return [c for c in sorted(self.numa_of) if c not in used]

    def topology_hints(self, pod: Pod) -> Optional[List[TopologyHint]]:
        """Per-NUMA feasibility for the pod's exclusive-core demand; None =
        no exclusive demand (no hint, topologymanager treats as don't-care)."""
        want = _is_guaranteed_integer_cpu(pod)
        if want is None:
            return None
        free = self._free_cores()
        by_numa: Dict[int, int] = {}
        for c in free:
            by_numa[self.numa_of[c]] = by_numa.get(self.numa_of[c], 0) + 1
        hints = [TopologyHint((node,), True)
                 for node, n in sorted(by_numa.items()) if n >= want]
        if not hints and len(free) >= want:
            hints.append(TopologyHint(tuple(sorted(by_numa)), False))
        return hints

    def allocate(self, pod: Pod, hint: Optional[TopologyHint] = None) -> List[int]:
        """Assign exclusive cores (empty list = shared pool). Prefers cores
        on the hint's NUMA nodes, packing one node first."""
        key = pod.meta.key()
        if key in self.assignments:
            return self.assignments[key]
        want = _is_guaranteed_integer_cpu(pod)
        if want is None:
            return []
        free = self._free_cores()
        if hint is not None:
            preferred = [c for c in free if self.numa_of[c] in hint.numa_nodes]
            free = preferred + [c for c in free if c not in preferred]
        if len(free) < want:
            raise TopologyAffinityError(
                f"not enough exclusive cores: want {want}, free {len(free)}")
        cores = free[:want]
        self.assignments[key] = cores
        self._persist()
        return cores

    def release(self, pod_key: str) -> None:
        if self.assignments.pop(pod_key, None) is not None:
            self._persist()


class DeviceManager:
    def __init__(self, checkpoints: CheckpointManager):
        self.checkpoints = checkpoints
        # resource -> {device id -> numa node}
        self.registry: Dict[str, Dict[str, int]] = {}
        # pod key -> {resource -> [device ids]}
        self.allocations: Dict[str, Dict[str, List[str]]] = {}
        self._restore()

    def _restore(self) -> None:
        doc = self.checkpoints.get_checkpoint(DEVICE_STATE_CHECKPOINT)
        if doc:
            self.allocations = {
                k: {r: list(ids) for r, ids in v.items()}
                for k, v in doc["pod_devices"].items()}

    def _persist(self) -> None:
        self.checkpoints.create_checkpoint(
            DEVICE_STATE_CHECKPOINT, {"pod_devices": self.allocations})

    # ---------------------------------------------------------- plugins

    def register_plugin(self, resource: str, devices: Dict[str, int]) -> None:
        """Device plugin registration (ListAndWatch's device set): device
        id -> NUMA node."""
        self.registry[resource] = dict(devices)

    def _free_devices(self, resource: str) -> List[str]:
        used = {d for alloc in self.allocations.values()
                for r, ids in alloc.items() if r == resource for d in ids}
        return [d for d in sorted(self.registry.get(resource, ()))
                if d not in used]

    def _demand(self, pod: Pod) -> Dict[str, int]:
        from ..api import resource as resource_api

        out: Dict[str, int] = {}
        for c in pod.spec.containers:
            for res, q in c.requests.items():
                if res in self.registry:
                    out[res] = out.get(res, 0) + resource_api.canonical(res, q)
        return out

    def topology_hints(self, pod: Pod) -> Optional[List[TopologyHint]]:
        demand = self._demand(pod)
        if not demand:
            return None
        hints: Optional[set] = None
        for res, want in demand.items():
            free = self._free_devices(res)
            by_numa: Dict[int, int] = {}
            for d in free:
                node = self.registry[res][d]
                by_numa[node] = by_numa.get(node, 0) + 1
            mine = {(node,) for node, n in by_numa.items() if n >= want}
            hints = mine if hints is None else (hints & mine)
        out = [TopologyHint(h, True) for h in sorted(hints or ())]
        if not out and all(len(self._free_devices(r)) >= w
                           for r, w in demand.items()):
            out.append(TopologyHint(tuple(sorted(
                {n for r in demand for n in self.registry[r].values()})), False))
        return out

    def allocate(self, pod: Pod, hint: Optional[TopologyHint] = None
                 ) -> Dict[str, List[str]]:
        key = pod.meta.key()
        if key in self.allocations:
            return self.allocations[key]
        demand = self._demand(pod)
        if not demand:
            return {}
        alloc: Dict[str, List[str]] = {}
        for res, want in demand.items():
            free = self._free_devices(res)
            if hint is not None:
                preferred = [d for d in free
                             if self.registry[res][d] in hint.numa_nodes]
                free = preferred + [d for d in free if d not in preferred]
            if len(free) < want:
                raise TopologyAffinityError(
                    f"insufficient {res}: want {want}, free {len(free)}")
            alloc[res] = free[:want]
        self.allocations[key] = alloc
        self._persist()
        return alloc

    def release(self, pod_key: str) -> None:
        if self.allocations.pop(pod_key, None) is not None:
            self._persist()


class TopologyManager:
    """cm/topologymanager/scope_container.go Admit, reduced to pod scope:
    gather each provider's hints, merge (bitwise-AND of NUMA sets across
    providers, narrowest preferred wins), allocate under the merged hint."""

    def __init__(self, policy: str = POLICY_BEST_EFFORT,
                 providers: Sequence[object] = ()):
        assert policy in (POLICY_NONE, POLICY_BEST_EFFORT,
                          POLICY_RESTRICTED, POLICY_SINGLE_NUMA)
        self.policy = policy
        self.providers = list(providers)

    def _merge(self, all_hints: List[List[TopologyHint]]) -> TopologyHint:
        """topology_manager.go mergeProvidersHints: cross-product AND; the
        best (fewest NUMA nodes, preferred) non-empty intersection wins."""
        merged: Optional[TopologyHint] = None
        from itertools import product

        for combo in product(*all_hints):
            nodes = None
            preferred = all(h.preferred for h in combo)
            for h in combo:
                s = set(h.numa_nodes)
                nodes = s if nodes is None else (nodes & s)
            if not nodes:
                continue
            cand = TopologyHint(tuple(sorted(nodes)), preferred)
            if merged is None or (cand.preferred, -len(cand.numa_nodes)) > \
                    (merged.preferred, -len(merged.numa_nodes)):
                merged = cand
        return merged if merged is not None else TopologyHint((), False)

    def _allocate_all(self, pod: Pod, hint: Optional[TopologyHint]) -> None:
        """Allocate across providers with ROLLBACK: a later provider's
        failure must release what earlier providers already persisted, or
        the Failed pod (which stays in the store) pins cores/devices
        forever and later pods are spuriously rejected."""
        done = []
        try:
            for p in self.providers:
                p.allocate(pod, hint)
                done.append(p)
        except TopologyAffinityError:
            for p in done:
                p.release(pod.meta.key())
            raise

    def admit(self, pod: Pod) -> Optional[TopologyHint]:
        """Admit + allocate; raises TopologyAffinityError on rejection.
        Returns the merged hint (None when no provider had demand)."""
        if self.policy == POLICY_NONE:
            self._allocate_all(pod, None)
            return None
        all_hints = [h for p in self.providers
                     if (h := p.topology_hints(pod)) is not None]
        if not all_hints:
            return None
        if any(not hs for hs in all_hints):
            raise TopologyAffinityError("a provider has no feasible placement")
        merged = self._merge(all_hints)
        if not merged.numa_nodes:
            raise TopologyAffinityError("providers' NUMA hints do not intersect")
        if self.policy == POLICY_SINGLE_NUMA and (
                not merged.preferred or len(merged.numa_nodes) != 1):
            raise TopologyAffinityError(
                f"single-numa-node policy rejects hint {merged.numa_nodes}")
        if self.policy == POLICY_RESTRICTED and not merged.preferred:
            raise TopologyAffinityError(
                f"restricted policy rejects non-preferred hint {merged.numa_nodes}")
        self._allocate_all(pod, merged)
        return merged

    def release(self, pod_key: str) -> None:
        for p in self.providers:
            p.release(pod_key)
