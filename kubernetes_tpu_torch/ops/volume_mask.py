"""The host volume screen of the batched scheduler: a [P, N] bindability
mask per batch (own copy of ``kubernetes_tpu/ops/volume_mask.py``;
reference: volumebinding/binder.go FindPodVolumes, volumezone/volume_zone.go,
nodevolumelimits).

  * bound claims: the PV's admitted-node set (node-affinity label terms and
    the VolumeZone rule, over the node slot table; a PV with neither admits
    every node);
  * delayed (WaitForFirstConsumer) claims: per storage class, the free-PV
    count on a node must cover the pod's claim count of that class (Hall's
    condition only approximated).

Attach limits (NodeVolumeLimits) are not screened: they vary by CSINode, and
any fixed bound would under-admit. The mask is one-sided: it may admit a
node the exact filters reject, never the reverse. The commit path re-runs
the exact volume filters on the chosen node only
(``framework/plugins/volume.py:verify_on_node``).

The mask is built in numpy; the caller uploads it once per batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.types import BINDING_WAIT_FOR_FIRST_CONSUMER

# zone/region label keys a bound PV constrains (volume_zone.go:88)
ZONE_KEYS = (
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)


class VolumeMaskBuilder:
    """Per-scheduler cache of PV -> admitted-slot sets, keyed by the
    encoder's slot table and the snapshot's versions (slots churn with node
    add and remove, labels with node updates)."""

    def __init__(self, client):
        self.client = client
        self._pv_slots: Dict[str, Tuple[object, Optional[np.ndarray]]] = {}
        self._label_index_key = None
        self._label_index: Dict[Tuple[str, str], List[int]] = {}
        self._slot_of: Dict[str, int] = {}

    def batchable(self, pod) -> bool:
        """Every claim resolves and is bound or delayed-binding (an
        immediate-mode unbound claim never schedules: volume_binding.go:207)."""
        for claim in pod.spec.volumes:
            pvc = self.client.get_pvc(f"{pod.meta.namespace}/{claim}")
            if pvc is None:
                return False
            if not pvc.bound_pv:
                sc = self.client.get_storage_class(pvc.storage_class)
                if sc is None or sc.volume_binding_mode != BINDING_WAIT_FOR_FIRST_CONSUMER:
                    return False
        return True

    def _node_label_index(self, snapshot, version) -> Dict[Tuple[str, str], List[int]]:
        if self._label_index_key != version:
            self._label_index = {}
            for ni in snapshot.node_info_map.values():
                node = ni.node
                slot = self._slot_of.get(node.meta.name)
                if slot is None:
                    continue
                for k, v in node.meta.labels.items():
                    self._label_index.setdefault((k, v), []).append(slot)
            self._label_index_key = version
        return self._label_index

    def _pv_admitted(self, pv, snapshot, version, n_cap) -> Optional[np.ndarray]:
        """[N] bool of the slots this PV admits: its node-affinity terms AND
        the VolumeZone rule (`__`-separated multi-zone values allowed).
        None = every node."""
        constraints = list(pv.node_affinity.items())
        for key in ZONE_KEYS:
            val = pv.meta.labels.get(key)
            if val is not None:
                constraints.append((key, tuple(val.split("__"))))
        if not constraints:
            return None
        cache_key = (version, pv.meta.resource_version)
        cached = self._pv_slots.get(pv.meta.name)
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        idx = self._node_label_index(snapshot, version)
        mask = np.zeros(n_cap, bool)
        first = True
        for key, allowed in constraints:
            term = np.zeros(n_cap, bool)
            for v in allowed:
                for slot in idx.get((key, v), ()):
                    term[slot] = True
            mask = term if first else (mask & term)
            first = False
        self._pv_slots[pv.meta.name] = (cache_key, mask)
        return mask

    def build(self, pods, snapshot, encoder, n_cap: int, pad_to: int) -> Optional[np.ndarray]:
        """[pad_to, n_cap] bool; None when no pod of the batch has volumes.
        Rows of volume-less and padding pods are all-True."""
        if not any(pod.spec.volumes for pod in pods):
            return None
        self._slot_of = encoder.node_slots
        version = (len(encoder.node_slots), snapshot.structure_version,
                   snapshot.node_object_version)
        mask = np.ones((pad_to, n_cap), bool)
        # delayed-binding pools: per storage class, free-PV counts per node
        free_by_class: Dict[str, np.ndarray] = {}
        for p, pod in enumerate(pods):
            if not pod.spec.volumes:
                continue
            row = mask[p]
            delayed_needs: Dict[str, int] = {}
            for claim in pod.spec.volumes:
                pvc = self.client.get_pvc(f"{pod.meta.namespace}/{claim}")
                if pvc is None:
                    continue  # admit-all keeps the mask one-sided
                if pvc.bound_pv:
                    pv = self.client.get_pv(pvc.bound_pv)
                    if pv is None:
                        continue  # a dangling bind: the exact filters skip it too
                    admitted = self._pv_admitted(pv, snapshot, version, n_cap)
                    if admitted is not None:
                        row &= admitted
                else:
                    delayed_needs[pvc.storage_class] = delayed_needs.get(pvc.storage_class, 0) + 1
            for cls, need in delayed_needs.items():
                free = free_by_class.get(cls)
                if free is None:
                    free = np.zeros(n_cap, np.int32)
                    for pv in self.client.list_pvs():
                        if pv.bound_pvc or pv.storage_class != cls:
                            continue
                        admitted = self._pv_admitted(pv, snapshot, version, n_cap)
                        if admitted is None:
                            free += 1
                        else:
                            free += admitted.astype(np.int32)
                    free_by_class[cls] = free
                row &= free >= need
        return mask
