"""Kubelet volume manager + status manager (pkg/kubelet/volumemanager/,
pkg/kubelet/status/ — the last L4c internals); an own copy of
``kubernetes_tpu/kubelet/volume_manager.py``.

VolumeManager keeps the desired-state-of-world (every PVC volume of every
pod bound to this node) reconciled against the actual-state-of-world
(what is "mounted"): a pod's volumes must be attached (VolumeAttachment
written by the attachdetach controller) and mounted before the pod may
run (volumemanager/volume_manager.go WaitForAttachAndMount); pods leaving
the node unmount their volumes (reconciler.go). The mount operation
itself is environment — the state machine and the run-gate are the parity
surface.

StatusManager (status/status_manager.go) is the kubelet's write-through
cache for pod status: versioned per-pod status with no-op suppression, so
the API server sees each distinct status exactly once.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple


class VolumeManager:
    def __init__(self, store, node_name: str, require_attach: bool = True):
        self.store = store
        self.node_name = node_name
        # in-tree PVC volumes "mount" only after the attachdetach controller
        # wrote the VolumeAttachment (False = treat attach as instant, the
        # kubemark mode)
        self.require_attach = require_attach
        self.mounted: Set[Tuple[str, str]] = set()  # (pod key, pvc name)
        self.mounts_total = 0
        self.unmounts_total = 0

    # ------------------------------------------------------------ desired

    def _desired(self) -> Set[Tuple[str, str]]:
        out = set()
        for pod in self.store.snapshot_map("Pod").values():
            if pod.spec.node_name != self.node_name:
                continue
            if pod.status.phase in ("Succeeded", "Failed"):
                continue
            for claim in pod.spec.volumes:
                out.add((pod.meta.key(), claim))
        return out

    def _attached(self, pod_ns: str, claim: str) -> bool:
        pvc = self.store.pvcs.get(f"{pod_ns}/{claim}")
        if pvc is None or not pvc.bound_pv:
            return False
        if not self.require_attach:
            return True
        for va in self.store.volume_attachments.values():
            if va.pv_name == pvc.bound_pv and va.node_name == self.node_name \
                    and va.attached:
                return True
        return False

    # ---------------------------------------------------------- reconcile

    def reconcile(self) -> int:
        """One reconciler pass (reconciler.go:159): mount newly-desired
        volumes whose PV is attached, unmount no-longer-desired ones.
        Returns state transitions."""
        desired = self._desired()
        changes = 0
        for key in list(self.mounted - desired):
            self.mounted.discard(key)
            self.unmounts_total += 1
            changes += 1
        for pod_key, claim in desired - self.mounted:
            ns = pod_key.split("/", 1)[0]
            if self._attached(ns, claim):
                self.mounted.add((pod_key, claim))
                self.mounts_total += 1
                changes += 1
        return changes

    def wait_for_attach_and_mount(self, pod, reconcile: bool = True) -> bool:
        """volume_manager.go:368 WaitForAttachAndMount, non-blocking form:
        True when every volume of ``pod`` is mounted (the syncLoop's
        run-gate; the caller retries next sync instead of blocking).
        ``reconcile=False`` makes this a pure read of the mounted set —
        the syncLoop reconciles ONCE per tick and gates each pod cheaply
        (a per-pod reconcile would be O(pending x pods x attachments))."""
        if reconcile:
            self.reconcile()
        key = pod.meta.key()
        return all((key, claim) in self.mounted for claim in pod.spec.volumes)


class StatusManager:
    """status/status_manager.go: per-pod versioned status cache with no-op
    suppression — SetPodStatus bumps a version only when the status
    actually changed; syncPod writes only unsynced versions."""

    def __init__(self, store):
        self.store = store
        self._versions: Dict[str, int] = {}
        self._synced: Dict[str, int] = {}
        self._status: Dict[str, tuple] = {}
        self.api_writes = 0

    @staticmethod
    def _sig(status) -> tuple:
        return (status.phase, status.reason, status.message,
                status.nominated_node_name)

    def set_pod_status(self, pod, status) -> None:
        key = pod.meta.key()
        sig = self._sig(status)
        if self._status.get(key) == sig:
            return  # no-op update suppressed
        self._status[key] = sig
        self._versions[key] = self._versions.get(key, 0) + 1

    def sync(self) -> int:
        """Write every unsynced status through the API; returns writes."""
        wrote = 0
        for key, version in list(self._versions.items()):
            if self._synced.get(key) == version:
                continue
            pod = self.store.get_pod(key)
            if pod is None:
                self._versions.pop(key, None)
                self._synced.pop(key, None)
                self._status.pop(key, None)
                continue
            phase, reason, message, nominated = self._status[key]
            new = pod.clone()
            new.status.phase = phase
            new.status.reason = reason
            new.status.message = message
            new.status.nominated_node_name = nominated
            try:
                self.store.update_pod(new)
                wrote += 1
                self.api_writes += 1
                self._synced[key] = version
            except Exception:  # noqa: BLE001 — conflict: retry next sync
                pass
        return wrote
