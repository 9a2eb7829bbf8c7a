"""Pod Lifecycle Event Generator (pkg/kubelet/pleg/generic.go); an own copy of
``kubernetes_tpu/kubelet/pleg.py``.

The kubelet's syncLoop must react to container state changes it did not
cause (crashes, OOM kills, runtime restarts). The reference's GenericPLEG
relists the runtime every second, diffs each pod's container states against
the previous relist, and emits PodLifecycleEvents that syncLoopIteration
(kubelet.go:2061) consumes to trigger per-pod syncs.

This PLEG speaks the CRI surface (kubelet/cri.py FakeRuntimeService or
CRIClient over real gRPC): ListPodSandbox + ListContainers are the relist,
sandbox/container ids key the state records, and the event types mirror
pleg/generic.go's (ContainerStarted/ContainerDied/ContainerRemoved/
PodSync). Relist health doubles as the runtime liveness probe
(Healthy(), generic.go:134 — a stuck runtime shows up as relist age).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

CONTAINER_STARTED = "ContainerStarted"
CONTAINER_DIED = "ContainerDied"
CONTAINER_REMOVED = "ContainerRemoved"
POD_SYNC = "PodSync"

_RUNNING = "CONTAINER_RUNNING"
_EXITED = "CONTAINER_EXITED"

# relist staleness above this marks the runtime unhealthy
# (pleg/generic.go:135 relistThreshold = 3min)
RELIST_THRESHOLD_S = 180.0


@dataclasses.dataclass(frozen=True)
class PodLifecycleEvent:
    """pleg/pleg.go PodLifecycleEvent: the pod key + what happened."""

    pod_uid: str
    pod_key: str  # "namespace/name" — the syncLoop's dirty-pod key
    type: str
    data: str = ""  # container id for container events


class GenericPLEG:
    def __init__(self, runtime, now_fn=time.monotonic):
        self.runtime = runtime
        self.now_fn = now_fn
        # sandbox id -> {container id -> state}; sandbox id -> meta
        self._containers: Dict[str, Dict[str, str]] = {}
        self._sandbox_meta: Dict[str, dict] = {}
        self._sandbox_state: Dict[str, str] = {}
        self.last_relist: Optional[float] = None
        self.events_emitted = 0

    # ------------------------------------------------------------------ util

    @staticmethod
    def _pod_key(meta: dict) -> str:
        return f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"

    def healthy(self) -> bool:
        """generic.go:134 Healthy: relist must have run recently."""
        if self.last_relist is None:
            return True  # not started yet
        return (self.now_fn() - self.last_relist) < RELIST_THRESHOLD_S

    # ---------------------------------------------------------------- relist

    def relist(self) -> List[PodLifecycleEvent]:
        """One relist pass (generic.go:190): snapshot the runtime, diff
        against the previous snapshot, emit events."""
        events: List[PodLifecycleEvent] = []
        sandboxes = {s["id"]: s for s in self.runtime.list_pod_sandbox()}
        containers_now: Dict[str, Dict[str, str]] = {}
        for sid, sbx in sandboxes.items():
            containers_now[sid] = {
                c["id"]: c["state"] for c in self.runtime.list_containers(sid)
            }
            cfg = sbx.get("config") or sbx  # FakeRuntimeService nests config
            meta = {"name": cfg.get("name", ""),
                    "namespace": cfg.get("namespace", "default"),
                    "uid": cfg.get("uid", "")}
            self._sandbox_meta[sid] = meta

        seen = set(sandboxes) | set(self._containers)
        for sid in seen:
            meta = self._sandbox_meta.get(sid, {})
            key = self._pod_key(meta)
            uid = meta.get("uid", "")
            old = self._containers.get(sid, {})
            new = containers_now.get(sid, {})
            for cid in set(old) | set(new):
                o, n = old.get(cid), new.get(cid)
                if o == n:
                    continue
                if n == _RUNNING:
                    events.append(PodLifecycleEvent(uid, key, CONTAINER_STARTED, cid))
                elif n == _EXITED and o == _RUNNING:
                    events.append(PodLifecycleEvent(uid, key, CONTAINER_DIED, cid))
                elif n is None:
                    # removed (or the whole sandbox vanished)
                    t = (CONTAINER_DIED if o == _RUNNING else CONTAINER_REMOVED)
                    events.append(PodLifecycleEvent(uid, key, t, cid))
                    if o == _RUNNING:
                        events.append(
                            PodLifecycleEvent(uid, key, CONTAINER_REMOVED, cid))
                else:
                    events.append(PodLifecycleEvent(uid, key, POD_SYNC, cid))
            # sandbox state change with no container change still syncs
            sb_old = self._sandbox_state.get(sid)
            sb_new = sandboxes[sid]["state"] if sid in sandboxes else None
            if sb_old != sb_new and not any(e.pod_key == key for e in events):
                events.append(PodLifecycleEvent(uid, key, POD_SYNC))
            if sb_new is not None:
                self._sandbox_state[sid] = sb_new
            else:
                self._sandbox_state.pop(sid, None)
                self._sandbox_meta.pop(sid, None)

        self._containers = containers_now
        self.last_relist = self.now_fn()
        self.events_emitted += len(events)
        return events
