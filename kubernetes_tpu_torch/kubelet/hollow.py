"""Hollow kubelet (pkg/kubemark/hollow_kubelet.go:65,95 + the kubelet
control loop shape of pkg/kubelet/kubelet.go:1405 Run / :1987 syncLoop); an own copy of
``kubernetes_tpu/kubelet/hollow.py``.

Lifecycle per sync:
- register: create/refresh the Node object (kubelet_node_status.go)
- heartbeat: renew the node Lease (component-helpers lease controller) and
  the NodeStatus every status period
- syncLoop: pods bound to this node transition Pending → Running after a
  configurable startup delay; pods annotated ``kubelet/terminates-after``
  complete to Succeeded once run that long; deleted pods vanish immediately
  (no graceful-termination window in the hollow runtime)
- admission: pods bound beyond the node's ``pods`` allocatable are rejected
  Failed, newest first — the hollow stand-in for eviction_manager.go
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from ..api.types import Lease, Node, ObjectMeta, Pod
from ..apiserver.store import Conflict, NotFound, Store
from ..controllers.nodelifecycle import NODE_LEASE_NAMESPACE

TERMINATES_AFTER_ANNOTATION = "kubelet/terminates-after"
DEFAULT_LEASE_DURATION = 40.0
DEFAULT_STARTUP_DELAY = 0.0


class HollowKubelet:
    def __init__(self, store: Store, node: Node,
                 now_fn=time.monotonic,
                 startup_delay: float = DEFAULT_STARTUP_DELAY,
                 lease_duration: float = DEFAULT_LEASE_DURATION,
                 runtime=None):
        self.store = store
        self.node_name = node.name()
        self._node_template = node
        self.now_fn = now_fn
        self.startup_delay = startup_delay
        self.lease_duration = lease_duration
        self._started_at: Dict[str, float] = {}  # pod key → Running since
        self.registered = False
        # CRI runtime (kubelet/cri.py FakeRuntimeService or CRIClient):
        # when present, syncPod materializes pod state through RunPodSandbox/
        # CreateContainer/StartContainer and teardown through StopPodSandbox/
        # RemovePodSandbox (kubelet.go:1502 syncPod's runtime calls)
        self.runtime = runtime
        self._sandbox_of: Dict[str, str] = {}  # pod key → sandbox id
        # PLEG (pleg/generic.go): relists the runtime and emits lifecycle
        # events; syncLoopIteration consumes them to repair pods whose
        # containers changed state underneath the kubelet (crashes, runtime
        # restarts). Only meaningful with a runtime attached.
        from .pleg import GenericPLEG

        self.pleg = GenericPLEG(runtime, now_fn=now_fn) if runtime is not None else None
        self.pleg_restarts = 0  # containers restarted off PLEG died events
        # eviction manager seam (kubelet/eviction.py EvictionManager):
        # attach via attach_eviction_manager(); run_once drives it
        self.eviction_manager = None
        # resource-manager seam (kubelet/cm.py TopologyManager over
        # CPU/Device managers): admission gate at Pending→Running
        self.topology_manager = None
        # volume-manager seam (kubelet/volume_manager.py): PVC mounts gate
        # the Pending→Running transition (WaitForAttachAndMount)
        self.volume_manager = None

    # ------------------------------------------------------------ registration

    def register(self) -> None:
        """Create the Node object (kubelet_node_status.go registerWithAPIServer)."""
        try:
            self.store.create_node(self._node_template)
        except Conflict:
            pass
        self.registered = True
        self.heartbeat()

    # ------------------------------------------------------------ heartbeats

    @property
    def _lease_key(self) -> str:
        return f"{NODE_LEASE_NAMESPACE}/{self.node_name}"

    def heartbeat(self) -> None:
        """Renew the node Lease (the cheap 10s heartbeat the nodelifecycle
        controller watches; NodeStatus stays on its slower period)."""
        now = self.now_fn()
        lease = self.store.get_lease(self._lease_key)
        if lease is None:
            self.store.create_lease(Lease(
                meta=ObjectMeta(name=self.node_name, namespace=NODE_LEASE_NAMESPACE),
                holder_identity=self.node_name,
                lease_duration_seconds=self.lease_duration,
                acquire_time=now,
                renew_time=now,
            ))
            return
        new = dataclasses.replace(lease, renew_time=now)
        new.meta = dataclasses.replace(lease.meta)
        try:
            self.store.update_lease(new, expect_rv=lease.meta.resource_version)
        except (Conflict, NotFound):
            pass  # raced with another writer; next beat wins

    # ------------------------------------------------------------ syncLoop

    def _my_pods(self):
        return [p for p in self.store.snapshot_map("Pod").values()
                if p.spec.node_name == self.node_name]

    def _allowed_pods(self) -> int:
        node = self.store.nodes.get(self.node_name)
        if node is None:
            return 0
        return int(node.status.allocatable.get("pods", 0) or 0)

    def sync(self) -> int:
        """One syncLoopIteration over this node's pods (kubelet.go:2061);
        returns the number of pod status transitions written."""
        if not self.registered:
            self.register()
        now = self.now_fn()
        transitions = 0
        my_pods = self._my_pods()
        if self.volume_manager is not None:
            self.volume_manager.reconcile()  # once per tick; gates read cheaply
        # admission: the pods-capacity over-commit rejects newest first
        # (eviction_manager.go stand-in; scheduler normally prevents this)
        allowed = self._allowed_pods()
        if allowed and len([p for p in my_pods if p.status.phase in ("Pending", "Running")]) > allowed:
            active = sorted(
                (p for p in my_pods if p.status.phase in ("Pending", "Running")),
                key=lambda p: p.meta.resource_version,
            )
            for pod in active[allowed:]:
                self._runtime_remove(pod.meta.key())  # evicted: tear down
                self._set_phase(pod, "Failed")
                transitions += 1
            my_pods = self._my_pods()
        for pod in my_pods:
            key = pod.meta.key()
            if pod.status.phase == "Pending":
                started = self._started_at.setdefault(key, now)
                if now - started >= self.startup_delay:
                    if (self.volume_manager is not None and pod.spec.volumes
                            and not self.volume_manager.wait_for_attach_and_mount(
                                pod, reconcile=False)):
                        continue  # volumes not attached+mounted yet: retry next sync
                    if not self._cm_admit(pod):
                        transitions += 1
                        continue
                    self._runtime_start(pod)
                    self._set_phase(pod, "Running", start_time=now)
                    transitions += 1
            elif pod.status.phase == "Running":
                self._started_at.setdefault(key, now)
                if self.runtime is not None and key not in self._sandbox_of:
                    # bound pods arrive already Running (the binding
                    # subresource sets the phase); reconcile the runtime to
                    # match — the PLEG relist-and-repair direction
                    self._runtime_start(pod)
                ttl = pod.meta.annotations.get(TERMINATES_AFTER_ANNOTATION)
                if ttl is not None and now - self._started_at[key] >= float(ttl):
                    self._runtime_stop(key)
                    self._set_phase(pod, "Succeeded")
                    transitions += 1
        # forget state for pods that left the node; their sandboxes are
        # removed (the PLEG relist + garbage path, pleg/generic.go)
        live = {p.meta.key() for p in self._my_pods()}
        for key in list(self._started_at):
            if key not in live:
                del self._started_at[key]
                self._runtime_remove(key)
                if self.topology_manager is not None:
                    self.topology_manager.release(key)
        return transitions

    def _cm_admit(self, pod: Pod) -> bool:
        """Resource-manager admission (cm/topologymanager scope Admit): a
        hint-rejected pod fails with the TopologyAffinityError reason —
        the reference's UnexpectedAdmissionError path."""
        if self.topology_manager is None:
            return True
        from .cm import TopologyAffinityError

        try:
            self.topology_manager.admit(pod)
            return True
        except TopologyAffinityError as e:
            new = pod.clone()
            new.status.phase = "Failed"
            new.status.reason = "TopologyAffinityError"
            new.status.message = str(e)
            try:
                self.store.update_pod(new)
            except Exception:  # noqa: BLE001 — deleted mid-sync
                pass
            return False

    # ---------------------------------------------------------- CRI syncPod

    def _runtime_start(self, pod: Pod) -> None:
        """syncPod's create path: sandbox up, containers created+started."""
        if self.runtime is None:
            return
        sid = self.runtime.run_pod_sandbox({
            "name": pod.meta.name, "namespace": pod.meta.namespace,
            "uid": pod.meta.uid, "labels": dict(pod.meta.labels)})
        self._sandbox_of[pod.meta.key()] = sid
        for c in pod.spec.containers:
            cid = self.runtime.create_container(
                sid, {"name": c.name, "image": c.image})
            self.runtime.start_container(cid)

    def _runtime_stop(self, pod_key: str) -> None:
        """Graceful completion: containers stop first (exit 0 — a Succeeded
        pod's containers must not read as SIGKILLed), then the sandbox."""
        if self.runtime is None:
            return
        sid = self._sandbox_of.get(pod_key)
        if sid is not None:
            for c in self.runtime.list_containers(sid):
                if c["state"] == "CONTAINER_RUNNING":
                    self.runtime.stop_container(c["id"])
            self.runtime.stop_pod_sandbox(sid)

    def _runtime_remove(self, pod_key: str) -> None:
        if self.runtime is None:
            return
        sid = self._sandbox_of.pop(pod_key, None)
        if sid is not None:
            self.runtime.stop_pod_sandbox(sid)
            self.runtime.remove_pod_sandbox(sid)

    def _set_phase(self, pod: Pod, phase: str, start_time: Optional[float] = None) -> None:
        new = pod.clone()
        new.status.phase = phase
        if start_time is not None and not new.status.start_time:
            new.status.start_time = start_time
        try:
            self.store.update_pod(new)
        except NotFound:
            pass  # deleted mid-sync

    # ------------------------------------------------------------- PLEG loop

    def _process_pleg_events(self) -> int:
        """syncLoopIteration's plegCh arm (kubelet.go:2061): a ContainerDied
        for a pod that should be Running is repaired per restartPolicy
        (Always — the default; hollow pods carry no explicit policy)."""
        if self.pleg is None:
            return 0
        from .pleg import CONTAINER_DIED

        repaired = 0
        for ev in self.pleg.relist():
            if ev.type != CONTAINER_DIED:
                continue
            pod = self.store.get_pod(ev.pod_key)
            if pod is None or pod.status.phase != "Running":
                continue  # deletion teardown or completed pod: expected death
            sid = self._sandbox_of.get(ev.pod_key)
            if sid is None:
                continue
            status = self.runtime.container_status(ev.data)
            if status is not None and status["state"] == "CONTAINER_EXITED":
                self.runtime.remove_container(ev.data)
                cid = self.runtime.create_container(
                    sid, {"name": status.get("name", "c"),
                          "image": status.get("image", "")})
                self.runtime.start_container(cid)
                repaired += 1
                self.pleg_restarts += 1
        return repaired

    def attach_eviction_manager(self, mgr) -> None:
        self.eviction_manager = mgr

    def run_once(self) -> int:
        """register + heartbeat + PLEG relist + eviction pass + sync —
        one full kubelet tick."""
        if not self.registered:
            self.register()
        self.heartbeat()
        self._process_pleg_events()
        if self.eviction_manager is not None:
            self.eviction_manager.synchronize()
        return self.sync()
