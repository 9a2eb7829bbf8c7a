"""Controller manager (cmd/kube-controller-manager/app/controllermanager.go;
an own copy of ``kubernetes_tpu/controllers/manager.py``).

NewControllerInitializers-style registry: each initializer builds a
controller over the shared store + informer factory. ``sync_round`` pumps the
informer bus then drains every controller's queue once — the synchronous
analog of the worker goroutine pools; ``run`` drives that on a thread with
the node-health ticker. HA mirrors the scheduler: leader election on a Lease.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..client.informer import SharedInformerFactory
from ..client.leaderelection import LeaderElectionConfig, LeaderElector
from .base import Controller
from .housekeeping import (
    EndpointsController,
    GarbageCollector,
    NamespaceController,
    PodGCController,
    PVBinderController,
    ResourceQuotaController,
)
from .autoscaling import HorizontalPodAutoscalerController
from .auxiliary import (
    EndpointSliceMirroringController,
    EphemeralVolumeController,
    NodeIpamController,
    PVCProtectionController,
    PVProtectionController,
    RootCACertPublisher,
    ServiceAccountController,
    TTLAfterFinishedController,
)
from .certificates import (
    BootstrapSignerController,
    ClusterRoleAggregationController,
    CSRApprovingController,
    CSRCleanerController,
    CSRSigningController,
    PVExpanderController,
    TokenCleanerController,
)
from .disruption import DisruptionController
from .extras import (
    AttachDetachController,
    CronJobController,
    EndpointSliceController,
    TTLController,
)
from .nodelifecycle import NodeLifecycleController
from .podgroup import PodGroupController
from .resourceclaim import ResourceClaimController
from .workloads import (
    DaemonSetController,
    DeploymentController,
    JobController,
    ReplicaSetController,
    ReplicationControllerController,
    StatefulSetController,
)

Initializer = Callable[["ControllerManager"], Controller]


def _wall_now(m):
    """Wall-clock selection for controllers whose schedules/expirations name
    absolute times: the manager's monotonic default is duration-only, so use
    wall time unless the caller overrode now_fn (tests' FakeClock)."""
    return m.now_fn if m.now_fn is not time.monotonic else time.time


def new_controller_initializers() -> Dict[str, Initializer]:
    """controllermanager.go:412 NewControllerInitializers."""
    return {
        "deployment": lambda m: DeploymentController(m.store, m.factory),
        "replicaset": lambda m: ReplicaSetController(m.store, m.factory),
        "replicationcontroller": lambda m: ReplicationControllerController(m.store, m.factory),
        "statefulset": lambda m: StatefulSetController(m.store, m.factory),
        "daemonset": lambda m: DaemonSetController(m.store, m.factory),
        "job": lambda m: JobController(m.store, m.factory, now_fn=m.now_fn),
        "nodelifecycle": lambda m: NodeLifecycleController(
            m.store, m.factory, now_fn=m.now_fn, metrics=m.metrics
        ),
        "podgc": lambda m: PodGCController(m.store, m.factory),
        "garbagecollector": lambda m: GarbageCollector(m.store, m.factory),
        "namespace": lambda m: NamespaceController(m.store, m.factory),
        "endpoints": lambda m: EndpointsController(m.store, m.factory),
        "pvbinder": lambda m: PVBinderController(m.store, m.factory),
        "resourcequota": lambda m: ResourceQuotaController(m.store, m.factory),
        # gang-group status truth-keeper + orphaned-group GC (the controller
        # half of the Coscheduling lifecycle; GC ages on wall time)
        "podgroup": lambda m: PodGroupController(m.store, m.factory,
                                                 now_fn=_wall_now(m)),
        "disruption": lambda m: DisruptionController(m.store, m.factory),
        "ttl": lambda m: TTLController(m.store, m.factory),
        "endpointslice": lambda m: EndpointSliceController(m.store, m.factory),
        # cron needs WALL time (schedules name hours/days); the manager's
        # monotonic default is duration-only — pass it through only when the
        # caller overrode it (tests' FakeClock)
        "cronjob": lambda m: CronJobController(m.store, m.factory,
                                               now_fn=_wall_now(m)),
        "attachdetach": lambda m: AttachDetachController(m.store, m.factory),
        "serviceaccount": lambda m: ServiceAccountController(m.store, m.factory),
        "root-ca-cert-publisher": lambda m: RootCACertPublisher(m.store, m.factory),
        "ttlafterfinished": lambda m: TTLAfterFinishedController(
            m.store, m.factory, now_fn=m.now_fn),
        "pvcprotection": lambda m: PVCProtectionController(m.store, m.factory),
        "pvprotection": lambda m: PVProtectionController(m.store, m.factory),
        "nodeipam": lambda m: NodeIpamController(m.store, m.factory),
        "endpointslicemirroring": lambda m: EndpointSliceMirroringController(
            m.store, m.factory),
        "ephemeral-volume": lambda m: EphemeralVolumeController(m.store, m.factory),
        "resourceclaim": lambda m: ResourceClaimController(m.store, m.factory),
        "horizontalpodautoscaling": lambda m: HorizontalPodAutoscalerController(
            m.store, m.factory, now_fn=m.now_fn),
        # certificate/security loops (controllermanager.go:412 tail)
        "csrapproving": lambda m: CSRApprovingController(m.store, m.factory),
        "csrsigning": lambda m: CSRSigningController(
            m.store, m.factory, now_fn=_wall_now(m)),
        "csrcleaner": lambda m: CSRCleanerController(
            m.store, m.factory, now_fn=_wall_now(m)),
        "clusterrole-aggregation": lambda m: ClusterRoleAggregationController(
            m.store, m.factory),
        "tokencleaner": lambda m: TokenCleanerController(
            m.store, m.factory, now_fn=_wall_now(m)),
        "bootstrapsigner": lambda m: BootstrapSignerController(m.store, m.factory),
        "persistentvolume-expander": lambda m: PVExpanderController(
            m.store, m.factory),
    }


class ControllerManager:
    def __init__(self, store, factory: Optional[SharedInformerFactory] = None,
                 controllers: Optional[List[str]] = None, now_fn=time.monotonic,
                 leader_election: bool = False, identity: str = "kcm-0",
                 metrics=None):
        self.store = store
        self.factory = factory or SharedInformerFactory(store)
        self.now_fn = now_fn
        # optional SchedulerMetrics set: controllers that feed scheduler_*
        # families (the taint manager's evicted-pods counter) bind it here
        self.metrics = metrics
        inits = new_controller_initializers()
        names = controllers if controllers is not None else list(inits)
        self.controllers: Dict[str, Controller] = {n: inits[n](self) for n in names}
        self.elector = (
            LeaderElector(
                store,
                LeaderElectionConfig(lock_name="kube-controller-manager", identity=identity),
                now_fn=now_fn,
            )
            if leader_election
            else None
        )
        self._stop = threading.Event()
        self.factory.wait_for_cache_sync()

    def __getitem__(self, name: str) -> Controller:
        return self.controllers[name]

    def sync_round(self, monitor_nodes: bool = False) -> int:
        """Pump informers, drain every controller once; the per-tick body of
        run(). Returns reconciles performed."""
        if self.elector is not None and not self.elector.run_once():
            return 0
        self.factory.pump()
        n = 0
        for c in self.controllers.values():
            if monitor_nodes and isinstance(c, NodeLifecycleController):
                c.monitor_node_health()
            try:
                c.tick()  # time-driven hook; a bad object must not halt the round
            except Exception:  # noqa: BLE001
                import logging

                logging.getLogger(__name__).exception("%s: tick failed", c.name)
            n += c.sync_once()
        return n

    def settle(self, max_rounds: int = 50) -> int:
        """Sync until no controller has work (tests / deterministic drives)."""
        total = 0
        for _ in range(max_rounds):
            n = self.sync_round()
            total += n
            if n == 0:
                return total
        return total

    def run(self, tick: float = 0.1, node_monitor_period: float = 5.0) -> threading.Thread:
        """Background loop (Run, controllermanager.go:176)."""

        def _loop():
            last_monitor = 0.0
            while not self._stop.is_set():
                now = self.now_fn()
                monitor = now - last_monitor >= node_monitor_period
                if monitor:
                    last_monitor = now
                self.sync_round(monitor_nodes=monitor)
                self._stop.wait(tick)

        t = threading.Thread(target=_loop, name="controller-manager", daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
