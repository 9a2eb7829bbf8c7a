"""The port's controllers (``kubernetes_tpu/controllers/``): the
kube-controller-manager loops (pkg/controller/*, registered by
NewControllerInitializers, cmd/kube-controller-manager/app/
controllermanager.go:412) as informer-fed, workqueue-driven reconcilers over
the in-process store (``base.py``), the manager that builds and pumps them
(``manager.py``), and beside them the drain orchestrator (``drain.py``) and
the SLO-guarded rebalancer (``rebalance.py``).

Each controller watches kinds through the shared informer factory, enqueues
keys on a rate-limited workqueue and reconciles level-triggered. The manager
registers them initializer-style and pumps them in sync rounds.
"""

from .base import Controller
from .drain import TAINT_SPOT_RECLAIM, TAINT_UNSCHEDULABLE, DrainOrchestrator
from .housekeeping import (
    EndpointsController,
    GarbageCollector,
    NamespaceController,
    PodGCController,
    PVBinderController,
)
from .manager import ControllerManager
from .nodelifecycle import NodeLifecycleController, evict_noexecute_pods
from .rebalance import Rebalancer, packing_entropy, score_cluster, score_from_snapshot
from .resourceclaim import MissingTemplateError, ResourceClaimController
from .workloads import (
    DaemonSetController,
    DeploymentController,
    JobController,
    ReplicaSetController,
    StatefulSetController,
)

__all__ = [
    "TAINT_SPOT_RECLAIM",
    "TAINT_UNSCHEDULABLE",
    "Controller",
    "ControllerManager",
    "DaemonSetController",
    "DeploymentController",
    "DrainOrchestrator",
    "EndpointsController",
    "GarbageCollector",
    "JobController",
    "MissingTemplateError",
    "NamespaceController",
    "NodeLifecycleController",
    "PVBinderController",
    "PodGCController",
    "Rebalancer",
    "ReplicaSetController",
    "ResourceClaimController",
    "StatefulSetController",
    "evict_noexecute_pods",
    "packing_entropy",
    "score_cluster",
    "score_from_snapshot",
]
