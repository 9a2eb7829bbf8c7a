"""The port's controllers (``kubernetes_tpu/controllers/``): the drain
orchestrator (``drain.py``), the NoExecute taint manager's eviction
(``nodelifecycle.py``), the SLO-guarded rebalancer (``rebalance.py``), the
controller base (``base.py``: informer, workqueue, reconcile) and the
resourceclaim controller built on it (``resourceclaim.py``). The other
controllers of the JAX package and its manager are not ported yet."""

from .base import Controller
from .drain import TAINT_SPOT_RECLAIM, TAINT_UNSCHEDULABLE, DrainOrchestrator
from .nodelifecycle import evict_noexecute_pods
from .rebalance import Rebalancer, packing_entropy, score_cluster, score_from_snapshot
from .resourceclaim import MissingTemplateError, ResourceClaimController

__all__ = ["TAINT_SPOT_RECLAIM", "TAINT_UNSCHEDULABLE", "Controller", "DrainOrchestrator",
           "MissingTemplateError", "ResourceClaimController", "evict_noexecute_pods",
           "Rebalancer", "packing_entropy", "score_cluster", "score_from_snapshot"]
