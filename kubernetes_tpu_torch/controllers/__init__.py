"""The port's controllers (``kubernetes_tpu/controllers/``): the drain
orchestrator (``drain.py``), the NoExecute taint manager's eviction
(``nodelifecycle.py``) and the SLO-guarded rebalancer (``rebalance.py``).
The controller framework (``controllers/base.py``, the informers of
``client/``) and the controllers built on it are not ported yet."""

from .drain import TAINT_SPOT_RECLAIM, TAINT_UNSCHEDULABLE, DrainOrchestrator
from .nodelifecycle import evict_noexecute_pods
from .rebalance import Rebalancer, packing_entropy, score_cluster, score_from_snapshot

__all__ = ["TAINT_SPOT_RECLAIM", "TAINT_UNSCHEDULABLE", "DrainOrchestrator",
           "evict_noexecute_pods", "Rebalancer", "packing_entropy", "score_cluster",
           "score_from_snapshot"]
