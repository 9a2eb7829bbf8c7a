"""scheduler_perf for the port (``kubernetes_tpu/perf/``): the harness
(``harness.py``: Runner, DataItems, the collectors), its op-list test cases
(``cases.py``) and ``python -m kubernetes_tpu_torch.perf``; beside them the
workloads as API objects and the runs ``chip_smoke.py`` calls
(``workloads.py``), and the kernel, sharding and slice profilers."""

from .cases import TEST_CASES
from .harness import DataItem, Runner, ThroughputCollector, data_items_to_json, run_workload

__all__ = [
    "DataItem",
    "Runner",
    "ThroughputCollector",
    "data_items_to_json",
    "run_workload",
    "TEST_CASES",
]
