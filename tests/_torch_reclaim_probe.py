"""Whether the JAX loop's cohort reclaim pass evicts anything in
SchedulingSoak (``kubernetes_tpu/perf/workloads.py:scheduling_soak``): runs
the JAX workload through the JAX ``TPUScheduler`` on the CPU, on a
FakeClock, and prints one JSON line per variant with the quota plugin's
``reclaims_executed``, the recorded reclaim demand left at the end and the
soak's invariants.

    env JAX_PLATFORMS=cpu python tests/_torch_reclaim_probe.py [nodes]
"""

import json
import sys

from kubernetes_tpu.perf import harness
from kubernetes_tpu.perf import workloads as jw
from kubernetes_tpu.utils.clock import FakeClock


def probe(nodes: int, cohort: str, claims: bool) -> dict:
    case = jw.scheduling_soak(nodes=nodes, cohort=cohort, claims=claims)
    r = harness.Runner(backend="tpu", now_fn=FakeClock(), collect_metrics=[])
    try:
        r.run_ops(case["ops"])
    finally:
        r.close()
    quota = r.scheduler._quota_plugin()
    inv = next(it.data for it in r.data_items if it.labels.get("Name") == "SoakInvariants")
    return {"workload": case["name"], "claims": claims,
            "reclaims_executed": quota.reclaims_executed,
            "demand_left": {c: len(d) for c, d in quota._reclaim_demand.items()},
            "invariants": inv}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    for cohort in ("soak", ""):
        for claims in (True, False):
            print(json.dumps(probe(n, cohort, claims)), flush=True)
