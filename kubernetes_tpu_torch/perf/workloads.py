"""SchedulingBasic, the north-star workload, as API objects.

The reference's scheduler_perf case (test/integration/scheduler_perf/config/
performance-config.yaml, SchedulingBasic; ``kubernetes_tpu/perf/workloads.py``
and ``perf/harness.py`` in the JAX package): nodes of cpu 32 / 128Gi /
110 pods with zone and hostname labels, pods asking 900m / 2Gi.
"""

from __future__ import annotations

from typing import List

from ..api.types import Pod
from ..api.wrappers import make_node, make_pod
from ..framework.types import NodeInfo


def scheduling_basic_nodes(count: int, zones: int = 10) -> List[NodeInfo]:
    infos = []
    for i in range(count):
        nw = make_node(f"node-{i}").capacity({"cpu": "32", "memory": "128Gi", "pods": 110})
        nw.label("topology.kubernetes.io/zone", f"zone-{i % zones}")
        nw.label("kubernetes.io/hostname", f"node-{i}")
        infos.append(NodeInfo(nw.obj()))
    return infos


def scheduling_basic_pods(prefix: str, count: int) -> List[Pod]:
    return [make_pod(f"{prefix}-{i}").req({"cpu": "900m", "memory": "2Gi"}).obj()
            for i in range(count)]
