"""Where a SchedulingBasic/5000Nodes batch spends its time on the card.

    python -m kubernetes_tpu_torch.perf.slice_profile

For each commit path of a topology-free batch, the fused kernel
(``KTPU_SPEC=0``) and the speculative rounds (``KTPU_SPEC=1``): runs 1000
init pods, then 1000 measured pods (host time per stage of BatchScheduler,
and for the rounds the rounds per batch), then 1000 more under
torch.profiler (device time by kernel name and the device's busy share of
the wall time; the profiler slows the host, so that share is a lower
bound). Prints one JSON object per part, each naming its path.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..backend import batch
from ..backend.batch_scheduler import BatchScheduler
from .workloads import scheduling_basic_nodes, scheduling_basic_pods

NODES, PODS, BATCH = 5000, 1000, 128
PATHS = (("fused", "0"), ("spec", "1"))  # (name, KTPU_SPEC)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_path(path: str) -> None:
    sched = BatchScheduler(scheduling_basic_nodes(NODES), device="cuda")
    sched.schedule(scheduling_basic_pods("init", PODS))
    sched.stage_seconds = dict.fromkeys(sched.stage_seconds, 0.0)
    before, rounds0 = sched.batches, batch.ROUNDS
    t0 = time.perf_counter()
    sched.schedule(scheduling_basic_pods("measured", PODS))
    wall = time.perf_counter() - t0
    n = sched.batches - before
    print(json.dumps({"part": "host stages", "path": path, "batches": n,
                      "paths": sorted(set(sched.batch_paths[before:])),
                      "rounds_per_batch": (batch.ROUNDS - rounds0) / n,
                      "wall_ms_per_batch": wall * 1e3 / n,
                      "stage_ms_per_batch": {k: v * 1e3 / n
                                             for k, v in sched.stage_seconds.items()}}))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sched.schedule(scheduling_basic_pods("profiled", PODS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"part": "device", "path": path, "wall_ms": wall * 1e3,
                      "device_busy_ms": busy_us / 1e3,
                      "busy_share": busy_us / 1e3 / (wall * 1e3),
                      "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}}))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("slice_profile needs a CUDA device")
    for path, flag in PATHS:
        os.environ["KTPU_SPEC"] = flag
        profile_path(path)


if __name__ == "__main__":
    main()
