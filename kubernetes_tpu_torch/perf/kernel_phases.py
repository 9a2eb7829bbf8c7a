"""Where the fused-step kernel spends a pod's step, on the card.

    python -m kubernetes_tpu_torch.perf.kernel_phases

Builds ``csrc/fused_step.cu`` twice: as shipped, and with
``-DKTPU_PHASE_STAMPS``, where thread 32 of each block (the first thread of
warp 1, which owns a node) records ``clock64()`` at each phase boundary of
each pod. Both run the first SchedulingBasic/5000Nodes batch (N=5120 node
slots, P=128). Prints one JSON object per part: the shipped kernel's median
CUDA-event time over 30 launches, and, from one stamped launch, its cycles
per pod, the SM clock those imply, and the median time of each phase over
the pods, for each block of the cluster. The stamps add a few instructions,
so the stamped kernel runs slightly slower than the shipped one.
"""

from __future__ import annotations

import ctypes
import json
import statistics

import numpy as np
import torch

from ..backend.batch import _pod_port_bits, static_phase
from ..backend.device_state import DeviceState, caps_for_cluster
from ..cache.snapshot import Snapshot
from ..ops import fused_step
from .workloads import scheduling_basic_nodes, scheduling_basic_pods

NODES, BATCH = 5000, 128
WEIGHTS = (1.0, 1.0, 3.0, 2.0, 1.0)
KERNEL_ARGS = ("alloc", "requested", "nonzero", "ports", "p_req", "p_nz", "p_bits",
               "static_ok", "static_ff", "taint", "aff", "img", "jitter",
               "nominated", "p_valid")
STAMPS, STAMP_PODS = 12, 4096  # kStamps and kStampPods of the kernel source
# (from stamp, to stamp, phase) along one pod's step, as warp 1 sees it
PHASES = (
    (0, 1, "top of the pod"),
    (1, 2, "pass 1"),
    (2, 3, "block reduction 1"),
    (3, 4, "arrive 1, first node's resource score"),
    (4, 5, "wait 1"),
    (5, 6, "combine the 8 partials"),
    (6, 7, "pass 2"),
    (7, 8, "block argmax"),
    (8, 9, "arrive 2, next pod's loads started"),
    (9, 10, "wait 2"),
    (10, 11, "winner and commit"),
)


def scheduling_basic_args(device) -> dict:
    """The kernel's inputs for the first SchedulingBasic batch, built by the
    port's own main path (sync, encode, static phase)."""
    ds = DeviceState(caps_for_cluster(NODES), device)
    ds.sync(Snapshot(scheduling_basic_nodes(NODES)))
    pb, et = ds.encoder.encode_pods(scheduling_basic_pods("init", BATCH))
    _m, static_ok, static_ff, taint, aff, img, jitter = static_phase(pb, et, ds.nt)
    nt = ds.nt
    vals = (nt.allocatable, nt.requested, nt.nonzero_requested, nt.port_bits,
            pb.req, pb.nonzero_req, _pod_port_bits(pb, nt.port_bits.shape[1]),
            static_ok, static_ff, taint, aff, img, jitter, pb.nominated, pb.valid)
    return {k: v.contiguous() for k, v in zip(KERNEL_ARGS, vals)}


def _timed(args) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fused_step.fused_step_batch(*args, WEIGHTS)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run_stamped(args) -> tuple:
    """Launch the stamped build of the kernel through the wrapper, after a
    few warm-up launches. Returns (outputs, stamps as int64 [CLUSTER, P,
    STAMPS] clock64() readings, the last launch's CUDA-event ms)."""
    stamped = fused_step.load_library(fused_step.build_library(("KTPU_PHASE_STAMPS",)))
    stamped.ktpu_read_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    shipped = fused_step._library
    fused_step._library = lambda: stamped  # the wrapper launches the stamped build
    try:
        for _ in range(5):
            fused_step.fused_step_batch(*args, WEIGHTS)
        out = fused_step.fused_step_batch(*args, WEIGHTS)  # compiled and warm: time the next
        ms = _timed(args)
    finally:
        fused_step._library = shipped
    buf = np.zeros(fused_step.CLUSTER * STAMP_PODS * STAMPS, np.int64)
    rc = stamped.ktpu_read_phase_stamps(buf.ctypes.data, STAMP_PODS, STAMPS)
    if rc != 0:
        raise RuntimeError(f"reading the stamps failed: {stamped.ktpu_cuda_error_string(rc)}")
    pods = args[4].shape[0]
    return out, buf.reshape(fused_step.CLUSTER, STAMP_PODS, STAMPS)[:, :pods], ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases needs a CUDA device")
    args = list(scheduling_basic_args(torch.device("cuda")).values())
    pods = args[4].shape[0]
    for _ in range(5):  # warm-up
        want = fused_step.fused_step_batch(*args, WEIGHTS)
    times = [_timed(args) for _ in range(30)]
    print(json.dumps({"part": "shipped kernel", "pods": pods, "median_ms": statistics.median(times),
                      "min_ms": min(times), "max_ms": max(times)}))

    got, st, ms = run_stamped(args)
    if not torch.equal(got.node_idx, want.node_idx):
        raise AssertionError("the stamped kernel placed the pods differently")
    cycles = float(st[0, -1, 11] - st[0, 0, 0])
    ns_per_cycle = ms * 1e6 / cycles
    print(json.dumps({
        "part": "stamped kernel", "ms": ms, "cycles_per_pod": cycles / pods,
        "implied_sm_ghz": 1.0 / ns_per_cycle,
        "phase_ns_median_over_pods_per_block": {
            name: [float(np.median(st[b, :, to] - st[b, :, frm])) * ns_per_cycle
                   for b in range(fused_step.CLUSTER)]
            for frm, to, name in PHASES},
        "pod_to_pod_ns_median": float(np.median(np.diff(st[0, :, 0]))) * ns_per_cycle}))


if __name__ == "__main__":
    main()
