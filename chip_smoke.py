#!/usr/bin/env python3
"""Drive kubernetes_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

1. Build: compiles the fused-step kernel (kubernetes_tpu_torch/csrc/
   fused_step.cu) from the checkout with nvcc and prints its resource report.
2. Kernel phase: the CUDA kernel against its plain PyTorch version on the
   card at the main-path sizes (N=5120 node slots, R=6, W=16, P=128): five
   seeded batches (random; floor boundaries; ties, host ports, padded pods
   and nodes, a nominated pod; slices: exact ties at every boundary of the
   kernel's 8-block node split, winners in all 8 slices, a pod with no
   feasible node and a nominated node in the last slice; masked: a volume
   screen and a claim mask on about a third of the cells, first-fail ids 9
   and 10 under the static ids 1-4, and three pods with every node masked)
   plus a real SchedulingBasic batch. Every output and the evolved carry
   must be exactly equal, and the slices batch must pick the winners it was
   built for. Times the kernel (median of CUDA-event timings over 30
   launches) and the plain version on the SchedulingBasic batch, the kernel
   on the masked batch, and works out the least time the card could take
   for the same work.
3. Slice phase: SchedulingBasic/5000Nodes (5000 nodes of cpu 32 / 128Gi /
   110 pods with zone and hostname labels; pods asking 900m / 2Gi) through
   BatchScheduler on the card with the default ``KTPU_SPEC=auto``: 1000
   init-* pods, then 1000 measured-* pods. Every pod must be placed, every
   batch must take the fused kernel, which must have launched once per
   batch, and the placements must equal the same run on the CPU (plain
   versions).
4. Topology phase: the topology-size log table on the card must equal the
   CPU's for every size 0..8194. Then, with the scan forced
   (``KTPU_SPEC=0``), SchedulingPodAntiAffinity/5000Nodes (1000 init + 1000
   measured pods, each anti-affine to the others on the hostname key) and
   TopologySpreading/5000Nodes (5000 plain init pods, then 2000 pods with a
   maxSkew 1 DoNotSchedule zone constraint) through BatchScheduler on the
   card, then on the CPU. Every pod must be placed; the anti-affine pods on
   2000 distinct nodes; the spread pods' per-zone counts within 1 of each
   other; every topology batch in the expected mode ("host", "general");
   the fused kernel launched by no topology batch; no host read inside a
   scan batch's device call (it runs under
   ``torch.cuda.set_sync_debug_mode("error")``); and the placements equal
   to the CPU run.
5. Spec phase: the three workloads again on the card with every batch
   forced to the speculative rounds (``KTPU_SPEC=1``). The placements and
   modes must equal the CPU run and the card's run of the fused kernel or
   the scan; in every batch (but the profiled one) the host reads, counted
   as the synchronising-operation warnings of
   ``set_sync_debug_mode("warn")``, must equal the rounds
   (``batch.ROUNDS``); and one measured batch's spec BatchResult on the
   card must equal, field by field and bit for bit, the rounds on the CPU
   from the same inputs. Prints rounds per batch, kernels per round, device
   busy ms, ms per batch and pods/s beside the path the rounds replace.
   Then times the two paths in turns (other, spec, spec, other) on that
   batch's inputs and prints which is faster per mode beside
   ``batch.SPEC_AUTO_CUDA`` (the path ``auto`` takes on the card); fails if
   the table takes a path this run measured more than 1.5 times slower.
6. DRA phase: SchedulingDRA/5000Nodes (nodes publishing tpu.dev/cores and
   tpu.dev/gen; 1000 init + 1000 measured pods with one claim each, class
   gen == v5, claim cores >= 8) and SchedulingInTreePVs/5000Nodes (5000
   init + 1000 measured pods, each with its own pre-bound EBS PV and PVC)
   through BatchScheduler with their object stores, on the card under
   ``KTPU_SPEC=auto`` (every batch on the fused kernel, one launch per
   batch), on the CPU, and on the card with the rounds forced. Every pod
   must be placed with nothing in ``retry`` or ``fallback``; placements and
   claim allocations equal across the three runs; every DRA pod on a gen v5
   node with its claim allocated there; one measured batch's claim mask
   (and volume screen) from the card equal to the CPU's bit for bit. Prints
   the claim mask's device ms (CUDA events) and the host ms per batch of the
   volume screen, the claim mask's build and the commit checks.
7. Preempt phase: PreemptionBasic/500Nodes (500 nodes of cpu 4 / 16Gi /
   32 pods; 2000 victims of 900m / 2Gi at priority 1; 8 warm and 500
   measured preemptors of 2 / 4Gi at priority 100) and PreemptionPVs/
   500Nodes (the same, each preemptor with its own pre-bound EBS PV and
   PVC) through BatchScheduler: the init, warm and measured pods, then the
   nominated pods resubmitted until none is left (at most 16 rounds;
   ``perf/workloads.py:run_with_preemption``), on the card under
   ``KTPU_SPEC=auto`` (every batch on the fused kernel), on the CPU, and
   on the card with the rounds forced. All 508 preemptors must be bound,
   nothing left nominated, in ``retry`` or in ``fallback``; every node's
   requests within its allocatable; placements, the nominations before
   each round and the victims (victim -> preemptor) equal across the three
   runs. On the failing batch with the most failed pods, the screen
   (``ops/preempt.py``) on the card must equal the CPU's exactly and read
   nothing to the host (``set_sync_debug_mode("error")``). Prints ms per batch by stage, ms per failing
   batch of the screen (CUDA events) and of the host Evaluator, the
   screen's CUDA kernels and device busy time (torch.profiler), rounds and
   victims.
8. Gang phase: SchedulingGangs/5000Nodes (5000 nodes in 10 zones; gangs
   of 8 and 32, each member anti-affine to its own PodGroup on the
   hostname key: 160 init + 320 measured pods) and SchedulingSlices/
   512Nodes (512 hosts of cpu 4 / 16Gi labelled superpod i // 64, slot
   i % 64; slice gangs of 2, 8 and 64 hosts: 4 init + 88 measured pods)
   through BatchScheduler with their object stores (PodGroups), on the card
   under ``KTPU_SPEC=auto`` (Gangs: the rounds; Slices: the fused kernel
   with the slice mask), on the CPU, and on the card with the other path
   forced (Gangs: the scan; Slices: the rounds). Every gang must be bound
   whole, with ``gang_rejected``, ``retry`` and ``fallback`` empty; each
   SchedulingGangs gang on distinct hosts; each slice gang on consecutive
   slots of one superpod, one member per host (0 contiguity violations);
   placements equal across the three runs; every SchedulingSlices batch on
   the fused kernel. On one measured batch of each, the slice plan (mask
   and words) and ``gang_verdicts`` (from the card's batch result) on the
   card equal the CPU's bit for bit, and run under
   ``set_sync_debug_mode("error")``. A reject case follows on a 128-host
   torus, on the card and on the CPU: a gang of 8 anti-affine members
   confined to 6 hosts and a slice gang of 65 hosts (wider than a
   superpod) are rejected whole, and after the next sync the device's
   requested equals a fresh encode of the cluster. Prints ms per batch by
   stage, the plan's and the verdicts' CUDA-event ms and CUDA kernels, and
   the fused kernel's ms on the slice-masked batch against the same batch
   without the mask.
9. Quota phase: SchedulingSoak/1000Nodes, SchedulingSoak/1000Nodes/
   Cohort and SchedulingSoak/1000Nodes/NoGangs (1000 nodes of cpu 4 / 16Gi
   / 32 pods in 10 zones publishing SchedulingDRA's device attributes;
   tenants soak-a / soak-b / soak-c with SchedulingQuotas of weights 4 / 2
   / 1 at scale 24, in one cohort in the second; 8 rounds of plain pods,
   soak-a's gangs of 8 (not in the third), soak-b's claim pods and
   soak-c's priority-100 preemptors, a quarter of each tenant's bound pods
   deleted after each round) through ``perf/workloads.py:run_soak`` on the
   card under ``KTPU_SPEC=auto``, on the CPU, and on the card with the
   rounds forced. Zero oversubscription at every pass; placements, the
   pods left pending, per-round ledgers and nominations, the quota, gang
   and screen rejections equal across the three runs; the fused kernel
   launched once per mode-off batch (the gangs' anti-affinity puts the
   first two in mode host throughout; every /NoGangs batch is mode off);
   in the rounds, host reads equal to rounds; at least one winner flagged
   by the device screen in a batch whose tenant the gate had let through
   whole (for /NoGangs, in a batch of the fused kernel); the screen on the
   batch with the most screened rows on the card equal to the CPU's and
   free of host reads (``set_sync_debug_mode("error")``). Prints ms per batch by
   stage, the gate's and the screen's counts per tenant, and the screen's
   CUDA-event ms, CUDA kernels and device busy time.
10. PreemptionAll phase: PreemptionBasic's 500 nodes and 2000 priority-1
   victims, with zone and hostname labels and SchedulingDRA's device
   attributes, then 128 priority-100 preemptors of 2 / 4Gi with a claim
   (mode off, the fused kernel), 128 anti-affine on the hostname key (mode
   host) and 128 with a zone spread constraint (mode general), each kind
   in its own batch, through ``run_with_preemption`` (at most 16 rounds)
   on the card (auto), on the CPU and on the card with the rounds forced:
   every preemptor bound, nothing nominated, in ``retry`` or in
   ``fallback``, every node within its allocatable, placements,
   nominations and victims equal across the three runs; per mode, the
   screen on its failing batch with the most failed pods equal on card and
   CPU and free of host reads. Prints the first failing batch of each mode
   (ms, screen, host Evaluator) and the screen's ms, kernels and busy time
   per mode.
11. Loop phase: the scheduler loop (``perf/workloads.py:run_loop``: nodes
   and pods created in the port's Store, ``TPUScheduler(store,
   device).run_until_settled()``, every bind through the store).
   SchedulingBasic/5000Nodes (1000 init, then 1000 measured pods) on the
   card at the default percentageOfNodesToScore (a full batch on CUDA),
   nine times in turns: the in-flight ring at its default (depth 2, its
   commits inline), the synchronous loop (``KTPU_PIPELINE_DEPTH=0``) and
   the ring with the commit worker (``KTPU_COMMIT_WORKER=1``).
   Each run: every pod bound, every batch on the fused kernel with
   launches (counted from 0 just before the run) equal to batches,
   placements and pods popped equal to the loop on the CPU at percentage
   100 (the inline ring, the plain fused step); each ring run with batches
   encoded on the carry. Then one inline-ring dispatch on the carry (the
   third) under ``set_sync_debug_mode("error")``; the ring once at the
   default deadline (``KTPU_BATCH_DEADLINE_MS``, 500 ms: popped batch sizes
   and program buckets); SchedulingPodAntiAffinity/5000Nodes and
   TopologySpreading/5000Nodes through the ring (placements, pods popped,
   modes and grown capacities equal to the CPU loop); the sampled loop
   (1000 nodes, 256 pods at percentage 10: every batch on the scan, no
   kernel launch, placements and the window's final start equal to the
   CPU run); PreemptionBasic/500Nodes through the inline ring (victims,
   nominations, placements, pods popped and counters equal to the CPU)
   and through the worker ring (every preemptor bound; nominations, victims
   and pods popped printed beside the CPU's). Prints per run pods/s of the
   measured phase, attempt p50/p90/p99 (pop to commit), the batches
   encoded on the carry, host ms per batch on the scheduling thread by
   stage (pop, snapshot, sync, encode, dispatch, commit), the commits' ms
   (wait, bind, reconcile), and with the worker the overlap: the ms its
   host commits ran beside the scheduling thread's encode and dispatch.
12. Each workload run prints pods/s, ms per batch, host ms per stage, and
   the CUDA kernels and device busy time of one measured batch
   (torch.profiler). Then the card's name and power limit, one JSON line of
   per-kernel numbers, and, as the last line, the device summary.

Exits non-zero, with no result line, when any phase fails or when no CUDA
device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from kubernetes_tpu_torch.backend import batch, batch_scheduler, claim_mask
from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
from kubernetes_tpu_torch.backend.device_state import DeviceState
from kubernetes_tpu_torch.ops import fused_step, preempt, topology
from kubernetes_tpu_torch.perf import workloads
from kubernetes_tpu_torch.perf.kernel_phases import scheduling_basic_args

N_NODES = 5000
N_PODS = 1000
P, R, W = 128, 6, 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TIMED_LAUNCHES = 30


# ---------------------------------------------------------------- kernel phase

def _seeded_batch(kind: str, seed: int, n: int = 5120, n_real: int = 5000) -> dict:
    rng = np.random.RandomState(seed)
    real = np.arange(n) < n_real
    if kind == "boundary":
        caps = np.array([3, 7, 1000, 4, 5, 8, 10, 100, 25, 50], np.int32)
        alloc = caps[rng.randint(len(caps), size=(n, R))]
        nz = (alloc * rng.randint(0, 5, size=(n, R))) // 4
        p_req = rng.choice([0, 1, 2, 5], size=(P, R))
    else:
        alloc = rng.choice([32000, 134217728 // 1024 * 1024, 110, 16000, 65536], size=(n, R))
        alloc[:, 0] = rng.choice([3000, 7000, 32000], size=n)
        nz = (alloc * rng.uniform(0, 0.9, size=(n, R))).astype(np.int64)
        p_req = rng.choice([0, 1, 100, 900, 2048], size=(P, R))
    alloc = np.where(real[:, None], alloc, 0).astype(np.int32)
    nz = np.where(real[:, None], nz, 0).astype(np.int32)
    valid = np.ones(P, bool)
    nominated = np.full(P, -1, np.int32)
    ports = np.zeros((n, W), np.int64)
    p_bits = np.zeros((P, W), np.int64)
    jitter = rng.randint(0, 1 << 24, size=(P, n)) * (0.5 / (1 << 24))
    if kind == "ties":
        valid[-8:] = False                     # padded pods
        nominated[3] = 4242                    # a nominated pod
        ports[rng.uniform(size=(n, W)) < 0.02] = 1 << rng.randint(0, 32, size=1)[0]
        for i in range(0, P, 2):
            p_bits[i, i % W] = 1 << (i % 32)   # host ports wanted
        jitter[:, : n // 2] = 0.0              # exact ties: the first index wins
        alloc[: n // 2] = alloc[0]
        nz[: n // 2] = nz[0]
    static_ok = (rng.uniform(size=(P, n)) < 0.95) & real[None, :] & valid[:, None]
    ff = np.where(static_ok, 0, rng.randint(1, 5, size=(P, n)))
    if kind == "masked":
        # the volume screen (id 9) and the claim mask (id 10) under the
        # static ids, as static_phase assigns them; pods 0, 7 and 77 have
        # every node masked by claims
        extra = rng.uniform(size=(P, n)) > 1 / 6
        dra = rng.uniform(size=(P, n)) > 1 / 6
        dra[[0, 7, 77]] = False
        ff = np.where(ff > 0, ff, np.where(~extra, 9, np.where(~dra, 10, 0)))
        static_ok &= extra & dra
        ff = np.where(static_ok, 0, np.where(ff > 0, ff, 1))
    as_i32 = lambda a: (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)  # noqa: E731
    return {
        "alloc": alloc, "requested": (nz * 0.8).astype(np.int32), "nonzero": nz,
        "ports": as_i32(ports), "p_req": p_req.astype(np.int32),
        "p_nz": np.maximum(p_req, 1).astype(np.int32), "p_bits": as_i32(p_bits),
        "static_ok": static_ok, "static_ff": ff.astype(np.int8),
        "taint": rng.randint(0, 3, size=(P, n)).astype(np.float32),
        "aff": rng.choice([0, 2, 5], size=(P, n)).astype(np.float32),
        "img": rng.choice([0, 0, 17], size=(P, n)).astype(np.float32),
        "jitter": jitter.astype(np.float32), "nominated": nominated, "p_valid": valid,
    }


def _slices_batch(seed: int, n: int = 5120, n_real: int = 5000):
    """A batch aimed at the kernel's split of the node axis into CLUSTER
    slices of m = ceil(n / CLUSTER) slots. Every real node has the same
    state in the two scored columns, and each commit adds 1 to both, so
    LeastAllocated stays 99 and BalancedAllocation 100 on every node: totals
    differ only by the taint, affinity and image rows. Each pod gives its
    tie nodes the best raw scores and a jitter of 0.5 and every other node a
    jitter below 0.25, so the first tie node wins:
      * pods p % 3 == 0: a tie across the boundary (k*m - 1, k*m);
      * pods p % 3 == 1: a tie between k*m and a node of the last slice;
      * pods p % 3 == 2: one tie node in each slice from s = p % 8 on;
    with k = 1 + p % 7. Pod 5 has no feasible node, pod 9 is nominated to a
    node of the last slice, and the last two pods are padding. Returns the
    kernel's inputs and the winner each pod must get."""
    rng = np.random.RandomState(seed)
    m = -(-n // fused_step.CLUSTER)
    real = np.arange(n) < n_real
    alloc = np.where(real[:, None], np.full((n, R), 32000), 0).astype(np.int32)
    nz = np.where(real[:, None], np.full((n, R), 160), 0).astype(np.int32)
    p_req = rng.choice([0, 1, 2], size=(P, R)).astype(np.int32)
    p_nz = np.maximum(p_req, 1)
    p_nz[:, :2] = 1
    valid = np.ones(P, bool)
    valid[-2:] = False
    static_ok = (rng.uniform(size=(P, n)) < 0.97) & real[None, :] & valid[:, None]
    taint = rng.randint(0, 3, size=(P, n)).astype(np.float32)
    aff = rng.choice([0, 2, 5], size=(P, n)).astype(np.float32)
    img = rng.choice([0, 17], size=(P, n)).astype(np.float32)
    jitter = rng.randint(0, 1 << 24, size=(P, n)) * (0.25 / (1 << 24))
    nominated = np.full(P, -1, np.int32)
    want = np.full(P, -1, np.int32)
    last = (fused_step.CLUSTER - 1) * m
    for p in range(P - 2):
        k, s = 1 + p % 7, p % 8
        ties = ([k * m - 1, k * m] if p % 3 == 0 else
                [k * m, last + 5] if p % 3 == 1 else
                [r * m + k for r in range(s, fused_step.CLUSTER)])
        static_ok[p, ties] = True
        taint[p, ties], aff[p, ties], img[p, ties], jitter[p, ties] = 0.0, 5.0, 17.0, 0.5
        want[p] = min(ties)
    static_ok[5] = False
    want[5] = -1
    nominated[9] = want[9] = n_real - 10
    static_ok[9, n_real - 10] = True
    ff = np.where(static_ok, 0, rng.randint(1, 5, size=(P, n)))
    return {
        "alloc": alloc, "requested": nz.copy(), "nonzero": nz,
        "ports": np.zeros((n, W), np.int32), "p_req": p_req, "p_nz": p_nz.astype(np.int32),
        "p_bits": np.zeros((P, W), np.int32), "static_ok": static_ok,
        "static_ff": ff.astype(np.int8), "taint": taint, "aff": aff, "img": img,
        "jitter": jitter.astype(np.float32), "nominated": nominated, "p_valid": valid,
    }, want


def _to_device(d: dict, device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in d.items()}


def _compare(got, want, label: str) -> float:
    """Raise unless every output is equal (floats by bit pattern); returns
    the largest absolute difference of the float outputs (0.0)."""
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        if a.dtype == torch.float32:
            err = max(err, float((a - b).abs().max()))
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"kernel != plain version on {label}: {name} ({bad} entries)")
    return err


def _bound(args: dict, out) -> tuple:
    """(bound_ms, bound_by, bytes): each input read once and each output written
    once over the memory rate, against the float32 work over its peak."""
    nbytes = sum(t.numel() * t.element_size() for t in args.values())
    nbytes += sum(t.numel() * t.element_size() for t in out)
    pods, n = args["static_ok"].shape
    flops = pods * n * 40  # scores, normalization, total and argmax per (pod, node)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def kernel_phase(device) -> dict:
    weights = (1.0, 1.0, 3.0, 2.0, 1.0)
    cases = [(k, _to_device(_seeded_batch(k, s), device))
             for k, s in (("random", 1), ("boundary", 2), ("ties", 3), ("masked", 5))]
    slices, slices_want = _slices_batch(4)
    cases.append(("slices", _to_device(slices, device)))
    basic = scheduling_basic_args(device)
    cases.append(("scheduling-basic", basic))
    print(f"launch: {fused_step.CLUSTER} blocks x {fused_step._THREADS} threads, 1 cluster")
    err, winners = 0.0, {}
    for label, args in cases:
        got = fused_step.fused_step_batch(*args.values(), weights)
        torch.cuda.synchronize()
        winners[label] = got.node_idx.cpu().numpy()
        want = fused_step.fused_step_batch_ref(*args.values(), weights)
        err = max(err, _compare(got, want, label))
        placed = int((got.node_idx >= 0).sum())
        print(f"kernel == plain on {label}: {placed}/{P} placed, "
              f"first_fail ids {sorted(torch.unique(got.first_fail).tolist())}")
    if not (winners["masked"][[0, 7, 77]] == -1).all():
        raise AssertionError("masked batch: a pod with every node masked was placed")
    if not np.array_equal(winners["slices"], slices_want):
        raise AssertionError("slices batch: winners differ from the ones it was built for")
    m = -(-slices["alloc"].shape[0] // fused_step.CLUSTER)
    won = sorted({int(i) // m for i in winners["slices"] if i >= 0})
    if won != list(range(fused_step.CLUSTER)):
        raise AssertionError(f"slices batch: winners only in slices {won}")
    print(f"slices batch: winners in slices {won}, ties at every boundary k*{m}-1 / k*{m} "
          f"went to the smaller index")

    args = list(basic.values())
    times, out = _event_ms(lambda: fused_step.fused_step_batch(*args, weights))
    masked = dict(cases)["masked"]
    masked_times, _ = _event_ms(lambda: fused_step.fused_step_batch(*masked.values(), weights))
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_step.fused_step_batch_ref(*args, weights)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    bound_ms, bound_by, nbytes = _bound(basic, out)
    ms = statistics.median(times)
    print(f"fused_step_batch on a SchedulingBasic batch (N={args[0].shape[0]}, P={P}): "
          f"kernel median {ms:.4f} ms over {TIMED_LAUNCHES} launches "
          f"(min {min(times):.4f}, max {max(times):.4f}); plain PyTorch "
          f"{statistics.median(plain):.2f} ms; bound {bound_ms:.5f} ms "
          f"({nbytes} bytes, {bound_by})")
    masked_ms = statistics.median(masked_times)
    print(f"fused_step_batch on the masked batch: kernel median {masked_ms:.4f} ms over "
          f"{TIMED_LAUNCHES} launches (min {min(masked_times):.4f}, max {max(masked_times):.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": statistics.median(plain),
            "bound_ms": bound_ms, "bound_by": bound_by, "masked_ms": masked_ms}


def _event_ms(fn, warmup: int = 3) -> tuple:
    """CUDA-event ms of each of TIMED_LAUNCHES calls of ``fn`` after a
    warm-up, and the last call's result."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


# ---------------------------------------------------------------- the runner


@contextlib.contextmanager
def _spec_flag(value: str):
    """``KTPU_SPEC`` for the runs inside: "0" the fused kernel and the scan,
    "1" the speculative rounds in every mode, "auto" the port's default."""
    old = os.environ.get("KTPU_SPEC")
    os.environ["KTPU_SPEC"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KTPU_SPEC", None)
        else:
            os.environ["KTPU_SPEC"] = old


def _host_copy(obj, device="cpu"):
    """A copy on ``device`` of a schema dataclass, a BatchResult, or a list or
    dict of them (a copy on the host too: a later sync writes rows into the
    mirror)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_host_copy(v, device) for v in obj]
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _host_copy(getattr(obj, f.name), device)
                            for f in dataclasses.fields(obj)})
    return obj


class _Watch:
    """Stands in for ``batch_scheduler.schedule_batch`` during a run. On the
    card, a scan batch runs under ``set_sync_debug_mode("error")`` (any host
    read inside it raises) and a spec batch under "warn", its host reads
    counted against its rounds (``batch.ROUNDS``); the fused kernel's
    launches are counted per mode; batch ``profile_at`` runs under
    torch.profiler instead (the profiler itself synchronises); and the
    inputs and the result of batch ``capture_at`` are copied to the host."""

    def __init__(self, profile_at: int = -1, capture_at: int = -1):
        self.inner = batch_scheduler.schedule_batch
        self.calls = 0
        self.fused_launches = {"off": 0, "host": 0, "general": 0}
        self.spec = []  # (call, rounds, host reads) of each counted spec batch
        self.profile_at, self.capture_at = profile_at, capture_at
        self.profile = self.captured = None
        self.last_mode = None

    def __call__(self, *args, **kw):
        mode, spec = kw.get("topo_mode", "off"), kw.get("spec_decode", False)
        self.last_mode = mode
        on_card = torch.device(kw["device"]).type == "cuda"
        before, rounds0 = fused_step.LAUNCHES, batch.ROUNDS
        if self.calls == self.capture_at:
            self.captured = {"args": _host_copy(args), "kw": _host_copy(kw)}
        if on_card and self.calls == self.profile_at:
            self.profile = _profiled(self.inner, args, kw)
            self.profile["rounds"] = batch.ROUNDS - rounds0
            res = self.profile.pop("result")
        elif on_card and spec:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = self.inner(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            reads = sum("synchronizing" in str(w.message) for w in caught)
            self.spec.append((self.calls, batch.ROUNDS - rounds0, reads))
        elif on_card and mode != "off":
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = self.inner(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            res = self.inner(*args, **kw)
        if self.calls == self.capture_at:
            self.captured["result"] = _host_copy(res)  # before a later sync writes into it
        self.fused_launches[mode] += fused_step.LAUNCHES - before
        self.calls += 1
        return res


def _profiled(fn, args, kw) -> dict:
    """One batch under torch.profiler: its CUDA kernels, their device time
    and the wall time (synchronised before and after)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = fn(*args, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = busy_us = launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
            busy_us += getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    return {"result": res, "kernels": kernels, "launch_calls": launches,
            "device_ms": busy_us / 1e3, "wall_ms": wall_ms}


def _run(w, device, profile_at: int = -1, capture_at: int = -1) -> dict:
    """One workload through BatchScheduler: init pods, then the measured
    pods in batches of P, each timed on the host clock. The profiled batch
    is left out of the timings."""
    watch = _Watch(profile_at, capture_at)
    batch_scheduler.schedule_batch = watch
    try:
        store = w.store()  # claims, volumes and PodGroups, where the workload has them
        sched = BatchScheduler(w.node_infos(), caps=w.caps(), device=device, client=store)
        placed = sched.schedule(w.init_pod_list())
        init_batches = sched.batches
        measured = w.measured_pod_list()
        per_batch = []
        stage_ms = dict.fromkeys(sched.stage_seconds, 0.0)
        screen_ms = dict.fromkeys(sched.screen_seconds, 0.0)
        for i in range(0, len(measured), P):
            profiled = watch.calls == profile_at
            stages0, screens0 = dict(sched.stage_seconds), dict(sched.screen_seconds)
            t0 = time.perf_counter()
            placed.update(sched.schedule(measured[i:i + P]))  # ends in the host read
            if not profiled:
                per_batch.append(((time.perf_counter() - t0) * 1e3, len(measured[i:i + P])))
                for k, v in sched.stage_seconds.items():
                    stage_ms[k] += (v - stages0[k]) * 1e3
                for k, v in sched.screen_seconds.items():
                    screen_ms[k] += (v - screens0[k]) * 1e3
    finally:
        batch_scheduler.schedule_batch = watch.inner
    ms = [t for t, _ in per_batch]
    return {"placed": placed, "sched": sched, "per_batch": per_batch, "watch": watch,
            "modes": sched.batch_modes, "paths": sched.batch_paths, "store": store,
            "init_batches": init_batches, "median_ms": statistics.median(ms),
            "pods_per_s": sum(n for _, n in per_batch) / (sum(ms) / 1e3),
            "stage_ms": {k: v / len(per_batch) for k, v in stage_ms.items()},
            "screen_ms": {k: v / len(per_batch) for k, v in screen_ms.items()}}


def _check_placed(name: str, w, gpu: dict) -> None:
    placed = gpu["placed"]
    unplaced = [k for k, v in placed.items() if v is None]
    if len(placed) != w.n_init + w.n_measured or unplaced:
        raise AssertionError(f"{name}: {len(unplaced)} pods unplaced of {len(placed)}")


def _check_same(name: str, got: dict, want: dict, what: str) -> None:
    if got["placed"] != want["placed"]:
        diff = sum(want["placed"][key] != v for key, v in got["placed"].items())
        raise AssertionError(f"{name}: {diff} placements differ from {what}")
    if got["modes"] != want["modes"]:
        raise AssertionError(f"{name}: modes {got['modes']} != {what}'s {want['modes']}")


def _report(name: str, gpu: dict) -> None:
    ms = [t for t, _ in gpu["per_batch"]]
    paths = sorted(set(gpu["paths"]))
    print(f"{name} on cuda: {len(gpu['placed'])} pods placed in {len(gpu['modes'])} batches "
          f"(modes: init {gpu['modes'][0]}, measured {gpu['modes'][-1]}; paths {paths}), "
          f"fused-kernel launches by mode {gpu['watch'].fused_launches}; measured phase "
          f"{gpu['pods_per_s']:.1f} pods/s, median {gpu['median_ms']:.2f} ms per batch (min "
          f"{min(ms):.2f}, max {max(ms):.2f}; {len(ms)} batches of up to {P}, the profiled one "
          f"left out); host ms per measured batch by stage: "
          + ", ".join(f"{k} {v:.2f}" for k, v in gpu["stage_ms"].items()))
    prof = gpu["watch"].profile
    if prof is not None:
        print(f"{name} one measured batch under torch.profiler: {prof['kernels']} CUDA kernels "
              f"({prof['kernels'] / P:.1f} per pod), {prof['launch_calls']} kernel-launch "
              f"calls, device busy {prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} ms wall")


# ---------------------------------------------------------------- slice phase


def slice_phase() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    fused_step.LAUNCHES = 0
    gpu = _run(basic, "cuda", profile_at=basic.init_pods // P + 2)
    launches = fused_step.LAUNCHES
    _check_placed(basic.name, basic, gpu)
    if set(gpu["paths"]) != {"fused"}:
        raise AssertionError(f"{basic.name}: paths {gpu['paths']} under KTPU_SPEC=auto")
    if launches != gpu["sched"].batches:
        raise AssertionError(f"{launches} kernel launches for {gpu['sched'].batches} batches")
    cpu = _run(basic, "cpu")
    _check_same(basic.name, gpu, cpu, "the cpu run")
    print(f"{basic.name}: kernel launches {launches} (one per batch), placements == cpu run")
    _report(basic.name, gpu)
    return {"launches": launches, "workload": basic, "gpu": gpu, "cpu": cpu}


# ---------------------------------------------------------------- topology phase


def _check_topo(name: str, w, gpu: dict, cpu: dict, init_mode: str, meas_mode: str) -> None:
    _check_placed(name, w, gpu)
    modes, k = gpu["modes"], gpu["init_batches"]
    if set(modes[:k]) != {init_mode} or set(modes[k:]) != {meas_mode}:
        raise AssertionError(f"{name}: batch modes {modes}")
    watch = gpu["watch"]
    if watch.fused_launches["host"] or watch.fused_launches["general"]:
        raise AssertionError(f"{name}: the fused kernel launched in topology batches: "
                             f"{watch.fused_launches}")
    if watch.profile is None:
        raise AssertionError(f"{name}: no topology batch was profiled")
    _check_same(name, gpu, cpu, "the cpu run")


def topology_phase() -> dict:
    sizes = 8195
    on_card = topology.size_log_table(sizes, "cuda").cpu()
    on_host = topology.size_log_table(sizes, "cpu")
    if not torch.equal(on_card.view(torch.int32), on_host.view(torch.int32)):
        raise AssertionError("size_log_table differs between cuda and cpu")
    x = torch.arange(sizes, dtype=torch.float32) + 2.0
    plain_card = torch.log(x.cuda()).cpu()
    print(f"size_log_table over sizes 0..{sizes - 1}: cuda == cpu bit for bit; torch.log: "
          f"cuda differs from cpu at {int((plain_card != torch.log(x)).sum())} sizes and from "
          f"the table at {int((plain_card != on_card).sum())}")

    out = {}
    with _spec_flag("0"):  # the scan; the spec phase runs the rounds
        anti = workloads.scheduling_pod_anti_affinity()
        gpu = _run(anti, "cuda", profile_at=10)
        cpu = _run(anti, "cpu")
        _check_topo(anti.name, anti, gpu, cpu, "host", "host")
        nodes = [v for v in gpu["placed"].values()]
        if len(set(nodes)) != len(nodes):
            raise AssertionError(f"{anti.name}: {len(nodes) - len(set(nodes))} pods share a node")
        print(f"{anti.name}: placements == cpu run, no host sync in the scan batches' "
              f"device calls")
        _report(anti.name, gpu)
        out[anti.name] = {"workload": anti, "gpu": gpu, "cpu": cpu}

        spread = workloads.topology_spreading()
        gpu = _run(spread, "cuda", profile_at=spread.init_pods // P + 2)
        cpu = _run(spread, "cpu")
        _check_topo(spread.name, spread, gpu, cpu, "off", "general")
        zone_of = {ni.node.meta.name: ni.node.meta.labels["topology.kubernetes.io/zone"]
                   for ni in gpu["sched"].snapshot.node_info_map.values()}
        per_zone = {}
        for key, node in gpu["placed"].items():
            if key.startswith("default/spread-"):
                per_zone[zone_of[node]] = per_zone.get(zone_of[node], 0) + 1
        if len(per_zone) != 10 or max(per_zone.values()) - min(per_zone.values()) > 1:
            raise AssertionError(f"{spread.name}: spread pods per zone {per_zone}")
        print(f"{spread.name}: measured pods per zone {sorted(per_zone.values())}; "
              f"placements == cpu run, no host sync in the scan batches' device calls")
        _report(spread.name, gpu)
        out[spread.name] = {"workload": spread, "gpu": gpu, "cpu": cpu}
    return out


# ---------------------------------------------------------------- spec phase


def _compare_results(name: str, got, want) -> None:
    """Every field of two BatchResults equal, floats by bit pattern."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        pairs = ([(f"{f.name}.{k}", a[k], b[k]) for k in sorted(a)] if isinstance(a, dict)
                 else [(f.name, a, b)])
        for label, x, y in pairs:
            if (x is None) != (y is None):
                raise AssertionError(f"{name}: {label} is None on one device only")
            if x is None:
                continue
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"{name}: spec {label} differs between cuda and cpu")


def _ab(cap: dict, reps: int) -> dict:
    """The rounds and the path they replace on one captured batch's inputs,
    on the card, in turns (other, spec, spec, other) ``reps`` times: median
    ms from the call to the end of the packed block's host read."""
    args = _host_copy(cap["args"], "cuda")
    kw = {**_host_copy(cap["kw"], "cuda"), "device": "cuda"}
    times = {True: [], False: []}
    for _ in range(reps):
        for spec in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batch.schedule_batch(*args, **{**kw, "spec_decode": spec})
            res.packed.cpu()
            times[spec].append((time.perf_counter() - t0) * 1e3)
    return {"spec": statistics.median(times[True]), "other": statistics.median(times[False])}


def spec_phase(basic: dict, topo: dict) -> dict:
    """Every batch of the three workloads forced to the speculative rounds
    on the card, against the earlier phases' runs of the fused kernel and
    the scan (cuda) and of the plain versions (cpu)."""
    rows = {}
    with _spec_flag("1"):
        for prev in (basic, *topo.values()):
            w = prev["workload"]
            profile_at = w.init_pods // P + 2
            gpu = _run(w, "cuda", profile_at=profile_at, capture_at=profile_at + 1)
            _check_placed(w.name, w, gpu)
            if set(gpu["paths"]) != {"spec"} or any(gpu["watch"].fused_launches.values()):
                raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, fused launches "
                                     f"{gpu['watch'].fused_launches} with the rounds forced")
            _check_same(w.name, gpu, prev["cpu"], "the cpu run")
            _check_same(w.name, gpu, prev["gpu"], "the cuda run of the kernel or the scan")
            counted = gpu["watch"].spec
            bad = [(c, r, n) for c, r, n in counted if n != r or r < 1]
            if bad or len(counted) != len(gpu["modes"]) - 1:
                raise AssertionError(f"{w.name}: host reads != rounds in (call, rounds, reads) "
                                     f"{bad[:5]} of {len(counted)} counted batches")
            cap = gpu["watch"].captured
            want = batch.schedule_batch(*cap["args"], **{**cap["kw"], "device": "cpu"})
            _compare_results(w.name, cap["result"], want)
            rounds = [r for c, r, _ in counted if c >= gpu["init_batches"]]
            prof = gpu["watch"].profile
            old = prev["gpu"]
            print(f"{w.name} spec rounds on cuda: placements == cpu run and == the cuda run of "
                  f"{sorted(set(old['paths']))}; host reads == rounds in all {len(counted)} "
                  f"counted batches; batch {profile_at + 1} ({gpu['modes'][profile_at + 1]}): "
                  f"spec BatchResult cuda == cpu on every field")
            _report(w.name, gpu)
            print(f"{w.name} measured batches: rounds per batch median "
                  f"{statistics.median(rounds)} (min {min(rounds)}, max {max(rounds)}, mean "
                  f"{statistics.mean(rounds):.2f}); host reads per batch = rounds; profiled batch: "
                  f"{prof['rounds']} rounds, {prof['kernels']} CUDA kernels, "
                  f"{prof['kernels'] / max(prof['rounds'], 1):.1f} per round, device busy "
                  f"{prof['device_ms']:.2f} ms. Replaced path {sorted(set(old['paths'][-1:]))}: "
                  f"{old['pods_per_s']:.1f} pods/s, median {old['median_ms']:.2f} ms per batch, "
                  f"{old['watch'].profile['kernels']} CUDA kernels and device busy "
                  f"{old['watch'].profile['device_ms']:.2f} ms in its profiled batch")
            ab = _ab(cap, 3 if gpu["modes"][-1] == "off" else 1)
            rows[w.name] = {"mode": gpu["modes"][-1], "other": old["paths"][-1], "ab": ab,
                            "e2e": {"spec": gpu["median_ms"], "other": old["median_ms"]},
                            "pods_per_s": {"spec": gpu["pods_per_s"],
                                           "other": old["pods_per_s"]}}
    print("KTPU_SPEC=auto on cuda against this run: the commit paths in turns on one measured "
          "batch (ms from the call to the packed block on the host), and the median ms per "
          "measured batch end to end:")
    for name, r in rows.items():
        ab, e2e, other = r["ab"], r["e2e"], r["other"]
        faster = ab["spec"] < ab["other"]
        table = batch.SPEC_AUTO_CUDA[r["mode"]]
        ratio = max(ab.values()) / min(ab.values())
        print(f"  mode {r['mode']} ({name}): in turns spec {ab['spec']:.2f} ms, {other} "
              f"{ab['other']:.2f} ms, faster: {'spec' if faster else other} by {ratio:.2f}x; "
              f"end to end spec {e2e['spec']:.2f} ms, {other} {e2e['other']:.2f} ms; "
              f"SPEC_AUTO_CUDA takes {'spec' if table else other}")
        if table != faster and ratio > 1.5:
            raise AssertionError(f"SPEC_AUTO_CUDA[{r['mode']!r}] takes the slower path")
    return rows


# ---------------------------------------------------------------- DRA phase


def _allocations(run: dict) -> dict:
    store = run["store"]
    return {k: (c.allocated_node, c.reserved_for) for k, c in store.resource_claims.items()}


def _check_masked(name: str, w, run: dict, what: str) -> None:
    _check_placed(name, w, run)
    sched = run["sched"]
    if sched.retry or sched.fallback:
        raise AssertionError(f"{name} ({what}): retry {dict(list(sched.retry.items())[:3])}, "
                             f"fallback {dict(list(sched.fallback.items())[:3])}")


class _MaskWatch:
    """Stands in for ``claim_mask.claim_feasibility_mask`` during a run:
    copies call ``capture_at``'s inputs and result to the host."""

    def __init__(self, capture_at: int):
        self.inner = claim_mask.claim_feasibility_mask
        self.calls, self.capture_at, self.captured = 0, capture_at, None

    def __call__(self, *args):
        out = self.inner(*args)
        if self.calls == self.capture_at:
            self.captured = (_host_copy(list(args)), _host_copy(out))
        self.calls += 1
        return out


def dra_phase() -> dict:
    """SchedulingDRA and SchedulingInTreePVs on the card (auto: the fused
    kernel), on the CPU and on the card with the rounds forced."""
    out = {}
    for w in (workloads.scheduling_dra(), workloads.scheduling_intree_pvs()):
        k = w.init_pods // P + 1  # the first measured batch but one is profiled
        mask_watch = _MaskWatch(capture_at=k if w.measured.claim else -1)
        claim_mask.claim_feasibility_mask = mask_watch
        try:
            fused_step.LAUNCHES = 0
            gpu = _run(w, "cuda", profile_at=k + 1, capture_at=k)
            launches = fused_step.LAUNCHES
        finally:
            claim_mask.claim_feasibility_mask = mask_watch.inner
        _check_masked(w.name, w, gpu, "cuda")
        if set(gpu["paths"]) != {"fused"} or launches != gpu["sched"].batches:
            raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, {launches} kernel "
                                 f"launches for {gpu['sched'].batches} batches")
        cpu = _run(w, "cpu", capture_at=k)
        _check_masked(w.name, w, cpu, "cpu")
        _check_same(w.name, gpu, cpu, "the cpu run")
        if _allocations(gpu) != _allocations(cpu):
            raise AssertionError(f"{w.name}: claim allocations differ from the cpu run")
        masks = [m for m in ("extra_mask", "dra_mask") if gpu["watch"].captured["kw"].get(m)
                 is not None]
        for m in masks:
            a, b = gpu["watch"].captured["kw"][m], cpu["watch"].captured["kw"][m]
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{w.name}: batch {k}'s {m} differs between cuda and cpu")
        with _spec_flag("1"):
            spec = _run(w, "cuda")
        _check_masked(w.name, w, spec, "spec")
        if set(spec["paths"]) != {"spec"}:
            raise AssertionError(f"{w.name}: paths {set(spec['paths'])} with the rounds forced")
        _check_same(w.name, spec, gpu, "the cuda run of the kernel")
        if _allocations(spec) != _allocations(gpu):
            raise AssertionError(f"{w.name}: claim allocations of the rounds differ")
        row = {"workload": w, "gpu": gpu, "launches": launches}
        line = (f"{w.name}: every pod placed, retry and fallback empty; {launches} kernel "
                f"launches for {gpu['sched'].batches} batches; placements == cpu run == the "
                f"rounds on cuda; batch {k}'s {' and '.join(masks)} cuda == cpu bit for bit")
        if w.measured.claim:
            gen = {ni.node.meta.name: ni.node.status.device_attributes.get("tpu.dev/gen")
                   for ni in gpu["sched"].snapshot.node_info_map.values()}
            allocs = _allocations(gpu)
            for key, node in gpu["placed"].items():
                claim = allocs[f"{key}-{w.measured.claim.name}"]
                if gen[node] != "v5" or claim != (node, (key,)):
                    raise AssertionError(f"{w.name}: {key} on {node} (gen {gen[node]}), "
                                         f"claim {claim}")
            args, want = mask_watch.captured
            args = _host_copy(args, "cuda")
            got = claim_mask.claim_feasibility_mask(*args).cpu()
            if not torch.equal(got, want) or not torch.equal(
                    claim_mask.claim_feasibility_mask(*_host_copy(args)), want):
                raise AssertionError(f"{w.name}: the claim mask differs from its capture")
            times, _ = _event_ms(lambda: claim_mask.claim_feasibility_mask(*args))
            prof = _profiled(claim_mask.claim_feasibility_mask, args, {})
            row["claim_mask_ms"] = statistics.median(times)
            line += (f"; every claim pod on a gen v5 node with its claim allocated there; "
                     f"claim_feasibility_mask [P={args[0].shape[0]}, S={args[0].shape[1]}, "
                     f"N={args[4].shape[0]}, A={args[4].shape[1]}] on the card: median "
                     f"{row['claim_mask_ms']:.4f} ms over {TIMED_LAUNCHES} (CUDA events; min "
                     f"{min(times):.4f}, max {max(times):.4f}), {prof['kernels']} CUDA kernels, "
                     f"device busy {prof['device_ms']:.4f} ms")
        print(line)
        _report(w.name, gpu)
        print(f"{w.name} host ms per measured batch inside the stages: " + ", ".join(
            f"{k2} {v:.3f}" for k2, v in gpu["screen_ms"].items()) + "; rounds forced: "
            f"{spec['pods_per_s']:.1f} pods/s, median {spec['median_ms']:.2f} ms per batch")
        out[w.name] = row
    return out


# ---------------------------------------------------------------- preempt phase


class _ScreenWatch:
    """Stands in for ``batch_scheduler.screen_prefix`` during a run: copies
    to the host the inputs and result of the call with the most failed
    pods (the first of them)."""

    def __init__(self):
        self.inner = batch_scheduler.screen_prefix
        self.calls = 0
        self.captured = None

    def __call__(self, pb, nt, static_masks, failed_prefix):
        out = self.inner(pb, nt, static_masks, failed_prefix)
        rows = int(np.sum(failed_prefix))
        if self.captured is None or rows > self.captured["rows"]:
            self.captured = {"rows": rows, "failed": np.array(failed_prefix, bool),
                             "args": _host_copy([pb, nt, static_masks]),
                             "result": _host_copy(list(out))}
        self.calls += 1
        return out


def _run_preempt(w, device) -> dict:
    """One preemption workload through BatchScheduler and
    ``run_with_preemption``, every batch timed on the host clock with its
    stage and screen seconds."""
    watch, screens = _Watch(), _ScreenWatch()
    batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = watch, screens
    try:
        sched = BatchScheduler(w.node_infos(), device=device, client=w.store())
        records = []
        inner = sched._schedule_batch

        def timed(pods):
            s0, c0 = dict(sched.stage_seconds), dict(sched.screen_seconds)
            t0 = time.perf_counter()
            out = inner(pods)
            records.append({
                "ms": (time.perf_counter() - t0) * 1e3, "pods": len(pods),
                "failed": sum(v is None for v in out.values()),
                "stages": {k: (v - s0[k]) * 1e3 for k, v in sched.stage_seconds.items()},
                "screens": {k: (v - c0[k]) * 1e3 for k, v in sched.screen_seconds.items()}})
            return out

        sched._schedule_batch = timed
        t0 = time.perf_counter()
        placed, rounds = workloads.run_with_preemption(sched, w)
        wall_s = time.perf_counter() - t0
    finally:
        batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = (watch.inner,
                                                                          screens.inner)
    return {"placed": placed, "rounds": rounds, "preempted": dict(sched.preempted),
            "sched": sched, "watch": watch, "screens": screens, "records": records,
            "wall_s": wall_s, "paths": sched.batch_paths}


def _check_preempt(name: str, w, run: dict, what: str) -> None:
    sched, placed = run["sched"], run["placed"]
    preemptors = [k for k in placed if k.startswith(("default/warm-", "default/preemptor-"))]
    unbound = [k for k in preemptors if placed[k] is None]
    if len(preemptors) != w.warm_pods + w.measured_pods or unbound or sched.nominated:
        raise AssertionError(f"{name} ({what}): {len(unbound)} of {len(preemptors)} preemptors "
                             f"unbound after {len(run['rounds'])} rounds, "
                             f"{len(sched.nominated)} still nominated")
    if sched.retry or sched.fallback:
        raise AssertionError(f"{name} ({what}): retry {sched.retry}, fallback {sched.fallback}")
    for ni in sched.snapshot.node_info_map.values():
        if (ni.requested.milli_cpu > ni.allocatable.milli_cpu
                or ni.requested.memory > ni.allocatable.memory
                or len(ni.pods) > ni.allocatable.allowed_pod_number):
            raise AssertionError(f"{name} ({what}): {ni.node.meta.name} over its allocatable")
    evicted = set(run["preempted"])
    if any(p.key() in evicted for ni in sched.snapshot.node_info_map.values() for p in ni.pods):
        raise AssertionError(f"{name} ({what}): a victim is still on its node")


def _check_preempt_same(name: str, got: dict, want: dict, what: str) -> None:
    for key in ("placed", "rounds", "preempted"):
        if got[key] != want[key]:
            raise AssertionError(f"{name}: {key} differ from {what}")


def _screen_on_card(name: str, cap: dict) -> dict:
    """The captured failing batch's screen: the card's result against the
    CPU's on the same inputs, one call under set_sync_debug_mode("error"),
    CUDA-event ms and the profile."""
    pb, nt, masks = cap["args"]
    rows = np.flatnonzero(cap["failed"]).tolist()
    want = preempt.screen_prefix(pb, nt, masks, cap["failed"])
    for label, a, b in (("screen", cap["result"][0], want.screen),
                        ("best", cap["result"][1], want.best)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: the screen's {label} differs between cuda and cpu")
    args = _host_copy([pb, nt, masks], "cuda") + [rows]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = preempt.preempt_screen(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (torch.equal(got.screen.cpu(), want.screen) and torch.equal(got.best.cpu(), want.best)):
        raise AssertionError(f"{name}: the screen on the card differs from its capture")
    times, _ = _event_ms(lambda: preempt.preempt_screen(*args))
    prof = _profiled(preempt.preempt_screen, args, {})
    n, c, _r = nt.class_req.shape
    return {"ms": statistics.median(times), "min": min(times), "max": max(times),
            "kernels": prof["kernels"], "device_ms": prof["device_ms"],
            "wall_ms": prof["wall_ms"], "launch_calls": prof["launch_calls"],
            "shape": f"[P={pb.capacity}, N={n}, C={c}], {len(rows)} failed rows"}


def preempt_phase() -> dict:
    """PreemptionBasic and PreemptionPVs on the card (auto: the fused
    kernel), on the CPU and on the card with the rounds forced."""
    out = {}
    for w in (workloads.preemption_basic(), workloads.preemption_pvs()):
        fused_step.LAUNCHES = 0
        gpu = _run_preempt(w, "cuda")
        launches = fused_step.LAUNCHES
        _check_preempt(w.name, w, gpu, "cuda")
        if set(gpu["paths"]) != {"fused"} or launches != gpu["sched"].batches:
            raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, {launches} kernel "
                                 f"launches for {gpu['sched'].batches} batches")
        cpu = _run_preempt(w, "cpu")
        _check_preempt(w.name, w, cpu, "cpu")
        _check_preempt_same(w.name, gpu, cpu, "the cpu run")
        with _spec_flag("1"):
            spec = _run_preempt(w, "cuda")
        _check_preempt(w.name, w, spec, "spec")
        if set(spec["paths"]) != {"spec"}:
            raise AssertionError(f"{w.name}: paths {set(spec['paths'])} with the rounds forced")
        _check_preempt_same(w.name, spec, gpu, "the cuda run of the kernel")
        screen = _screen_on_card(w.name, gpu["screens"].captured)
        init_batches = -(-w.init_pods // P)
        recs = gpu["records"][init_batches:]  # warm, measured and resubmitted batches
        failing = [r for r in recs if r["failed"]]
        stages = {k: statistics.median(r["stages"][k] for r in recs) for k in recs[0]["stages"]}
        med = lambda rs, key: statistics.median(r["screens"][key] for r in rs)  # noqa: E731
        per_pod = [r["screens"]["preempt_host"] / r["failed"] for r in failing]
        print(f"{w.name}: all {w.warm_pods + w.measured_pods} preemptors bound in "
              f"{len(gpu['rounds'])} resubmission rounds (nominated before each: "
              f"{[len(r) for r in gpu['rounds']]}), {len(gpu['preempted'])} victims; placements, "
              f"nominations and victims == cpu run == the rounds on cuda; {launches} kernel "
              f"launches for {gpu['sched'].batches} batches; every node within its allocatable")
        print(f"{w.name} on cuda: {len(recs)} batches after the init pods, median "
              f"{statistics.median(r['ms'] for r in recs):.2f} ms (min "
              f"{min(r['ms'] for r in recs):.2f}, max {max(r['ms'] for r in recs):.2f}); "
              f"median host ms by stage: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
              + f"; {len(failing)} failing batches: median {statistics.median(r['ms'] for r in failing):.2f} "
              f"ms, failed pods {[r['failed'] for r in failing]}, screen with its read "
              f"{med(failing, 'preempt_screen'):.2f} ms, host Evaluator "
              f"{med(failing, 'preempt_host'):.2f} ms (per failed pod median "
              f"{statistics.median(per_pod):.3f}, max {max(per_pod):.3f}; per batch "
              f"{[round(r['screens']['preempt_host'], 1) for r in failing]}); whole run "
              f"{gpu['wall_s']:.2f} s, cpu {cpu['wall_s']:.2f} s, rounds forced "
              f"{spec['wall_s']:.2f} s")
        print(f"{w.name} preempt_screen on the failing batch {screen['shape']}: cuda == cpu "
              f"exactly, no host read under set_sync_debug_mode(\"error\"); median "
              f"{screen['ms']:.4f} ms over {TIMED_LAUNCHES} (CUDA events; min {screen['min']:.4f}, "
              f"max {screen['max']:.4f}); {screen['kernels']} CUDA kernels, "
              f"{screen['launch_calls']} kernel-launch calls, device busy "
              f"{screen['device_ms']:.4f} ms of {screen['wall_ms']:.2f} ms wall")
        out[w.name] = {"launches": launches, "screen": screen}
    return out


# ---------------------------------------------------------------- gang phase


class _VerdictWatch:
    """Stands in for ``batch_scheduler.gang_verdicts`` during a run: copies
    call ``capture_at``'s inputs and outputs to the host."""

    def __init__(self, capture_at: int):
        self.inner = batch_scheduler.gang_verdicts
        self.calls, self.capture_at, self.captured = 0, capture_at, None

    def __call__(self, *args):
        out = self.inner(*args)
        if self.calls == self.capture_at:
            self.captured = (_host_copy(list(args)), _host_copy(list(out)))
        self.calls += 1
        return out


def _no_host_read(fn, *args):
    """``fn(*args)`` on the card under set_sync_debug_mode("error")."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _check_gangs(name: str, w, run: dict, what: str) -> None:
    """Every pod placed, nothing rejected or turned away; each gang whole
    (flat gangs on distinct hosts, slice gangs contiguous)."""
    _check_placed(name, w, run)
    sched = run["sched"]
    if sched.gang_rejected or sched.retry or sched.fallback:
        raise AssertionError(f"{name} ({what}): gang_rejected {dict(list(sched.gang_rejected.items())[:3])}, "
                             f"retry {sched.retry}, fallback {sched.fallback}")
    hosts = {}
    for ni in sched.snapshot.node_info_map.values():
        for p in ni.pods:
            hosts.setdefault(p.meta.labels["scheduling.x-k8s.io/pod-group"], []).append(
                ni.node.meta.name)
    if any(len(set(v)) != len(v) for v in hosts.values()):
        raise AssertionError(f"{name} ({what}): a gang has two members on one host")
    if w.tpu_slots:
        stats = workloads.slice_stats(sched.snapshot.node_info_map.values())
        if stats["ContiguityViolations"] or stats["BoundSliceGangs"] != len(hosts):
            raise AssertionError(f"{name} ({what}): slice stats {stats}")
        run["slice_stats"] = stats


def _reject_case(device) -> dict:
    """A 128-host torus (2 superpods of 64, hostname and zone labels): a
    gang of 8 anti-affine members whose node selector leaves 6 hosts, then
    a slice gang of 65 hosts, then 3 plain pods. Both gangs must be
    rejected whole ("infeasible"), the plain pods placed, and after the
    next sync the device's requested must equal a fresh encode."""
    from kubernetes_tpu_torch.api.types import LabelSelector, ObjectMeta, PodGroup
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.apiserver.store import Store

    infos = workloads.scheduling_basic_nodes(128, 10, capacity={"cpu": "4", "memory": "16Gi",
                                                                "pods": 8}, tpu_slots=64)
    for ni in infos[10:16]:
        ni.node.meta.labels["rack"] = "r0"
    store = Store()
    for name, k in (("flat", 8), ("wide", 65)):
        store.create_object("PodGroup", PodGroup(meta=ObjectMeta(name=name, namespace="default"),
                                                 min_member=k))
    flat = [make_pod(f"flat-{j}").req({"cpu": "500m", "memory": "1Gi"}).pod_group("flat")
            .node_selector({"rack": "r0"}).pod_affinity(
                "kubernetes.io/hostname",
                LabelSelector(match_labels={"scheduling.x-k8s.io/pod-group": "flat"}),
                anti=True).obj() for j in range(8)]
    wide = [make_pod(f"wide-{j}").req({"cpu": "3500m", "memory": "12Gi"}).pod_group("wide")
            .label("ktpu.dev/slice", "1").obj() for j in range(65)]
    plain = [make_pod(f"plain-{j}").req({"cpu": "250m", "memory": "1Gi"}).obj() for j in range(3)]
    sched = BatchScheduler(infos, caps=workloads.scheduling_slices(128).caps(), device=device,
                           client=store)
    placed = {}
    for pods in (flat, wide, plain):
        placed.update(sched.schedule(pods))
    want = dict.fromkeys((p.key() for p in flat + wide), "infeasible")
    if sched.gang_rejected != want or any(placed[p.key()] for p in flat + wide) or not all(
            placed[p.key()] for p in plain):
        raise AssertionError(f"reject case on {device}: gang_rejected "
                             f"{sorted(set(sched.gang_rejected.values()))}, placed {placed}")
    sched.state.sync(sched.snapshot)
    fresh = DeviceState(sched.caps, "cpu")
    fresh.sync(sched.snapshot)
    if not torch.equal(sched.state.nt.requested.cpu(), fresh.nt.requested):
        raise AssertionError(f"reject case on {device}: requested after the sync != a fresh encode")
    status = {k: (g.phase, g.scheduled) for k, g in store.pod_groups.items()}
    return {"placed": placed, "status": status, "modes": sched.batch_modes,
            "rejections": dict(sched.coscheduling.rejections)}


def _fused_inputs(args, kw, slice_mask):
    """The fused kernel's inputs for a captured batch, as
    ``schedule_batch_core`` builds them, with or without its slice mask."""
    pb, et, nt = args[:3]
    (_m, static_ok, static_ff, taint_raw, affinity_raw, image_score,
     jitter) = batch.static_phase(pb, et, nt, slice_mask=slice_mask)
    pod_bits = batch._pod_port_bits(pb, nt.port_bits.shape[1])
    return [nt.allocatable, nt.requested, nt.nonzero_requested, nt.port_bits, pb.req,
            pb.nonzero_req, pod_bits, static_ok.contiguous(), static_ff.contiguous(),
            taint_raw.contiguous(), affinity_raw.contiguous(), image_score.contiguous(),
            jitter.contiguous(), pb.nominated, pb.valid,
            batch.weight_vector({**batch.DEFAULT_WEIGHTS, **(args[3] or {})})]


def gang_phase() -> dict:
    """SchedulingGangs and SchedulingSlices on the card (auto), on the CPU
    and on the card with the other path forced; the plan and the verdicts
    on the card against the CPU; the reject case."""
    out = {}
    for w, other in ((workloads.scheduling_gangs(), "0"), (workloads.scheduling_slices(), "1")):
        k = -(-w.n_init // P)  # the first measured batch is captured
        slices = bool(w.tpu_slots)
        verdicts = _VerdictWatch(capture_at=-1 if slices else k)
        batch_scheduler.gang_verdicts = verdicts
        try:
            fused_step.LAUNCHES = 0
            gpu = _run(w, "cuda", profile_at=-1 if slices else k + 1, capture_at=k)
            launches = fused_step.LAUNCHES
        finally:
            batch_scheduler.gang_verdicts = verdicts.inner
        _check_gangs(w.name, w, gpu, "cuda")
        want_paths = {"fused"} if slices else {"spec"}
        if set(gpu["paths"]) != want_paths or launches != (gpu["sched"].batches if slices else 0):
            raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, {launches} kernel "
                                 f"launches for {gpu['sched'].batches} batches")
        cpu = _run(w, "cpu")
        _check_gangs(w.name, w, cpu, "cpu")
        _check_same(w.name, gpu, cpu, "the cpu run")
        with _spec_flag(other):
            forced = _run(w, "cuda")
        _check_gangs(w.name, w, forced, "forced")
        _check_same(w.name, forced, gpu, "the cuda run under auto")
        row = {"launches": launches, "gpu": gpu, "workload": w}
        cap = gpu["watch"].captured
        if slices:
            pb, nt = cap["args"][0], cap["args"][2]
            members, grid = cap["kw"]["slice_members"], cap["kw"]["slice_grid"]
            want = batch._slice_plan(pb, nt, members, grid)
            dev = _host_copy([pb, nt, members], "cuda")
            plan_args = (dev[0], dev[1], tuple(dev[2]), grid)
            got = _no_host_read(batch._slice_plan, *plan_args)
            words = batch.unpack_result_block(cap["result"].packed, w.caps().nodes)[2]
            if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)) or not np.array_equal(
                    words, want[1].numpy()):
                raise AssertionError(f"{w.name}: the slice plan differs between cuda and cpu")
            times, _ = _event_ms(lambda: batch._slice_plan(*plan_args))
            prof = _profiled(batch._slice_plan, plan_args, {})
            fargs = _host_copy(cap["args"], "cuda")
            fkw = _host_copy(cap["kw"], "cuda")
            masked = _fused_inputs(fargs, fkw, got[0])
            plain = _fused_inputs(fargs, fkw, None)
            kernel = {}
            for label in ("plain", "masked", "masked", "plain"):
                t, _ = _event_ms(lambda: fused_step.fused_step_batch(
                    *(masked if label == "masked" else plain)))
                kernel.setdefault(label, []).extend(t)
            row.update(plan_ms=statistics.median(times), plan_kernels=prof["kernels"],
                       plan_device_ms=prof["device_ms"],
                       masked_ms=statistics.median(kernel["masked"]),
                       plain_ms=statistics.median(kernel["plain"]))
            detail = (f"batch {k}'s slice plan [G={members[0].shape[0]}, M={members[0].shape[1]}, "
                      f"grid {grid[0]}x{grid[1]}, N={nt.capacity}] cuda == cpu bit for bit (mask, "
                      f"words, and the packed block's slice column), no host read; "
                      f"_slice_plan on the card: median {row['plan_ms']:.4f} ms over "
                      f"{TIMED_LAUNCHES} (CUDA events; min {min(times):.4f}, max {max(times):.4f}), "
                      f"{prof['kernels']} CUDA kernels, device busy {prof['device_ms']:.4f} ms; "
                      f"the fused kernel on this batch (N={nt.capacity}, P={P}) in turns: "
                      f"slice-masked {row['masked_ms']:.4f} ms, unmasked {row['plain_ms']:.4f} ms "
                      f"(median of {2 * TIMED_LAUNCHES} each); slice stats {gpu['slice_stats']}")
        else:
            args, outs = verdicts.captured
            want = batch.gang_verdicts(*args)
            dev = _host_copy(args, "cuda")
            got = _no_host_read(batch.gang_verdicts, *dev)
            if not all(torch.equal(a.cpu(), b) and torch.equal(b, c)
                       for a, b, c in zip(got, want, outs)):
                raise AssertionError(f"{w.name}: gang_verdicts differ between cuda and cpu")
            times, _ = _event_ms(lambda: batch.gang_verdicts(*dev))
            prof = _profiled(batch.gang_verdicts, dev, {})
            row.update(verdicts_ms=statistics.median(times), verdicts_kernels=prof["kernels"],
                       verdicts_device_ms=prof["device_ms"])
            detail = (f"batch {k}'s gang_verdicts [G={args[2].shape[0]}, M={args[2].shape[1]}, "
                      f"N={args[1].shape[1]}] from the card's batch result: cuda == cpu == the "
                      f"run's own, no host read; on the card: median {row['verdicts_ms']:.4f} ms "
                      f"over {TIMED_LAUNCHES} (CUDA events; min {min(times):.4f}, max "
                      f"{max(times):.4f}), {prof['kernels']} CUDA kernels, device busy "
                      f"{prof['device_ms']:.4f} ms")
        # the path auto takes against the other, in turns on the captured batch
        ab = _ab(cap, 1)
        mode = gpu["modes"][k]
        table = "spec" if batch.SPEC_AUTO_CUDA[mode] else "other"
        ratio = ab[table] / ab["other" if table == "spec" else "spec"]
        if ratio > 1.5:
            raise AssertionError(f"{w.name}: SPEC_AUTO_CUDA[{mode!r}] takes the path measured "
                                 f"{ratio:.2f}x slower in turns ({ab})")
        row["ab"] = ab
        print(f"{w.name}: every gang bound whole, gang_rejected, retry and fallback empty, "
              f"placements == cpu run == cuda with KTPU_SPEC={other}; paths {sorted(want_paths)}, "
              f"{launches} kernel launches for {gpu['sched'].batches} batches; {detail}; in turns "
              f"on batch {k} (mode {mode}): rounds {ab['spec']:.2f} ms, "
              f"{'fused kernel' if mode == 'off' else 'scan'} {ab['other']:.2f} ms, auto takes "
              f"{'the rounds' if table == 'spec' else 'the other'}")
        _report(w.name, gpu)
        print(f"{w.name} host ms per measured batch inside the stages: " + ", ".join(
            f"{k2} {v:.3f}" for k2, v in gpu["screen_ms"].items()) + f"; forced path: "
            f"{forced['pods_per_s']:.1f} pods/s, median {forced['median_ms']:.2f} ms per batch; "
            f"cpu {cpu['median_ms']:.2f} ms per batch")
        out[w.name] = row
    on_card, on_cpu = _reject_case("cuda"), _reject_case("cpu")
    if on_card != on_cpu:
        raise AssertionError("reject case: the card's run differs from the cpu's")
    print(f"reject case: a gang of 8 anti-affine members on 6 hosts and a slice gang of 65 "
          f"hosts rejected whole (infeasible) on cuda and cpu alike, the plain pods placed; "
          f"PodGroups {on_card['status']}; rejections {on_card['rejections']}; modes "
          f"{on_card['modes']}; requested after the next sync == a fresh encode")
    return out


# ---------------------------------------------------------------- quota phase


class _QuotaWatch:
    """Stands in for ``batch.quota_screen`` during a run: counts its calls
    and keeps (on the device, copied after the run) the inputs and result
    of the call with the most screened rows."""

    def __init__(self):
        self.inner = batch.quota_screen
        self.calls = 0
        self.captured = None

    def __call__(self, node_idx, ns_idx, req, used, limit):
        out = self.inner(node_idx, ns_idx, req, used, limit)
        rows = int((np.asarray(ns_idx) >= 0).sum())
        if self.captured is None or rows > self.captured["rows"]:
            self.captured = {"rows": rows, "ns": np.array(ns_idx),
                             "args": [node_idx, req, used, limit], "result": out}
        self.calls += 1
        return out


def _timed_batches(sched) -> list:
    """Wraps ``sched._schedule_batch``: each batch's host ms, pods, stage
    and screen ms, and the pods the quota gate turned away and the
    winners the screen flagged, per namespace. Returns the records (of
    the calls that ran a batch: a call whose pods all fail the gates runs
    none)."""
    records = []
    inner = sched._schedule_batch

    def timed(pods):
        s0, c0 = dict(sched.stage_seconds), dict(sched.screen_seconds)
        g0, f0 = dict(sched.quota_gated), dict(sched.quota_flagged)
        b0 = sched.batches
        t0 = time.perf_counter()
        out = inner(pods)
        if sched.batches == b0:
            return out  # every pod failed a PreFilter: no batch ran
        records.append({
            "ms": (time.perf_counter() - t0) * 1e3, "pods": len(pods),
            "failed": sum(v is None for v in out.values()),
            "gated": {k: v - g0.get(k, 0) for k, v in sched.quota_gated.items()
                      if v != g0.get(k, 0)},
            "flagged": {k: v - f0.get(k, 0) for k, v in sched.quota_flagged.items()
                        if v != f0.get(k, 0)},
            "namespaces": {p.meta.namespace for p in pods},
            "path": sched.batch_paths[-1],
            "stages": {k: (v - s0[k]) * 1e3 for k, v in sched.stage_seconds.items()},
            "screens": {k: (v - c0[k]) * 1e3 for k, v in sched.screen_seconds.items()}})
        return out

    sched._schedule_batch = timed
    return records


def _run_soak(w, device) -> dict:
    watch, qwatch = _Watch(), _QuotaWatch()
    batch_scheduler.schedule_batch, batch.quota_screen = watch, qwatch
    try:
        sched = BatchScheduler(w.node_infos(), caps=w.caps(), device=device, client=w.store())
        records = _timed_batches(sched)
        t0 = time.perf_counter()
        out = workloads.run_soak(sched, w)
        wall_s = time.perf_counter() - t0
    finally:
        batch_scheduler.schedule_batch, batch.quota_screen = watch.inner, qwatch.inner
    return {**out, "sched": sched, "watch": watch, "qwatch": qwatch, "records": records,
            "wall_s": wall_s, "quota_rejected": dict(sched.quota_rejected),
            "nominated": dict(sched.nominated), "gang_rejected": dict(sched.gang_rejected),
            "flagged": dict(sched.quota_flagged), "gated": dict(sched.quota_gated),
            "modes": sched.batch_modes, "paths": sched.batch_paths}


SOAK_KEYS = ("placed", "bound", "passes", "rounds", "pending", "quota_rejected", "nominated",
             "gang_rejected", "flagged", "gated", "modes")


def _quota_screen_on_card(name: str, cap: dict) -> dict:
    """The captured batch's screen: the card's result against the CPU's on
    the same inputs, one call under set_sync_debug_mode("error"), CUDA-event
    ms and the profile."""
    args = [a.cpu() for a in cap["args"]]
    want = batch.quota_screen(args[0], cap["ns"], *args[1:])
    if not torch.equal(cap["result"].cpu(), want):
        raise AssertionError(f"{name}: the quota screen differs between cuda and cpu")
    dev = [a.to("cuda") for a in args]
    call = (dev[0], cap["ns"], *dev[1:])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = batch.quota_screen(*call)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"{name}: the quota screen on the card differs from its capture")
    times, _ = _event_ms(lambda: batch.quota_screen(*call))
    prof = _profiled(batch.quota_screen, call, {})
    return {"ms": statistics.median(times), "min": min(times), "max": max(times),
            "kernels": prof["kernels"], "device_ms": prof["device_ms"],
            "wall_ms": prof["wall_ms"], "launch_calls": prof["launch_calls"],
            "rows": cap["rows"], "shape": f"[P={args[0].shape[0]}, NS={args[2].shape[0]}, "
                                          f"Q={args[2].shape[1]}], {cap['rows']} screened rows"}


def quota_phase() -> dict:
    """SchedulingSoak, SchedulingSoak/Cohort and SchedulingSoak/NoGangs
    through ``run_soak`` on the card (auto), on the CPU and on the card with
    the rounds forced. The first two are in mode ``host`` (the rounds) in
    every batch; /NoGangs is in mode ``off``: the fused kernel, then the
    screen, in every batch."""
    out = {}
    for w in (workloads.scheduling_soak(), workloads.scheduling_soak(cohort="soak"),
              workloads.scheduling_soak(gangs=False)):
        fused_step.LAUNCHES = 0
        gpu = _run_soak(w, "cuda")
        launches = fused_step.LAUNCHES
        cpu = _run_soak(w, "cpu")
        with _spec_flag("1"):
            spec = _run_soak(w, "cuda")
        for run, what in ((gpu, "cuda"), (cpu, "cpu"), (spec, "spec")):
            if run["oversubscription"]:
                raise AssertionError(f"{w.name} ({what}): {run['oversubscription']} "
                                     "oversubscribed quota dimensions")
            if run["sched"].fallback:
                raise AssertionError(f"{w.name} ({what}): fallback {run['sched'].fallback}")
        for key in SOAK_KEYS:
            if gpu[key] != cpu[key] or spec[key] != gpu[key]:
                raise AssertionError(f"{w.name}: {key} differ across cuda, cpu and spec")
        off = sum(m == "off" for m in gpu["modes"])
        fused = [p for m, p in zip(gpu["modes"], gpu["paths"]) if m == "off"]
        if launches != off or set(fused) - {"fused"} or gpu["watch"].fused_launches["off"] != off:
            raise AssertionError(f"{w.name}: {launches} kernel launches for {off} mode-off "
                                 "batches")
        bad = [(c, r, n) for c, r, n in spec["watch"].spec if r != n]
        if bad:
            raise AssertionError(f"{w.name}: host reads differ from rounds in {bad[:3]}")
        if "NoGangs" in w.name and (off != len(gpu["modes"]) or off == 0):
            raise AssertionError(f"{w.name}: batches in modes {gpu['modes']}, not all off")
        # a winner flagged in a batch whose tenant the gate let through whole
        clean = [(i, ns, r["path"]) for i, r in enumerate(gpu["records"]) for ns in r["flagged"]
                 if ns not in r["gated"]]
        if not clean:
            raise AssertionError(f"{w.name}: no winner flagged in a batch the gate let through")
        if "NoGangs" in w.name and not any(path == "fused" for _i, _ns, path in clean):
            raise AssertionError(f"{w.name}: no winner flagged after the fused kernel")
        screen = _quota_screen_on_card(w.name, gpu["qwatch"].captured)
        recs = gpu["records"]
        stages = {k: statistics.median(r["stages"][k] for r in recs) for k in recs[0]["stages"]}
        screens = {k: statistics.median(r["screens"][k] for r in recs)
                   for k in ("quota_gate", "quota_table", "quota_reserve", "preempt_host")}
        print(f"{w.name}: {sum(gpu['bound'].values())} pods bound over {w.rounds} rounds "
              f"(per tenant {gpu['bound']}), {len(gpu['pending'])} pending at the end, "
              f"{gpu['passes']} passes in {len(recs)} batches (modes "
              f"{dict((m, gpu['modes'].count(m)) for m in sorted(set(gpu['modes'])))}, paths "
              f"{sorted(set(gpu['paths']))}); gate turned away {gpu['gated']}, screen flagged "
              f"{gpu['flagged']} (first clean batch {clean[0]}); 0 oversubscription at every "
              f"pass; placements, rejections, nominations and ledgers == cpu run == the rounds "
              f"forced; {launches} kernel launches for {off} mode-off batches")
        print(f"{w.name} on cuda: median {statistics.median(r['ms'] for r in recs):.2f} ms per "
              f"batch (min {min(r['ms'] for r in recs):.2f}, max "
              f"{max(r['ms'] for r in recs):.2f}); median host ms by stage: "
              + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
              + "; of which " + ", ".join(f"{k} {v:.2f}" for k, v in screens.items())
              + f"; whole run {gpu['wall_s']:.2f} s, cpu {cpu['wall_s']:.2f} s, rounds forced "
              f"{spec['wall_s']:.2f} s; {gpu['qwatch'].calls} screened batches")
        print(f"{w.name} quota_screen on the batch {screen['shape']}: cuda == cpu exactly, no "
              f"host read under set_sync_debug_mode(\"error\"); median {screen['ms']:.4f} ms "
              f"over {TIMED_LAUNCHES} (CUDA events; min {screen['min']:.4f}, max "
              f"{screen['max']:.4f}); {screen['kernels']} CUDA kernels, "
              f"{screen['launch_calls']} kernel-launch calls, device busy "
              f"{screen['device_ms']:.4f} ms of {screen['wall_ms']:.2f} ms wall")
        out[w.name] = {"launches": launches, "screen": screen}
    return out


# ---------------------------------------------------------------- preempt_all phase


class _ModeScreenWatch(_ScreenWatch):
    """``_ScreenWatch`` keeping one capture per topology mode (the mode of
    the batch ``watch`` saw last)."""

    def __init__(self, watch: "_Watch"):
        super().__init__()
        self.watch = watch
        self.by_mode = {}

    def __call__(self, pb, nt, static_masks, failed_prefix):
        self.captured = self.by_mode.get(self.watch.last_mode)
        out = super().__call__(pb, nt, static_masks, failed_prefix)
        self.by_mode[self.watch.last_mode] = self.captured
        return out


def _run_preempt_all(w, device) -> dict:
    watch = _Watch()
    screens = _ModeScreenWatch(watch)
    batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = watch, screens
    try:
        sched = BatchScheduler(w.node_infos(), caps=w.caps(), device=device, client=w.store())
        records = _timed_batches(sched)
        t0 = time.perf_counter()
        placed, rounds = workloads.run_with_preemption(sched, w)
        wall_s = time.perf_counter() - t0
    finally:
        batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = (watch.inner,
                                                                          screens.inner)
    return {"placed": placed, "rounds": rounds, "preempted": dict(sched.preempted),
            "sched": sched, "watch": watch, "screens": screens, "records": records,
            "wall_s": wall_s, "modes": sched.batch_modes, "paths": sched.batch_paths}



def _check_preempt_all(name: str, w, run: dict, what: str) -> None:
    sched, placed = run["sched"], run["placed"]
    preemptors = [p.key() for p in w.measured_pod_list()]
    unbound = [k for k in preemptors if placed.get(k) is None]
    if unbound or sched.nominated or sched.fallback or sched.retry:
        raise AssertionError(f"{name} ({what}): {len(unbound)} of {len(preemptors)} preemptors "
                             f"unbound after {len(run['rounds'])} rounds, "
                             f"{len(sched.nominated)} nominated, fallback {sched.fallback}, "
                             f"retry {sched.retry}")
    for ni in sched.snapshot.node_info_map.values():
        if (ni.requested.milli_cpu > ni.allocatable.milli_cpu
                or ni.requested.memory > ni.allocatable.memory
                or len(ni.pods) > ni.allocatable.allowed_pod_number):
            raise AssertionError(f"{name} ({what}): {ni.node.meta.name} over its allocatable")
    init = -(-w.init_pods // P)
    if run["modes"][init:init + 3] != ["off", "host", "general"]:
        raise AssertionError(f"{name} ({what}): preemptor batches in modes "
                             f"{run['modes'][init:init + 3]}")


def preempt_all_phase() -> dict:
    """PreemptionAll on the card (auto), on the CPU and on the card with the
    rounds forced."""
    w = workloads.preemption_all()
    fused_step.LAUNCHES = 0
    gpu = _run_preempt_all(w, "cuda")
    launches = fused_step.LAUNCHES
    cpu = _run_preempt_all(w, "cpu")
    with _spec_flag("1"):
        spec = _run_preempt_all(w, "cuda")
    for run, what in ((gpu, "cuda"), (cpu, "cpu"), (spec, "spec")):
        _check_preempt_all(w.name, w, run, what)
    for key in ("placed", "rounds", "preempted", "modes"):
        if gpu[key] != cpu[key] or spec[key] != gpu[key]:
            raise AssertionError(f"{w.name}: {key} differ across cuda, cpu and spec")
    off = sum(m == "off" for m in gpu["modes"])
    if launches != off:
        raise AssertionError(f"{w.name}: {launches} kernel launches for {off} mode-off batches")
    init = -(-w.init_pods // P)
    by_mode = {}
    for mode, cap in sorted(gpu["screens"].by_mode.items()):
        by_mode[mode] = _screen_on_card(f"{w.name} ({mode})", cap)
    recs = gpu["records"][init:]
    print(f"{w.name}: all {len(w.measured_pod_list())} preemptors (claim, anti-affine, spread; "
          f"first batches in modes off, host, general) bound in {len(gpu['rounds'])} "
          f"resubmission rounds (nominated before each: {[len(r) for r in gpu['rounds']]}), "
          f"{len(gpu['preempted'])} victims, fallback empty; placements, nominations and "
          f"victims == cpu run == the rounds forced; {launches} kernel launches for {off} "
          f"mode-off batches; every node within its allocatable; whole run "
          f"{gpu['wall_s']:.2f} s, cpu {cpu['wall_s']:.2f} s, rounds forced {spec['wall_s']:.2f} s")
    for i, (rec, mode) in enumerate(zip(recs[:3], ("off", "host", "general"))):
        print(f"{w.name} first {mode} batch on cuda: {rec['ms']:.2f} ms, {rec['failed']} failed "
              f"pods, screen with its read {rec['screens']['preempt_screen']:.2f} ms, host "
              f"Evaluator {rec['screens']['preempt_host']:.2f} ms; host ms by stage: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["stages"].items()))
    for mode, screen in by_mode.items():
        print(f"{w.name} preempt_screen, mode {mode}, on the failing batch {screen['shape']}: "
              f"cuda == cpu exactly, no host read under set_sync_debug_mode(\"error\"); median "
              f"{screen['ms']:.4f} ms (CUDA events; min {screen['min']:.4f}, max "
              f"{screen['max']:.4f}); {screen['kernels']} CUDA kernels, device busy "
              f"{screen['device_ms']:.4f} ms of {screen['wall_ms']:.2f} ms wall")
    return {w.name: {"launches": launches, "screens": by_mode}}


# ---------------------------------------------------------------- loop phase


def _loop_report(name: str, run: dict) -> None:
    ms = run["measured_batch_ms"]
    n = len(ms)
    m = max(run["measured_batches"], 1)
    ring = (f"ring depth {run['pipeline_depth']}, commit worker "
            f"{'on' if run['commit_worker'] else 'off'}")
    print(f"{name} through the loop ({ring}): {run['metrics']['scheduled']} pods bound in "
          f"{run['batches']} batches (paths {sorted(set(run['paths']))}), fused-kernel "
          f"launches {run['launches']}; measured phase {run['pods_per_s']:.1f} pods/s over "
          f"{run['measured_s']:.3f} s, {n} cycles of median {statistics.median(ms):.2f} ms "
          f"(min {min(ms):.2f}, max {max(ms):.2f}) on the scheduling thread, the settle "
          f"loop's no-progress sleeps {run['measured_idle_ms']:.2f} ms; attempt ms (pop "
          "to commit) " + ", ".join(f"{k} {v:.2f}" for k, v in run["attempt_ms"].items())
          + f"; {run['measured_carry_batches']} of {run['measured_batches']} measured batches "
          f"encoded on the carry; host ms per measured batch on the scheduling thread: "
          + ", ".join(f"{k} {v / m:.2f}" for k, v in run["measured_stage_ms"].items())
          + "; commit ms per measured batch: "
          + ", ".join(f"{k} {v / m:.2f}" for k, v in run["measured_commit_ms"].items())
          + "; per batch over the whole run: "
          + ", ".join(f"{k} {v / run['batches']:.2f}" for k, v in run["stage_ms"].items())
          + f"; measured phase: encode+dispatch spans {run['measured_dispatch_ms']:.2f} ms, "
          f"host commit spans {run['measured_commit_host_ms']:.2f} ms, both at once "
          f"{run['measured_overlap_ms']:.2f} ms")


def _check_loop_same(name: str, got: dict, want: dict, keys) -> None:
    for key in keys:
        if got[key] != want[key]:
            raise AssertionError(f"{name} through the loop: {key} differs from the cpu run")


@contextlib.contextmanager
def _env(**values):
    """Set (a string) or clear (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the ring at its default (depth 2, commits inline), synchronous, and the
# ring with the commit worker
RING = dict(KTPU_PIPELINE_DEPTH=None, KTPU_COMMIT_WORKER=None)
SYNC = dict(RING, KTPU_PIPELINE_DEPTH="0")
WORKER = dict(RING, KTPU_COMMIT_WORKER="1")


def _loop_run(w, label: str, env: dict, **kw) -> dict:
    with _env(**env):
        fused_step.LAUNCHES = 0
        run = workloads.run_loop(w, "cuda", **kw)
    if run["launches"] != fused_step.LAUNCHES:
        raise AssertionError(f"{label}: launches counted twice")
    _loop_report(label, run)
    return run


def _check_all_bound(name: str, w, run: dict) -> None:
    if run["settle_abandoned"] or not all(run["placed"].values()) \
            or len(run["placed"]) != w.n_init + w.n_measured:
        raise AssertionError(f"{name} through the loop: not every pod bound")


class _StrictDispatch:
    """Runs the ``at``-th ring dispatch under ``set_sync_debug_mode("error")``."""

    def __init__(self, inner, at: int):
        self.inner, self.at, self.calls, self.checked = inner, at, 0, None

    def __call__(self, state, enc, *args):
        self.calls += 1
        if self.calls != self.at:
            return self.inner(state, enc, *args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = self.inner(state, enc, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.checked = out.path
        return out


def loop_phase(topo: dict, spec: dict, basic_batch: dict) -> dict:
    """The scheduler loop on the card: the in-flight ring against the
    synchronous loop in turns, the ring at the default deadline, topology
    workloads through the ring (capacity growth), the sampled loop and
    PreemptionBasic (inline ring exact, worker ring bound)."""
    from kubernetes_tpu_torch.backend import tpu_scheduler

    out = {}
    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    with _env(**RING):
        cpu = workloads.run_loop(basic, "cpu", percentage=100)
    turns = {"ring": [], "sync": [], "worker": []}
    envs = {"ring": RING, "sync": SYNC, "worker": WORKER}
    for i, kind in enumerate(("ring", "sync", "worker") * 3):
        gpu = _loop_run(basic, f"{basic.name} [{kind} {i // 3 + 1}]", envs[kind])
        _check_all_bound(basic.name, basic, gpu)
        if set(gpu["paths"]) != {"fused"} or gpu["launches"] != gpu["batches"]:
            raise AssertionError(f"{basic.name} [{kind}]: paths {set(gpu['paths'])}, "
                                 f"{gpu['launches']} launches for {gpu['batches']} batches")
        _check_loop_same(f"{basic.name} [{kind}]", gpu, cpu, ("placed", "cycles", "paths"))
        if kind != "sync" and not (gpu["commit_worker"] == (kind == "worker")
                                   and gpu["measured_carry_batches"]):
            raise AssertionError(f"{basic.name} [{kind}]: worker or carry not as set")
        turns[kind].append(gpu)
    for kind, runs in turns.items():
        print(f"{basic.name} {kind} in turns: pods/s "
              + " / ".join(f"{r['pods_per_s']:.1f}" for r in runs) + "; attempt p50 "
              + " / ".join(f"{r['attempt_ms']['p50']:.2f}" for r in runs) + ", p99 "
              + " / ".join(f"{r['attempt_ms']['p99']:.2f}" for r in runs) + " ms; idle sleeps "
              + " / ".join(f"{r['measured_idle_ms']:.2f}" for r in runs) + " ms; carry share "
              + " / ".join(f"{r['measured_carry_batches']}/{r['measured_batches']}"
                           for r in runs) + "; host commit beside encode+dispatch "
              + " / ".join(f"{r['measured_overlap_ms']:.2f} of {r['measured_commit_host_ms']:.2f}"
                           for r in runs) + " ms")
    print(f"{basic.name}: every run's placements == the cpu loop at percentage 100 (inline "
          f"ring), one kernel launch per batch; BatchScheduler in this call "
          f"{basic_batch['pods_per_s']:.1f} pods/s")
    out[f"{basic.name}/ring"] = {"launches": turns["ring"][0]["launches"], "run": turns["ring"]}
    out[f"{basic.name}/sync"] = {"launches": turns["sync"][0]["launches"], "run": turns["sync"]}
    out[f"{basic.name}/worker"] = {"launches": turns["worker"][0]["launches"],
                                   "run": turns["worker"]}

    # one ring dispatch on the carry (the third, inline: the mode is
    # process-wide) under the strict mode
    strict = _StrictDispatch(tpu_scheduler.dispatch_device_batch, at=3)
    tpu_scheduler.dispatch_device_batch = strict
    try:
        small = workloads.scheduling_basic(N_NODES, 0, 4 * P)
        run = _loop_run(small, f"{small.name}/512 pods [ring, strict dispatch 3]", RING)
    finally:
        tpu_scheduler.dispatch_device_batch = strict.inner
    if strict.checked != "fused" or run["carry_batches"] < 1:
        raise AssertionError(f"strict dispatch: {strict.checked}, carry {run['carry_batches']}")
    print("one ring dispatch on the carry (fused kernel, carry adopted, packed block staged "
          "to pinned memory) ran under set_sync_debug_mode('error'): no host read")

    deadline = _loop_run(basic, f"{basic.name} [ring, default deadline]",
                         dict(RING, KTPU_BATCH_DEADLINE_MS=None), batch_deadline_ms=None)
    _check_all_bound(basic.name, basic, deadline)
    sizes, buckets = {}, {}
    for n, b in zip(deadline["batch_pods"], deadline["buckets"]):
        sizes[n] = sizes.get(n, 0) + 1
        buckets[b] = buckets.get(b, 0) + 1
    print(f"{basic.name} at the default deadline (500 ms): popped batch sizes "
          f"{dict(sorted(sizes.items()))}, program buckets {dict(sorted(buckets.items()))}, "
          f"attempt p99 {deadline['attempt_ms']['p99']:.2f} ms")
    out[f"{basic.name}/deadline"] = {"launches": deadline["launches"], "run": deadline}

    for name, prev in topo.items():
        w = prev["workload"]
        gpu = _loop_run(w, f"{w.name} [ring]", RING)
        with _env(**RING):
            t_cpu = time.perf_counter()
            cpu_run = workloads.run_loop(w, "cpu", percentage=100)
            cpu_s = time.perf_counter() - t_cpu
        _check_all_bound(w.name, w, gpu)
        _check_loop_same(w.name, gpu, cpu_run, ("placed", "cycles", "modes"))
        caps = {k: v for k, v in gpu["caps"].items() if v != cpu_run["caps"][k]}
        if caps:
            raise AssertionError(f"{w.name}: grown capacities differ from the cpu's: {caps}")
        bs = spec[name]["pods_per_s"]
        print(f"{w.name} through the ring: placements == the cpu loop ({cpu_s:.1f} s), "
              f"capacities grown past caps_for_cluster: {gpu['grown'] or 'none'}; "
              f"paths {sorted(set(gpu['paths']))}; "
              f"{gpu['pods_per_s']:.1f} pods/s, attempt p99 {gpu['attempt_ms']['p99']:.2f} ms; "
              f"BatchScheduler in this call: rounds {bs['spec']:.1f} pods/s, "
              f"{bs_other(prev)} {bs['other']:.1f} pods/s")
        out[f"{w.name}/ring"] = {"launches": gpu["launches"], "run": gpu}

    sampled = workloads.scheduling_basic(1000, 0, 256)
    s_gpu = _loop_run(sampled, f"{sampled.name} at percentage 10 [ring]", RING, percentage=10)
    with _env(**RING):
        s_cpu = workloads.run_loop(sampled, "cpu", percentage=10)
    if (set(s_gpu["paths"]) != {"scan"} or s_gpu["launches"] != 0 or s_gpu["settle_abandoned"]
            or len(s_gpu["placed"]) != sampled.n_measured or not all(s_gpu["placed"].values())):
        raise AssertionError(f"sampled loop: paths {set(s_gpu['paths'])}, {s_gpu['launches']} "
                             "kernel launches, or a pod unbound")
    _check_loop_same("sampled loop", s_gpu, s_cpu, ("placed", "start", "cycles"))
    print(f"sampled loop: {s_gpu['batches']} batches on the scan, final window start "
          f"{s_gpu['start']} == cpu, placements == cpu")
    out["sampled"] = {"launches": s_gpu["launches"], "run": s_gpu}

    pre = workloads.preemption_basic()
    with _env(**RING):
        p_cpu = workloads.run_loop(pre, "cpu", percentage=100)
    for label, env in (("inline ring", RING), ("worker ring", WORKER)):
        p_gpu = _loop_run(pre, f"{pre.name} [{label}]", env)
        preemptors = [k for k in p_gpu["placed"] if "/preemptor-" in k or "/warm-" in k]
        if not all(p_gpu["placed"][k] for k in preemptors) or p_gpu["settle_abandoned"]:
            raise AssertionError(f"{pre.name} [{label}]: a preemptor is unbound")
        if p_gpu["launches"] != p_gpu["batches"]:
            raise AssertionError(f"{pre.name} [{label}]: {p_gpu['launches']} launches for "
                                 f"{p_gpu['batches']} batches")
        if label == "inline ring":
            _check_loop_same(pre.name, p_gpu, p_cpu,
                             ("placed", "preempted", "nominations", "cycles", "metrics"))
        print(f"{pre.name} through the {label}: {len(preemptors)} preemptors bound, "
              f"{len(p_gpu['preempted'])} victims, {len(p_gpu['nominations'])} nominations, "
              f"pods popped per settle {p_gpu['cycles']}"
              + ("; all == cpu" if label == "inline ring" else
                 f" (the cpu's inline ring: {len(p_cpu['preempted'])} victims, "
                 f"{len(p_cpu['nominations'])} nominations, {p_cpu['cycles']})"))
        out[f"{pre.name}/{label.split()[0]}"] = {"launches": p_gpu["launches"], "run": p_gpu}
    return out


def bs_other(prev: dict) -> str:
    return sorted(set(prev["gpu"]["paths"]))[-1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    lib = fused_step.build_library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    report = lib.with_suffix(".ptxas.txt")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())
    device = torch.device("cuda")
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    kern = timed("kernel", kernel_phase, device)
    sl = timed("slice", slice_phase)
    basic_name = sl["workload"].name
    topo = timed("topology", topology_phase)
    spec = timed("spec", spec_phase, sl, topo)
    dra = timed("dra", dra_phase)
    pre = timed("preempt", preempt_phase)
    gangs = timed("gang", gang_phase)
    quota = timed("quota", quota_phase)
    pre_all = timed("preempt_all", preempt_all_phase)
    loop = timed("loop", loop_phase, topo, spec, sl["gpu"])
    slices_name = next(k for k, v in gangs.items() if v["workload"].tpu_slots)
    print("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    print(json.dumps({"kernels": [{
        "name": "fused_step_batch", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/fused_step.cu",
        "replaces": "kubernetes_tpu/ops/pallas_step.py:62",
        "launches": sl["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "masked_ms": kern["masked_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None,
        "launches_by_workload": {basic_name: sl["launches"],
                                 **{k: v["launches"] for k, v in dra.items()},
                                 **{k: v["launches"] for k, v in pre.items()},
                                 **{k: v["launches"] for k, v in gangs.items()},
                                 **{k: v["launches"] for k, v in quota.items()},
                                 **{k: v["launches"] for k, v in pre_all.items()},
                                 **{f"loop:{k}": v["launches"] for k, v in loop.items()}},
        "slice_masked_ms": gangs[slices_name]["masked_ms"],
        "slice_unmasked_ms": gangs[slices_name]["plain_ms"],
        "status": "ported, exact against the plain version; cluster of 8 blocks"}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
