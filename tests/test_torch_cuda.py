"""The CUDA fused-step kernel against its plain PyTorch version (masked,
nominated and slice-masked batches among them), and the topology scan, the
speculative rounds, the claim mask, the preemption screen, the quota
screen, the slice planner, the gang assigner and the claim, volume,
preemption, gang, quota and PreemptionAll workloads and the scheduler loop
(SchedulingBasic, the ring, gangs, slices, the soak, claims and volumes,
delayed binding, the soak's device flap, SchedulingReplay, SchedulingElastic and
a drain wave) against their CPU runs, ``packing_entropy`` against its plain
version, and
the warm sweep's launches against the plain version, on the card. With the
observability layer on: a batch read through ``materialize_profiled``
(``deviceExecS`` > 0, the packed block's fetch bytes), an observed loop run
(dispatch count == fused launches, each ``deviceExecS`` within its cycle,
the memory sample's three keys, placements == the run with the recorders
off) and the latency ledger on the card == the CPU loop's. The wire
service (``backend/service.py``) on the card against a CPU service:
SchedulingBasic at depth 0 and 3, preemption hints, a restart and two
replicas; the device fabric of two card services with the primary killed
(cold and warm standbys) and the gRPC transport (skipped without grpc).
Node-axis sharding (``parallel/``): one NCCL rank's sharded scan against
the fused kernel's batch at N=5120, and two gloo ranks on the card
against two on the CPU in modes off and host. The scheduler_perf harness,
the controller manager and the loop taking turns
(``perf/control_plane.py``), and the loop behind the API front with its
write-ahead log, crash and restore (``perf/apiserver.py``), each against
its CPU run.

Marked ``cuda``: without a CUDA device these tests skip. They import no JAX,
so they also run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops import fused_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _batch(rng, p, n, r=6, w=16):
    alloc = rng.choice([0, 3, 7, 1000, 4000, 32000], size=(n, r)).astype(np.int32)
    nz = (alloc * rng.uniform(0, 1.1, size=(n, r))).astype(np.int32)
    ports = np.where(rng.uniform(size=(n, w)) < 0.05,
                     rng.randint(0, 1 << 31, size=(n, w)), 0).astype(np.int32)
    p_req = rng.choice([0, 1, 2, 100, 900], size=(p, r)).astype(np.int32)
    p_bits = np.zeros((p, w), np.int32)
    for i in range(0, p, 3):
        p_bits[i, rng.randint(w)] = 1 << rng.randint(31)
    jitter = np.where(rng.uniform(size=(p, n)) < 0.5, 0.0,
                      rng.randint(0, 1 << 24, size=(p, n)) * (0.5 / (1 << 24)))
    nominated = np.full(p, -1, np.int32)
    nominated[1] = n // 2
    valid = np.ones(p, bool)
    valid[-2:] = False
    static_ok = (rng.uniform(size=(p, n)) < 0.9) & valid[:, None]
    return dict(
        alloc=alloc, requested=(nz * 0.9).astype(np.int32), nonzero=nz, ports=ports,
        p_req=p_req, p_nz=np.maximum(p_req, 1), p_bits=p_bits, static_ok=static_ok,
        static_ff=np.where(static_ok, 0, rng.randint(1, 5, size=(p, n))).astype(np.int8),
        taint=rng.randint(0, 3, size=(p, n)).astype(np.float32),
        aff=rng.choice([0, 2, 5], size=(p, n)).astype(np.float32),
        img=rng.choice([0, 0, 42], size=(p, n)).astype(np.float32),
        jitter=jitter.astype(np.float32), nominated=nominated, p_valid=valid)


def _slice_ties_batch(rng, p, n, r=6, w=16):
    """Uniform node state (commits of 1 keep LeastAllocated at 99 and
    BalancedAllocation at 100), so totals differ only by the score rows. Pod
    i ties the two nodes across slice boundary k*m (k = 1 + i % 7, m the
    kernel's slice width) with the best scores and jitter 0.5, every other
    node below; pod 3 has no feasible node."""
    m = -(-n // fused_step.CLUSTER)
    d = _batch(rng, p, n, r, w)
    d["alloc"] = np.full((n, r), 32000, np.int32)
    d["requested"] = d["nonzero"] = np.full((n, r), 160, np.int32)
    d["ports"] = np.zeros((n, w), np.int32)
    d["p_nz"][:, :2] = 1
    d["nominated"][:] = -1
    d["jitter"] = (d["jitter"] * 0.5).astype(np.float32)  # below 0.25
    d["p_valid"][:] = True
    want = np.empty(p, np.int32)
    for i in range(p):
        k = 1 + i % 7
        ties = [k * m - 1, k * m]
        d["static_ok"][i, ties] = True
        d["taint"][i, ties], d["aff"][i, ties], d["img"][i, ties] = 0.0, 5.0, 42.0
        d["jitter"][i, ties] = 0.5
        want[i] = k * m - 1
    d["static_ok"][3] = False
    want[3] = -1
    d["static_ff"] = np.where(d["static_ok"], 0, 1).astype(np.int8)
    return d, want


def _args(cuda, d):
    return [torch.from_numpy(np.ascontiguousarray(d[k])).to(cuda) for k in (
        "alloc", "requested", "nonzero", "ports", "p_req", "p_nz", "p_bits",
        "static_ok", "static_ff", "taint", "aff", "img", "jitter", "nominated",
        "p_valid")]


def _assert_equal(got, want):
    """Every output equal, floats by bit pattern."""
    for name, a, b in zip(got._fields, got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


def _run(cuda, d, weights=(1.0, 1.0, 3.0, 2.0, 1.0)):
    """Kernel and plain version on the card: equal outputs and exactly one
    launch. Returns the kernel's outputs."""
    args = _args(cuda, d)
    before = fused_step.LAUNCHES
    got = fused_step.fused_step_batch(*args, weights)
    torch.cuda.synchronize()
    assert fused_step.LAUNCHES == before + 1
    _assert_equal(got, fused_step.fused_step_batch_ref(*args, weights))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 128, 1000, 5003, 5120, 8193])
def test_kernel_matches_plain_version(cuda, n):
    # fewer nodes than blocks (1, 7), a short last slice (5003, 8193), and
    # more than one node per thread (8193: 1025 slots per block over the
    # 992 threads of warps 1-31)
    got = _run(cuda, _batch(np.random.RandomState(n), 32, n))
    assert int(got.node_idx[-1]) == -1  # a padded pod commits nothing


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5003, 5120, 8193])
def test_kernel_ties_across_slice_boundaries(cuda, n):
    # at 8193 the tied winner k*m - 1 is the second node of its owner thread
    d, want = _slice_ties_batch(np.random.RandomState(n + 1), 32, n)
    got = _run(cuda, d)
    np.testing.assert_array_equal(got.node_idx.cpu().numpy(), want)
    assert not bool(got.any_feasible[3])  # no feasible node: best is node 0's total


@pytest.mark.cuda
def test_phase_stamps_leave_the_kernel_exact(cuda):
    # the -DKTPU_PHASE_STAMPS build that perf/kernel_phases.py reads
    from kubernetes_tpu_torch.perf import kernel_phases

    args = _args(cuda, _batch(np.random.RandomState(11), 32, 5120))
    got, stamps, _ms = kernel_phases.run_stamped(args)
    _assert_equal(got, fused_step.fused_step_batch_ref(*args, kernel_phases.WEIGHTS))
    assert stamps.shape == (fused_step.CLUSTER, 32, kernel_phases.STAMPS)
    assert (np.diff(stamps, axis=2) >= 0).all()  # each pod's phases in order


def _topo_state(keys, seed, device):
    """A seeded topology batch encoded on the CPU (port API only), its mode,
    and its inputs moved to ``device``."""
    import dataclasses

    from _torch_cases import (SnapshotShim, build_topo_nodes, build_topo_pods,
                              topo_cluster_spec, topo_pods_spec, torch_api)
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster

    caps = dataclasses.replace(caps_for_cluster(1000, batch=64), sigs=16, ex_terms=32)
    sched = BatchScheduler([], caps=caps, device="cpu")
    ds = sched.state
    ds.sync(SnapshotShim(build_topo_nodes(torch_api(), topo_cluster_spec(1000, seed, keys))))
    pods = build_topo_pods(torch_api(), topo_pods_spec(64, seed + 1, keys, nominate="node-9"))
    pb, et = ds.encoder.encode_pods(pods)
    tb = ds.sig_table.encode_topo(pods)
    mode, vd, host_key = sched._topo_mode_info()

    def to(obj):
        return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                            for f in dataclasses.fields(obj)})

    return (to(pb), to(et), to(ds.nt)), dict(tc=to(ds.tc), tb=to(tb), topo_mode=mode,
                                             vd_override=vd, host_key=host_key)


@pytest.mark.cuda
@pytest.mark.parametrize("keys,mode", [(("kubernetes.io/hostname",), "host"),
                                       (("topology.kubernetes.io/zone",
                                         "kubernetes.io/hostname"), "general")])
def test_topology_scan_matches_cpu(cuda, keys, mode):
    from kubernetes_tpu_torch.backend.batch import schedule_batch

    args, kw = _topo_state(keys, 3, cuda)
    assert kw["topo_mode"] == mode
    before = fused_step.LAUNCHES
    got = schedule_batch(*args, device=cuda, **kw)
    torch.cuda.synchronize()
    assert fused_step.LAUNCHES == before  # the scan, not the fused kernel
    args, kw = _topo_state(keys, 3, "cpu")
    want = schedule_batch(*args, device="cpu", **kw)
    for name in ("node_idx", "best_score", "any_feasible", "fit_ok", "ports_ok", "spread_ok",
                 "ipa_ok", "first_fail", "final_requested", "final_nonzero", "final_ports",
                 "final_class_req", "final_sel_counts", "final_seg_exist", "packed"):
        a, b = getattr(got, name).cpu(), getattr(want, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    assert int((want.node_idx >= 0).sum()) > 32


def _off_state(seed, device):
    """A seeded batch of mode off (every static filter and score, host
    ports, a nominated pod) encoded on the CPU, moved to ``device``."""
    import dataclasses

    from _torch_cases import SnapshotShim, build_nodes, build_pods, cluster_spec, pods_spec, torch_api
    from kubernetes_tpu_torch.backend.device_state import DeviceState, caps_for_cluster

    ds = DeviceState(caps_for_cluster(1000, batch=64), device="cpu")
    ds.sync(SnapshotShim(build_nodes(torch_api(), cluster_spec(1000, seed))))
    pb, et = ds.encoder.encode_pods(build_pods(torch_api(), pods_spec(64, seed + 1,
                                                                      nominate="node-9")))

    def to(obj):
        return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                            for f in dataclasses.fields(obj)})

    return (to(pb), to(et), to(ds.nt)), dict(ports_enabled=ds.encoder.last_has_ports)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["off", "host", "general"])
def test_spec_rounds_match_cpu(cuda, mode):
    """The speculative rounds on the card against the rounds on the CPU:
    every BatchResult field, floats by bit pattern, and the same rounds."""
    from kubernetes_tpu_torch.backend import batch

    def state(device):
        if mode == "off":
            return _off_state(4, device)
        keys = {"host": ("kubernetes.io/hostname",),
                "general": ("topology.kubernetes.io/zone", "kubernetes.io/hostname")}[mode]
        args, kw = _topo_state(keys, 5, device)
        assert kw["topo_mode"] == mode
        return args, kw

    args, kw = state(cuda)
    before, rounds0 = fused_step.LAUNCHES, batch.ROUNDS
    got = batch.schedule_batch(*args, device=cuda, spec_decode=True, **kw)
    torch.cuda.synchronize()
    rounds = batch.ROUNDS - rounds0
    assert fused_step.LAUNCHES == before and rounds >= 1
    args, kw = state("cpu")
    want = batch.schedule_batch(*args, device="cpu", spec_decode=True, **kw)
    assert batch.ROUNDS - rounds0 == 2 * rounds
    for f in ("node_idx", "best_score", "any_feasible", "fit_ok", "ports_ok", "spread_ok",
              "ipa_ok", "first_fail", "final_requested", "final_nonzero", "final_ports",
              "final_class_req", "final_sel_counts", "final_seg_exist", "packed"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None and mode == "off", f
            continue
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert int((want.node_idx >= 0).sum()) > 32


def _masked_batch(rng, p, n):
    """A batch whose static_ok carries a volume screen (first-fail id 9) and
    a claim mask (id 10) on about a third of the cells, under the static
    ids 1-4, and three pods with every node masked by claims."""
    d = _batch(rng, p, n)
    extra = rng.uniform(size=(p, n)) > 1 / 6
    dra = rng.uniform(size=(p, n)) > 1 / 6
    dra[[0, 5, 9]] = False
    ff = d["static_ff"]
    ff = np.where(ff > 0, ff, np.where(~extra, 9, np.where(~dra, 10, 0))).astype(np.int8)
    d["static_ok"] = d["static_ok"] & extra & dra
    d["static_ff"] = np.where(d["static_ok"], 0, np.where(ff > 0, ff, 1)).astype(np.int8)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 5120])
def test_kernel_matches_plain_version_on_masked_batch(cuda, n):
    got = _run(cuda, _masked_batch(np.random.RandomState(n + 7), 32, n))
    ff = got.first_fail.cpu().numpy()
    assert {9, 10}.issubset(set(np.unique(ff).tolist()))
    assert (got.node_idx.cpu().numpy()[[0, 5, 9]] == -1).all()


@pytest.mark.cuda
def test_claim_mask_on_card_matches_cpu(cuda):
    from kubernetes_tpu_torch.backend.batch import claim_feasibility_mask

    rng = np.random.RandomState(3)
    n, a, p, s = 5120, 8, 128, 4
    pool = np.array([-(2 ** 31), -1, 0, 1, 8, 16, 2 ** 31 - 1])
    kind = rng.choice([0, 1, 2], size=(n, a)).astype(np.int32)
    val = np.where(kind == 2, rng.randint(1, 4, size=(n, a)), rng.choice(pool, size=(n, a)))
    sel = [rng.randint(0, a, size=(p, s)), rng.choice([-1, 0, 1, 2, 3, 4, 5], size=(p, s)),
           rng.choice([1, 2], size=(p, s)), rng.choice(pool, size=(p, s))]
    arrays = [x.astype(np.int32) for x in sel] + [kind, np.where(kind == 0, 0, val).astype(np.int32)]
    got = claim_feasibility_mask(*(torch.from_numpy(x).to(cuda) for x in arrays))
    want = claim_feasibility_mask(*(torch.from_numpy(x) for x in arrays))
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < want.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scheduling_dra", "scheduling_intree_pvs"])
def test_claim_and_volume_workloads_match_cpu(cuda, name):
    """A small SchedulingDRA / SchedulingInTreePVs through BatchScheduler on
    the card (every batch on the fused kernel) and on the CPU: the same
    placements and claim allocations, nothing turned away."""
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster
    from kubernetes_tpu_torch.perf import workloads

    w = getattr(workloads, name)(nodes=300, init_pods=200, measured=100)
    runs = []
    for device in (cuda, "cpu"):
        store = w.store()
        sched = BatchScheduler(w.node_infos(), caps=caps_for_cluster(300, batch=64),
                               device=device, client=store)
        before = fused_step.LAUNCHES
        placed = sched.schedule(w.init_pod_list() + w.measured_pod_list())
        runs.append((placed, {k: (c.allocated_node, c.reserved_for)
                              for k, c in store.resource_claims.items()}))
        assert all(placed.values()) and not sched.retry and not sched.fallback
        if device != "cpu":
            assert fused_step.LAUNCHES - before == sched.batches
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 5120])
def test_kernel_matches_plain_version_on_nominated_batch(cuda, n):
    """Half the pods nominated (resubmitted preemptors): to feasible nodes,
    to infeasible ones and to padded slots."""
    rng = np.random.RandomState(n + 11)
    d = _batch(rng, 128, n)
    d["alloc"][:] = 32000  # room for every pod, so most nominated nodes are feasible
    d["requested"] = d["nonzero"] = np.full_like(d["alloc"], 8000)
    d["nominated"][::2] = rng.choice(n, size=64, replace=False)
    d["nominated"][2] = n - 1
    d["static_ok"][4, d["nominated"][4]] = False
    got = _run(cuda, d)
    idx, nom = got.node_idx.cpu().numpy(), d["nominated"]
    ok = d["static_ok"][np.arange(128), np.maximum(nom, 0)] & (nom >= 0)
    assert (idx[ok] == nom[ok]).mean() > 0.5  # the bonus steers them to their node
    assert idx[4] != nom[4]


def _preempt_cluster(device, n=500, classes=(1, 5, 20, 2000000000)):
    """PreemptionBasic's nodes with its victims bound four per node, at a
    few priorities, synced into a DeviceState, and an encoded batch of 128
    preemptors."""
    from kubernetes_tpu_torch.backend.device_state import DeviceState, caps_for_cluster
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.preemption_basic(nodes=n, init_pods=4 * n, measured=128)
    infos = w.node_infos()
    for i, pod in enumerate(w.init_pod_list()):
        pod.spec.priority = classes[i % len(classes)]
        pod.spec.node_name = infos[i % n].node.meta.name
        infos[i % n].add_pod(pod)
    ds = DeviceState(caps_for_cluster(n), device)
    ds.sync(Snapshot(infos))
    pods = w.measured_pod_list()
    for i, pod in enumerate(pods):
        pod.spec.priority = (100, 2000000001, 2**30)[i % 3]
    pb, et = ds.encoder.encode_pods(pods)
    ds.preempt_inputs()  # class_prio refreshed for the batch's new priorities
    return ds, pb, et


@pytest.mark.cuda
def test_preempt_screen_on_card_matches_cpu(cuda):
    from kubernetes_tpu_torch.backend.batch import static_phase
    from kubernetes_tpu_torch.ops import preempt

    failed = np.random.RandomState(5).uniform(size=128) < 0.8
    results = []
    for device in (cuda, "cpu"):
        ds, pb, et = _preempt_cluster(device)
        masks = static_phase(pb, et, ds.nt)[0]
        rows = np.flatnonzero(failed).tolist()
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")  # no host read inside the screen
        try:
            res = preempt.preempt_screen(pb, ds.nt, masks, rows)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        results.append((res.screen.cpu(), res.best.cpu()))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])
    assert int((results[1][1] >= 0).sum()) > 64


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["preemption_basic", "preemption_pvs"])
def test_preemption_workload_matches_cpu(cuda, name):
    """A small PreemptionBasic / PreemptionPVs on the card (every batch on
    the fused kernel) and on the CPU: the same placements, nominations and
    victims, every preemptor bound."""
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster
    from kubernetes_tpu_torch.perf import workloads

    w = getattr(workloads, name)(nodes=100, init_pods=400, measured=100)
    runs = []
    for device in (cuda, "cpu"):
        sched = BatchScheduler(w.node_infos(), caps=caps_for_cluster(100, batch=32),
                               device=device, client=w.store())
        before = fused_step.LAUNCHES
        placed, rounds = workloads.run_with_preemption(sched, w)
        runs.append((placed, rounds, dict(sched.preempted)))
        assert all(placed.values()) and not sched.nominated and not sched.fallback
        if device != "cpu":
            assert fused_step.LAUNCHES - before == sched.batches
    assert runs[0] == runs[1]


# ---------------------------------------------------------------- gangs and slices


@pytest.mark.cuda
def test_plan_slices_and_assign_gangs_match_cpu(cuda):
    """The torus planner at SchedulingSlices' grid (8 superpods of 64 slots,
    duplicate and missing coordinates, blocked cells) and the gang assigner
    at 8 gangs of 32 on 5120 nodes: the card's result equals the CPU's, and
    neither reads a value on the host."""
    import types

    from kubernetes_tpu_torch.ops.gang import assign_gangs
    from kubernetes_tpu_torch.ops.slice import plan_slices

    rng = np.random.RandomState(11)
    n, sp, slots = 600, 8, 64
    cell = rng.randint(0, sp * slots + 20, size=n)
    nodes = {"valid": rng.uniform(size=n) > 0.03, "unschedulable": rng.uniform(size=n) < 0.03,
             "allocatable": np.full((n, 2), 4000, np.int32),
             "requested": np.where(rng.uniform(size=(n, 2)) < 0.2, 3000, 0).astype(np.int32),
             "topo_sp": (cell // slots).astype(np.int32), "topo_pos": (cell % slots).astype(np.int32)}
    req = np.full((128, 2), 1000, np.int32)
    member_idx = np.full((8, 64), -1, np.int32)
    for g, k in enumerate([2, 2, 8, 8, 64, 3, 1, 65]):
        member_idx[g, :min(k, 64)] = np.arange(16 * g, 16 * g + min(k, 64)) % 128
    args = [req, member_idx, member_idx >= 0]

    def upload(device):
        return (types.SimpleNamespace(**{k: torch.from_numpy(v).to(device)
                                         for k, v in nodes.items()}),
                *(torch.from_numpy(a).to(device) for a in args))

    want = plan_slices(*upload("cpu"), (sp, slots))
    plan_args = upload(cuda)
    feasible = rng.uniform(size=(8, 32, 5120)) < 0.01
    prefer = rng.randint(-1, 5120, size=(8, 32)).astype(np.int32)
    active = np.arange(32)[None, :] < rng.randint(1, 33, size=(8, 1))
    feasible[1, 0] = False                       # a member with no feasible node
    active[5, :6] = True
    feasible[5] = False
    feasible[5, :, :3] = True                    # 6 members, 3 nodes: no cover
    gang_args = [feasible, prefer, active]
    want_gangs = assign_gangs(*map(torch.from_numpy, gang_args))
    on_card = [torch.from_numpy(a).to(cuda) for a in gang_args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = plan_slices(*plan_args, (sp, slots))
        got_gangs = assign_gangs(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got + got_gangs, want + want_gangs):
        assert torch.equal(a.cpu(), b)
    assert 0 < int(want[1].sum()) < 8 and 0 < int(want_gangs[1].sum()) < 8


def _slice_masked_batch(rng, p, n):
    """A batch whose static_ok carries a slice mask: pods 0-7 pinned to one
    node each (first-fail id 11 elsewhere), pods 8-9 to no node, under the
    static ids 1-4."""
    d = _batch(rng, p, n)
    pin = np.ones((p, n), bool)
    pin[:10] = False
    pin[np.arange(8), rng.choice(n, size=8, replace=False)] = True
    ff = np.where(d["static_ff"] > 0, d["static_ff"], np.where(~pin, 11, 0)).astype(np.int8)
    d["static_ok"] = d["static_ok"] & pin
    d["static_ff"] = np.where(d["static_ok"], 0, np.where(ff > 0, ff, 1)).astype(np.int8)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 5120])
def test_kernel_matches_plain_version_on_slice_masked_batch(cuda, n):
    got = _run(cuda, _slice_masked_batch(np.random.RandomState(n + 9), 32, n))
    assert 11 in np.unique(got.first_fail.cpu().numpy())
    assert (got.node_idx.cpu().numpy()[[8, 9]] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scheduling_gangs", "scheduling_slices"])
def test_gang_workloads_match_cpu(cuda, name):
    """A small SchedulingGangs / SchedulingSlices through BatchScheduler on
    the card and on the CPU: the same placements, every gang whole."""
    import dataclasses

    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.perf import workloads

    w = (workloads.scheduling_gangs(nodes=300, init_gangs=1, measured_gangs=2)
         if name == "scheduling_gangs" else workloads.scheduling_slices())
    runs = []
    for device in (cuda, "cpu"):
        sched = BatchScheduler(w.node_infos(), caps=dataclasses.replace(w.caps()),
                               device=device, client=w.store())
        placed = sched.schedule(w.init_pod_list())
        placed.update(sched.schedule(w.measured_pod_list()))
        assert all(placed.values()) and not sched.gang_rejected
        runs.append(placed)
    assert runs[0] == runs[1]
    if name == "scheduling_slices":
        stats = workloads.slice_stats(sched.snapshot.node_info_map.values())
        assert stats["ContiguityViolations"] == 0.0 and stats["BoundSliceGangs"] == 9.0


# ---------------------------------------------------------------- quota and preemption of every batch


@pytest.mark.cuda
def test_quota_screen_on_card_matches_cpu(cuda):
    """The screen on the card against the CPU on a seeded batch of 128
    pods over 16 namespaces (losers, unscreened rows, a same-namespace run,
    sums past 2**31 - 1), with no host read."""
    from kubernetes_tpu_torch.ops import quota

    rng = np.random.RandomState(5)
    p, ns_n = 128, 16
    node_idx = np.where(rng.uniform(size=p) < 0.2, -1, rng.randint(0, 512, p)).astype(np.int32)
    ns_idx = rng.randint(-1, ns_n, p).astype(np.int32)
    ns_idx[10:40] = 3
    used = rng.randint(0, 40, (ns_n, 4)).astype(np.int32)
    used[5] = 2**31 - 10
    req = rng.randint(0, 5, (p, 4)).astype(np.int32)
    limit = (used + rng.randint(0, 30, (ns_n, 4))).astype(np.int32)
    limit[5] = 2**31 - 1
    want = quota.quota_screen(torch.from_numpy(node_idx), ns_idx, torch.from_numpy(req),
                              torch.from_numpy(used), torch.from_numpy(limit))
    args = [torch.from_numpy(a).to(cuda) for a in (node_idx, req, used, limit)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = quota.quota_screen(args[0], ns_idx, *args[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.cpu(), want)
    assert int((want == quota.QUOTA_SCREEN_BIT).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cohort", ["", "soak"])
def test_quota_screened_workload_matches_cpu(cuda, cohort):
    """A small SchedulingSoak without gangs (every batch in mode off, on the
    fused kernel with the screen after it) on the card and on the CPU: the
    same placements, ledgers and rejections, flagged winners, no
    oversubscription."""
    import dataclasses

    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_soak(nodes=60, scale=4, rounds=3, gangs=False, cohort=cohort)
    caps = dataclasses.replace(w.caps(), pods=32)
    runs = []
    for device in (cuda, "cpu"):
        sched = BatchScheduler(w.node_infos(), caps=caps, device=device, client=w.store())
        before = fused_step.LAUNCHES
        out = workloads.run_soak(sched, w)
        runs.append((out, dict(sched.quota_rejected), sched.quota_flagged))
        assert out["oversubscription"] == 0 and sched.quota_flagged
        assert set(sched.batch_modes) == {"off"}
        if device != "cpu":
            assert fused_step.LAUNCHES - before == sched.batches
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_preempt_all_workload_matches_cpu(cuda):
    """A small PreemptionAll (claim, anti-affine and spread preemptors) on
    the card and on the CPU: the same placements, nominations and victims,
    every preemptor bound, nothing in fallback."""
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.preemption_all(nodes=100, init_pods=400, per_kind=32)
    runs = []
    for device in (cuda, "cpu"):
        sched = BatchScheduler(w.node_infos(), caps=caps_for_cluster(100, batch=32),
                               device=device, client=w.store())
        placed, rounds = workloads.run_with_preemption(sched, w)
        runs.append((placed, rounds, dict(sched.preempted), sched.batch_modes))
        assert all(placed.values()) and not sched.nominated and not sched.fallback
        assert {"off", "host", "general"} <= set(sched.batch_modes)
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scheduling_basic", "preemption_basic"])
def test_scheduler_loop_matches_cpu(cuda, name, monkeypatch):
    """The scheduler loop (store, cache, queue, TPUScheduler) on the card
    against its full-batch CPU run: the same placements, victims,
    nominations and pods popped; on the card every batch is one fused-kernel
    launch. PreemptionBasic's failures requeue in an order that follows the
    commit worker's timing, so it runs the inline ring on the card."""
    from kubernetes_tpu_torch.perf import workloads

    w = (workloads.scheduling_basic(nodes=300, init_pods=200, measured=300)
         if name == "scheduling_basic"
         else workloads.preemption_basic(nodes=48, init_pods=192, measured=48))
    if name == "preemption_basic":
        monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    gpu = workloads.run_loop(w, cuda, batch_size=64)
    cpu = workloads.run_loop(w, "cpu", percentage=100, batch_size=64)
    for key in ("placed", "preempted", "nominations", "cycles", "paths", "metrics"):
        assert gpu[key] == cpu[key], key
    assert all(gpu["placed"].values()) and not gpu["settle_abandoned"]
    assert set(gpu["paths"]) == {"fused"} and gpu["launches"] == gpu["batches"]


@pytest.mark.cuda
def test_sampled_loop_matches_cpu(cuda):
    """A sampled loop (percentageOfNodesToScore 10 on 500 nodes: k = 100)
    on the card against the CPU: every batch on the scan, no kernel launch,
    the same placements and the same final window start."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(nodes=500, init_pods=0, measured=192)
    gpu = workloads.run_loop(w, cuda, percentage=10, batch_size=64)
    cpu = workloads.run_loop(w, "cpu", percentage=10, batch_size=64)
    assert gpu["placed"] == cpu["placed"] and gpu["start"] == cpu["start"] is not None
    assert set(gpu["paths"]) == {"scan"} and gpu["launches"] == 0


def _ring_env(monkeypatch, worker: str) -> None:
    for key in ("KTPU_PIPELINE_DEPTH", "KTPU_SPEC", "KTPU_FULL_BATCH"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)


@pytest.mark.cuda
@pytest.mark.parametrize("worker", ["0", "1"])
def test_ring_matches_cpu_inline_ring(cuda, worker, monkeypatch):
    """The in-flight ring on the card, with the commit worker and inline,
    against the CPU's inline ring (percentage 100): the same placements,
    pods popped and counters; one fused-kernel launch per batch, and later
    batches encoded on the carry."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(nodes=300, init_pods=200, measured=300)
    _ring_env(monkeypatch, worker)
    gpu = workloads.run_loop(w, cuda, batch_size=64)
    _ring_env(monkeypatch, "0")
    cpu = workloads.run_loop(w, "cpu", percentage=100, batch_size=64)
    for key in ("placed", "cycles", "paths", "metrics", "buckets"):
        assert gpu[key] == cpu[key], key
    assert gpu["commit_worker"] == (worker == "1") and gpu["pipeline_depth"] == 2
    assert gpu["launches"] == gpu["batches"] and gpu["carry_batches"] > 0


@pytest.mark.cuda
def test_worker_ring_binds_every_preemptor(cuda, monkeypatch):
    """PreemptionBasic through the ring with the commit worker: every
    preemptor binds, its victims are evicted, nothing is left nominated
    in the queue, and every PostFilter call reads a node list that holds
    every pod the store has bound (the worker's snapshot, refreshed before
    the failure path)."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.preemption_basic(nodes=48, init_pods=192, measured=48)
    _ring_env(monkeypatch, "1")
    gpu = workloads.run_loop(w, cuda, batch_size=64)
    preemptors = [k for k in gpu["placed"] if "/preemptor-" in k or "/warm-" in k]
    assert preemptors and all(gpu["placed"][k] for k in preemptors)
    assert gpu["preempted"] and not gpu["settle_abandoned"]
    assert gpu["commit_worker"] and gpu["launches"] == gpu["batches"]

    store = Store()
    sched = TPUScheduler(store, device=cuda, batch_size=16, batch_deadline_ms=0)
    real, missing = sched.profiles["default-scheduler"].plugin("DefaultPreemption").post_filter, []

    def post_filter(pod, hints=None, unresolvable=(), state=None):
        seen = {p.key() for ni in sched.profiles["default-scheduler"].filters.node_infos_fn() for p in ni.pods}
        missing.append({k for k, p in list(store.pods.items()) if p.spec.node_name} - seen)
        return real(pod, hints, unresolvable, state)

    sched.profiles["default-scheduler"].plugin("DefaultPreemption").post_filter = post_filter
    for ni in w.node_infos():
        store.create_node(ni.node)
    for pods in (w.init_pod_list(), w.measured_pod_list()):
        for pod in pods:
            store.create_pod(pod)
        sched.run_until_settled()
    sched.close()
    assert missing and not any(missing) and sched.carry_batches > 0
    assert all(p.spec.node_name for p in store.pods.values())


@pytest.mark.cuda
@pytest.mark.parametrize("worker", ["0", "1"])
def test_growth_through_the_ring_matches_cpu(cuda, worker, monkeypatch):
    """The anti-affinity, affinity and spread pods of ``topo_cluster_spec``
    on the hostname and zone keys together (the existing pods' terms
    overflow ``ex_terms``), through the ring on the card, with the commit
    worker and inline; two batches in flight when 16 nodes join and the
    node axis outgrows its 128 rows, so the ring drains (through the
    worker) before the mirror is rebuilt. The grown capacities, pods
    popped, counters and placements equal the CPU's inline ring."""
    import dataclasses

    from _torch_cases import (HOST, ZONE, build_topo_nodes, build_topo_pods,
                              topo_cluster_spec, topo_pods_spec, torch_api)
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    def run(device, worker_env):
        _ring_env(monkeypatch, worker_env)
        api, clock = torch_api(), FakeClock()
        store = Store(now_fn=clock)
        # the specs' objects as they are, as on LoopPair's stores
        # (topo_pods_spec sets minDomains on ScheduleAnyway constraints too)
        store.validation_enabled = False
        sched = TPUScheduler(store, device=device, batch_size=16, batch_deadline_ms=0,
                             percentage_of_nodes_to_score=100, now_fn=clock)
        infos = build_topo_nodes(api, topo_cluster_spec(136, 3, keys=(HOST, ZONE)))
        for ni in infos[:120]:
            store.create_node(ni.node)
        for pod in (p for ni in infos[:120] for p in ni.pods):
            store.create_pod(pod)
        for pod in build_topo_pods(api, topo_pods_spec(64, 4, keys=(HOST, ZONE))):
            store.create_pod(pod)
        popped = sched.schedule_batch_cycle() + sched.schedule_batch_cycle()
        assert len(sched._inflight) == 2 and sched.state.caps.nodes == 128
        for ni in infos[120:]:
            store.create_node(ni.node)
        popped += sched.run_until_settled()
        sched.close()
        return {"placed": {k: p.spec.node_name for k, p in store.pods.items()},
                "caps": dataclasses.asdict(sched.state.caps), "popped": popped,
                "metrics": dict(sched.metrics), "worker": sched.commit_worker is not None}

    gpu, cpu = run(cuda, worker), run("cpu", "0")
    assert gpu["worker"] == (worker == "1")
    for key in ("caps", "popped", "metrics", "placed"):
        assert gpu[key] == cpu[key], key
    assert gpu["caps"]["nodes"] == 256 and gpu["caps"]["ex_terms"] > 8
    assert gpu["metrics"]["scheduled"] > 40


@pytest.mark.cuda
def test_ring_dispatch_reads_nothing_to_the_host(cuda, monkeypatch):
    """Every dispatch of a full mode-off batch (the batch program, the
    carry adopted, the packed block's staged copy) runs under
    ``set_sync_debug_mode("error")``: no host read serializes the ring."""
    from kubernetes_tpu_torch.backend import tpu_scheduler
    from kubernetes_tpu_torch.perf import workloads

    real, calls = tpu_scheduler.dispatch_device_batch, []

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            calls.append(1)

    monkeypatch.setattr(tpu_scheduler, "dispatch_device_batch", strict)
    _ring_env(monkeypatch, "0")  # the mode is process-wide: no worker reads meanwhile
    gpu = workloads.run_loop(workloads.scheduling_basic(nodes=300, init_pods=0, measured=256),
                             cuda, batch_size=64)
    assert len(calls) == gpu["batches"] == 4 and set(gpu["paths"]) == {"fused"}


@pytest.mark.cuda
def test_pinned_block_equals_blocking_read(cuda):
    """The packed block read through its pinned, event-fenced copy equals a
    blocking ``.cpu()`` read of the device block."""
    from kubernetes_tpu_torch.backend import batch_scheduler
    from kubernetes_tpu_torch.backend.batch import unpack_result_block
    from kubernetes_tpu_torch.backend.commit_plane import materialize_result
    from kubernetes_tpu_torch.backend.device_state import DeviceState, caps_for_cluster
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(nodes=300, init_pods=0, measured=128)
    state = DeviceState(caps_for_cluster(300), cuda)
    state.sync(Snapshot(w.node_infos()))
    enc = batch_scheduler.encode_device_batch(state, w.measured_pod_list())
    disp = batch_scheduler.dispatch_device_batch(state, enc)
    assert disp.block.is_pinned() and disp.ready is not None
    got = materialize_result(disp, state.caps.nodes)
    want = unpack_result_block(disp.res.packed.cpu(), state.caps.nodes)
    for a, b in zip(got, want):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert (got[0] >= 0).all()


@pytest.mark.cuda
def test_slice_workload_through_the_loop_matches_cpu(cuda, monkeypatch):
    """SchedulingSlices at a small size through the scheduler loop on the
    card against the CPU loop: the same placements, PodGroups and pods
    popped per batch; every slice gang contiguous; every batch mode ``off``
    on the fused kernel, one launch each."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_slices(nodes=32, slots=8, init_gangs=1, measured_small=2,
                                    measured_medium=1, measured_large=0)
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_loop(w, cuda, batch_size=64)
    cpu = workloads.run_loop(w, "cpu", percentage=100, batch_size=64)
    for key in ("placed", "pod_groups", "batch_pods", "gang_rejected", "slice_stats"):
        assert gpu[key] == cpu[key], key
    assert gpu["slice_stats"]["ContiguityViolations"] == 0 and gpu["waiting"] == []
    assert set(gpu["modes"]) == {"off"} and gpu["launches"] == gpu["batches"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cohort", "nogangs"])
def test_soak_through_the_loop_matches_cpu(cuda, variant, monkeypatch):
    """A small SchedulingSoak (60 nodes, 4 rounds, without claim pods)
    through the loop on the card against the CPU loop: the same binds,
    pods popped per batch, ledgers and evictions, zero oversubscription;
    without gangs every batch one fused launch."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_soak(nodes=60, scale=4, rounds=4, claims=False,
                                  cohort="soak" if variant == "cohort" else "",
                                  gangs=variant != "nogangs")
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_loop_soak(w, cuda)
    cpu = workloads.run_loop_soak(w, "cpu", percentage=100)
    for key in ("placed", "bound", "rounds", "batch_pods", "pending", "evicted", "flagged",
                "oversubscription"):
        assert gpu[key] == cpu[key], key
    assert gpu["oversubscription"] == 0 and gpu["waiting"] == []
    if variant == "nogangs":
        assert set(gpu["modes"]) == {"off"} and gpu["launches"] == len(gpu["batch_pods"])
        assert gpu["flagged"] > 0


@pytest.mark.cuda
def test_gang_split_across_batches_with_worker_matches_cpu(cuda, monkeypatch):
    """A gang of six in batches of four through the worker ring on the
    card: the first batch's members wait at Permit, the second allows
    them, and placements, PodGroups and pops equal the CPU's inline ring."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    def run(device, worker):
        _ring_env(monkeypatch, worker)
        clock = FakeClock()
        store = Store(now_fn=clock)
        sched = TPUScheduler(store, device=device, batch_size=4, batch_deadline_ms=0,
                             percentage_of_nodes_to_score=100, now_fn=clock)
        for i in range(10):
            store.create_node(make_node(f"node-{i}").capacity(
                {"cpu": "8", "memory": "16Gi", "pods": 32}).obj())
        store.create_object("PodGroup", PodGroup(meta=ObjectMeta(name="wide"), min_member=6))
        for i in range(6):
            store.create_pod(make_pod(f"wide-{i}").req({"cpu": "500m"}).pod_group("wide").obj())
        sched.run_until_settled()
        sched.close()
        return {"placed": {k: p.spec.node_name for k, p in store.pods.items()},
                "groups": {k: (g.phase, g.scheduled) for k, g in store.pod_groups.items()},
                "pops": list(sched.batch_pods), "waiting": dict(sched.waiting_pods),
                "worker": sched.commit_worker is not None}

    gpu, cpu = run(cuda, "1"), run("cpu", "0")
    assert gpu["worker"] and not cpu["worker"]
    for key in ("placed", "groups", "pops", "waiting"):
        assert gpu[key] == cpu[key], key
    assert all(gpu["placed"].values()) and gpu["groups"] == {"default/wide": ("Running", 6)}
    assert gpu["pops"] == [4, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scheduling_dra", "scheduling_intree_pvs", "scheduling_csi_pvs"])
def test_claims_and_volumes_through_the_loop_match_cpu(cuda, name, monkeypatch):
    """SchedulingDRA, SchedulingInTreePVs and SchedulingCSIPVs at a small
    size through the loop on the card against the CPU loop: the same
    placements, pods popped, PV bindings, claim allocations and sequential
    binds; every batch mode ``off`` with one fused launch each."""
    from kubernetes_tpu_torch.perf import workloads

    w = getattr(workloads, name)(nodes=300, init_pods=200, measured=100)
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_loop(w, cuda)
    cpu = workloads.run_loop(w, "cpu", percentage=100)
    for key in ("placed", "batch_pods", "pv_bindings", "claims", "fallback_scheduled",
                "metrics"):
        assert gpu[key] == cpu[key], key
    assert all(gpu["placed"].values()) and gpu["csi_over"] == [] and gpu["rwop_shared"] == []
    assert set(gpu["modes"]) == {"off"} and gpu["launches"] == gpu["batches"]


@pytest.mark.cuda
@pytest.mark.parametrize("worker", ["0", "1"])
def test_delayed_binding_through_the_loop_matches_cpu(cuda, worker, monkeypatch):
    """The seeded delayed-binding case at a small size on the card (the
    inline ring and the worker ring) against the CPU's inline ring: the
    same placements, PV bindings and counters; every PV bound to one pod
    in its zone."""
    from kubernetes_tpu_torch.perf import workloads

    c = workloads.DelayedBinding(nodes=120, pods=64, pvs=40, extra_pvs=8)
    _ring_env(monkeypatch, worker)
    gpu = workloads.run_delayed_binding(c, cuda)
    _ring_env(monkeypatch, "0")
    cpu = workloads.run_delayed_binding(c, "cpu")
    for key in ("placed", "pv_bindings", "metrics", "fallback_scheduled"):
        assert gpu[key] == cpu[key], key
    assert sum(1 for v in gpu["pv_bindings"].values() if v) == c.pvs + c.extra_pvs
    assert gpu["launches"] == sum(m == "off" for m in gpu["modes"])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "nogangs"])
def test_soak_with_claims_through_the_loop_matches_cpu(cuda, variant, monkeypatch):
    """A small SchedulingSoak with its claim pods (60 nodes, 4 rounds)
    through the loop on the card against the CPU loop: the same binds,
    pods popped, ledgers and claim allocations, zero oversubscription."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_soak(nodes=60, scale=4, rounds=4, gangs=variant != "nogangs")
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_loop_soak(w, cuda)
    cpu = workloads.run_loop_soak(w, "cpu", percentage=100)
    for key in ("placed", "bound", "rounds", "batch_pods", "pending", "claims",
                "fallback_scheduled", "oversubscription"):
        assert gpu[key] == cpu[key], key
    assert gpu["oversubscription"] == 0 and gpu["bound"]["soak-b"] > 0


@pytest.mark.cuda
def test_warm_sweep_matches_plain_version(cuda, monkeypatch):
    """The warm sweep of ``run_loop(warm=True)`` at SchedulingBasic's 5120
    node slots (200 init pods settled first) on the card: every fused
    launch of the sweep, at P = 16, 32, 64 and 128, equal to the plain
    version on the same inputs bit for bit; the launches counted apart
    from the loop's; the mirror's tensors unchanged; the sizer seeded from
    the timed runs; the measured pods placed as the CPU loop places them."""
    from kubernetes_tpu_torch.backend import batch, tpu_scheduler
    from kubernetes_tpu_torch.perf import workloads

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    inner, warm, pods = batch.fused_step_batch, tpu_scheduler.TPUScheduler.warm_buckets, []

    def checked(*args):
        out = inner(*args)
        ref = fused_step.fused_step_batch_ref(*args)
        for name, got, want in zip(out._fields, out, ref):
            assert torch.equal(bits(got), bits(want)), name
        pods.append(args[4].shape[0])
        return out

    def sweep(sched, *args, **kw):
        monkeypatch.setattr(batch, "fused_step_batch", checked)
        try:
            return warm(sched, *args, **kw)
        finally:
            monkeypatch.setattr(batch, "fused_step_batch", inner)

    _ring_env(monkeypatch, "0")
    monkeypatch.setattr(tpu_scheduler.TPUScheduler, "warm_buckets", sweep)
    w = workloads.scheduling_basic(5000, 200, 200)
    run = workloads.run_loop(w, cuda, batch_deadline_ms=500, warm=True)
    assert sorted(set(pods)) == [16, 32, 64, 128] and len(pods) == run["warm_launches"]
    assert run["mirror_unchanged"] and len(run["warm_timings"]) == 4
    assert run["warm_sizer"]["b"] > 0 and run["warmed"] >= 8
    cpu = workloads.run_loop(w, "cpu", percentage=100)
    assert run["placed"] == cpu["placed"]


@pytest.mark.cuda
def test_relay_death_through_the_loop_matches_cpu(cuda, monkeypatch):
    """The relay death (``workloads.run_relay_death``) at 100 nodes and 256
    measured pods through the loop on the card against the CPU loop: the
    same steps and placements; pods degraded while the breaker is open,
    and meanwhile no batch, no fused launch and no mirror on the card; the
    probe batch launches the kernel and closes the breaker."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(100, 50, 256)
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_relay_death(w, cuda, percentage=100)
    cpu = workloads.run_relay_death(w, "cpu", percentage=100)
    strip = [[{k: v for k, v in st.items() if k != "launches"} for st in run["steps"]]
             for run in (gpu, cpu)]
    assert strip[0] == strip[1] and gpu["placed"] == cpu["placed"]
    assert gpu["degraded_s"] == cpu["degraded_s"] and gpu["faults"] == cpu["faults"]
    opened = [st for st in gpu["steps"] if st["state"] == "open"]
    assert len(opened) == 3 and gpu["relay_degraded_pods"] == 192
    assert len({(st["batches"], st["launches"]) for st in opened}) == 1
    assert not any(st["mirror"] for st in opened)
    assert gpu["steps"][-1]["state"] == "closed"
    assert gpu["steps"][-1]["launches"] > opened[-1]["launches"]


@pytest.mark.cuda
def test_flap_soak_through_the_loop_matches_cpu(cuda, monkeypatch):
    """A small SchedulingSoak without gangs (32 nodes, 4 rounds, scale 6)
    with the device flap and the comparer every second landed winner
    through the loop on the card against the CPU loop: the same binds,
    pops, degraded pods, sequential binds, breaker state per cycle and
    degraded seconds; three flap batches, no comparer mismatch, the breaker
    closed at the end."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_soak(nodes=32, rounds=4, scale=6, gangs=False)
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_loop_soak(w, cuda, comparer_every_n=2)
    cpu = workloads.run_loop_soak(w, "cpu", percentage=100, comparer_every_n=2)
    for key in ("placed", "bound", "batch_pods", "flap_batches", "relay_degraded_pods",
                "fallback_scheduled", "breaker", "degraded_s", "comparer_checks",
                "comparer_mismatches", "oversubscription"):
        assert gpu[key] == cpu[key], key
    assert gpu["flap_batches"] == 3 and gpu["relay_opens"] == 1 and gpu["breaker_state"] == 0
    assert gpu["comparer_checks"] > 0 and gpu["comparer_mismatches"] == 0
    assert gpu["launches"] == len(gpu["batch_pods"])


@pytest.mark.cuda
def test_profiles_through_the_loop_match_cpu(cuda, monkeypatch):
    """The loop built from a KubeSchedulerConfiguration on the card against
    the CPU loop of the same config, at a small size: two batchable
    profiles share the fused kernel's batches (one launch per batch, no
    sequential bind); the MostAllocated and no-scoring profiles' pods take
    the sequential path, the rest the kernel; PreemptionBasic with
    PriorityClasses equals its numeric-priority run."""
    from kubernetes_tpu_torch.perf import workloads

    _ring_env(monkeypatch, "0")
    names = ("default-scheduler", "batch-b")
    w = workloads.with_scheduler_names(workloads.scheduling_basic(300, 100, 128), names)
    config = workloads.profiles_config(*names)
    gpu = workloads.run_loop(w, cuda, config=config)
    cpu = workloads.run_loop(w, "cpu", percentage=100, config=config)
    assert gpu["placed"] == cpu["placed"] and all(gpu["placed"].values())
    assert set(gpu["paths"]) == {"fused"} and gpu["launches"] == gpu["batches"]
    assert gpu["fallback_scheduled"] == 0
    assert gpu["scheduled_by_profile"] == {"default-scheduler": 64, "batch-b": 64}

    names = ("default-scheduler", "most-allocated", "default-scheduler", "no-scoring")
    w = workloads.with_scheduler_names(workloads.scheduling_basic(200, 60, 64), names)
    config = workloads.profiles_config("default-scheduler", "most-allocated", "no-scoring")
    gpu = workloads.run_loop(w, cuda, percentage=100, config=config)
    cpu = workloads.run_loop(w, "cpu", percentage=100, config=config)
    for key in ("placed", "cycles", "fallback_scheduled", "batch_pods"):
        assert gpu[key] == cpu[key], key
    assert gpu["fallback_scheduled"] == 32 and gpu["launches"] == gpu["batches"]

    runs = [workloads.run_loop(workloads.preemption_basic(24, 96, 24, classes=classes), dev,
                               percentage=100)
            for classes, dev in ((True, cuda), (True, "cpu"), (False, cuda))]
    for key in ("placed", "preempted", "nominations", "cycles", "metrics"):
        assert runs[0][key] == runs[1][key] == runs[2][key], key
    assert runs[0]["preempted"] and all(
        node for key, node in runs[0]["placed"].items() if "/preemptor-" in key)


@pytest.mark.cuda
def test_admission_through_the_loop_matches_cpu(cuda, monkeypatch):
    """SchedulingBasic/5000Nodes with the admission chain doing the work
    (``workloads.admission_basic``) on the card against the CPU loop:
    placements, refusals per plugin and counters equal; no pod on a node
    created not Ready, team-a's pods on pool=b, team-b's requests from the
    LimitRange, team-c's overhead from its RuntimeClass and its creates past
    the quota of 200 pods refused."""
    from kubernetes_tpu_torch.perf import workloads

    _ring_env(monkeypatch, "0")
    w = workloads.admission_basic(5000, 1000, 1000)
    gpu = workloads.run_loop(w, cuda)
    cpu = workloads.run_loop(w, "cpu", percentage=100)
    for key in ("placed", "refused", "refused_pods", "metrics", "cycles", "quota_used"):
        assert gpu[key] == cpu[key], key
    assert gpu["refused"] == {"ResourceQuota": 50}
    assert all(gpu["placed"].values()) and len(gpu["placed"]) == 1950
    assert set(gpu["paths"]) == {"fused"} and gpu["launches"] == gpu["batches"]
    assert workloads.admission_violations(w, gpu) == []


@pytest.mark.cuda
def test_extenders_through_the_loop_match_cpu(cuda, monkeypatch):
    """SchedulingBasic/1000Nodes/Extender with a quarter of the measured
    pods on ``no-scoring`` and an in-process ``LoopExtender``, on the card
    against the CPU loop: placements and calls per verb equal, no
    sequential pod on a node the Filter drops, every pod bound through the
    extender; PreemptionBasic with a preempt-capable one: victims and
    nominations equal."""
    from kubernetes_tpu_torch.perf import workloads

    _ring_env(monkeypatch, "0")
    names = ("default-scheduler",) * 3 + ("no-scoring",)
    w = workloads.extender_basic(1000, 500, 256, names)
    config = workloads.profiles_config("default-scheduler", "no-scoring")
    runs, made = [], []
    for dev in (cuda, "cpu"):
        def exts(store, _made=made):
            _made.append(workloads.LoopExtender(w.nodes, store.bind))
            return _made[-1:]
        runs.append(workloads.run_loop(w, dev, percentage=100, config=config, extenders=exts))
    gpu, cpu = runs
    for key in ("placed", "cycles", "fallback_scheduled", "batch_pods", "metrics"):
        assert gpu[key] == cpu[key], key
    assert made[0].calls == made[1].calls
    assert made[0].calls["bind"] == len(gpu["placed"]) == 756 and all(gpu["placed"].values())
    sequential = [k for i, k in enumerate(p.key() for p in w.measured_pod_list())
                  if names[i % 4] == "no-scoring"]
    assert not any(workloads.filtered_by_extender(gpu["placed"][k]) for k in sequential)

    pre = workloads.preemption_basic(24, 96, 24)
    runs, made = [], []
    for dev in (cuda, "cpu"):
        def exts(store, _made=made):
            _made.append(workloads.LoopExtender(pre.nodes, None, preempt=True))
            return _made[-1:]
        runs.append(workloads.run_loop(pre, dev, percentage=100, extenders=exts))
    for key in ("placed", "preempted", "nominations", "cycles", "metrics"):
        assert runs[0][key] == runs[1][key], key
    assert made[0].calls == made[1].calls and made[0].calls["preempt"] > 0


# ---------------------------------------------------------------- telemetry


@pytest.fixture
def recorders_off():
    yield
    from kubernetes_tpu_torch.backend import telemetry
    from kubernetes_tpu_torch.metrics import latency_ledger
    from kubernetes_tpu_torch.utils import tracing

    for m in (telemetry, latency_ledger, tracing):
        m.disable()


@pytest.mark.cuda
def test_profiled_read_times_the_batch_program(cuda, recorders_off):
    """One dispatched batch read through ``materialize_profiled`` with
    telemetry on: the events bracket the batch program (``deviceExecS`` >
    0), the fetch counts the packed block's bytes, and the read equals
    ``materialize_result``'s."""
    from kubernetes_tpu_torch.backend import batch_scheduler, telemetry
    from kubernetes_tpu_torch.backend.commit_plane import materialize_profiled
    from kubernetes_tpu_torch.backend.device_state import DeviceState, caps_for_cluster
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(nodes=300, init_pods=0, measured=128)

    def dispatched():
        state = DeviceState(caps_for_cluster(300), cuda)
        state.sync(Snapshot(w.node_infos()))
        enc = batch_scheduler.encode_device_batch(state, w.measured_pod_list())
        return state, batch_scheduler.dispatch_device_batch(state, enc)

    rec = telemetry.enable()
    state, disp = dispatched()
    assert disp.exec_events is not None
    read, record = materialize_profiled(disp, state.caps.nodes, program="schedule_batch",
                                        bucket="128/off", batch_id="b1", pods=128)
    assert record["deviceExecS"] > 0
    assert record["fetchBytes"] == disp.block.numel() * disp.block.element_size()
    assert rec.transfer_bytes["fetch"] == record["fetchBytes"]
    assert sum(record["window"].values()) == pytest.approx(record["waitS"], abs=1e-12)
    telemetry.disable()
    state, disp = dispatched()  # the same batch on a fresh mirror, telemetry off
    assert disp.exec_events is None
    want, none = materialize_profiled(disp, state.caps.nodes, program="schedule_batch")
    assert none is None
    for a, b in zip(read, want):
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.cuda
def test_observed_loop_on_the_card(cuda, recorders_off, monkeypatch):
    """SchedulingBasic at 500 nodes through the synchronous loop with the
    recorders on: the dispatch count equals the fused launches; each
    batch's ``deviceExecS`` is positive and within its cycle's host time
    (synchronous: the cycle encodes, dispatches and reads its batch); the
    memory sample has its three keys; every fetch is the packed block's
    bytes; the placements equal the same run with the recorders off."""
    from kubernetes_tpu_torch.perf import workloads

    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    w = workloads.scheduling_basic(nodes=500, init_pods=256, measured=512)
    run = workloads.run_loop(w, "cuda", observe=True)
    off = workloads.run_loop(w, "cuda")
    assert run["placed"] == off["placed"] and run["cycles"] == off["cycles"]
    o = run["observed"]
    count = sum(v["count"] for k, v in o["programs"].items() if k.startswith("schedule_batch@"))
    assert count == o["launches"] == run["launches"] == run["batches"]
    # synchronous: the newest records are the measured cycles' batches
    measured = [r["deviceExecS"] for r in o["records"]][-len(run["measured_batch_ms"]):]
    assert all(0 < t * 1e3 <= ms for t, ms in zip(measured, run["measured_batch_ms"]))
    assert {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} <= set(o["hbm"])
    words = 1 + -(-run["caps"]["nodes"] // 4)  # node_idx, then first_fail as int32 words
    for r in o["records"]:
        assert r["fetchBytes"] == 4 * int(r["bucket"].split("/")[0]) * words
    assert o["retraces"] == 0 and o["e2e_rel_err"] <= 1e-9


@pytest.mark.cuda
def test_ledger_on_the_card_equals_the_cpu(cuda, recorders_off, monkeypatch):
    """The same store through the loop on the card and on the CPU (full
    batches), each ledger on its own FakeClock stepped between settles:
    every entry equal (result, segments, their order, e2e)."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.metrics import latency_ledger
    from kubernetes_tpu_torch.utils.clock import FakeClock

    from _torch_cases import (build_nodes, build_pods, cluster_spec, ledger_view, pods_spec,
                              torch_api)

    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "2")
    views = []
    for device in ("cuda", "cpu"):
        clock = FakeClock()
        store = Store(now_fn=clock)
        sched = TPUScheduler(store, device=device, now_fn=clock, batch_size=16,
                             batch_deadline_ms=0, percentage_of_nodes_to_score=100)
        led = latency_ledger.enable(sched.smetrics, now_fn=clock, keep_closed=1 << 16)
        spec = cluster_spec(12, 0)
        for ni in build_nodes(torch_api(), spec):
            store.create_node(ni.node)
            for p in ni.pods:
                store.create_pod(p)
        for p in build_pods(torch_api(), pods_spec(150, 1)):
            store.create_pod(p)
        sched.run_until_settled()
        clock.advance(11.0)
        sched.queue.flush_backoff_completed()
        sched.run_until_settled()
        sched.close()
        views.append(ledger_view(led))
        latency_ledger.disable()
    assert views[0] == views[1] and len(views[0]) == 150


# ------------------------------------------------------------------ drain and rebalance


@pytest.mark.cuda
def test_packing_entropy_on_the_card_matches_cpu(cuda):
    """``packing_entropy`` on the card against its plain version on the
    CPU, on seeded [N, 6] rows up to N = 5120: within 1e-6."""
    from kubernetes_tpu_torch.controllers.rebalance import packing_entropy

    rng = np.random.RandomState(7)
    for n in (24, 512, 5120):
        req = (rng.randint(0, 40, size=(n, 6)) * rng.choice([1, 100, 512, 4000], 6))
        req = np.where(rng.uniform(size=(n, 6)) < 0.5, 0, req).astype(np.float32)
        valid = rng.uniform(size=n) < 0.9
        cm, cp = packing_entropy(torch.from_numpy(req), torch.from_numpy(valid))
        gm, gp = packing_entropy(torch.from_numpy(req).to(cuda), torch.from_numpy(valid).to(cuda))
        assert abs(float(gm) - float(cm)) <= 1e-6
        assert np.allclose(gp.cpu().numpy(), cp.numpy(), atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_replay_through_the_loop_matches_cpu(cuda, monkeypatch):
    """A small SchedulingReplay (24 nodes, 6 rounds, scale 4) with the
    rebalancer on, through the loop on the card against the CPU loop: the
    same placements, invariants and waves (victims included)."""
    from kubernetes_tpu_torch.perf import workloads

    knobs = {"cooldown_s": 1.0, "score_interval_s": 0.25, "entropy_high": 0.80,
             "entropy_low": 0.60, "max_migrations_per_wave": 8}
    w = workloads.scheduling_replay(nodes=24, rounds=6, scale=4, rebalance=knobs)
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_loop_replay(w, cuda, percentage=100)
    cpu = workloads.run_loop_replay(w, "cpu", percentage=100)
    for key in ("placed", "invariants", "tenants", "cycles", "evicted"):
        assert gpu[key] == cpu[key], key
    strip = lambda waves: [{k: v for k, v in wv.items() if k != "entropy"} for wv in waves]  # noqa: E731
    assert strip(gpu["waves"]) == strip(cpu["waves"]) and gpu["invariants"]["Waves"] > 0


@pytest.mark.cuda
def test_elastic_through_the_loop_matches_cpu(cuda, monkeypatch):
    """A small SchedulingElastic (24 nodes, 6 rounds) through the loop on
    the card against the CPU loop: the same placements, invariants,
    evictions and nodes; no pod lost, slots reused, no steady upload."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_elastic(nodes=24, rounds=6, pods_per_round=12, drain_nodes=3,
                                     cycles_per_round=40)
    _ring_env(monkeypatch, "0")
    gpu = workloads.run_loop_elastic(w, cuda, percentage=100)
    cpu = workloads.run_loop_elastic(w, "cpu", percentage=100)
    for key in ("placed", "invariants", "evicted", "nodes", "cycles"):
        assert gpu[key] == cpu[key], key
    inv = gpu["invariants"]
    assert inv["LostPods"] == 0 and inv["SlotReuses"] > 0 and inv["UploadBytesSteady"] == 0


@pytest.mark.cuda
def test_drain_wave_through_the_loop_matches_cpu(cuda, monkeypatch):
    """A gang of 3 and a solo pod on 4 nodes through the loop on the card
    and on the CPU; the gang's first member's node drained: the gang is
    evicted whole and binds again whole, the stores equal."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.controllers.drain import DrainOrchestrator
    from kubernetes_tpu_torch.utils.clock import FakeClock

    _ring_env(monkeypatch, "0")
    views = []
    for device in (cuda, "cpu"):
        clock = FakeClock()
        store = Store(now_fn=clock)
        sched = TPUScheduler(store, device=device, now_fn=clock, batch_size=16,
                             batch_deadline_ms=0, percentage_of_nodes_to_score=100)
        for i in range(4):
            store.create_node(make_node(f"n{i}").capacity(
                {"cpu": "2", "memory": "16Gi", "pods": 20}).obj())
        store.create_object("PodGroup", PodGroup(meta=ObjectMeta(name="g"), min_member=3,
                                                 schedule_timeout_seconds=30))
        for i in range(3):
            store.create_pod(make_pod(f"g-{i}").req({"cpu": "1"}).pod_group("g").obj())
        store.create_pod(make_pod("solo").req({"cpu": "1"}).obj())
        sched.run_until_settled()
        drain = DrainOrchestrator(store, metrics=sched.smetrics, queue=sched.queue, now_fn=clock)
        victim = store.get_pod("default/g-0").spec.node_name
        summary = drain.drain_wave([victim])
        drain.uncordon(victim)
        clock.advance(11.0)
        sched.queue.flush_backoff_completed()
        sched.run_until_settled()
        sched.close()
        views.append((summary, {k: p.spec.node_name for k, p in store.pods.items()}))
    assert views[0] == views[1]
    assert views[0][0]["gangs"] == 1 and all(views[0][1].values())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 3])
def test_wire_loop_on_card_matches_cpu_service(cuda, depth):
    """SchedulingBasic at 300 nodes through ``WireScheduler`` and
    ``serve(DeviceService(device="cuda"))`` on 127.0.0.1 against the same
    run on a CPU service at percentage 100: every pod bound, the same pods
    per batch, counters and queue, and at depth 0 the same placements (at
    depth 3 the service runs the batches in flight in lock order, C26),
    one fused launch per full mode-off batch, nothing replayed or
    resynced, the card's deviceTime echoed."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(300, 200, 300)
    gpu = workloads.run_loop_wire(w, cuda, depth)
    cpu = workloads.run_loop_wire(w, "cpu", depth, percentage=100)
    keys = ("placed", "batch_pods", "metrics", "pending") if depth == 0 else (
        "batch_pods", "metrics", "pending")
    for key in keys:
        assert gpu[key] == cpu[key], key
    assert len(gpu["placed"]) == 500 and all(gpu["placed"].values())
    assert gpu["placements"] == gpu["binds"] == 500 and not gpu["over_capacity"]
    assert gpu["paths"] == ["fused"] * gpu["batches"]
    assert gpu["launches"] == gpu["batches"] == gpu["client_batches"]
    assert gpu["replays"] == gpu["resyncs"] == 0
    assert gpu["device_time_ms"]["deviceExecMs"] > 0


@pytest.mark.cuda
def test_wire_preemption_on_card_matches_cpu_service(cuda):
    """A small PreemptionBasic through the wire: hints from the screen on
    the card, nominations equal to the CPU service's run."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.preemption_basic(nodes=48, init_pods=192, measured=48)
    gpu = workloads.run_loop_wire(w, cuda, 0)
    cpu = workloads.run_loop_wire(w, "cpu", 0, percentage=100)
    for key in ("placed", "nominations", "metrics", "batch_pods"):
        assert gpu[key] == cpu[key], key
    assert gpu["nominations"]


@pytest.mark.cuda
def test_wire_restart_and_replicas_on_card(cuda):
    """A service restart mid-run: one full resync, no batch run twice,
    placements equal to the CPU service's run with the same restart; two
    replicas on one card service: one placement and one bind per pod, none
    of a bound pod, no node over capacity, conflicts counted."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(300, 200, 300)
    gpu = workloads.run_loop_wire(w, cuda, 0, restart_after=3)
    cpu = workloads.run_loop_wire(w, "cpu", 0, percentage=100, restart_after=3)
    assert gpu["placed"] == cpu["placed"]
    assert gpu["resyncs"] == gpu["restarts"] == 1
    assert gpu["launches"] == gpu["batches"] == gpu["client_batches"]
    two = workloads.run_loop_wire(w, cuda, 3, replicas=2)
    assert all(two["placed"].values()) and not two["double_binds"] and not two["over_capacity"]
    assert two["placements"] == two["binds"] == len(two["placed"])
    assert two["conflicts"] == two["service_conflicts"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_fabric_failover_on_card_matches_cpu(cuda, warm):
    """Two card services behind the device fabric, the primary killed after
    two batches: one transient failover to the standby, every pod bound
    once, launches == the batches the replicas ran, none run twice, and the
    placements of the same script on two CPU services; a warm standby's
    promote uploads fewer row bytes than a cold one's."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(300, 200, 300)
    kw = dict(fabric_replicas=2, kill_primary_after=2, standby_replication=warm)
    gpu = workloads.run_loop_wire(w, cuda, 0, **kw)
    cpu = workloads.run_loop_wire(w, "cpu", 0, percentage=100, **kw)
    for key in ("placed", "batch_pods", "metrics", "pending"):
        assert gpu[key] == cpu[key], key
    assert gpu["failovers"] == {"transient": 1} and gpu["active"] == 1
    assert gpu["placements"] == gpu["binds"] == 500 and not gpu["double_binds"]
    assert not gpu["over_capacity"] and gpu["replays"] == 0
    assert gpu["launches"] == gpu["batches"] == sum(r["launches"] for r in gpu["per_replica"])
    assert [r["batches"] for r in gpu["per_replica"]] == [r["launches"]
                                                          for r in gpu["per_replica"]]
    if warm:
        cold = workloads.run_loop_wire(w, cuda, 0, fabric_replicas=2, kill_primary_after=2)
        assert 0 < gpu["promote_bytes"] < cold["promote_bytes"]
        assert gpu["replication_bytes"]["full"] > 0


@pytest.mark.cuda
def test_grpc_on_card_matches_http(cuda):
    """SchedulingBasic over gRPC against ``serve_grpc(DeviceService(device=
    "cuda"))``: the placements, counters and queue of the HTTP run, one
    fused launch per batch."""
    import importlib.util

    if importlib.util.find_spec("grpc") is None or importlib.util.find_spec(
            "google.protobuf") is None:
        pytest.skip("grpc or protobuf is not installed")
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(300, 200, 300)
    grpc_run = workloads.run_loop_wire(w, cuda, 0, transport="grpc")
    http_run = workloads.run_loop_wire(w, cuda, 0)
    for key in ("placed", "batch_pods", "metrics", "pending"):
        assert grpc_run[key] == http_run[key], key
    assert grpc_run["launches"] == grpc_run["batches"] == grpc_run["client_batches"]


def _sharded_basic_batch():
    """The first SchedulingBasic/5000Nodes batch (N=5120, P=128), encoded on
    the host by the main path's DeviceState."""
    from kubernetes_tpu_torch.backend.batch_scheduler import encode_device_batch
    from kubernetes_tpu_torch.backend.device_state import DeviceState, caps_for_cluster
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.perf import workloads

    ds = DeviceState(caps_for_cluster(5000), "cpu")
    ds.sync(Snapshot(workloads.scheduling_basic_nodes(5000)))
    enc = encode_device_batch(ds, workloads.scheduling_basic_pods("init", 128))
    assert enc.mode == "off"
    return ds.nt, enc.pb, enc.et, ds.tc, enc.tb


@pytest.mark.cuda
def test_sharded_scan_one_nccl_rank_equals_fused_kernel(cuda):
    from kubernetes_tpu_torch.backend import batch
    from kubernetes_tpu_torch.parallel import launch

    nt, pb, et, tc, tb = _sharded_basic_batch()
    on = [type(x).from_numpy(x.to_numpy(), cuda) for x in (pb, et, nt)]
    before = fused_step.LAUNCHES
    want = launch.result_to_numpy(batch.schedule_batch_core(*on, batch.DEFAULT_WEIGHTS))
    assert fused_step.LAUNCHES == before + 1
    case = launch.case_fields(pb, et, nt, tc, tb, topo_enabled=False)
    rec = launch.run_ranks(launch.schedule_cases, 1, device="cuda", args=([case],),
                           timeout_s=300)[0][0]
    assert launch.result_diff(rec["result"], want) == []
    assert rec["collectives"] > 0 and rec["fused_launches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["off", "host"])
def test_two_gloo_ranks_on_card_equal_cpu(cuda, mode):
    """Two gloo ranks sharing the card against two on the CPU, the scan and
    the rounds, at 32 nodes and 16 pods."""
    from _torch_cases import sharding_case
    from kubernetes_tpu_torch.parallel import launch

    _enc, nt, pb, et, tc, tb, kw = sharding_case(
        "port", "off_rounds" if mode == "off" else "host_rounds")
    kw = dict(kw, spec_decode=False)
    cases = [launch.case_fields(pb, et, nt, tc, tb, **kw),
             launch.case_fields(pb, et, nt, tc, tb, **dict(kw, spec_decode=True))]
    gpu = launch.run_ranks(launch.schedule_cases, 2, device="cuda", args=(cases,),
                           timeout_s=300)[0]
    cpu = launch.run_ranks(launch.schedule_cases, 2, device="cpu", args=(cases,),
                           timeout_s=300)[0]
    for g, c in zip(gpu, cpu):
        assert launch.result_diff(g["result"], c["result"]) == []
        assert (g["collectives"], g["collective_bytes"]) == (c["collectives"],
                                                             c["collective_bytes"])
    assert (gpu[0]["result"]["node_idx"] == gpu[1]["result"]["node_idx"]).all()



@pytest.mark.cuda
@pytest.mark.parametrize("case", ["SchedulingBasic", "SchedulingDRA"])
def test_harness_on_card_matches_cpu(cuda, monkeypatch, case):
    """The scheduler_perf harness (``perf/harness.py``, backend ``tpu``) at
    64 nodes on the card and on the CPU in one process: every pod bound,
    the placements and the DataItems' names, labels, units and Counts
    equal, and the fused kernel launched once per batch on the card (the
    warm sweep's launches apart)."""
    from kubernetes_tpu_torch.perf import cases, harness

    monkeypatch.setenv("KTPU_BATCH_DEADLINE_MS", "0")
    monkeypatch.setenv("KTPU_FULL_BATCH", "1")
    runs = {}
    for device in ("cuda", "cpu"):
        tc = cases.TEST_CASES[case](nodes=64, init_pods=40, measured=60)
        before = fused_step.LAUNCHES
        r = harness.Runner(backend="tpu", device=device, batch_size=16)
        try:
            r.run_ops(tc["ops"])
        finally:
            r.close()
        runs[device] = (r, fused_step.LAUNCHES - before)
    (gpu, launches), (cpu, cpu_launches) = runs["cuda"], runs["cpu"]
    placed = {k: p.spec.node_name for k, p in gpu.store.pods.items()}
    assert len(placed) == 100 and all(placed.values())
    assert placed == {k: p.spec.node_name for k, p in cpu.store.pods.items()}
    assert [(it.unit, it.labels, it.data.get("Count")) for it in gpu.data_items] == [
        (it.unit, it.labels, it.data.get("Count")) for it in cpu.data_items]
    sched = gpu.scheduler
    assert cpu_launches == 0 and set(sched.batch_paths) == {"fused"}
    assert launches - sched.warm_launches == len(sched.batch_paths) > 0


@pytest.mark.cuda
def test_control_plane_on_card_matches_cpu(cuda, monkeypatch):
    """The controller manager and the loop taking turns
    (``perf/control_plane.py``) at 64 nodes on the card and on the CPU in
    one process: every step's placements, PDB statuses, taints, evictions,
    objects per kind, reconciles and pods popped equal; every pod bound and
    none on a tainted node; the fused kernel launched once per fused batch
    on the card, never on the CPU; PreemptionBasic's cluster with a guarded
    ReplicaSet evicts no guarded victim."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.controllers import ControllerManager
    from kubernetes_tpu_torch.perf import control_plane as cp
    from kubernetes_tpu_torch.utils.clock import FakeClock

    monkeypatch.setenv("KTPU_BATCH_DEADLINE_MS", "0")
    monkeypatch.setenv("KTPU_FULL_BATCH", "1")

    def side(device):
        clock = FakeClock()
        store = Store(now_fn=clock)
        sched = TPUScheduler(store, device=device, now_fn=clock, batch_size=16,
                             batch_deadline_ms=0)
        return store, clock, sched, ControllerManager(store, now_fn=clock,
                                                      metrics=sched.smetrics)

    runs = {}
    for device in ("cuda", "cpu"):
        before = fused_step.LAUNCHES
        store, clock, sched, m = side(device)
        nodes = cp.add_nodes(cp.port_api(), store, clock, 64, cp.NODE_CAPACITY)
        steps = cp.run_control_plane(store, m, sched, clock, nodes=nodes, replicas=100,
                                     stateful=4, job=8, lost=4, scale_to=(150, 60))
        bstore, bclock, bsched, bm = side(device)
        steps["budgets"] = cp.run_preemption_budgets(bstore, bm, bsched, bclock, nodes=16,
                                                     victims=64, preemptors=16)
        paths = sched.batch_paths + bsched.batch_paths
        warm = sched.warm_launches + bsched.warm_launches
        runs[device] = ({n: {k: v for k, v in r.items() if k != "seconds"}
                         for n, r in steps.items()},
                        fused_step.LAUNCHES - before - warm, paths)
    (gpu, launches, paths), (cpu, cpu_launches, _) = runs["cuda"], runs["cpu"]
    assert gpu == cpu
    for name, rec in gpu.items():
        if name != "budgets":
            tainted = {n for n, v in rec["taints"].items() if v[0]}
            assert all(rec["placed"].values()) and not [
                n for n in rec["placed"].values() if n in tainted], name
    assert gpu["node_loss"]["evicted"] > 0
    assert gpu["budgets"]["guarded_evicted"] == 0 and gpu["budgets"]["preemptors_bound"] == 16
    assert cpu_launches == 0 and launches == sum(p == "fused" for p in paths) > 0


@pytest.mark.cuda
def test_loop_apiserver_on_card_matches_cpu(cuda, monkeypatch):
    """The loop behind the API front (``perf/apiserver.py``): SchedulingBasic
    at 64 nodes POSTed over HTTP to a durable, authenticated front, Run A
    and the crash-and-restore Run B, on the card and on the CPU: every check
    of ``check_apiserver_run`` holds, placements equal, one fused launch per
    fused batch on the card, none on the CPU."""
    from kubernetes_tpu_torch.perf import workloads
    from kubernetes_tpu_torch.perf.apiserver import check_apiserver_run, run_loop_apiserver

    monkeypatch.setenv("KTPU_BATCH_DEADLINE_MS", "0")
    w = workloads.scheduling_basic(64, 40, 40)
    for crash in (False, True):
        runs = {d: run_loop_apiserver(w, d, crash=crash, batch_size=16) for d in ("cuda", "cpu")}
        for d, run in runs.items():
            assert check_apiserver_run(f"{d} crash={crash}", w, run, crash) == []
        assert runs["cuda"]["placed"] == runs["cpu"]["placed"]
        assert runs["cpu"]["launches"] == 0
        assert runs["cuda"]["launches"] == sum(p == "fused" for p in runs["cuda"]["paths"]) > 0
