"""The CUDA fused-step kernel against its plain PyTorch version (masked,
nominated and slice-masked batches among them), and the topology scan, the
speculative rounds, the claim mask, the preemption screen, the quota
screen, the slice planner, the gang assigner and the claim, volume,
preemption, gang, quota and PreemptionAll workloads against their CPU runs,
on the card.

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
    real, missing = sched.profile.preemption.post_filter, []

    def post_filter(pod, hints=None, unresolvable=()):
        seen = {p.key() for ni in sched.profile.filters.node_infos_fn() for p in ni.pods}
        missing.append({k for k, p in list(store.pods.items()) if p.spec.node_name} - seen)
        return real(pod, hints, unresolvable)

    sched.profile.preemption.post_filter = post_filter
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
