"""The port's slice (torus) path on the CPU against the JAX package, exactly:

* ``_row_runs`` and ``plan_slices`` over seeded tori (1-4 superpods, 4-16
  slots, blocked and unschedulable cells, gangs of 1 to slots + 1 hosts,
  zero requests, duplicate coordinates), against the JAX planner and its
  host oracle ``slice_assign_host``;
* ``_slice_plan`` (the per-pod mask and words) on an encoded batch;
* the static phase's first-fail order with the volume, claim and slice
  masks together, and the packed block with its slice column, byte for
  byte;
* ``fragmentation_host``;
* ``BatchScheduler`` on a small SchedulingSlices (the fused kernel's plain
  version and the rounds) against the JAX batched loop, and a slice gang
  wider than a superpod rejected whole.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (jax_api, jax_coscheduling, jax_encoded, jax_gang_loop, numpy_fields,
                          pod_group_status, run_gang_workload_both, SnapshotShim, torch_api)
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu.ops import slice as jslice
from kubernetes_tpu_torch import interop
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.ops import slice as tslice

# ------------------------------------------------------------------ the planner


def _torus(seed: int):
    """A seeded torus: (superpods, slots, node fields, per-pod requests,
    member index, member valid). Some nodes share coordinates, some have
    none or lie off the grid, some are invalid or unschedulable; requests
    include zeros and gangs reach slots + 1 members."""
    rng = np.random.RandomState(seed)
    s_pods, ps = int(rng.randint(1, 5)), int(rng.randint(4, 17))
    cells = s_pods * ps
    n = int(rng.randint(cells, 2 * cells))
    chosen = rng.randint(0, cells, size=n)            # duplicates on purpose
    topo_sp = (chosen // ps).astype(np.int32)
    topo_pos = (chosen % ps).astype(np.int32)
    off = rng.uniform(size=n) < 0.05
    topo_sp[off] = rng.choice([-1, s_pods, 0], size=off.sum())
    topo_pos[off] = np.where(topo_sp[off] == 0, ps + 1, topo_pos[off])
    r = 3
    alloc = rng.randint(4, 11, size=(n, r)).astype(np.int32)
    requested = (alloc * rng.uniform(0, 0.6, size=(n, r)) ** 2).astype(np.int32)
    nodes = {"valid": rng.uniform(size=n) > 0.05, "unschedulable": rng.uniform(size=n) < 0.05,
             "allocatable": alloc, "requested": requested, "topo_sp": topo_sp,
             "topo_pos": topo_pos}
    g = int(rng.randint(1, 6))
    wants = [int(rng.choice([0, 1, 2, 3, ps // 2, ps, ps + 1])) for _ in range(g)]
    p = max(1, sum(wants)) + 2
    req = rng.randint(0, 4, size=(p, r)).astype(np.int32)
    req[rng.uniform(size=(p, r)) < 0.3] = 0
    m_cap = max(2, max(wants))
    member_idx = np.full((g, m_cap), -1, np.int32)
    rows = rng.permutation(p)
    nxt = 0
    for gi, k in enumerate(wants):
        member_idx[gi, :k] = rows[nxt:nxt + k]
        nxt += k
    return (s_pods, ps), nodes, req, member_idx, member_idx >= 0


def _jax_nt(nodes):
    return types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in nodes.items()})


def _torch_nt(nodes):
    return types.SimpleNamespace(**{k: torch.from_numpy(np.ascontiguousarray(v))
                                    for k, v in nodes.items()})


@pytest.mark.parametrize("seed", range(8))
def test_row_runs_matches_jax(seed):
    rng = np.random.RandomState(seed)
    fg = rng.uniform(size=(int(rng.randint(1, 5)), int(rng.randint(1, 17)))) < 0.6
    want = np.asarray(jslice._row_runs(jnp.asarray(fg)))
    got = tslice._row_runs(torch.from_numpy(fg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(8))
def test_plan_slices_matches_jax_and_oracle(seed):
    grid, nodes, req, member_idx, member_valid = _torus(seed)
    jt, jok = jslice.plan_slices(_jax_nt(nodes), jnp.asarray(req), jnp.asarray(member_idx),
                                 jnp.asarray(member_valid), grid)
    tt, tok = tslice.plan_slices(_torch_nt(nodes), torch.from_numpy(req),
                                 torch.from_numpy(member_idx), torch.from_numpy(member_valid),
                                 grid)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # the JAX host oracle, with each gang's request the max over its members
    wants = member_valid.sum(axis=1)
    req_g = np.stack([np.max(np.where(member_valid[g][:, None], req[np.maximum(
        member_idx[g], 0)], 0), axis=0) for g in range(len(wants))])
    free = nodes["allocatable"] - nodes["requested"]
    fits = np.stack([np.all((free >= rg[None, :]) | (rg[None, :] == 0), axis=1)
                     & nodes["valid"] & ~nodes["unschedulable"] for rg in req_g])
    h_targets, h_ok = jslice.slice_assign_host(nodes["topo_sp"], nodes["topo_pos"],
                                               nodes["valid"], fits, wants, grid)
    for g, k in enumerate(wants):
        assert bool(tok[g]) == h_ok[g]
        if h_ok[g]:
            assert tt[g, :k].tolist() == h_targets[g]
        else:
            assert (tt[g] == -1).all()


def test_duplicate_coordinates_take_the_highest_slot():
    """Three nodes on one cell: the cell holds the highest slot, as JAX's CPU
    scatter and the host oracle give it."""
    nodes = {"valid": np.ones(5, bool), "unschedulable": np.zeros(5, bool),
             "allocatable": np.full((5, 1), 4, np.int32), "requested": np.zeros((5, 1), np.int32),
             "topo_sp": np.zeros(5, np.int32), "topo_pos": np.array([1, 0, 1, 1, 2], np.int32)}
    req = np.ones((3, 1), np.int32)
    member_idx = np.array([[0, 1, 2]], np.int32)
    args = (req, member_idx, member_idx >= 0)
    jt, _ = jslice.plan_slices(_jax_nt(nodes), *map(jnp.asarray, args), (1, 4))
    tt, _ = tslice.plan_slices(_torch_nt(nodes), *map(torch.from_numpy, args), (1, 4))
    assert tt.tolist() == [[1, 3, 4]] == np.asarray(jt).tolist()


def test_oversized_gang_plan_is_all_or_nothing():
    """A gang one wider than the free run is rejected: ok False, every
    target -1; a later gang that fits still plans."""
    nodes = {"valid": np.ones(6, bool), "unschedulable": np.zeros(6, bool),
             "allocatable": np.full((6, 1), 10, np.int32),
             "requested": np.array([[0], [0], [10], [0], [0], [0]], np.int32),
             "topo_sp": np.zeros(6, np.int32), "topo_pos": np.arange(6, dtype=np.int32)}
    req = np.ones((6, 1), np.int32)
    member_idx = np.array([[0, 1, 2, 3], [4, 5, -1, -1]], np.int32)
    args = (req, member_idx, member_idx >= 0)
    tt, tok = tslice.plan_slices(_torch_nt(nodes), *map(torch.from_numpy, args), (1, 6))
    jt, jok = jslice.plan_slices(_jax_nt(nodes), *map(jnp.asarray, args), (1, 6))
    assert tok.tolist() == [False, True] == np.asarray(jok).tolist()
    assert tt.tolist() == [[-1] * 4, [0, 1, -1, -1]] == np.asarray(jt).tolist()


# ------------------------------------------------------------ the batch program


def _encoded_with_gangs(seed: int, sp_slots: int = 8):
    """A JAX-encoded batch (40 nodes with synthetic torus coordinates from
    their slots) and a member index of three slice gangs plus padding."""
    jds, pods, pb, et = jax_encoded(40, 48, seed)
    member_idx = np.full((4, 8), -1, np.int32)
    member_idx[0, :3] = [4, 9, 11]
    member_idx[1, :8] = np.arange(20, 28)
    member_idx[2, :2] = [0, 47]
    return jds, pods, pb, et, member_idx


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_slice_plan_matches_jax(seed):
    jds, _pods, pb, et, member_idx = _encoded_with_gangs(seed)
    grid = (jds.caps.superpods, jds.caps.sp_slots)
    jmask, jwords = jbatch._slice_plan(pb, jds.nt, (jnp.asarray(member_idx),
                                                    jnp.asarray(member_idx >= 0)), grid)
    nt = interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu")
    tpb = interop.pod_batch_from_numpy(numpy_fields(pb), "cpu")
    idx = torch.from_numpy(member_idx)
    tmask, twords = tbatch._slice_plan(tpb, nt, (idx, idx >= 0), grid)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(twords.numpy(), np.asarray(jwords))
    words = twords.numpy()
    assert (words[member_idx[member_idx >= 0]] & tbatch.SLICE_MEMBER_BIT).all()
    assert (words[[i for i in range(48) if i not in member_idx]] == 0).all()


@pytest.mark.parametrize("spec", [False, True])
def test_slice_batch_matches_jax(spec):
    """A batch with slice gangs through both packages' schedule_batch (the
    fused kernel's plain version or the rounds; JAX: the scan or the
    rounds): every field and the packed bytes, slice column included."""
    jds, pods, pb, et, member_idx = _encoded_with_gangs(4)
    grid = (jds.caps.superpods, jds.caps.sp_slots)
    jres = jbatch.schedule_batch(pb, et, jds.nt, jds.tc, jds.sig_table.encode_topo(pods),
                                 jax.random.PRNGKey(0), topo_enabled=False, spec_decode=spec,
                                 slice_members=(jnp.asarray(member_idx),
                                                jnp.asarray(member_idx >= 0)),
                                 slice_grid=grid)
    idx = torch.from_numpy(member_idx)
    tres = tbatch.schedule_batch(interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
                                 interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
                                 interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"),
                                 device="cpu", spec_decode=spec, slice_members=(idx, idx >= 0),
                                 slice_grid=grid)
    assert tres.packed.numpy().tobytes() == np.asarray(jres.packed).tobytes()
    for name in ("node_idx", "first_fail", "final_requested", "any_feasible"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), err_msg=name)
    assert 11 in np.unique(tres.first_fail.numpy())
    _, _, words, _ = tbatch.unpack_result_block(tres.packed, jds.caps.nodes)
    assert words is not None and (words[[4, 9, 11]] & tbatch.SLICE_PLAN_OK_BIT).all()


def test_first_fail_order_with_three_masks():
    """Static ids first, then 9 (volumes), 10 (claims), 11 (slices): a cell
    failing the slice mask alone reports 11, with the claim mask 10."""
    jds, pods, pb, et = jax_encoded(40, 48, 1)
    nt, tpb, tet = (interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"),
                    interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
                    interop.expr_table_from_numpy(numpy_fields(et), "cpu"))
    base = tbatch.static_phase(tpb, tet, nt)[2].numpy()
    taint = np.argwhere(base == 3)[0]
    clean = np.argwhere((base == 0) & nt.valid.numpy()[None, :] & tpb.valid.numpy()[:, None])
    every, dra_slice, only_slice = clean[0], clean[1], clean[2]
    masks = [np.ones(base.shape, bool) for _ in range(3)]
    for cell in (taint, every):
        for m in masks:
            m[tuple(cell)] = False
    masks[1][tuple(dra_slice)] = masks[2][tuple(dra_slice)] = False
    masks[2][tuple(only_slice)] = False
    got = tbatch.static_phase(tpb, tet, nt, *map(torch.from_numpy, masks))
    ff = got[2].numpy()
    assert (ff[tuple(taint)], ff[tuple(every)], ff[tuple(dra_slice)],
            ff[tuple(only_slice)]) == (3, 9, 10, 11)
    # the JAX static phase, read off its program's first-fail table, with the
    # slice mask the plan of a one-pod "gang" pinned to nowhere gives
    extra, dra, slice_mask = masks
    want = jbatch.schedule_batch_core(
        pb, et, jds.nt, jds.tc, jds.sig_table.encode_topo(pods), jax.random.PRNGKey(0),
        tuple(sorted(jbatch.DEFAULT_WEIGHTS.items())), False, extra_mask=jnp.asarray(extra),
        dra_mask=jnp.asarray(dra), slice_mask=jnp.asarray(slice_mask))
    static = ff != 0
    np.testing.assert_array_equal(np.asarray(want.first_fail)[static], ff[static])
    assert not got[1].numpy()[tuple(only_slice)]


@pytest.mark.parametrize("n", [128, 130, 131])
def test_pack_unpack_with_slice_column(n):
    rng = np.random.RandomState(n)
    idx = rng.randint(-1, n, size=16).astype(np.int32)
    ff = rng.randint(-3, 12, size=(16, n)).astype(np.int8)
    words = rng.randint(-2 ** 31, 2 ** 31 - 1, size=16).astype(np.int32)
    jp = np.asarray(jbatch.pack_result_block(jnp.asarray(idx), jnp.asarray(ff),
                                             slice_words=jnp.asarray(words)))
    tp = tbatch.pack_result_block(torch.from_numpy(idx), torch.from_numpy(ff),
                                  torch.from_numpy(words))
    assert jp.tobytes() == tp.numpy().tobytes()
    j_idx, j_ff, j_words, _ = jbatch.unpack_result_block(jp, n)
    t_idx, t_ff, t_words, t_quota = tbatch.unpack_result_block(tp, n)
    assert t_quota is None
    for a, b in ((j_idx, t_idx), (j_ff, t_ff), (j_words, t_words), (t_words, words)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_fragmentation_matches_jax(seed):
    grid, nodes, _req, _idx, _valid = _torus(seed)
    node_free = np.random.RandomState(seed + 50).uniform(size=len(nodes["valid"])) < 0.6
    args = (nodes["topo_sp"], nodes["topo_pos"], nodes["valid"], node_free, grid)
    assert tslice.fragmentation_host(*args) == jslice.fragmentation_host(*args)


# ------------------------------------------------------------------ BatchScheduler


@pytest.mark.parametrize("spec", ["0", "1"])
def test_scheduling_slices_matches_jax(monkeypatch, spec):
    """Small SchedulingSlices (32 nodes, 8 slots): placements, PodGroup
    status and the slice stats equal the JAX loop's, on the fused kernel's
    plain version and on the rounds."""
    from kubernetes_tpu_torch.perf import workloads

    monkeypatch.setenv("KTPU_SPEC", spec)
    placed_j, rejected_j, jstore, _trace, placed_t, tstore, sched = run_gang_workload_both(
        "scheduling_slices")
    assert placed_t == placed_j and all(placed_t.values())
    assert rejected_j == sched.gang_rejected == {}
    assert pod_group_status(tstore) == pod_group_status(jstore)
    assert set(pod_group_status(tstore).values()) == {("Running", 2), ("Running", 8)}
    assert set(sched.batch_paths) == {"fused" if spec == "0" else "spec"}
    stats = workloads.slice_stats(sched.snapshot.node_info_map.values())
    assert stats["ContiguityViolations"] == 0.0 and stats["BoundSliceGangs"] == 4.0


def _slice_cluster(api, meta, pod_group, store, n=16, slots=8):
    from kubernetes_tpu_torch.ops.slice import TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL

    infos = []
    for i in range(n):
        nw = api.make_node(f"node-{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 8})
        nw.label(TOPO_SUPERPOD_LABEL, str(i // slots)).label(TOPO_SLOT_LABEL, str(i % slots))
        infos.append(api.NodeInfo(nw.obj()))
    for name, size in (("wide", slots + 1), ("fits", 4)):
        store.create_object("PodGroup", pod_group(meta=meta(name=name, namespace="default"),
                                                  min_member=size))
    return infos


def _slice_pods(api):
    pods = []
    for name, size in (("wide", 9), ("fits", 4)):
        for j in range(size):
            pods.append(api.make_pod(f"{name}-{j}").req({"cpu": "3500m", "memory": "12Gi"})
                        .pod_group(name).label("ktpu.dev/slice", "1").obj())
    pods.append(api.make_pod("plain").req({"cpu": "1", "memory": "1Gi"}).obj())
    return pods


def test_oversized_slice_gang_rejected_whole():
    """A slice gang one host wider than a superpod: every member None with
    reason "infeasible", its PodGroup Pending and in backoff; the gang that
    fits and the plain pod place; the same as the JAX loop."""
    from kubernetes_tpu.api.types import ObjectMeta as JMeta, PodGroup as JPodGroup
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    caps = dict(nodes=128, pods=32, value_words=32, superpods=16, sp_slots=8)
    jstore = ClusterStore()
    jinfos = {ni.node.meta.name: ni for ni in _slice_cluster(jax_api(), JMeta, JPodGroup,
                                                             jstore)}
    jpods = _slice_pods(jax_api())
    for pod in jpods:
        jstore.create_pod(pod)
    rejected_j = {}
    plugin = jax_coscheduling(jstore)
    placed_j = jax_gang_loop(JDeviceState(JCaps(**caps)), jbatch.build_schedule_batch_fn(),
                             jinfos, jstore, plugin, jpods, 32, rejected_j)
    tstore = Store()
    infos = _slice_cluster(torch_api(), ObjectMeta, PodGroup, tstore)
    sched = BatchScheduler(infos, caps=Capacities(**caps), device="cpu", client=tstore)
    placed_t = sched.schedule(_slice_pods(torch_api()))
    assert placed_t == placed_j
    assert sched.gang_rejected == rejected_j == {f"default/wide-{j}": "infeasible"
                                                 for j in range(9)}
    assert all(placed_t[f"default/fits-{j}"] for j in range(4)) and placed_t["default/plain"]
    assert pod_group_status(tstore) == pod_group_status(jstore)
    assert pod_group_status(tstore)["default/wide"] == ("Pending", 0)
    assert sched.coscheduling.rejections == plugin.metrics.gangs_rejected.by_label == {
        "infeasible": 1}
    assert sched.coscheduling.pre_filter(None, _slice_pods(torch_api())[0])[1].reason.startswith(
        "pod group is in rejection backoff")
