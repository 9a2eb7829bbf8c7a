"""The topology slice against the JAX package on the CPU, with exact
equality: the SigTable's encoding and recounts, ``schedule_batch`` in the
``host`` and ``general`` modes (full domain axis, the 64 bucket, and the
smallest axis that covers the involved keys), ``BatchScheduler`` on small
versions of SchedulingPodAntiAffinity, SchedulingPodAffinity and
TopologySpreading against the JAX DeviceState plus build_schedule_batch_fn
loop, and the mode cases of tests/test_topo_modes.py."""

import jax
import numpy as np
import pytest
import torch

from _torch_cases import (HOST, TOPO_CAPS as CAPS, TOPO_MODES as MODES, TOPO_WORKLOADS, ZONE,
                          SnapshotShim, build_topo_nodes, build_topo_pods, f32_bits, jax_api,
                          jax_loop as _jax_loop, jax_topo_mode_info as _jax_mode_info,
                          numpy_fields, run_workload_both, topo_cluster_spec,
                          topo_encoded as _encoded, topo_pods_spec, torch_api, u32)
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
from kubernetes_tpu.ops.schema import Capacities as JCaps
from kubernetes_tpu_torch import interop
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
from kubernetes_tpu_torch.backend.device_state import DeviceState
from kubernetes_tpu_torch.ops.schema import Capacities
from kubernetes_tpu_torch.perf import workloads


# ------------------------------------------------------------------ SigTable


def _compare_sig_tables(jst, tst):
    np.testing.assert_array_equal(jst.sel_counts, tst.sel_counts)
    np.testing.assert_array_equal(jst.term_counts, tst.term_counts)
    np.testing.assert_array_equal(jst.term_key_slots, tst.term_key_slots)
    assert (jst.n_sigs, jst.n_terms) == (tst.n_sigs, tst.n_terms)


def _compare_topo_batch(jtb, ttb):
    t = ttb.to_numpy()
    for name, a in numpy_fields(jtb).items():
        assert t[name].dtype == a.dtype, name
        np.testing.assert_array_equal(t[name], a, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sig_table_encode_and_recount_match_jax(seed):
    spec = topo_cluster_spec(48, seed)
    jinfos = {ni.node.meta.name: ni for ni in build_topo_nodes(jax_api(), spec)}
    tinfos = {ni.node.meta.name: ni for ni in build_topo_nodes(torch_api(), spec)}
    jds = JDeviceState(JCaps(**CAPS))
    tds = DeviceState(Capacities(**CAPS), device="cpu")
    jds.sync(SnapshotShim(jinfos.values()))
    tds.sync(SnapshotShim(tinfos.values()))
    _compare_sig_tables(jds.sig_table, tds.sig_table)
    assert jds.sig_table.n_terms > 1  # existing pods registered their terms

    pspec = topo_pods_spec(30, seed + 7)
    jpods, tpods = build_topo_pods(jax_api(), pspec), build_topo_pods(torch_api(), pspec)
    jds.encoder.encode_pods(jpods)
    tds.encoder.encode_pods(tpods)
    _compare_topo_batch(jds.sig_table.encode_topo(jpods), tds.sig_table.encode_topo(tpods))
    assert jds.sig_table.last_topo_summary == tds.sig_table.last_topo_summary
    _compare_sig_tables(jds.sig_table, tds.sig_table)  # the batch's rows, backfilled

    # recount_node: bind some pods, drop a node, then sync both again
    for i in range(0, 30, 3):
        name = f"node-{i % 48}"
        for pods, infos in ((jpods, jinfos), (tpods, tinfos)):
            bound = pods[i].clone()
            bound.spec.node_name = name
            infos[name].add_pod(bound)
    for infos in (jinfos, tinfos):
        del infos["node-5"]
    jds.sync(SnapshotShim(jinfos.values()))
    tds.sync(SnapshotShim(tinfos.values()))
    _compare_sig_tables(jds.sig_table, tds.sig_table)
    np.testing.assert_array_equal(np.asarray(jds.tc.sel_counts), tds.tc.sel_counts.numpy())
    np.testing.assert_array_equal(np.asarray(jds.tc.term_counts), tds.tc.term_counts.numpy())


def test_topology_free_batch_reuses_the_zero_programs():
    tds = DeviceState(Capacities(**CAPS), device="cpu")
    pods = build_topo_pods(torch_api(), [dict(p, spread=[], affinity=[], preferred=[])
                                         for p in topo_pods_spec(4, 3)])
    a = tds.sig_table.encode_topo(pods)
    b = tds.sig_table.encode_topo(pods)
    assert a is b and not tds.topo_enabled
    assert tds.sig_table.last_topo_summary == {"hostname_only": False, "vd_needed": 1}


# ------------------------------------------------------------ schedule_batch


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(MODES))
def test_schedule_batch_matches_jax_scan(case, seed):
    c = MODES[case]
    jds, pb, et, tb = _encoded(seed, c["keys"])
    mode, vd_bucket, host_key = _jax_mode_info(jds)
    assert mode == c["mode"]
    vd = {None: None, "bucket": vd_bucket,
          "exact": jds.sig_table.last_topo_summary["vd_needed"]}.get(c.get("vd"))
    tc = jds.tc  # after encode_topo: the batch's rows are backfilled
    jres = jbatch.schedule_batch(pb, et, jds.nt, tc, tb, jax.random.PRNGKey(0),
                                 topo_enabled=True, topo_mode=mode, vd_override=vd,
                                 host_key=host_key, spec_decode=False)
    tres = tbatch.schedule_batch(
        interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
        interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
        interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"), device="cpu",
        tc=interop.topo_counts_from_numpy(numpy_fields(tc), "cpu"),
        tb=interop.topo_batch_from_numpy(numpy_fields(tb), "cpu"),
        topo_mode=mode, vd_override=vd, host_key=host_key)

    for name in ("node_idx", "first_fail", "any_feasible", "fit_ok", "ports_ok", "spread_ok",
                 "ipa_ok", "final_requested", "final_nonzero", "final_class_req",
                 "final_sel_counts", "final_seg_exist", "packed"):
        got = getattr(tres, name).numpy()
        want = np.asarray(getattr(jres, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(u32(tres.final_ports), np.asarray(jres.final_ports))
    np.testing.assert_array_equal(f32_bits(tres.best_score), f32_bits(jres.best_score))
    # the batch exercises the topology filters and places most pods
    ff = tres.first_fail.numpy()
    assert (ff == tbatch.SPREAD_FAIL_ID).any() or (ff == tbatch.IPA_FAIL_ID).any()
    assert (tres.node_idx.numpy() >= 0).sum() > 16


def test_vd_override_below_the_involved_keys_is_exact_at_the_boundary():
    """The smallest domain axis that covers the involved keys' value ids:
    every domain id the scan reads is below it, so no gather or scatter
    leaves the axis."""
    jds, pb, et, tb = _encoded(2, (ZONE, HOST))
    vd = jds.sig_table.last_topo_summary["vd_needed"]
    assert vd == int(np.asarray(jds.nt.label_val).max()) + 1  # hostname ids reach the top
    tres = tbatch.schedule_batch(
        interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
        interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
        interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"), device="cpu",
        tc=interop.topo_counts_from_numpy(numpy_fields(jds.tc), "cpu"),
        tb=interop.topo_batch_from_numpy(numpy_fields(tb), "cpu"),
        topo_mode="general", vd_override=vd)
    assert tres.final_seg_exist.shape[1] == vd


# ------------------------------------------------------------ BatchScheduler


@pytest.mark.parametrize("name", sorted(TOPO_WORKLOADS))
def test_batch_scheduler_matches_jax_on_topology_workloads(name, monkeypatch):
    monkeypatch.setenv("KTPU_SPEC", "0")
    n, n_init, n_meas, _batch = TOPO_WORKLOADS[name]
    placed_j, modes_j, placed_t, sched = run_workload_both(name)
    assert sched.batch_paths == ["scan" if m != "off" else "fused" for m in modes_j]
    assert placed_t == placed_j
    assert sched.batch_modes == modes_j
    assert set(modes_j) == {"scheduling_pod_anti_affinity": {"host"},
                            "scheduling_pod_affinity": {"general"},
                            "topology_spreading": {"off", "general"}}[name]
    placed = [v for v in placed_t.values() if v is not None]
    if name == "scheduling_pod_anti_affinity":
        assert len(placed) == len(set(placed)) == n  # one per node, the rest refused
    else:
        assert len(placed) == n_init + n_meas


def test_workload_definitions_match_the_published_sizes():
    anti = workloads.scheduling_pod_anti_affinity()
    aff = workloads.scheduling_pod_affinity()
    spread = workloads.topology_spreading()
    assert (anti.nodes, anti.init_pods, anti.measured_pods) == (5000, 1000, 1000)
    assert (aff.nodes, aff.init_pods, aff.measured_pods) == (5000, 5000, 1000)
    assert (spread.nodes, spread.init_pods, spread.measured_pods) == (5000, 5000, 2000)
    assert anti.name == "SchedulingPodAntiAffinity/5000Nodes"
    pod = anti.measured.pods(1)[0]
    assert pod.meta.labels == {"color": "green"} and pod.meta.name == "anti-0"
    assert pod.spec.affinity.pod_anti_affinity.required[0].topology_key == HOST
    (c,) = spread.measured.pods(1)[0].spec.topology_spread_constraints
    assert (c.max_skew, c.topology_key, c.when_unsatisfiable) == (1, ZONE, "DoNotSchedule")
    assert not spread.init.pods(1)[0].spec.topology_spread_constraints


# ----------------------------------------------------------------- the modes


def _anti_nodes(api, names, hostnames):
    infos = []
    for name, hostname in zip(names, hostnames):
        node = api.make_node(name).capacity({"cpu": "8", "memory": "16Gi", "pods": 10}).obj()
        node.meta.labels[HOST] = hostname
        infos.append(api.NodeInfo(node))
    return infos


def _anti_pods(api, count):
    sel = api.LabelSelector(match_labels={"app": "x"})
    return [api.make_pod(f"p{i}").req({"cpu": "1"}).label("app", "x")
            .pod_affinity(HOST, sel, anti=True).obj() for i in range(count)]


def test_duplicate_hostname_falls_back_to_general():
    """Two nodes share one hostname: the fast path is refused, and required
    anti-affinity blocks both nodes, as in the JAX scheduler."""
    names = ["twin-a", "twin-b"]
    sched = BatchScheduler(_anti_nodes(torch_api(), names, ["shared", "shared"]),
                           caps=Capacities(nodes=128, pods=4), device="cpu")
    placed = sched.schedule(_anti_pods(torch_api(), 3))
    assert sched.batch_modes == ["general"]
    assert sum(v is not None for v in placed.values()) == 1
    jinfos = {ni.node.meta.name: ni for ni in _anti_nodes(jax_api(), names, ["shared"] * 2)}
    out, modes = _jax_loop(JDeviceState(JCaps(nodes=128, pods=4)), jbatch.build_schedule_batch_fn(),
                           jinfos, _anti_pods(jax_api(), 3), 4)
    assert (out, modes) == (placed, sched.batch_modes)


def test_unique_hostnames_select_host_mode():
    names = [f"n{i}" for i in range(4)]
    sched = BatchScheduler(_anti_nodes(torch_api(), names, names),
                           caps=Capacities(nodes=128, pods=4), device="cpu")
    placed = sched.schedule(_anti_pods(torch_api(), 6))
    assert sched.batch_modes == ["host", "host"]
    assert len({v for v in placed.values() if v is not None}) == 4


def test_host_mode_decides_as_general_mode():
    """Hostname-only batches: the fast path decides as the domain path does
    (the scores may differ in the last bits; the decisions may not)."""
    jds, pb, et, tb = _encoded(4, (HOST,))
    mode, _, host_key = _jax_mode_info(jds)
    assert mode == "host"
    args = (interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
            interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
            interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"))
    kw = dict(device="cpu", tc=interop.topo_counts_from_numpy(numpy_fields(jds.tc), "cpu"),
              tb=interop.topo_batch_from_numpy(numpy_fields(tb), "cpu"))
    host = tbatch.schedule_batch(*args, topo_mode="host", host_key=host_key, **kw)
    gen = tbatch.schedule_batch(*args, topo_mode="general", **kw)
    for name in ("node_idx", "any_feasible", "spread_ok", "ipa_ok", "first_fail",
                 "final_sel_counts"):
        assert torch.equal(getattr(host, name), getattr(gen, name)), name
    np.testing.assert_allclose(host.best_score.numpy(), gen.best_score.numpy(), atol=1e-4)


def test_vd_override_decides_as_the_full_domain_axis():
    jds, pb, et, tb = _encoded(5, (ZONE, HOST))
    args = (interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
            interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
            interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"))
    kw = dict(device="cpu", tc=interop.topo_counts_from_numpy(numpy_fields(jds.tc), "cpu"),
              tb=interop.topo_batch_from_numpy(numpy_fields(tb), "cpu"), topo_mode="general")
    full = tbatch.schedule_batch(*args, **kw)
    compact = tbatch.schedule_batch(*args, vd_override=64, **kw)
    for name in ("node_idx", "spread_ok", "ipa_ok", "any_feasible", "first_fail", "packed"):
        assert torch.equal(getattr(full, name), getattr(compact, name)), name
    assert torch.equal(full.final_seg_exist[:, :64], compact.final_seg_exist)
    assert not full.final_seg_exist[:, 64:].any()
