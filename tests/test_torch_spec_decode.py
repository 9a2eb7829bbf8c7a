"""The port's speculative decode (``backend/batch.py:_speculative_core``)
on the CPU, with exact equality:

* against the JAX package's rounds (``schedule_batch(..., spec_decode=True)``)
  on the same encoded state, in modes off, host and general (full, bucket
  and exact domain axis): every BatchResult field, the packed bytes and the
  ``best_score`` bits;
* against the port's own scan and fused kernel (plain version) on the cases
  of tests/test_spec_decode.py: placements, ``any_feasible``, every carry,
  and ``first_fail`` on the rows the JAX test compares;
* the loop: rounds per batch, and zero rounds on an all-padding batch;
* the float sum over three or more ScheduleAnyway constraints, and the
  whole-number contractions at counts above 2**11;
* ``BatchScheduler`` under ``KTPU_SPEC=1`` against the JAX loop under
  ``KTPU_SPEC=1``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_cases import (HOST, TOPO_MODES, WORKLOADS, ZONE, SnapshotShim, f32_bits, jax_api,
                          jax_encoded, numpy_fields, run_workload_both, topo_case_args,
                          torch_api, u32)
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu_torch import interop
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
from kubernetes_tpu_torch.ops.schema import Capacities

FIELDS = ("node_idx", "any_feasible", "fit_ok", "ports_ok", "spread_ok", "ipa_ok",
          "first_fail", "final_requested", "final_nonzero", "final_class_req", "packed")
TOPO_FIELDS = ("final_sel_counts", "final_seg_exist")


def _port_args(jds, pb, et, tb=None, tc=None):
    """The JAX-encoded state carried into the port on the CPU (``tc``:
    the count tables, by default the DeviceState's)."""
    args = (interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
            interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
            interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"))
    if tb is None:
        return args, {}
    return args, dict(tc=interop.topo_counts_from_numpy(numpy_fields(tc or jds.tc), "cpu"),
                      tb=interop.topo_batch_from_numpy(numpy_fields(tb), "cpu"))


def _assert_same_as_jax(tres, jres, topo: bool):
    for name in FIELDS + (TOPO_FIELDS if topo else ()):
        got, want = getattr(tres, name).numpy(), np.asarray(getattr(jres, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(u32(tres.final_ports), np.asarray(jres.final_ports))
    np.testing.assert_array_equal(f32_bits(tres.best_score), f32_bits(jres.best_score))


# ------------------------------------------------------- port rounds vs JAX rounds


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["off"] + sorted(TOPO_MODES))
def test_rounds_match_jax_rounds(case, seed):
    if case == "off":
        jds, _pods, pb, et = jax_encoded(40, 48, seed, nominate="node-3", node_name="node-9")
        tb, kw = jds.sig_table.encode_topo(_pods), dict(topo_mode="off")
    else:
        jds, pb, et, tb, kw = topo_case_args(case, seed)
    jres = jbatch.schedule_batch(pb, et, jds.nt, jds.tc, tb, jax.random.PRNGKey(0),
                                 topo_enabled=case != "off", spec_decode=True, **kw)
    args, topo = _port_args(jds, pb, et, None if case == "off" else tb)
    before = tbatch.ROUNDS
    tres = tbatch.schedule_batch(*args, device="cpu", spec_decode=True, **topo, **kw)
    assert tbatch.ROUNDS > before
    _assert_same_as_jax(tres, jres, topo=case != "off")
    assert (tres.node_idx.numpy() >= 0).sum() > 16


@pytest.mark.parametrize("ports_enabled", [False, True])
def test_rounds_without_ports_match_jax(ports_enabled):
    """A batch in which no pod wants a host port, with and without the
    [P, N, W] conflict."""
    jds, pods, pb, et = jax_encoded(40, 48, 5)
    assert bool(np.asarray(pb.port_ids).any())
    # drop the wanted ports: encode again without them
    for p in pods:
        for c in p.spec.containers:
            c.ports = []
    pb, et = jds.encoder.encode_pods(pods)
    assert not jds.encoder.last_has_ports
    tb = jds.sig_table.encode_topo(pods)
    jres = jbatch.schedule_batch(pb, et, jds.nt, jds.tc, tb, jax.random.PRNGKey(0),
                                 topo_enabled=False, spec_decode=True,
                                 ports_enabled=ports_enabled)
    args, _ = _port_args(jds, pb, et)
    tres = tbatch.schedule_batch(*args, device="cpu", spec_decode=True,
                                 ports_enabled=ports_enabled)
    _assert_same_as_jax(tres, jres, topo=False)


# ------------------------------------------- port rounds vs the port's scan and kernel


def _nodes(n_nodes, cpu=("4", "8", "16")):
    """tests/test_spec_decode.py's nodes, with the port's API."""
    api = torch_api()
    return [api.NodeInfo(api.make_node(f"n{i}").capacity(
        {"cpu": cpu[i % len(cpu)], "memory": "16Gi", "pods": 20}).label("zone", f"z{i % 3}").obj())
        for i in range(n_nodes)]


def _pods(n, cpu="500m", mem=None, build=None):
    api = torch_api()
    out = []
    for i in range(n):
        req = {"cpu": cpu[i % len(cpu)] if isinstance(cpu, tuple) else cpu}
        if mem:
            req["memory"] = mem
        pw = api.make_pod(f"p{i}").req(req)
        if build is not None:
            build(api, i, pw)
        out.append(pw.obj())
    return out


def _spread(key, skew=1, min_domains=None, app="web", anyway=False):
    def build(api, i, pw):
        pw.label("app", app).spread_constraint(
            skew, key, selector=api.LabelSelector(match_labels={"app": app}),
            when_unsatisfiable="ScheduleAnyway" if anyway else "DoNotSchedule",
            min_domains=min_domains)
    return build


def _affinity(key, app, anti):
    def build(api, i, pw):
        pw.label("app", app).pod_affinity(key, api.LabelSelector(match_labels={"app": app}),
                                          anti=anti)
    return build


def _priorities(api, i, pw):
    pw.priority(i % 4)
    if i % 5 == 0:
        pw.node_selector({"zone": "z1"})
    if i % 7 == 0:
        pw.preferred_node_affinity(5, "zone", ["z2"])


def _near_capacity(api, i, pw):
    pw.preferred_node_affinity(10, "zone", ["z0"])
    pw.preferred_node_affinity(3, "zone", ["z1"])


def _mixed_host(api, i, pw):
    pw.label("app", f"svc{i % 2}").priority(i % 3)
    if i % 2 == 0:
        pw.spread_constraint(2, HOST, when_unsatisfiable="ScheduleAnyway",
                             selector=api.LabelSelector(match_labels={"app": "svc0"}))
    else:
        pw.preferred_pod_affinity(10, HOST, api.LabelSelector(match_labels={"app": "svc1"}))


def _mixed_zone(api, i, pw):
    pw.label("app", f"svc{i % 2}")
    if i % 2 == 0:
        pw.spread_constraint(2, "zone", when_unsatisfiable="ScheduleAnyway",
                             selector=api.LabelSelector(match_labels={"app": "svc0"}))
    else:
        pw.preferred_pod_affinity(10, "zone", api.LabelSelector(match_labels={"app": "svc1"}))


def _spread_and_anti(api, i, pw):
    _spread("zone", app="mix")(api, i, pw)
    if i % 4 == 0:
        pw.pod_affinity("zone", api.LabelSelector(match_labels={"app": "mix"}), anti=True)


def _one_slot():
    api = torch_api()
    return [api.NodeInfo(api.make_node("only").capacity(
        {"cpu": "1", "memory": "2Gi", "pods": 10}).obj())]


def _interleaved():
    api = torch_api()
    return [api.make_pod(f"big{i}").req({"cpu": "64"}).obj() if i % 3 == 2
            else api.make_pod(f"p{i}").req({"cpu": "900m"}).obj() for i in range(16)]


def _huge_tail():
    api = torch_api()
    return _pods(6) + [api.make_pod(f"huge{i}").req({"cpu": "64"}).obj() for i in range(2)]


def _host_ports():
    api = torch_api()
    return [api.make_pod(f"p{i}").req({"cpu": "100m"}).host_port(8080).obj() for i in range(6)]


# name: (nodes, pods, batch capacity, topology mode); the cases of
# tests/test_spec_decode.py, plus zone spread with minDomains
CASES = {
    "uniform": (lambda: _nodes(24), lambda: _pods(24, mem="1Gi"), 32, "off"),
    "mixed-sizes": (lambda: _nodes(24), lambda: _pods(30, ("3500m", "7", "300m"), "2Gi"), 32,
                    "off"),
    "unschedulable": (lambda: _nodes(8), _huge_tail, 16, "off"),
    "host-ports": (lambda: _nodes(4), _host_ports, 8, "off"),
    "priorities": (lambda: _nodes(24), lambda: _pods(20, "800m", build=_priorities), 32, "off"),
    "near-capacity": (lambda: _nodes(12), lambda: _pods(24, "3500m", build=_near_capacity), 32,
                      "off"),
    "interleaved-failures": (lambda: _nodes(6), _interleaved, 16, "off"),
    "one-slot-node": (_one_slot, lambda: _pods(3, "900m"), 8, "off"),
    "hostname-spread": (lambda: _nodes(12, ("8",)), lambda: _pods(20, build=_spread(HOST)), 32,
                        "host"),
    "hostname-anti-overflow": (lambda: _nodes(5, ("8",)),
                               lambda: _pods(8, "100m", build=_affinity(HOST, "x", True)), 8,
                               "host"),
    "self-affinity-first-pod": (lambda: _nodes(6, ("8",)),
                                lambda: _pods(10, build=_affinity(HOST, "herd", False)), 16,
                                "host"),
    "mixed-host": (lambda: _nodes(12, ("8",)), lambda: _pods(24, ("250m", "1"),
                                                             build=_mixed_host), 32, "host"),
    "zone-spread": (lambda: _nodes(12, ("8",)), lambda: _pods(18, build=_spread("zone")), 32,
                    "general"),
    "zone-spread-min-domains": (lambda: _nodes(12, ("8",)),
                                lambda: _pods(18, build=_spread("zone", min_domains=4)), 32,
                                "general"),
    "zone-anti": (lambda: _nodes(9, ("8",)),
                  lambda: _pods(5, "250m", build=_affinity("zone", "zdb", True)), 8, "general"),
    "zone-affinity": (lambda: _nodes(9, ("8",)),
                      lambda: _pods(9, build=_affinity("zone", "herd", False)), 16, "general"),
    "mixed-zone": (lambda: _nodes(12, ("8",)), lambda: _pods(24, ("250m", "1"),
                                                             build=_mixed_zone), 32, "general"),
    "zone-spread-anti": (lambda: _nodes(12, ("8",)), lambda: _pods(12, build=_spread_and_anti),
                         16, "general"),
}


def _port_batch(case):
    """(schedule_batch arguments and keywords) of a CASES entry, encoded
    by the port's own DeviceState on the CPU."""
    nodes, pods, batch, mode = CASES[case]
    sched = BatchScheduler(nodes(), caps=Capacities(nodes=128, pods=batch, sigs=16, ex_terms=32),
                           device="cpu")
    ds = sched.state
    ds.sync(sched.snapshot)
    pod_list = pods()
    pb, et = ds.encoder.encode_pods(pod_list)
    tb = ds.sig_table.encode_topo(pod_list)
    got_mode, vd, host_key = sched._topo_mode_info()
    assert got_mode == mode
    kw = dict(device="cpu", ports_enabled=ds.encoder.last_has_ports)
    if mode != "off":
        kw.update(tc=ds.tc, tb=tb, topo_mode=mode, vd_override=vd, host_key=host_key)
    return (pb, et, ds.nt), kw, len(pod_list)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_match_the_scan_and_the_kernel(case):
    args, kw, n_pods = _port_batch(case)
    seq = tbatch.schedule_batch(*args, spec_decode=False, **kw)
    before = tbatch.ROUNDS
    spec = tbatch.schedule_batch(*args, spec_decode=True, **kw)
    rounds = tbatch.ROUNDS - before
    assert 1 <= rounds <= n_pods
    names = ["node_idx", "any_feasible", "final_requested", "final_nonzero", "final_ports",
             "final_class_req"]
    if kw.get("topo_mode", "off") != "off":
        names += ["final_sel_counts", "final_seg_exist"]
    for name in names:
        assert torch.equal(getattr(spec, name), getattr(seq, name)), name
    idx, anyf = seq.node_idx.numpy(), seq.any_feasible.numpy()
    rows = (idx >= 0) | ~anyf  # the rows tests/test_spec_decode.py compares
    np.testing.assert_array_equal(spec.first_fail.numpy()[rows], seq.first_fail.numpy()[rows])
    valid = args[0].valid.numpy()  # padding pods' best_score is the scan's node-0 total
    np.testing.assert_array_equal(f32_bits(spec.best_score)[valid],
                                  f32_bits(seq.best_score)[valid])
    placed = int((idx >= 0).sum())
    if case == "hostname-anti-overflow":
        assert placed == 5  # one per node
    if case == "self-affinity-first-pod":
        assert placed == n_pods and len(set(idx[:n_pods].tolist())) == 1
    if case == "zone-spread-min-domains":
        assert placed == 3  # fewer domains than minDomains: one pod per zone
    if case == "zone-anti":
        # three zones take one pod each; every later winner waits a round for
        # the term an earlier one committed (the seg_exist deferral)
        assert placed == 3 and rounds >= placed
    if case == "one-slot-node":
        assert placed == 1


# ----------------------------------------------------------------------- the loop


def test_all_padding_batch_runs_no_round():
    args, kw, _ = _port_batch("uniform")
    pb = args[0]
    pb = dataclasses.replace(pb, valid=torch.zeros_like(pb.valid))
    before = tbatch.ROUNDS
    res = tbatch.schedule_batch(pb, *args[1:], spec_decode=True, **kw)
    assert tbatch.ROUNDS == before
    assert (res.node_idx == -1).all() and not res.any_feasible.any()
    assert torch.equal(res.final_requested, args[2].requested)


def test_conflicting_batch_takes_several_rounds():
    """Big pods on few nodes collide: more than one round, never more than
    one per valid pod."""
    args, kw, n_pods = _port_batch("mixed-sizes")
    before = tbatch.ROUNDS
    tbatch.schedule_batch(*args, spec_decode=True, **kw)
    assert 2 <= tbatch.ROUNDS - before <= n_pods


# ------------------------------------------------- float sums and contractions


def _schedule_both(jds, pb, et, tb, kw, spec_decode, tc=None):
    tc = tc or jds.tc
    jres = jbatch.schedule_batch(pb, et, jds.nt, tc, tb, jax.random.PRNGKey(0),
                                 topo_enabled=True, spec_decode=spec_decode, **kw)
    args, topo = _port_args(jds, pb, et, tb, tc)
    tres = tbatch.schedule_batch(*args, device="cpu", spec_decode=spec_decode, **topo, **kw)
    _assert_same_as_jax(tres, jres, topo=True)
    return tres


@pytest.mark.parametrize("spec_decode", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_many_schedule_anyway_constraints_match_jax(seed, spec_decode):
    """Four ScheduleAnyway constraints of skews 1-4 per pod: the rounds sum
    their non-integral contributions over the [P, C, N] constraint axis
    (the scan over [C, N]) in XLA's order."""
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from _torch_cases import (TOPO_CAPS, build_topo_nodes, build_topo_pods,
                              jax_topo_mode_info, topo_cluster_spec, topo_pods_spec)

    keys = (ZONE, HOST)
    jds = JDeviceState(JCaps(**{**TOPO_CAPS, "spread_cons": 4}))
    jds.sync(SnapshotShim(build_topo_nodes(jax_api(), topo_cluster_spec(48, seed, keys))))
    spec = topo_pods_spec(32, seed + 3, keys)
    sels = ({"app": "web"}, {"color": "green"}, {"app": "db"}, {"color": "green"})
    for i, d in enumerate(spec):
        d["spread"] = [(skew, keys[(i + skew) % 2], "ScheduleAnyway", sels[skew - 1], None)
                       for skew in (1, 2, 3, 4)]
    pods = build_topo_pods(jax_api(), spec)
    pb, et = jds.encoder.encode_pods(pods)
    tb = jds.sig_table.encode_topo(pods)
    assert (np.asarray(tb.ss_valid).sum(axis=1) == 4).all()
    mode, vd, host_key = jax_topo_mode_info(jds)
    assert mode == "general"
    tres = _schedule_both(jds, pb, et, tb, dict(topo_mode=mode, vd_override=vd,
                                                host_key=host_key), spec_decode)
    assert (tres.node_idx.numpy() >= 0).sum() > 16


@pytest.mark.parametrize("spec_decode", [True, False])
@pytest.mark.parametrize("case", ["host", "general-bucket"])
def test_large_counts_contract_exactly(case, spec_decode):
    """Count tables scaled so that the [P, T] x [T, N] contractions (and the
    per-domain sums) see whole numbers far above 2**11, where a TF32 GEMM
    would round: the rounds' float64 contractions and the scan's elementwise
    ones both equal JAX."""
    jds, pb, et, tb, kw = topo_case_args(case, 2)
    scale = 3001  # odd, above 2**11: not a TF32 value
    tc = dataclasses.replace(jds.tc, sel_counts=jds.tc.sel_counts * scale,
                             term_counts=jds.tc.term_counts * scale)
    assert int(np.asarray(tc.term_counts).max()) > 2 ** 11
    _schedule_both(jds, pb, et, tb, kw, spec_decode, tc)


# ----------------------------------------------------------------- BatchScheduler


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_batch_scheduler_rounds_match_jax(name, monkeypatch):
    """Every batch forced to the rounds in both packages."""
    monkeypatch.setenv("KTPU_SPEC", "1")
    placed_j, modes_j, placed_t, sched = run_workload_both(name)
    assert placed_t == placed_j
    assert sched.batch_modes == modes_j
    assert set(sched.batch_paths) == {"spec"}
    n, n_init, n_meas, _ = WORKLOADS[name]
    placed = [v for v in placed_t.values() if v is not None]
    assert len(placed) == (n if name == "scheduling_pod_anti_affinity" else n_init + n_meas)


def test_auto_keeps_the_cpu_on_the_kernel_and_the_scan(monkeypatch):
    monkeypatch.delenv("KTPU_SPEC", raising=False)
    for mode in tbatch.TOPO_MODES:
        assert not tbatch.spec_decode_eligible(mode, "cpu")
        assert tbatch.spec_decode_eligible(mode, "cuda") == tbatch.SPEC_AUTO_CUDA[mode]
    monkeypatch.setenv("KTPU_SPEC", "1")
    assert all(tbatch.spec_decode_eligible(m, d) for m in tbatch.TOPO_MODES
               for d in ("cpu", "cuda"))
    monkeypatch.setenv("KTPU_SPEC", "0")
    assert not any(tbatch.spec_decode_eligible(m, d) for m in tbatch.TOPO_MODES
                   for d in ("cpu", "cuda"))
