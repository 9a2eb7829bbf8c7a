"""The port's schedule_batch (plain versions, CPU) against the JAX package's
schedule_batch on one encoded state, carried across through interop.

The JAX side runs its XLA scan (KTPU_PALLAS=0) and its Pallas kernel in
interpret mode (KTPU_PALLAS=interpret). Exact: node_idx, any_feasible,
first_fail, the three carries, the class table (the scan returns it; the
Pallas path does not) and the packed bytes. best_score is compared by bit
pattern: every term of the total is an integer-valued float32 times a
small integer weight, so no contraction can change it.
"""

import jax
import numpy as np
import pytest

from _torch_cases import f32_bits, jax_encoded, to_port, u32
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu_torch.backend import batch as tbatch


def _jax_run(monkeypatch, ds, pods, pb, et, mode, weights=None):
    monkeypatch.setenv("KTPU_PALLAS", mode)
    fn = jbatch.build_schedule_batch_fn(weights)
    return fn(pb, et, ds.nt, ds.tc, ds.sig_table.encode_topo(pods),
              jax.random.PRNGKey(0), topo_enabled=False,
              ports_enabled=ds.encoder.last_has_ports)


def _compare(jres, tres, class_req=True):
    np.testing.assert_array_equal(np.asarray(jres.node_idx), tres.node_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jres.any_feasible), tres.any_feasible.numpy())
    np.testing.assert_array_equal(np.asarray(jres.first_fail), tres.first_fail.numpy())
    np.testing.assert_array_equal(np.asarray(jres.fit_ok), tres.fit_ok.numpy())
    np.testing.assert_array_equal(np.asarray(jres.ports_ok), tres.ports_ok.numpy())
    np.testing.assert_array_equal(f32_bits(jres.best_score), f32_bits(tres.best_score))
    np.testing.assert_array_equal(np.asarray(jres.final_requested), tres.final_requested.numpy())
    np.testing.assert_array_equal(np.asarray(jres.final_nonzero), tres.final_nonzero.numpy())
    np.testing.assert_array_equal(np.asarray(jres.final_ports), u32(tres.final_ports))
    if class_req:
        np.testing.assert_array_equal(np.asarray(jres.final_class_req),
                                      tres.final_class_req.numpy())
    packed = np.asarray(jres.packed)
    np.testing.assert_array_equal(packed, tres.packed.numpy())
    assert packed.tobytes() == tres.packed.numpy().tobytes()
    for name, mask in tres.static_masks.items():
        np.testing.assert_array_equal(np.asarray(jres.static_masks[name]), mask.numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("seed", [1, 2])
def test_schedule_batch_matches_jax(monkeypatch, mode, seed):
    ds, pods, pb, et = jax_encoded(200, 48, seed)
    nt, tpb, tet = to_port(ds, pb, et)
    tres = tbatch.schedule_batch(tpb, tet, nt, device="cpu")
    jres = _jax_run(monkeypatch, ds, pods, pb, et, mode)
    _compare(jres, tres, class_req=mode == "0")
    # the batch really exercised the filters: some placed, some failing ids
    ff = tres.first_fail.numpy()
    assert (tres.node_idx.numpy() >= 0).sum() > 10
    assert {1, 3, 4}.issubset(set(np.unique(ff).tolist()))


def test_schedule_batch_tight_cluster_matches_jax(monkeypatch):
    """Few nodes, many pods: fit (6) and ports (5) failures in the scan."""
    ds, pods, pb, et = jax_encoded(4, 64, 7, capacity_nodes=128)
    nt, tpb, tet = to_port(ds, pb, et)
    tres = tbatch.schedule_batch(tpb, tet, nt, device="cpu")
    _compare(_jax_run(monkeypatch, ds, pods, pb, et, "0"), tres)
    assert (tres.node_idx.numpy() == -1).any()
    assert {5, 6}.issubset(set(np.unique(tres.first_fail.numpy()).tolist()))


def test_nominated_pod_matches_scan(monkeypatch):
    """A pod with a nominated node: the port follows the XLA scan (the
    Pallas kernel has no nominated input, so it is not compared here)."""
    ds, pods, pb, et = jax_encoded(100, 16, 3, capacity_nodes=128,
                                   nominate="node-43", node_name="node-17")
    assert int(np.asarray(pb.nominated)[1]) >= 0
    nt, tpb, tet = to_port(ds, pb, et)
    tres = tbatch.schedule_batch(tpb, tet, nt, device="cpu")
    _compare(_jax_run(monkeypatch, ds, pods, pb, et, "0"), tres)
    slot = ds.encoder.node_slots["node-43"]
    assert int(tres.first_fail[1, slot]) == 0  # feasible, so it wins outright
    assert int(tres.node_idx[1]) == slot


def test_custom_weights_match_jax(monkeypatch):
    weights = dict(jbatch.DEFAULT_WEIGHTS, TaintToleration=1.0, NodeAffinity=5.0)
    ds, pods, pb, et = jax_encoded(150, 32, 11)
    nt, tpb, tet = to_port(ds, pb, et)
    tres = tbatch.schedule_batch(tpb, tet, nt, weights=weights, device="cpu")
    _compare(_jax_run(monkeypatch, ds, pods, pb, et, "0", weights), tres)
