"""The port's sampled scan (percentageOfNodesToScore's rotating window)
against the JAX package's ``schedule_batch`` with ``sample_k`` and
``sample_start``, on the same encoded batches: ``node_idx``,
``first_fail``, ``final_sample_start`` and the carry equal, ``best_score``
equal bit for bit. Modes ``off`` (a sampled batch takes the scan, never the
kernel), ``host`` and ``general``; windows smaller than the feasible set, a
start that wraps, a nominated node the window does not reach, padding pods
(which must not move the start) and ``k`` at or above the node axis."""

import jax
import numpy as np
import pytest
import torch

from _torch_cases import (f32_bits, jax_encoded, numpy_fields, topo_case_args, u32)
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu_torch import interop
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.ops import fused_step

FIELDS = ("node_idx", "any_feasible", "fit_ok", "ports_ok", "spread_ok", "ipa_ok",
          "first_fail", "final_requested", "final_nonzero", "final_class_req", "packed")


def _port_args(jds, pb, et, tb=None):
    args = (interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
            interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
            interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"))
    if tb is None:
        return args, {}
    return args, dict(tc=interop.topo_counts_from_numpy(numpy_fields(jds.tc), "cpu"),
                      tb=interop.topo_batch_from_numpy(numpy_fields(tb), "cpu"))


def _case(mode: str, seed: int):
    """(JAX DeviceState, pb, et, tb or None, schedule_batch kwargs, the
    number of real pods). ``mode``: "off" or a TOPO_MODES case ("host",
    "general-bucket": mode ``general`` on the scheduler's domain axis)."""
    if mode == "off":
        # 40 pods in a 64-row batch: 24 padding rows; pod 1 (its selector
        # is zone-1) is nominated to node-4, of zone-1
        jds, pods, pb, et = jax_encoded(40, 40, seed, nominate="node-4")
        return jds, pb, et, None, dict(topo_mode="off"), len(pods)
    jds, pb, et, tb, kw = topo_case_args(mode, seed)
    return jds, pb, et, tb, kw, int(np.asarray(pb.valid).sum())


def _run(jds, pb, et, tb, kw, k: int, start: int):
    """The JAX and the port's results of one sampled batch."""
    mode = kw["topo_mode"]
    jtb = tb if tb is not None else jds.sig_table.encode_topo([])
    jres = jbatch.schedule_batch(pb, et, jds.nt, jds.tc, jtb, jax.random.PRNGKey(0),
                                 topo_enabled=mode != "off", sample_k=np.int32(k),
                                 sample_start=np.int32(start), **kw)
    args, topo = _port_args(jds, pb, et, tb)
    launches = fused_step.LAUNCHES
    tres = tbatch.schedule_batch(*args, device="cpu", sample_k=k,
                                 sample_start=torch.tensor(start, dtype=torch.int32),
                                 **topo, **kw)
    assert fused_step.LAUNCHES == launches  # the scan, never the kernel
    return jres, tres


def _both(mode: str, seed: int, k: int, start: int):
    jds, pb, et, tb, kw, n_pods = _case(mode, seed)
    jres, tres = _run(jds, pb, et, tb, kw, k, start)
    return jds, jres, tres, n_pods


def _assert_same(jres, tres, topo: bool):
    for name in FIELDS + (("final_sel_counts", "final_seg_exist") if topo else ()):
        got, want = getattr(tres, name).numpy(), np.asarray(getattr(jres, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(u32(tres.final_ports), np.asarray(jres.final_ports))
    np.testing.assert_array_equal(f32_bits(tres.best_score), f32_bits(jres.best_score))
    assert int(tres.final_sample_start) == int(np.asarray(jres.final_sample_start))


@pytest.mark.parametrize("k,start", [(3, 0), (7, 200), (20, 255)])
@pytest.mark.parametrize("mode", ["off", "host", "general-bucket"])
def test_sampled_scan_matches_jax(mode, k, start):
    jds, jres, tres, n_pods = _both(mode, 0, k, start % jds_nodes(mode))
    _assert_same(jres, tres, topo=mode != "off")
    assert tres.final_sample_start is not None
    assert (tres.node_idx.numpy()[:n_pods] >= 0).sum() > n_pods // 2


def jds_nodes(mode: str) -> int:
    """The node axis of a case (the window turns over slots, not nodes)."""
    return 256 if mode == "off" else 128


@pytest.mark.parametrize("mode", ["off", "general-bucket"])
def test_window_changes_placements(mode):
    """A small window places pods elsewhere than the full evaluation (the
    case is not vacuous), and the start moves by a whole turn at most per
    pod."""
    n = jds_nodes(mode)
    _jds, _jres, small, n_pods = _both(mode, 1, 2, 5)
    _jds, _jres, full, _ = _both(mode, 1, n, 5)
    assert not torch.equal(small.node_idx, full.node_idx)
    assert 0 <= int(small.final_sample_start) < n


def test_k_at_or_above_the_axis_examines_everything():
    """``k`` >= the node axis: every feasible node is eligible and each real
    pod turns the window by a whole axis, so the start comes back to where
    it began; the placements equal the unsampled kernel's."""
    jds, jres, tres, _ = _both("off", 2, 300, 17)
    _assert_same(jres, tres, topo=False)
    assert int(tres.final_sample_start) == 17
    _jds, pb, et, _tb, kw, _ = _case("off", 2)
    args, _ = _port_args(jds, pb, et)
    plain = tbatch.schedule_batch(*args, device="cpu", **kw)
    assert torch.equal(plain.node_idx, tres.node_idx)


def test_padding_pods_do_not_rotate():
    """Only real pods move the start: the same 40 pods in a batch of 40
    rows and of 64 rows (24 padding) end at the same start, with the same
    placements, in both packages."""
    out = {}
    for cap in (40, 64):
        jds, _pods, pb, et = jax_encoded(40, 40, 3, nominate="node-4", pods_cap=cap)
        jres, tres = _run(jds, pb, et, None, dict(topo_mode="off"), 5, 11)
        _assert_same(jres, tres, topo=False)
        out[cap] = tres
    assert int(out[40].final_sample_start) == int(out[64].final_sample_start) != 11
    assert torch.equal(out[40].node_idx, out[64].node_idx[:40])
    assert (out[64].node_idx[40:] == -1).all()


def test_nominated_node_outside_the_window_stays_eligible():
    """Pod 1 is nominated to node-4; with a one-node window starting far
    from node-4's slot, it still lands there (the nominated node is ORed
    into the window), in both packages."""
    jds, jres, tres, _ = _both("off", 0, 1, 100)
    _assert_same(jres, tres, topo=False)
    slot = jds.encoder.node_slots["node-4"]
    assert int(tres.first_fail[1, slot]) == 0
    assert int(tres.node_idx[1]) == slot


def test_spec_decode_refuses_a_sampled_batch():
    jds, pb, et, _tb, kw, _ = _case("off", 0)
    args, _ = _port_args(jds, pb, et)
    with pytest.raises(ValueError, match="sampling"):
        tbatch.schedule_batch(*args, device="cpu", spec_decode=True, sample_k=4, **kw)
    assert not tbatch.spec_decode_eligible("off", "cpu", sampled=True)
