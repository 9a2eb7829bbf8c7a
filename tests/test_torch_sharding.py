"""The port's node-axis sharding (``kubernetes_tpu_torch/parallel/``) on the
CPU: the nine cases of tests/test_sharding.py, built and encoded by both
packages from the same description (``_torch_cases.SHARDING_CASES``).

The port runs each case as W ``gloo`` ranks (``parallel.launch.run_ranks``)
for W in 2, 4 and 8; the JAX package runs ``make_sharded_schedule_fn`` on
``make_node_mesh(jax.devices()[:8])`` (conftest forces 8 CPU devices), the
mesh its own test uses. JAX's sharded result has the same bits at every
mesh size (its decisions are global by construction;
``test_jax_sharded_result_is_the_same_at_every_mesh_size`` holds that at 2
and 4 devices on two of the cases), so each W of the port is held to it.
Against JAX's sharded program, with the sharded fields gathered:
``node_idx``, ``any_feasible``, ``first_fail``, the four static masks,
``fit_ok``, ``ports_ok``, ``spread_ok``, ``ipa_ok`` and every carry
exactly equal, and ``best_score`` equal to the bit (each float sum across
ranks has one non-zero term, the owning rank's). In mode ``off`` the port
returns no topology carry (None, as its single-device program does); JAX
passes its inputs through unchanged there, which is checked.

Against the port's own single-device program, each case holds what
tests/test_sharding.py holds JAX's sharded result to. Where that test
allows ``best_score`` within 1.5 and placements that differ within score
ties (mode ``off``, the scan), the port is held to equality: the tie-break
jitter is keyed by node name (``ops/tiebreak.py``), the same under every
shard layout, so the sharded scan decides as the single-device batch does
(in mode ``off`` the fused kernel, here its plain version, which follows
the scan's float order).

All of a world size's cases run in one spawn of W processes, started in a
background thread at module setup so that the JAX side computes meanwhile;
every spawn has a deadline.
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest

from _torch_cases import SHARDING_CASES, sharding_case
from kubernetes_tpu.parallel import (make_node_mesh as jax_mesh,
                                     make_sharded_schedule_fn as jax_sharded_fn,
                                     shard_node_tensors as jax_shard_nt,
                                     shard_topo_counts as jax_shard_tc)
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.parallel import launch

WORLDS = (2, 4, 8)
SPAWN_TIMEOUT_S = 240.0
EXACT = ("node_idx", "any_feasible", "first_fail", "fit_ok", "ports_ok", "spread_ok", "ipa_ok",
         "final_requested", "final_nonzero", "final_class_req")
STATIC = ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity")


def _mode(kw) -> str:
    return kw.get("topo_mode") or ("general" if kw.get("topo_enabled") else "off")


@functools.lru_cache(maxsize=None)
def _port_inputs(name):
    return sharding_case("port", name)


@pytest.fixture(scope="module")
def port_runs():
    """World size -> future of ``schedule_cases``' records, rank 0's, by case."""
    names = list(SHARDING_CASES)
    cases = []
    for n in names:
        _enc, nt, pb, et, tc, tb, kw = _port_inputs(n)
        cases.append(launch.case_fields(pb, et, nt, tc, tb, **kw))

    def run(world):
        ranks = launch.run_ranks(launch.schedule_cases, world, device="cpu", args=(cases,),
                                 timeout_s=SPAWN_TIMEOUT_S)
        assert all(len(r) == len(names) for r in ranks)
        return dict(zip(names, ranks[0]))

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {w: pool.submit(run, w) for w in WORLDS}
    yield futures
    pool.shutdown(wait=True, cancel_futures=True)


JAX_WORLD = 8


@functools.lru_cache(maxsize=None)
def _jax_sharded(name, world=JAX_WORLD):
    enc, nt, pb, et, tc, tb, kw = sharding_case("jax", name)
    mesh = jax_mesh(jax.devices()[:world])
    res = jax_sharded_fn(mesh, **kw)(pb, et, jax_shard_nt(nt, mesh), jax_shard_tc(tc, mesh),
                                    tb, jax.random.PRNGKey(0))
    return res, np.asarray(tc.sel_counts), np.asarray(tc.term_counts).shape[0]


@functools.lru_cache(maxsize=None)
def _port_single(name):
    enc, nt, pb, et, tc, tb, kw = _port_inputs(name)
    return tbatch.schedule_batch_core(pb, et, nt, tbatch.DEFAULT_WEIGHTS, tc, tb, _mode(kw),
                                      host_key=kw.get("host_key", 0), spec_decode=False)


def _f32_bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _assert_equal_to_jax(got: dict, jres, jsel, n_terms, mode):
    for name in EXACT:
        want = np.asarray(getattr(jres, name))
        assert got[name].shape == want.shape, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    for name in STATIC:
        np.testing.assert_array_equal(got["static_masks"][name],
                                      np.asarray(jres.static_masks[name]), err_msg=name)
    np.testing.assert_array_equal(got["final_ports"].view(np.uint32),
                                  np.asarray(jres.final_ports))
    np.testing.assert_array_equal(_f32_bits(got["best_score"]), _f32_bits(jres.best_score))
    if mode == "off":
        assert got["final_sel_counts"] is None and got["final_seg_exist"] is None
        np.testing.assert_array_equal(np.asarray(jres.final_sel_counts), jsel)
        np.testing.assert_array_equal(np.asarray(jres.final_seg_exist),
                                      np.zeros((n_terms, 1), np.int32))
    else:
        for name in ("final_sel_counts", "final_seg_exist"):
            np.testing.assert_array_equal(got[name], np.asarray(getattr(jres, name)),
                                          err_msg=name)


def _assert_like_jax_test(name, got, enc, single):
    """What tests/test_sharding.py holds the sharded result to, against the
    port's single-device program."""
    idx = got["node_idx"]
    s_idx = single.node_idx.numpy()
    # every case: the same winners, feasibility and scores as the
    # single-device program (see the module docstring for mode off)
    np.testing.assert_array_equal(idx, s_idx)
    np.testing.assert_array_equal(got["any_feasible"], single.any_feasible.numpy())
    np.testing.assert_array_equal(_f32_bits(got["best_score"]), _f32_bits(single.best_score))
    fit = single.fit_ok.numpy()
    for p, slot in enumerate(idx):
        if slot >= 0:
            assert fit[p, slot]
            for m in single.static_masks.values():
                assert m.numpy()[p, slot]
    if name in ("topology_scan", "topo_carry_scan", "host_rounds", "general_rounds"):
        for f in ("spread_ok", "ipa_ok", "fit_ok", "ports_ok", "final_requested",
                  "final_nonzero", "final_sel_counts", "final_seg_exist"):
            if name.endswith("rounds") and f in ("spread_ok", "ipa_ok", "fit_ok", "ports_ok"):
                continue  # the JAX test compares the rounds' carries, not their masks
            np.testing.assert_array_equal(got[f], getattr(single, f).numpy(), err_msg=f)
    if name in ("topology_scan", "topo_carry_scan", "off_rounds"):
        np.testing.assert_array_equal(got["final_ports"], single.final_ports.numpy())
    if name == "capacity_scan":
        assert (idx >= 0).sum() == 1 and idx[idx >= 0][0] == enc.node_slots["only"]
    if name == "anti_cross_shard":
        placed = idx[idx >= 0]
        assert len(placed) == 2 and len({int(i) % 2 for i in placed}) == 2
    if name == "conflict_rounds":
        assert int((idx >= 0).sum()) == 8
    if name == "host_rounds":
        anti = [idx[i] for i in range(16) if i % 2 == 0 and idx[i] >= 0]
        assert len(anti) == len(set(anti))


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS for c in SHARDING_CASES])
def test_sharded_program_matches_jax(port_runs, world, case):
    rec = port_runs[world].result(timeout=SPAWN_TIMEOUT_S * len(WORLDS))[case]
    got = rec["result"]
    enc, *_rest, kw = _port_inputs(case)
    jres, jsel, n_terms = _jax_sharded(case)
    _assert_equal_to_jax(got, jres, jsel, n_terms, _mode(kw))
    _assert_like_jax_test(case, got, enc, _port_single(case))
    assert rec["collectives"] > 0 and rec["fused_launches"] == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["off_scan", "host_rounds"])
def test_jax_sharded_result_is_the_same_at_every_mesh_size(case, world):
    want, got = _jax_sharded(case)[0], _jax_sharded(case, world)[0]
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
        elif a is not None:
            np.testing.assert_array_equal(np.asarray(b).view(np.uint8),
                                          np.asarray(a).view(np.uint8), err_msg=name)


def test_sharded_program_needs_a_divisible_node_axis():
    from kubernetes_tpu_torch.parallel import NodeMesh, shard_node_tensors

    _enc, nt, *_ = _port_inputs("capacity_scan")
    mesh = NodeMesh(rank=0, world=3, group=None, device=nt.valid.device, backend="gloo")
    with pytest.raises(ValueError, match="not divisible"):
        shard_node_tensors(nt, mesh)


def test_unsharded_paths_unchanged_without_a_mesh():
    """``mesh=None`` leaves the single-device program as it was: mode off
    takes the fused kernel (its launches counted on CUDA tensors only, so
    its plain version here), the topology modes the scan, and a sharded
    call is refused a sampling window."""
    from kubernetes_tpu_torch.parallel import NodeMesh

    enc, nt, pb, et, tc, tb, kw = _port_inputs("off_scan")
    res = tbatch.schedule_batch_core(pb, et, nt, tbatch.DEFAULT_WEIGHTS)
    assert res.final_sel_counts is None
    mesh = NodeMesh(rank=0, world=1, group=None, device=nt.valid.device, backend="gloo")
    with pytest.raises(ValueError, match="sampling"):
        tbatch.schedule_batch_core(pb, et, nt, tbatch.DEFAULT_WEIGHTS, sample_k=4, mesh=mesh)


def test_one_rank_in_process_with_host_staging(tmp_path):
    """A one-rank gloo group in this process: the sharded scan equals the
    unsharded batch, and its collectives are counted."""
    import torch.distributed as dist
    from kubernetes_tpu_torch.parallel import launch as tlaunch, make_node_mesh, mesh as tmesh

    _enc, nt, pb, et, tc, tb, kw = _port_inputs("host_rounds")
    want = launch.result_to_numpy(_port_single("host_rounds"))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_node_mesh("cpu")
        fn = tmesh.make_sharded_schedule_fn(mesh, **dict(kw, spec_decode=False))
        got = tlaunch.result_to_numpy(fn(pb, et, nt, tc, tb))
        assert mesh.collectives > 0 and mesh.collective_bytes > 0
    finally:
        dist.destroy_process_group()
    assert launch.result_diff({k: v for k, v in got.items() if k != "packed"},
                              {k: v for k, v in want.items() if k != "packed"}) == []


def test_run_ranks_raises_when_a_rank_raises():
    """A rank that raises fails the call with its traceback; a missing card
    raises before anything starts."""
    import torch

    with pytest.raises(RuntimeError, match="raised"):
        launch.run_ranks(launch.schedule_cases, 2, device="cpu", args=([{"bad": 1}],),
                         timeout_s=60)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.run_ranks(launch.schedule_cases, 2, args=([],), timeout_s=60)
