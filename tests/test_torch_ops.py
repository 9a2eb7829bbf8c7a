"""The port's static-phase ops against the JAX package's, on one encoded
state: masks, raw scores, the jitter table, the pod port bitsets and the
packed result block must be exactly equal (floats by bit pattern)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (build_nodes, build_pods, cluster_spec, f32_bits, jax_api,
                          jax_encoded, numpy_fields, pods_spec, to_port, torch_api, u32)
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu.ops.encode import ClusterEncoder as JEncoder
from kubernetes_tpu.ops.schema import Capacities as JCaps
from kubernetes_tpu.ops import filters as jfilters
from kubernetes_tpu.ops import scores as jscores
from kubernetes_tpu.ops import tiebreak as jtiebreak
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.ops import filters as tfilters
from kubernetes_tpu_torch.ops import scores as tscores
from kubernetes_tpu_torch.ops import tiebreak as ttiebreak
from kubernetes_tpu_torch.ops.encode import ClusterEncoder
from kubernetes_tpu_torch.ops.schema import Capacities


@pytest.fixture(scope="module", params=[1, 4])
def state(request):
    ds, pods, pb, et = jax_encoded(200, 48, request.param)
    nt, tpb, tet = to_port(ds, pb, et)
    return ds.nt, pb, et, nt, tpb, tet


def _eq(a, b, floats=False):
    a = np.asarray(a)
    b = b.numpy()
    if floats:
        np.testing.assert_array_equal(f32_bits(a), f32_bits(b))
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["eval_exprs", "filter_node_name", "filter_unschedulable",
                                  "filter_taints", "filter_node_affinity",
                                  "filter_node_ports"])
def test_filters_match(state, name):
    jnt, jpb, jet, nt, pb, et = state
    if name == "eval_exprs":
        _eq(jfilters.eval_exprs(jet, jnt), tfilters.eval_exprs(et, nt))
    elif name == "filter_node_affinity":
        _eq(jfilters.filter_node_affinity(jpb, jet, jnt),
            tfilters.filter_node_affinity(pb, et, nt))
    else:
        _eq(getattr(jfilters, name)(jpb, jnt), getattr(tfilters, name)(pb, nt))


def test_raw_scores_match(state):
    jnt, jpb, jet, nt, pb, et = state
    _eq(jscores.score_taint_toleration(jpb, jnt), tscores.score_taint_toleration(pb, nt), True)
    _eq(jscores.score_node_affinity(jpb, jet, jnt), tscores.score_node_affinity(pb, et, nt), True)
    img = tscores.score_image_locality(pb, nt)
    _eq(jscores.score_image_locality(jpb, jnt), img, True)
    assert (img.numpy() > 0).any()  # the image-locality term is exercised


@pytest.mark.parametrize("reverse", [False, True])
def test_normalize_default_matches(state, reverse):
    jnt, jpb, jet, nt, pb, et = state
    raw = tscores.score_node_affinity(pb, et, nt)
    feasible = tfilters.filter_taints(pb, nt)
    jraw = jnp.asarray(raw.numpy())
    jfeas = jnp.asarray(feasible.numpy())
    _eq(jscores.normalize_default(jraw, jfeas, reverse),
        tscores.normalize_default(raw, feasible, reverse), True)
    _eq(jbatch._normalize(jraw[0], jfeas[0], reverse),
        tbatch._normalize(raw[0], feasible[0], reverse), True)


def test_resource_scores_match():
    rng = np.random.RandomState(0)
    alloc = rng.choice([0, 3, 7, 1000, 4096, 32000], size=(512, 2)).astype(np.float32)
    nz = (alloc * rng.uniform(0, 1.3, size=alloc.shape)).astype(np.int32).astype(np.float32)
    ja, jb = jbatch._resource_scores(jnp.asarray(alloc), jnp.asarray(nz))
    ta, tb = tbatch._resource_scores(torch.from_numpy(alloc), torch.from_numpy(nz))
    _eq(ja, ta, True)
    _eq(jb, tb, True)


def test_jitter_table_bit_equal(state):
    jnt, jpb, jet, nt, pb, et = state
    _eq(jtiebreak.jitter_table(jpb.tie_seed, jnt.name_hash),
        ttiebreak.jitter_table(pb.tie_seed, nt.name_hash), True)
    # seeds and hashes across the whole uint32 range, including the top bit
    rng = np.random.RandomState(9)
    seeds = rng.randint(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    hashes = rng.randint(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32)
    seeds[:2] = [0, 2**32 - 1]
    _eq(jtiebreak.jitter_table(jnp.asarray(seeds), jnp.asarray(hashes)),
        ttiebreak.jitter_table(torch.from_numpy(seeds.view(np.int32)),
                               torch.from_numpy(hashes.view(np.int32))), True)


def test_pod_port_bits_match(state):
    jnt, jpb, jet, nt, pb, et = state
    words = nt.port_bits.shape[1]
    j = np.asarray(jbatch._pod_port_bits(jpb, words))
    t = u32(tbatch._pod_port_bits(pb, words))
    np.testing.assert_array_equal(j, t)
    assert j.any()


@pytest.mark.parametrize("n", [128, 130, 131])
def test_pack_unpack_block_match(n):
    rng = np.random.RandomState(n)
    idx = rng.randint(-1, n, size=16).astype(np.int32)
    ff = rng.randint(-3, 12, size=(16, n)).astype(np.int8)
    jp = np.asarray(jbatch.pack_result_block(jnp.asarray(idx), jnp.asarray(ff)))
    tp = tbatch.pack_result_block(torch.from_numpy(idx), torch.from_numpy(ff))
    assert jp.tobytes() == tp.numpy().tobytes()
    j_idx, j_ff, _, _ = jbatch.unpack_result_block(jp, n)
    t_idx, t_ff, t_slice, t_quota = tbatch.unpack_result_block(tp, n)
    assert t_slice is None and t_quota is None
    np.testing.assert_array_equal(j_idx, t_idx)
    np.testing.assert_array_equal(j_ff, t_ff)
    np.testing.assert_array_equal(t_ff, ff)


def test_encoders_agree():
    """The port's own encoder gives the JAX encoder's tensors for the same
    cluster and batch (every field, uint32 bits compared as uint32)."""
    jenc = JEncoder(JCaps(nodes=256, pods=64))
    tenc = ClusterEncoder(Capacities(nodes=256, pods=64), device="cpu")
    spec = cluster_spec(150, 21)
    jnt = jenc.encode_snapshot(build_nodes(jax_api(), spec))
    tnt = tenc.encode_snapshot(build_nodes(torch_api(), spec))
    pspec = pods_spec(40, 22)
    jpb, jet = jenc.encode_pods(build_pods(jax_api(), pspec))
    tpb, tet = tenc.encode_pods(build_pods(torch_api(), pspec))
    for jobj, tobj in ((jnt, tnt), (jpb, tpb), (jet, tet)):
        tn = tobj.to_numpy()
        for name, a in numpy_fields(jobj).items():
            np.testing.assert_array_equal(a, tn[name], err_msg=name)
            assert a.dtype == tn[name].dtype, name
