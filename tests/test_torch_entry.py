"""The port's entry points (``kubernetes_tpu_torch/entry.py``) against the JAX
package's (``__graft_entry__.py``) on the CPU.

* ``entry(device="cpu")``: its ``fn(*args)`` equals JAX ``entry()``'s on
  the winners, the first-fail table and every carry, ``best_score`` to the
  bit.
* ``dryrun_multichip(W, device="cpu")`` for W in 2 and 4 (``gloo`` ranks):
  its own checks pass, and each of its runs equals JAX's
  ``make_sharded_schedule_fn`` on ``make_node_mesh(jax.devices()[:W])``
  over the JAX dryrun's inputs. JAX's ``dryrun_multichip`` itself is not
  called: it forces its process's platform. The port's dryruns run in a
  background thread while the JAX side computes.
* Without a card, ``device=None`` raises.
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from _torch_cases import f32_bits, u32
from kubernetes_tpu.parallel import (make_node_mesh, make_sharded_schedule_fn,
                                     shard_node_tensors, shard_topo_counts)
from kubernetes_tpu_torch import entry as tentry

WORLDS = (2, 4)
DRYRUN_TIMEOUT_S = 300.0


def test_entry_equals_jax_entry():
    jfn, jargs = jentry.entry()
    want = jfn(*jargs)
    fn, args = tentry.entry(device="cpu")
    got = fn(*args)
    for name in ("node_idx", "any_feasible", "first_fail", "fit_ok", "ports_ok", "spread_ok",
                 "ipa_ok", "final_requested", "final_nonzero", "final_class_req",
                 "final_sel_counts", "final_seg_exist"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(u32(got.final_ports), np.asarray(want.final_ports))
    np.testing.assert_array_equal(f32_bits(got.best_score), f32_bits(want.best_score))
    assert (got.node_idx.numpy() >= 0).all()


@pytest.fixture(scope="module")
def dryruns():
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {w: pool.submit(tentry.dryrun_multichip, w, "cpu", None, DRYRUN_TIMEOUT_S)
               for w in WORLDS}
    yield futures
    pool.shutdown(wait=True, cancel_futures=True)


def _jax_host_inputs(n_nodes):
    """Program 4's inputs as the JAX dryrun builds them."""
    from kubernetes_tpu.api.types import LabelSelector
    from kubernetes_tpu.api.wrappers import make_node, make_pod
    from kubernetes_tpu.backend.sig_table import SigTable
    from kubernetes_tpu.framework.plugins.podtopologyspread import HOSTNAME_KEY
    from kubernetes_tpu.framework.types import NodeInfo
    from kubernetes_tpu.ops.encode import ClusterEncoder
    from kubernetes_tpu.ops.schema import Capacities

    infos = [NodeInfo(make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "32Gi", "pods": 110}).label(HOSTNAME_KEY, f"node-{i}").obj())
        for i in range(n_nodes)]
    enc = ClusterEncoder(Capacities(nodes=n_nodes, pods=32, value_words=32))
    sig = SigTable(enc)
    nt = enc.encode_snapshot(infos)
    sel = LabelSelector(match_labels={"color": "red"})
    pods = []
    for i in range(32):
        pw = make_pod(f"h{i}").req({"cpu": "250m", "memory": "512Mi"}).label("color", "red")
        pw.spread_constraint(1, HOSTNAME_KEY, selector=sel)
        if i % 2 == 0:
            pw.pod_affinity(HOSTNAME_KEY, sel, anti=True)
        pods.append(pw.obj())
    pb, et = enc.encode_pods(pods)
    tb = sig.encode_topo(pods)
    return nt, pb, et, sig.topo_counts(), tb, enc.key_slot(HOSTNAME_KEY)


@functools.lru_cache(maxsize=None)
def _jax_runs(world):
    """Each dryrun run's node_idx from JAX's sharded program at ``world``."""
    n_nodes = 32 * world
    inputs = {"topo": jentry._build_inputs(n_nodes, 64),
              "anti": jentry._build_affinity_inputs(n_nodes, 64),
              "off": jentry._build_inputs(n_nodes, 64),
              "host": _jax_host_inputs(n_nodes)}
    mesh = make_node_mesh(jax.devices()[:world])
    out = {}
    for name, which, kw in tentry.DRYRUN_RUNS:
        nt, pb, et, tc, tb = inputs[which][:5]
        if which == "host":
            kw = dict(kw, host_key=inputs["host"][5])
        res = make_sharded_schedule_fn(mesh, **kw)(
            pb, et, shard_node_tensors(nt, mesh), shard_topo_counts(tc, mesh), tb,
            jax.random.PRNGKey(0))
        out[name] = np.asarray(res.node_idx)
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_multichip_matches_jax(dryruns, world):
    want = _jax_runs(world)
    got = dryruns[world].result(timeout=DRYRUN_TIMEOUT_S * len(WORLDS))
    for name, _which, _kw in tentry.DRYRUN_RUNS:
        np.testing.assert_array_equal(got["node_idx"][name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["node_idx"]["host_single"], want["host_rounds"])
    assert len(got["ranks"]) == world
    for rank in got["ranks"]:
        assert [r["collectives"] for r in rank] == [r["collectives"] for r in got["ranks"][0]]
        assert all(r["fused_launches"] == 0 and r["collectives"] > 0 for r in rank)


def test_entry_points_need_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(2)
