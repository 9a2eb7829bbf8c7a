"""SchedulingElastic (``kubernetes_tpu_torch/perf/workloads.py:Elastic``,
``elastic_rounds``) through the port's scheduler loop against the JAX loop
on the CPU, at the JAX test's small size (``tests/test_elastic.py:519-544``:
24 nodes, rounds 6, 12 pods per round, 3 drain nodes, 40 cycles per
round, tick 0.05 s), at ring depth 2 and 0.

``workloads.elastic_rounds`` drives both packages' loops (``LoopPair``,
FakeClocks), each evicting through its own package's drain orchestrator:
the storm drains 30% of the nodes, deletes them and adds nodes of new
names (the mirror's tombstoned slots reused), the rolling drain cordons
and evicts the last three nodes, the spot reclamation taints 15% of the
nodes NoExecute and deletes them. The ElasticInvariants equal the JAX
loop's, and so do the evictions by reason, the nodes left, and the
placements, queues and gang state. JAX's bar holds on the port: no pod
lost, no node oversubscribed, nothing pending; nodes removed and added,
slots reused, pods evicted; the mirror's node axis still
``caps_for_cluster(24).nodes``, and the second sync of the settled
snapshot uploads 0 bytes. ``run_loop_elastic`` (its own store and loop at
LOOP_BATCH) meets the same bar."""

import pytest

from _torch_cases import LoopPair, to_jax

SMALL = dict(nodes=24, rounds=6, pods_per_round=12, drain_nodes=3, cycles_per_round=40,
             tick_s=0.05)


@pytest.fixture(params=["2", "0"], ids=["depth2", "depth0"])
def depth(request, monkeypatch):
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", request.param)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    return request.param


def _assert_bar(inv: dict) -> None:
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster

    assert inv["LostPods"] == 0.0
    assert inv["Oversubscribed"] == 0.0
    assert inv["PendingAtEnd"] == 0.0
    assert inv["NodesRemoved"] > 0 and inv["NodesAdded"] > 0
    assert inv["SlotReuses"] > 0
    assert inv["EvictedPods"] > 0
    assert inv["RowCapacity"] == float(caps_for_cluster(SMALL["nodes"]).nodes)
    assert inv["UploadBytesSteady"] == 0.0


def test_elastic_matches_jax(depth):
    from kubernetes_tpu.controllers.drain import DrainOrchestrator as JDrain
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_elastic(**SMALL)
    pair = LoopPair(batch=32)
    for ni in w.node_infos():
        pair.jstore.create_node(to_jax(ni.node))
        pair.tstore.create_node(ni.node)
    jdrain = JDrain(pair.jstore, metrics=pair.jsched.smetrics, queue=pair.jsched.queue,
                    now_fn=pair.jclock)
    jout = workloads.elastic_rounds(w, pair.jstore, pair.jsched, pair.jclock, drain=jdrain,
                                    convert=to_jax)
    tout = workloads.elastic_rounds(w, pair.tstore, pair.tsched, pair.tclock)
    assert tout["invariants"] == jout["invariants"]
    assert tout["evicted"] == jout["evicted"]
    assert tout["nodes"] == jout["nodes"]
    assert tout["cycles"] == jout["cycles"]
    pair.assert_gang_equal()
    _assert_bar(tout["invariants"])
    assert tout["evicted"]["drain"] > 0 and tout["evicted"]["spot"] > 0


def test_run_loop_elastic_meets_the_bar():
    from kubernetes_tpu_torch.perf import workloads

    out = workloads.run_loop_elastic(workloads.scheduling_elastic(**SMALL), "cpu")
    _assert_bar(out["invariants"])
    assert all(out["placed"].values())
    assert set(n for n in out["placed"].values()) <= set(out["nodes"])
