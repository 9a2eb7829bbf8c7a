"""The port's drain orchestrator (``kubernetes_tpu_torch/controllers/
drain.py``) and the taint manager's eviction (``controllers/
nodelifecycle.py``) against the JAX package's on the CPU, in the cases of
``tests/test_elastic.py:237-488``.

Each case writes the same cluster to both packages' stores (a ``LoopPair``
where a scheduler loop places the pods: both loops on the CPU, FakeClocks),
runs the same drain operation through each package's orchestrator, and
holds the two stores equal after it (every pod's node, every node's
``unschedulable`` and taints), with the JAX test's own assertions on the
port's side: the cordon's dual write and its idempotence, a drain wave
that evicts a gang whole (members on healthy nodes included) and lets it
bind again whole, a spot reclamation through the taint manager that honours
an unbounded toleration and, with the nodes deleted, evicts every pod; the
PodDisruptionBudget deferral and the later sweep that takes the deferred
pod once the budget allows; one wave charging one budget per eviction;
and the NoExecute eviction of a node whose unreachable taint outlived the
admission-stamped 300 s toleration, an unbounded toleration keeping its
pod (the JAX case drives it through ``NodeLifecycleController``, which the
port does not have: here the taint is set on the node and the eviction
called)."""

import dataclasses

import pytest

from _torch_cases import LoopPair, jax_api, to_jax, torch_api


def _nodes(api, n, cap="8"):
    return [api.make_node(f"n{i}").capacity({"cpu": cap, "memory": "16Gi", "pods": 20}).obj()
            for i in range(n)]


def _store_view(store) -> dict:
    return {"pods": {k: p.spec.node_name for k, p in store.pods.items()},
            "nodes": {n: (node.spec.unschedulable,
                          tuple((t.key, t.effect) for t in node.spec.taints))
                      for n, node in store.nodes.items()}}


def _drainers(pair):
    from kubernetes_tpu.controllers.drain import DrainOrchestrator as JDrain
    from kubernetes_tpu_torch.controllers.drain import DrainOrchestrator

    return (JDrain(pair.jstore, metrics=pair.jsched.smetrics, queue=pair.jsched.queue,
                   now_fn=pair.jclock),
            DrainOrchestrator(pair.tstore, metrics=pair.tsched.smetrics, queue=pair.tsched.queue,
                              now_fn=pair.tclock))


def _pair(n_nodes, cap="8") -> LoopPair:
    pair = LoopPair(batch=16)
    for jn, tn in zip(_nodes(jax_api(), n_nodes, cap), _nodes(torch_api(), n_nodes, cap)):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)
    return pair


def _both(pair, build):
    """``build(api)`` -> pods, created in both stores."""
    pair.add_pods(build(jax_api()), build(torch_api()))


def _assert_stores_equal(pair) -> dict:
    want, got = _store_view(pair.jstore), _store_view(pair.tstore)
    assert got == want
    return got


def test_cordon_writes_unschedulable_and_taint():
    from kubernetes_tpu_torch.controllers.drain import TAINT_UNSCHEDULABLE

    pair = _pair(1)
    for d in _drainers(pair):
        assert d.cordon("n0")
        assert not d.cordon("n0")  # idempotent
    _assert_stores_equal(pair)
    node = pair.tstore.nodes["n0"]
    assert node.spec.unschedulable
    assert any(t.key == TAINT_UNSCHEDULABLE and t.effect == "NoSchedule"
               for t in node.spec.taints)
    for d in _drainers(pair):
        assert d.uncordon("n0")
        assert not d.uncordon("n0")
    _assert_stores_equal(pair)
    node = pair.tstore.nodes["n0"]
    assert not node.spec.unschedulable
    assert not any(t.key == TAINT_UNSCHEDULABLE for t in node.spec.taints)


def test_drain_wave_evicts_whole_gang_atomically():
    pair = _pair(4, cap="2")
    pair.add_pod_group("g", 3, timeout_s=30)
    _both(pair, lambda api: [api.make_pod(f"g-{i}").req({"cpu": "1"}).pod_group("g").obj()
                             for i in range(3)] + [api.make_pod("solo").req({"cpu": "1"}).obj()])
    pair.settle()
    bound = _assert_stores_equal(pair)["pods"]
    assert all(bound.values()) and len(bound) == 4
    gang_nodes = {bound[f"default/g-{i}"] for i in range(3)}
    assert len(gang_nodes) > 1  # spread over several nodes
    victim_node = bound["default/g-0"]
    summaries = [d.drain_wave([victim_node]) for d in _drainers(pair)]
    assert summaries[1] == summaries[0]
    assert summaries[1]["gangs"] == 1
    for store in (pair.jstore, pair.tstore):
        for i in range(3):
            p = store.get_pod(f"default/g-{i}")
            assert p is not None and not p.spec.node_name
    _assert_stores_equal(pair)
    assert pair.tsched.smetrics.evicted_pods.labels("drain") >= 3
    for d in _drainers(pair):
        d.uncordon(victim_node)
    pair.advance(11.0)
    pair.settle()
    placed = _assert_stores_equal(pair)["pods"]
    assert sum(1 for k, n in placed.items() if k.startswith("default/g-") and n) == 3
    pair.assert_gang_equal()


def _spot_pods(api, toleration_cls):
    shielded = api.make_pod("shielded").req({"cpu": "1"}).obj()
    shielded.spec.tolerations = (toleration_cls(
        key="node.kubernetes.io/spot-reclaiming", operator="Exists", effect="NoExecute"),)
    return [api.make_pod("plain").req({"cpu": "1"}).obj(), shielded]


def test_spot_reclaim_rides_taint_manager_and_respects_tolerations():
    from kubernetes_tpu.api.types import Toleration as JToleration
    from kubernetes_tpu_torch.api.types import Toleration
    from kubernetes_tpu_torch.controllers.drain import TAINT_SPOT_RECLAIM

    pair = _pair(2)
    pair.add_pods(_spot_pods(jax_api(), JToleration), _spot_pods(torch_api(), Toleration))
    pair.settle()
    used = set(_assert_stores_equal(pair)["pods"].values())
    drainers = _drainers(pair)
    summaries = [d.spot_reclaim(sorted(d.store.nodes)) for d in drainers]
    assert summaries[1] == summaries[0]
    store = pair.tstore
    reclaimed = {n for n, node in store.nodes.items()
                 if any(t.key == TAINT_SPOT_RECLAIM for t in node.spec.taints)}
    assert reclaimed == set(store.nodes) and used <= reclaimed
    plain = store.get_pod("default/plain")
    assert plain is not None and not plain.spec.node_name  # recreated unbound
    assert store.get_pod("default/shielded").spec.node_name
    assert summaries[1]["evicted"] == 1
    assert pair.tsched.smetrics.evicted_pods.labels("spot") == 1
    _assert_stores_equal(pair)
    # the capacity goes: a toleration cannot keep a pod on deleted hardware
    for d in drainers:
        d.spot_reclaim(sorted(d.store.nodes), delete_nodes=True)
    assert not store.nodes
    shielded = store.get_pod("default/shielded")
    assert shielded is not None and not shielded.spec.node_name
    assert all(not p.spec.node_name for p in store.pods.values())
    _assert_stores_equal(pair)
    assert (pair.tsched.smetrics.evicted_pods.labels("spot")
            == pair.jsched.smetrics.evicted_pods.labels("spot"))


def _pdb(ns_app: str, allowed: int):
    from kubernetes_tpu_torch.api.types import LabelSelector, ObjectMeta, PodDisruptionBudget

    return PodDisruptionBudget(meta=ObjectMeta(name="db-pdb", namespace="default"),
                               selector=LabelSelector(match_labels={"app": ns_app}),
                               disruptions_allowed=allowed)


def test_spot_reclaim_defers_to_pdb_budget():
    from kubernetes_tpu.controllers.nodelifecycle import evict_noexecute_pods as jevict
    from kubernetes_tpu_torch.controllers.drain import TAINT_SPOT_RECLAIM
    from kubernetes_tpu_torch.controllers.nodelifecycle import evict_noexecute_pods

    pair = _pair(2)
    _both(pair, lambda api: [api.make_pod("guarded").req({"cpu": "1"}).label("app", "db").obj(),
                             api.make_pod("free").req({"cpu": "1"}).obj()])
    pair.settle()
    pdb = _pdb("db", 0)  # the budget is spent
    pair.jstore.create_pdb(to_jax(pdb))
    pair.tstore.create_pdb(pdb)
    drainers = _drainers(pair)
    summaries = [d.spot_reclaim(sorted(d.store.nodes)) for d in drainers]
    assert summaries[1] == summaries[0] and summaries[1]["evicted"] == 1
    store = pair.tstore
    guarded = store.get_pod("default/guarded")
    assert guarded is not None and guarded.spec.node_name  # deferred
    free = store.get_pod("default/free")
    assert free is not None and not free.spec.node_name
    node_name = guarded.spec.node_name
    assert any(t.key == TAINT_SPOT_RECLAIM for t in store.nodes[node_name].spec.taints)
    _assert_stores_equal(pair)
    # the budget recovers: the periodic sweep takes the deferred pod
    taken = []
    for d, evict, clock in zip(drainers, (jevict, evict_noexecute_pods),
                               (pair.jclock, pair.tclock)):
        old = d.store.pdbs["default/db-pdb"]
        new = dataclasses.replace(old, disruptions_allowed=1)
        new.meta = dataclasses.replace(old.meta)
        d.store.update_object("PodDisruptionBudget", new)
        taken.append([p.meta.name for p in evict(d.store, d.store.nodes[node_name], clock(),
                                                 since=None,
                                                 allow_fn=d._pdb_disruption_gate())])
    assert taken[1] == taken[0] == ["guarded"]
    _assert_stores_equal(pair)


def test_pdb_gate_charges_budget_within_one_wave():
    pair = _pair(3)
    _both(pair, lambda api: [api.make_pod(f"db-{i}").req({"cpu": "1"}).label("app", "db").obj()
                             for i in range(3)])
    pair.settle()
    pdb = _pdb("db", 1)
    pair.jstore.create_pdb(to_jax(pdb))
    pair.tstore.create_pdb(pdb)
    summaries = [d.spot_reclaim(sorted(d.store.nodes)) for d in _drainers(pair)]
    assert summaries[1] == summaries[0] and summaries[1]["evicted"] == 1
    still = [p for p in pair.tstore.pods.values()
             if p.spec.node_name and p.meta.labels.get("app") == "db"]
    assert len(still) == 2, "wave overdrew the disruption budget"
    _assert_stores_equal(pair)


def _tainted(node, taint_cls, key):
    new = dataclasses.replace(node)
    new.meta = dataclasses.replace(node.meta)
    new.spec = dataclasses.replace(node.spec, taints=node.spec.taints + (
        taint_cls(key=key, effect="NoExecute"),))
    return new


@pytest.mark.parametrize("late", [False, True], ids=["in-window", "past-window"])
def test_noexecute_eviction_honours_toleration_windows(late):
    """A pod bound to a node whose unreachable NoExecute taint went on at
    ``since`` stays while the admission-stamped 300 s window lasts, and is
    evicted past it; a pod with an unbounded toleration of the taint stays
    either way."""
    from kubernetes_tpu.api.types import Taint as JTaint
    from kubernetes_tpu.api.types import Toleration as JToleration
    from kubernetes_tpu.controllers.nodelifecycle import TAINT_UNREACHABLE as JUNREACHABLE
    from kubernetes_tpu.controllers.nodelifecycle import evict_noexecute_pods as jevict
    from kubernetes_tpu.metrics import SchedulerMetrics as JMetrics
    from kubernetes_tpu_torch.api.types import Taint, Toleration
    from kubernetes_tpu_torch.controllers.nodelifecycle import (TAINT_UNREACHABLE,
                                                                evict_noexecute_pods)
    from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics

    assert TAINT_UNREACHABLE == JUNREACHABLE
    pair = _pair(1)

    def pods(api, tol_cls):
        w = api.make_pod("w").req({"cpu": "1"}).obj()
        w.spec.node_name = "n0"
        tol = api.make_pod("tol").req({"cpu": "1"}).obj()
        tol.spec.node_name = "n0"
        tol.spec.tolerations = (tol_cls(key=TAINT_UNREACHABLE, operator="Exists",
                                        effect="NoExecute"),)
        return [w, tol]

    pair.add_pods(pods(jax_api(), JToleration), pods(torch_api(), Toleration))
    since = pair.tclock()
    out = []
    for store, taint_cls, evict, metrics in ((pair.jstore, JTaint, jevict, JMetrics()),
                                             (pair.tstore, Taint, evict_noexecute_pods,
                                              SchedulerMetrics())):
        store.update_node(_tainted(store.nodes["n0"], taint_cls, TAINT_UNREACHABLE))
        now = since + (301.0 if late else 60.0)
        taken = evict(store, store.nodes["n0"], now, since=since, metrics=metrics)
        out.append(([p.meta.name for p in taken], metrics.evicted_pods.labels("taint")))
    assert out[1] == out[0] == ((["w"], 1) if late else ([], 0))
    assert pair.tstore.get_pod("default/tol") is not None
    assert (pair.tstore.get_pod("default/w") is None) == late
    _assert_stores_equal(pair)
