"""The port's sequential path (``Scheduler.schedule_one_pod`` of the
port's ``TPUScheduler`` on the CPU) against the JAX package's
``Scheduler.schedule_one_pod`` on seeded clusters, pod by pod: the
same stores (``_torch_cases.LoopPair``), the same pod popped on each
side, then the sequential cycle on both. Per pod the nodes its filters
found feasible (in the order found), its Diagnosis (each failing node's
reason, the failed plugins, the nodes whose status is unresolvable) or
the PreFilter's failure, and afterwards the whole loop state
(``LoopPair.assert_equal``: placements, nominations, counters, queue)
must be equal. The cases: the main path's filters and scores on a
heterogeneous cluster; spread and inter-pod (anti-)affinity pods, whose
PreScores walk the cluster; pods nominated to a node (the nominated node
first) and a node restriction (matchFields); and percentage-sampled
filtering on 120 and 250 nodes, where the start rotates across pods
(sampling needs 100 nodes or more)."""

import pytest

from _torch_cases import (LoopPair, build_nodes, build_pods, build_topo_nodes, build_topo_pods,
                          cluster_spec, jax_api, pods_spec, topo_cluster_spec, topo_pods_spec,
                          torch_api)


@pytest.fixture(autouse=True)
def _sync(monkeypatch):
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")


def _record(sched, log, jax: bool):
    """Wrap ``find_nodes_that_fit_pod`` to append, per call, the feasible
    nodes and the Diagnosis (or the PreFilter's FitError)."""
    find = sched.find_nodes_that_fit_pod

    def diagnosis(d):
        if jax:
            status = {n: ", ".join(st.reasons) for n, st in d.node_to_status.items()}
            unresolvable = {n for n, st in d.node_to_status.items() if st.code == 3}
        else:
            status, unresolvable = dict(d.node_to_status), set(d.unresolvable)
        return status, set(d.unschedulable_plugins), unresolvable

    def recorded(*args):
        try:
            out = find(*args)
        except Exception as err:  # the PreFilter's FitError
            log.append(("prefilter", diagnosis(err.diagnosis)))
            raise
        log.append(([ni.node.meta.name for ni in out[0]], diagnosis(out[1])))
        return out

    sched.find_nodes_that_fit_pod = recorded


def _drive(pair: LoopPair, starts=None) -> list:
    """Pop one pod per side and run the sequential cycle until both queues
    are empty, the rotating start equal after every pod (appended to
    ``starts``); returns the port's records."""
    logs = ([], [])
    _record(pair.jsched, logs[0], True)
    _record(pair.tsched, logs[1], False)
    steps = 0
    while True:
        popped = [s.queue.pop_batch(1) for s in (pair.jsched, pair.tsched)]
        assert [[qp.pod.key() for qp in p] for p in popped[:1]] == \
            [[qp.pod.key() for qp in p] for p in popped[1:]]
        if not popped[0]:
            break
        for sched, (qp,) in zip((pair.jsched, pair.tsched), popped):
            qp.pod = sched.store.get_pod(qp.pod.key())
            sched.schedule_one_pod(qp, sched.queue.scheduling_cycle)
        assert logs[1] == logs[0], steps
        assert pair.tsched.next_start_node_index == pair.jsched.next_start_node_index
        if starts is not None:
            starts.append(pair.tsched.next_start_node_index)
        steps += 1
    pair.assert_equal()
    return logs[1]


def _cluster(n_nodes: int, seed: int, percentage: int = 0, nominate: str = "",
             n_pods: int = 40) -> LoopPair:
    pair = LoopPair(batch=16, percentage=percentage)
    spec = cluster_spec(n_nodes, seed)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(n_pods, seed + 1, nominate=nominate)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    return pair


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain(seed):
    """The main path's filters and every default score on a heterogeneous
    cluster of 12 nodes; the last of its 128 pods fit nowhere (their
    Diagnosis)."""
    log = _drive(_cluster(12, seed, n_pods=128))
    assert any(len(feasible) > 1 for feasible, _d in log)
    assert any(not feasible for feasible, _d in log)


@pytest.mark.parametrize("seed", [0, 1])
def test_topology(seed):
    """Spread constraints (DoNotSchedule and ScheduleAnyway) and inter-pod
    (anti-)affinity, required and preferred, on 32 nodes."""
    pair = LoopPair(batch=16)
    keys = ("topology.kubernetes.io/zone", "kubernetes.io/hostname")
    spec = topo_cluster_spec(32, seed, keys)
    pair.add_nodes(build_topo_nodes(jax_api(), spec), build_topo_nodes(torch_api(), spec))
    pods = topo_pods_spec(48, seed + 1, keys)
    pair.add_pods(build_topo_pods(jax_api(), pods), build_topo_pods(torch_api(), pods))
    log = _drive(pair)
    assert any(len(feasible) > 1 for feasible, _d in log)


def test_nominated_and_restricted():
    """A pod nominated to a node takes it first when it fits; a pod whose
    required terms name nodes by matchFields is restricted to them."""
    from kubernetes_tpu.api.types import NodeSelectorTerm as JTerm
    from kubernetes_tpu_torch.api.types import NodeSelectorTerm as TTerm

    pair = _cluster(24, 3, nominate="node-4")
    for api, store, term in ((jax_api(), pair.jstore, JTerm), (torch_api(), pair.tstore, TTerm)):
        pw = api.make_pod("pinned").req({"cpu": "100m"}).priority(200)
        for name in ("node-7", "node-9"):
            pw._add_required_node_term(term(match_fields_name=name))
        store.create_pod(pw.obj())
    log = _drive(pair)
    assert (["node-4"], ({}, set(), set())) in log
    assert pair.tstore.get_pod("default/pod-4-1").spec.node_name == "node-4"
    assert pair.tstore.get_pod("default/pinned").spec.node_name in ("node-7", "node-9")
    assert log[0][0] in (["node-7", "node-9"], ["node-9", "node-7"])


@pytest.mark.parametrize("nodes,percentage", [(120, 20), (250, 50)])
def test_percentage_sampled(nodes, percentage):
    """``num_feasible_nodes_to_find`` stops the walk early (at 100 nodes,
    its floor, and at half of 250), and the next pod starts where the last
    one's walk ended."""
    from kubernetes_tpu_torch.scheduler.scheduler import num_feasible_nodes_to_find

    pair = _cluster(nodes, 4, percentage=percentage)
    starts = []
    log = _drive(pair, starts)
    want = num_feasible_nodes_to_find(nodes, percentage)
    assert want == max(100, nodes * percentage // 100) < nodes
    # a walk that stopped at ``want`` feasible nodes checked fewer than all
    assert any(len(feasible) == want and len(feasible) + len(d[0]) < nodes
               for feasible, d in log if feasible != "prefilter")
    assert len(set(starts)) > 2
