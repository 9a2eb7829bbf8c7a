"""Scheduler extenders in the port against the JAX package.

First the three cases of ``tests/test_config_extenders.py`` (Filter and
Prioritize, a binder, an ignorable failure), each through both packages'
``scheduler_from_config``: the JAX sequential ``Scheduler`` and the port's
loop with a pass-through out-of-tree Filter in its profile, which sends its
pods down the port's sequential path. Then the loop cases through
``LoopPair`` with a config and an in-process ``workloads.LoopExtender``
per package (Filter drops node-i with i % 7 == 0, Prioritize favours the
upper half of the nodes, Bind binds through the store, ProcessPreemption
keeps every other candidate): an unbatchable profile's pods honour Filter
and Prioritize; every pod binds through the binder; a non-ignorable error
fails the cycle to the backoff queue and an ignorable one is skipped;
preemption's trimmed candidates and victims; and ROADMAP C22, where a pod
of a batchable profile rides the batch past the Filter in both packages.
Last, the same extender behind a local HTTP server (``HTTPExtender``).
Placements, loop state and the calls per verb must equal JAX's."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import (LoopPair, build_nodes, build_pods, cluster_spec, jax_api,  # noqa: E402
                          pods_spec, torch_api)

from kubernetes_tpu_torch.perf import workloads  # noqa: E402

N_NODES = 14


@pytest.fixture(autouse=True)
def _sync(monkeypatch):
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")


# -------------------------------------------------------------- the three JAX cases


class _JaxPass:
    """A Filter that passes every node (JAX interface)."""

    def __init__(self, handle, args):
        pass

    def name(self):
        return "Pass"

    def filter(self, state, pod, node_info):
        from kubernetes_tpu.framework.interface import OK

        return OK


class _Pass:
    """A Filter that passes every node (the port's interface): a profile
    holding it is not batchable, so its pods take the sequential path."""

    def __init__(self, handle, args):
        pass

    def name(self):
        return "Pass"

    def filter(self, state, pod, node_info):
        return None


SEQUENTIAL = {"apiVersion": "kubescheduler.config.k8s.io/v1beta3", "profiles": [{
    "schedulerName": "default-scheduler",
    "plugins": {"filter": {"enabled": [{"name": "Pass"}]}}}]}


def _sequential_pair(make_extender):
    """A JAX store under the JAX sequential ``Scheduler`` and a port store
    under the port's loop, three nodes of 4 cpu each, one pod of 100m;
    ``make_extender(store, package)`` gives each side's extender."""
    from kubernetes_tpu.api.wrappers import make_node as jmake_node
    from kubernetes_tpu.api.wrappers import make_pod as jmake_pod
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.config import Extender as JExtender
    from kubernetes_tpu.config import load_config as jload
    from kubernetes_tpu.config import scheduler_from_config as jfrom_config
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.config import Extender, load_config, scheduler_from_config

    jstore, tstore = ClusterStore(), Store()
    for i in range(3):
        cap = {"cpu": "4", "memory": "8Gi", "pods": 10}
        jstore.create_node(jmake_node(f"n{i}").capacity(cap).obj())
        tstore.create_node(make_node(f"n{i}").capacity(cap).obj())
    jcfg, tcfg = jload(SEQUENTIAL), load_config(SEQUENTIAL)
    jcfg.extenders.append(JExtender(instance=make_extender(jstore, "kubernetes_tpu")))
    tcfg.extenders.append(Extender(instance=make_extender(tstore, "kubernetes_tpu_torch")))
    jsched = jfrom_config(jstore, jcfg, out_of_tree_registry={"Pass": _JaxPass})
    tsched = scheduler_from_config(tstore, tcfg, out_of_tree_registry={"Pass": _Pass},
                                   scheduler_cls=TPUScheduler, device="cpu",
                                   batch_deadline_ms=0)
    jstore.create_pod(jmake_pod("p").req({"cpu": "100m"}).obj())
    tstore.create_pod(make_pod("p").req({"cpu": "100m"}).obj())
    jsched.run_until_settled()
    tsched.run_until_settled()
    assert tsched.fallback_scheduled == tsched.metrics["scheduled"]  # the sequential path
    return jstore, tstore, jsched, tsched


def _callable(pkg: str, **kw):
    import importlib

    return importlib.import_module(f"{pkg}.scheduler.extender").CallableExtender(**kw)


def test_extender_filter_and_prioritize():
    """The extender drops n0 and its score (x weight 100) makes n2 win."""
    seen = {}

    def make(store, pkg):
        calls = seen.setdefault(pkg, [])

        def filt(pod, nodes):
            calls.append(("filter", tuple(n.meta.name for n in nodes)))
            return [n for n in nodes if n.meta.name != "n0"], {"n0": "extender says no"}

        def prio(pod, nodes):
            calls.append(("prioritize", tuple(n.meta.name for n in nodes)))
            return {n.meta.name: (10 if n.meta.name == "n2" else 0) for n in nodes}

        return _callable(pkg, filter_fn=filt, prioritize_fn=prio, weight=100)

    jstore, tstore, _, _ = _sequential_pair(make)
    assert tstore.get_pod("default/p").spec.node_name == \
        jstore.get_pod("default/p").spec.node_name == "n2"
    assert seen["kubernetes_tpu_torch"] == seen["kubernetes_tpu"]


def test_extender_binder():
    """The binder extender binds the pod (through its store)."""
    bound = {}

    def make(store, pkg):
        def bind(pod, node_name):
            bound.setdefault(pkg, {})[pod.key()] = node_name
            if pkg == "kubernetes_tpu":
                from kubernetes_tpu.api.types import Binding

                store.bind(Binding(pod_key=pod.key(), node_name=node_name))
            else:
                store.bind(pod.key(), node_name)

        return _callable(pkg, bind_fn=bind)

    jstore, tstore, _, _ = _sequential_pair(make)
    assert bound["kubernetes_tpu_torch"] == bound["kubernetes_tpu"]
    assert tstore.get_pod("default/p").spec.node_name == \
        jstore.get_pod("default/p").spec.node_name


def test_ignorable_extender_failure_is_tolerated():
    """An ignorable extender whose Filter fails is skipped."""
    def make(store, pkg):
        import importlib

        err = importlib.import_module(f"{pkg}.scheduler.extender").ExtenderError

        def bad_filter(pod, nodes):
            raise err("down")

        return _callable(pkg, filter_fn=bad_filter, ignorable=True)

    jstore, tstore, _, _ = _sequential_pair(make)
    assert tstore.get_pod("default/p").spec.node_name == \
        jstore.get_pod("default/p").spec.node_name != ""


# -------------------------------------------------------------- through both loops


def _binder(store, pkg: str):
    """``bind(pod key, node)`` through ``store``, in its package's form."""
    if pkg == "kubernetes_tpu":
        from kubernetes_tpu.api.types import Binding

        return lambda key, node: store.bind(Binding(pod_key=key, node_name=node))
    return store.bind


class _FailingFilter(workloads.LoopExtender):
    """A ``LoopExtender`` whose Filter raises its package's ExtenderError."""

    def __init__(self, error, ignorable, *args, **kw):
        super().__init__(*args, **kw)
        self.error = error
        self._ignorable = ignorable

    def filter(self, pod, nodes):
        self.calls["filter"] += 1
        raise self.error("extender down")


def _loop_extenders(preempt=False, bind=True, failing=False, ignorable=False):
    """``LoopPair``'s ``extenders``: a ``LoopExtender`` per package (kept on
    the pair as ``pair.ext``, JAX's first), binding through its store."""
    import importlib

    def make(pair):
        exts = []
        for store, pkg in ((pair.jstore, "kubernetes_tpu"), (pair.tstore, "kubernetes_tpu_torch")):
            args = (N_NODES, _binder(store, pkg) if bind else None)
            if failing:
                error = importlib.import_module(f"{pkg}.scheduler.extender").ExtenderError
                exts.append(_FailingFilter(error, ignorable, *args, preempt=preempt))
            else:
                exts.append(workloads.LoopExtender(*args, preempt=preempt))
        pair.ext = exts
        return exts[0:1], exts[1:2]

    return make


def _config(*names):
    return workloads.profiles_config(*names)


def _add_cluster(pair, seed: int, n_pods: int, names=("default-scheduler",)):
    spec = cluster_spec(N_NODES, seed)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(n_pods, seed + 1)
    pods_j, pods_t = build_pods(jax_api(), pods), build_pods(torch_api(), pods)
    for i, (pj, pt) in enumerate(zip(pods_j, pods_t)):
        pj.spec.scheduler_name = pt.spec.scheduler_name = names[i % len(names)]
    pair.add_pods(pods_j, pods_t)


def _calls_equal(pair):
    assert pair.ext[1].calls == pair.ext[0].calls
    return pair.ext[1].calls


def test_unbatchable_profile_honours_filter_and_prioritize():
    """Every pod on ``no-scoring`` takes the sequential path: none lands on a
    node the Filter drops, and the extender's score, the only one, sends
    each to the upper half where it fits."""
    pair = LoopPair(config=_config("default-scheduler", "no-scoring"),
                    extenders=_loop_extenders(bind=False))
    _add_cluster(pair, seed=21, n_pods=24, names=("no-scoring",))
    pair.settle()
    got = pair.assert_equal()
    calls = _calls_equal(pair)
    placed = [n for k, n in got["placed"].items() if k.startswith("default/pod-") and n]
    assert placed and not any(workloads.filtered_by_extender(n) for n in placed)
    assert calls["filter"] >= len(placed) and calls["prioritize"] > 0 and calls["bind"] == 0
    assert pair.tsched.fallback_scheduled == len(placed)


def test_every_pod_binds_through_the_binder():
    """Batch pods and sequential pods alike bind through the binder
    extender, before the Bind plugins."""
    pair = LoopPair(config=_config("default-scheduler", "no-scoring"),
                    extenders=_loop_extenders())
    _add_cluster(pair, seed=22, n_pods=32, names=("default-scheduler", "no-scoring"))
    pair.settle()
    got = pair.assert_equal()
    calls = _calls_equal(pair)
    bound = [k for k, n in got["placed"].items() if k.startswith("default/pod-") and n]
    assert calls["bind"] == len(bound) > 16
    assert 0 < pair.tsched.fallback_scheduled < len(bound)


@pytest.mark.parametrize("ignorable", [False, True], ids=["fails_the_cycle", "ignorable"])
def test_filter_error(ignorable):
    """A Filter that raises ExtenderError: from a non-ignorable extender the
    sequential pods' cycles fail to the backoff queue (counted as errors),
    from an ignorable one the extender is skipped and they bind."""
    pair = LoopPair(config=_config("default-scheduler", "no-scoring"),
                    extenders=_loop_extenders(ignorable=ignorable, failing=True))
    _add_cluster(pair, seed=23, n_pods=8, names=("no-scoring",))
    pair.settle()
    got = pair.assert_equal()
    _calls_equal(pair)
    assert pair.tsched.metrics["errors"] == pair.jsched.metrics["errors"]
    seq = [n for k, n in got["placed"].items() if k.startswith("default/pod-")]
    if ignorable:
        assert pair.tsched.metrics["errors"] == 0 and any(seq)
    else:
        assert pair.tsched.metrics["errors"] == 8 and not any(seq)
        assert got["pending"]["backoff"] == 8


def _preemption_nodes(api, n: int):
    """PreemptionBasic's nodes, each full of four priority-1 victims."""
    infos = []
    for i in range(n):
        ni = api.NodeInfo(api.make_node(f"node-{i}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": 32}).obj())
        for j in range(4):
            pod = api.make_pod(f"victim-{i}-{j}").req({"cpu": "900m", "memory": "2Gi"}) \
                .priority(1).obj()
            pod.spec.node_name = ni.node.meta.name
            pod.status.start_time = float(j)
            ni.add_pod(pod)
        infos.append(ni)
    return infos


@pytest.mark.parametrize("profile", ["default-scheduler", "no-scoring"])
def test_preemption_through_the_extender(profile):
    """Preemptors on full nodes: the extender trims the candidate map (every
    other node kept) on the device's preferred node and after the walk;
    victims, nominations and placements equal JAX's."""
    pair = LoopPair(config=_config("default-scheduler", "no-scoring"),
                    extenders=_loop_extenders(preempt=True, bind=False))
    pair.add_nodes(_preemption_nodes(jax_api(), N_NODES), _preemption_nodes(torch_api(), N_NODES))

    def preemptors(api):
        return [api.make_pod(f"preemptor-{i}").req({"cpu": "2", "memory": "4Gi"})
                .priority(100).scheduler_name(profile).obj() for i in range(10)]

    pair.add_pods(preemptors(jax_api()), preemptors(torch_api()))
    for _ in range(3):
        pair.settle()
        pair.advance(2.0)
    pair.settle()
    got = pair.assert_equal()
    calls = _calls_equal(pair)
    assert calls["preempt"] > 0 and got["nominated"]
    assert all(got["placed"][f"default/preemptor-{i}"] for i in range(10))


def test_c22_batch_pod_rides_past_the_filter():
    """ROADMAP C22, kept from the JAX loop: a pod of a batchable profile
    never meets the extender's Filter or Prioritize, so big-0 lands on
    node-0, the only node that fits it, which the Filter drops. On the
    sequential path the Filter holds: big-1 (PreemptionPolicy Never) stays
    pending. big-2 fails the same way, but its PostFilter nominates node-0
    (no victim is needed there: the dry run does not ask the Filter), and
    its retry takes the nominated-node fast path, which returns before the
    extenders in JAX (upstream runs them there too), so it lands on node-0
    as well. Each package's outcome is asserted."""
    pair = LoopPair(config=_config("default-scheduler", "no-scoring"),
                    extenders=_loop_extenders(bind=False))

    def nodes(api):
        return [api.NodeInfo(api.make_node(f"node-{i}").capacity(
            {"cpu": "12" if i == 0 else "1", "memory": "16Gi", "pods": 32}).obj())
            for i in range(3)]

    def pods(api):
        out = [api.make_pod(f"big-{i}").req({"cpu": "4"}).scheduler_name(name).obj()
               for i, name in enumerate(("default-scheduler", "no-scoring", "no-scoring"))]
        out[1].spec.preemption_policy = "Never"
        return out

    pair.add_nodes(nodes(jax_api()), nodes(torch_api()))
    pair.add_pods(pods(jax_api()), pods(torch_api()))
    pair.settle()
    pair.advance(2.0)
    pair.settle()
    got = pair.assert_equal()
    for store in (pair.jstore, pair.tstore):
        assert [store.get_pod(f"default/big-{i}").spec.node_name for i in range(3)] == [
            "node-0", "", "node-0"]
    assert got["nominated"] == {"default/big-2": "node-0"}
    calls = _calls_equal(pair)
    assert calls["filter"] >= 2 and calls["prioritize"] == 0


def test_http_extender_on_a_local_server():
    """The same extender behind a ``ThreadingHTTPServer`` on 127.0.0.1, one
    per package's store, each loop's ``HTTPExtender`` built by its
    package's ``build_extenders`` from a config entry naming the urlPrefix
    and all four verbs: placements, loop state and calls per verb equal
    JAX's, and every pod binds through the wire."""
    import importlib

    servers, exts = [], []

    def make(pair):
        out = []
        for store, pkg in ((pair.jstore, "kubernetes_tpu"), (pair.tstore, "kubernetes_tpu_torch")):
            ext = workloads.LoopExtender(N_NODES, _binder(store, pkg), preempt=True)
            server, url = workloads.serve_extender(ext)
            servers.append(server)
            exts.append(ext)
            e = workloads.extender_config(url)
            config = importlib.import_module(f"{pkg}.config")
            out.append(importlib.import_module(f"{pkg}.scheduler.extender").build_extenders([
                config.Extender(url_prefix=e["urlPrefix"], filter_verb=e["filterVerb"],
                                prioritize_verb=e["prioritizeVerb"], bind_verb=e["bindVerb"],
                                preempt_verb=e["preemptVerb"], weight=e["weight"])]))
        pair.ext = exts
        return out[0], out[1]

    try:
        pair = LoopPair(config=_config("default-scheduler", "no-scoring"), extenders=make)
        assert [type(e).__name__ for e in pair.tsched.extenders] == ["HTTPExtender"]
        _add_cluster(pair, seed=24, n_pods=12, names=("no-scoring", "default-scheduler"))
        pair.settle()
        got = pair.assert_equal()
        calls = _calls_equal(pair)
        assert calls["bind"] == sum(
            1 for k, n in got["placed"].items() if k.startswith("default/pod-") and n) > 0
        assert calls["filter"] > 0 and calls["prioritize"] > 0
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
