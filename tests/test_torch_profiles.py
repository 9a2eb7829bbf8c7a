"""Profiles, the plugin registry, plugin args and out-of-tree plugins in the
port against the JAX package.

* The registry's names, ``DEFAULT_PLUGINS``, the extension points and the
  point each plugin object implements equal the JAX package's (MultiPoint
  expansion keeps an entry only where its plugin implements the point).
* For a table of configs, each profile's ``Framework`` has the JAX one's
  points (names, weights and order) and event map.
* The sequential path (``schedule_one_pod`` pod by pod, both loops built by
  their package's ``scheduler_from_config``) under custom profiles: no
  scoring, MostAllocated, RequestedToCapacityRatio, BalancedAllocation's
  resources, ``hard_pod_affinity_weight`` 5 with affinity pods,
  PodTopologySpread's ``default_constraints`` (and ``system_defaulted``),
  NodeAffinity's ``added_affinity``: feasible nodes, Diagnosis, placements.
* The multi-profile loop against the JAX ``TPUScheduler``: batchable
  profiles (the default one, and one listing the default set through
  ``multiPoint``) mixed in one batch, a custom profile on the sequential
  path, a pod of an unknown scheduler left pending; depth 0, depth 2 and
  the commit worker; the batch and sequential counters equal.
* C20: a profile that keeps the default plugin set but sets MostAllocated
  takes the port's sequential path and binds as the JAX ``Scheduler``
  does; the JAX ``TPUScheduler`` batches it and binds elsewhere.
* Out-of-tree plugins (``ZoneWeight`` written against the port's
  interface), a name collision, a profile without PostFilter (no
  preemption screen, no victims), a Reserve plugin outside the default
  bind path (the batch's winners run their PreFilters at commit).
"""

from __future__ import annotations

import pytest

from _torch_cases import (HOST, ZONE, LoopPair, build_nodes, build_pods, build_topo_nodes,
                          build_topo_pods, cluster_spec, jax_api, pods_spec, to_jax,
                          topo_cluster_spec, topo_pods_spec, torch_api)
from test_torch_sequential import _drive

from kubernetes_tpu_torch.perf import workloads

DEFAULT = "default-scheduler"
BATCH_B = {"schedulerName": "batch-b", **workloads.PROFILES["batch-b"]}
NO_SCORING = {"schedulerName": "no-scoring", "plugins": {"score": {"disabled": [{"name": "*"}]}}}


def _args(name: str, args: dict) -> dict:
    return {"name": name, "args": args}


# -------------------------------------------------------------- ZoneWeight


class ZoneWeight:
    """The out-of-tree plugin of ``examples/out_of_tree_plugin.py``, written
    against the port's interface: a Filter that refuses the ``forbidden``
    zones and a Score from the zones' ``weights`` (default 50)."""

    NAME = "ZoneWeight"

    def __init__(self, handle, args: dict):
        self.forbidden = set(args.get("forbidden", ()))
        self.weights = dict(args.get("weights", {}))

    def name(self) -> str:
        return self.NAME

    def filter(self, state, pod, node_info):
        from kubernetes_tpu_torch.framework.interface import unschedulable

        zone = node_info.node.meta.labels.get("zone", "")
        return unschedulable(f"zone {zone!r} is forbidden") if zone in self.forbidden else None

    def score_node(self, state, pod, node_info) -> int:
        return int(self.weights.get(node_info.node.meta.labels.get("zone", ""), 50))


def _zoned_config(forbidden=("z2",)):
    return {"apiVersion": "kubescheduler.config.k8s.io/v1beta3", "profiles": [{
        "schedulerName": "zoned-scheduler",
        "plugins": {"filter": {"enabled": [{"name": "ZoneWeight"}]},
                    "score": {"enabled": [{"name": "ZoneWeight", "weight": 5}]}},
        "pluginConfig": [_args("ZoneWeight", {"forbidden": list(forbidden),
                                              "weights": {"z1": 100, "z0": 10}})]}]}


def _jax_zone_weight():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from examples.out_of_tree_plugin import ZoneWeight as JZoneWeight

    return JZoneWeight


# -------------------------------------------------------------- registry


def test_registry_and_default_plugins_equal_jax():
    from kubernetes_tpu.framework import interface as jinterface
    from kubernetes_tpu.framework.registry import DEFAULT_PLUGINS as JDEFAULT
    from kubernetes_tpu.framework.registry import in_tree_registry as jregistry
    from kubernetes_tpu.framework.runtime import _POINT_METHODS
    from kubernetes_tpu_torch.framework import interface
    from kubernetes_tpu_torch.framework.registry import DEFAULT_PLUGINS, in_tree_registry

    assert list(in_tree_registry()) == list(jregistry())
    assert DEFAULT_PLUGINS == JDEFAULT
    assert interface.EXTENSION_POINTS == jinterface.EXTENSION_POINTS
    assert interface.POINT_METHODS == _POINT_METHODS


def test_each_plugin_implements_the_jax_points():
    """Every registry plugin implements exactly its JAX counterpart's
    points, so MultiPoint expands alike."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.framework.registry import in_tree_registry as jregistry
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.framework.interface import POINT_METHODS
    from kubernetes_tpu_torch.framework.registry import in_tree_registry

    jstore, tstore = ClusterStore(), Store()
    jh = {"snapshot_fn": lambda: [], "client": jstore, "ns_labels_fn": jstore.ns_labels}
    th = {"snapshot_fn": lambda: [], "client": tstore, "ns_labels_fn": tstore.ns_labels}

    def points(plugin):
        return [p for p, m in POINT_METHODS.items() if hasattr(plugin, m)]

    jreg, treg = jregistry(), in_tree_registry()
    for name in jreg:
        jp, tp = jreg[name](jh, {}), treg[name](th, {})
        assert tp.name() == jp.name() == name
        assert points(tp) == points(jp), name
        assert hasattr(tp, "events_to_register") == hasattr(jp, "events_to_register"), name
        if hasattr(jp, "events_to_register"):
            assert ([(str(e.resource), e.action_type, e.label) for e in tp.events_to_register()]
                    == [(str(e.resource), e.action_type, e.label)
                        for e in jp.events_to_register()]), name


# -------------------------------------------------------------- frameworks

FRAMEWORK_CONFIGS = {
    "default": None,
    "two_profiles": {"profiles": [{"schedulerName": DEFAULT}, BATCH_B, NO_SCORING]},
    "reenable": {"profiles": [{"plugins": {
        "score": {"disabled": [{"name": "ImageLocality"}],
                  "enabled": [{"name": "TaintToleration", "weight": 7},
                              {"name": "SelectorSpread"}]},
        "preScore": {"enabled": [{"name": "SelectorSpread"}]},
        "filter": {"disabled": [{"name": "*"}],
                   "enabled": [{"name": "NodeResourcesFit"}, {"name": "EBSLimits"},
                               {"name": "CinderLimits"}]},
        "preFilter": {"enabled": [{"name": "EBSLimits"}, {"name": "CinderLimits"}]},
        "queueSort": {"disabled": [{"name": "*"}], "enabled": [{"name": "PrioritySort"}]}}}]},
    "multi_point": {"profiles": [{"plugins": {"multiPoint": {
        "enabled": [{"name": "SelectorSpread", "weight": 4}, {"name": "VolumeBinding"},
                    {"name": "GCEPDLimits"}, {"name": "AzureDiskLimits"},
                    {"name": "ZoneWeight", "weight": 3}],
        "disabled": [{"name": "ImageLocality"}, {"name": "DefaultPreemption"}]}}}]},
    "multi_point_star": {"profiles": [{"plugins": {"multiPoint": {
        "enabled": [{"name": "NodeResourcesFit"}, {"name": "NodeName"},
                    {"name": "DefaultBinder"}, {"name": "PrioritySort"}],
        "disabled": [{"name": "*"}]}}}]},
}


@pytest.mark.parametrize("name", sorted(FRAMEWORK_CONFIGS))
def test_framework_points_equal_jax(name):
    """Each profile's points (names, weights, order), event map and queue
    sort plugin equal the JAX ``Framework``'s for the same config."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.config import scheduler_from_config as jax_from_config
    from kubernetes_tpu.scheduler.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.config import scheduler_from_config
    from kubernetes_tpu_torch.framework.interface import EXTENSION_POINTS
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    raw = FRAMEWORK_CONFIGS[name]
    jsched = jax_from_config(ClusterStore(), raw=raw, scheduler_cls=JScheduler,
                             out_of_tree_registry={"ZoneWeight": _jax_zone_weight()})
    tsched = scheduler_from_config(Store(), raw=raw, scheduler_cls=Scheduler,
                                   out_of_tree_registry={"ZoneWeight": ZoneWeight})
    assert list(tsched.profiles) == list(jsched.profiles)
    for profile, jfwk in jsched.profiles.items():
        tfwk = tsched.profiles[profile]
        for point in EXTENSION_POINTS:
            assert tfwk.point_names(point) == [(p.name(), w) for p, w in
                                               jfwk.points.get(point, [])], (profile, point)
        jmap = {(str(ev.resource), ev.action_type, ev.label): p
                for ev, p in jfwk.cluster_event_map().items()}
        tmap = {(str(ev.resource), ev.action_type, ev.label): p
                for ev, p in tfwk.cluster_event_map().items()}
        assert tmap == jmap, profile
    union = {}
    for jfwk in jsched.profiles.values():
        for ev, plugins in jfwk.cluster_event_map().items():
            union.setdefault((str(ev.resource), ev.action_type, ev.label), set()).update(plugins)
    assert {(str(ev.resource), ev.action_type, ev.label): p
            for ev, p in tsched.event_map.items()} == union


# -------------------------------------------------------------- the sequential path


@pytest.fixture()
def synchronous(monkeypatch):
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")


def _one_profile(plugin_config=None, plugins=None) -> dict:
    profile = {"schedulerName": DEFAULT}
    if plugin_config:
        profile["pluginConfig"] = plugin_config
    if plugins:
        profile["plugins"] = plugins
    return {"profiles": [profile]}


def _topology_pair(config: dict, seed: int) -> LoopPair:
    pair = LoopPair(batch=16, config=config)
    keys = (ZONE, HOST)
    spec = topo_cluster_spec(24, seed, keys)
    pair.add_nodes(build_topo_nodes(jax_api(), spec), build_topo_nodes(torch_api(), spec))
    pods = topo_pods_spec(40, seed + 1, keys)
    pair.add_pods(build_topo_pods(jax_api(), pods), build_topo_pods(torch_api(), pods))
    return pair


def _plain_pair(config: dict, seed: int, n_nodes: int = 12, n_pods: int = 64) -> LoopPair:
    pair = LoopPair(batch=16, config=config)
    spec = cluster_spec(n_nodes, seed)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(n_pods, seed + 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    return pair


def _spread_defaults(system_defaulted: bool) -> dict:
    from kubernetes_tpu_torch.api.types import LabelSelector, TopologySpreadConstraint

    return {"default_constraints": [
        TopologySpreadConstraint(max_skew=1, topology_key=ZONE,
                                 when_unsatisfiable="DoNotSchedule",
                                 label_selector=LabelSelector()),
        TopologySpreadConstraint(max_skew=2, topology_key="tier",
                                 when_unsatisfiable="ScheduleAnyway",
                                 label_selector=LabelSelector())],
        "system_defaulted": system_defaulted}


def _added_affinity():
    from kubernetes_tpu_torch.api.types import (NodeAffinity, NodeSelector, NodeSelectorTerm,
                                                PreferredSchedulingTerm, Requirement)

    return NodeAffinity(
        required=NodeSelector(terms=(NodeSelectorTerm(match_expressions=(
            Requirement(key=ZONE, operator="In", values=("zone-0", "zone-1")),)),)),
        preferred=(PreferredSchedulingTerm(weight=7, preference=NodeSelectorTerm(
            match_expressions=(Requirement(key="tier", operator="In", values=("2",)),))),))


SEQUENTIAL = {
    "no_scoring": lambda: _one_profile(plugins={"score": {"disabled": [{"name": "*"}]}}),
    "most_allocated": lambda: _one_profile([_args("NodeResourcesFit",
                                                  {"strategy": "MostAllocated"})]),
    "rtcr": lambda: _one_profile([_args("NodeResourcesFit", {
        "strategy": "RequestedToCapacityRatio", "resources": [["cpu", 3], ["memory", 1]],
        "shape": [[0, 10], [50, 3], [100, 0]]})]),
    "balanced_resources": lambda: _one_profile([_args("NodeResourcesBalancedAllocation", {
        "resources": [["cpu", 1], ["memory", 1], ["pods", 1]]})]),
    "spread_defaults": lambda: _one_profile([_args("PodTopologySpread", _spread_defaults(False))]),
    "spread_system_defaulted": lambda: _one_profile(
        [_args("PodTopologySpread", _spread_defaults(True))]),
    "added_affinity": lambda: _one_profile([_args("NodeAffinity",
                                                  {"added_affinity": _added_affinity()})]),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SEQUENTIAL))
def test_sequential_under_custom_profiles(name, seed, synchronous):
    """The sequential path pod by pod under a custom profile, on the
    heterogeneous cluster: feasible nodes, Diagnosis, placements equal."""
    log = _drive(_plain_pair(SEQUENTIAL[name](), seed))
    assert any(feasible for feasible, _d in log)


@pytest.mark.parametrize("seed", [0, 1])
def test_sequential_hard_pod_affinity_weight(seed, synchronous):
    """hard_pod_affinity_weight 5 with the topology case's affinity pods:
    the existing pods' required terms weigh 5 in InterPodAffinity's
    PreScore."""
    config = _one_profile([_args("InterPodAffinity", {"hard_pod_affinity_weight": 5})])
    log = _drive(_topology_pair(config, seed))
    assert any(len(feasible) > 1 for feasible, _d in log)


# -------------------------------------------------------------- the loop

# (KTPU_PIPELINE_DEPTH, KTPU_COMMIT_WORKER); the worker's commits land at
# the end of each cycle (``LoopPair.land_worker_each_cycle``)
MODES = [("0", "0"), ("2", "0"), ("2", "1")]


@pytest.fixture(params=MODES, ids=["depth0", "depth2", "depth2-worker"])
def mode(request, monkeypatch):
    depth, worker = request.param
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)
    return request.param


def _close(pair: LoopPair) -> None:
    for sched in (pair.jsched, pair.tsched):
        sched._drain_inflight()
        if sched.commit_worker is not None:
            sched.commit_worker.stop()


def _named_pods(api, spec, names):
    pods = build_pods(api, spec)
    for i, pod in enumerate(pods):
        pod.spec.scheduler_name = names[i % len(names)]
    return pods


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_profile_loop_equals_jax(seed, mode):
    """Three profiles: pods of ``default-scheduler`` and ``batch-b`` share
    batches (each looked up at commit), ``no-scoring`` pods take the
    sequential path in both loops, and one pod of an unknown scheduler
    stays pending. Placements, queue, counters, batches and the batch /
    sequential split equal the JAX TPUScheduler's."""
    config = {"profiles": [{"schedulerName": DEFAULT}, BATCH_B, NO_SCORING]}
    pair = LoopPair(batch=16, config=config)
    pair.land_worker_each_cycle()
    spec = cluster_spec(16, seed)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    names = [DEFAULT, "batch-b", DEFAULT, "batch-b", "no-scoring"]
    pods = pods_spec(60, seed + 1)
    pair.add_pods(_named_pods(jax_api(), pods, names), _named_pods(torch_api(), pods, names))
    stray = [api.make_pod("stray").req({"cpu": "100m"}).scheduler_name("elsewhere").obj()
             for api in (jax_api(), torch_api())]
    pair.add_pods(*([p] for p in stray))
    pair.settle()
    _close(pair)
    got = pair.assert_equal()
    assert got["placed"]["default/stray"] == ""
    assert pair.tsched.batch_scheduled == pair.jsched.batch_scheduled > 0
    assert pair.tsched.fallback_scheduled == pair.jsched.fallback_scheduled > 0
    batchable = {name: pair.tsched._framework_batchable(fwk)
                 for name, fwk in pair.tsched.profiles.items()}
    assert batchable == {DEFAULT: True, "batch-b": True, "no-scoring": False}


def test_two_profiles_share_one_quota_ledger(mode):
    """Two profiles that both run QuotaAdmission charge one ledger: a
    borrower's loans are granted through both (the newest through
    ``batch-b``), then a lender's pod records demand and the reclaim pass
    evicts the pool's newest loan. The loans' order in ``dump()``, the
    evicted pod and every placement equal the JAX TPUScheduler's."""
    config = {"profiles": [{"schedulerName": DEFAULT}, BATCH_B]}
    pair = LoopPair(batch=16, config=config)
    pair.land_worker_each_cycle()

    def nodes(api):
        return [api.make_node(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": 32})
                .label("kubernetes.io/hostname", f"node-{i}").obj() for i in range(4)]

    def pods(api, prefix, ns, names):
        return [api.make_pod(f"{prefix}-{i}", namespace=ns).req({"cpu": "100m"})
                .scheduler_name(name).obj() for i, name in enumerate(names)]

    for jn, tn in zip(nodes(jax_api()), nodes(torch_api())):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)
    pair.add_quota("lend", {"pods": 3}, cohort="pool")
    pair.add_quota("borrow", {"pods": 1}, cohort="pool")
    # b-0 is the borrower's own; b-1 and b-2 are loans through the default
    # profile, b-3 the newest loan, through batch-b
    names = [DEFAULT, DEFAULT, DEFAULT, "batch-b"]
    pair.add_pods(pods(jax_api(), "b", "borrow", names), pods(torch_api(), "b", "borrow", names))
    pair.settle()
    got = pair.assert_gang_equal()
    assert len(_bound_in(got, "borrow")) == 4
    jloans, tloans = (s._quota_plugin().dump()["_cohorts"]["pool"]["loans"]
                      for s in (pair.jsched, pair.tsched))
    assert [loan["pod"] for loan in tloans] == [loan["pod"] for loan in jloans] == [
        "borrow/b-3", "borrow/b-2", "borrow/b-1"]
    assert tloans == jloans
    pair.add_pods(pods(jax_api(), "l", "lend", [DEFAULT]), pods(torch_api(), "l", "lend", [DEFAULT]))
    pair.settle()
    pair.advance(1.5)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert _bound_in(got, "lend") == ["lend/l-0"]
    assert _bound_in(got, "borrow") == ["borrow/b-0", "borrow/b-1", "borrow/b-2"]
    assert pair.tsched.smetrics.evicted_pods.labels("quota_reclaim") == 1
    assert (pair.tsched._quota_plugin().dump()["_cohorts"]["pool"]
            == pair.jsched._quota_plugin().dump()["_cohorts"]["pool"])


def _bound_in(state, ns):
    return sorted(k for k, n in state["placed"].items() if n and k.startswith(f"{ns}/"))


def test_custom_profile_falls_back_and_default_batches():
    """The counterparts of the JAX TestCustomProfileFallsBack: a profile
    whose Score list differs schedules through the sequential path; the
    default profile batches."""
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.config import scheduler_from_config

    raw = {"profiles": [{"schedulerName": DEFAULT, "plugins": {"score": {
        "disabled": [{"name": "*"}], "enabled": [{"name": "NodeResourcesFit", "weight": 5}]}}}]}
    for config, batched in ((raw, False), (None, True)):
        store = Store()
        sched = scheduler_from_config(store, raw=config, scheduler_cls=TPUScheduler,
                                      device="cpu", batch_deadline_ms=0)
        store.create_node(make_node("n1").capacity({"cpu": "4", "memory": "8Gi",
                                                    "pods": 10}).obj())
        store.create_pod(make_pod("p").req({"cpu": "100m"}).obj())
        sched.run_until_settled()
        sched.close()
        assert store.get_pod("default/p").spec.node_name == "n1"
        assert (sched.batch_scheduled, sched.fallback_scheduled) == ((1, 0) if batched
                                                                     else (0, 1))


def test_c20_plugin_args_take_the_sequential_path():
    """C20: the default plugin set with NodeResourcesFit's MostAllocated.
    The JAX Scheduler binds the 500m pod to the busy node; the port's loop
    sends the profile down the sequential path and binds it there too; the
    JAX TPUScheduler batches it, scored LeastAllocated, onto the empty
    node."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler as JTPUScheduler
    from kubernetes_tpu.config import scheduler_from_config as jax_from_config
    from kubernetes_tpu.scheduler.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.config import scheduler_from_config

    raw = _one_profile([_args("NodeResourcesFit", {"strategy": "MostAllocated"})])

    def fill(store, api):
        for name in ("busy", "empty"):
            store.create_node(api.make_node(name).capacity(
                {"cpu": "8", "memory": "16Gi", "pods": 20}).obj())
        old = api.make_pod("old").req({"cpu": "4", "memory": "1Gi"}).obj()
        old.spec.node_name = "busy"
        store.create_pod(old)

    placed = {}
    for side in ("jax", "jax_loop", "port"):
        if side == "port":
            store, api = Store(), torch_api()
            sched = scheduler_from_config(store, raw=raw, scheduler_cls=TPUScheduler,
                                          device="cpu", batch_deadline_ms=0)
        else:
            store, api = ClusterStore(), jax_api()
            cls = JScheduler if side == "jax" else JTPUScheduler
            kw = {} if side == "jax" else {"batch_deadline_ms": 0}
            sched = jax_from_config(store, raw=raw, scheduler_cls=cls, **kw)
        fill(store, api)
        store.create_pod(api.make_pod("new").req({"cpu": "500m", "memory": "1Gi"}).obj())
        sched.run_until_settled()
        placed[side] = (store.get_pod("default/new").spec.node_name,
                        getattr(sched, "batch_scheduled", None),
                        getattr(sched, "fallback_scheduled", None))
        if side != "jax":
            sched._drain_inflight()
    assert placed["jax"][0] == "busy"
    assert placed["port"] == ("busy", 0, 1)
    assert placed["jax_loop"] == ("empty", 1, 0)


# -------------------------------------------------------------- out-of-tree plugins


def _zoned_pair(forbidden=("z2",), n=6) -> LoopPair:
    pair = LoopPair(batch=16, config=_zoned_config(forbidden),
                    registries=({"ZoneWeight": _jax_zone_weight()}, {"ZoneWeight": ZoneWeight}))
    pair.add_nodes(*[[api.NodeInfo(api.make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": 20}).label("zone", f"z{i % 3}").obj())
        for i in range(n)] for api in (jax_api(), torch_api())])
    return pair


def _zoned_pods(api, n):
    return [api.make_pod(f"pod-{i}").req({"cpu": "500m", "memory": "512Mi"})
            .scheduler_name("zoned-scheduler").obj() for i in range(n)]


def test_out_of_tree_plugin_filters_and_scores(synchronous):
    """ZoneWeight through ``out_of_tree_registry``: z2 filtered, z1's
    weight wins; every pod takes the sequential path, as in the JAX loop."""
    pair = _zoned_pair()
    pair.add_pods(_zoned_pods(jax_api(), 4), _zoned_pods(torch_api(), 4))
    pair.settle()
    got = pair.assert_equal()
    zones = {pair.tstore.nodes[n].meta.labels["zone"] for n in got["placed"].values()}
    assert zones == {"z1"}
    assert pair.tsched.fallback_scheduled == pair.jsched.fallback_scheduled == 4


def test_out_of_tree_plugin_unschedulable_when_all_forbidden(synchronous):
    pair = _zoned_pair(forbidden=("z0", "z1", "z2"), n=3)
    pair.add_pods(_zoned_pods(jax_api(), 1), _zoned_pods(torch_api(), 1))
    pair.settle()
    got = pair.assert_equal()
    assert got["placed"]["default/pod-0"] == ""
    assert got["queued"][0][2] == ("ZoneWeight",)


def test_name_collision_with_in_tree_plugin_raises():
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.config import scheduler_from_config

    with pytest.raises(ValueError, match="already registered"):
        scheduler_from_config(Store(), raw=_zoned_config(), device="cpu",
                              out_of_tree_registry={"NodeAffinity": ZoneWeight})


# -------------------------------------------------------------- preemption and the bind path


def _full_nodes(api, n):
    """``n`` 4-cpu nodes, each full with four priority-1 victims."""
    infos = []
    for i in range(n):
        ni = api.NodeInfo(api.make_node(f"n{i}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": 32}).obj())
        for j in range(4):
            pod = api.make_pod(f"victim-{i}-{j}").req({"cpu": "900m", "memory": "2Gi"}) \
                .priority(1).obj()
            pod.spec.node_name = f"n{i}"
            ni.add_pod(pod)
        infos.append(ni)
    return infos


def test_no_post_filter_means_no_preemption(mode, monkeypatch):
    """A profile with PostFilter disabled: no preemption screen runs, no
    pod is evicted or nominated; both loops leave the preemptors
    pending."""
    from kubernetes_tpu_torch.backend import tpu_scheduler

    def screen(*_args, **_kw):
        raise AssertionError("the preemption screen ran")

    monkeypatch.setattr(tpu_scheduler, "preempt_screen", screen)
    config = _one_profile(plugins={"postFilter": {"disabled": [{"name": "*"}]}})
    pair = LoopPair(batch=16, config=config)
    pair.land_worker_each_cycle()
    assert not pair.tsched._preempt_wired
    pair.add_nodes(_full_nodes(jax_api(), 6), _full_nodes(torch_api(), 6))

    def preemptors(api):
        return [api.make_pod(f"preemptor-{i}").req({"cpu": "2", "memory": "4Gi"})
                .priority(100).obj() for i in range(6)]

    pair.add_pods(preemptors(jax_api()), preemptors(torch_api()))
    pair.settle()
    _close(pair)
    got = pair.assert_equal()
    assert not got["nominated"] and not pair.tsched.preempted and not pair.tsched.nominations
    assert all(got["placed"][f"default/preemptor-{i}"] == "" for i in range(6))


class _Recorder:
    """A Reserve plugin outside the default bind path: it records the
    PreFilter state each pod reaches Reserve with."""

    def __init__(self, handle, args):
        self.seen = {}

    def name(self) -> str:
        return "Recorder"

    def reserve(self, state, pod, node_name):
        self.seen[pod.key()] = None if state is None else dict(state.request)
        return None

    def unreserve(self, state, pod, node_name):
        pass


def test_non_default_reserve_runs_the_pre_filters_at_commit():
    """A Reserve plugin outside the default bind path makes
    ``_bind_path_needs_prefilter`` true: the batch's winners (the profile
    still batches) run their PreFilters at commit, so the plugin sees each
    pod's state."""
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.config import scheduler_from_config

    store = Store()
    config = _one_profile(plugins={"reserve": {"enabled": [{"name": "Recorder"}]}})
    sched = scheduler_from_config(store, raw=config, scheduler_cls=TPUScheduler, device="cpu",
                                  batch_deadline_ms=0,
                                  out_of_tree_registry={"Recorder": _Recorder})
    fwk = sched.profiles[DEFAULT]
    assert sched._bind_path_needs_prefilter(fwk) and sched._framework_batchable(fwk)
    for i in range(3):
        store.create_node(make_node(f"n{i}").capacity({"cpu": "4", "memory": "8Gi",
                                                       "pods": 10}).obj())
    for i in range(5):
        store.create_pod(make_pod(f"p{i}").req({"cpu": "300m", "memory": "1Gi"}).obj())
    sched.run_until_settled()
    sched.close()
    assert sched.batch_scheduled == 5 and sched.fallback_scheduled == 0
    recorder = fwk.plugin("Recorder")
    assert all(req is not None and req.get("cpu") == 300 for req in recorder.seen.values())
    assert len(recorder.seen) == 5


class _Skipper:
    """A Bind plugin ahead of DefaultBinder that declines every pod (Status
    Skip), recording the pods it saw; ``jax`` builds the JAX package's."""

    def __init__(self, handle, args, jax=False):
        self.seen, self.jax = [], jax

    def name(self) -> str:
        return "Skipper"

    def bind(self, state, pod, node_name):
        self.seen.append(pod.key())
        if self.jax:
            from kubernetes_tpu.framework import interface as jfw

            return jfw.Status(jfw.SKIP)
        from kubernetes_tpu_torch.framework.interface import SKIP

        return SKIP


def test_bind_plugin_skip_passes_to_the_next(mode):
    """A Bind plugin listed ahead of DefaultBinder that returns Skip for
    every pod: each pod goes on to DefaultBinder and binds, in both loops,
    and the plugin saw the same pods in the same order."""
    config = _one_profile(plugins={"bind": {"disabled": [{"name": "*"}],
                                            "enabled": [{"name": "Skipper"},
                                                        {"name": "DefaultBinder"}]}})
    pair = LoopPair(batch=16, config=config,
                    registries=({"Skipper": lambda h, a: _Skipper(h, a, jax=True)},
                                {"Skipper": _Skipper}))
    pair.land_worker_each_cycle()
    spec = cluster_spec(8, 0)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(24, 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    pair.settle()
    _close(pair)
    got = pair.assert_equal()
    jseen = pair.jsched.profiles[DEFAULT].plugin("Skipper").seen
    tseen = pair.tsched.profiles[DEFAULT].plugin("Skipper").seen
    assert tseen == jseen and len(tseen) > 0
    assert sorted(tseen) == sorted(k for k, n in got["placed"].items()
                                   if n and not k.startswith("default/old-"))


def test_sequential_selector_spread(synchronous):
    """SelectorSpread (no default profile holds it) in PreScore and Score:
    a Service selects the app's pods, some already bound; each new pod of
    the app spreads over nodes and zones, pod by pod as in JAX."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, Service

    config = _one_profile(plugins={"preScore": {"enabled": [{"name": "SelectorSpread"}]},
                                   "score": {"enabled": [{"name": "SelectorSpread",
                                                          "weight": 3}]}})
    pair = LoopPair(batch=16, config=config)
    svc = Service(meta=ObjectMeta(name="web", namespace="default"), selector={"app": "web"})
    pair.jstore.create_service(to_jax(svc))
    pair.tstore.create_object("Service", svc)

    def nodes(api):
        infos = []
        for i in range(8):
            ni = api.NodeInfo(api.make_node(f"n{i}").capacity(
                {"cpu": "8", "memory": "16Gi", "pods": 20})
                .label(ZONE, f"zone-{i % 2}").obj())
            for j in range(i % 3):
                pod = api.make_pod(f"old-{i}-{j}").req({"cpu": "100m"}).label("app", "web").obj()
                pod.spec.node_name = f"n{i}"
                ni.add_pod(pod)
            infos.append(ni)
        return infos

    def pods(api):
        return [api.make_pod(f"web-{i}").req({"cpu": "200m"}).label("app", "web").obj()
                for i in range(10)]

    pair.add_nodes(nodes(jax_api()), nodes(torch_api()))
    pair.add_pods(pods(jax_api()), pods(torch_api()))
    log = _drive(pair)
    assert all(len(feasible) == 8 for feasible, _d in log)
