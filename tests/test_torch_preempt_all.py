"""Preemption for every batch in the port against the JAX package: the
InterPodAffinity, PodTopologySpread and DynamicResources PreFilters,
Filters and AddPod / RemovePod extensions, the filter chain with nominated
pods, the Evaluator's candidates and victims for anti-affine, spread and
claim preemptors, and BatchScheduler's failure path in modes ``host``,
``general`` and ``off`` with claims, for rejected gangs and for
quota-rejected pods. Every comparison is exact."""

from __future__ import annotations

import random

import numpy as np
import pytest

import _torch_cases as tc

NS_LABELS = {"default": {"team": "a"}}


def _ns_labels(ns):
    return NS_LABELS.get(ns, {})


def _topo_world(seed: int):
    """The same seeded topology cluster and pods in both packages:
    (JAX infos, JAX pods, port infos, port pods)."""
    spec = tc.topo_cluster_spec(24, seed)
    pspec = tc.topo_pods_spec(16, seed + 1)
    return (tc.build_topo_nodes(tc.jax_api(), spec), tc.build_topo_pods(tc.jax_api(), pspec),
            tc.build_topo_nodes(tc.torch_api(), spec), tc.build_topo_pods(tc.torch_api(), pspec))


def _same_verdict(reason, status):
    assert (reason is None) == status.is_success()
    if reason is not None:
        assert reason == status.reasons[0]


@pytest.mark.parametrize("seed", range(5))
def test_topology_prefilter_filter_and_extensions_match_jax(seed):
    """Both topology plugins' PreFilter state and Filter verdict on every
    node, then again after a seeded walk of RemovePod / AddPod moves on
    cloned states (the originals must not move)."""
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins.interpodaffinity import InterPodAffinity
    from kubernetes_tpu.framework.plugins.podtopologyspread import PodTopologySpread
    from kubernetes_tpu_torch.framework.plugins import interpodaffinity as tipa
    from kubernetes_tpu_torch.framework.plugins import podtopologyspread as tpts

    jinfos, jpods, tinfos, tpods = _topo_world(seed)
    ipa = InterPodAffinity(snapshot_fn=lambda: jinfos, ns_labels_fn=_ns_labels)
    pts = PodTopologySpread(snapshot_fn=lambda: jinfos)
    rng = np.random.RandomState(seed)
    moved = 0
    for jp, tp in zip(jpods, tpods):
        state = CycleState()
        ipa.pre_filter(state, jp)
        pts.pre_filter(state, jp)
        s_ipa = tipa.pre_filter(tp, tinfos, _ns_labels)
        s_pts = tpts.pre_filter(tp, tinfos)

        def compare(st, a, b):
            ja, jb = st.read(ipa.PREFILTER_KEY), st.read(pts.PREFILTER_KEY)
            for f in ("existing_anti", "affinity", "anti_affinity"):
                assert getattr(a, f) == getattr(ja, f), f
            assert b.tp_pair_to_match_num == jb.tp_pair_to_match_num
            assert b.tp_key_to_domains_num == jb.tp_key_to_domains_num
            for jni, tni in zip(jinfos, tinfos):
                _same_verdict(tipa.filter_node(a, tp, tni, _ns_labels), ipa.filter(st, jp, jni))
                _same_verdict(tpts.filter_node(b, tp, tni) if b.constraints else None,
                              pts.filter(st, jp, jni))

        compare(state, s_ipa, s_pts)
        before = (dict(s_ipa.existing_anti), dict(s_pts.tp_pair_to_match_num))
        st2, a2, b2 = state.clone(), s_ipa.clone(), s_pts.clone()
        for _ in range(6):
            k = rng.randint(len(jinfos))
            jni, tni = jinfos[k], tinfos[k]
            if jni.pods and rng.randint(2):
                j = rng.randint(len(jni.pods))
                jv, tv = jni.pods[j], tni.pods[j]
                ipa.remove_pod(st2, jp, jv, jni)
                pts.remove_pod(st2, jp, jv, jni)
                tipa.update_for_pod(a2, tp, tv, tni.node, -1, _ns_labels)
                tpts.update_for_pod(b2, tp, tv, tni.node, -1)
            else:
                o = rng.randint(len(jpods))
                ipa.add_pod(st2, jp, jpods[o], jni)
                pts.add_pod(st2, jp, jpods[o], jni)
                tipa.update_for_pod(a2, tp, tpods[o], tni.node, 1, _ns_labels)
                tpts.update_for_pod(b2, tp, tpods[o], tni.node, 1)
            moved += 1
        compare(st2, a2, b2)
        assert before == (s_ipa.existing_anti, s_pts.tp_pair_to_match_num)
    assert moved


def _claim_world(seed: int):
    """Nodes publishing device attributes and pods with claims (some
    allocated to a node) in both packages, with their stores: (JAX store,
    JAX infos, JAX pods, port store, port infos, port pods)."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.api import types as ttypes
    from kubernetes_tpu_torch.apiserver.store import Store

    rng = np.random.RandomState(seed)
    api = tc.torch_api()
    infos = []
    for i in range(12):
        nw = api.make_node(f"n{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": 10})
        nw.device_attrs({"tpu.dev/cores": int(rng.choice([4, 8, 16])),
                         "tpu.dev/gen": str(rng.choice(["v4", "v5"]))})
        infos.append(api.NodeInfo(nw.obj()))
    store = Store()
    store.create_object("ResourceClass", ttypes.ResourceClass(
        meta=ttypes.ObjectMeta(name="tpu", namespace=""), driver_name="tpu",
        selectors={"tpu.dev/gen": "v5"}))
    pods = []
    for j in range(10):
        pw = api.make_pod(f"c{j}").req({"cpu": "1"}).priority(10)
        for k in range(1 + j % 2):
            name = f"c{j}-x{k}"
            alloc = f"n{rng.randint(12)}" if rng.uniform() < 0.3 else ""
            store.create_object("ResourceClaim", ttypes.ResourceClaim(
                meta=ttypes.ObjectMeta(name=name, namespace="default"),
                resource_class_name="tpu", allocated_node=alloc,
                selectors={"tpu.dev/cores": str(rng.choice([">=8", ">=16", "<=8"]))}))
            pw.resource_claim(f"x{k}", claim_name=name)
        pods.append(pw.obj())
    pods.append(api.make_pod("missing").resource_claim("x", claim_name="nope").obj())
    jstore = ClusterStore()
    tc.copy_store_objects(store, jstore)
    jinfos = [tc.to_jax_node_info(ni) for ni in infos]
    return jstore, jinfos, [tc.to_jax(p) for p in pods], store, infos, pods


@pytest.mark.parametrize("seed", range(4))
def test_claim_prefilter_and_filter_match_jax(seed):
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins.dynamicresources import DynamicResources
    from kubernetes_tpu_torch.framework.runtime import Framework

    jstore, jinfos, jpods, tstore, tinfos, tpods = _claim_world(seed)
    dra = DynamicResources(client=jstore)
    runner = Framework({"client": tstore, "snapshot_fn": lambda: tinfos}).filters
    fwk, _plugin = tc.jax_framework(lambda: jinfos, tc.JaxPreemptClient(jstore, {}))
    from kubernetes_tpu_torch.framework.plugins import dynamicresources as tdra

    restricted = 0
    for jp, tp in zip(jpods, tpods):
        state = CycleState()
        _, st = dra.pre_filter(state, jp)
        _, st_all = fwk.run_pre_filter_plugins(CycleState(), jp)
        _tstate, reason = runner.pre_filter(tp)
        _same_verdict(reason, st_all)
        claims, reason = tdra.pre_filter(tstore, tp)
        _same_verdict(reason, st)
        restricted += st.is_success() and not st_all.is_success()
        if reason is not None:
            continue
        for jni, tni in zip(jinfos, tinfos):
            _same_verdict(tdra.filter_node(claims, tni.node), dra.filter(state, jp, jni))
    if seed == 2:
        assert restricted  # claims allocated to two nodes: no node is left


@pytest.mark.parametrize("seed", range(4))
def test_filter_with_nominated_pods_matches_jax(seed):
    """The whole chain, two passes with nominated pods added (and the
    AddPod extensions run for them on a copy of the state), on every
    node."""
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu_torch.framework.runtime import Framework, PodNominator

    jinfos, jpods, tinfos, tpods = _topo_world(seed + 10)
    fwk, _plugin = tc.jax_framework(lambda: jinfos, tc.JaxPreemptClient(None, {}))
    fwk.handle_ctx["ns_labels_fn"] = _ns_labels
    nominator = PodNominator()
    runner = Framework({"snapshot_fn": lambda: tinfos, "ns_labels_fn": _ns_labels,
                        "nominator": nominator}).filters
    for k, (jp, tp) in enumerate(zip(jpods, tpods)):
        jp.spec.priority = tp.spec.priority = 10 * (k % 3)
    for k in range(0, len(jpods), 3):
        node = tinfos[(5 * k) % len(tinfos)].node.meta.name
        fwk.nominator.add_nominated_pod(jpods[k], node)
        nominator.add_nominated_pod(tpods[k], node)
    checked = 0
    for jp, tp in zip(jpods, tpods):
        state = CycleState()
        _, st = fwk.run_pre_filter_plugins(state, jp)
        tstate, reason = runner.pre_filter(tp)
        _same_verdict(reason, st)
        if reason is not None:
            continue
        for jni, tni in zip(jinfos, tinfos):
            _same_verdict(runner.filter_with_nominated_pods(tstate, tp, tni),
                          fwk.run_filter_plugins_with_nominated_pods(state, jp, jni))
            checked += 1
    assert checked


def _bound_world(nodes=24, init_pods=96, per_kind=6):
    """A small PreemptionAll with its victims bound by the port (on the
    CPU), rebuilt in the JAX package: (JAX infos, JAX client, JAX
    framework, JAX preemptors, port BatchScheduler, port preemptors)."""
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.preemption_all(nodes=nodes, init_pods=init_pods, per_kind=per_kind)
    store = w.store()
    sched = BatchScheduler(w.node_infos(), caps=Capacities(nodes=64, pods=32, value_words=32),
                           device="cpu", client=store)
    sched.schedule(w.init_pod_list())
    # the victims' start times decide ties of the pick
    for k, p in enumerate(p for ni in sched.snapshot.node_info_map.values() for p in ni.pods):
        p.status.start_time = float(k % 5)
    jinfos = [tc.to_jax_node_info(ni) for ni in sched.snapshot.node_info_map.values()]
    client = tc.JaxPreemptClient(None, {})
    from kubernetes_tpu.apiserver.store import ClusterStore

    client.store = ClusterStore()
    tc.copy_store_objects(store, client.store)
    fwk, _plugin = tc.jax_framework(lambda: jinfos, client)
    tpods = w.measured_pod_list()
    return jinfos, client, fwk, [tc.to_jax(p) for p in tpods], sched, tpods


def test_evaluator_candidates_match_jax():
    """Every candidate (node, victims in order, PDB violations) and the
    pick for claim, anti-affine and spread preemptors, from the same random
    offset, on clones of the PreFilter state per dry run."""
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.preemption import Evaluator as JEvaluator
    from kubernetes_tpu_torch.framework.preemption import Evaluator

    jinfos, client, fwk, jpods, sched, tpods = _bound_world()
    runner = sched._preemption.filters
    tinfos = list(sched.snapshot.node_info_map.values())
    kinds = set()
    for k, (jp, tp) in enumerate(zip(jpods, tpods)):
        state = CycleState()
        _, st = fwk.run_pre_filter_plugins(state, jp)
        tstate, reason = runner.pre_filter(tp)
        _same_verdict(reason, st)
        jev = JEvaluator("DefaultPreemption", fwk, [], state, rng=random.Random(k))
        tev = Evaluator(runner, tstate, [], None, None, random.Random(k))
        jc, _diag = jev.find_candidates(jp, {}, jinfos)
        tcands = tev.find_candidates(tp, tinfos)
        as_tuple = lambda c: (c.node_name, [v.key() for v in c.victims],  # noqa: E731
                              c.num_pdb_violations)
        assert [as_tuple(c) for c in tcands] == [as_tuple(c) for c in jc], tp.key()
        assert tcands
        assert as_tuple(tev.select_candidate(tcands)) == as_tuple(jev.select_candidate(jc))
        kinds.add(tp.meta.name.rsplit("-", 1)[0])
    assert kinds == {"pre-claim", "pre-anti", "pre-spread"}


def test_evaluator_skips_unresolvable_nodes_as_jax():
    """Nodes whose filter status was UnschedulableAndUnresolvable take no
    dry run (``nodesWherePreemptionMightHelp``): the candidates with every
    third node so marked equal the JAX Evaluator's over the same status
    map."""
    from kubernetes_tpu.framework.interface import CycleState, Status
    from kubernetes_tpu.framework.preemption import Evaluator as JEvaluator
    from kubernetes_tpu_torch.framework.preemption import Evaluator

    jinfos, client, fwk, jpods, sched, tpods = _bound_world()
    runner = sched._preemption.filters
    tinfos = list(sched.snapshot.node_info_map.values())
    skip = {ni.node.meta.name for ni in tinfos[::3]}
    status = {name: Status.unresolvable("pinned elsewhere") for name in skip}
    for k in (0, 6, 12):
        jp, tp = jpods[k], tpods[k]
        state = CycleState()
        fwk.run_pre_filter_plugins(state, jp)
        tstate, _ = runner.pre_filter(tp)
        jc, _ = JEvaluator("DefaultPreemption", fwk, [], state,
                           rng=random.Random(k)).find_candidates(jp, status, jinfos)
        tcands = Evaluator(runner, tstate, [], None, None,
                           random.Random(k)).find_candidates(tp, tinfos, skip)
        assert [c.node_name for c in tcands] == [c.node_name for c in jc]
        assert tcands and not {c.node_name for c in tcands} & skip


def test_shared_state_would_leak_between_dry_runs():
    """The reason the Evaluator clones: a dry run that removes victims
    moves the spread counts of its state, and the next node's dry run must
    start from the PreFilter's counts."""
    jinfos, client, fwk, jpods, sched, tpods = _bound_world()
    runner = sched._preemption.filters
    spread = next(p for p in tpods if "spread" in p.meta.name)
    state, _ = runner.pre_filter(spread)
    before = dict(state.spread.tp_pair_to_match_num)
    from kubernetes_tpu_torch.framework.preemption import Evaluator

    ev = Evaluator(runner, state, [], None, None, random.Random(0))
    for ni in sched.snapshot.node_info_map.values():
        ev.select_victims_on_node(spread, ni)
    assert state.spread.tp_pair_to_match_num == before
    clone = state.clone()
    ni = next(iter(sched.snapshot.node_info_map.values()))
    runner.add_pod(clone, spread, spread, ni)
    assert clone.spread.tp_pair_to_match_num != before
    assert state.spread.tp_pair_to_match_num == before


# ----------------------------------------------------------------- BatchScheduler


@pytest.mark.parametrize("spec", ["0", "1"])
def test_preempt_all_matches_jax(spec, monkeypatch):
    """A small PreemptionAll (claim, anti-affine and spread preemptors, each
    in its own batch) against the JAX loop: placements, the nominations
    before each round, victims; every preemptor bound, nothing in
    ``fallback``, a failing batch in each of modes off, host, general."""
    monkeypatch.setenv("KTPU_SPEC", spec)
    placed_j, rounds_j, env, placed_t, rounds_t, sched = tc.run_preempt_all_both()
    assert placed_t == placed_j and rounds_t == rounds_j
    assert sched.preempted == env.preempted and sched.batch_modes == env.modes
    assert all(v is not None for v in placed_t.values())
    assert not sched.fallback and not sched.retry and not sched.nominated
    first = {m for m, p in zip(sched.batch_modes[-len(rounds_t) - 3:][:3], "xyz")}
    assert {"off", "host", "general"} <= set(sched.batch_modes) and first
    victims = set(sched.preempted)
    kinds = {sched.preempted[v].split("/")[1].rsplit("-", 1)[0] for v in victims}
    assert kinds == {"pre-claim", "pre-anti", "pre-spread"}
    for ni in sched.snapshot.node_info_map.values():
        assert ni.requested.milli_cpu <= ni.allocatable.milli_cpu
        assert not victims & {p.key() for p in ni.pods}
    if spec == "1":
        assert set(sched.batch_paths) == {"spec"}


def _gang_world(backoff):
    """Four nodes, each with one priority-1 pod: n0 keeps room for one
    3-cpu gang member, the others 1 cpu; a gang of three anti-affine
    priority-100 members: the device places the first on n0, the other
    two fail."""
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu_torch.api import types as ttypes
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    def cluster(api):
        infos = []
        for i in range(4):
            ni = api.NodeInfo(api.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "8Gi", "pods": 10})
                .label("kubernetes.io/hostname", f"n{i}").obj())
            victim = api.make_pod(f"low-{i}").req({"cpu": "1" if i == 0 else "3"}).priority(
                1).node(f"n{i}").obj()
            ni.add_pod(victim)
            infos.append(ni)
        return infos

    api = tc.torch_api()
    gang = [api.make_pod(f"m{j}").req({"cpu": "3"}).priority(100).pod_group("grp")
            .pod_affinity("kubernetes.io/hostname",
                          api.LabelSelector({"scheduling.x-k8s.io/pod-group": "grp"}),
                          anti=True).obj() for j in range(3)]
    caps = dict(nodes=16, pods=8, value_words=32)
    store = Store()
    store.create_object("PodGroup", ttypes.PodGroup(
        meta=ttypes.ObjectMeta(name="grp", namespace="default"), min_member=3))
    sched = BatchScheduler(cluster(api), caps=Capacities(**caps), device="cpu", client=store)
    clock = lambda: 50.0  # noqa: E731
    sched.coscheduling.now_fn = clock
    sched.coscheduling.gang_backoff_s = backoff
    env = tc.JaxEnv(cluster(tc.jax_api()), caps, clock=clock,
                    plugin_args={"Coscheduling": {"gang_backoff_s": backoff}})
    env.store.create_object("PodGroup", jtypes.PodGroup(
        meta=jtypes.ObjectMeta(name="grp", namespace="default"), min_member=3))
    return sched, env, gang


@pytest.mark.parametrize("backoff", [0.0, 5.0])
def test_rejected_gang_member_preempts_as_jax(backoff):
    """A gang the batch rejects: its unplaced member runs its PostFilter
    without hints (it preempts only when the rejection armed no backoff);
    the placed members preempt nothing."""
    sched, env, gang = _gang_world(backoff)
    jgang = [tc.to_jax(p) for p in gang]
    env.add_pods(jgang)
    placed_t = sched.schedule(gang)
    placed_j = env.schedule(jgang)
    assert placed_t == placed_j and all(v is None for v in placed_t.values())
    assert sched.gang_rejected == env.gang_rejected
    assert sched.nominated == env.nominated and sched.preempted == env.preempted
    assert not sched.fallback
    if backoff:
        assert not sched.nominated and not sched.preempted
    else:
        # the unplaced members preempt (the second around the first's
        # nomination to n0, which its anti-affinity refuses); the member
        # the device placed does not
        assert set(sched.nominated) == {"default/m1", "default/m2"} and sched.preempted
        assert set(sched.preempted.values()) == {"default/m2"}


def test_quota_rejected_pod_never_preempts():
    """A priority-100 pod of a namespace at its quota outranks every bound
    pod, but the gate turns it away: no screen, no PostFilter, no victim;
    a pod of a namespace with headroom preempts."""
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu_torch.api import types as ttypes
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    def cluster(api):
        infos = []
        for i in range(3):
            ni = api.NodeInfo(api.make_node(f"n{i}").capacity(
                {"cpu": "2", "memory": "4Gi", "pods": 10}).obj())
            ns = "full" if i == 0 else "default"
            ni.add_pod(api.make_pod(f"low-{i}", namespace=ns).req({"cpu": "2"}).priority(0)
                       .node(f"n{i}").obj())
            infos.append(ni)
        return infos

    def quota(types_):
        return types_.SchedulingQuota(meta=types_.ObjectMeta(name="q", namespace="full"),
                                      hard={"pods": 1})

    api = tc.torch_api()
    pods = [api.make_pod("over", namespace="full").req({"cpu": "2"}).priority(100).obj(),
            api.make_pod("room", namespace="free").req({"cpu": "2"}).priority(100).obj()]
    caps = dict(nodes=16, pods=8, value_words=32)
    store = Store()
    store.create_object("SchedulingQuota", quota(ttypes))
    sched = BatchScheduler(cluster(api), caps=Capacities(**caps), device="cpu", client=store)
    env = tc.JaxEnv(cluster(tc.jax_api()), caps)
    env.store.create_object("SchedulingQuota", quota(jtypes))
    jpods = [tc.to_jax(p) for p in pods]
    env.add_pods(jpods)
    assert sched.schedule(pods) == env.schedule(jpods)
    assert sched.quota_rejected == env.quota_rejected == {
        "full/over": 'QuotaExceeded: namespace "full" over quota on pods'}
    assert sched.nominated == env.nominated and set(sched.nominated) == {"free/room"}
    assert sched.preempted == env.preempted
    assert all(v == "free/room" for v in sched.preempted.values())
