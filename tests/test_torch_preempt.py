"""The port's preemption against the JAX package's, on the CPU.

* The device screen (``ops/preempt.py``): ``preempt_screen`` and
  ``screen_prefix`` against JAX's on seeded clusters carried over through
  ``interop.py`` (1 to 31 priority classes and unused INT_MAX ones,
  priorities near 2**30 and at 2000000000, ties, all-failed and
  some-failed prefixes, nodes full of higher-priority pods); the float32
  prefix sum against ``jnp.cumsum``; the screen against the host
  prescreen.
* The host Evaluator: ``DefaultPreemption.post_filter`` and
  ``Evaluator.find_candidates`` against a bare JAX Framework's over the
  same NodeInfos (taints, node affinity, host ports, PDBs, nominated and
  terminating pods), with and without the device hints.
* End to end: small PreemptionBasic and PreemptionPVs through
  ``BatchScheduler`` against ``jax_preempt_loop``, with and without the
  speculative rounds.
* The shortcut and the cases the port does not preempt for yet.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cases as tc
from kubernetes_tpu_torch.ops import preempt as tpreempt

def _wide(rng, k):
    """k distinct priorities spread over [2**30, 2**31 - 1)."""
    out = set()
    while len(out) < k:
        out.add(int(rng.randint(2**30, 2**31 - 1)))
    return np.array(sorted(out))


PRIO_REGIMES = {
    "small": lambda rng, k: rng.choice(np.arange(-50, 1000), k, replace=False),
    "wide": _wide,
    "near-2**30": lambda rng, k: 2**30 + rng.choice(np.arange(-200, 200), k, replace=False),
    "2e9": lambda rng, k: np.concatenate(
        [[2000000000], 2000000000 - 1 - rng.choice(np.arange(0, 400), k - 1, replace=False)]),
}


# ----------------------------------------------------------------- the screen


@pytest.mark.parametrize("n", [1, 8, 16, 17, 32, 48, 300])
def test_float_prefix_sum_matches_jnp_cumsum(n):
    rng = np.random.RandomState(n)
    cnt = rng.randint(0, 40, size=(64, n)).astype(np.float32)
    prio = rng.randint(2**30 - 1000, 2**31 - 1, size=n).astype(np.float32)
    prio[rng.randint(n)] = 2000000000
    x = cnt * prio
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    got = tpreempt._xla_cumsum_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _screen_case(seed: int, n_classes: int, regime: str, ties: bool):
    """A JAX DeviceState over 56 seeded nodes (8 of them full of pods that
    outrank every preemptor) and an encoded 32-pod batch, with
    ``n_classes`` distinct priorities in all; class_prio refreshed."""
    from kubernetes_tpu.backend.device_state import DeviceState
    from kubernetes_tpu.ops.schema import Capacities

    rng = np.random.RandomState(seed)
    pool = sorted(int(p) for p in PRIO_REGIMES[regime](rng, n_classes))
    low = pool[:-1] or pool
    spec = tc.preempt_cluster_spec(48, seed, low)
    if ties:
        for d in spec:
            d.update(cpu="4", mem="3Gi", pods=30, taints=[], unschedulable=False)
            d["existing"] = [dict(e, cpu="900m", mem="512Mi", port=0)
                             for e in spec[0]["existing"]]
    for i in range(8):  # full of pods that no preemptor outranks
        spec.append(dict(spec[i], name=f"full-{i}", cpu="2", pods=30, existing=[
            dict(spec[i]["existing"][0], name=f"top-{i}-{j}", cpu="1", priority=pool[-1],
                 terminating=False) for j in range(2)]))
    ds = DeviceState(Capacities(nodes=64, pods=32))
    ds.sync(tc.SnapshotShim(tc.build_nodes(tc.jax_api(), spec)))
    pods = tc.build_preemptors(tc.jax_api(), tc.preemptor_spec(32, seed + 1, pool))
    pb, et = ds.encoder.encode_pods(pods)
    ds._refresh_class_prio()
    return ds, pb, et


def _jax_static_masks(ds, pb, et):
    from kubernetes_tpu.backend import batch as jbatch

    tb = ds.sig_table.encode_topo([])
    res = jbatch.build_schedule_batch_fn()(pb, et, ds.nt, ds.tc, tb, jax.random.PRNGKey(0),
                                           topo_enabled=False, ports_enabled=True)
    return res.static_masks


@pytest.mark.parametrize("n_classes", [1, 2, 7, 16, 31])
@pytest.mark.parametrize("regime", sorted(PRIO_REGIMES))
@pytest.mark.parametrize("failed", ["all", "some"])
def test_screen_matches_jax(n_classes, regime, failed):
    from kubernetes_tpu.ops.preempt import screen_prefix

    if regime == "2e9" and n_classes == 1:
        n_classes = 2  # 2000000000 and one below it
    seed = 100 * n_classes + len(regime) + (failed == "all")
    ds, pb, et = _screen_case(seed, n_classes, regime, ties=n_classes == 7)
    cp = np.asarray(ds.nt.class_prio)
    assert len(set(cp.tolist()) - {2**31 - 1}) == n_classes  # the rest unused
    masks = _jax_static_masks(ds, pb, et)
    rng = np.random.RandomState(seed)
    prefix = np.ones(27, bool) if failed == "all" else rng.uniform(size=27) < 0.5
    want = screen_prefix(pb, ds.nt, masks, prefix)
    nt, tpb, _ = tc.to_port(ds, pb, et)
    tmasks = {k: torch.from_numpy(np.array(v)) for k, v in masks.items()}
    got = tpreempt.screen_prefix(tpb, nt, tmasks, prefix)
    np.testing.assert_array_equal(got.screen.numpy(), np.asarray(want.screen))
    np.testing.assert_array_equal(got.best.numpy(), np.asarray(want.best))
    best = got.best.numpy()
    assert (best[27:] == -1).all() and (best[:27][~prefix] == -1).all()
    if failed == "all":
        assert (best >= 0).sum() > 1  # something to rank
    # a pod that asks for cpu never frees a node full of top-priority pods
    full = [ds.encoder.node_slots[f"full-{i}"] for i in range(8)]
    asks = np.asarray(pb.req)[:, 0] > 0
    assert not got.screen.numpy()[asks][:, full].any()


def _rounding_case():
    """(31 priorities, (i, j), (k, l)): multiples of 128 in [2**30, 2**31)
    with prio_i + prio_j == prio_k + prio_l exactly, such that the victim
    priority sums over classes 0-18 (one pod each) plus one more pod in i
    and j, or in k and l, compare one way when added left to right and
    another way in XLA's order."""
    for seed in range(2000):
        rng = np.random.RandomState(seed)
        pool = np.sort(rng.choice(np.arange(2**23, 2**24 - 1), 31, replace=False)) * 128
        i, k = sorted(rng.choice(16, 2, replace=False))
        l, j = sorted(rng.choice(np.arange(16, 19), 2, replace=False))
        v = pool[i] + pool[j] - pool[k]
        if not pool[l - 1] < v < pool[l + 1]:
            continue
        pool[l] = v
        cnt = np.zeros((2, 31), np.float32)
        cnt[:, :19] = 1
        cnt[0, [i, j]] += 1
        cnt[1, [k, l]] += 1
        x = torch.from_numpy(cnt * pool.astype(np.float32))
        xla = tpreempt._xla_cumsum_f32(x)[:, 18]
        fold = tpreempt._left_fold(x)[:, 18]
        if torch.sign(xla[0] - xla[1]) != torch.sign(fold[0] - fold[1]):
            return [int(p) for p in pool], (i, j), (k, l)
    raise AssertionError("no case found")


def test_screen_rounds_the_priority_sum_as_jax():
    """Every node evicts the same 19 classes (so the highest victim
    priority ties everywhere). Nodes 0 and 1 hold one more pod in classes
    whose priorities sum to the same value, the rest three more: the first
    pick between nodes 0 and 1 follows the rounding of the prefix sum."""
    from kubernetes_tpu.backend.device_state import DeviceState
    from kubernetes_tpu.ops.preempt import screen_prefix
    from kubernetes_tpu.ops.schema import Capacities

    pool, pair0, pair1 = _rounding_case()
    rng = np.random.RandomState(0)
    spec = []
    for n in range(48):
        extra = pair0 if n == 0 else pair1 if n == 1 else rng.randint(19, size=3)
        existing = [dict(name=f"v-{n}-{c}", cpu="100m", mem="0", port=0, priority=pool[c])
                    for c in range(20)]
        existing += [dict(name=f"x-{n}-{e}", cpu="0", mem="0", port=0, priority=pool[c])
                     for e, c in enumerate(extra)]
        spec.append(dict(name=f"node-{n}", cpu="2", mem="4Gi", pods=110, labels={},
                         taints=[], unschedulable=False, images=[], existing=existing))
    ds = DeviceState(Capacities(nodes=64, pods=32))
    ds.sync(tc.SnapshotShim(tc.build_nodes(tc.jax_api(), spec)))
    pods = [tc.jax_api().make_pod(f"p-{i}").req({"cpu": "1900m"}).priority(pool[20 + i % 11])
            .obj() for i in range(32)]
    pb, et = ds.encoder.encode_pods(pods)
    ds._refresh_class_prio()
    want = screen_prefix(pb, ds.nt, _jax_static_masks(ds, pb, et), np.ones(32, bool))
    nt, tpb, _tet = tc.to_port(ds, pb, et)
    got = tpreempt.screen_prefix(tpb, nt, {}, np.ones(32, bool))
    np.testing.assert_array_equal(got.screen.numpy(), np.asarray(want.screen))
    np.testing.assert_array_equal(got.best.numpy(), np.asarray(want.best))
    slots = {ds.encoder.node_slots["node-0"], ds.encoder.node_slots["node-1"]}
    assert int(got.best[0]) in slots and got.screen.numpy()[:, :48].all()


def test_screen_of_the_port_static_masks_matches_jax():
    """The whole device side of the port: its own static phase's masks into
    its screen, against JAX's masks into JAX's screen."""
    from kubernetes_tpu.ops.preempt import screen_prefix
    from kubernetes_tpu_torch.backend.batch import static_phase

    ds, pb, et = _screen_case(7, 9, "near-2**30", ties=False)
    want = screen_prefix(pb, ds.nt, _jax_static_masks(ds, pb, et), np.ones(32, bool))
    nt, tpb, tet = tc.to_port(ds, pb, et)
    got = tpreempt.screen_prefix(tpb, nt, static_phase(tpb, tet, nt)[0], np.ones(32, bool))
    np.testing.assert_array_equal(got.screen.numpy(), np.asarray(want.screen))
    np.testing.assert_array_equal(got.best.numpy(), np.asarray(want.best))


def test_screen_matches_host_prescreen():
    """The screen equals the host ``_max_free_prescreen`` on a mixed
    cluster (exact for the resource columns both model): nodes full of
    evictable pods, nodes full of higher-priority pods, a small empty
    node."""
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.backend.device_state import DeviceState
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.framework.preemption import Evaluator
    from kubernetes_tpu_torch.framework.types import NodeInfo
    from kubernetes_tpu_torch.ops.schema import Capacities

    infos = []
    for kind, prio in (("evict", 0), ("hard", 2000)):
        for i in range(3):
            ni = NodeInfo(make_node(f"{kind}-{i}").capacity(
                {"cpu": "2", "memory": "4Gi", "pods": 10}).obj())
            pod = make_pod(f"{kind}-pod-{i}").req({"cpu": "1500m", "memory": "3Gi"}).priority(
                prio).node(f"{kind}-{i}").obj()
            ni.add_pod(pod)
            infos.append(ni)
    infos.append(NodeInfo(make_node("tiny").capacity(
        {"cpu": "500m", "memory": "1Gi", "pods": 10}).obj()))
    ds = DeviceState(Capacities(nodes=16, pods=4), "cpu")
    ds.sync(Snapshot(infos))
    pods = [make_pod("claim").req({"cpu": "1", "memory": "2Gi"}).priority(1000).obj()]
    pb, _et = ds.encoder.encode_pods(pods)
    screen = tpreempt.screen_prefix(pb, ds.preempt_inputs(), {}, [True]).screen.numpy()[0]
    host = Evaluator._max_free_prescreen(pods[0], infos)
    assert [bool(screen[ds.encoder.node_slots[ni.node.meta.name]]) for ni in infos] == host
    assert host == [True] * 3 + [False] * 4


# ----------------------------------------------------------------- the Evaluator

PDB_SPEC = [("pdb-a", "a", 1), ("pdb-b", "b", 0), ("pdb-c", "c", 3)]


def _evaluator_world(seed: int, with_pdbs: bool):
    """The same seeded cluster, preemptors and PDBs in both packages, with
    three pods already nominated (in both nominators): (JAX infos, JAX
    client, JAX framework, JAX plugin, JAX preemptors, port infos, port
    plugin, port preemptors, port eviction log)."""
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.api import types as ttypes
    from kubernetes_tpu_torch.framework.plugins.defaultpreemption import DefaultPreemption
    from kubernetes_tpu_torch.framework.runtime import Framework, PodNominator

    prios = [0, 5, 10, 50]
    spec = tc.preempt_cluster_spec(24, seed, prios)
    pspec = tc.preemptor_spec(12, seed + 1, [10, 50, 100, 1000])
    nomspec = tc.preemptor_spec(3, seed + 2, [20, 60, 2000])
    for i, d in enumerate(nomspec):
        d["name"] = f"nominated-{i}"
        d["never"] = False
    pdb_spec = PDB_SPEC if with_pdbs else []

    jinfos = tc.build_nodes(tc.jax_api(), spec)
    jpods = tc.build_preemptors(tc.jax_api(), pspec)
    jnoms = tc.build_preemptors(tc.jax_api(), nomspec)
    client = tc.JaxPreemptClient(ClusterStore(), {p.key(): p for p in jpods + jnoms},
                                 tc.pdbs(jtypes, pdb_spec))
    fwk, plugin = tc.jax_framework(lambda: jinfos, client)

    tinfos = tc.build_nodes(tc.torch_api(), spec)
    tpods = tc.build_preemptors(tc.torch_api(), pspec)
    tnoms = tc.build_preemptors(tc.torch_api(), nomspec)
    log = {"evicted": [], "cleared": []}
    nominator = PodNominator()
    tplugin = DefaultPreemption(
        Framework({"snapshot_fn": lambda: tinfos, "nominator": nominator}).filters,
        lambda victim, pod: log["evicted"].append((victim.key(), pod.key())),
        lambda pod: log["cleared"].append(pod.key()),
        pdb_lister=lambda: tc.pdbs(ttypes, pdb_spec))
    for i, (jp, tp) in enumerate(zip(jnoms, tnoms)):
        node = spec[3 * i + 1]["name"]
        fwk.nominator.add_nominated_pod(jp, node)
        nominator.add_nominated_pod(tp, node)
        jp.status.nominated_node_name = tp.status.nominated_node_name = node
    return jinfos, client, fwk, plugin, jpods, tinfos, tplugin, tpods, log


def _hints(rng, infos, kind):
    """Device-style hints over ``infos`` (slot = list index): a random
    screen row and a random top node among its True entries, or an
    all-False row."""
    slot_of = {ni.node.meta.name: i for i, ni in enumerate(infos)}
    row = rng.uniform(size=len(infos)) < (0.0 if kind == "none-viable" else 0.7)
    best = None
    if row.any() and kind != "no-best":
        best = infos[int(rng.choice(np.flatnonzero(row)))].node.meta.name
    return row, slot_of, best


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("hints", ["none", "screen", "no-best", "none-viable"])
@pytest.mark.parametrize("with_pdbs", [False, True])
def test_post_filter_matches_jax(seed, hints, with_pdbs):
    from kubernetes_tpu.framework.interface import CycleState

    jinfos, client, fwk, plugin, jpods, tinfos, tplugin, tpods, log = _evaluator_world(
        seed, with_pdbs)
    rng = np.random.RandomState(seed)
    outcomes = []
    for jp, tp in zip(jpods, tpods):
        state = CycleState()
        h = None if hints == "none" else _hints(rng, jinfos, hints)
        if h is not None:
            state.write(plugin.HINTS_KEY, h)
        client.preemptor = jp.key()
        jnode, st = plugin.post_filter(state, jp, {})
        tnode, reason = tplugin.post_filter(tp, h)
        assert (jnode if st.is_success() else None) == tnode, jp.key()
        assert (reason is None) == st.is_success()
        if tnode is not None:
            fwk.nominator.add_nominated_pod(jp, jnode)
            client.update_pod_nominated_node(jp.key(), jnode)
            tplugin.filters.nominator.add_nominated_pod(tp, tnode)
        outcomes.append(tnode)
    assert [k for k, _ in log["evicted"]] == client.deleted
    first = {}
    for victim, preemptor in log["evicted"]:
        first.setdefault(victim, preemptor)
    assert first == client.preempted
    # the nominations of lower-priority pods cleared on the chosen nodes
    assert log["cleared"] == client.cleared
    if hints != "none-viable":
        assert any(outcomes)  # something was preempted for
    else:
        assert not any(outcomes) and not log["evicted"]


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("with_pdbs", [False, True])
def test_find_candidates_matches_jax(seed, with_pdbs):
    """Every candidate (node, victims in order, PDB violations) and the
    pick, for each preemptor, from the same random offset."""
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.preemption import Evaluator as JEvaluator
    from kubernetes_tpu_torch.framework.preemption import Evaluator

    jinfos, client, fwk, _plugin, jpods, tinfos, tplugin, tpods, _log = _evaluator_world(
        seed, with_pdbs)
    seen_violations = 0
    for k, (jp, tp) in enumerate(zip(jpods, tpods)):
        state = CycleState()
        _, st = fwk.run_pre_filter_plugins(state, jp)
        tstate, reason = tplugin.filters.pre_filter(tp)
        assert st.is_success() == (reason is None)
        if reason is not None:
            continue
        jev = JEvaluator("DefaultPreemption", fwk, client.list_pdbs, state,
                         rng=random.Random(k))
        tev = Evaluator(tplugin.filters, tstate, tplugin.pdb_lister(), None, None,
                        random.Random(k))
        jc, _diag = jev.find_candidates(jp, {}, jinfos)
        tcands = tev.find_candidates(tp, tinfos)
        as_tuple = lambda c: (c.node_name, [v.key() for v in c.victims],  # noqa: E731
                              c.num_pdb_violations)
        assert [as_tuple(c) for c in tcands] == [as_tuple(c) for c in jc], jp.key()
        if jc:
            assert as_tuple(tev.select_candidate(tcands)) == as_tuple(jev.select_candidate(jc))
        seen_violations += sum(c.num_pdb_violations for c in tcands)
    if with_pdbs and seed == 5:
        assert seen_violations > 0  # a PDB was violated somewhere


# ----------------------------------------------------------------- end to end


@pytest.mark.parametrize("spec", ["0", "1"])
@pytest.mark.parametrize("name", sorted(tc.PREEMPT_WORKLOADS))
def test_preemption_workload_matches_jax(name, spec, monkeypatch):
    monkeypatch.setenv("KTPU_SPEC", spec)
    jax_out, port_out, sched = tc.run_preempt_workload_both(name)
    for key in ("placed", "rounds", "preempted", "fallback"):
        assert port_out[key] == jax_out[key], key
    placed = port_out["placed"]
    assert all(v is not None for v in placed.values())
    n, n_init, n_meas, _ = tc.PREEMPT_WORKLOADS[name]
    assert len(placed) == n_init + n_meas + 8 and not sched.nominated
    assert port_out["rounds"] and len(port_out["preempted"]) >= 2 * (n_meas + 8) - 2 * n
    assert set(sched.batch_paths) == {"spec" if spec == "1" else "fused"}
    victims = set(port_out["preempted"])
    for ni in sched.snapshot.node_info_map.values():
        assert ni.requested.milli_cpu <= ni.allocatable.milli_cpu
        assert ni.requested.memory <= ni.allocatable.memory
        assert not victims & {p.key() for p in ni.pods}


# ----------------------------------------------------------------- shortcut, unported


def _full_cluster(prio: int, nodes: int = 4):
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.framework.types import NodeInfo

    infos = []
    for i in range(nodes):
        ni = NodeInfo(make_node(f"n{i}").capacity({"cpu": "2", "memory": "4Gi", "pods": 10})
                      .label("kubernetes.io/hostname", f"n{i}").obj())
        for j in range(2):
            ni.add_pod(make_pod(f"low-{i}-{j}").req({"cpu": "1", "memory": "1Gi"})
                       .priority(prio).node(f"n{i}").obj())
        infos.append(ni)
    return infos


def _sched(infos, **kw):
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    return BatchScheduler(infos, caps=Capacities(nodes=16, pods=8, value_words=32),
                          device="cpu", **kw)


def test_equal_priorities_take_the_shortcut(monkeypatch):
    """No failed pod outranks a bound pod: no device screen, no preemption."""
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.backend import batch_scheduler

    def no_screen(*a, **k):
        raise AssertionError("the screen ran")

    monkeypatch.setattr(batch_scheduler, "screen_prefix", no_screen)
    sched = _sched(_full_cluster(prio=7))
    pods = [make_pod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).priority(7).obj()
            for i in range(3)]
    assert sched.schedule(pods) == {p.key(): None for p in pods}
    assert not sched.nominated and not sched.preempted and not sched.fallback
    assert sched.screen_seconds["preempt_screen"] > 0  # the shortcut's host screen


def test_higher_priority_preempts_and_binds_on_resubmission():
    from kubernetes_tpu_torch.api.wrappers import make_pod

    sched = _sched(_full_cluster(prio=0))
    pods = [make_pod(f"high-{i}").req({"cpu": "2", "memory": "2Gi"}).priority(1000).obj()
            for i in range(3)]
    assert sched.schedule(pods) == {p.key(): None for p in pods}
    assert len(sched.nominated) == 3 and len(set(sched.nominated.values())) == 3
    assert len(sched.preempted) == 6 and set(sched.preempted.values()) == {p.key() for p in pods}
    nominated = dict(sched.nominated)
    for p in pods:
        assert p.status.nominated_node_name == nominated[p.key()]
    placed = sched.schedule(pods)
    assert placed == nominated and not sched.nominated


def test_never_policy_does_not_preempt():
    from kubernetes_tpu_torch.api.wrappers import make_pod

    sched = _sched(_full_cluster(prio=0))
    pod = make_pod("never").req({"cpu": "2", "memory": "2Gi"}).priority(1000).obj()
    pod.spec.preemption_policy = "Never"
    assert sched.schedule([pod]) == {pod.key(): None}
    assert not sched.nominated and not sched.preempted and not sched.fallback


def _env_like(infos_fn, store=None):
    """A JaxEnv over the JAX twin of the cluster ``infos_fn`` builds (port
    API), with the port store's objects."""
    env = tc.JaxEnv([tc.to_jax_node_info(ni) for ni in infos_fn()],
                    dict(nodes=16, pods=8, value_words=32))
    if store is not None:
        tc.copy_store_objects(store, env.store)
    return env


def test_topology_and_claim_preemptors_land_in_fallback():
    """A topology-batch preemptor and a claim preemptor outranking the bound
    pods now preempt (they used to land in ``fallback``), as the JAX
    package's PostFilter does: the same nomination and victims, nothing in
    ``fallback``."""
    from kubernetes_tpu_torch.api.types import LabelSelector
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.perf import workloads

    sched = _sched(_full_cluster(prio=0))
    env = _env_like(lambda: _full_cluster(prio=0))
    anti = make_pod("anti").req({"cpu": "2", "memory": "2Gi"}).priority(1000).label(
        "app", "x").pod_affinity("kubernetes.io/hostname",
                                 LabelSelector(match_labels={"app": "x"}), anti=True).obj()
    janti = tc.to_jax(anti)
    env.add_pods([janti])
    assert sched.schedule([anti]) == env.schedule([janti]) == {anti.key(): None}
    assert sched.batch_modes == env.modes == ["host"]
    assert sched.nominated == env.nominated and set(sched.nominated) == {anti.key()}
    assert sched.preempted == env.preempted and len(sched.preempted) == 2
    assert not sched.fallback

    # a claim pod, in a mode off batch, outranking the bound pods
    shape = workloads.PodShape("dra", req={"cpu": "2", "memory": "2Gi"},
                               claim=workloads.TPU_CLAIM, priority=1000)
    store = Store()
    shape.populate(store, 1)

    def infos():
        out = _full_cluster(prio=0)
        for ni in out:
            ni.node.status.device_attributes = {"tpu.dev/cores": 8, "tpu.dev/gen": "v5"}
        return out

    sched = _sched(infos(), client=store)
    env = _env_like(infos, store)
    claim_pod = shape.pods(1)[0]
    jclaim = tc.to_jax(claim_pod)
    env.add_pods([jclaim])
    assert sched.schedule([claim_pod]) == env.schedule([jclaim]) == {claim_pod.key(): None}
    assert sched.batch_modes == env.modes == ["off"]
    assert sched.nominated == env.nominated and set(sched.nominated) == {claim_pod.key()}
    assert sched.preempted == env.preempted and len(sched.preempted) == 2
    assert not sched.fallback


def test_fallback_preemptor_binds_on_resubmission_and_leaves_fallback():
    """A topology-batch preemptor is nominated (never put in ``fallback``)
    and, resubmitted with an empty node added meanwhile, binds where the
    JAX loop binds it: both runs nominate, evict and place alike, and
    nothing is left in ``fallback``, ``retry`` or ``nominated``."""
    from kubernetes_tpu_torch.api.types import LabelSelector
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.framework.types import NodeInfo

    sched = _sched(_full_cluster(prio=0))
    env = _env_like(lambda: _full_cluster(prio=0))
    anti = make_pod("anti").req({"cpu": "2", "memory": "2Gi"}).priority(1000).label(
        "app", "x").pod_affinity("kubernetes.io/hostname",
                                 LabelSelector(match_labels={"app": "x"}), anti=True).obj()
    janti = tc.to_jax(anti)
    env.add_pods([janti])
    assert sched.schedule([anti]) == env.schedule([janti]) == {anti.key(): None}
    assert not sched.fallback and set(sched.nominated) == {anti.key()}
    assert sched.nominated == env.nominated and sched.preempted == env.preempted
    node = sched.nominated[anti.key()]

    def room():
        return NodeInfo(make_node("room").capacity({"cpu": "2", "memory": "4Gi", "pods": 10})
                        .label("kubernetes.io/hostname", "room").obj())

    sched.add_node(room())
    env.add_node(tc.to_jax_node_info(room()))
    assert sched.schedule([anti]) == env.schedule([janti]) == {anti.key(): node}
    assert sched.batch_modes == env.modes == ["host", "host"]
    assert not sched.fallback and not sched.retry and not sched.nominated
    assert not env.fallback and not env.retry and not env.nominated


def test_min_pod_priority_follows_adds_and_removes():
    """The shortcut's lowest bound priority comes from the NodeInfos' own
    buckets: it follows every add and remove, a node removal included."""
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.cache.snapshot import Snapshot

    infos = _full_cluster(prio=50, nodes=3)
    snap = Snapshot(infos)
    assert snap.min_pod_priority() == 50
    low = make_pod("low").req({"cpu": "100m"}).priority(-7).node("n1").obj()
    infos[1].add_pod(low)
    assert snap.min_pod_priority() == -7
    snap.remove("n1")
    assert snap.min_pod_priority() == 50
    for ni in infos[0::2]:
        for pod in list(ni.pods):
            ni.remove_pod(pod)
    assert Snapshot([]).min_pod_priority() is None
    assert snap.min_pod_priority() is None
