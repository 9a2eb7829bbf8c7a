"""The port's gang path on the CPU against the JAX package, exactly:

* ``assign_gangs`` and ``gang_verdicts`` over seeded masks (up to 8 gangs
  of up to 32 members on up to 300 nodes: colliding preferences, gangs
  with no distinct-node cover, padding members, ``prefer = -1``);
* Coscheduling's PreFilter, ``reject_gang`` and PostBind against the JAX
  plugin: a missing group, too few members, the rejection backoff under a
  fake clock, the PodGroup status writes;
* ``BatchScheduler`` on a small SchedulingGangs against the JAX batched
  loop (the scan and the rounds); a gang with no distinct-node cover
  rejected whole, its placed members surrendered, and the next batch's
  device state equal to JAX's; a below-quorum gang dropped before encode;
  the cases this slice leaves out raising NotImplementedError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (jax_api, jax_coscheduling, jax_gang_loop, pod_group_status,
                          run_gang_workload_both, torch_api)
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu.ops import gang as jgang
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.backend import batch_scheduler
from kubernetes_tpu_torch.ops import gang as tgang

# ------------------------------------------------------------ the assigner


def _gang_masks(seed: int):
    """[G, M, N] feasibility, [G, M] preferences and [G, M] active members:
    sparse rows (so some gangs have no cover), preferences that collide
    within a gang, point at infeasible nodes, or are -1."""
    rng = np.random.RandomState(seed)
    g, m, n = int(rng.randint(1, 9)), int(rng.randint(1, 33)), int(rng.randint(1, 301))
    density = rng.choice([0.02, 0.1, 0.5])
    feasible = rng.uniform(size=(g, m, n)) < density
    prefer = rng.randint(-1, n, size=(g, m)).astype(np.int32)
    prefer[:, 1::3] = prefer[:, :1]                                 # collisions
    prefer[rng.uniform(size=(g, m)) < 0.2] = -1
    active = np.ones((g, m), bool)
    for gi in range(g):
        active[gi, rng.randint(1, m + 1):] = False                  # padding members
    return feasible, prefer, active


@pytest.mark.parametrize("seed", range(8))
def test_assign_gangs_matches_jax(seed):
    feasible, prefer, active = _gang_masks(seed)
    jidx, jok = jgang.assign_gangs(jnp.asarray(feasible), jnp.asarray(prefer),
                                   jnp.asarray(active))
    tidx, tok = tgang.assign_gangs(*map(torch.from_numpy, (feasible, prefer, active)))
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    for g in range(len(active)):
        want, ok = jgang.gang_assign_host(feasible[g], prefer[g], active[g])
        assert bool(tok[g]) == ok
        if ok:
            assert tidx[g].tolist() == want


def test_assign_gangs_takes_the_first_free_slot():
    """A taken preference falls back to the first available slot; a gang
    short of one distinct node is all -1."""
    feasible = np.zeros((2, 3, 6), bool)
    feasible[0, :, 2:5] = True
    feasible[1, :, 1:3] = True
    prefer = np.array([[3, 3, -1], [1, 2, 1]], np.int32)
    active = np.ones((2, 3), bool)
    idx, ok = tgang.assign_gangs(*map(torch.from_numpy, (feasible, prefer, active)))
    assert idx.tolist() == [[3, 2, 4], [-1, -1, -1]] and ok.tolist() == [True, False]


@pytest.mark.parametrize("seed", range(6))
def test_gang_verdicts_match_jax(seed):
    rng = np.random.RandomState(seed)
    p, n = 64, int(rng.randint(8, 300))
    first_fail = np.where(rng.uniform(size=(p, n)) < rng.choice([0.05, 0.3, 0.7]), 0,
                          rng.randint(1, 12, size=(p, n))).astype(np.int8)
    node_idx = np.where(rng.uniform(size=p) < 0.85, rng.randint(0, n, size=p), -1)
    node_idx = node_idx.astype(np.int32)
    rows = rng.permutation(p)
    sizes = [int(rng.randint(1, 17)) for _ in range(int(rng.randint(1, 6)))]
    groups, nxt = [], 0
    for k in sizes:
        groups.append(rows[nxt:nxt + k].tolist())
        nxt += k
    member_idx, member_valid = tbatch.gang_member_index(groups, "cpu")
    got = tbatch.gang_verdicts(torch.from_numpy(node_idx), torch.from_numpy(first_fail),
                               member_idx, member_valid)
    want = jbatch.gang_verdicts(jnp.asarray(node_idx), jnp.asarray(first_fail),
                                jnp.asarray(member_idx.numpy()), jnp.asarray(member_valid.numpy()))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert member_idx.shape == (max(2, 1 << (len(groups) - 1).bit_length()),
                                max(2, 1 << (max(sizes) - 1).bit_length()))


# ------------------------------------------------------------ Coscheduling


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _plugins(clock):
    """The port's and the JAX plugin over stores holding PodGroup a (min 3)
    and b (min 2), and the gang pods of both packages: three of a, one of
    b, two of c (no PodGroup)."""
    from kubernetes_tpu.api.types import ObjectMeta as JMeta, PodGroup as JPodGroup
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.framework.plugins.coscheduling import Coscheduling

    def pods(api):
        return [api.make_pod(f"{g}-{j}").pod_group(g).obj()
                for g, k in (("a", 3), ("b", 1), ("c", 2)) for j in range(k)]

    jstore, tstore = ClusterStore(), Store()
    for store, meta, pg in ((jstore, JMeta, JPodGroup), (tstore, ObjectMeta, PodGroup)):
        for name, k in (("a", 3), ("b", 2)):
            store.create_object("PodGroup", pg(meta=meta(name=name, namespace="default"),
                                               min_member=k))
    jpods, tpods = pods(jax_api()), pods(torch_api())
    for pod in jpods:
        jstore.create_pod(pod)
    members = {}
    for pod in tpods:
        members.setdefault(pod.meta.namespace + "/" + pod.meta.labels[
            "scheduling.x-k8s.io/pod-group"], set()).add(pod.key())
    bound = {}
    plugin = Coscheduling(tstore, lambda g, only: len(bound.get(g, set()) | (
        set() if only else members.get(g, set()))), now_fn=clock)
    return jax_coscheduling(jstore, now_fn=clock), jstore, jpods, plugin, tstore, tpods, bound


def test_coscheduling_matches_jax_plugin():
    from kubernetes_tpu.framework.interface import CycleState

    clock = Clock()
    jplug, jstore, jpods, tplug, tstore, tpods, bound = _plugins(clock)

    def verdicts():
        out = []
        for jp, tp in zip(jpods, tpods):
            _, st = jplug.pre_filter(CycleState(), jp)
            _restrict, fail = tplug.pre_filter(None, tp)
            got = fail.reason if fail is not None else None
            assert (got is None) == st.is_success()
            assert got is None or (got,) == tuple(st.reasons)
            out.append(got)
        return out

    first = verdicts()
    assert first[:3] == [None] * 3                       # a: 3 members >= min 3
    assert first[3].startswith("fewer than minMember") and first[4].startswith("pod group not")
    for plug in (jplug, tplug):
        plug.reject_gang("default/a", "infeasible")
    assert pod_group_status(tstore) == pod_group_status(jstore)
    assert verdicts()[0].startswith("pod group is in rejection backoff")
    clock.t += 4.9
    assert verdicts()[0].startswith("pod group is in rejection backoff")
    clock.t += 0.2                                        # the 5 s backoff is over
    assert verdicts()[:3] == [None] * 3
    assert tplug.rejections == jplug.metrics.gangs_rejected.by_label == {"infeasible": 1}
    # PostBind: two members bound, then the third (quorum: Running)
    for n_bound in (2, 1):
        keys = [p.key() for p in tpods[:3]]
        bound.setdefault("default/a", set()).update(keys[:2] if n_bound == 2 else keys)
        for p in jpods[:3][:2] if n_bound == 2 else jpods[2:3]:
            jstore.pods[p.key()] = p.clone()
            jstore.pods[p.key()].spec.node_name = "n"
        tplug.post_bind_batch(tpods[:2] if n_bound == 2 else tpods[2:3])
        jplug.post_bind_batch([(None, p, "n") for p in (jpods[:2] if n_bound == 2
                                                         else jpods[2:3])])
        assert pod_group_status(tstore) == pod_group_status(jstore)
    assert pod_group_status(tstore)["default/a"] == ("Running", 3)


# ------------------------------------------------------------ BatchScheduler


@pytest.mark.parametrize("spec", ["0", "1"])
def test_scheduling_gangs_matches_jax(monkeypatch, spec):
    """Small SchedulingGangs: placements, PodGroup status and the flat
    gangs' verdicts equal the JAX loop's; every gang on distinct hosts."""
    monkeypatch.setenv("KTPU_SPEC", spec)
    verdicts = []
    inner = batch_scheduler.gang_verdicts

    def record(*args):
        out = inner(*args)
        verdicts.append([a.numpy() for a in out])
        return out

    monkeypatch.setattr(batch_scheduler, "gang_verdicts", record)
    placed_j, rejected_j, jstore, trace, placed_t, tstore, sched = run_gang_workload_both(
        "scheduling_gangs")
    assert placed_t == placed_j and all(placed_t.values())
    assert rejected_j == sched.gang_rejected == {}
    assert pod_group_status(tstore) == pod_group_status(jstore)
    assert sched.batch_modes == [t["mode"] for t in trace] == ["host", "host"]
    assert set(sched.batch_paths) == {"scan" if spec == "0" else "spec"}
    want = [t["verdicts"] for t in trace]
    assert len(verdicts) == len(want) == 2
    for got, exp in zip(verdicts, want):
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)
    by_group = {}
    for ni in sched.snapshot.node_info_map.values():
        for p in ni.pods:
            by_group.setdefault(p.meta.labels["scheduling.x-k8s.io/pod-group"], []).append(
                ni.node.meta.name)
    assert len(by_group) == 6
    for nodes in by_group.values():
        assert len(set(nodes)) == len(nodes) in (8, 32)


def _gang_cluster(api, n=6):
    infos = []
    for i in range(n):
        nw = api.make_node(f"node-{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": 20})
        nw.label("topology.kubernetes.io/zone", f"zone-{i % 2}")
        nw.label("kubernetes.io/hostname", f"node-{i}")
        infos.append(api.NodeInfo(nw.obj()))
    return infos


def _gang_pods(api, group, size, prefix=None, anti=True, cpu="500m"):
    out = []
    for j in range(size):
        pw = api.make_pod(f"{prefix or group}-{j}").req({"cpu": cpu, "memory": "256Mi"})
        pw.pod_group(group)
        if anti:
            pw.pod_affinity("kubernetes.io/hostname",
                            api.LabelSelector({"scheduling.x-k8s.io/pod-group": group}),
                            anti=True)
        out.append(pw.obj())
    return out


def _plain(api, names, cpu="250m"):
    return [api.make_pod(n).req({"cpu": cpu, "memory": "128Mi"}).obj() for n in names]


def _both(groups, caps=None):
    """JAX loop state and the port's BatchScheduler over ``_gang_cluster``,
    with PodGroups ``groups`` (name -> min_member) in both stores."""
    from kubernetes_tpu.api.types import ObjectMeta as JMeta, PodGroup as JPodGroup
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    caps = caps or dict(nodes=128, pods=16, value_words=32, sigs=16, ex_terms=16)
    clock = Clock()
    jstore, tstore = ClusterStore(), Store()
    for store, meta, pg in ((jstore, JMeta, JPodGroup), (tstore, ObjectMeta, PodGroup)):
        for name, k in groups.items():
            store.create_object("PodGroup", pg(meta=meta(name=name, namespace="default"),
                                               min_member=k))
    jax_side = {"ds": JDeviceState(JCaps(**caps)), "fn": jbatch.build_schedule_batch_fn(),
                "infos": {ni.node.meta.name: ni for ni in _gang_cluster(jax_api())},
                "store": jstore, "plugin": jax_coscheduling(jstore, now_fn=clock),
                "rejected": {}, "trace": [], "batch": caps["pods"]}
    sched = BatchScheduler(_gang_cluster(torch_api()), caps=Capacities(**caps), device="cpu",
                           client=tstore)
    sched.coscheduling.now_fn = clock
    return jax_side, sched, tstore, clock


def _jax_schedule(js, pods):
    for pod in pods:
        if pod.key() not in js["store"].pods:
            js["store"].create_pod(pod)
    return jax_gang_loop(js["ds"], js["fn"], js["infos"], js["store"], js["plugin"], pods,
                         js["batch"], js["rejected"], js["trace"])


def _port_trace(monkeypatch, sched):
    """Per batch of ``sched``: the device's requested and sel_counts as the
    program reads them, and the flat gangs' verdicts."""
    trace = []
    inner_batch, inner_verdicts = batch_scheduler.schedule_batch, batch_scheduler.gang_verdicts

    def batch(pb, et, nt, *args, **kw):
        trace.append({"requested": nt.requested.clone().numpy(),
                      "sel_counts": sched.state.tc.sel_counts.clone().numpy(),
                      "verdicts": None})
        return inner_batch(pb, et, nt, *args, **kw)

    def verdicts(*args):
        out = inner_verdicts(*args)
        trace[-1]["verdicts"] = [a.numpy() for a in out]
        return out

    monkeypatch.setattr(batch_scheduler, "schedule_batch", batch)
    monkeypatch.setattr(batch_scheduler, "gang_verdicts", verdicts)
    return trace


def _same_trace(port, jax_trace):
    assert len(port) == len(jax_trace)
    for a, b in zip(port, jax_trace):
        np.testing.assert_array_equal(a["requested"], b["requested"])
        np.testing.assert_array_equal(a["sel_counts"], b["sel_counts"])
        assert (a["verdicts"] is None) == (b["verdicts"] is None)
        for x, y in zip(a["verdicts"] or (), b["verdicts"] or ()):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("spec", ["0", "1"])
def test_infeasible_gang_rejected_whole(monkeypatch, spec):
    """A gang of 8 anti-affine members on 6 hosts: the batch places 6 and
    fails 2, so the gang is rejected whole ("infeasible": no distinct-node
    cover) and its 6 placements surrendered. The next batch's device state
    (requested and the selector counts) equals JAX's, and a pod anti-affine
    to the gang finds every host free of it; within the backoff the gang
    fails its PreFilter, after it the gang is judged again."""
    monkeypatch.setenv("KTPU_SPEC", spec)
    js, sched, tstore, clock = _both({"big": 8, "pair": 2})
    trace = _port_trace(monkeypatch, sched)
    calls = [
        lambda api: (_gang_pods(api, "big", 8) + _gang_pods(api, "pair", 2)
                     + _plain(api, ["p-0", "p-1"])),
        lambda api: ([api.make_pod("watch").req({"cpu": "100m"}).pod_affinity(
            "kubernetes.io/hostname",
            api.LabelSelector({"scheduling.x-k8s.io/pod-group": "big"}), anti=True).obj()]
            + _plain(api, ["q-0", "q-1"])),
        lambda api: _gang_pods(api, "big", 8),
    ]
    for make in calls:
        placed_j = _jax_schedule(js, make(jax_api()))
        placed_t = sched.schedule(make(torch_api()))
        assert placed_t == placed_j
        assert sched.gang_rejected == js["rejected"]
        assert pod_group_status(tstore) == pod_group_status(js["store"])
    _same_trace(trace, js["trace"])
    assert js["trace"][0]["mode"] == js["trace"][1]["mode"] == "host"
    assert {k: v for k, v in sched.gang_rejected.items() if k.startswith("default/big")} == {
        f"default/big-{j}": 'pod group is in rejection backoff "default/big"' for j in range(8)}
    # after the first call: every big member None, the pair and plain pods bound
    assert trace[0]["verdicts"][0].tolist()[:2] == [False, True]
    # the next batch counts the pair's two members and none of the
    # surrendered ones (row 1: big's selector, row 2: pair's)
    rows = sched.state.sig_table._sig_rows
    assert [r.selector.match_labels for r in rows[1:3]] == [
        {"scheduling.x-k8s.io/pod-group": g} for g in ("big", "pair")]
    assert trace[1]["sel_counts"][1].sum() == 0 and trace[1]["sel_counts"][2].sum() == 2
    assert pod_group_status(tstore)["default/big"] == ("Pending", 0)
    assert sched.coscheduling.rejections == {"infeasible": 1}
    clock.t += 6.0
    placed_j = _jax_schedule(js, _gang_pods(jax_api(), "big", 8))
    assert sched.schedule(_gang_pods(torch_api(), "big", 8)) == placed_j
    assert sched.gang_rejected == js["rejected"]
    assert set(sched.gang_rejected.values()) == {"infeasible"}
    assert sched.coscheduling.rejections == {"infeasible": 2}
    assert sched.fallback == {} and sched.retry == {}


def test_surrendered_rows_repaired_on_next_sync():
    """After a rejected gang, the next sync uploads the surrendered rows
    from the snapshot: requested equals a fresh encode of the cluster."""
    from kubernetes_tpu_torch.backend.device_state import DeviceState

    _js, sched, _store, _clock = _both({"big": 8})
    placed = sched.schedule(_gang_pods(torch_api(), "big", 8) + _plain(torch_api(), ["a"]))
    assert placed["default/a"] and not any(v for k, v in placed.items() if "big" in k)
    sched.state.sync(sched.snapshot)
    fresh = DeviceState(sched.caps, "cpu")
    fresh.sync(sched.snapshot)
    np.testing.assert_array_equal(sched.state.nt.requested.numpy(), fresh.nt.requested.numpy())
    assert int(sched.state.nt.requested[:, 0].sum()) == 250


def test_below_quorum_gang_dropped_before_encode():
    """Three members of a group that needs four fail the PreFilter and take
    no batch row: the rest of the batch places as the same batch without
    them (and as the JAX loop)."""
    js, sched, tstore, _clock = _both({"quad": 4, "duo": 2})

    def pods(api, with_quad=True):
        quad = _gang_pods(api, "quad", 3, anti=False) if with_quad else []
        return (_plain(api, ["x-0"]) + quad + _gang_pods(api, "duo", 2)
                + _plain(api, ["x-1", "x-2"]))

    placed_j = _jax_schedule(js, pods(jax_api()))
    placed_t = sched.schedule(pods(torch_api()))
    assert placed_t == placed_j
    assert sched.gang_rejected == js["rejected"] == {
        f"default/quad-{j}": 'fewer than minMember sibling pods exist for "default/quad"'
        for j in range(3)}
    _js2, alone, _s2, _c2 = _both({"quad": 4, "duo": 2})
    without = alone.schedule(pods(torch_api(), with_quad=False))
    assert {k: v for k, v in placed_t.items() if "quad" not in k} == without
    assert sched.batches == 1 and pod_group_status(tstore)["default/duo"] == ("Running", 2)


def test_unported_gang_cases_raise():
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    api = torch_api()
    _js, sched, _store, _clock = _both({"g": 3}, caps=dict(nodes=128, pods=4, value_words=32))
    straddle = _plain(api, ["a", "b"]) + _gang_pods(api, "g", 3, anti=False)
    with pytest.raises(NotImplementedError, match="straddles a batch boundary"):
        sched.schedule(straddle)
    claim = api.make_pod("c").pod_group("g").resource_claim("accel",
                                                            claim_name="tpu-claim").obj()
    vol = api.make_pod("v").pod_group("g").pvc("data").obj()
    for pod in (claim, vol):
        with pytest.raises(NotImplementedError, match="gang pod with resource claims"):
            sched.schedule([pod])
    storeless = BatchScheduler(_gang_cluster(api), caps=Capacities(nodes=128, pods=4),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="without an object store"):
        storeless.schedule(_gang_pods(api, "g", 1))
    assert sched.batches == storeless.batches == 0
    assert sched.schedule(straddle[2:] + straddle[:2]) and sched.batches == 2


def test_rejected_gang_member_that_outranks_lands_in_fallback():
    """Members of a rejected gang that outrank a bound pod no longer land in
    ``fallback``: they take the JAX ``_fail`` path, where the rejection's
    backoff fails Coscheduling's PreFilter inside the PostFilter, so no
    member preempts, exactly as the JAX loop; a gang that places leaves
    nothing anywhere."""
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities
    import _torch_cases as tc

    def cluster(api):
        infos = _gang_cluster(api)
        for i, ni in enumerate(infos):
            victim = api.make_pod(f"low-{i}").req({"cpu": "100m"}).priority(1).obj()
            victim.spec.node_name = ni.node.meta.name
            ni.add_pod(victim)
        return infos

    api = torch_api()
    store = Store()
    for name, k in (("big", 8), ("pair", 2)):
        store.create_object("PodGroup", PodGroup(meta=ObjectMeta(name=name, namespace="default"),
                                                 min_member=k))
    caps = dict(nodes=128, pods=16, value_words=32)
    sched = BatchScheduler(cluster(api), caps=Capacities(**caps), device="cpu", client=store)
    clock = Clock()
    sched.coscheduling.now_fn = clock
    env = tc.JaxEnv(cluster(jax_api()), caps, clock=clock)
    for name, k in (("big", 8), ("pair", 2)):
        env.store.create_object("PodGroup", jtypes.PodGroup(
            meta=jtypes.ObjectMeta(name=name, namespace="default"), min_member=k))
    pods = _gang_pods(api, "big", 8) + _gang_pods(api, "pair", 2)
    for pod in pods:
        pod.spec.priority = 100
    jpods = [tc.to_jax(p) for p in pods]
    env.add_pods(jpods)
    placed = sched.schedule(pods)
    assert placed == env.schedule(jpods)
    big = [p.key() for p in pods[:8]]
    assert not sched.fallback
    assert sched.gang_rejected == env.gang_rejected == dict.fromkeys(big, "infeasible")
    assert sched.nominated == env.nominated == {} and sched.preempted == env.preempted == {}
    assert all(placed[p.key()] for p in pods[8:])
