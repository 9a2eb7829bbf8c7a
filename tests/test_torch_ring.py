"""The port's in-flight ring (``kubernetes_tpu_torch.backend.tpu_scheduler``,
``device="cpu"``) against the real JAX ``TPUScheduler`` under
``JAX_PLATFORMS=cpu``, with exact equality (``LoopPair``: the same stores,
FakeClocks, ``batch_deadline_ms=0``; on the CPU both commit inline):

- the ring at depths 0-3 on the scenarios of tests/test_pipeline.py;
- ``DeviceState.reconcile`` / ``has_dirty`` on the same snapshot sequence
  as JAX's, and the C5a case, where the two packages differ on purpose;
- capacity growth per axis (``_resync_grown``), through the loop and
  directly, and the unknown axis;
- the ring's poison path through ``relay_fault_fn``;
- the cross-batch topology carry in ``schedule_batch`` (scan and rounds);
- ``encode_topo``'s InterPodAffinity arguments and bucket (C8).

And, in the port alone: ``CommitWorker``, and the loop with the commit
worker against the inline ring."""

import dataclasses
import threading
import types

import jax
import numpy as np
import pytest

from _torch_cases import (HOST, ZONE, LoopPair, SnapshotShim, build_topo_nodes,
                          build_topo_pods, jax_api, numpy_fields, topo_case_args,
                          topo_cluster_spec, topo_pods_spec, torch_api)
from kubernetes_tpu_torch import interop

DEPTHS = [0, 1, 2, 3]


def _caps(caps) -> dict:
    return dataclasses.asdict(caps)


# ------------------------------------------------------ the ring at depth K


def _zone_nodes(api, n=8, cpu="8", memory="16Gi", pods=10):
    return [api.make_node(f"n{i}").capacity({"cpu": cpu, "memory": memory, "pods": pods})
            .label("zone", f"z{i % 2}").obj() for i in range(n)]


def _depth_k(api):
    """tests/test_pipeline.py:55: anti-affine pods on the zone key among
    plain ones."""
    sel = api.LabelSelector(match_labels={"app": "x"})
    pods = [api.make_pod(f"aa{i}").req({"cpu": "1"}).label("app", "x")
            .pod_affinity("zone", sel, anti=True).obj() for i in range(6)]
    pods += [api.make_pod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).obj() for i in range(18)]
    return _zone_nodes(api), pods


def _capacity(api):
    """:83: a one-pod node and nine pods: exactly one binds."""
    node = api.make_node("only").capacity({"cpu": "2", "memory": "4Gi", "pods": 1}).obj()
    return [node], [api.make_pod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).obj()
                    for i in range(9)]


def _topo_carry(api):
    """:99: eight mutually anti-affine pods over two zones: two bind, one
    per zone, although later batches are dispatched before the first
    commits."""
    sel = api.LabelSelector(match_labels={"app": "x"})
    return _zone_nodes(api), [api.make_pod(f"p{i}").req({"cpu": "1"}).label("app", "x")
                              .pod_affinity("zone", sel, anti=True).obj() for i in range(8)]


SCENARIOS = {"depth_k": _depth_k, "capacity": _capacity, "topo_carry": _topo_carry}


def _ring_pair(monkeypatch, depth: int, batch: int = 4) -> LoopPair:
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.delenv("KTPU_COMMIT_WORKER", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", str(depth))
    pair = LoopPair(batch=batch)
    assert pair.tsched.pipeline_depth == pair.jsched.pipeline_depth == depth
    assert pair.tsched.commit_worker is None and pair.jsched.commit_worker is None
    return pair


def _fill(pair: LoopPair, build) -> None:
    (jnodes, jpods), (tnodes, tpods) = build(jax_api()), build(torch_api())
    for jn, tn in zip(jnodes, tnodes):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)
    pair.add_pods(jpods, tpods)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_ring_matches_jax_ring(scenario, depth, monkeypatch):
    pair = _ring_pair(monkeypatch, depth)
    _fill(pair, SCENARIOS[scenario])
    pair.settle()
    got = pair.assert_equal()
    t, j = pair.tsched, pair.jsched
    assert t.pipelined_batches == j.pipelined_batches
    bound = {k: n for k, n in got["placed"].items() if n}
    if scenario == "depth_k":  # six batches: deeper than every ring
        # two of the six anti-affine pods bind, one per zone
        assert len(bound) == 20 and (t.pipelined_batches > 0) == (depth > 0)
        assert (t.carry_batches > 0) == (depth > 0)
    elif scenario == "capacity":
        assert len(bound) == 1 and got["metrics"]["scheduled"] == 1
    else:
        assert len(bound) == 2 and {int(n[1:]) % 2 for n in bound.values()} == {0, 1}


@pytest.mark.parametrize("depth", DEPTHS)
def test_ring_at_depth_matches_synchronous(depth, monkeypatch):
    """The ring places exactly as the synchronous loop does."""
    ring = _ring_pair(monkeypatch, depth)
    _fill(ring, _depth_k)
    ring.settle()
    sync = _ring_pair(monkeypatch, 0)
    _fill(sync, _depth_k)
    sync.settle()
    assert ring.state(1)["placed"] == sync.state(1)["placed"] == ring.state(0)["placed"]


@pytest.mark.parametrize("depth", DEPTHS)
def test_chain_breaks_on_external_change(depth, monkeypatch):
    """:123: a node created between settles breaks the carry chain (drain
    and sync), and the next pods see it."""
    pair = _ring_pair(monkeypatch, depth)
    for api, store in ((jax_api(), pair.jstore), (torch_api(), pair.tstore)):
        store.create_node(api.make_node("small").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 4}).obj())
    pair.add_pods(*[[api.make_pod(f"a{i}").req({"cpu": "1", "memory": "1Gi"}).obj()
                     for i in range(4)] for api in (jax_api(), torch_api())])
    pair.settle()
    assert pair.assert_equal()["metrics"]["scheduled"] == 4
    seq = pair.tsched.external_change_seq()
    for api, store in ((jax_api(), pair.jstore), (torch_api(), pair.tstore)):
        store.create_node(api.make_node("big").capacity(
            {"cpu": "64", "memory": "128Gi", "pods": 100}).obj())
    assert pair.tsched.external_change_seq() == seq + 1
    pair.add_pods(*[[api.make_pod(f"b{i}").req({"cpu": "2", "memory": "2Gi"}).obj()
                     for i in range(8)] for api in (jax_api(), torch_api())])
    pair.settle()
    got = pair.assert_equal()
    assert got["metrics"]["scheduled"] == 12
    assert sum(1 for n in got["placed"].values() if n == "big") == 8


# ------------------------------------------------ reconcile and has_dirty


class _Side:
    """One package's cache, snapshot and DeviceState on three nodes."""

    def __init__(self, jax_side: bool, topology: bool):
        if jax_side:
            from kubernetes_tpu.backend.device_state import DeviceState, caps_for_cluster
            from kubernetes_tpu.cache.cache import Cache
            from kubernetes_tpu.cache.snapshot import Snapshot
            self.api = jax_api()
            self.dev = DeviceState(caps_for_cluster(3))
        else:
            from kubernetes_tpu_torch.backend.device_state import DeviceState, caps_for_cluster
            from kubernetes_tpu_torch.cache.cache import Cache
            from kubernetes_tpu_torch.cache.snapshot import Snapshot
            self.api = torch_api()
            self.dev = DeviceState(caps_for_cluster(3), device="cpu")
        self.cache, self.snap = Cache(), Snapshot()
        self.nodes = {}
        for i in range(3):
            n = self._node(f"n{i}")
            self.nodes[n.meta.name] = n
            self.cache.add_node(n)
        if topology:
            sel = self.api.LabelSelector(match_labels={"app": "x"})
            self.dev.sig_table.encode_topo([self.api.make_pod("t").label("app", "x")
                                            .spread_constraint(1, ZONE, selector=sel).obj()])
        self.cache.update_snapshot(self.snap)
        self.dev.sync(self.snap)

    def _node(self, name, **labels):
        w = self.api.make_node(name).capacity({"cpu": "4", "memory": "8Gi", "pods": 10})
        for k, v in labels.items():
            w = w.label(k, v)
        return w.obj()

    def pod(self, name, node=""):
        p = self.api.make_pod(name).req({"cpu": "1", "memory": "1Gi"}).label("app", "x").obj()
        p.spec.node_name = node
        return p

    def adopt(self, pod, node):
        """Advance the mirror by one commit of ``pod`` to ``node``, as a
        batch's read does."""
        self.dev.encoder.encode_pods([pod])
        result = types.SimpleNamespace(final_requested=True, final_class_req=True)
        slot = self.dev.encoder.node_slots[node]
        self.dev.adopt_commits(result, self.dev.encoder.last_host_pb, np.array([slot]))

    def probe(self, step):
        self.cache.update_snapshot(self.snap)
        dirty = self.dev.has_dirty(self.snap)
        left = self.dev.reconcile(self.snap)
        after = self.dev.has_dirty(self.snap)
        aligned = {n: self.dev._uploaded_gen.get(n) == ni.generation
                   for n, ni in self.snap.node_info_map.items()}
        st = self.dev.sig_table
        return (step, dirty, left, after, sorted(self.dev._recon_pending), aligned,
                st.sel_counts.tolist(), {k: v.tolist() for k, v in self.dev._mirror.items()
                                         if k in ("requested", "nonzero_requested")})


def _sequence(side: _Side):
    out = []
    side.cache.update_node(side.nodes["n0"])  # a generation bump, no change
    out.append(side.probe("bump"))
    side.cache.update_node(side._node("n1", zone="z9"))  # a new Node object
    out.append(side.probe("relabel"))
    pod = side.pod("p0", "n2")  # a bound pod the mirror has not seen
    side.cache.add_pod(pod)
    out.append(side.probe("unadopted"))
    side.dev.sync(side.snap)
    out.append(side.probe("synced"))
    pod = side.pod("p1")
    side.adopt(pod, "n2")  # the device committed p1 to n2, then the host did
    bound = pod.clone()
    bound.spec.node_name = "n2"
    side.cache.add_pod(bound)
    out.append(side.probe("adopted"))
    side.cache.remove_node("n0")  # a structure change: the full walk
    out.append(side.probe("removed"))
    side.dev.sync(side.snap)
    out.append(side.probe("resynced"))
    return out


@pytest.mark.parametrize("topology", [False, True])
def test_reconcile_and_has_dirty_match_jax(topology):
    """The return values, the pending rows, which uploaded generations are
    aligned, the count tables and the mirror, after every step of the same
    snapshot sequence."""
    jax_seq, port_seq = _sequence(_Side(True, topology)), _sequence(_Side(False, topology))
    assert port_seq == jax_seq
    steps = {s[0]: s for s in port_seq}
    assert steps["bump"][1:4] == (True, 0, False)
    assert steps["relabel"][2] == 1 and steps["relabel"][4] == ["n1"]
    assert steps["unadopted"][2] == 2 and steps["synced"][1:4] == (False, 0, False)
    assert steps["adopted"][1:4] == (True, 0, False)  # the adopted commit: elided
    assert steps["removed"][4] == ["n0"]
    assert steps["resynced"][1:4] == (False, 0, False)


def test_rejected_row_is_revisited():
    """C5a: a row the device committed to and the host then rejected
    without touching the cache (a gang or quota surrender, a failed
    assume). The port's ``invalidate_row`` marks it pending: ``has_dirty``
    reports it, ``reconcile`` leaves it dirty, and the next sync restores
    the row from the snapshot. The JAX scheduler's ``_invalidate_device_row``
    only drops the generation: its probes never see the row again, and
    its mirror keeps the rejected commit until a full sync."""
    ports, jaxs = _Side(False, False), _Side(True, False)
    for side in (ports, jaxs):
        side.adopt(side.pod("rejected"), "n1")
        assert side.dev._mirror["requested"][side.dev.encoder.node_slots["n1"]][0] > 0
    ports.dev.invalidate_row("n1")
    jaxs.dev._uploaded_gen.pop("n1", None)  # tpu_scheduler.py:1544-1551
    for side, seen in ((ports, True), (jaxs, False)):
        side.cache.update_snapshot(side.snap)
        assert side.dev.has_dirty(side.snap) is seen
        assert side.dev.reconcile(side.snap) == int(seen)
        assert side.dev.has_dirty(side.snap) is seen
        assert ("n1" in side.dev._recon_pending) is seen
    slot = ports.dev.encoder.node_slots["n1"]
    assert ports.dev.sync(ports.snap) == 1
    assert not ports.dev.has_dirty(ports.snap)
    assert ports.dev._mirror["requested"][slot][0] == 0
    assert ports.dev.nt.requested[slot, 0].item() == 0


# ------------------------------------------------------- capacity growth


def _labels_overflow(api):
    nodes = []
    for i in range(6):
        w = api.make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 20})
        for k in range(20):
            w = w.label(f"key-{k}", f"v{(i + k) % 3}")
        nodes.append(w.obj())
    pods = [api.make_pod(f"p{i}").req({"cpu": "1"}).node_selector({"key-19": "v1"}).obj()
            for i in range(8)]
    return nodes, pods


def _taints_overflow(api):
    nodes = [api.make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 20}).obj()
             for i in range(6)]
    w = api.make_node("tainted").capacity({"cpu": "8", "memory": "16Gi", "pods": 20})
    for t in range(6):
        w = w.taint(f"t{t}", "x", "PreferNoSchedule")
    nodes.append(w.obj())
    return nodes, [api.make_pod(f"p{i}").req({"cpu": "2"}).obj() for i in range(12)]


def _tolerations_overflow(api):
    nodes = [api.make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 20})
             .taint("dedicated", "a").obj() for i in range(3)]
    nodes += [api.make_node(f"m{i}").capacity({"cpu": "2", "memory": "16Gi", "pods": 20}).obj()
              for i in range(3)]
    pods = []
    for i in range(10):
        w = api.make_pod(f"p{i}").req({"cpu": "1"})
        for t in range(6):
            w = w.toleration(f"k{t}" if t else "dedicated", value="a" if not t else "",
                             operator="Equal" if not t else "Exists")
        pods.append(w.obj())
    return nodes, pods


def _resources_overflow(api):
    ext = {f"example.com/r{r}": 4 for r in range(4)}
    nodes = [api.make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 20, **ext})
             .obj() for i in range(4)]
    pods = [api.make_pod(f"p{i}").req({"cpu": "1", f"example.com/r{i % 4}": 1}).obj()
            for i in range(20)]
    return nodes, pods


def _spread_sigs_overflow(api):
    nodes = [api.make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 20})
             .label(ZONE, f"z{i % 3}").obj() for i in range(9)]
    pods = []
    for i in range(12):
        sel = api.LabelSelector(match_labels={"app": f"a{i}"})
        pods.append(api.make_pod(f"p{i}").req({"cpu": "1"}).label("app", f"a{i}")
                    .spread_constraint(1, ZONE, selector=sel).obj())
    return nodes, pods


def _terms_overflow(api):
    nodes = [api.make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 20})
             .label(ZONE, f"z{i % 3}").obj() for i in range(9)]
    pods = []
    for i in range(12):
        sel = api.LabelSelector(match_labels={"app": f"a{i}"})
        pods.append(api.make_pod(f"p{i}").req({"cpu": "1"}).label("app", f"a{i}")
                    .pod_affinity(HOST if i % 2 else ZONE, sel, anti=True).obj())
    return nodes, pods


def _per_pod_overflow(api):
    """Pods past the per-pod axes: host ports, containers, node-selector
    requirements, preferred node-affinity terms, priority classes."""
    nodes = [api.make_node(f"n{i}").capacity({"cpu": "64", "memory": "64Gi", "pods": 60})
             .label("a", "1").label("b", "1").obj() for i in range(6)]
    pods = []
    for i in range(40):
        w = api.make_pod(f"p{i}").req({"cpu": "100m"}).priority(i)
        if i == 1:
            for port in range(9):
                w = w.host_port(8000 + port)
        if i == 2:
            for c in range(5):
                w = w.container(f"img-{c}", {"cpu": "10m"})
        if i == 3:
            w = w.node_selector({f"k{j}": "1" for j in range(9)})
        if i == 4:
            for t in range(5):
                w = w.preferred_node_affinity(t + 1, "a", ["1"])
        pods.append(w.obj())
    return nodes, pods


GROWTH = {
    "label_keys": (_labels_overflow, ("label_keys",)),
    "taints": (_taints_overflow, ("taints",)),
    "tolerations": (_tolerations_overflow, ("tolerations",)),
    "resources": (_resources_overflow, ("resources",)),
    "sigs": (_spread_sigs_overflow, ("sigs",)),
    "ex_terms": (_terms_overflow, ("ex_terms",)),
    "per_pod": (_per_pod_overflow, ("ports", "containers", "sel_exprs", "pref_terms",
                                    "prio_classes")),
}


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("case", sorted(GROWTH))
def test_growth_through_the_loop_matches_jax(case, depth, monkeypatch):
    """Workloads that overflow a default capacity axis: both loops grow
    exactly the named axes to the same capacities, and place alike."""
    build, axes = GROWTH[case]
    pair = _ring_pair(monkeypatch, depth, batch=16)
    _fill(pair, build)
    pair.settle()
    got = pair.assert_equal()
    caps = pair.tsched.state.caps
    assert _caps(caps) == _caps(pair.jsched.device.caps)
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster

    base = caps_for_cluster(len(pair.tstore.nodes), batch=16)
    for axis in axes:
        assert getattr(caps, axis) > getattr(base, axis), axis
    assert got["metrics"]["scheduled"] > 0


def _grow_dims():
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

    return sorted(TPUScheduler._GROW_FIELDS) + ["value vocab for 'zone'"]


@pytest.mark.parametrize("dim", _grow_dims())
def test_resync_grown_matches_jax(dim, monkeypatch):
    """``_resync_grown`` on every axis it knows: the same grown capacities
    in both packages, and the same placements after the rebuild."""
    from kubernetes_tpu.ops.encode import CapacityError as JCapacityError
    from kubernetes_tpu_torch.ops.encode import CapacityError

    pair = _ring_pair(monkeypatch, 2, batch=8)
    _fill(pair, lambda api: (_zone_nodes(api), [api.make_pod(f"p{i}").req({"cpu": "1"}).obj()
                                                 for i in range(10)]))
    pair.settle()
    fields = pair.tsched._GROW_FIELDS.get(dim, ("value_words",))
    have = getattr(pair.tsched.state.caps, fields[0])
    pair.jsched._resync_grown(JCapacityError(dim, 2 * have + 1, have))
    pair.tsched._resync_grown(CapacityError(dim, 2 * have + 1, have))
    caps = pair.tsched.state.caps
    assert _caps(caps) == _caps(pair.jsched.device.caps)
    assert all(getattr(caps, f) >= 2 * have + 1 for f in fields[:1])
    pair.add_pods(*[[api.make_pod(f"q{i}").req({"cpu": "1"}).obj() for i in range(10)]
                    for api in (jax_api(), torch_api())])
    pair.settle()
    assert pair.assert_equal()["metrics"]["scheduled"] == 20


def test_unknown_dimension_raises(monkeypatch):
    from kubernetes_tpu.backend.errors import PermanentDeviceError as JPermanent
    from kubernetes_tpu.ops.encode import CapacityError as JCapacityError
    from kubernetes_tpu_torch.backend.errors import PermanentDeviceError
    from kubernetes_tpu_torch.ops.encode import CapacityError

    pair = _ring_pair(monkeypatch, 2)
    _fill(pair, _capacity)
    pair.settle()
    with pytest.raises(JPermanent):
        pair.jsched._resync_grown(JCapacityError("warp drives", 3, 2))
    with pytest.raises(PermanentDeviceError, match="warp drives"):
        pair.tsched._resync_grown(CapacityError("warp drives", 3, 2))


# ------------------------------------------------------------- poison


@pytest.mark.parametrize("depth", [0, 2])
def test_poisoned_ring_requeues_like_jax(depth, monkeypatch):
    """A device fault at the third commit's read: every pod of the ring
    (that batch and those dispatched after it) goes back to backoffQ, the
    mirror is dropped and rebuilt by the next batch, and the queue equals
    JAX's; past the backoff every pod binds that can."""
    from kubernetes_tpu_torch.backend.errors import TransientDeviceError

    pair = _ring_pair(monkeypatch, depth)
    calls = {"j": 0, "t": 0}
    states = []

    def fault(side):
        def fn(op):
            assert op == "commit"
            calls[side] += 1
            if side == "t":
                states.append(pair.tsched.state)
            return TransientDeviceError("device lost") if calls[side] == 3 else None
        return fn

    pair.jsched.relay_fault_fn, pair.tsched.relay_fault_fn = fault("j"), fault("t")
    _fill(pair, _depth_k)
    pair.settle()
    got = pair.assert_equal()
    ring = 4 * (depth + 1)
    assert got["pending"]["backoff"] >= ring and got["metrics"]["scheduled"] <= 20 - ring
    assert states[2] is states[0] and pair.tsched.state is not states[0]  # rebuilt
    pair.advance(2.0)
    pair.settle()
    got = pair.assert_equal()
    assert got["metrics"]["scheduled"] == 20


# ---------------------------------------------------------- CommitWorker


def test_commit_worker_order_flush_and_backpressure():
    from kubernetes_tpu_torch.backend.commit_plane import CommitWorker

    gate, done = threading.Event(), []

    def commit(item):
        gate.wait(10)
        done.append(item)

    w = CommitWorker(commit)
    assert w.idle() and w.depth() == 0
    for i in range(5):
        w.submit(i)
    assert w.depth() == 5 and not w.idle()
    stolen = []
    waiter = threading.Thread(target=lambda: w.wait_below(2))
    waiter.start()
    waiter.join(0.05)
    assert waiter.is_alive()  # blocked: 5 pending or running
    stolen = w.steal_pending()  # the four not yet started
    gate.set()
    waiter.join(10)
    assert not waiter.is_alive()
    w.flush()
    assert done == [0] and stolen == [1, 2, 3, 4] and w.idle()
    for i in range(5, 9):
        w.submit(i)
    w.flush()
    assert done == [0, 5, 6, 7, 8] and w.committed == 5
    w.stop()
    assert not w._thread.is_alive()


def test_commit_worker_reraises_a_surprise_at_flush():
    from kubernetes_tpu_torch.backend.commit_plane import CommitWorker

    done = []

    def commit(item):
        if item == 1:
            raise KeyError("surprise")
        done.append(item)

    w = CommitWorker(commit)
    for i in range(3):
        w.submit(i)
    with pytest.raises(KeyError, match="surprise"):
        w.flush()
    assert done == [0, 2]
    w.flush()  # raised once
    w.stop()


def test_worker_loop_equals_inline_ring(monkeypatch):
    """``KTPU_COMMIT_WORKER=1`` on the CPU: the pods bind through the
    worker (four anti-affine pods find no zone and park), and with no
    external event the placements equal the inline ring's (and the JAX
    loop's)."""
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "1")
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.delenv("KTPU_PIPELINE_DEPTH", raising=False)
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    store = Store(now_fn=clock)
    worker = TPUScheduler(store, device="cpu", batch_size=4, batch_deadline_ms=0, now_fn=clock)
    assert worker.commit_worker is not None and worker.pipeline_depth == 2
    nodes, pods = _depth_k(torch_api())
    for node in nodes:
        store.create_node(node)
    for pod in pods:
        store.create_pod(pod)
    worker.run_until_settled()
    placed = {k: p.spec.node_name for k, p in store.pods.items()}
    assert sum(1 for n in placed.values() if n) == worker.metrics["scheduled"] == 20
    assert worker.commit_worker.committed == worker.batch_counter == 6
    assert worker.carry_batches > 0
    worker.close()
    assert not worker.commit_worker._thread.is_alive()

    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    inline = _ring_pair(monkeypatch, 2)
    _fill(inline, _depth_k)
    inline.settle()
    assert inline.state(1)["placed"] == inline.state(0)["placed"] == placed


def _watch_postfilter(sched, store) -> list:
    """Wrap ``sched``'s PostFilter: each call records the pods bound in the
    store that the node list it reads does not hold."""
    real, missing = sched.profiles["default-scheduler"].plugin("DefaultPreemption").post_filter, []

    def post_filter(pod, hints=None, unresolvable=(), state=None):
        seen = {p.key() for ni in sched.profiles["default-scheduler"].filters.node_infos_fn() for p in ni.pods}
        missing.append({k for k, p in list(store.pods.items()) if p.spec.node_name} - seen)
        return real(pod, hints, unresolvable, state)

    sched.profiles["default-scheduler"].plugin("DefaultPreemption").post_filter = post_filter
    return missing


@pytest.mark.parametrize("worker", ["0", "1"])
def test_postfilter_reads_every_committed_bind(worker, monkeypatch):
    """PreemptionBasic's shape (victims fill 100 nodes, 108 preemptors in
    batches of 32) through the ring, inline and with the commit worker:
    every PostFilter call reads a node list that holds every pod the store
    has bound, and every preemptor binds. With the worker the carry chain
    holds across commits, so a node list as fresh as the chain's last sync
    (the scheduling thread's snapshot) missed the binds committed since and
    nominated pods to nodes that were full (562 nominations for 508
    preemptors at PreemptionBasic/500Nodes)."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)
    monkeypatch.delenv("KTPU_PIPELINE_DEPTH", raising=False)
    api, store = torch_api(), Store()
    sched = TPUScheduler(store, device="cpu", batch_size=32, batch_deadline_ms=0,
                         percentage_of_nodes_to_score=100)
    assert (sched.commit_worker is not None) == (worker == "1")
    missing = _watch_postfilter(sched, store)
    for i in range(100):
        store.create_node(api.make_node(f"node-{i}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": 32}).obj())
    for prefix, n, cpu, mem, prio in (("victim", 400, "900m", "2Gi", 1),
                                      ("preemptor", 108, "2", "4Gi", 100)):
        for j in range(n):
            store.create_pod(api.make_pod(f"{prefix}-{j}").req({"cpu": cpu, "memory": mem})
                             .priority(prio).obj())
        sched.run_until_settled()
    sched.close()
    assert len(missing) >= 100 and not any(missing)
    assert sched.carry_batches > 0 and len(sched.preempted) == 216
    assert all(p.spec.node_name for k, p in store.pods.items() if "preemptor" in k)


# ------------------------------------------------- topo_carry, encode_topo


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("case", ["host", "general-bucket"])
def test_topo_carry_matches_jax(case, spec):
    """The same batch run twice, the second time on the first run's final
    counts as its topology carry, as the ring chains two batches: every
    result field equal to JAX's, on the scan and on the rounds."""
    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu_torch.backend import batch as tbatch

    jds, pb, et, tb, kw = topo_case_args(case, 3)
    tc = jds.tc
    targs = (interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
             interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
             interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"))
    ttc = interop.topo_counts_from_numpy(numpy_fields(tc), "cpu")
    ttb = interop.topo_batch_from_numpy(numpy_fields(tb), "cpu")

    def both(jcarry, tcarry):
        jres = jbatch.schedule_batch(pb, et, jds.nt, tc, tb, jax.random.PRNGKey(0),
                                     topo_enabled=True, spec_decode=spec,
                                     topo_carry=jcarry, **kw)
        tres = tbatch.schedule_batch(*targs, device="cpu", tc=ttc, tb=ttb, spec_decode=spec,
                                     topo_carry=tcarry, **kw)
        for name in ("node_idx", "any_feasible", "final_requested", "final_sel_counts",
                     "final_seg_exist", "packed"):
            np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                          np.asarray(getattr(jres, name)), err_msg=name)
        return jres, tres

    j1, t1 = both(None, None)
    j2, t2 = both((j1.final_sel_counts, j1.final_seg_exist),
                  (t1.final_sel_counts, t1.final_seg_exist))
    assert not np.array_equal(t2.final_sel_counts.numpy(), t1.final_sel_counts.numpy())
    assert not np.array_equal(t2.packed.numpy(), t1.packed.numpy())  # the carry was read


@pytest.mark.parametrize("capacity", [None, 16])
@pytest.mark.parametrize("weight,ignore", [(1, False), (7, False), (3, True)])
def test_encode_topo_options_match_jax(weight, ignore, capacity):
    """C8: ``hard_pod_affinity_weight``, ``ignore_preferred`` and
    ``capacity`` of ``encode_topo``, field by field against JAX's."""
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu_torch.backend.device_state import DeviceState
    from kubernetes_tpu_torch.ops.schema import Capacities

    from _torch_cases import TOPO_CAPS

    spec = topo_cluster_spec(48, 5)
    jds, tds = JDeviceState(JCaps(**TOPO_CAPS)), DeviceState(Capacities(**TOPO_CAPS), "cpu")
    jds.sync(SnapshotShim(build_topo_nodes(jax_api(), spec)))
    tds.sync(SnapshotShim(build_topo_nodes(torch_api(), spec)))
    pspec = topo_pods_spec(12, 9)
    jtb = jds.sig_table.encode_topo(build_topo_pods(jax_api(), pspec), weight, ignore,
                                    capacity=capacity)
    ttb = tds.sig_table.encode_topo(build_topo_pods(torch_api(), pspec), weight, ignore,
                                    capacity=capacity).to_numpy()
    for name, a in numpy_fields(jtb).items():
        assert ttb[name].dtype == a.dtype, name
        np.testing.assert_array_equal(ttb[name], a, err_msg=name)
    assert ttb["term_score_w"].shape[0] == (capacity or TOPO_CAPS["pods"])
    w = ttb["term_score_w"]
    assert (w == weight).any() if weight != 1 else True
    assert not (w[w != float(weight)] > 0).any() if ignore else True
