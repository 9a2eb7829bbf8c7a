"""The port's scheduler loop (``kubernetes_tpu_torch.backend.tpu_scheduler.
TPUScheduler`` with ``device="cpu"``) against the real JAX
``kubernetes_tpu.backend.TPUScheduler`` under ``JAX_PLATFORMS=cpu``: the
same stores, built from ``_torch_cases`` specs through each package's
wrappers, ``batch_deadline_ms=0`` and FakeClocks that start equal. Every
pod's node in the store, the counters (attempts, scheduled,
unschedulable), the queue (``pending_pods`` and each queued pod's attempts
and failed plugins), the nominations, the evicted victims, the pods popped
(``run_until_settled``'s count) and the batches must be equal. Both loops
run synchronously (``KTPU_PIPELINE_DEPTH=0``) and at their default (the in-flight
ring, two batches in flight, committed inline on the CPU). The deadline
sizer, with its commit-wait model, is held against the JAX ``BatchSizer``
on fed observations, and run at its default in both loops."""

import dataclasses

import numpy as np
import pytest

from _torch_cases import (HOST, ZONE, LoopPair, build_nodes, build_pods, build_topo_nodes,
                          build_topo_pods, cluster_spec, jax_api, pods_spec, topo_cluster_spec,
                          topo_pods_spec, torch_api)

PIPELINES = ["0", "default"]


@pytest.fixture(params=PIPELINES)
def pipeline(request, monkeypatch):
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    if request.param == "0":
        monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    else:
        monkeypatch.delenv("KTPU_PIPELINE_DEPTH", raising=False)
    monkeypatch.delenv("KTPU_FULL_BATCH", raising=False)
    monkeypatch.delenv("KTPU_SPEC", raising=False)
    return request.param


def _basic(n_nodes: int, n_pods: int, seed: int, percentage: int = 0,
           replay: bool = False) -> LoopPair:
    """``replay``: fill the stores first, then build the schedulers, which
    replay them as ADDED events."""
    pair = LoopPair(batch=16, percentage=percentage, start=not replay)
    spec = cluster_spec(n_nodes, seed)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(n_pods, seed + 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    if replay:
        pair.start()
    return pair


@pytest.mark.parametrize("replay", [False, True])
def test_unsampled_cluster(pipeline, replay):
    """64 nodes, below the 100 of adaptive sampling: full batches on the
    fused step; the schedulers built before the objects arrive (events) or
    after (the LIST replayed)."""
    pair = _basic(64, 56, 0, replay=replay)
    pair.settle()
    got = pair.assert_equal()
    assert set(pair.tsched.batch_paths) == {"fused"}
    assert got["metrics"]["scheduled"] == 56 and got["cycles"] == 56


def test_failures_across_batches(pipeline):
    """12 nodes, 150 pods in ten batches: 22 pods find no node.
    Synchronous, both loops park them unschedulable: past their backoff no
    event wakes them; past the 5-minute unschedulable timeout the
    housekeeping flush retries them, and they park again. Pipelined, each
    batch commits after the next two were popped, so its failures race the
    queue moves of the binds committed meanwhile and park in backoffQ
    (``move_request_cycle``); past their backoff they are retried and park
    unschedulable. The two loops agree exactly at every step."""
    pair = _basic(12, 150, 0)
    pair.settle()
    got = pair.assert_equal()
    assert got["metrics"] == {"schedule_attempts": 150, "scheduled": 128,
                              "unschedulable": 22}
    assert got["pending"]["unschedulable" if pipeline == "0" else "backoff"] == 22
    pair.advance(11.0)
    pair.settle()
    got = pair.assert_equal()
    assert got["pending"]["unschedulable"] == 22
    assert got["cycles"] == (150 if pipeline == "0" else 172)
    pair.advance(300.0)
    pair.settle()
    got = pair.assert_equal()
    assert got["pending"]["unschedulable"] == 22 and got["cycles"] == 172
    assert got["metrics"]["unschedulable"] == 44


def test_default_sampling_chains_the_window(pipeline):
    """300 nodes at the CPU default: every batch samples (k = 141) and the
    window's start chains over at least three batches."""
    pair = _basic(300, 56, 1)
    pair.settle()
    pair.assert_equal()
    sched = pair.tsched
    assert sched.num_feasible_nodes_to_find(300) == 141
    assert len(sched.batch_paths) >= 3 and set(sched.batch_paths) == {"scan"}
    assert int(sched._start_carry) == int(np.asarray(pair.jsched._start_carry))


def test_explicit_percentage(pipeline):
    pair = _basic(300, 40, 2, percentage=40)
    pair.settle()
    pair.assert_equal()
    assert pair.tsched.num_feasible_nodes_to_find(300) == 120
    assert int(pair.tsched._start_carry) == int(np.asarray(pair.jsched._start_carry))


@pytest.mark.parametrize("keys,mode", [((HOST,), "host"), ((ZONE,), "general"),
                                       ((HOST, ZONE), "general")])
def test_topology_pods(pipeline, keys, mode):
    """The anti-affinity, affinity and spread pods of ``topo_cluster_spec``
    on 120 nodes, sampled (k = 58): on the hostname key in mode ``host``,
    on the zone key in mode ``general``, and on both keys, whose terms and
    signatures overflow the default count tables: both loops grow exactly
    those axes (``_resync_grown``) to the same capacities."""
    pair = LoopPair(batch=16)
    spec = topo_cluster_spec(120, 3, keys=keys)
    pair.add_nodes(build_topo_nodes(jax_api(), spec), build_topo_nodes(torch_api(), spec))
    pods = topo_pods_spec(40, 4, keys=keys)
    pair.add_pods(build_topo_pods(jax_api(), pods), build_topo_pods(torch_api(), pods))
    pair.settle()
    got = pair.assert_equal()
    assert mode in pair.tsched.batch_modes and set(pair.tsched.batch_paths) == {"scan"}
    assert got["metrics"]["scheduled"] > 20
    assert pair.tsched.state.caps == _jax_caps(pair.jsched.device.caps)
    if len(keys) == 2:
        assert pair.tsched.state.caps.ex_terms > 8 or pair.tsched.state.caps.sigs > 8


def _jax_caps(caps):
    from kubernetes_tpu_torch.ops.schema import Capacities

    return Capacities(**dataclasses.asdict(caps))


def _big_pods(api, n: int, cpu: str = "40"):
    return [api.make_pod(f"big-{i}").req({"cpu": cpu, "memory": "1Gi"}).obj() for i in range(n)]


def test_node_added_wakes_unschedulable_pods(pipeline):
    """Pods no node fits park unschedulable; a node that fits them joins,
    its NodeAdd event moves them to backoff, and once the backoff is over
    they bind."""
    pair = _basic(12, 0, 5)
    pair.add_pods(_big_pods(jax_api(), 6), _big_pods(torch_api(), 6))
    pair.settle()
    got = pair.assert_equal()
    assert got["pending"]["unschedulable"] == 6
    for api, store in ((jax_api(), pair.jstore), (torch_api(), pair.tstore)):
        store.create_node(api.make_node("roomy").capacity(
            {"cpu": "256", "memory": "64Gi", "pods": 110}).obj())
    got = pair.assert_equal()
    assert got["pending"]["backoff"] == 6
    pair.advance(2.0)
    pair.settle()
    got = pair.assert_equal()
    assert sum(1 for k, n in got["placed"].items() if k.startswith("default/big-") and n) == 6


def test_node_axis_grows(pipeline):
    """120 nodes fill a 128-slot node axis; 20 more join while pods wait
    for room, and both loops rebuild their device state on a 256-slot axis
    and place the waiting pods on the new nodes."""
    pair = _basic(120, 0, 8, percentage=100)
    pair.add_pods(_big_pods(jax_api(), 4), _big_pods(torch_api(), 4))
    pair.settle()
    assert pair.tsched.state.caps.nodes == 128
    for i in range(20):
        for api, store in ((jax_api(), pair.jstore), (torch_api(), pair.tstore)):
            store.create_node(api.make_node(f"extra-{i}").capacity(
                {"cpu": "64", "memory": "64Gi", "pods": 110}).obj())
    pair.advance(2.0)
    pair.settle()
    got = pair.assert_equal()
    assert pair.tsched.state.caps.nodes == pair.jsched.device.caps.nodes == 256
    assert all(got["placed"][f"default/big-{i}"].startswith("extra-") for i in range(4))


def test_externally_bound_pod_is_skipped(pipeline):
    """A pod bound by someone else while it waits in the queue is popped and
    skipped, never scheduled again."""
    from kubernetes_tpu.api.types import Binding

    pair = _basic(20, 24, 6)
    pair.jstore.bind(Binding(pod_key="default/pod-7-3", node_name="node-4"))
    pair.tstore.bind("default/pod-7-3", "node-4")
    pair.settle()
    got = pair.assert_equal()
    assert got["placed"]["default/pod-7-3"] == "node-4"
    assert got["metrics"]["schedule_attempts"] == 23


def test_other_scheduler_name_is_ignored(pipeline):
    pair = _basic(20, 16, 7)
    pods_j, pods_t = _big_pods(jax_api(), 2, "1"), _big_pods(torch_api(), 2, "1")
    for p in pods_j + pods_t:
        p.spec.scheduler_name = "someone-else"
    pair.add_pods(pods_j, pods_t)
    pair.settle()
    got = pair.assert_equal()
    assert got["placed"]["default/big-0"] == "" and got["placed"]["default/big-1"] == ""
    assert got["metrics"]["schedule_attempts"] == 16


def _preemption_nodes(api, n: int):
    """PreemptionBasic's nodes (cpu 4 / 16Gi / 32 pods), each full of four
    priority-1 victims of 900m / 2Gi, bound."""
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


def test_preemption_through_deleted_events(pipeline):
    """A small PreemptionBasic: 12 priority-100 preemptors of 2 / 4Gi on 12
    full nodes. Each fails, preempts (the victims are deleted in the store,
    their DELETED events wake the queue), is nominated, returns to the
    queue through its nomination's update, and binds on the next batch."""
    pair = LoopPair(batch=16)
    pair.add_nodes(_preemption_nodes(jax_api(), 12), _preemption_nodes(torch_api(), 12))

    def preemptors(api):
        return [api.make_pod(f"preemptor-{i}").req({"cpu": "2", "memory": "4Gi"})
                .priority(100).obj() for i in range(12)]

    pair.add_pods(preemptors(jax_api()), preemptors(torch_api()))
    pair.settle()
    got = pair.assert_equal()
    assert all(got["placed"][f"default/preemptor-{i}"] for i in range(12))
    assert got["nominated"]  # the bound preemptors keep their nomination
    victims = {k for k in got["placed"] if k.startswith("default/victim-")}
    assert len(victims) < 48
    assert set(pair.tsched.preempted) == {f"default/victim-{i}-{j}" for i in range(12)
                                          for j in range(4)} - victims


def test_preemption_across_batches(pipeline):
    """40 preemptors on 24 full nodes, in batches of 16: three waves fail,
    preempt and are nominated, and come back in later batches. Pipelined,
    each batch commits after the next two were popped, so the nominated
    pods re-enter the queue after batches already in flight: both loops
    place, nominate and evict exactly alike either way."""
    pair = LoopPair(batch=16)
    pair.add_nodes(_preemption_nodes(jax_api(), 24), _preemption_nodes(torch_api(), 24))

    def preemptors(api):
        return [api.make_pod(f"preemptor-{i}").req({"cpu": "2", "memory": "4Gi"})
                .priority(100).obj() for i in range(40)]

    pair.add_pods(preemptors(jax_api()), preemptors(torch_api()))
    pair.settle()
    got = pair.assert_equal()
    assert got["metrics"] == {"schedule_attempts": 80, "scheduled": 40, "unschedulable": 40}
    assert all(got["placed"][f"default/preemptor-{i}"] for i in range(40))
    assert len(pair.tsched.preempted) == 80
    assert pair.tsched.batch_counter == pair.jsched.batch_counter > 5


def test_unported_kinds_raise():
    """No kind of pod raises any more. A claim pod whose claim is missing
    and a volume pod whose PVC is missing take the sequential path at pop
    (``batch_supported`` refuses them), fail its PreFilter and park,
    unbound, with the plugin whose event wakes them (DynamicResources,
    VolumeRestrictions); once the object is created they bind. Gang and
    slice pods and a store with SchedulingQuota objects are scheduled (a
    gang member whose PodGroup is missing fails Coscheduling's gate and
    parks)."""
    from kubernetes_tpu_torch.api.types import (ROX, ObjectMeta, PersistentVolume,
                                                PersistentVolumeClaim, ResourceClaim,
                                                SchedulingQuota)
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.ops.slice import SLICE_LABEL
    from kubernetes_tpu_torch.utils.clock import FakeClock

    cases = {
        "claim": make_pod("c").req({"cpu": "1"}).resource_claim("gpu", claim_name="c-gpu").obj(),
        "volume": make_pod("v").req({"cpu": "1"}).pvc("data").obj(),
        "gang": make_pod("g").req({"cpu": "1"}).pod_group("pg").obj(),
        "slice": make_pod("s").req({"cpu": "1"}).label(SLICE_LABEL, "1").obj(),
        "quota": make_pod("q").req({"cpu": "1"}).obj(),
    }
    missing = {"claim": "DynamicResources", "volume": "VolumeRestrictions"}
    for kind, pod in cases.items():
        store = Store()
        store.create_node(make_node("n0").capacity({"cpu": "8", "memory": "8Gi",
                                                    "pods": 10}).obj())
        if kind == "quota":
            store.create_object("SchedulingQuota", SchedulingQuota(
                meta=ObjectMeta(name="q", namespace="default"), hard={"pods": 10}))
        clock = FakeClock()
        sched = TPUScheduler(store, device="cpu", batch_deadline_ms=0, now_fn=clock)
        store.create_pod(pod)
        sched.run_until_settled()
        bound = store.get_pod(pod.key()).spec.node_name
        if kind in missing:
            assert not bound and sched.batch_counter == 0
            (qp,) = sched.queue.pending_pod_infos()
            assert qp.unschedulable_plugins == {missing[kind]}
            if kind == "claim":
                store.create_object("ResourceClaim", ResourceClaim(
                    meta=ObjectMeta(name="c-gpu", namespace="default")))
            else:
                store.create_pv(PersistentVolume(meta=ObjectMeta(name="pv-data"),
                                                 capacity_bytes=1 << 30,
                                                 bound_pvc="default/data", access_modes=(ROX,)))
                store.create_pvc(PersistentVolumeClaim(meta=ObjectMeta(name="data"),
                                                       bound_pv="pv-data", access_modes=(ROX,)))
            clock.advance(2)  # the event moved it to backoffQ
            sched.run_until_settled()
            assert store.get_pod(pod.key()).spec.node_name == "n0"
            assert sched.batch_counter == 1 and sched.fallback_scheduled == 0
            continue
        if kind == "gang":
            assert not bound and sched.queue.pending_pods()["unschedulable"] == 1
        else:
            assert bound == "n0"
        if kind == "quota":
            assert sched._quota_plugin().usage("default")["pods"] == 1


def test_event_map_and_attribution_match_jax():
    """The default profile's registered events and the first-fail
    attribution order are the JAX default profile's."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.backend.tpu_scheduler import _ATTRIBUTION_ORDER
    from kubernetes_tpu.scheduler.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import ATTRIBUTION_ORDER
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    jmap = JScheduler(ClusterStore()).profiles["default-scheduler"].cluster_event_map()
    tmap = Scheduler(Store()).profiles["default-scheduler"].cluster_event_map()
    assert {(ev.resource.name, ev.action_type, ev.label): frozenset(p)
            for ev, p in jmap.items()} == {
        (ev.resource, ev.action_type, ev.label): frozenset(p) for ev, p in tmap.items()}
    assert tuple(ATTRIBUTION_ORDER) == tuple(_ATTRIBUTION_ORDER)


def test_no_card_raises():
    import torch

    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPUScheduler(Store())


def _team_pods(api, ns_types):
    """Namespaces team-a and team-b (labels team=a / team=b), each with
    three bound app=db pods (team-a's on node-0..2, team-b's on node-3..5),
    then four default-namespace pods whose terms select app=db pods by
    namespace labels: required anti-affinity to team=a's and required
    affinity to team=b's, on the hostname key."""
    import dataclasses

    namespaces = [ns_types.Namespace(meta=ns_types.ObjectMeta(name=f"team-{t}",
                                                              labels={"team": t}))
                  for t in "ab"]
    bound = []
    for t, first in (("a", 0), ("b", 3)):
        for i in range(3):
            pod = api.make_pod(f"db-{i}", namespace=f"team-{t}").label("app", "db") \
                .req({"cpu": "1", "memory": "1Gi"}).obj()
            pod.spec.node_name = f"node-{first + i}"
            bound.append(pod)
    pending = []
    for i, (anti, team) in enumerate([(True, "a"), (True, "a"), (False, "b"), (False, "b")]):
        pod = api.make_pod(f"sel-{i}").req({"cpu": "1", "memory": "1Gi"}) \
            .pod_affinity(HOST, api.LabelSelector(match_labels={"app": "db"}), anti=anti).obj()
        terms = (pod.spec.affinity.pod_anti_affinity if anti else pod.spec.affinity.pod_affinity)
        terms.required = tuple(dataclasses.replace(
            t, namespace_selector=api.LabelSelector(match_labels={"team": team}))
            for t in terms.required)
        pending.append(pod)
    return namespaces, bound, pending


def test_namespace_selector_terms(pipeline):
    """Affinity terms that select pods by their namespace's labels
    (``Store.create_namespace`` / ``ns_labels``): the anti-affine pods
    avoid team-a's db nodes, the affine ones land on team-b's."""
    import kubernetes_tpu.api.types as jtypes
    import kubernetes_tpu_torch.api.types as ttypes

    pair = LoopPair(batch=16)
    nodes = [[api.make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": 32}).obj() for i in range(12)]
        for api in (jax_api(), torch_api())]
    objs = [_team_pods(jax_api(), jtypes), _team_pods(torch_api(), ttypes)]
    for (ns_list, bound, _), store, node_list in zip(objs, (pair.jstore, pair.tstore), nodes):
        for ns in ns_list:
            store.create_namespace(ns)
        for node in node_list:
            store.create_node(node)
        for pod in bound:
            store.create_pod(pod)
    pair.add_pods(objs[0][2], objs[1][2])
    pair.settle()
    got = pair.assert_equal()
    placed = got["placed"]
    assert {placed[f"default/sel-{i}"] for i in (0, 1)}.isdisjoint({"node-0", "node-1", "node-2"})
    assert {placed[f"default/sel-{i}"] for i in (2, 3)} <= {"node-3", "node-4", "node-5"}
    assert pair.tstore.ns_labels("team-b") == {"team": "b"}
    assert "host" in pair.tsched.batch_modes


# (batch size fed, latency seconds) sequences: a linear cost with noise, a
# one-off compile spike (rejected as an outlier), a machine that turns
# five times slower (three outliers in a row, then accepted), and a flat
# cost (a degenerate slope keeps the prior one)
def _sizer_trace(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    for step in range(60):
        bucket = int(rng.choice([16, 32, 64, 128, 256]))
        latency = 0.012 + 0.003 * bucket * float(rng.uniform(0.9, 1.1))
        if kind == "flat":
            latency = 0.05
        elif kind == "spike" and step in (10, 31):
            latency *= 40
        elif kind == "slowdown" and step >= 30:
            latency *= 5
        yield bucket, latency


@pytest.mark.parametrize("waits", [False, True])
@pytest.mark.parametrize("kind", ["linear", "spike", "slowdown", "flat"])
@pytest.mark.parametrize("max_batch,deadline_s", [(128, 0.5), (1024, 0.3), (256, 0.0)])
def test_batch_sizer_matches_jax(kind, max_batch, deadline_s, waits, monkeypatch):
    """The deadline fit, the bucket ladder, the sticky hysteresis and the
    outlier rejection against the JAX ``BatchSizer`` fed the same pop-to-
    commit observations and, with ``waits``, the same commit waits (about
    0.2 ms per pod of the bucket, from the same trace), whose stall model
    caps the target at the 15 ms default: ``target()`` and ``bucket_for()``
    equal after every observation, and both fitted models equal to the
    bit."""
    from kubernetes_tpu.backend.sizer import BatchSizer as JSizer
    from kubernetes_tpu_torch.backend.sizer import BatchSizer

    monkeypatch.delenv("KTPU_STALL_TARGET_MS", raising=False)
    jsizer, sizer = JSizer(max_batch, deadline_s), BatchSizer(max_batch, deadline_s)
    targets = set()
    for bucket, latency in _sizer_trace(kind, max_batch):
        for n in (1, 17, bucket, bucket + 1, max_batch, 5000):
            assert sizer.bucket_for(n) == jsizer.bucket_for(n)
        jsizer.update(bucket, latency)
        sizer.update(bucket, latency)
        if waits:
            wait = 0.0002 * bucket * latency / (0.012 + 0.003 * bucket)
            jsizer.update_wait(bucket, wait)
            sizer.update_wait(bucket, wait)
        assert sizer.target() == jsizer.target()
        targets.add(sizer.target())
        assert (sizer._fit.a, sizer._fit.b) == (jsizer._a, jsizer._b)
        assert (sizer._wfit.a, sizer._wfit.b) == (jsizer._wfit.a, jsizer._wfit.b)
    if deadline_s == 0:
        assert targets == {max_batch}
    elif kind != "flat":
        assert min(targets) < max_batch  # the deadline did cut batches
    if waits and deadline_s and kind == "linear":
        assert max(targets) <= 64  # the stall cap: 15 ms at 0.2 ms per pod


class _StepClock:
    """A clock that moves ``step`` seconds at every read."""

    def __init__(self, step: float):
        self.t, self.step = 1000.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _deadline_run(jax_side: bool):
    """The default-deadline loop on a ``_StepClock(0.25)``: 20 nodes, 200
    pods, batches of 64. Returns (pops, placements, counters, queue,
    scheduler)."""
    clock = _StepClock(0.25)
    if jax_side:
        from kubernetes_tpu.apiserver.store import ClusterStore
        from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler as JTPUScheduler

        store = ClusterStore()
        store.validation_enabled = False
        sched = JTPUScheduler(store, batch_size=64, now_fn=clock)
        api = jax_api()
    else:
        from kubernetes_tpu_torch.apiserver.store import Store
        from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

        store = Store(now_fn=clock)
        sched = TPUScheduler(store, device="cpu", batch_size=64, now_fn=clock)
        api = torch_api()
    assert sched.sizer.deadline_s == 0.5 and sched.sizer.target() == 64
    for node in build_nodes(api, cluster_spec(20, 3)):
        store.create_node(node.node)
    for pod in build_pods(api, pods_spec(200, 4)):
        store.create_pod(pod)
    pops = []
    pop_batch = sched.queue.pop_batch

    def recording_pop(k):
        popped = pop_batch(k)
        pops.append(len(popped))
        return popped

    sched.queue.pop_batch = recording_pop
    sched.run_until_settled()
    pods = store.list_objects("Pod")[0] if jax_side else store.pods.values()
    placed = {p.key(): p.spec.node_name for p in pods}
    return pops, placed, dict(sched.metrics), dict(sched.queue.pending_pods()), sched


def test_default_deadline_cuts_batches(monkeypatch):
    """``TPUScheduler(store, device="cpu")`` without a deadline argument
    takes ``KTPU_BATCH_DEADLINE_MS`` (500 ms by default). On a clock where
    every batch spans seconds, the sizer cuts the pops down to its
    smallest bucket once the first commit fed it (the ring pops three
    batches first), every pod still binds through the store or parks, and
    each cut batch runs the program at the sizer's bucket of 16 pods, not
    at ``caps.pods``. Pops, placements, counters and queue equal the JAX
    loop's on the same clock."""
    monkeypatch.delenv("KTPU_BATCH_DEADLINE_MS", raising=False)
    monkeypatch.delenv("KTPU_FULL_BATCH", raising=False)
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.delenv("KTPU_STALL_TARGET_MS", raising=False)
    pops, placed, metrics, pending, sched = _deadline_run(jax_side=False)
    jax_run = _deadline_run(jax_side=True)
    assert (pops, placed, metrics, pending) == jax_run[:4]
    assert sched.sizer.target() == sched.sizer.min_batch == 16
    depth = sched.pipeline_depth
    assert pops[:depth + 1] == [64] * (depth + 1) and 0 < max(pops[depth + 1:]) <= 16
    assert sched.batch_buckets[:depth + 1] == [64] * (depth + 1)
    assert set(sched.batch_buckets[depth + 1:]) == {16}
    assert metrics["scheduled"] + pending["unschedulable"] + pending["backoff"] == 200
    assert sum(1 for n in placed.values() if n) == metrics["scheduled"]
