"""Gangs and torus slices through the port's scheduler loop
(``kubernetes_tpu_torch.backend.tpu_scheduler.TPUScheduler``,
``device="cpu"``) against the real JAX ``TPUScheduler`` under
``JAX_PLATFORMS=cpu``, with exact equality (``LoopPair.gang_state``):
placements, the pods popped per batch, the queue's contents, the pods
parked at Permit, the PodGroups' phase and count, and the gang and slice
metrics. Every case runs at ring depth 0, at depth 2, and at depth 2 with
the commit worker on both sides, its commits landed at the end of each
cycle so that the next pop does not race them.

The scenarios are the JAX loop tests' (tests/test_gang.py:375-575,
tests/test_slice.py:216-244): two gangs and solos; an infeasible gang
rejected whole; a gang of six split across batches of four, so Permit
crosses batches; a PodGroup's Permit timeout; a member deleted while its
siblings wait; the starvation guard; slice gangs landing contiguously, an
oversized one rejected and a rejected one planned again. And the queue's
gang co-activation rate limit against the JAX queue's. And the Permit
timeout with the worker's commits not landed between cycles, on the port
alone: outcomes that do not follow thread timing."""

import pytest

from _torch_cases import LoopPair, jax_api, torch_api

# (KTPU_PIPELINE_DEPTH, KTPU_COMMIT_WORKER); with the worker, its commits
# land at the end of each cycle (``LoopPair.land_worker_each_cycle``)
MODES = [("0", "0"), ("2", "0"), ("2", "1")]
HOST = "kubernetes.io/hostname"


@pytest.fixture(params=MODES, ids=["depth0", "depth2", "depth2-worker"])
def mode(request, monkeypatch):
    depth, worker = request.param
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)
    return request.param


def _pair(batch: int = 16) -> LoopPair:
    pair = LoopPair(batch=batch)
    pair.land_worker_each_cycle()
    depth = int(pair.tsched.pipeline_depth)
    assert depth == pair.jsched.pipeline_depth
    assert (pair.tsched.commit_worker is None) == (pair.jsched.commit_worker is None)
    return pair


def _close(pair: LoopPair) -> None:
    for sched in (pair.jsched, pair.tsched):
        sched._drain_inflight()
        if sched.commit_worker is not None:
            sched.commit_worker.stop()


def _nodes(pair, n, cpu="8", pods=32, torus=None):
    """``n`` nodes with hostname labels, or the torus rig of ``torus``
    (superpods, slots): hosts a slice pod fills whole."""
    from kubernetes_tpu_torch.ops.slice import TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL

    def build(api):
        if torus is None:
            return [api.make_node(f"node-{i}").capacity(
                {"cpu": cpu, "memory": "16Gi", "pods": pods}).label(HOST, f"node-{i}").obj()
                for i in range(n)]
        sps, slots = torus
        return [api.make_node(f"n{sp}-{s}").capacity({"cpu": "4", "memory": "16Gi", "pods": 8})
                .label(TOPO_SUPERPOD_LABEL, str(sp)).label(TOPO_SLOT_LABEL, str(s)).obj()
                for sp in range(sps) for s in range(slots)]

    for jn, tn in zip(build(jax_api()), build(torch_api())):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)


def _gang(pair, group, size, min_member=None, cpu="500m", anti=True, timeout_s=0,
          prefix=None, slice_=False):
    """The PodGroup, then its members (tests/test_gang.py ``gang_pod``,
    tests/test_slice.py ``_slice_gang``)."""
    from kubernetes_tpu_torch.ops.slice import SLICE_LABEL

    pair.add_pod_group(group, size if min_member is None else min_member, timeout_s=timeout_s)

    def build(api):
        out = []
        for i in range(size):
            if slice_:
                pw = api.make_pod(f"{prefix or group}-{i}").req(
                    {"cpu": "3500m", "memory": "12Gi"}).pod_group(group).label(SLICE_LABEL, "1")
            else:
                pw = api.make_pod(f"{prefix or group}-{i}").req(
                    {"cpu": cpu, "memory": "256Mi"}).pod_group(group)
                if anti:
                    pw.pod_affinity(HOST, api.LabelSelector(
                        match_labels={"scheduling.x-k8s.io/pod-group": group}), anti=True)
            out.append(pw.obj())
        return out

    pair.add_pods(build(jax_api()), build(torch_api()))


def _solos(pair, n, cpu="200m", prefix="solo", priority=0):
    def build(api):
        out = []
        for i in range(n):
            pw = api.make_pod(f"{prefix}-{i}").req({"cpu": cpu})
            if priority:
                pw.priority(priority)
            out.append(pw.obj())
        return out

    pair.add_pods(build(jax_api()), build(torch_api()))


def _bound(state, prefix):
    return {k: n for k, n in state["placed"].items() if n and k.startswith(f"default/{prefix}")}


def test_two_gangs_and_solos(mode):
    """tests/test_gang.py:387: both gangs land whole, Running."""
    pair = _pair()
    _nodes(pair, 12)
    _gang(pair, "train", 4)
    _gang(pair, "infer", 2)
    _solos(pair, 3)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert sum(1 for n in got["placed"].values() if n) == 9
    assert got["pod_groups"] == {"default/train": ("Running", 4), "default/infer": ("Running", 2)}
    assert got["waiting"] == [] and got["gangs_rejected"] == {}


def test_infeasible_gang_rejected_whole(mode):
    """tests/test_gang.py:410: five mutually anti-affine members on three
    nodes: the gang is rejected whole, nothing waits, the solo binds; past
    the gang's backoff it is tried again and rejected again."""
    pair = _pair()
    _nodes(pair, 3)
    _gang(pair, "big", 5, timeout_s=2)
    _solos(pair, 1)
    pair.settle()
    got = pair.assert_gang_equal()
    assert set(k for k, n in got["placed"].items() if n) == {"default/solo-0"}
    assert got["waiting"] == [] and sum(got["gangs_rejected"].values()) >= 1
    pair.advance(6.0)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert _bound(got, "big") == {} and sum(got["gangs_rejected"].values()) >= 2


def test_gang_split_across_batches(mode):
    """tests/test_gang.py:430: a gang of six in batches of four: the first
    batch's members park at Permit and the second batch's quorum allows
    them; every member on its own node."""
    pair = _pair(batch=4)
    _nodes(pair, 10)
    _gang(pair, "wide", 6)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert len(set(_bound(got, "wide").values())) == 6
    assert got["pod_groups"] == {"default/wide": ("Running", 6)}
    assert [len(b) for b in got["popped"]] == [4, 2]
    assert got["gang_wait"] == {("scheduled",): (1, 0.0)}


def test_permit_timeout(mode):
    """A gang's first batch parks at Permit while higher-priority pods
    take the next batch; past the PodGroup's timeout the sweep rejects the
    parked members whole ("timeout"); past the gang's backoff it lands."""
    pair = _pair(batch=4)
    _nodes(pair, 10)
    _gang(pair, "late", 6, timeout_s=2)
    for sched in (pair.jsched, pair.tsched):
        sched.schedule_batch_cycle()  # the first four members
    _solos(pair, 4, priority=10, prefix="hi")
    pair.advance(3.0)
    pair.settle()
    got = pair.assert_gang_equal()
    if mode[0] == "0":  # inline, the first batch parked before the clock moved
        assert got["gangs_rejected"] == {("timeout",): 1}
        assert got["pod_groups"] == {"default/late": ("Pending", 0)}
    pair.advance(6.0)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert len(_bound(got, "hi")) == 4 and got["waiting"] == []
    assert len(_bound(got, "late")) in (0, 6)


@pytest.mark.parametrize("step", [0.25, 1.0, 3.0])
def test_permit_timeout_with_unlanded_worker(step, monkeypatch):
    """The Permit timeout at depth 2 with the commit worker on and nothing
    landing its commits between cycles: the gang's first four members park
    on the worker while higher-priority batches pop, the clock moving
    ``step`` per cycle, so the timeout meets the gang's last two members
    before or after they commit, as thread timing falls. Whatever the
    timing, the gang ends whole and Running or rejected "timeout" and
    unbound, nothing waits at Permit, no assume stays open, and the cache
    holds what the store binds."""
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "2")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "1")
    pair = LoopPair(batch=4)
    assert pair.tsched.commit_worker is not None
    _nodes(pair, 10)
    _gang(pair, "late", 6, timeout_s=2)
    pair.tsched.schedule_batch_cycle()  # the first four members
    _solos(pair, 8, priority=10, prefix="hi")
    _solos(pair, 4, prefix="lo")
    pair.drive_port_unlanded(6, step)
    for advance in (0.0, 10.0):
        pair.tclock.advance(advance)
        pair.tsched.queue.flush_backoff_completed()
        pair.cycles[1] += pair.tsched.run_until_settled()
        got = pair.assert_port_consistent()
        late = _bound(got, "late")
        if len(late) == 6:
            assert len(set(late.values())) == 6
            assert got["pod_groups"] == {"default/late": ("Running", 6)}
        else:
            assert late == {} and got["gangs_rejected"].get(("timeout",), 0) >= 1
            assert got["pod_groups"]["default/late"][0] != "Running"
    _close(pair)
    assert len(_bound(got, "hi")) == 8 and len(_bound(got, "lo")) == 4


def test_member_deleted_while_siblings_wait(mode):
    """A parked member is deleted: the gang is one member short, so its
    last two fail Coscheduling's gate, and the parked four (the deleted one
    still among them) wait until the sweep rejects them at the timeout."""
    pair = _pair(batch=4)
    _nodes(pair, 10)
    _gang(pair, "wide", 6, timeout_s=30)
    for sched in (pair.jsched, pair.tsched):
        sched.schedule_batch_cycle()
        sched._drain_inflight()
    assert sorted(pair.tsched.waiting_pods) == sorted(pair.jsched.waiting_pods)
    pair.delete_pod("default/wide-1")
    pair.settle()
    got = pair.assert_gang_equal()
    # five members left: the last two fail Coscheduling's gate, and the
    # four parked (the deleted one among them) wait for the timeout
    assert len(got["waiting"]) == 4 and got["pending"]["unschedulable"] == 2
    pair.advance(40.0)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert "default/wide-1" not in got["placed"] and got["waiting"] == []


def test_stuck_gang_does_not_starve_singletons(mode):
    """tests/test_gang.py:519 through the loop: a 32-pod gang of full-node
    members on four nodes is rejected, and its backoff keeps it from
    holding the nodes while the singletons bind."""
    pair = _pair(batch=8)
    _nodes(pair, 4, cpu="2")
    _gang(pair, "huge", 32, cpu="2", anti=False, timeout_s=1)
    pair.settle()
    pair.assert_gang_equal()
    _solos(pair, 6)
    pair.settle()
    pair.assert_gang_equal()
    for _ in range(4):
        pair.advance(1.6)
        pair.settle()
        got = pair.assert_gang_equal()
    _close(pair)
    assert len(_bound(got, "solo")) == 6
    assert len(_bound(got, "huge")) == 0 and sum(got["gangs_rejected"].values()) >= 1


def test_slice_gangs_land_contiguously(mode):
    """tests/test_slice.py:217: two slice gangs on a 2 x 8 torus, each on
    consecutive slots of one superpod."""
    pair = _pair(batch=32)
    _nodes(pair, 0, torus=(2, 8))
    _gang(pair, "a", 4, slice_=True)
    _gang(pair, "b", 3, slice_=True)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    for group, size in (("a", 4), ("b", 3)):
        cells = sorted((int(n[1]), int(n[3:])) for k, n in got["placed"].items()
                       if n and k.startswith(f"default/{group}-"))
        assert len(cells) == size and len({sp for sp, _ in cells}) == 1
        assert cells[-1][1] - cells[0][1] == size - 1
    assert got["slice_wait"] == {("scheduled",): (2, 0.0)}


def test_slice_gang_rejected_then_planned_again(mode):
    """An oversized slice gang (six hosts, four slots) is rejected
    "infeasible"; a third four-host gang finds no window while two others
    hold the torus, and after one of them leaves and its backoff lapses it
    is planned again onto the freed superpod."""
    pair = _pair(batch=32)
    _nodes(pair, 0, torus=(2, 4))
    _gang(pair, "wide", 6, slice_=True)
    _gang(pair, "a", 4, slice_=True)
    _gang(pair, "b", 4, slice_=True)
    _gang(pair, "c", 4, slice_=True)
    pair.settle()
    got = pair.assert_gang_equal()
    assert _bound(got, "wide") == {} and _bound(got, "c") == {}
    assert got["gangs_rejected"].get(("infeasible",), 0) >= 2
    for i in range(4):
        pair.delete_pod(f"default/a-{i}")
    pair.advance(6.0)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert len(_bound(got, "c")) == 4 and got["pod_groups"]["default/c"] == ("Running", 4)
    assert got["slice_fragmentation"] == pair.gang_state(0)["slice_fragmentation"]


def test_torus_outgrows_mirror_twice(mode):
    """A 64-slot torus on a mirror built for 16 slots. A sync that meets
    slot 16 first names 17 slots; the mirror grown to 32 then meets slot 62
    in its own sync (the snapshot's order follows the process's string
    hashing, so a run may meet them so). The growth grows again until every
    slot fits, and a slice gang then lands on consecutive slots. The port
    alone: the JAX loop's ``_resync_grown``
    (``kubernetes_tpu/backend/tpu_scheduler.py:386-411``) grows once."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.ops.encode import CapacityError
    from kubernetes_tpu_torch.ops.slice import SLICE_LABEL, TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL

    api = torch_api()
    store = Store()
    for s in range(64):
        store.create_node(api.make_node(f"n0-{s}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": 8})
            .label(TOPO_SUPERPOD_LABEL, "0").label(TOPO_SLOT_LABEL, str(s)).obj())
    sched = TPUScheduler(store, device="cpu", batch_size=16, batch_deadline_ms=0)
    try:
        sched._ensure_device()  # on the empty snapshot, at caps_for_cluster's slots
        assert sched.state.caps.sp_slots == 16
        sched.cache.update_snapshot(sched.snapshot)
        sched._resync_grown(CapacityError("sp_slots", 17, 16))
        assert sched.state.caps.sp_slots == 64
        store.create_object("PodGroup", PodGroup(meta=ObjectMeta(name="g", namespace="default"),
                                                 min_member=4))
        for i in range(4):
            store.create_pod(api.make_pod(f"g-{i}").req({"cpu": "3500m", "memory": "12Gi"})
                             .pod_group("g").label(SLICE_LABEL, "1").obj())
        sched.run_until_settled()
        sched._drain_inflight()
        slots = sorted(int(store.get_pod(f"default/g-{i}").spec.node_name[3:])
                       for i in range(4))
    finally:
        if sched.commit_worker is not None:
            sched.commit_worker.stop()
    assert slots == list(range(slots[0], slots[0] + 4))
    assert sched.state.caps.sp_slots == 64


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_gang_coactivation_is_rate_limited(pkg):
    """tests/test_gang.py:547 on each package's queue: activate_gang
    moves the gang's parked members, then not again within the interval."""
    if pkg == "jax":
        from kubernetes_tpu.framework.plugins.coscheduling import pod_group_key
        from kubernetes_tpu.framework.types import QueuedPodInfo
        from kubernetes_tpu.queue.scheduling_queue import SchedulingQueue
        from kubernetes_tpu.utils.clock import FakeClock
        api = jax_api()
    else:
        from kubernetes_tpu_torch.framework.plugins.coscheduling import pod_group_key
        from kubernetes_tpu_torch.framework.types import QueuedPodInfo
        from kubernetes_tpu_torch.queue.scheduling_queue import SchedulingQueue
        from kubernetes_tpu_torch.utils.clock import FakeClock
        api = torch_api()
    clock = FakeClock()
    # the port's interval is its POD_INITIAL_BACKOFF (1 s); the JAX queue's is an option
    kw = {"gang_coactivation_interval": 1.0} if pkg == "jax" else {}
    q = SchedulingQueue(now_fn=clock, gang_key_fn=pod_group_key, **kw)

    def park():
        q._in_queue.clear()
        q._active.clear()
        for i in range(3):
            pod = api.make_pod(f"m-{i}").req({"cpu": "1"}).pod_group("g").obj()
            q._unschedulable[pod.key()] = QueuedPodInfo(pod=pod, timestamp=clock())

    park()
    assert q.activate_gang("default/g") == 3
    park()
    assert q.activate_gang("default/g") == 0
    clock.advance(1.5)
    assert q.activate_gang("default/g") == 3
