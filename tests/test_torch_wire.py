"""The batched device service over HTTP against the JAX package's
(``kubernetes_tpu/backend/service.py``; the counterparts of
``tests/test_wire_service.py``): each package's ``WireScheduler`` against
its ``serve(DeviceService)`` on 127.0.0.1 in one process
(``_torch_cases.WirePair``; the port's service on ``device="cpu"``), both
stores fed the same objects in the same order. Each case asserts the
port's outcome equal to the JAX pair's where the JAX outcome is
deterministic: placements, queue contents, counters, resyncs, session
rejoins and conflict verdicts, at pipeline depth 0 and 3. The cross cases
run each client against the other package's service; the no-fallback
cases show that the port's service raises what the JAX one would swallow.
"""

import numpy as np
import pytest
import torch

from _torch_cases import (WirePair, build_nodes, build_pods, claim_allocations, cluster_spec,
                          jax_api, pods_spec, to_jax, torch_api)

DEPTHS = (0, 3)
READ_TIMEOUT = 10.0


def _nodes(api, store, n=4, cpu="4", mem="8Gi", pods=10, zones=2):
    for i in range(n):
        store.create_node(api.make_node(f"n{i}").capacity(
            {"cpu": cpu, "memory": mem, "pods": pods}).label("zone", f"z{i % zones}").obj())


def _pods(api, store, n=12, cpu="1", mem="1Gi", prefix="p"):
    for i in range(n):
        store.create_pod(api.make_pod(f"{prefix}{i}").req({"cpu": cpu, "memory": mem}).obj())


def _one_node(cpu="4", mem="8Gi"):
    def build(api, store):
        store.create_node(api.make_node("n0").capacity(
            {"cpu": cpu, "memory": mem, "pods": 10}).obj())
    return build


def _pod(name, cpu="500m"):
    def build(api, store):
        store.create_pod(api.make_pod(name).req({"cpu": cpu}).obj())
    return build


def _modules(pkg):
    return WirePair._modules(pkg)


# ------------------------------------------------------------------ the codec


def _codec_objects(api):
    """Pods and nodes with every field family of the main path and the
    topology rules, from the shared seeded specs."""
    pods = build_pods(api, pods_spec(16, seed=7))
    sel = api.LabelSelector(match_labels={"app": "web"})
    pods.append(api.make_pod("topo").req({"cpu": "1500m", "memory": "2Gi"}).label("app", "web")
                .priority(100).node_affinity_in("disk", ["ssd"])
                .spread_constraint(1, "zone", selector=sel)
                .pod_affinity("zone", sel, anti=True)
                .toleration("dedicated", "gpu", "NoSchedule").obj())
    infos = build_nodes(api, cluster_spec(8, seed=3))
    nodes = [ni.node for ni in infos] + [p for ni in infos for p in ni.pods]
    return pods + nodes


def test_codec_equals_jax_both_ways():
    """The wire format is a contract between the packages: for the same
    objects the port's ``to_wire`` equals JAX's, and each package's
    ``from_wire`` of the other's bytes round-trips to the same bytes."""
    from kubernetes_tpu.api import codec as jcodec
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu_torch.api import codec as tcodec
    from kubernetes_tpu_torch.api import types as ttypes

    jobjs, tobjs = _codec_objects(jax_api()), _codec_objects(torch_api())
    assert len(jobjs) == len(tobjs) > 20
    for jo, to in zip(jobjs, tobjs):
        jw, tw = jcodec.to_wire(jo), tcodec.to_wire(to)
        assert tw == jw
        name = type(to).__name__
        # port bytes into JAX objects and back, JAX bytes into the port's
        assert jcodec.to_wire(jcodec.from_wire(getattr(jtypes, name), tw)) == jw
        back = tcodec.from_wire(getattr(ttypes, name), jw)
        assert type(back) is type(to) and tcodec.to_wire(back) == tw
        if name == "Pod":
            assert back.resource_request() == to.resource_request()
            assert back.key() == to.key()


def test_codec_field_mismatch_is_a_wire_difference_not_a_crash():
    """A field one package does not know is dropped by ``from_wire``: it
    shows as a difference in the bytes, never as an exception."""
    from kubernetes_tpu_torch.api import codec as tcodec
    from kubernetes_tpu_torch.api.types import Pod

    pod = torch_api().make_pod("x").req({"cpu": "1"}).obj()
    wire = tcodec.to_wire(pod)
    wire["spec"]["only_in_a_newer_peer"] = 3
    assert tcodec.to_wire(tcodec.from_wire(Pod, wire)) == tcodec.to_wire(pod) != wire


# ------------------------------------------------------------------ end to end


@pytest.mark.parametrize("depth", DEPTHS)
def test_end_to_end(depth):
    with WirePair(depth=depth) as pair:
        pair.build(_nodes)
        pair.build(_pods)
        pair.settle()
        state = pair.assert_equal()
    assert state["metrics"]["scheduled"] == 12
    per_node = {}
    for node in state["placed"].values():
        per_node[node] = per_node.get(node, 0) + 1
    assert all(v <= 4 for v in per_node.values()), per_node


@pytest.mark.parametrize("depth", DEPTHS)
def test_unschedulable_and_recovery(depth):
    def small(api, store):
        store.create_node(api.make_node("small").capacity(
            {"cpu": "1", "memory": "2Gi", "pods": 10}).obj())
        store.create_pod(api.make_pod("big").req({"cpu": "4", "memory": "4Gi"}).obj())

    def large(api, store):
        store.create_node(api.make_node("large").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": 10}).obj())

    with WirePair(depth=depth) as pair:
        pair.build(small)
        pair.settle()
        state = pair.assert_equal()
        assert state["metrics"]["scheduled"] == 0
        assert state["pending"]["unschedulable"] == 1
        assert state["queued"] == [("default/big", 1, ("NodeResourcesFit",))]
        pair.build(large)
        pair.advance(1.1)
        pair.settle()
        state = pair.assert_equal()
    assert state["placed"]["default/big"] == "large"


def _spread_workload(api, store):
    for i in range(6):
        store.create_node(api.make_node(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": 20}).label("zone", f"z{i % 3}").obj())
    for i in range(15):
        pw = api.make_pod(f"p{i}").req({"cpu": "1", "memory": "1Gi"})
        if i % 3 == 0:
            pw.label("app", "web").spread_constraint(
                1, "zone", selector=api.LabelSelector(match_labels={"app": "web"}))
        store.create_pod(pw.obj())


@pytest.mark.parametrize("depth", DEPTHS)
def test_matches_in_process_loop(depth, monkeypatch):
    """The wire and the port's in-process loop place the same workload
    identically (same program, same tie-break seeds), topology batches
    included."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    with WirePair(depth=depth) as pair:
        pair.build(_spread_workload)
        pair.settle()
        wire = pair.assert_equal()
        assert pair.service(1).batch_paths and "scan" in pair.service(1).batch_paths
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    clock = FakeClock()
    store = Store(now_fn=clock)
    store.validation_enabled = False
    loop = TPUScheduler(store, device="cpu", batch_size=8, batch_deadline_ms=0, now_fn=clock)
    _spread_workload(torch_api(), store)
    loop.run_until_settled()
    assert wire["metrics"]["scheduled"] == loop.metrics["scheduled"] == 15
    assert wire["placed"] == {k: p.spec.node_name for k, p in store.pods.items()}


def test_basic_run_equals_the_loop(monkeypatch):
    """``run_loop_wire`` at depth 0 against the port's ``run_loop`` (its
    ring at the default depth), both at percentage 100, on SchedulingBasic:
    the same placements, pods per batch, counters and queue, which is what
    ``chip_smoke.py``'s loop_wire phase holds the card's wire runs to."""
    from kubernetes_tpu_torch.perf import workloads

    monkeypatch.delenv("KTPU_PIPELINE_DEPTH", raising=False)
    monkeypatch.delenv("KTPU_COMMIT_WORKER", raising=False)
    w = workloads.scheduling_basic(200, 96, 160)
    loop = workloads.run_loop(w, "cpu", percentage=100)
    wire = workloads.run_loop_wire(w, "cpu", 0, percentage=100)
    for key in ("placed", "batch_pods", "metrics", "pending"):
        assert wire[key] == loop[key], key
    assert wire["placements"] == wire["binds"] == 256 and wire["double_binds"] == []


def _claims_workload(pair):
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceClaim, ResourceClass

    def nodes(api, store):
        for i in range(6):
            store.create_node(api.make_node(f"n{i}").capacity(
                {"cpu": "8", "memory": "16Gi", "pods": 20}).device_attrs(
                    {"tpu.dev/cores": 8 if i % 2 else 2,
                     "tpu.dev/gen": "v5" if i % 2 else "v4"}).obj())

    pair.build(nodes)
    objs = [("ResourceClass", ResourceClass(meta=ObjectMeta(name="tpu.example.com", namespace=""),
                                            driver_name="tpu.example.com",
                                            selectors={"tpu.dev/gen": "v5"}))]
    for i in range(4):
        objs.append(("ResourceClaim", ResourceClaim(meta=ObjectMeta(name=f"c{i}"),
                                                    resource_class_name="tpu.example.com",
                                                    selectors={"tpu.dev/cores": ">=4"})))
    for kind, obj in objs:
        pair.stores[0].create_object(kind, to_jax(obj))
        pair.stores[1].create_object(kind, obj)

    def pods(api, store):
        for i in range(4):
            store.create_pod(api.make_pod(f"claim-{i}").req({"cpu": "300m"})
                             .resource_claim("dev", claim_name=f"c{i}").obj())
            store.create_pod(api.make_pod(f"plain-{i}").req({"cpu": "300m"}).obj())

    pair.build(pods)


@pytest.mark.parametrize("depth", DEPTHS)
def test_claim_pods_stay_on_wire(depth):
    """Claim pods ride the wire (their selector rows in the request, the
    mask built against the service's attribute table): nothing degraded,
    allocations equal, every claim pod on a v5 node."""
    with WirePair(batch=16, depth=depth) as pair:
        _claims_workload(pair)
        pair.settle()
        state = pair.assert_equal()
        assert claim_allocations(pair.stores[1]) == claim_allocations(pair.stores[0])
        assert pair.scheds[1].degraded_pods == 0
    assert state["metrics"]["scheduled"] == 8
    for key, node in state["placed"].items():
        if key.startswith("default/claim"):
            assert int(node[1:]) % 2 == 1, (key, node)


# ------------------------------------------------------------------ 409s and conflicts


@pytest.mark.parametrize("client_pkg,service_pkg",
                         [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_conflict_vs_stale_epoch_409(client_pkg, service_pkg):
    """Two 409s on one status code: ``staleEpoch`` (resync) and
    ``conflict`` (another client owns it) map to distinct typed errors,
    whichever package serves or calls."""
    client_mod, _ = _modules(client_pkg)
    server_mod, _ = _modules(service_pkg)
    if client_pkg == "jax":
        from kubernetes_tpu.backend.errors import ConflictError, StaleEpochError
    else:
        from kubernetes_tpu_torch.backend.errors import ConflictError, StaleEpochError
    kw = {"device": "cpu"} if service_pkg == "port" else {}
    service = server_mod.DeviceService(batch_size=8, **kw)
    server, port = server_mod.serve(service)
    try:
        client = client_mod.WireClient(f"http://127.0.0.1:{port}", read_timeout=READ_TIMEOUT)
        with pytest.raises(StaleEpochError) as stale:
            client.apply_deltas({"expectEpoch": "not-this-process", "nodes": []})
        assert stale.value.epoch == service.epoch
        service.apply_deltas({"clientId": "A", "nodes": []})
        gen_a = service.sessions["A"].gen
        service._fence(service.sessions["A"])
        with pytest.raises(ConflictError):
            client.schedule_batch({"clientId": "A", "sessionGen": gen_a, "pods": []})
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("depth", DEPTHS)
def test_conflict_requeues_via_backoff_not_breaker(depth):
    with WirePair(depth=depth, plan=True, client_ids=("confl", "confl"),
                  sched_kw=dict(breaker_threshold=2)) as pair:
        pair.build(_one_node())
        for plan in pair.plans:
            plan.conflict("schedule_batch")
        pair.build(_pod("p0"))
        pair.settle()
        state = pair.assert_equal()
        assert state["metrics"]["scheduled"] == 0
        assert state["pending"]["backoff"] == 1
        assert state["breaker"] == "closed" and state["degraded_pods"] == 0
        assert state["session_rejoins"] == 1 and state["conflicts"] == 1
        pair.advance(1.1)
        pair.settle()
        state = pair.assert_equal()
    assert state["metrics"]["scheduled"] == 1 and state["breaker"] == "closed"
    assert state["service_batches"] > 0


@pytest.mark.parametrize("depth", DEPTHS)
def test_per_pod_conflict_requeues_one_pod(depth):
    """A rival session holds one pod before our batch reaches the service:
    that pod alone gets the conflict verdict; the rest binds."""
    with WirePair(depth=depth, client_ids=("mine", "mine")) as pair:
        pair.build(_one_node(cpu="8"))
        pair.build(_pod("stolen", "1"))
        pair.build(_pod("okay", "1"))
        for side in (0, 1):
            codec = _modules(("jax", "port")[side])[0]
            store, service = pair.stores[side], pair.service(side)
            entry = {"gen": 1, "node": codec.to_wire(store.nodes["n0"]), "pods": []}
            service.apply_deltas({"clientId": "rival", "nodes": [entry]})
            service.schedule_batch({"clientId": "rival", "batchId": "rival-1",
                                    "pods": [codec.to_wire(store.get_pod("default/stolen"))]})
        pair.settle()
        state = pair.assert_equal()
    assert state["placed"]["default/okay"] == "n0"
    assert state["placed"]["default/stolen"] == ""
    assert state["conflicts"] >= 1 and state["pending"]["backoff"] == 1


# ------------------------------------------------------------------ restarts, breaker, sessions


@pytest.mark.parametrize("depth", DEPTHS)
def test_full_resync_after_restart_with_rejoined_session(depth):
    with WirePair(depth=depth, plan=True, client_ids=("rs", "rs")) as pair:
        pair.build(_one_node(cpu="8"))
        pair.build(_pod("p0", "1"))
        pair.settle()
        assert all(s._session_gen is not None for s in pair.scheds)
        for side in (0, 1):
            service = pair.service(side)
            service._fence(service.sessions["rs"])
        pair.build(_pod("p1", "1"))
        pair.settle()
        pair.advance(1.1)
        pair.settle()
        state = pair.assert_equal()
        assert state["session_rejoins"] == 1
        assert all(s._session_gen is not None and s._session_gen > 1 for s in pair.scheds)
        assert state["placed"]["default/p1"] == "n0"
        conflicts_after_rejoin = state["conflicts"]
        for plan in pair.plans:
            plan.crash("apply_deltas")
        pair.build(_pod("p2", "1"))
        pair.settle()
        pair.advance(1.1)
        pair.settle()
        state = pair.assert_equal()
        assert [server.binding.restarts for _pkg, server in pair.servers] == [1, 1]
    assert state["placed"]["default/p2"] == "n0"
    assert state["resyncs"] == 1 and state["breaker"] == "closed"
    assert state["conflicts"] == conflicts_after_rejoin


def test_heartbeat_skipped_while_breaker_open():
    with WirePair(plan=True, client_ids=("hb", "hb"),
                  sched_kw=dict(wire_max_retries=0, breaker_threshold=1, breaker_reset_s=60.0,
                                heartbeat_interval_s=1.0)) as pair:
        pair.build(_one_node())
        beats = [[], []]
        for side, sched in enumerate(pair.scheds):
            real = sched.client.heartbeat
            sched.client.heartbeat = (
                lambda p, _real=real, _b=beats[side]: (_b.append(1), _real(p))[1])
        for plan in pair.plans:
            plan.drop(count=1)
        pair.build(_pod("p0"))
        pair.settle()
        state = pair.assert_equal()
        assert state["breaker"] == "open" and state["metrics"]["scheduled"] == 1
        for _ in range(5):
            pair.advance(2.0)
            pair.settle()
        pair.assert_equal()
    assert beats == [[], []]


def test_heartbeat_verb_and_debug_sessions():
    with WirePair(client_ids=("dbg", "dbg")) as pair:
        pair.build(_one_node())
        pair.build(_pod("p0"))
        pair.settle()
        pair.assert_equal()
        docs = []
        for side, sched in enumerate(pair.scheds):
            sched._heartbeat()
            assert sched._session_gen == pair.service(side).sessions["dbg"].gen
            assert sched.smetrics.client_sessions.labels() == 1
            docs.append(sched.debug_sessions())
    rows = []
    for doc in docs:
        assert doc["enabled"] and doc["clientId"] == "dbg"
        table = {s["clientId"]: s for s in doc["service"]["sessions"]}
        row = table["dbg"]
        assert row["deltaSeq"] >= 1 and row["leaseAgeS"] >= 0.0 and row["batches"] >= 1
        assert row["fenced"] is False
        rows.append({k: row[k] for k in ("deltaSeq", "sentNodes", "batches", "batchReplays",
                                         "inflightHolds", "releasedHolds", "fenced")})
    assert rows[1] == rows[0]


def test_health_verb_and_half_open_probe():
    with WirePair(plan=True, sched_kw=dict(wire_max_retries=0, breaker_threshold=1,
                                           breaker_reset_s=5.0)) as pair:
        for side, sched in enumerate(pair.scheds):
            out = sched.client.health()
            assert out["status"] == "serving" and out["epoch"] == pair.service(side).epoch
        pair.build(lambda api, store: _nodes(api, store, n=2))
        for plan in pair.plans:
            plan.drop(count=1)
        pair.build(_pod("p0"))
        pair.settle()
        state = pair.assert_equal()
        assert state["breaker"] == "open" and state["metrics"]["scheduled"] == 1
        for plan in pair.plans:
            plan.drop(op="health", count=1)
        pair.advance(5.5)
        pair.build(_pod("p1"))
        pair.settle()
        state = pair.assert_equal()
        assert all(("client", "health", "drop") in plan.log for plan in pair.plans)
        assert state["breaker"] == "open" and state["metrics"]["scheduled"] == 2
        pair.advance(5.5)
        pair.build(_pod("p2"))
        pair.settle()
        state = pair.assert_equal()
    assert state["breaker"] == "closed" and state["metrics"]["scheduled"] == 3
    assert state["service_batches"] > 0


# ------------------------------------------------------------------ the pipeline


def _rig(depth, **kw):
    pair = WirePair(batch=4, depth=depth, plan=True,
                    sched_kw=dict(heartbeat_interval_s=0.0, wire_max_retries=1,
                                  pod_initial_backoff=0.01, pod_max_backoff=0.05), **kw)
    try:
        pair.build(lambda api, store: _nodes(api, store, cpu="8", mem="16Gi", pods=20,
                                             zones=1))
        pair.build(lambda api, store: _pods(api, store, cpu="500m", mem="0"))
    except BaseException:
        pair.close()
        raise
    return pair


def test_pipelined_placements_match_synchronous():
    placed = {}
    for depth in DEPTHS:
        with _rig(depth) as pair:
            pair.settle()
            state = pair.assert_equal()
            assert state["metrics"]["scheduled"] == 12 and state["service_replays"] == 0
            placed[depth] = state["placed"]
    assert placed[0] == placed[3]


def test_keeps_k_batches_in_flight():
    with _rig(3) as pair:
        for _ in range(3):
            for sched in pair.scheds:
                sched.schedule_batch_cycle()
        for sched in pair.scheds:
            assert len(sched._wire_inflight) == 3
            assert sched.smetrics.wire_inflight.labels() == 3
        pair.settle()
        state = pair.assert_equal()
        for sched in pair.scheds:
            assert len(sched._wire_inflight) == 0
            assert sched.smetrics.wire_inflight.labels() == 0
            assert sched.pipelined_wire_batches >= 2
            assert sched.wire_sizer.updates >= 3
        assert pair.scheds[1].pipelined_wire_batches == pair.scheds[0].pipelined_wire_batches
    assert state["metrics"]["scheduled"] == 12


def test_out_of_order_replies_matched_by_batch_id():
    """The reorder fault swaps two replies across lanes (both clients on
    three lanes): each reaches its batch by the echoed batchId. Which batch
    the service runs first follows thread timing (C26), so both packages
    are held to the order-free invariants, equal between them."""
    with _rig(3, one_lane=False) as pair:
        for plan in pair.plans:
            plan.reorder("schedule_batch")
        pair.settle()
        for side in (0, 1):
            assert ("reply", "schedule_batch", "reorder") in pair.plans[side].log
            assert pair.scheds[side]._wire_pipeline.duplicate_replies == 0
        held = [pair.invariants(side) for side in (0, 1)]
    assert held[1] == held[0] == {"bound": 12, "over_capacity": [],
                                  "program_runs_equal_batches": True, "service_replays": 0,
                                  "degraded_pods": 0}


def _roomy(name):
    """Roomy workloads (every pod fits in any order), by name."""
    if name == "plain":
        return 12, [_nodes, _pods]
    if name == "half-cpu":
        return 12, [lambda api, store: _nodes(api, store, cpu="8", mem="16Gi", pods=20),
                    lambda api, store: _pods(api, store, cpu="500m", mem="0")]
    return 24, [lambda api, store: _nodes(api, store, n=6, cpu="16", mem="32Gi", pods=30),
                lambda api, store: _pods(api, store, n=24, cpu="1", mem="1Gi")]


@pytest.mark.parametrize("workload", ["plain", "half-cpu", "wide"])
def test_full_lanes_keep_the_invariants(workload):
    """Three batches in flight on three lanes each: the service runs them
    in the order its handler threads take the lock (C26), so placements
    may differ from the synchronous run, but in both packages every pod
    binds, no node holds more than it has, the program runs once per batch
    sent, nothing replays and nothing degrades."""
    n, builders = _roomy(workload)
    with WirePair(batch=4, depth=3, one_lane=False) as pair:
        for fn in builders:
            pair.build(fn)
        pair.settle()
        pair.advance(2.0)
        pair.settle()
        held = [pair.invariants(side) for side in (0, 1)]
    assert held[1] == held[0] == {"bound": n, "over_capacity": [],
                                  "program_runs_equal_batches": True, "service_replays": 0,
                                  "degraded_pods": 0}


def test_duplicate_reply_dropped_by_router():
    with _rig(3) as pair:
        for plan in pair.plans:
            plan.dup_reply("schedule_batch")
        pair.settle()
        state = pair.assert_equal()
        assert [s._wire_pipeline.duplicate_replies for s in pair.scheds] == [1, 1]
    assert state["metrics"]["scheduled"] == 12 and state["service_replays"] == 0


@pytest.mark.parametrize("depth", DEPTHS)
def test_torn_reply_replays_idempotently(depth):
    """The service commits, the reply is lost: the transport retry replays
    the stored reply by batchId, and the batch program runs once per
    logical batch (the service's batch count equals the batches the
    client sent)."""
    with _rig(depth) as pair:
        for plan in pair.plans:
            plan.torn("schedule_batch")
        pair.settle()
        state = pair.assert_equal()
        port_sched = pair.scheds[1]
        assert pair.service(1).batch_counter == port_sched.wire_batches
    assert state["service_replays"] == 1 and state["metrics"]["scheduled"] == 12
    per_node = {}
    for node in state["placed"].values():
        per_node[node] = per_node.get(node, 0) + 1
    assert all(v <= 16 for v in per_node.values())


def _holds_script(pkg):
    """The pipelined hole in hold reconciliation: an owner push that omits
    a placement of a batch still in flight keeps its hold; omitted after
    the batch lands, it releases."""
    mod, _ = _modules(pkg)
    api = jax_api() if pkg == "jax" else torch_api()
    kw = {"device": "cpu"} if pkg == "port" else {}
    service = mod.DeviceService(batch_size=8, **kw)
    node = api.make_node("n0").capacity({"cpu": "4", "memory": "8Gi", "pods": 10}).obj()
    entry = {"gen": 1, "node": mod.to_wire(node), "pods": []}
    service.apply_deltas({"clientId": "A", "nodes": [entry]})
    pod = mod.to_wire(api.make_pod("p").req({"cpu": "2"}).obj())
    out = service.schedule_batch({"clientId": "A", "pods": [pod], "batchId": "b-1"})
    seen = [out["results"][0]["nodeName"], out["batchId"],
            service.infos["n0"].requested.milli_cpu]
    service.apply_deltas({"clientId": "A", "nodes": [dict(entry, gen=2)],
                          "inflightBatchIds": ["b-1"]})
    seen += [sorted(h.pod.meta.name for h in service.holds.values()),
             service.infos["n0"].requested.milli_cpu]
    service.apply_deltas({"clientId": "A", "nodes": [dict(entry, gen=3)]})
    seen += [len(service.holds), service.infos["n0"].requested.milli_cpu]
    return seen


def test_inflight_batch_holds_survive_owner_delta_push():
    got, want = _holds_script("port"), _holds_script("jax")
    assert got == want == ["n0", "b-1", 2000, ["p"], 2000, 0, 0]


def _replicator_script(pkg):
    mod, _ = _modules(pkg)
    api = jax_api() if pkg == "jax" else torch_api()
    kw = {"device": "cpu"} if pkg == "port" else {}
    service = mod.DeviceService(batch_size=8, **kw)

    def node_v(v):
        return mod.to_wire(api.make_node("n0").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 10}).label("v", v).obj())

    seen = []
    service.apply_deltas({"clientId": "A", "nodes": [{"gen": 5, "node": node_v("2"), "pods": []}]})
    service.apply_deltas({"clientId": "R", "replicator": True,
                          "nodes": [{"gen": 3, "node": node_v("1"), "pods": []}]})
    seen += [service.infos["n0"].node.meta.labels["v"], "n0" in service.sessions["R"].sent_gens]
    service.apply_deltas({"clientId": "A", "nodes": [{"gen": 6, "node": node_v("2"), "pods": []}]})
    service.apply_deltas({"clientId": "R", "replicator": True, "nodes": [], "removed": ["n0"]})
    seen.append("n0" in service.infos)
    service.apply_deltas({"clientId": "R", "replicator": True,
                          "nodes": [{"gen": 7, "node": node_v("3"), "pods": []}]})
    seen.append(service.infos["n0"].node.meta.labels["v"])
    service.apply_deltas({"clientId": "R", "replicator": True, "nodes": [], "removed": ["n0"]})
    seen.append("n0" in service.infos)
    return seen


def test_replicator_entries_never_regress_direct_client_rows():
    got, want = _replicator_script("port"), _replicator_script("jax")
    assert got == want == ["2", False, True, "3", False]


# ------------------------------------------------------------------ across packages


def _mixed_workload(api, store):
    """The seeded heterogeneous cluster and pods of the main path (taints,
    affinity, ports, images, failures), then spread pods."""
    for ni in build_nodes(api, cluster_spec(12, seed=5)):
        store.create_node(ni.node)
        for pod in ni.pods:
            store.create_pod(pod)
    for pod in build_pods(api, pods_spec(24, seed=11)):
        store.create_pod(pod)


@pytest.mark.parametrize("client", ["jax", "port"])
def test_client_against_the_other_service(client):
    """The JAX client against the port's service, and the port's client
    against JAX's: the same placements and verdicts as the same-package
    run (synchronous: the JAX service runs pipelined batches in no fixed
    order, C26)."""
    side = ("jax", "port").index(client)
    states = {}
    for services in (("jax", "port"), ("port", "jax")):
        with WirePair(services=services) as pair:
            pair.build(_mixed_workload)
            pair.settle()
            states[services] = pair.state(side)
    same, crossed = states[("jax", "port")], states[("port", "jax")]
    skip = {"service_batches", "service_replays", "service_conflicts"}
    for key in same:
        if key not in skip:
            assert crossed[key] == same[key], key
    assert same["metrics"]["scheduled"] > 0 and same["metrics"]["unschedulable"] > 0


@pytest.mark.parametrize("depth", DEPTHS)
def test_mixed_workload_equals_jax(depth):
    with WirePair(depth=depth) as pair:
        pair.build(_mixed_workload)
        pair.settle()
        pair.assert_equal()
        pair.advance(11.0)
        pair.settle()
        state = pair.assert_equal()
    assert state["metrics"]["unschedulable"] > 0


# ------------------------------------------------------------------ no fallback


def test_service_on_the_card_by_default():
    """``device=None`` is the card: without CUDA it raises, never runs the
    plain versions."""
    from kubernetes_tpu_torch.backend.service import DeviceService

    if torch.cuda.is_available():
        assert DeviceService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceService()


def _failing_batch(monkeypatch, target):
    """A service whose ``target`` (the preemption screen or the batch
    program's dispatch) raises, driven with one pod that cannot fit."""
    from kubernetes_tpu_torch.backend import service as svc

    def boom(*args, **kwargs):
        raise RuntimeError(f"{target} failed on the card")

    monkeypatch.setattr(svc, target, boom)
    api = torch_api()
    service = svc.DeviceService(batch_size=8, device="cpu")
    node = api.make_node("n0").capacity({"cpu": "1", "memory": "1Gi", "pods": 10}).obj()
    service.apply_deltas({"clientId": "A", "nodes": [{"gen": 1, "node": svc.to_wire(node),
                                                      "pods": []}]})
    pod = svc.to_wire(api.make_pod("big").req({"cpu": "2"}).obj())
    return svc, service, {"clientId": "A", "pods": [pod], "batchId": "b-1"}


@pytest.mark.parametrize("target", ["screen_prefix", "dispatch_device_batch"])
def test_device_failure_is_raised_not_swallowed(monkeypatch, target):
    """A failure of the preemption screen (which JAX swallows, dropping
    the hints) or of the batch program raises out of ``schedule_batch``,
    reaches the client as a 500 mapped to ``PermanentDeviceError``, and
    caches no reply."""
    from kubernetes_tpu_torch.backend.errors import PermanentDeviceError

    svc, service, req = _failing_batch(monkeypatch, target)
    with pytest.raises(RuntimeError, match="failed on the card"):
        service.schedule_batch(req)
    assert service.sessions["A"].last_batches == {}
    server, port = svc.serve(service)
    try:
        client = svc.WireClient(f"http://127.0.0.1:{port}", read_timeout=READ_TIMEOUT)
        with pytest.raises(PermanentDeviceError, match="failed on the card"):
            client.schedule_batch(req)
    finally:
        svc.stop(server)


@pytest.mark.parametrize("target", ["screen_prefix", "dispatch_device_batch"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_wire_scheduler_raises_a_device_failure(monkeypatch, depth, target):
    """A service failure on the card reaches the port's ``WireScheduler``
    as a ``PermanentDeviceError`` and is raised out of its cycle, as the
    loop raises it: the breaker counts nothing, no pod takes the host's
    sequential path, and the pod waits in the queue."""
    from kubernetes_tpu_torch.backend import service as svc
    from kubernetes_tpu_torch.backend.errors import PermanentDeviceError

    def boom(*args, **kwargs):
        raise RuntimeError(f"{target} failed on the card")

    monkeypatch.setattr(svc, target, boom)
    with WirePair(depth=depth) as pair:
        api, store, sched = pair.apis[1], pair.stores[1], pair.scheds[1]
        store.create_node(api.make_node("n0").capacity(
            {"cpu": "1", "memory": "1Gi", "pods": 10}).obj())
        store.create_pod(api.make_pod("big").req({"cpu": "2"}).obj())
        with pytest.raises(PermanentDeviceError, match="failed on the card"):
            sched.run_until_settled()
        assert sched.degraded_pods == 0 and sched.breaker.state == "closed"
        assert sched.breaker.consecutive_failures == 0 and sched.breaker.last_error == ""
        assert sched.metrics["errors"] == 1 and sched.metrics["scheduled"] == 0
        assert [qp.pod.key() for qp in sched.queue.pending_pod_infos()] == ["default/big"]
        assert store.get_pod("default/big").spec.node_name == ""


def test_unported_branches_raise():
    """The two branches the port once refused now build as in JAX: one
    endpoint keeps the plain WireClient, a list or a comma-separated string
    builds the device fabric; what stays refused is malformed: an unknown
    transport, a fault_plan list that does not match the endpoints, no
    endpoint."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.fabric import DeviceFabric
    from kubernetes_tpu_torch.backend.service import WireClient, WireScheduler
    from kubernetes_tpu_torch.testing.faults import FaultPlan

    one = WireScheduler(Store(), endpoint="http://127.0.0.1:1")
    assert isinstance(one.client, WireClient)
    assert one.debug_fabric() == {"enabled": False, "endpoint": "http://127.0.0.1:1"}
    eps = ["http://127.0.0.1:1", "http://127.0.0.1:2"]
    for endpoint in (" , ".join(eps), eps):
        sched = WireScheduler(Store(), endpoint=endpoint)
        assert isinstance(sched.client, DeviceFabric)
        assert [r.endpoint for r in sched.client.replicas] == eps
        assert sched.debug_fabric()["enabled"] is True
        sched.close()
    with pytest.raises(ValueError, match="transport"):
        WireScheduler(Store(), endpoint="127.0.0.1:1", transport="quic")
    with pytest.raises(ValueError, match="fault_plan"):
        WireScheduler(Store(), endpoint=eps, fault_plan=[FaultPlan()])
    with pytest.raises(ValueError, match="endpoint"):
        WireScheduler(Store(), endpoint=" , ")


def test_replay_runs_no_program(monkeypatch):
    """A batch replayed by batchId returns the stored reply and dispatches
    nothing: the batch program's calls are counted."""
    from kubernetes_tpu_torch.backend import service as svc

    calls = []
    real = svc.dispatch_device_batch
    monkeypatch.setattr(svc, "dispatch_device_batch",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    api = torch_api()
    service = svc.DeviceService(batch_size=8, device="cpu")
    node = api.make_node("n0").capacity({"cpu": "4", "memory": "8Gi", "pods": 10}).obj()
    service.apply_deltas({"clientId": "A", "nodes": [{"gen": 1, "node": svc.to_wire(node),
                                                      "pods": []}]})
    req = {"clientId": "A", "batchId": "b-1",
           "pods": [svc.to_wire(api.make_pod("p").req({"cpu": "1"}).obj())]}
    first = service.schedule_batch(req)
    again = service.schedule_batch(req)
    assert again is first and first["results"][0]["nodeName"] == "n0"
    assert calls == [1] and service.batch_counter == 1 and service.batch_replays == 1
    assert np.array_equal(service.state.nt.requested.numpy()[0],
                          service.state._mirror["requested"][0])


def _preemption_workload(api, store):
    for i in range(4):
        store.create_node(api.make_node(f"n{i}").capacity(
            {"cpu": "2", "memory": "8Gi", "pods": 10}).obj())
    for i in range(8):
        store.create_pod(api.make_pod(f"victim-{i}").req({"cpu": "900m"}).priority(1).obj())


def _preemptors(api, store):
    for i in range(4):
        store.create_pod(api.make_pod(f"preemptor-{i}").req({"cpu": "1500m"}).priority(100)
                         .obj())


@pytest.mark.parametrize("depth", DEPTHS)
def test_preemption_hints_equal_jax(depth):
    """Preemptors fail on the service; the screen's hints ride back with
    their results; PostFilter nominates and evicts the same victims in
    both packages, and the preemptors bind after their backoff."""
    with WirePair(depth=depth) as pair:
        pair.build(_preemption_workload)
        pair.settle()
        pair.build(_preemptors)
        pair.settle()
        state = pair.assert_equal()
        assert state["nominated"] and state["metrics"]["unschedulable"] == 4
        assert len(state["placed"]) < 12  # victims deleted, the same in both (placed)
        for _ in range(3):
            pair.advance(2.0)
            pair.settle()
        state = pair.assert_equal()
    assert all(state["placed"][f"default/preemptor-{i}"] for i in range(4))


def test_concurrent_clients_never_double_book():
    """Twelve client threads (more than the cores) race scheduleBatch for
    the same twelve pods on one port service with a short switch
    interval: each pod is held by one client only, every other client gets
    a conflict verdict for it, and no node holds more than it has."""
    import sys
    import threading

    from kubernetes_tpu_torch.backend import service as svc

    api = torch_api()
    service = svc.DeviceService(batch_size=16, device="cpu")
    nodes = [{"gen": 1, "node": svc.to_wire(api.make_node(f"n{i}").capacity(
        {"cpu": "64", "memory": "8Gi", "pods": 110}).obj()), "pods": []} for i in range(4)]
    pods = [svc.to_wire(api.make_pod(f"p{i}").req({"cpu": "1"}).obj()) for i in range(12)]
    clients = [f"c{j}" for j in range(12)]
    for cid in clients:
        service.apply_deltas({"clientId": cid, "nodes": nodes})
    errors, verdicts = [], []

    def race(cid):
        try:
            out = service.schedule_batch({"clientId": cid, "batchId": f"{cid}-1", "pods": pods})
            verdicts.append(out["results"])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=race, args=(cid,)) for cid in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and len(verdicts) == len(clients)
    placed = [r["nodeName"] for results in verdicts for r in results if r.get("nodeName")]
    conflicts = sum(1 for results in verdicts for r in results if r.get("conflict"))
    assert len(placed) == len(service.holds) == 12
    assert conflicts == service.commit_conflicts == 12 * 11
    for name, ni in service.infos.items():
        assert ni.requested.milli_cpu <= ni.allocatable.milli_cpu, name


@pytest.mark.parametrize("ownership", ["checked", "unchecked"])
def test_two_replicas_bind_each_pod_once(monkeypatch, ownership):
    """Two port replicas on one port service, their pipelined batches
    racing for the same pods (``run_loop_wire(replicas=2)``): with the
    service's ownership check every loser gets a conflict verdict, so each
    pod gets one placement and one bind, and no bind reaches a bound pod;
    without it (the check patched out) both replicas get placements for
    the same pods, and the count of placements passes the binds."""
    from kubernetes_tpu_torch.backend import service as svc
    from kubernetes_tpu_torch.perf import workloads

    if ownership == "unchecked":
        monkeypatch.setattr(svc.DeviceService, "_validate_placements",
                            lambda self, *args, **kwargs: {})
    w = workloads.scheduling_basic(100, 64, 128)
    two = workloads.run_loop_wire(w, "cpu", 3, batch_size=32, percentage=100, replicas=2)
    assert len(two["placed"]) == 192 and all(two["placed"].values())
    assert not two["settle_abandoned"] and two["degraded_pods"] == 0
    assert two["double_binds"] == [] and two["binds"] == 192
    if ownership == "checked":
        assert two["placements"] == 192 and two["over_capacity"] == []
        assert two["conflicts"] == two["service_conflicts"] > 0
    else:
        assert two["placements"] > 192 and two["service_conflicts"] == 0


# ------------------------------------------------------------------ C28: the wire against the loop

# the smallest seeded PreemptionBasic (workloads.preemption_basic) at which
# the port's wire and the port's loop place pods differently: one more
# preemptor than the batch of 128 (below 128 measured pods, none differ)
C28_CASE = dict(nodes=8, init_pods=32, measured=130)


def _c28_drive(sides, settle, nodes, phases):
    """Nodes, then each phase's pods, into every (store, is_port) side,
    settling after each phase; the port's objects rebuilt for JAX."""
    for store, port in sides:
        for node in nodes:
            store.create_node(node if port else to_jax(node))
    for pods in phases:
        for store, port in sides:
            for pod in pods:
                store.create_pod(pod if port else to_jax(pod))
        settle()


@pytest.mark.parametrize("ring", ["depth2", "depth0"])
def test_c28_jax_wire_against_jax_loop(ring, monkeypatch):
    """ROADMAP C28: at PreemptionBasic's size the wire (depth 0) and the
    loop place pods differently. Both packages' wires and both loops run
    one seeded case in this process (C14): the port's wire equals JAX's
    wire, the port's loop equals JAX's loop, and JAX's wire and loop differ
    on exactly the pods where the port's do. The cause is the loop's
    in-flight ring (``KTPU_PIPELINE_DEPTH``, default 2): it pops the next
    batch (the last two preemptors) before the 128-pod batch's PostFilter
    has moved that batch's failed pods back, while the wire at depth 0
    lands each batch first and pops them together. With the ring at depth
    0 the loop equals the wire in both packages."""
    from _torch_cases import LoopPair
    from kubernetes_tpu_torch.perf import workloads

    if ring == "depth0":
        monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    else:
        monkeypatch.delenv("KTPU_PIPELINE_DEPTH", raising=False)
    monkeypatch.delenv("KTPU_COMMIT_WORKER", raising=False)
    w = workloads.preemption_basic(**C28_CASE)
    nodes = [ni.node for ni in w.node_infos()]
    phases = (w.init_pod_list(), w.warm_pod_list(), w.measured_pod_list())
    with WirePair(batch=128, service_batch=128, percentage=100) as wire:
        _c28_drive(((wire.stores[0], False), (wire.stores[1], True)), wire.settle, nodes, phases)
        jwire, twire = wire.state(0), wire.state(1)
    loop = LoopPair(batch=128, percentage=100)
    try:
        _c28_drive(((loop.jstore, False), (loop.tstore, True)), loop.settle, nodes, phases)
        jloop, tloop = loop.state(0), loop.state(1)
    finally:
        loop.tsched.close()
    for key in ("placed", "nominated"):
        assert twire[key] == jwire[key], key
        assert tloop[key] == jloop[key], key

    def moved(a, b):
        return sorted(k for k in a["placed"] if a["placed"][k] != b["placed"][k])

    jax_moved, port_moved = moved(jwire, jloop), moved(twire, tloop)
    assert port_moved == jax_moved
    assert jwire["nominated"] == jloop["nominated"]
    if ring == "depth2":
        assert port_moved, "the case no longer shows C28"
        assert all("/preemptor-" in k for k in port_moved)
    else:
        assert port_moved == []
