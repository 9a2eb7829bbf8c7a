"""DRA claims through the port's scheduler loop (``TPUScheduler``,
``device="cpu"``) against the real JAX ``TPUScheduler`` under
``JAX_PLATFORMS=cpu``, exactly (``LoopPair.volume_state``): placements,
the pods popped per batch, the queue, the counters, every claim's
allocated node and reserved-for pods, the PodSchedulingContexts PostBind
writes, and the pods the sequential path bound. Each case runs at ring
depth 0, at depth 2, and at depth 2 with the commit worker on both sides,
its commits landed at the end of each cycle.

The cases: claim pods whose class and claim selectors admit a subset of
the nodes (the claim mask in the batch program, Reserve's allocation,
PostBind), one pod nothing admits, and plain pods beside them; pods
sharing one claim (after the first allocation the others are pinned to
its node, and a pod that lands elsewhere in the same batch is refused at
Reserve); a pod whose claim is missing at pop (the sequential path, which
parks it until the claim's event) and a pod whose class is missing; and a
claim deleted after its batch was encoded, found by the commit's PreFilter,
which hands the pod to the sequential path."""

import pytest

from _torch_cases import LoopPair

MODES = [("0", "0"), ("2", "0"), ("2", "1")]
CLASS = "tpu.example.com"


@pytest.fixture(params=MODES, ids=["depth0", "depth2", "depth2-worker"])
def mode(request, monkeypatch):
    depth, worker = request.param
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)
    return request.param


def _pair(n_nodes: int = 24) -> LoopPair:
    """``n_nodes`` nodes publishing SchedulingDRA's device attributes, and
    the claim class."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceClass
    from kubernetes_tpu_torch.api.wrappers import make_node

    pair = LoopPair(batch=16)
    pair.land_worker_each_cycle()
    for i in range(n_nodes):
        pair.create("create_node", make_node(f"node-{i}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": 16}).label(
            "topology.kubernetes.io/zone", f"zone-{i % 3}").device_attrs(
            {"tpu.dev/cores": (8, 16)[i % 2], "tpu.dev/gen": ("v5", "v5", "v4")[i % 3]}).obj())
    pair.create("create_object", ResourceClass(
        meta=ObjectMeta(name=CLASS, namespace=""), driver_name=CLASS,
        selectors={"tpu.dev/gen": "v5"}), kind="ResourceClass")
    return pair


def _claim(pair: LoopPair, name: str, selectors=None) -> None:
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceClaim

    pair.create("create_object", ResourceClaim(
        meta=ObjectMeta(name=name), resource_class_name=CLASS,
        selectors=dict(selectors or {"tpu.dev/cores": ">=8"})), kind="ResourceClaim")


def _pod(name: str, claim: str = "", template: bool = True, cpu: str = "500m"):
    from kubernetes_tpu_torch.api.wrappers import make_pod

    pw = make_pod(name).req({"cpu": cpu, "memory": "1Gi"})
    if claim:
        if template:
            pw.resource_claim(claim, template_name="tpu")
        else:
            pw.resource_claim("accel", claim_name=claim)
    return pw.obj()


def _close(pair: LoopPair) -> None:
    for sched in (pair.jsched, pair.tsched):
        sched._drain_inflight()
        if sched.commit_worker is not None:
            sched.commit_worker.stop()


def _bound(state, prefix):
    return {k: n for k, n in state["placed"].items() if n and k.startswith(f"default/{prefix}")}


def test_claim_pods(mode):
    """40 claim pods (cores >= 8 on v5 nodes; every fourth needs 16 cores)
    and 10 plain pods: each claim pod lands on a node its selectors admit
    and its claim is allocated there and reserved for it; a pod whose claim
    no node satisfies fails with DynamicResources."""
    pair = _pair()
    pods = []
    for i in range(40):
        _claim(pair, f"dra-{i}-accel",
               {"tpu.dev/cores": ">=16"} if i % 4 == 3 else None)
        pods.append(_pod(f"dra-{i}", "accel"))
        if i % 4 == 0:
            pods.append(_pod(f"plain-{i}"))
    _claim(pair, "nowhere-accel", {"tpu.dev/cores": ">=64"})
    pods.append(_pod("nowhere", "accel"))
    pair.create("create_pod", *pods)
    pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    assert len(_bound(got, "dra-")) == 40 and len(_bound(got, "plain-")) == 10
    nodes = {n.meta.name: n for n in pair.tstore.nodes.values()}
    for i in range(40):
        node = nodes[got["placed"][f"default/dra-{i}"]]
        attrs = node.status.device_attributes
        assert attrs["tpu.dev/gen"] == "v5" and attrs["tpu.dev/cores"] >= (16 if i % 4 == 3 else 8)
        assert got["claims"][f"default/dra-{i}-accel"] == (node.meta.name, (f"default/dra-{i}",))
        assert got["contexts"][f"default/dra-{i}"] == node.meta.name
    assert not got["placed"]["default/nowhere"]
    assert ("default/nowhere", 1, ("DynamicResources",)) in got["queued"]
    assert got["fallback_scheduled"] == 0


def test_shared_claim(mode):
    """Six pods share one claim: the first Reserve allocates it to its
    node, a sibling the batch placed elsewhere is refused at Reserve, and
    on its retry the claim mask pins it to the claim's node."""
    pair = _pair()
    _claim(pair, "shared")
    pair.create("create_pod", *[_pod(f"share-{i}", "shared", template=False, cpu="200m")
                                for i in range(6)])
    pair.settle()
    pair.advance(11.0)
    pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    node, users = got["claims"]["default/shared"]
    bound = _bound(got, "share-")
    assert set(bound.values()) == {node} and sorted(users) == sorted(bound)


def test_missing_claim_and_class(mode):
    """A pod whose claim is missing and a pod whose claim's class is
    missing take the sequential path at pop, after the batch queued before
    them, and park (DynamicResources' PreFilter); the claim's event moves
    the first, which binds, on the sequential path or in a batch."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceClaim

    pair = _pair()
    pods = [_pod(f"before-{i}") for i in range(5)]
    pods += [_pod("late", "accel"), _pod("classless", "accel")]
    pods += [_pod(f"after-{i}") for i in range(5)]
    pair.create("create_object", ResourceClaim(
        meta=ObjectMeta(name="classless-accel"), resource_class_name="missing.example.com"),
        kind="ResourceClaim")
    pair.create("create_pod", *pods)
    pair.settle()
    got = pair.assert_volume_equal()
    assert not got["placed"]["default/late"] and not got["placed"]["default/classless"]
    assert len(_bound(got, "before-")) == 5 and len(_bound(got, "after-")) == 5
    assert ("default/late", 1, ("DynamicResources",)) in got["queued"]
    _claim(pair, "late-accel")
    pair.advance(2.0)
    pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    assert got["placed"]["default/late"]
    assert got["claims"]["default/late-accel"][0] == got["placed"]["default/late"]


def test_claim_vanishes_before_commit(mode):
    """A claim deleted after its pod's batch was encoded and before the
    batch commits: the commit's PreFilter finds it gone, the pod's row is
    surrendered and the sequential path parks the pod; the batch's other
    pods bind."""
    pair = _pair()
    for i in range(12):
        _claim(pair, f"dra-{i}-accel")
    pair.create("create_pod", *[_pod(f"dra-{i}", "accel") for i in range(12)])
    for sched, store in ((pair.jsched, pair.jstore), (pair.tsched, pair.tstore)):
        commit = sched._commit_batch

        def first_deletes(*args, _commit=commit, _store=store, _done=[], **kwargs):
            if not _done:
                _done.append(True)
                _store.delete_object("ResourceClaim", "default/dra-5-accel")
            return _commit(*args, **kwargs)

        sched._commit_batch = first_deletes
    pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    assert not got["placed"]["default/dra-5"]
    assert len(_bound(got, "dra-")) == 11
    assert ("default/dra-5", 1, ("DynamicResources",)) in got["queued"]
    assert "default/dra-5-accel" not in got["claims"]


@pytest.mark.parametrize("gangs", [True, False], ids=["soak", "nogangs"])
def test_small_soak_with_claims_matches_jax(gangs, mode):
    """SchedulingSoak at 60 nodes, scale 4, 4 rounds with soak-b's claim
    pods (each claim created just before its pod) through
    ``workloads.soak_rounds`` on both loops: equal binds, pops, queues,
    ledgers and claim allocations, zero oversubscription at every check;
    each bound claim pod's claim is allocated to its node."""
    from _torch_cases import to_jax
    from kubernetes_tpu_torch.perf import workloads

    # without the device flap: its requeues leave no claim pod bound at the
    # end of this small run (test_torch_loop_faults.py runs the flap with
    # claims)
    w = workloads.scheduling_soak(nodes=60, scale=4, rounds=4, gangs=gangs, flap=False)
    pair = LoopPair(batch=32)
    pair.land_worker_each_cycle()
    for ni in w.node_infos():
        pair.create("create_node", ni.node)
    for q in w.quotas():
        pair.add_quota(q.meta.namespace, q.hard, weight=q.weight, cohort=q.cohort)
    jout = workloads.soak_rounds(w, pair.jstore, pair.jsched, pair.jsched._quota_plugin(),
                                 pair.jclock, convert=to_jax)
    tout = workloads.soak_rounds(w, pair.tstore, pair.tsched, pair.tsched._quota_plugin(),
                                 pair.tclock)
    _close(pair)
    got = pair.assert_volume_equal()
    assert pair.assert_gang_equal()["waiting"] == []
    assert tout == jout
    assert tout["oversubscription"] == 0 and tout["bound"]["soak-b"] > 0
    # a churned pod's claim stays allocated (no claim controller runs)
    live = {k: v for k, v in got["claims"].items() if v[0] and v[1][0] in got["placed"]}
    assert live and all(got["placed"][v[1][0]] == v[0] for v in live.values())
