"""Namespace quota through the port's scheduler loop
(``kubernetes_tpu_torch.backend.tpu_scheduler.TPUScheduler``,
``device="cpu"``) against the real JAX ``TPUScheduler`` under
``JAX_PLATFORMS=cpu``, with exact equality (``LoopPair.gang_state``:
placements, the pods popped per batch, the queue's contents with its gated
pods, the pods parked at Permit, the PodGroups and the gang and quota
metrics), at ring depth 0, at depth 2, and at depth 2 with the commit
worker on both sides, its commits landed at the end of each cycle so that
the next pop does not race them.

The scenarios are the JAX loop tests' (tests/test_quota.py:557-590) and
more: the host gate at pop and the device screen's flags; the PreEnqueue
gate and the release move on a delete; deficit round robin over three
weighted tenants; the cohort reclaim pass evicting the newest loan; C12,
a cohort borrower's gang member refused at Reserve while its siblings
wait at Permit until the timeout; and a small SchedulingSoak (60 nodes, 4
rounds; with a cohort and without gangs) through ``workloads.soak_rounds``
on both loops, with zero oversubscription at every check. And the loop's
reclaim pass on SchedulingSoak against the JAX measurement that decided
to port it. And C12 with the worker's commits not landed between cycles,
on the port alone: outcomes that do not follow thread timing."""

import pytest

from _torch_cases import LoopPair, jax_api, to_jax, torch_api

# (KTPU_PIPELINE_DEPTH, KTPU_COMMIT_WORKER); with the worker, its commits
# land at the end of each cycle (``LoopPair.land_worker_each_cycle``)
MODES = [("0", "0"), ("2", "0"), ("2", "1")]


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
    assert (pair.tsched.commit_worker is None) == (pair.jsched.commit_worker is None)
    return pair


def _close(pair: LoopPair) -> None:
    for sched in (pair.jsched, pair.tsched):
        sched._drain_inflight()
        if sched.commit_worker is not None:
            sched.commit_worker.stop()


def _nodes(pair, n=4, cpu="8"):
    def build(api):
        return [api.make_node(f"node-{i}").capacity({"cpu": cpu, "memory": "32Gi", "pods": 32})
                .label("kubernetes.io/hostname", f"node-{i}").obj() for i in range(n)]

    for jn, tn in zip(build(jax_api()), build(torch_api())):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)


def _pods(pair, prefix, n, ns="default", cpu="100m", group=None):
    def build(api):
        out = []
        for i in range(n):
            pw = api.make_pod(f"{prefix}-{i}", namespace=ns).req({"cpu": cpu})
            if group:
                pw.pod_group(group)
            out.append(pw.obj())
        return out

    pair.add_pods(build(jax_api()), build(torch_api()))


def _bound(state, ns):
    return sorted(k for k, n in state["placed"].items() if n and k.startswith(f"{ns}/"))


def test_gate_at_pop_and_device_screen(mode):
    """tests/test_quota.py:557: five pods under a two-pod quota in one
    batch: the gate admits all five (nothing is charged yet), the device
    screen flags the winners past the cap, Reserve charges two, and the
    rest park behind the gate."""
    pair = _pair()
    _nodes(pair)
    pair.add_quota("team-a", {"pods": 2})
    _pods(pair, "p", 5, ns="team-a")
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert len(_bound(got, "team-a")) == 2
    assert got["pending"]["gated"] + got["pending"]["unschedulable"] == 3
    assert pair.tsched.quota_flagged == 3
    assert pair.tsched._quota_plugin().usage("team-a")["pods"] == 2


def test_gate_and_release_move_on_delete(mode):
    """tests/test_quota.py:579: a one-pod quota binds one pod and gates
    the other; deleting the bound one releases the charge, and the
    targeted move admits the gated pod, which binds."""
    pair = _pair()
    _nodes(pair)
    pair.add_quota("team-a", {"pods": 1})
    _pods(pair, "p", 1, ns="team-a")
    pair.settle()
    _pods(pair, "q", 1, ns="team-a")
    pair.settle()
    got = pair.assert_gang_equal()
    assert got["pending"]["gated"] == 1 and len(_bound(got, "team-a")) == 1
    pair.delete_pod(_bound(got, "team-a")[0])
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert _bound(got, "team-a") == ["team-a/q-0"] and got["pending"]["gated"] == 0


def test_drr_across_weighted_tenants(mode):
    """Three tenants of weights 4, 2 and 1 flood the queue; batches of
    four pop them in deficit round robin, in the JAX queue's order."""
    pair = _pair(batch=4)
    _nodes(pair, 8)
    for ns, w in (("t-a", 4), ("t-b", 2), ("t-c", 1)):
        pair.add_quota(ns, {"pods": 100}, weight=w)
    for ns in ("t-c", "t-b", "t-a"):
        _pods(pair, "p", 12, ns=ns)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert sum(len(b) for b in got["popped"]) == 36
    order = [k.split("/")[0] for b in got["popped"] for k in b]
    # the rotation, not the arrival order (t-c came first): t-a's turn of
    # 4 x 4 credit drains it, then t-b's and t-c's turns alternate
    assert order[:12] == ["t-a"] * 12 and order[12:20] == ["t-b"] * 8
    assert order[20:24] == ["t-c"] * 4


def test_reclaim_evicts_the_newest_loan(mode):
    """A borrower fills the pool with loans; a lender's pod fits its own
    quota but not the pool: it records reclaim demand and parks. At the
    next 1 s sweep the reclaim pass evicts the newest loan (deleted and
    created again unbound), and the lender's pod binds."""
    pair = _pair()
    _nodes(pair)
    pair.add_quota("lend", {"pods": 2}, cohort="pool")
    pair.add_quota("borrow", {"pods": 1}, cohort="pool")
    _pods(pair, "b", 3, ns="borrow")
    pair.settle()
    got = pair.assert_gang_equal()
    assert len(_bound(got, "borrow")) == 3
    _pods(pair, "l", 1, ns="lend")
    pair.settle()
    got = pair.assert_gang_equal()
    assert _bound(got, "lend") == []
    pair.advance(1.5)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert _bound(got, "lend") == ["lend/l-0"] and len(_bound(got, "borrow")) == 2
    assert pair.tsched.smetrics.evicted_pods.labels("quota_reclaim") == 1
    assert (pair.tsched._quota_plugin().reclaims_executed
            == pair.jsched._quota_plugin().reclaims_executed == 1)


def test_c12_member_refused_at_reserve_siblings_time_out(mode):
    """C12 (ROADMAP): a cohort borrower's gang of four passes the gate (its
    whole remaining gang priced against the pool), but the lender's pods
    ahead of it in the batch (their tenant first in the fair-share
    rotation) charge the pool first, so at Reserve its
    largest member no longer fits. As in the JAX loop: that member fails
    (its Unreserve arms nothing), its three siblings pass Reserve and wait
    at Permit, and the sweep rejects them at the PodGroup's timeout."""
    pair = _pair()
    _nodes(pair, 4, cpu="16")
    pair.add_quota("a-lend", {"requests.cpu": 3000}, cohort="pool")
    pair.add_quota("b-borrow", {"requests.cpu": 1000}, cohort="pool")
    _pods(pair, "l", 3, ns="a-lend", cpu="1000m")
    pair.add_pod_group("g", 4, ns="b-borrow", timeout_s=2)

    def gang(api):
        return [api.make_pod(f"g-{i}", namespace="b-borrow")
                .req({"cpu": "1000m" if i == 3 else "100m"}).pod_group("g").obj()
                for i in range(4)]

    pair.add_pods(gang(jax_api()), gang(torch_api()))
    pair.settle()
    got = pair.assert_gang_equal()
    if mode[0] == "0":
        assert got["waiting"] == ["b-borrow/g-0", "b-borrow/g-1", "b-borrow/g-2"]
        assert got["gangs_rejected"] == {}
    pair.advance(3.0)
    pair.settle()
    got = pair.assert_gang_equal()
    _close(pair)
    assert got["waiting"] == [] and _bound(got, "b-borrow") == []
    assert got["gangs_rejected"].get(("timeout",), 0) >= 1
    assert len(_bound(got, "a-lend")) == 3


@pytest.mark.parametrize("step", [0.5, 3.0])
def test_c12_with_unlanded_worker(step, monkeypatch):
    """C12's cluster at depth 2 with the commit worker on and nothing
    landing its commits between cycles, behind a flood of unquota'd pods
    so that the borrower's gang commits on the worker while later batches
    pop; the clock moves ``step`` per cycle. Whatever the timing: the gang
    ends whole and Running or unbound, nothing waits at Permit, no assume
    stays open, the cache holds what the store binds, the ledger is never
    over a cap at a settled point, and the lender's three pods bind."""
    from kubernetes_tpu_torch.perf import workloads

    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "2")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "1")
    pair = LoopPair(batch=4)
    assert pair.tsched.commit_worker is not None
    _nodes(pair, 4, cpu="16")
    pair.add_quota("a-lend", {"requests.cpu": 3000}, cohort="pool")
    pair.add_quota("b-borrow", {"requests.cpu": 1000}, cohort="pool")
    _pods(pair, "f", 8)
    _pods(pair, "l", 3, ns="a-lend", cpu="1000m")
    pair.add_pod_group("g", 4, ns="b-borrow", timeout_s=2)

    def gang(api):
        return [api.make_pod(f"g-{i}", namespace="b-borrow")
                .req({"cpu": "1000m" if i == 3 else "100m"}).pod_group("g").obj()
                for i in range(4)]

    pair.add_pods(gang(jax_api()), gang(torch_api()))
    pair.drive_port_unlanded(8, step)
    quota = pair.tsched._quota_plugin()
    for advance in (0.0, 3.0, 10.0):
        pair.tclock.advance(advance)
        pair.tsched.queue.flush_backoff_completed()
        pair.cycles[1] += pair.tsched.run_until_settled()
        got = pair.assert_port_consistent()
        assert workloads.quota_oversubscription(quota, ["a-lend", "b-borrow"]) == 0
        borrowed = _bound(got, "b-borrow")
        assert len(borrowed) in (0, 4)
        if borrowed:
            assert got["pod_groups"]["b-borrow/g"] == ("Running", 4)
    _close(pair)
    assert len(_bound(got, "a-lend")) == 3 and len(_bound(got, "default")) == 8


@pytest.mark.parametrize("variant", ["plain", "cohort", "nogangs"])
def test_small_soak_matches_jax(variant, mode):
    """SchedulingSoak at 60 nodes, scale 4, 4 rounds (without its claim
    pods) through ``workloads.soak_rounds`` on both loops: equal binds,
    pops, queues and ledgers, and zero oversubscription at every check."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_soak(nodes=60, scale=4, rounds=4, claims=False,
                                  cohort="soak" if variant == "cohort" else "",
                                  gangs=variant != "nogangs")
    pair = _pair(batch=32)
    for ni in w.node_infos():
        pair.jstore.create_node(to_jax(ni.node))
        pair.tstore.create_node(ni.node)
    for q in w.quotas():
        pair.add_quota(q.meta.namespace, q.hard, weight=q.weight, cohort=q.cohort)
    jout = workloads.soak_rounds(w, pair.jstore, pair.jsched, pair.jsched._quota_plugin(),
                                 pair.jclock, convert=to_jax)
    tout = workloads.soak_rounds(w, pair.tstore, pair.tsched, pair.tsched._quota_plugin(),
                                 pair.tclock)
    got = pair.assert_gang_equal()
    _close(pair)
    assert tout == jout
    assert tout["oversubscription"] == 0 and tout["checks"] > 4
    assert sum(tout["bound"].values()) > 0
    if variant == "nogangs":
        assert set(pair.tsched.batch_modes) == {"off"}
        assert set(pair.tsched.batch_paths) == {"fused"}
    assert got["waiting"] == []
