"""PersistentVolumeClaims and generic ephemeral volumes through the port's
scheduler loop (``TPUScheduler``, ``device="cpu"``) against the real JAX
``TPUScheduler`` under ``JAX_PLATFORMS=cpu``, exactly
(``LoopPair.volume_state``): placements, the pods popped per batch, the
queue, the counters, every PV's claim and every PVC's volume, and the pods
the sequential path bound. Each case runs at ring depth 0, at depth 2, and
at depth 2 with the commit worker on both sides, its commits landed at the
end of each cycle.

The cases: pods with pre-bound PVs whose node affinity and zone labels
admit a subset of the nodes (the volume screen in the batch program, the
exact filters at commit); delayed (WaitForFirstConsumer) claims with fewer
zonal PVs than pods (VolumeBinding's Filter, Reserve and PreBind through
the store; a PV created later moves the pods that found none); a pod whose
PVC is missing and one whose immediate-mode PVC is unbound (the
sequential path at pop, which parks them); and pods with generic
ephemeral volumes only, which every plugin ignores as in the JAX package.

And C9 (``test_c9_*``): two pods of one batch that together would exceed
a node's CSI attach limit of 1, or share a ReadWriteOncePod claim. The
JAX loop's commit checks read a snapshot without the batch's earlier
winners, so it binds both; the port's see them, so it binds the first and
sends the second down the sequential path, which places it on the other
node (the limit) or parks it (the claim in use). Asserted on each package
alone, at depth 0 and 2."""

import pytest

from _torch_cases import LoopPair

MODES = [("0", "0"), ("2", "0"), ("2", "1")]
ZONE = "topology.kubernetes.io/zone"
DRIVER = "ebs.csi.aws.com"


@pytest.fixture(params=MODES, ids=["depth0", "depth2", "depth2-worker"])
def mode(request, monkeypatch):
    depth, worker = request.param
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)
    return request.param


def _pair(n_nodes: int = 24, cpu: str = "4") -> LoopPair:
    """``n_nodes`` nodes in three zones and four racks, and the storage
    classes: ``csi`` (immediate), ``wffc`` (WaitForFirstConsumer)."""
    from kubernetes_tpu_torch.api.types import (BINDING_WAIT_FOR_FIRST_CONSUMER, ObjectMeta,
                                                StorageClass)
    from kubernetes_tpu_torch.api.wrappers import make_node

    pair = LoopPair(batch=16)
    pair.land_worker_each_cycle()
    for i in range(n_nodes):
        pair.create("create_node", make_node(f"node-{i}").capacity(
            {"cpu": cpu, "memory": "16Gi", "pods": 16}).label(ZONE, f"zone-{i % 3}").label(
            "rack", f"r{i % 4}").obj())
    pair.create("create_storage_class",
                StorageClass(meta=ObjectMeta(name="csi", namespace=""), provisioner=DRIVER),
                StorageClass(meta=ObjectMeta(name="wffc", namespace=""), provisioner=DRIVER,
                             volume_binding_mode=BINDING_WAIT_FOR_FIRST_CONSUMER))
    return pair


def _pv(name: str, claim: str = "", sc: str = "", rack=None, zone=None, access=None,
        size: int = 1 << 30):
    from kubernetes_tpu_torch.api.types import ROX, ObjectMeta, PersistentVolume

    return PersistentVolume(
        meta=ObjectMeta(name=name, namespace="", labels={ZONE: zone} if zone else {}),
        capacity_bytes=size, storage_class=sc, bound_pvc=f"default/{claim}" if claim else "",
        access_modes=access or (ROX,), node_affinity={"rack": tuple(rack)} if rack else {})


def _pvc(name: str, pv: str = "", sc: str = "", access=None):
    from kubernetes_tpu_torch.api.types import ROX, ObjectMeta, PersistentVolumeClaim

    return PersistentVolumeClaim(meta=ObjectMeta(name=name), storage_class=sc, bound_pv=pv,
                                 access_modes=access or (ROX,), requested_bytes=1 << 30)


def _pod(name: str, *pvcs: str, cpu: str = "500m", ephemeral=()):
    from kubernetes_tpu_torch.api.wrappers import make_pod

    pw = make_pod(name).req({"cpu": cpu, "memory": "1Gi"})
    for c in pvcs:
        pw.pvc(c)
    pod = pw.obj()
    pod.spec.ephemeral_claims = tuple(ephemeral)
    return pod


def _close(pair: LoopPair) -> None:
    for sched in (pair.jsched, pair.tsched):
        sched._drain_inflight()
        if sched.commit_worker is not None:
            sched.commit_worker.stop()


def _bound(state, prefix):
    return {k: n for k, n in state["placed"].items() if n and k.startswith(f"default/{prefix}")}


def test_bound_pvcs(mode):
    """40 pods, each with a pre-bound PV: a third pinned to racks r1/r2, a
    third to zone-0 by the zone label, the rest anywhere; every pod lands
    where its PV admits it, all in batches."""
    pair = _pair()
    pods = []
    for i in range(40):
        kind = i % 3
        pair.create("create_pv", _pv(f"pv-{i}", f"pvc-{i}", rack=("r1", "r2") if kind == 0
                                     else None, zone="zone-0" if kind == 1 else None))
        pair.create("create_pvc", _pvc(f"pvc-{i}", f"pv-{i}"))
        pods.append(_pod(f"vol-{i}", f"pvc-{i}"))
    pair.create("create_pod", *pods)
    pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    assert len(_bound(got, "vol-")) == 40 and got["fallback_scheduled"] == 0
    for i in range(0, 40, 3):
        assert int(got["placed"][f"default/vol-{i}"].split("-")[1]) % 4 in (1, 2)
    for i in range(1, 40, 3):
        assert int(got["placed"][f"default/vol-{i}"].split("-")[1]) % 3 == 0


def test_delayed_pvcs(mode):
    """Twelve pods each with an unbound WaitForFirstConsumer PVC and eight
    free PVs pinned to racks: VolumeBinding's Filter picks a PV per node,
    Reserve assumes it and PreBind binds it through the store; pods of one
    batch on one rack choose the same smallest PV, and all but the first
    are refused at PreBind (the Filter does not see another pod's assumed
    PVs, as in the JAX plugin) and retried after their backoff; the pods
    left without a PV park on VolumeBinding until two more PVs are
    created, whose events move them."""
    pair = _pair()
    for j in range(8):
        pair.create("create_pv", _pv(f"free-{j}", sc="wffc", rack=(f"r{j % 4}",),
                                     size=(1 << 30) + j))
    pods = []
    for i in range(12):
        pair.create("create_pvc", _pvc(f"late-{i}", sc="wffc"))
        pods.append(_pod(f"late-{i}", f"late-{i}"))
    pair.create("create_pod", *pods)
    pair.settle()
    got = pair.assert_volume_equal()
    assert len(_bound(got, "late-")) == 4 and got["pending"]["backoff"] == 8
    for _ in range(4):
        pair.advance(11.0)
        pair.settle()
    got = pair.assert_volume_equal()
    assert len(_bound(got, "late-")) == 8
    parked = [q for q in got["queued"] if q[0].startswith("default/late-")]
    assert len(parked) == 4 and all("VolumeBinding" in q[2] for q in parked)
    pair.create("create_pv", _pv("free-8", sc="wffc"), _pv("free-9", sc="wffc", rack=("r3",)))
    for _ in range(3):
        pair.advance(11.0)
        pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    assert len(_bound(got, "late-")) == 10
    racks = {f"free-{j}": f"r{j % 4}" for j in range(8)}
    for pv, claim in got["pv_bindings"].items():
        if not claim:
            continue
        node = got["placed"][claim]
        assert got["pvc_bindings"][claim] == pv
        if pv in racks:
            assert f"r{int(node.split('-')[1]) % 4}" == racks[pv]


def test_missing_and_immediate_unbound_pvcs(mode):
    """A pod whose PVC is missing and a pod whose immediate-mode PVC is
    unbound take the sequential path at pop, after the batch queued before
    them, and park (VolumeRestrictions, VolumeBinding); the missing PVC's
    creation (bound) moves its pod, which binds."""
    pair = _pair()
    pair.create("create_pvc", _pvc("unbound", sc="csi"))
    pods = [_pod(f"before-{i}") for i in range(5)]
    pods += [_pod("missing", "later"), _pod("immediate", "unbound")]
    pods += [_pod(f"after-{i}") for i in range(5)]
    pair.create("create_pod", *pods)
    pair.settle()
    got = pair.assert_volume_equal()
    assert not got["placed"]["default/missing"] and not got["placed"]["default/immediate"]
    assert len(_bound(got, "before-")) == 5 and len(_bound(got, "after-")) == 5
    assert ("default/missing", 1, ("VolumeRestrictions",)) in got["queued"]
    assert ("default/immediate", 1, ("VolumeBinding",)) in got["queued"]
    pair.create("create_pv", _pv("pv-later", "later", rack=("r3",)))
    pair.create("create_pvc", _pvc("later", "pv-later"))
    pair.advance(2.0)
    pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    assert int(got["placed"]["default/missing"].split("-")[1]) % 4 == 3
    assert not got["placed"]["default/immediate"]


def test_ephemeral_claims(mode):
    """Pods whose only volumes are generic ephemeral ones schedule as if
    they had none, in batches, as in the JAX loop (ROADMAP C17)."""
    pair = _pair()
    pods = [_pod(f"eph-{i}", ephemeral=("scratch",)) for i in range(20)]
    pair.create("create_pod", *pods)
    pair.settle()
    _close(pair)
    got = pair.assert_volume_equal()
    assert len(_bound(got, "eph-")) == 20 and got["fallback_scheduled"] == 0
    assert pair.tsched.batch_counter == pair.jsched.batch_counter >= 2


def _c9_case(pair: LoopPair, case: str) -> None:
    """Two nodes; node-0 is preferred (node-1 has a PreferNoSchedule taint),
    so the batch program puts both pods on node-0. ``limit``: each node's
    CSINode allows one volume of the driver, and each pod has its own
    bound CSI volume. ``rwop``: both pods use one ReadWriteOncePod PVC."""
    from kubernetes_tpu_torch.api.types import RWOP, CSINode, ObjectMeta, StorageClass
    from kubernetes_tpu_torch.api.wrappers import make_node

    for i in range(2):
        nw = make_node(f"node-{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 16})
        if i == 1:
            nw.taint("spare", "yes", "PreferNoSchedule")
        pair.create("create_node", nw.obj())
        pair.create("create_csinode", CSINode(meta=ObjectMeta(name=f"node-{i}", namespace=""),
                                              drivers={DRIVER: 1}))
    pair.create("create_storage_class",
                StorageClass(meta=ObjectMeta(name="csi", namespace=""), provisioner=DRIVER))
    if case == "limit":
        for i in range(2):
            pair.create("create_pv", _pv(f"pv-{i}", f"pvc-{i}", sc="csi"))
            pair.create("create_pvc", _pvc(f"pvc-{i}", f"pv-{i}", sc="csi"))
        pair.create("create_pod", _pod("c9-0", "pvc-0"), _pod("c9-1", "pvc-1"))
    else:
        pair.create("create_pv", _pv("pv-rwop", "rwop", sc="csi", access=(RWOP,)))
        pair.create("create_pvc", _pvc("rwop", "pv-rwop", sc="csi", access=(RWOP,)))
        pair.create("create_pod", _pod("c9-0", "rwop"), _pod("c9-1", "rwop"))


@pytest.mark.parametrize("case", ["limit", "rwop"])
@pytest.mark.parametrize("depth", ["0", "2"])
def test_c9_batch_conflict(case, depth, monkeypatch):
    """ROADMAP C9, asserted on each package: the JAX loop binds both pods
    on node-0 (the limit of 1 exceeded, or the ReadWriteOncePod claim
    shared); the port binds c9-0 there and sends c9-1 down the sequential
    path, which binds it on node-1 (the limit) or parks it on
    VolumeRestrictions (the claim in use), with no limit exceeded and no
    claim shared."""
    from kubernetes_tpu_torch.perf.workloads import _volume_outcome

    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    pair = LoopPair(batch=16)
    _c9_case(pair, case)
    pair.settle()
    _close(pair)
    jax_state, port_state = pair.volume_state(0), pair.volume_state(1)
    assert jax_state["popped"] == port_state["popped"] == [["default/c9-0", "default/c9-1"]]
    assert jax_state["placed"] == {"default/c9-0": "node-0", "default/c9-1": "node-0"}
    assert jax_state["fallback_scheduled"] == 0
    assert port_state["placed"]["default/c9-0"] == "node-0"
    if case == "limit":
        assert port_state["placed"]["default/c9-1"] == "node-1"
        assert port_state["fallback_scheduled"] == 1
    else:
        assert port_state["placed"]["default/c9-1"] == ""
        assert port_state["fallback_scheduled"] == 0
        assert ("default/c9-1", 1, ("VolumeRestrictions",)) in port_state["queued"]
    outcome = _volume_outcome(pair.tstore)
    assert outcome["csi_over"] == [] and outcome["rwop_shared"] == []
    # the same check over the JAX store finds node-0 over its limit, or
    # the claim shared
    jax_outcome = _volume_outcome(pair.jstore)
    if case == "limit":
        assert jax_outcome["csi_over"] == ["node-0"]
    else:
        assert jax_outcome["rwop_shared"] == ["default/rwop"]
    assert pair.tsched.batch_counter == pair.jsched.batch_counter == 1
    assert pair.tsched.screen_seconds["commit_checks"] > 0


@pytest.mark.parametrize("name", ["scheduling_intree_pvs", "scheduling_csi_pvs",
                                  "scheduling_dra"])
def test_claim_and_volume_workloads_through_run_loop(name):
    """The claim and volume workloads at a small size through
    ``workloads.run_loop`` on the CPU: every pod bound in mode-``off``
    batches, each PV still bound to its own claim, each claim allocated to
    its pod's node, no CSINode limit exceeded, nothing on the sequential
    path."""
    from kubernetes_tpu_torch.perf import workloads

    w = getattr(workloads, name)(nodes=64, init_pods=60, measured=40)
    out = workloads.run_loop(w, "cpu", percentage=100, batch_size=32)
    assert all(out["placed"].values()) and len(out["placed"]) == 100
    assert set(out["modes"]) == {"off"} and out["fallback_scheduled"] == 0
    assert out["csi_over"] == [] and out["rwop_shared"] == []
    for pv, claim in out["pv_bindings"].items():
        assert claim == "default/" + pv.replace("pv-", "pvc-", 1)
    for key, (node, users) in out["claims"].items():
        assert users == (key[:-len("-accel")],) and out["placed"][users[0]] == node
    assert out["screen_ms"]["commit_checks"] > 0


def test_delayed_binding_case_on_cpu():
    """``workloads.run_delayed_binding`` at a small size on the CPU: every
    PV, the extra ones included, ends bound to one pod on a node of its
    zone; the other pods stay unbound."""
    from kubernetes_tpu_torch.perf import workloads

    c = workloads.DelayedBinding(nodes=60, pods=32, pvs=20, extra_pvs=4)
    out = workloads.run_delayed_binding(c, "cpu")
    zones = {pv.meta.name: pv.node_affinity[ZONE][0] for pv in c.pv_list()}
    bound = {claim: pv for pv, claim in out["pv_bindings"].items() if claim}
    assert len(bound) == 24 and sum(map(bool, out["placed"].values())) == 24
    for claim, pv in bound.items():
        node = out["placed"][claim]
        assert f"zone-{int(node.split('-')[1]) % 10}" == zones[pv]
    assert out["rounds"] > 2 and out["csi_over"] == []
