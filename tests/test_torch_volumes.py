"""The port's bound-volume path on the CPU against the JAX package, exactly:

* ``VolumeMaskBuilder`` (PV node affinity, zone and region labels with
  multi-zone values, dangling binds, missing claims, the delayed-binding
  free-PV pools) against the JAX builder;
* each ported volume filter (VolumeRestrictions with its PreFilter,
  NodeVolumeLimits, VolumeBinding for bound claims, VolumeZone) against the
  JAX plugin's verdict and reason on seeded (pod, node) pairs;
* ``BatchScheduler`` on a small SchedulingInTreePVs against the JAX batched
  path;
* the screen's over-admission: the mask admits a node that the exact
  NodeVolumeLimits check then rejects, in both packages, and the rejected
  pod's row goes back to the snapshot's content;
* pods the slice does not place (unbound, delayed or missing PVCs) raise.
"""

import types

import numpy as np
import pytest

from _torch_cases import (JaxSnapshot, SnapshotShim, jax_api, jax_commit_checks,
                          jax_masked_loop, run_masked_workload_both, torch_api)
from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
from kubernetes_tpu.ops.schema import Capacities as JCaps
from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
from kubernetes_tpu_torch.backend.device_state import DeviceState as TDeviceState
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch.ops.schema import Capacities as TCaps

ZONE = "topology.kubernetes.io/zone"
REGION = "topology.kubernetes.io/region"
BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"


def _storage(pkg: str):
    if pkg == "jax":
        from kubernetes_tpu.api import types as t
        from kubernetes_tpu.apiserver.store import ClusterStore as Store
    else:
        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.apiserver.store import Store
    return types.SimpleNamespace(t=t, Store=Store)


def _nodes(api, n):
    out = []
    for i in range(n):
        nw = (api.make_node(f"node-{i}").capacity({"cpu": "16", "memory": "32Gi", "pods": 30})
              .label(ZONE, f"zone-{i % 3}").label("rack", f"r{i % 4}")
              .label("kubernetes.io/hostname", f"node-{i}"))
        if i % 2:
            nw.label(REGION, "east")
        if i % 5 == 0:
            nw.label(BETA_ZONE, f"zone-{i % 3}")
        out.append(nw.obj())
    return out


def _store(pkg: str, n_nodes: int):
    """Storage classes (immediate with a CSI driver, delayed pools), bound
    PVs with affinity and zone labels, free PVs of the delayed classes,
    CSINode limits on a few nodes."""
    s = _storage(pkg)
    t, store = s.t, s.Store()
    Meta = t.ObjectMeta
    store.create_storage_class(t.StorageClass(meta=Meta(name="csi"), provisioner="ebs.csi"))
    for name in ("wffc", "wffc-empty"):
        store.create_storage_class(t.StorageClass(
            meta=Meta(name=name), provisioner="ebs.csi",
            volume_binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    bound = {
        "rack12": dict(node_affinity={"rack": ("r1", "r2")}),
        "multizone": dict(labels={ZONE: "zone-1__zone-2"}),
        "east": dict(labels={REGION: "east"}),
        "beta": dict(labels={BETA_ZONE: "zone-0"}),
        "rack-zone": dict(node_affinity={"rack": ("r0",)}, labels={ZONE: "zone-0"}),
        "free-any": dict(),
        "rwop": dict(access=(t.RWOP,)),
        "csi-a": dict(sc="csi"), "csi-b": dict(sc="csi"), "csi-c": dict(sc="csi"),
    }
    for name, cfg in bound.items():
        store.create_pv(t.PersistentVolume(
            meta=Meta(name=f"pv-{name}", labels=dict(cfg.get("labels", {}))),
            capacity_bytes=1 << 30, storage_class=cfg.get("sc", ""),
            bound_pvc=f"default/{name}", access_modes=cfg.get("access", (t.ROX,)),
            node_affinity=dict(cfg.get("node_affinity", {}))))
        store.create_pvc(t.PersistentVolumeClaim(
            meta=Meta(name=name), storage_class=cfg.get("sc", ""), bound_pv=f"pv-{name}",
            access_modes=cfg.get("access", (t.ROX,)), requested_bytes=1 << 30))
    store.create_pvc(t.PersistentVolumeClaim(meta=Meta(name="dangling"), bound_pv="pv-gone"))
    store.create_pvc(t.PersistentVolumeClaim(meta=Meta(name="unbound")))
    for i in range(4):
        store.create_pvc(t.PersistentVolumeClaim(meta=Meta(name=f"late-{i}"),
                                                 storage_class="wffc"))
    store.create_pvc(t.PersistentVolumeClaim(meta=Meta(name="late-empty"),
                                             storage_class="wffc-empty"))
    # free PVs of the delayed class: two anywhere, three on rack r3, one in zone-2
    for i, cfg in enumerate([{}, {}, {"node_affinity": {"rack": ("r3",)}},
                             {"node_affinity": {"rack": ("r3",)}},
                             {"node_affinity": {"rack": ("r3",)}}, {"labels": {ZONE: "zone-2"}}]):
        store.create_pv(t.PersistentVolume(
            meta=Meta(name=f"free-{i}", labels=dict(cfg.get("labels", {}))),
            capacity_bytes=1 << 30, storage_class="wffc",
            node_affinity=dict(cfg.get("node_affinity", {}))))
    for i in range(0, n_nodes, 3):
        store.create_csinode(t.CSINode(meta=Meta(name=f"node-{i}"), drivers={"ebs.csi": 1 + i % 2}))
    return store


# each pod's PVC names: every branch of the screen and the filters
POD_VOLUMES = [(), ("rack12",), ("multizone",), ("east",), ("beta",), ("rack-zone",),
               ("free-any",), ("rwop",), ("csi-a",), ("csi-b", "csi-c"), ("dangling",),
               ("missing",), ("late-0",), ("late-1", "late-2", "late-3"), ("late-empty",),
               ("rack12", "east"), ("unbound",)]


def _pods(api):
    out = []
    for i, vols in enumerate(POD_VOLUMES):
        pw = api.make_pod(f"p{i}").req({"cpu": "100m"})
        for v in vols:
            pw.pvc(v)
        out.append(pw.obj())
    return out


def _with_existing(api, nodes):
    """NodeInfos whose nodes already hold volume pods: the RWOP claim on
    node-4, CSI volumes that fill node-0's limit of 1 and half node-3's 2."""
    infos = [api.NodeInfo(n) for n in nodes]
    for node_i, vol in ((4, "rwop"), (0, "csi-a"), (3, "csi-b")):
        pod = api.make_pod(f"old-{node_i}").req({"cpu": "100m"}).pvc(vol).node(
            f"node-{node_i}").obj()
        infos[node_i].add_pod(pod)
    return infos


def _both(n_nodes=12):
    jinfos = {ni.node.meta.name: ni for ni in _with_existing(jax_api(), _nodes(jax_api(), n_nodes))}
    tinfos = _with_existing(torch_api(), _nodes(torch_api(), n_nodes))
    jds = JDeviceState(JCaps(nodes=32, pods=32))
    jds.sync(SnapshotShim(jinfos.values()))
    snap = Snapshot(tinfos)
    tds = TDeviceState(TCaps(nodes=32, pods=32), device="cpu")
    tds.sync(snap)
    assert tds.encoder.node_slots == jds.encoder.node_slots
    return jinfos, jds, snap, tds


def test_volume_mask_matches_jax():
    from kubernetes_tpu.ops.volume_mask import VolumeMaskBuilder as JBuilder
    from kubernetes_tpu_torch.ops.volume_mask import VolumeMaskBuilder as TBuilder

    jinfos, jds, snap, tds = _both()
    jstore, tstore = _store("jax", 12), _store("torch", 12)
    jb, tb = JBuilder(jstore), TBuilder(tstore)
    jpods, tpods = _pods(jax_api()), _pods(torch_api())
    assert [jb.batchable(p) for p in jpods] == [tb.batchable(p) for p in tpods]
    qps = [types.SimpleNamespace(pod=p) for p in jpods]
    want = jb.build(qps, JaxSnapshot(jinfos), jds.encoder, 32, 32)
    for _ in range(2):  # the second build reads the PV cache
        got = tb.build(tpods, snap, tds.encoder, 32, 32)
        np.testing.assert_array_equal(got, want)
    slot = tds.encoder.node_slots
    rows = {vols: got[i] for i, vols in enumerate(POD_VOLUMES)}
    assert rows[()].all() and rows[("missing",)].all() and rows[("dangling",)].all()
    assert rows[("rack12",)].sum() == 6 and not rows[("rack-zone",)][slot["node-4"]]
    # three free PVs: on rack r3 (3 + 2 anywhere) or in zone-2 (1 + 2 anywhere)
    assert rows[("late-1", "late-2", "late-3")].sum() == 6
    assert not rows[("late-empty",)].any()
    assert got[len(POD_VOLUMES):].all()                       # padding rows
    assert tb.build([torch_api().make_pod("x").obj()], snap, tds.encoder, 32, 32) is None


def _jax_verdict(st):
    return None if st.is_success() else st.reasons[0]


@pytest.mark.parametrize("filter_name", ["VolumeRestrictions", "NodeVolumeLimits",
                                         "VolumeBinding", "VolumeZone"])
def test_volume_filters_match_jax(filter_name):
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins import volume as jvol
    from kubernetes_tpu_torch.framework.plugins import volume as tvol

    jinfos, _jds, snap, _tds = _both()
    jstore, tstore = _store("jax", 12), _store("torch", 12)
    tinfos = snap.node_info_map
    verdicts = set()
    for jpod, tpod in zip(_pods(jax_api()), _pods(torch_api())):
        state = CycleState()
        if filter_name == "VolumeRestrictions":
            plugin = jvol.VolumeRestrictions(jstore, snapshot_fn=lambda: list(jinfos.values()))
            _, st = plugin.pre_filter(state, jpod)
            rwop, reason = tvol.volume_restrictions_pre_filter(tstore, tpod, tinfos.values())
            assert reason == _jax_verdict(st)
            verdicts.add(reason)
            if reason is not None:
                continue
            check = lambda ni: tvol.volume_restrictions_filter(rwop, ni)  # noqa: E731
        elif filter_name == "VolumeBinding":
            plugin = jvol.VolumeBinding(jstore, volume_capacity_priority=False)
            _, st = plugin.pre_filter(state, jpod)
            bound, delayed, reason = tvol.volume_binding_pre_filter(tstore, tpod)
            assert reason == _jax_verdict(st)
            verdicts.add(reason)
            if reason is not None:
                continue
            if delayed:
                verdicts.add("delayed")
            node_bindings = {}
            check = lambda ni: tvol.volume_binding_filter(  # noqa: E731
                tstore, bound, ni, delayed, node_bindings)
        elif filter_name == "NodeVolumeLimits":
            plugin = jvol.NodeVolumeLimits(jstore)
            check = lambda ni: tvol.node_volume_limits_filter(tstore, tpod, ni)  # noqa: E731
        else:
            plugin = jvol.VolumeZone(jstore)
            check = lambda ni: tvol.volume_zone_filter(tstore, tpod, ni)  # noqa: E731
        for name, jni in jinfos.items():
            want = _jax_verdict(plugin.filter(state, jpod, jni))
            assert check(tinfos[name]) == want, (filter_name, tpod.key(), name)
            verdicts.add(want)
        if filter_name == "VolumeBinding":
            # the delayed claims' choice per node, as the JAX Filter records it
            assert node_bindings == state.read(plugin.STATE_KEY).node_bindings
    assert None in verdicts and len(verdicts) >= 2, verdicts


def test_batch_scheduler_intree_pvs_matches_jax():
    placed_j, _jstore, turned_j, placed_t, _tstore, sched = run_masked_workload_both(
        "scheduling_intree_pvs")
    assert placed_t == placed_j
    assert all(placed_t.values()) and not turned_j
    assert not sched.retry and not sched.fallback
    assert set(sched.batch_paths) == {"fused"}
    assert sched.screen_seconds["volume_mask"] > 0 and sched.screen_seconds["commit_checks"] > 0
    used = {k for ni in sched.snapshot.node_info_map.values() for k in ni.pvc_ref_counts}
    assert len(used) == len(placed_t)


def _limit_cluster(pkg: str, api):
    """One node with a CSI attach limit of 1 that an existing pod already
    uses, and a second node the pods cannot take (it is unschedulable)."""
    s = _storage(pkg)
    t, store = s.t, s.Store()
    store.create_storage_class(t.StorageClass(meta=t.ObjectMeta(name="csi"),
                                              provisioner="ebs.csi"))
    for name in ("vol-old", "vol-new", "vol-other"):
        store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name=f"pv-{name}"),
                                           storage_class="csi", bound_pvc=f"default/{name}"))
        store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name=name),
                                                 storage_class="csi", bound_pv=f"pv-{name}"))
    store.create_csinode(t.CSINode(meta=t.ObjectMeta(name="node-0"), drivers={"ebs.csi": 1}))
    full = api.NodeInfo(api.make_node("node-0").capacity(
        {"cpu": "16", "memory": "32Gi", "pods": 30}).obj())
    full.add_pod(api.make_pod("old").req({"cpu": "1"}).pvc("vol-old").node("node-0").obj())
    closed = api.NodeInfo(api.make_node("node-1").capacity(
        {"cpu": "16", "memory": "32Gi", "pods": 30}).unschedulable().obj())
    pods = [api.make_pod("new").req({"cpu": "100m"}).pvc("vol-new").obj(),
            api.make_pod("plain").req({"cpu": "100m"}).obj()]
    return store, [full, closed], pods


def test_screen_over_admits_and_the_exact_check_rejects():
    from kubernetes_tpu.backend import batch as jbatch

    jstore, jnodes, jpods = _limit_cluster("jax", jax_api())
    tstore, tnodes, tpods = _limit_cluster("torch", torch_api())
    jinfos = {ni.node.meta.name: ni for ni in jnodes}
    # the JAX package's own check of the chosen node rejects the pod
    assert jax_commit_checks(jstore, jinfos)(jpods[0], "node-0") == (
        "fallback", ("node(s) exceed max volume count",))
    jds = JDeviceState(JCaps(nodes=32, pods=8))
    turned_j = {}
    placed_j = jax_masked_loop(jds, jbatch.build_schedule_batch_fn(), jinfos, jstore, jpods, 8,
                               turned_j)
    sched = BatchScheduler(tnodes, caps=TCaps(nodes=32, pods=8), device="cpu", client=tstore)
    placed_t = sched.schedule(tpods)
    assert placed_t == placed_j == {"default/new": None, "default/plain": "node-0"}
    assert turned_j == {"default/new": "fallback"}
    assert sched.fallback == {"default/new": "node(s) exceed max volume count"}
    # the mask admitted node-0: the device chose it, and only the host check refused
    assert sched.screen_seconds["commit_checks"] > 0
    # the device row still holds the refused pod until the next sync puts
    # the snapshot's content back
    slot = sched.state.encoder.node_slots["node-0"]
    with_phantom = sched.state.nt.requested.numpy()[slot].copy()
    sched.state.sync(sched.snapshot)
    fresh = TDeviceState(TCaps(nodes=32, pods=8), device="cpu")
    fresh.sync(Snapshot(sched.snapshot.node_info_map.values()))
    np.testing.assert_array_equal(sched.state.nt.requested.numpy(), fresh.nt.requested.numpy())
    assert (with_phantom > sched.state.nt.requested.numpy()[slot]).any()
    # the exact filters of both packages agree on the refused node
    jds.sync(SnapshotShim(jinfos.values()))
    np.testing.assert_array_equal(np.asarray(jds.nt.requested)[slot],
                                  sched.state.nt.requested.numpy()[slot])


def test_unplaceable_volume_pods_raise():
    tstore = _store("torch", 12)
    sched = BatchScheduler(_with_existing(torch_api(), _nodes(torch_api(), 12)),
                           caps=TCaps(nodes=32, pods=32), device="cpu", client=tstore)
    api = torch_api()
    for vols in (("unbound",), ("late-0",), ("missing",), ("rack12", "late-empty")):
        pw = api.make_pod("x").req({"cpu": "100m"})
        for v in vols:
            pw.pvc(v)
        with pytest.raises(NotImplementedError):
            sched.schedule([pw.obj()])
    no_store = BatchScheduler([api.NodeInfo(n) for n in _nodes(api, 2)], device="cpu")
    with pytest.raises(NotImplementedError):
        no_store.schedule([api.make_pod("y").pvc("rack12").obj()])
    assert sched.batches == 0 and no_store.batches == 0
    placed = sched.schedule([api.make_pod("z").req({"cpu": "100m"}).pvc("rack12").obj()])
    assert placed["default/z"] in {f"node-{i}" for i in range(12) if i % 4 in (1, 2)}
