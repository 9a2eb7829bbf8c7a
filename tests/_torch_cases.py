"""Shared builders for the port's parity tests (tests/test_torch_*.py).

One seeded description of a cluster and a pod batch (plain data made with
numpy) is built twice: once with the JAX package's API objects and once with
the port's, so both packages see the same inputs.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

ZONES = 3


def cluster_spec(n_nodes: int, seed: int) -> list:
    """Heterogeneous nodes: capacities that land on floor boundaries,
    zones, taints of every effect, one unschedulable node, images, and
    existing pods (requests and host ports)."""
    rng = np.random.RandomState(seed)
    caps = [("3", "7Gi", 20), ("7", "1000Mi", 10), ("16", "64Gi", 110),
            ("4", "3Gi", 30), ("32", "128Gi", 110)]
    nodes = []
    for i in range(n_nodes):
        cpu, mem, pods = caps[rng.randint(len(caps))]
        taints = []
        if i % 7 == 1:
            taints.append(("dedicated", "infra", "PreferNoSchedule"))
        if i % 11 == 2:
            taints.append(("gpu", "yes", "NoSchedule"))
        if i % 13 == 3:
            taints.append(("flaky", "", "PreferNoSchedule"))
        existing = []
        for j in range(rng.randint(0, 3)):
            existing.append({
                "name": f"old-{i}-{j}",
                "cpu": f"{int(rng.choice([0, 100, 250, 500]))}m",
                "mem": f"{int(rng.choice([0, 128, 512]))}Mi",
                "port": int(rng.choice([0, 0, 8080, 9090])),
                "priority": int(rng.choice([0, 10])),
            })
        nodes.append({
            "name": f"node-{i}",
            "cpu": cpu, "mem": mem, "pods": pods,
            "labels": {"topology.kubernetes.io/zone": f"zone-{i % ZONES}",
                       "tier": str(i % 4)},
            "taints": taints,
            "unschedulable": i == 5,
            "images": [("registry/web:1.0", 300 * 1024 * 1024)] if i % 3 == 0 else [],
            "existing": existing,
        })
    return nodes


def pods_spec(n_pods: int, seed: int, nominate: str = "", node_name: str = "") -> list:
    """Pods that exercise every static filter and score of the main path."""
    rng = np.random.RandomState(seed)
    pods = []
    for i in range(n_pods):
        d = {"name": f"pod-{seed}-{i}",
             "cpu": f"{int(rng.choice([0, 100, 500, 900, 2000, 3000]))}m",
             "mem": f"{int(rng.choice([0, 256, 1024, 2048, 7168]))}Mi",
             "priority": int(rng.choice([0, 10, 100])),
             "selector": {}, "affinity_in": None, "preferred": [],
             "tolerations": [], "port": 0, "image": "", "nominated": "",
             "node_name": ""}
        k = i % 8
        if k == 1:
            d["selector"] = {"topology.kubernetes.io/zone": f"zone-{i % ZONES}"}
        elif k == 2:
            d["affinity_in"] = ("tier", ["1", "2"])
        elif k == 3:
            d["preferred"] = [(5, "tier", ["3"]), (2, "topology.kubernetes.io/zone", ["zone-0"])]
        elif k == 4:
            d["tolerations"] = [("dedicated", "Equal", "infra", "PreferNoSchedule"),
                                ("gpu", "Exists", "", "")]
        elif k == 5:
            d["port"] = int(rng.choice([8080, 9090, 7000]))
        elif k == 6:
            d["image"] = "registry/web:1.0"
        pods.append(d)
    if nominate:
        pods[1]["nominated"] = nominate
    if node_name:
        pods[2]["node_name"] = node_name
    return pods


def build_nodes(api, spec: list) -> list:
    """NodeInfos from ``spec`` with the given package's API namespace
    (``api.make_node``, ``api.make_pod``, ``api.NodeInfo``)."""
    infos = []
    for d in spec:
        nw = api.make_node(d["name"]).capacity(
            {"cpu": d["cpu"], "memory": d["mem"], "pods": d["pods"]})
        for k, v in d["labels"].items():
            nw.label(k, v)
        for key, value, effect in d["taints"]:
            nw.taint(key, value, effect)
        if d["unschedulable"]:
            nw.unschedulable()
        for name, size in d["images"]:
            nw.image(name, size)
        ni = api.NodeInfo(nw.obj())
        for e in d["existing"]:
            pw = api.make_pod(e["name"]).req({"cpu": e["cpu"], "memory": e["mem"]})
            pw.priority(e["priority"])
            if e["port"]:
                pw.host_port(e["port"])
            for k, v in e.get("labels", {}).items():
                pw.label(k, v)
            pod = pw.obj()
            pod.spec.node_name = d["name"]
            pod.status.start_time = e.get("start", 0.0)
            pod.meta.deletion_timestamp = 1.0 if e.get("terminating") else 0.0
            ni.add_pod(pod)
        infos.append(ni)
    return infos


def build_pods(api, spec: list) -> list:
    pods = []
    for d in spec:
        pw = api.make_pod(d["name"]).req({"cpu": d["cpu"], "memory": d["mem"]})
        pw.priority(d["priority"])
        if d["selector"]:
            pw.node_selector(d["selector"])
        if d["affinity_in"]:
            pw.node_affinity_in(*d["affinity_in"])
        for w, key, values in d["preferred"]:
            pw.preferred_node_affinity(w, key, values)
        for key, op, value, effect in d["tolerations"]:
            pw.toleration(key, op, value, effect)
        if d["port"]:
            pw.host_port(d["port"])
        if d["image"]:
            pw.container(d["image"], {"cpu": "10m"})
        pod = pw.obj()
        pod.status.nominated_node_name = d["nominated"]
        pod.spec.node_name = d["node_name"]
        pods.append(pod)
    return pods


@dataclasses.dataclass
class Api:
    make_node: object
    make_pod: object
    NodeInfo: object
    LabelSelector: object


def jax_api() -> Api:
    from kubernetes_tpu.api.types import LabelSelector
    from kubernetes_tpu.api.wrappers import make_node, make_pod
    from kubernetes_tpu.framework.types import NodeInfo

    return Api(make_node, make_pod, NodeInfo, LabelSelector)


def torch_api() -> Api:
    from kubernetes_tpu_torch.api.types import LabelSelector
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.framework.types import NodeInfo

    return Api(make_node, make_pod, NodeInfo, LabelSelector)


# ----------------------------------------------------------------- topology

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
TOPO_LABELS = ({"app": "web"}, {"color": "green"}, {"app": "db", "color": "green"}, {})


def _topo_pod(rng, name: str, keys) -> dict:
    """A pod with seeded labels, spread constraints and (anti-)affinity
    terms on the topology keys ``keys``."""
    d = {"name": name, "cpu": f"{int(rng.choice([100, 250, 500]))}m",
         "mem": f"{int(rng.choice([128, 256]))}Mi",
         "labels": dict(TOPO_LABELS[rng.randint(len(TOPO_LABELS))]),
         "spread": [], "affinity": [], "preferred": [], "port": 0, "nominated": ""}
    k = rng.randint(8)
    key = keys[rng.randint(len(keys))]
    if k in (0, 1):
        when = "DoNotSchedule" if k == 0 else "ScheduleAnyway"
        d["spread"].append((int(rng.randint(1, 3)), key, when, {"app": "web"},
                            int(rng.choice([0, 0, 3])) or None))
        d["labels"]["app"] = "web"
    elif k == 2:
        d["affinity"].append((key, {"color": "green"}, True))
        d["labels"]["color"] = "green"
    elif k == 3:
        d["affinity"].append((key, {"app": "web"}, False))
    elif k == 4:
        d["preferred"].append((int(rng.choice([1, 5])), key, {"app": "db"}, False))
        d["preferred"].append((int(rng.choice([2, 7])), keys[0], {"color": "green"}, True))
    elif k == 5:
        d["spread"].append((1, key, "DoNotSchedule", {"app": "web"}, None))
        d["affinity"].append((keys[-1], {"app": "db"}, True))
    elif k == 6:
        d["port"] = int(rng.choice([8080, 9090]))
    return d


def topo_cluster_spec(n_nodes: int, seed: int, keys=(ZONE, HOST), zones: int = 4) -> list:
    """Nodes with zone and hostname labels (a few without a zone), holding
    existing pods that carry labels and (anti-)affinity terms on ``keys``."""
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {HOST: f"node-{i}"}
        if i % 9 != 4:
            labels[ZONE] = f"zone-{i % zones}"
        existing = [_topo_pod(rng, f"old-{i}-{j}", keys) for j in range(rng.randint(0, 3))]
        for e in existing:
            e["spread"] = []  # placed pods' constraints play no part
        nodes.append({"name": f"node-{i}", "labels": labels, "existing": existing,
                      "cpu": str(int(rng.choice([4, 8]))), "mem": "16Gi", "pods": 20})
    return nodes


def topo_pods_spec(n_pods: int, seed: int, keys=(ZONE, HOST), nominate: str = "") -> list:
    rng = np.random.RandomState(seed)
    pods = [_topo_pod(rng, f"pod-{seed}-{i}", keys) for i in range(n_pods)]
    if nominate:
        pods[1]["nominated"] = nominate
    return pods


def _topo_wrapper(api, d: dict):
    pw = api.make_pod(d["name"]).req({"cpu": d["cpu"], "memory": d["mem"]})
    for k, v in d["labels"].items():
        pw.label(k, v)
    for skew, key, when, sel, min_domains in d["spread"]:
        pw.spread_constraint(skew, key, when_unsatisfiable=when,
                             selector=api.LabelSelector(match_labels=dict(sel)),
                             min_domains=min_domains)
    for key, sel, anti in d["affinity"]:
        pw.pod_affinity(key, api.LabelSelector(match_labels=dict(sel)), anti=anti)
    for weight, key, sel, anti in d["preferred"]:
        pw.preferred_pod_affinity(weight, key, api.LabelSelector(match_labels=dict(sel)),
                                  anti=anti)
    if d["port"]:
        pw.host_port(d["port"])
    return pw


def build_topo_nodes(api, spec: list) -> list:
    infos = []
    for d in spec:
        nw = api.make_node(d["name"]).capacity(
            {"cpu": d["cpu"], "memory": d["mem"], "pods": d["pods"]})
        for k, v in d["labels"].items():
            nw.label(k, v)
        ni = api.NodeInfo(nw.obj())
        for e in d["existing"]:
            pod = _topo_wrapper(api, e).obj()
            pod.spec.node_name = d["name"]
            ni.add_pod(pod)
        infos.append(ni)
    return infos


def build_topo_pods(api, spec: list) -> list:
    pods = []
    for d in spec:
        pod = _topo_wrapper(api, d).obj()
        pod.status.nominated_node_name = d["nominated"]
        pods.append(pod)
    return pods


class SnapshotShim:
    """The part of a cache snapshot the JAX DeviceState.sync reads."""

    def __init__(self, infos):
        self.node_info_map = {ni.node.meta.name: ni for ni in infos}


TOPO_CAPS = dict(nodes=128, pods=32, value_words=32, sigs=16, ex_terms=32)

# the topology modes of a seeded batch: its keys, the mode the JAX scheduler
# picks for them, and the domain axis of mode general (None: the full value
# vocab; bucket: the scheduler's; exact: vd_needed)
TOPO_MODES = {
    "host": dict(keys=(HOST,), mode="host"),
    "general-full": dict(keys=(ZONE, HOST), mode="general", vd=None),
    "general-bucket": dict(keys=(ZONE, HOST), mode="general", vd="bucket"),
    "general-exact": dict(keys=(ZONE, HOST), mode="general", vd="exact"),
}


def jax_topo_mode_info(ds):
    """The JAX scheduler's own mode choice, on a bare DeviceState."""
    import types

    from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler

    return TPUScheduler._topo_mode_info(types.SimpleNamespace(device=ds))


def topo_encoded(seed, keys):
    """The JAX-encoded state of a seeded topology batch: (DeviceState, pb,
    et, tb)."""
    from kubernetes_tpu.backend.device_state import DeviceState
    from kubernetes_tpu.ops.schema import Capacities

    jds = DeviceState(Capacities(**TOPO_CAPS))
    jds.sync(SnapshotShim(build_topo_nodes(jax_api(), topo_cluster_spec(48, seed, keys))))
    pods = build_topo_pods(jax_api(), topo_pods_spec(32, seed + 11, keys, nominate="node-7"))
    pb, et = jds.encoder.encode_pods(pods)
    tb = jds.sig_table.encode_topo(pods)
    return jds, pb, et, tb


def jax_loop(ds, fn, infos, pods, batch):
    """The JAX DeviceState + build_schedule_batch_fn loop, the mode chosen
    by the JAX scheduler's own rule. Returns (placements, modes)."""
    import jax

    from kubernetes_tpu.backend import batch as jbatch

    out, modes = {}, []
    for s in range(0, len(pods), batch):
        chunk = pods[s:s + batch]
        ds.sync(SnapshotShim(infos.values()))
        pb, et = ds.encoder.encode_pods(chunk)
        tb = ds.sig_table.encode_topo(chunk)
        mode, vd, host_key = jax_topo_mode_info(ds)
        modes.append(mode)
        res = fn(pb, et, ds.nt, ds.tc, tb, jax.random.PRNGKey(0),
                 topo_enabled=ds.topo_enabled, topo_mode=mode, vd_override=vd,
                 host_key=host_key, ports_enabled=ds.encoder.last_has_ports)
        node_idx = jbatch.unpack_result_block(res.packed, ds.caps.nodes)[0]
        names = ds.slot_to_name()
        for i, pod in enumerate(chunk):
            if node_idx[i] < 0:
                out[pod.key()] = None
                continue
            name = names[int(node_idx[i])]
            bound = pod.clone()
            bound.spec.node_name = name
            infos[name].add_pod(bound)
            out[pod.key()] = name
        ds.adopt_device(res)
        ds.adopt_commits(res, ds.encoder.last_host_pb, node_idx)
    return out, modes


# small versions of the scheduler_perf workloads: (node count, init pods,
# measured pods, batch)
TOPO_WORKLOADS = {
    "scheduling_pod_anti_affinity": (64, 40, 40, 16),
    "scheduling_pod_affinity": (64, 48, 32, 16),
    "topology_spreading": (64, 60, 50, 16),
}
WORKLOADS = {**TOPO_WORKLOADS, "scheduling_basic": (64, 40, 50, 16)}


def run_workload_both(name: str):
    """A small workload of WORKLOADS through the JAX DeviceState +
    build_schedule_batch_fn loop and through the port's BatchScheduler on
    the CPU, both under the current KTPU_SPEC. Returns (JAX placements, JAX
    modes, port placements, the port's BatchScheduler)."""
    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu.perf import workloads as jworkloads
    from kubernetes_tpu.perf.harness import _node_wrapper, _pod_wrapper
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities
    from kubernetes_tpu_torch.perf import workloads

    n, n_init, n_meas, batch = WORKLOADS[name]
    w = getattr(workloads, name)(nodes=n, init_pods=n_init, measured=n_meas)
    jops = getattr(jworkloads, name)(nodes=n, init_pods=n_init, measured=n_meas)["ops"]
    caps = dict(nodes=128, pods=batch, value_words=32)
    jinfos = {}
    for i in range(n):
        ni = jax_api().NodeInfo(_node_wrapper(i, jops[0]).obj())
        jinfos[ni.node.meta.name] = ni
    ds = JDeviceState(JCaps(**caps))
    fn = jbatch.build_schedule_batch_fn()
    placed_j, modes_j = {}, []
    for op, count in ((jops[1], n_init), (jops[3], n_meas)):
        pods = [_pod_wrapper(i, op["prefix"], op).obj() for i in range(count)]
        out, modes = jax_loop(ds, fn, jinfos, pods, batch)
        placed_j.update(out)
        modes_j += modes
    sched = BatchScheduler(w.node_infos(), caps=Capacities(**caps), device="cpu")
    placed_t = sched.schedule(w.init_pod_list())
    placed_t.update(sched.schedule(w.measured_pod_list()))
    return placed_j, modes_j, placed_t, sched


def topo_case_args(case: str, seed: int):
    """A TOPO_MODES case: (JAX DeviceState, pb, et, tb, the keyword
    arguments of both packages' schedule_batch: topo_mode, vd_override,
    host_key)."""
    c = TOPO_MODES[case]
    jds, pb, et, tb = topo_encoded(seed, c["keys"])
    mode, vd_bucket, host_key = jax_topo_mode_info(jds)
    assert mode == c["mode"]
    vd = {None: None, "bucket": vd_bucket,
          "exact": jds.sig_table.last_topo_summary["vd_needed"]}.get(c.get("vd"))
    return jds, pb, et, tb, dict(topo_mode=mode, vd_override=vd, host_key=host_key)


def jax_encoded(n_nodes: int, n_pods: int, seed: int, capacity_nodes: int = 256,
                pods_cap: int = 64, **pod_kw):
    """(JAX DeviceState, pods, PodBatch, ExprTable) for a seeded case."""
    from kubernetes_tpu.backend.device_state import DeviceState
    from kubernetes_tpu.ops.schema import Capacities

    caps = Capacities(nodes=capacity_nodes, pods=pods_cap)
    ds = DeviceState(caps)
    ds.sync(SnapshotShim(build_nodes(jax_api(), cluster_spec(n_nodes, seed))))
    pods = build_pods(jax_api(), pods_spec(n_pods, seed + 1, **pod_kw))
    pb, et = ds.encoder.encode_pods(pods)
    return ds, pods, pb, et


def numpy_fields(obj) -> dict:
    """A JAX dataclass as a dict of numpy arrays (np.asarray per field)."""
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def to_port(ds, pb, et):
    """The JAX-encoded state carried into the port on the CPU."""
    from kubernetes_tpu_torch import interop

    return (interop.node_tensors_from_numpy(numpy_fields(ds.nt), "cpu"),
            interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
            interop.expr_table_from_numpy(numpy_fields(et), "cpu"))


def u32(t) -> np.ndarray:
    """uint32 view of a port tensor holding uint32 bits in int32."""
    return t.cpu().numpy().view(np.uint32)


def f32_bits(a) -> np.ndarray:
    """Bit pattern of a float32 array (for bit-exact comparison)."""
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


# ----------------------------------------------------------------- DRA and volumes


class JaxSnapshot:
    """The part of the JAX cache snapshot its volume screen and
    ``TPUScheduler._verify_volumes_on_node`` read, over a NodeInfo dict."""

    def __init__(self, infos: dict):
        self.infos = infos
        self.structure_version = self.node_object_version = 0

    @property
    def node_info_list(self):
        return list(self.infos.values())

    def get(self, name):
        return self.infos.get(name)


def jax_commit_checks(store, infos: dict):
    """fn(pod, node name) -> None, ("retry", reason) or ("fallback", reason):
    the JAX package's commit path for a volume or claim pod
    (``TPUScheduler._commit_batch``): the PreFilters in the default order
    (a failure: the sequential fallback), ``_verify_volumes_on_node`` with
    the default volume filters, then the DynamicResources Reserve (a failure
    requeues the pod: retry)."""
    import types

    from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins.dynamicresources import DynamicResources
    from kubernetes_tpu.framework.plugins.volume import (NodeVolumeLimits, VolumeBinding,
                                                         VolumeRestrictions, VolumeZone)

    snap = JaxSnapshot(infos)
    vr = VolumeRestrictions(client=store, snapshot_fn=lambda: list(infos.values()))
    vb = VolumeBinding(client=store, volume_capacity_priority=False)
    dr = DynamicResources(client=store)
    fwk = types.SimpleNamespace(points={"filter": [
        (p, 0) for p in (vr, NodeVolumeLimits(client=store), vb, VolumeZone(client=store))]})
    shim = types.SimpleNamespace(snapshot=snap, _VOLUME_FILTERS=TPUScheduler._VOLUME_FILTERS)

    def check(pod, node_name):
        state = CycleState()
        for plugin in ((vr, vb) if pod.spec.volumes else ()) + (dr,):
            _, st = plugin.pre_filter(state, pod)
            if not st.is_success():
                return ("fallback", st.reasons)
        if pod.spec.volumes:
            st = TPUScheduler._verify_volumes_on_node(shim, fwk, state, pod, node_name)
            if not st.is_success():
                return ("fallback", st.reasons)
        st = dr.reserve(state, pod, node_name)
        if not st.is_success():
            return ("retry", st.reasons)
        return None

    return check


def jax_masked_loop(ds, fn, infos, store, pods, batch, turned_away: dict):
    """The JAX batched path with the volume screen and the claim mask: per
    batch ``VolumeMaskBuilder`` and ``ClaimMaskBuilder`` (as
    ``tpu_scheduler.py:701-705`` builds them), the batch program with
    ``extra_mask`` / ``dra_mask``, then in batch order the commit checks of
    ``jax_commit_checks``; a pod turned away is recorded in ``turned_away``
    (pod key -> "retry" or "fallback"), is not bound, and its node's row is
    uploaded again by the next sync. Returns the placements."""
    import jax

    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu.backend.claim_mask import ClaimMaskBuilder
    from kubernetes_tpu.ops.volume_mask import VolumeMaskBuilder

    vmb, cmb = VolumeMaskBuilder(store), ClaimMaskBuilder(store)
    check = jax_commit_checks(store, infos)
    out = {}
    for s in range(0, len(pods), batch):
        chunk = pods[s:s + batch]
        qps = [type("QP", (), {"pod": p})() for p in chunk]
        ds.sync(SnapshotShim(infos.values()))
        pb, et = ds.encoder.encode_pods(chunk)
        tb = ds.sig_table.encode_topo(chunk)
        extra = vmb.build(qps, JaxSnapshot(infos), ds.encoder, ds.caps.nodes, batch)
        dra_mask = cmb.build(qps, ds, batch)
        res = fn(pb, et, ds.nt, ds.tc, tb, jax.random.PRNGKey(0), topo_enabled=False,
                 ports_enabled=ds.encoder.last_has_ports,
                 extra_mask=None if extra is None else jax.numpy.asarray(extra),
                 dra_mask=dra_mask)
        node_idx = jbatch.unpack_result_block(res.packed, ds.caps.nodes)[0]
        names = ds.slot_to_name()
        rejected = set()
        for i, pod in enumerate(chunk):
            if node_idx[i] < 0:
                out[pod.key()] = None
                continue
            name = names[int(node_idx[i])]
            if pod.spec.volumes or pod.spec.resource_claims:
                verdict = check(pod, name)
                if verdict is not None:
                    turned_away[pod.key()] = verdict[0]
                    out[pod.key()] = None
                    rejected.add(name)
                    continue
            turned_away.pop(pod.key(), None)
            bound = pod.clone()
            bound.spec.node_name = name
            infos[name].add_pod(bound)
            out[pod.key()] = name
        ds.adopt_device(res)
        ds.adopt_commits(res, ds.encoder.last_host_pb, node_idx)
        for name in rejected:
            ds._uploaded_gen.pop(name, None)  # TPUScheduler._invalidate_device_row
    return out


def populate_jax_store(store, op: dict) -> None:
    """The objects the JAX harness and its resourceclaim controller leave
    for one createPods / measurePods op: each pod's claim (``<pod>-<entry>``)
    and its class, or each pod's pre-bound PV and PVC."""
    from kubernetes_tpu.api.types import (ObjectMeta, PersistentVolume, PersistentVolumeClaim,
                                          ResourceClaim, ResourceClass)

    for cfg in op.get("claims") or ():
        if store.get_object("ResourceClass", cfg["class"]) is None:
            store.create_object("ResourceClass", ResourceClass(
                meta=ObjectMeta(name=cfg["class"], namespace=""), driver_name=cfg["class"],
                selectors=dict(cfg["class_selectors"])))
    for i in range(op["count"]):
        prefix = op["prefix"]
        for cfg in op.get("claims") or ():
            store.create_object("ResourceClaim", ResourceClaim(
                meta=ObjectMeta(name=f"{prefix}-{i}-{cfg['name']}"),
                resource_class_name=cfg["class"], selectors=dict(cfg["selectors"])))
        if op.get("pvc"):
            pv, pvc = f"pv-{prefix}-{i}", f"pvc-{prefix}-{i}"
            store.create_pv(PersistentVolume(
                meta=ObjectMeta(name=pv), capacity_bytes=1 << 30, bound_pvc=f"default/{pvc}",
                access_modes=("ReadOnlyMany",), volume_type=op["pvc"]["volume_type"]))
            store.create_pvc(PersistentVolumeClaim(
                meta=ObjectMeta(name=pvc, annotations={"pv.kubernetes.io/bind-completed": "true"}),
                bound_pv=pv, access_modes=("ReadOnlyMany",), requested_bytes=1 << 30))


def jax_workload_pods(op: dict) -> list:
    """The pods of one JAX op, named ``<prefix>-<i>`` from 0 as the port's
    workloads name them, with the PVC the harness adds to each."""
    from kubernetes_tpu.perf.harness import _pod_wrapper

    pods = []
    for i in range(op["count"]):
        pw = _pod_wrapper(i, op["prefix"], op)
        if op.get("pvc"):
            pw.pvc(f"pvc-{op['prefix']}-{i}")
        pods.append(pw.obj())
    return pods


# small versions of the claim and volume workloads: (node count, init pods,
# measured pods, batch)
MASKED_WORKLOADS = {
    "scheduling_dra": (64, 40, 50, 16),
    "scheduling_intree_pvs": (64, 60, 40, 16),
}


def run_masked_workload_both(name: str):
    """A small MASKED_WORKLOADS workload through ``jax_masked_loop`` and the
    port's BatchScheduler on the CPU. Returns (JAX placements, JAX store,
    JAX turned-away, port placements, port store, the port's
    BatchScheduler)."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu.perf import workloads as jworkloads
    from kubernetes_tpu.perf.harness import _node_wrapper
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities
    from kubernetes_tpu_torch.perf import workloads

    n, n_init, n_meas, batch = MASKED_WORKLOADS[name]
    w = getattr(workloads, name)(nodes=n, init_pods=n_init, measured=n_meas)
    jops = getattr(jworkloads, name)(nodes=n, init_pods=n_init, measured=n_meas)["ops"]
    caps = dict(nodes=128, pods=batch, value_words=32)
    jinfos = {}
    for i in range(n):
        ni = jax_api().NodeInfo(_node_wrapper(i, jops[0]).obj())
        jinfos[ni.node.meta.name] = ni
    jstore = ClusterStore()
    for op in (jops[1], jops[3]):
        populate_jax_store(jstore, op)
    ds = JDeviceState(JCaps(**caps))
    fn = jbatch.build_schedule_batch_fn()
    placed_j, turned_j = {}, {}
    for op in (jops[1], jops[3]):
        placed_j.update(jax_masked_loop(ds, fn, jinfos, jstore, jax_workload_pods(op), batch,
                                        turned_j))
    tstore = w.store()
    sched = BatchScheduler(w.node_infos(), caps=Capacities(**caps), device="cpu", client=tstore)
    placed_t = sched.schedule(w.init_pod_list())
    placed_t.update(sched.schedule(w.measured_pod_list()))
    return placed_j, jstore, turned_j, placed_t, tstore, sched


def claim_allocations(store) -> dict:
    """claim key -> (allocated node, reserved-for pod keys)."""
    return {k: (c.allocated_node, c.reserved_for) for k, c in store.resource_claims.items()}


# ----------------------------------------------------------------- preemption


def preempt_cluster_spec(n_nodes: int, seed: int, prios, max_pods: int = 5) -> list:
    """cluster_spec's nodes (taints, an unschedulable node, images), each
    holding 1 to ``max_pods`` pods with app=a|b|c labels, priorities drawn
    from ``prios``, start times, host ports, and one in nine terminating."""
    rng = np.random.RandomState(seed)
    nodes = cluster_spec(n_nodes, seed)
    for i, d in enumerate(nodes):
        d["existing"] = [{
            "name": f"old-{i}-{j}",
            "cpu": f"{int(rng.choice([250, 500, 900, 1500]))}m",
            "mem": f"{int(rng.choice([128, 512, 1024]))}Mi",
            "port": int(rng.choice([0, 0, 0, 8080, 9090])),
            "priority": int(prios[rng.randint(len(prios))]),
            "labels": {"app": "abc"[rng.randint(3)]},
            "start": float(rng.randint(0, 4)),
            "terminating": rng.randint(9) == 0,
        } for j in range(rng.randint(1, max_pods + 1))]
    return nodes


def preemptor_spec(n_pods: int, seed: int, prios) -> list:
    """pods_spec's pods (selectors, affinity, tolerations, ports, images)
    at priorities drawn from ``prios``, every fifth with PreemptionPolicy
    Never."""
    rng = np.random.RandomState(seed)
    pods = pods_spec(n_pods, seed)
    for i, d in enumerate(pods):
        d["priority"] = int(prios[rng.randint(len(prios))])
        d["never"] = i % 5 == 4
    return pods


def build_preemptors(api, spec: list) -> list:
    pods = build_pods(api, spec)
    for pod, d in zip(pods, spec):
        if d.get("never"):
            pod.spec.preemption_policy = "Never"
    return pods


def pdbs(api_types, spec) -> list:
    """PodDisruptionBudgets over app=<a> in namespace default, from
    (name, app, disruptions allowed) triples, in either package's types."""
    return [api_types.PodDisruptionBudget(
        meta=api_types.ObjectMeta(name=name, namespace="default"),
        selector=api_types.LabelSelector(match_labels={"app": app}),
        disruptions_allowed=allowed) for name, app, allowed in spec]


class JaxPreemptClient:
    """The client of a bare JAX Framework for preemption: reads go to a JAX
    ClusterStore; pod deletions (victim key -> the preemptor being
    evaluated, first one kept), nominations and cleared nominations are
    recorded, the nominations also written into the pods' status."""

    def __init__(self, store, pods_by_key: dict, pdb_list=()):
        self.store = store
        self.pods = pods_by_key
        self.pdbs = list(pdb_list)
        self.preemptor = None
        self.deleted = []
        self.preempted = {}
        self.nominations = {}
        self.cleared = []  # pod keys whose nomination was cleared, in order

    def __getattr__(self, name):
        return getattr(self.store, name)

    def list_pdbs(self):
        return list(self.pdbs)

    def delete_pod(self, key):
        self.deleted.append(key)
        self.preempted.setdefault(key, self.preemptor)

    def update_pod_nominated_node(self, key, node):
        pod = self.pods.get(key)
        if pod is not None:
            pod.status.nominated_node_name = node
        if node:
            self.nominations[key] = node
        else:
            self.nominations.pop(key, None)
            self.cleared.append(key)


def jax_framework(infos_fn, client):
    """A bare JAX Framework over the NodeInfos ``infos_fn`` lists, and its
    DefaultPreemption plugin."""
    from kubernetes_tpu.framework.runtime import Framework

    fwk = Framework({"snapshot_fn": infos_fn, "client": client,
                     "ns_labels_fn": lambda ns: {}})
    return fwk, fwk.plugin("DefaultPreemption")


def jax_preempt_loop(ds, fn, infos: dict, client, fwk, plugin, pods, batch,
                     turned_away: dict) -> dict:
    """The JAX batched path with preemption, in the order of
    ``TPUScheduler._commit_batch`` and ``_handle_scheduling_failure``: per
    batch the program (with the volume screen and the claim mask), the
    packed read, the carry adopted; if a pod failed, the host shortcut
    (no failed pod outranks a bound pod) or ``_refresh_class_prio`` and
    ``screen_prefix`` on the adopted carry; then, in batch order, each
    failed pod's ``DefaultPreemption.post_filter`` with its hints against
    the NodeInfos as they stood before the batch (a nomination enters the
    nominator and the pod's status at once); the commit checks and binds
    of ``jax_masked_loop`` (a bound pod's nomination cleared, as
    ``commit_plane.py:187``); and last the victims taken off their nodes,
    each once. Returns the placements."""
    import jax

    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu.backend.claim_mask import ClaimMaskBuilder
    from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.ops.preempt import screen_prefix
    from kubernetes_tpu.ops.volume_mask import VolumeMaskBuilder
    import types

    vmb, cmb = VolumeMaskBuilder(client.store), ClaimMaskBuilder(client.store)
    check = jax_commit_checks(client.store, infos)
    diag = types.SimpleNamespace(_SHARED_STATUSES=TPUScheduler._SHARED_STATUSES)
    out = {}
    for s in range(0, len(pods), batch):
        chunk = pods[s:s + batch]
        qps = [type("QP", (), {"pod": p})() for p in chunk]
        ds.sync(SnapshotShim(infos.values()))
        pb, et = ds.encoder.encode_pods(chunk)
        tb = ds.sig_table.encode_topo(chunk)
        mode, vd, host_key = jax_topo_mode_info(ds)
        extra = vmb.build(qps, JaxSnapshot(infos), ds.encoder, ds.caps.nodes, batch)
        dra_mask = cmb.build(qps, ds, batch)
        res = fn(pb, et, ds.nt, ds.tc, tb, jax.random.PRNGKey(0),
                 topo_enabled=ds.topo_enabled, topo_mode=mode, vd_override=vd,
                 host_key=host_key, ports_enabled=ds.encoder.last_has_ports,
                 extra_mask=None if extra is None else jax.numpy.asarray(extra),
                 dra_mask=dra_mask)
        node_idx, ff = jbatch.unpack_result_block(res.packed, ds.caps.nodes)[:2]
        ds.adopt_device(res)
        ds.adopt_commits(res, ds.encoder.last_host_pb, node_idx)
        names = ds.slot_to_name()
        failed = node_idx[:len(chunk)] < 0
        if failed.any():
            bound = [p.spec.priority for ni in infos.values() for p in ni.pods]
            min_prio = min(bound) if bound else None
            if min_prio is None or all(chunk[i].spec.priority <= min_prio
                                       for i in np.flatnonzero(failed)):
                screen = np.zeros((len(chunk), ds.caps.nodes), bool)
                best = np.full(len(chunk), -1, np.int32)
            else:
                ds._refresh_class_prio()
                pres = screen_prefix(pb, ds.nt, res.static_masks, failed)
                screen, best = np.asarray(pres.screen), np.asarray(pres.best)
            slot_of = dict(ds.encoder.node_slots)
            for i in np.flatnonzero(failed):
                pod = chunk[i]
                d = TPUScheduler._diagnose(diag, ff[i], names)
                if not d.node_to_status:
                    continue
                state = CycleState()
                best_name = names.get(int(best[i])) if best[i] >= 0 else None
                state.write(plugin.HINTS_KEY, (screen[i], slot_of, best_name))
                client.preemptor = pod.key()
                node, st = plugin.post_filter(state, pod, d.node_to_status)
                if st.is_success() and node:
                    fwk.nominator.add_nominated_pod(pod, node)
                    client.update_pod_nominated_node(pod.key(), node)
        rejected = set()
        for i, pod in enumerate(chunk):
            if node_idx[i] < 0:
                out[pod.key()] = None
                continue
            name = names[int(node_idx[i])]
            if pod.spec.volumes or pod.spec.resource_claims:
                verdict = check(pod, name)
                if verdict is not None:
                    turned_away[pod.key()] = verdict[0]
                    out[pod.key()] = None
                    rejected.add(name)
                    continue
            turned_away.pop(pod.key(), None)
            bound_pod = pod.clone()
            bound_pod.spec.node_name = name
            infos[name].add_pod(bound_pod)
            out[pod.key()] = name
            fwk.nominator.delete_nominated_pod_if_exists(pod)
            client.nominations.pop(pod.key(), None)
        for name in rejected:
            ds._uploaded_gen.pop(name, None)  # TPUScheduler._invalidate_device_row
        if client.deleted:
            where = {p.key(): ni for ni in infos.values() for p in ni.pods}
            for key in client.deleted:
                ni = where.pop(key, None)
                if ni is not None:
                    ni.remove_pod(next(p for p in ni.pods if p.key() == key))
            client.deleted.clear()
    return out


# small versions of the preemption workloads: (node count, victims, measured
# preemptors, batch); each also has its 8 warm preemptors
PREEMPT_WORKLOADS = {
    "preemption_basic": (48, 192, 48, 16),
    "preemption_pvs": (48, 192, 48, 16),
}


def run_preempt_workload_both(name: str):
    """A small PREEMPT_WORKLOADS workload through ``jax_preempt_loop`` and
    through the port's BatchScheduler on the CPU (``run_with_preemption``):
    the ops in order, then the nominated pods resubmitted in order until
    none is left. Returns two dicts, JAX's and the port's, of: placed,
    rounds (the nominations before each round), preempted (victim key ->
    preemptor key), fallback (pod keys), and the port's BatchScheduler."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu.perf import workloads as jworkloads
    from kubernetes_tpu.perf.harness import _node_wrapper
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities
    from kubernetes_tpu_torch.perf import workloads

    n, n_init, n_meas, batch = PREEMPT_WORKLOADS[name]
    w = getattr(workloads, name)(nodes=n, init_pods=n_init, measured=n_meas)
    all_ops = getattr(jworkloads, name)(nodes=n, init_pods=n_init, measured=n_meas)["ops"]
    jops = [op for op in all_ops if op["opcode"] in ("createPods", "measurePods")]
    caps = dict(nodes=128, pods=batch, value_words=32)
    jinfos = {}
    for i in range(n):
        ni = jax_api().NodeInfo(_node_wrapper(i, all_ops[0]).obj())
        jinfos[ni.node.meta.name] = ni
    jstore = ClusterStore()
    ops = []
    for op in jops:
        populate_jax_store(jstore, op)
        ops.append(jax_workload_pods(op))
    all_pods = [p for op in ops for p in op]
    client = JaxPreemptClient(jstore, {p.key(): p for p in all_pods})
    fwk, plugin = jax_framework(lambda: list(jinfos.values()), client)
    ds = JDeviceState(JCaps(**caps))
    fn = jbatch.build_schedule_batch_fn()
    placed_j, turned_j, rounds_j = {}, {}, []
    for op in ops:
        placed_j.update(jax_preempt_loop(ds, fn, jinfos, client, fwk, plugin, op, batch,
                                         turned_j))
    while client.nominations and len(rounds_j) < workloads.MAX_PREEMPTION_ROUNDS:
        rounds_j.append(dict(client.nominations))
        again = [p for p in all_pods if p.key() in client.nominations]
        placed_j.update(jax_preempt_loop(ds, fn, jinfos, client, fwk, plugin, again, batch,
                                         turned_j))
    jax_out = {"placed": placed_j, "rounds": rounds_j, "preempted": client.preempted,
               "fallback": sorted(k for k, v in turned_j.items() if v == "fallback")}

    sched = BatchScheduler(w.node_infos(), caps=Capacities(**caps), device="cpu",
                           client=w.store())
    placed_t, rounds_t = workloads.run_with_preemption(sched, w)
    port_out = {"placed": placed_t, "rounds": rounds_t, "preempted": sched.preempted,
                "fallback": sorted(sched.fallback)}
    return jax_out, port_out, sched


# ----------------------------------------------------------------- gangs and slices


class Counts:
    """Stands in for a metrics counter: ``inc(label)`` counts per label."""

    def __init__(self):
        self.by_label = {}

    def inc(self, label):
        self.by_label[label] = self.by_label.get(label, 0) + 1


def jax_coscheduling(store, now_fn=None):
    """The JAX Coscheduling plugin over a JAX ClusterStore, its rejections
    counted in ``plugin.metrics.gangs_rejected.by_label``."""
    import types

    from kubernetes_tpu.framework.plugins.coscheduling import Coscheduling

    return Coscheduling(client=store, now_fn=now_fn,
                        metrics=types.SimpleNamespace(gangs_rejected=Counts()))


def _gang_index(groups: list):
    """The JAX scheduler's bucketed member index (``_judge_gangs``)."""
    from kubernetes_tpu.backend.claim_mask import _bucket

    member_idx = np.full((_bucket(len(groups), floor=2),
                          _bucket(max(len(g) for g in groups), floor=2)), -1, np.int32)
    for g, rows in enumerate(groups):
        member_idx[g, :len(rows)] = rows
    return member_idx, member_idx >= 0


def jax_gang_loop(ds, fn, infos: dict, store, plugin, pods, batch, gang_rejected: dict,
                  trace=None) -> dict:
    """The JAX batched path with gangs, in ``TPUScheduler``'s order: per
    batch Coscheduling's PreFilter (a member that fails takes no row and
    lands in ``gang_rejected`` with its reason), the slice member index
    (``_slice_batch_args``), the batch program, the packed read and the
    adopted carry; slice gangs judged from the slice words and node_idx
    (``_judge_slice_gangs``), flat gangs through ``gang_verdicts``
    (``_judge_gangs``), ``reject_gang`` per rejected gang; then the binds in
    batch order (written to the store, so the plugin counts them), the
    placed members of rejected gangs surrendered
    (``_invalidate_device_row``), and ``post_bind_batch``. ``trace``, a
    list, gets per batch the device's requested and sel_counts as the
    program read them and the flat gangs' verdicts. Returns the
    placements."""
    import jax

    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins.coscheduling import pod_group_key
    from kubernetes_tpu.ops.slice import is_slice_pod

    out = {}
    for s in range(0, len(pods), batch):
        chunk = []
        for pod in pods[s:s + batch]:
            _, st = plugin.pre_filter(CycleState(), pod)
            if st.is_success():
                chunk.append(pod)
            else:
                out[pod.key()] = None
                gang_rejected[pod.key()] = st.reasons[0]
        if not chunk:
            continue
        qps = [type("QP", (), {"pod": p})() for p in chunk]
        ds.sync(SnapshotShim(infos.values()))
        pb, et = ds.encoder.encode_pods(chunk)
        tb = ds.sig_table.encode_topo(chunk)
        mode, vd, host_key = jax_topo_mode_info(ds)
        slice_members, slice_grid = TPUScheduler._slice_batch_args(None, qps, ds)
        # copies: on the CPU np.asarray may view a buffer the program donates
        step = {"requested": np.array(ds.nt.requested, copy=True),
                "sel_counts": np.array(ds.tc.sel_counts, copy=True), "mode": mode,
                "verdicts": None}
        res = fn(pb, et, ds.nt, ds.tc, tb, jax.random.PRNGKey(0),
                 topo_enabled=ds.topo_enabled, topo_mode=mode, vd_override=vd,
                 host_key=host_key, ports_enabled=ds.encoder.last_has_ports,
                 slice_members=slice_members, slice_grid=slice_grid)
        node_idx, _ff, slice_words, _ = jbatch.unpack_result_block(res.packed, ds.caps.nodes)
        ds.adopt_device(res)
        ds.adopt_commits(res, ds.encoder.last_host_pb, node_idx)
        names = ds.slot_to_name()
        flat, slices = {}, {}
        for i, pod in enumerate(chunk):
            gkey = pod_group_key(pod)
            if gkey is not None:
                (slices if is_slice_pod(pod) else flat).setdefault(gkey, []).append(i)
        rejected = {}
        if flat:
            member_idx, member_valid = _gang_index(list(flat.values()))
            verdicts = [np.asarray(a) for a in jbatch.gang_verdicts(
                res.node_idx, res.first_fail, member_idx, member_valid)]
            step["verdicts"] = verdicts
            for g, gkey in enumerate(flat):
                if verdicts[0][g]:
                    continue
                reason = "incomplete" if verdicts[1][g] else "infeasible"
                rejected.update(dict.fromkeys(flat[gkey], reason))
                plugin.reject_gang(gkey, reason)
        for gkey, idxs in slices.items():
            if all(node_idx[i] >= 0 for i in idxs):
                continue
            plan_ok = all(int(slice_words[i]) & jbatch.SLICE_PLAN_OK_BIT for i in idxs)
            reason = "incomplete" if plan_ok else "infeasible"
            rejected.update(dict.fromkeys(idxs, reason))
            plugin.reject_gang(gkey, reason)
        surrendered, items = set(), []
        for i, pod in enumerate(chunk):
            slot = int(node_idx[i])
            if i in rejected:
                out[pod.key()] = None
                gang_rejected[pod.key()] = rejected[i]
                if slot >= 0:
                    surrendered.add(names[slot])
                continue
            if slot < 0:
                out[pod.key()] = None
                continue
            name = names[slot]
            bound = pod.clone()
            bound.spec.node_name = name
            infos[name].add_pod(bound)
            if pod.key() in store.pods:
                store.pods[pod.key()] = bound
            out[pod.key()] = name
            gang_rejected.pop(pod.key(), None)
            items.append((None, pod, name))
        for name in surrendered:
            ds._uploaded_gen.pop(name, None)  # TPUScheduler._invalidate_device_row
        plugin.post_bind_batch(items)
        if trace is not None:
            trace.append(step)
    return out


# small versions of the gang workloads: (node count, kwargs, batch)
GANG_WORKLOADS = {
    "scheduling_gangs": (48, dict(init_gangs=1, measured_gangs=2), 80),
    "scheduling_slices": (32, dict(slots=8, init_gangs=1, measured_small=2, measured_medium=1,
                                   measured_large=0), 16),
}


def gang_caps(w, n_nodes: int, batch: int) -> dict:
    """The Capacities fields both packages run a small gang workload with:
    the workload's own, at 128 node slots and ``batch`` pods."""
    caps = dataclasses.asdict(w.caps())
    caps.update(nodes=128, pods=batch, value_words=32,
                superpods=max(caps["superpods"], -(-128 // caps["sp_slots"])))
    return caps


def jax_gang_pods(op: dict) -> list:
    """One gang op's pods, named ``<prefix>-<j>`` and grouped by the op's
    own ordinal, as the JAX harness groups them."""
    from kubernetes_tpu.perf.harness import _pod_wrapper

    return [_pod_wrapper(j, op["prefix"], dict(op, _gang_ordinal=j)).obj()
            for j in range(op["count"])]


def run_gang_workload_both(name: str):
    """A small GANG_WORKLOADS workload through ``jax_gang_loop`` and the
    port's BatchScheduler on the CPU, both under the current KTPU_SPEC:
    the init ops' pods in one call, then the measured ops' pods. Returns
    (JAX placements, JAX gang_rejected, JAX store, JAX trace, port
    placements, port store, the port's BatchScheduler)."""
    from kubernetes_tpu.api.types import ObjectMeta as JMeta, PodGroup as JPodGroup
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu.perf import workloads as jworkloads
    from kubernetes_tpu.perf.harness import _node_wrapper
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities
    from kubernetes_tpu_torch.perf import workloads

    n, kw, batch = GANG_WORKLOADS[name]
    w = getattr(workloads, name)(nodes=n, **kw)
    all_ops = getattr(jworkloads, name)(nodes=n, **kw)["ops"]
    caps = gang_caps(w, n, batch)
    jinfos = {}
    for i in range(n):
        ni = jax_api().NodeInfo(_node_wrapper(i, all_ops[0]).obj())
        jinfos[ni.node.meta.name] = ni
    jstore = ClusterStore()
    phases = ([], [])  # init pods, measured pods
    for op in all_ops:
        if op["opcode"] not in ("createPods", "measurePods"):
            continue
        pods = jax_gang_pods(op)
        for pod in pods:
            jstore.create_pod(pod)
        for g in range(-(-op["count"] // op["gang_size"])):
            jstore.create_object("PodGroup", JPodGroup(
                meta=JMeta(name=f"{op['prefix']}-pg{g}", namespace="default"),
                min_member=op["gang_size"]))
        phases[op["opcode"] == "measurePods"].extend(pods)
    plugin = jax_coscheduling(jstore)
    ds = JDeviceState(JCaps(**caps))
    fn = jbatch.build_schedule_batch_fn()
    placed_j, rejected_j, trace = {}, {}, []
    for pods in phases:
        placed_j.update(jax_gang_loop(ds, fn, jinfos, jstore, plugin, pods, batch, rejected_j,
                                      trace))
    tstore = w.store()
    sched = BatchScheduler(w.node_infos(), caps=Capacities(**caps), device="cpu", client=tstore)
    placed_t = sched.schedule(w.init_pod_list())
    placed_t.update(sched.schedule(w.measured_pod_list()))
    return placed_j, rejected_j, jstore, trace, placed_t, tstore, sched


def pod_group_status(store) -> dict:
    """PodGroup key -> (phase, scheduled) in either package's store."""
    groups = getattr(store, "pod_groups", None)
    if groups is None:
        groups = {g.meta.key(): g for g in store.list_objects("PodGroup")[0]}
    return {k: (g.phase, g.scheduled) for k, g in groups.items()}


# ----------------------------------------------------------------- quota and preemption of every batch


def to_jax(obj):
    """A port API object rebuilt as the JAX package's (dataclasses by class
    name from ``kubernetes_tpu.api.types``, then ``apiserver.auth`` and
    ``apiserver.admission``, where the JAX package keeps the RBAC objects
    and the webhook configurations; field by field; memoized caches are not
    copied)."""
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu.apiserver import admission as jadmission
    from kubernetes_tpu.apiserver import auth as jauth

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        cls = next(getattr(m, name) for m in (jtypes, jauth, jadmission) if hasattr(m, name))
        return cls(**{f.name: to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_jax(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_jax(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_jax(v) for k, v in obj.items()}
    if isinstance(obj, (set, frozenset)):
        return type(obj)(to_jax(v) for v in obj)
    return obj


class JaxEnv:
    """The JAX side of ``BatchScheduler`` for the quota and preemption
    paths: a JAX DeviceState and batch program, NodeInfos, a JAX
    ClusterStore behind ``JaxPreemptClient`` (``pods``: every pod created
    and not deleted, bound ones as bound), and one bare JAX Framework whose
    QuotaAdmission is the ledger, whose Coscheduling gates gangs (on
    ``clock``) and whose DefaultPreemption runs the PostFilters. The result
    dicts have the port's names."""

    def __init__(self, node_infos, caps: dict, clock=None, plugin_args=None):
        from kubernetes_tpu.apiserver.store import ClusterStore
        from kubernetes_tpu.backend import batch as jbatch
        from kubernetes_tpu.backend.claim_mask import ClaimMaskBuilder
        from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
        from kubernetes_tpu.framework.runtime import Framework
        from kubernetes_tpu.ops.schema import Capacities as JCaps
        from kubernetes_tpu.ops.volume_mask import VolumeMaskBuilder

        self.infos = {ni.node.meta.name: ni for ni in node_infos}
        self.store = ClusterStore()
        self.client = JaxPreemptClient(self.store, {})
        for ni in self.infos.values():
            for p in ni.pods:
                self.client.pods[p.key()] = p
        self.clock = clock
        handle = {"snapshot_fn": lambda: list(self.infos.values()), "client": self.client,
                  "ns_labels_fn": lambda ns: {}}
        if clock is not None:
            handle["now_fn"] = clock
        self.fwk = Framework(handle, plugin_args=plugin_args)
        self.plugin = self.fwk.plugin("DefaultPreemption")
        self.quota = self.fwk.plugin("QuotaAdmission")
        self.cos = self.fwk.plugin("Coscheduling")
        self.batch = caps["pods"]
        self.ds = JDeviceState(JCaps(**caps))
        self.fn = jbatch.build_schedule_batch_fn()
        self.vmb, self.cmb = VolumeMaskBuilder(self.store), ClaimMaskBuilder(self.store)
        self.retry, self.fallback, self.quota_rejected, self.gang_rejected = {}, {}, {}, {}
        self.flagged, self.gated = {}, {}  # namespace -> pods
        self.modes = []

    @property
    def nominated(self):
        return self.client.nominations

    @property
    def preempted(self):
        return self.client.preempted

    def add_node(self, ni) -> None:
        self.infos[ni.node.meta.name] = ni

    def add_pods(self, pods) -> None:
        for p in pods:
            self.client.pods[p.key()] = p

    def delete_pod(self, key: str) -> None:
        """``BatchScheduler.delete_pod``: off its node, out of the store,
        its quota released."""
        for ni in self.infos.values():
            pod = next((p for p in ni.pods if p.key() == key), None)
            if pod is not None:
                ni.remove_pod(pod)
                self.client.pods.pop(key, None)
                self.quota.pod_deleted(pod)
                return

    def _precheck(self, pod, name):
        """The commit checks before Reserve: (CycleState, None) or (None,
        reasons) for the fallback."""
        from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
        from kubernetes_tpu.framework.interface import CycleState
        import types

        state = CycleState()
        plugins = [self.fwk.plugin(n) for n in (
            ("VolumeRestrictions", "VolumeBinding") if pod.spec.volumes else ())]
        plugins.append(self.fwk.plugin("DynamicResources"))
        for plugin in plugins:
            _, st = plugin.pre_filter(state, pod)
            if not st.is_success():
                return None, st.reasons
        if pod.spec.volumes:
            fwk = types.SimpleNamespace(points={"filter": [
                (self.fwk.plugin(n), 0) for n in ("VolumeRestrictions", "NodeVolumeLimits",
                                                  "VolumeBinding", "VolumeZone")]})
            shim = types.SimpleNamespace(snapshot=JaxSnapshot(self.infos),
                                         _VOLUME_FILTERS=TPUScheduler._VOLUME_FILTERS)
            st = TPUScheduler._verify_volumes_on_node(shim, fwk, state, pod, name)
            if not st.is_success():
                return None, st.reasons
        return state, None

    def schedule(self, chunk) -> dict:
        """One batch (``BatchScheduler._schedule_batch``'s order with the
        JAX programs and plugins)."""
        import types

        import jax

        from kubernetes_tpu.backend import batch as jbatch
        from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
        from kubernetes_tpu.framework.interface import CycleState
        from kubernetes_tpu.framework.plugins.coscheduling import pod_group_key
        from kubernetes_tpu.framework.plugins.quota import ERR_REASON_QUOTA_EXCEEDED
        from kubernetes_tpu.ops.preempt import screen_prefix
        from kubernetes_tpu.ops.quota import (QUOTA_OK_BIT, QUOTA_SCREEN_BIT,
                                              build_quota_batch_args)
        from kubernetes_tpu.ops.slice import is_slice_pod

        ds, infos, client = self.ds, self.infos, self.client
        out = {}
        ds.sync(SnapshotShim(infos.values()))
        pods = []
        for pod in chunk:
            out[pod.key()] = None
            _, st = self.quota.pre_filter(CycleState(), pod)
            if not st.is_success():
                self.quota_rejected[pod.key()] = st.reasons[0]
                ns = pod.meta.namespace
                self.gated[ns] = self.gated.get(ns, 0) + 1
                continue
            _, st = self.cos.pre_filter(CycleState(), pod)
            if not st.is_success():
                self.gang_rejected[pod.key()] = st.reasons[0]
                continue
            pods.append(pod)
        if not pods:
            return out
        qps = [types.SimpleNamespace(pod=p) for p in pods]
        pb, et = ds.encoder.encode_pods(pods)
        tb = ds.sig_table.encode_topo(pods)
        mode, vd, host_key = jax_topo_mode_info(ds)
        extra = self.vmb.build(qps, JaxSnapshot(infos), ds.encoder, ds.caps.nodes, self.batch)
        dra_mask = self.cmb.build(qps, ds, self.batch)
        slice_members, slice_grid = TPUScheduler._slice_batch_args(None, qps, ds)
        table = self.quota.device_quota_table()
        ns_idx = req = None
        if table or ds.nsq_slots:
            ns_idx, req = build_quota_batch_args(pods, ds, table=table, pad_to=self.batch)
        res = self.fn(pb, et, ds.nt, ds.tc, tb, jax.random.PRNGKey(0),
                      topo_enabled=ds.topo_enabled, topo_mode=mode, vd_override=vd,
                      host_key=host_key, ports_enabled=ds.encoder.last_has_ports,
                      extra_mask=None if extra is None else jax.numpy.asarray(extra),
                      dra_mask=dra_mask, slice_members=slice_members, slice_grid=slice_grid,
                      quota_ns=ns_idx, quota_req=req,
                      quota_used=ds.nsq_used if ns_idx is not None else None,
                      quota_limit=ds.nsq_limit if ns_idx is not None else None)
        self.modes.append(mode)
        node_idx, ff, slice_words, quota_words = jbatch.unpack_result_block(
            res.packed, ds.caps.nodes, quota_col=ns_idx is not None)
        node_idx = np.array(node_idx[:len(pods)])
        ds.adopt_device(res)
        ds.adopt_commits(res, ds.encoder.last_host_pb, np.asarray(
            jbatch.unpack_result_block(res.packed, ds.caps.nodes,
                                       quota_col=ns_idx is not None)[0]))
        names = ds.slot_to_name()
        flagged = set()
        if quota_words is not None:
            for i in range(len(pods)):
                w = int(quota_words[i])
                if node_idx[i] >= 0 and w & QUOTA_SCREEN_BIT and not w & QUOTA_OK_BIT:
                    flagged.add(i)
                    ns = pods[i].meta.namespace
                    self.flagged[ns] = self.flagged.get(ns, 0) + 1
        flat, slices = {}, {}
        for i, pod in enumerate(pods):
            gkey = pod_group_key(pod)
            if gkey is not None:
                (slices if is_slice_pod(pod) else flat).setdefault(gkey, []).append(i)
        reasons = {}
        if flat:
            member_idx, member_valid = _gang_index(list(flat.values()))
            verdicts = [np.asarray(a) for a in jbatch.gang_verdicts(
                res.node_idx, res.first_fail, member_idx, member_valid)]
            for g, gkey in enumerate(flat):
                if not verdicts[0][g]:
                    reasons[gkey] = "incomplete" if verdicts[1][g] else "infeasible"
        for gkey, idxs in slices.items():
            if not all(node_idx[i] >= 0 for i in idxs):
                plan_ok = all(int(slice_words[i]) & jbatch.SLICE_PLAN_OK_BIT for i in idxs)
                reasons[gkey] = "incomplete" if plan_ok else "infeasible"
        for gkey, idxs in {**flat, **slices}.items():
            if gkey not in reasons and any(i in flagged for i in idxs):
                reasons[gkey] = "incomplete"
        gang_rows = {}
        for gkey, reason in reasons.items():
            self.cos.reject_gang(gkey, reason)
            for i in flat.get(gkey) or slices[gkey]:
                gang_rows[i] = reason
        failed = node_idx < 0
        evicted_before = len(client.deleted)
        if failed.any() or gang_rows:
            screen = best = None
            if failed.any():
                bound = [p.spec.priority for ni in infos.values() for p in ni.pods]
                min_prio = min(bound) if bound else None
                if min_prio is None or all(pods[i].spec.priority <= min_prio
                                           for i in np.flatnonzero(failed)):
                    screen = np.zeros((len(pods), ds.caps.nodes), bool)
                    best = np.full(len(pods), -1, np.int32)
                else:
                    ds._refresh_class_prio()
                    fpad = np.zeros(pb.capacity, bool)
                    fpad[:len(pods)] = failed
                    pres = screen_prefix(pb, ds.nt, res.static_masks, fpad)
                    screen, best = np.asarray(pres.screen), np.asarray(pres.best)
            slot_of = dict(ds.encoder.node_slots)
            diag = types.SimpleNamespace(_SHARED_STATUSES=TPUScheduler._SHARED_STATUSES)
            for i in sorted(set(np.flatnonzero(failed).tolist()) | set(gang_rows)):
                pod = pods[i]
                if i in gang_rows and not failed[i]:
                    continue
                d = TPUScheduler._diagnose(diag, ff[i], names)
                if not d.node_to_status:
                    continue
                state = CycleState()
                if i not in gang_rows:
                    best_name = names.get(int(best[i])) if best[i] >= 0 else None
                    state.write(self.plugin.HINTS_KEY, (screen[i], slot_of, best_name))
                client.preemptor = pod.key()
                node, st = self.plugin.post_filter(state, pod, d.node_to_status)
                if st.is_success() and node:
                    self.fwk.nominator.add_nominated_pod(pod, node)
                    client.update_pod_nominated_node(pod.key(), node)
        for key in client.deleted[evicted_before:]:
            victim = client.pods.get(key)
            if victim is not None:
                self.quota.pod_deleted(victim)
        # Reserve runs over the whole batch before any failed pod is
        # unreserved, as the JAX commit plane's batched Reserve does
        # (commit_plane.py ``_run_reserve_permit``): ``held`` keeps the
        # quota charge of a pod DynamicResources refused until then
        surrender, held, gang_bound = set(), [], {}
        for i, pod in enumerate(pods):
            key, slot = pod.key(), int(node_idx[i])
            if i in gang_rows:
                self.gang_rejected[key] = gang_rows[i]
                if slot >= 0:
                    surrender.add(names[slot])
                continue
            if slot < 0:
                continue
            name = names[slot]
            if i in flagged:
                self.quota_rejected[key] = (f'{ERR_REASON_QUOTA_EXCEEDED}: namespace '
                                            f'"{pod.meta.namespace}" over quota at decision '
                                            'time (device screen)')
                surrender.add(name)
                continue
            gkey = pod_group_key(pod)
            state = CycleState()
            if pod.spec.volumes or pod.spec.resource_claims:
                state, why = self._precheck(pod, name)
                if why is not None:
                    self.fallback[key] = why[0]
                    surrender.add(name)
                    continue
            st = self.quota.reserve(state, pod, name)
            if not st.is_success():
                self.retry[key] = st.reasons[0]
                surrender.add(name)
                continue
            if pod.spec.resource_claims:
                st = self.fwk.plugin("DynamicResources").reserve(state, pod, name)
                if not st.is_success():
                    self.retry[key] = st.reasons[0]
                    surrender.add(name)
                    held.append(pod)
                    continue
            for d in (self.retry, self.fallback, self.quota_rejected):
                d.pop(key, None)
            bound_pod = pod.clone()
            bound_pod.spec.node_name = name
            infos[name].add_pod(bound_pod)
            client.pods[key] = bound_pod
            out[key] = name
            self.fwk.nominator.delete_nominated_pod_if_exists(pod)
            client.nominations.pop(key, None)
            if gkey is not None:
                gang_bound.setdefault(gkey, []).append(bound_pod)
        for pod in held:
            self.quota.unreserve(CycleState(), pod, "")
        for gkey, members in gang_bound.items():
            for p in members:
                self.gang_rejected.pop(p.key(), None)
        for name in surrender:
            ds._uploaded_gen.pop(name, None)  # TPUScheduler._invalidate_device_row
        if gang_bound:
            self.cos.post_bind_batch([(None, p, p.spec.node_name)
                                      for m in gang_bound.values() for p in m])
        where = {p.key(): ni for ni in infos.values() for p in ni.pods}
        for key in client.deleted[evicted_before:]:
            ni = where.pop(key, None)
            if ni is not None:
                ni.remove_pod(next(p for p in ni.pods if p.key() == key))
                client.pods.pop(key, None)
        return out


def jax_run_soak(env: "JaxEnv", w, jax_pods_of) -> dict:
    """``workloads.run_soak`` over a ``JaxEnv``: the same rounds, batches,
    resubmissions and churn, with the JAX pods ``jax_pods_of(port pods)``
    gives and the JAX ledger's objects in the env's store."""
    from kubernetes_tpu_torch.perf import workloads

    for q in w.quotas():
        env.store.create_object("SchedulingQuota", to_jax(q))
    tenants = [ns for ns, _w in workloads.SOAK_TENANTS]
    counter = 0
    pending = []
    soak_bound = {ns: [] for ns in tenants}
    placed_all, bound = {}, dict.fromkeys(tenants, 0)
    oversub = passes = 0
    rounds = []
    for r in range(w.rounds):
        tpods = w.arrivals(r, counter)
        counter += len(tpods)
        tstore = workloads.Store()
        w.populate(tstore, tpods)
        for kind, m in (("PodGroup", tstore.pod_groups), ("ResourceClaim", tstore.resource_claims),
                        ("ResourceClass", tstore.resource_classes)):
            for obj in m.values():
                key = obj.meta.name if kind == "ResourceClass" else obj.meta.key()
                if env.store.get_object(kind, key) is None:
                    env.store.create_object(kind, to_jax(obj))
        arrivals = jax_pods_of(tpods)
        env.add_pods(arrivals)
        pending += arrivals
        submit = list(pending)
        nominations = {}
        while submit:
            placed = {}
            for chunk in workloads.soak_chunks(submit, env.batch):
                placed.update(env.schedule(chunk))
            passes += 1
            oversub += workloads.quota_oversubscription(env.quota, tenants)
            nominations.update(env.nominated)
            newly = [p for p in submit if placed.get(p.key())]
            for p in newly:
                placed_all[p.key()] = placed[p.key()]
                soak_bound[p.meta.namespace].append(p.key())
                bound[p.meta.namespace] += 1
            pending = [p for p in pending if not placed.get(p.key())]
            if not newly:
                break
            again = set(env.retry) | set(env.quota_rejected) | set(env.nominated)
            submit = [p for p in pending if p.key() in again]
        env.clock.advance(workloads.SOAK_CYCLES_PER_ROUND * workloads.SOAK_TICK_S)
        for ns in tenants:
            keys = soak_bound[ns]
            n = int(len(keys) * workloads.SOAK_CHURN_FRAC)
            for key in keys[:n]:
                env.delete_pod(key)
            soak_bound[ns] = keys[n:]
        oversub += workloads.quota_oversubscription(env.quota, tenants)
        rounds.append({"usage": {ns: env.quota.usage(ns) for ns in tenants},
                       "nominations": nominations})
    return {"placed": placed_all, "bound": bound, "oversubscription": oversub,
            "passes": passes, "rounds": rounds, "pending": [p.key() for p in pending]}


def run_soak_both(nodes=60, scale=4, rounds=4, cohort="", gangs=True):
    """A small SchedulingSoak through ``jax_run_soak`` and through the
    port's ``run_soak`` on the CPU (under the current KTPU_SPEC). Returns
    (JAX result, JAX env, port result, the port's BatchScheduler)."""
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_soak(nodes=nodes, scale=scale, rounds=rounds, cohort=cohort,
                                  gangs=gangs)
    caps = dataclasses.asdict(w.caps())
    caps.update(pods=32)
    sched = BatchScheduler(w.node_infos(), caps=workloads.Capacities(**caps), device="cpu",
                           client=w.store())
    port = workloads.run_soak(sched, w)
    env = JaxEnv([to_jax_node_info(ni) for ni in w.node_infos()], caps,
                 clock=workloads.FakeClock())
    jax_out = jax_run_soak(env, w, lambda pods: [to_jax(p) for p in pods])
    return jax_out, env, port, sched


def to_jax_node_info(ni):
    """A port NodeInfo rebuilt as a JAX one, its pods added in order."""
    jni = jax_api().NodeInfo(to_jax(ni.node))
    for p in ni.pods:
        jni.add_pod(to_jax(p))
    return jni


def copy_store_objects(tstore, jstore) -> None:
    """The port store's claim classes, claims, PodGroups, quotas and PDBs
    created again in a JAX store."""
    for kind, m in (("ResourceClass", tstore.resource_classes),
                    ("ResourceClaim", tstore.resource_claims),
                    ("PodGroup", tstore.pod_groups),
                    ("SchedulingQuota", tstore.scheduling_quotas)):
        for obj in m.values():
            key = obj.meta.name if kind == "ResourceClass" else obj.meta.key()
            if jstore.get_object(kind, key) is None:
                jstore.create_object(kind, to_jax(obj))


def jax_run_with_preemption(env: "JaxEnv", ops) -> tuple:
    """``workloads.run_with_preemption`` over a ``JaxEnv``: each op's pods
    in batches, then the nominated pods resubmitted in order until none is
    left. Returns (placements, the nominations before each round)."""
    from kubernetes_tpu_torch.perf import workloads

    placed = {}
    for op in ops:
        env.add_pods(op)
        for s in range(0, len(op), env.batch):
            placed.update(env.schedule(op[s:s + env.batch]))
    pods = [p for op in ops for p in op]
    rounds = []
    while env.nominated and len(rounds) < workloads.MAX_PREEMPTION_ROUNDS:
        rounds.append(dict(env.nominated))
        again = [p for p in pods if p.key() in env.nominated]
        for s in range(0, len(again), env.batch):
            placed.update(env.schedule(again[s:s + env.batch]))
    return placed, rounds


def run_preempt_all_both(nodes=48, init_pods=192, per_kind=16, batch=16):
    """A small PreemptionAll through ``jax_run_with_preemption`` and the
    port's ``run_with_preemption`` on the CPU (under the current
    KTPU_SPEC). Returns (JAX placements, JAX rounds, JAX env, port
    placements, port rounds, the port's BatchScheduler)."""
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.preemption_all(nodes=nodes, init_pods=init_pods, per_kind=per_kind)
    caps = dataclasses.asdict(w.caps())
    caps.update(nodes=128, pods=batch, value_words=32)
    tstore = w.store()
    sched = BatchScheduler(w.node_infos(), caps=workloads.Capacities(**caps), device="cpu",
                           client=tstore)
    env = JaxEnv([to_jax_node_info(ni) for ni in w.node_infos()], caps)
    copy_store_objects(w.store(), env.store)
    ops = [[to_jax(p) for p in op] for op in
           (w.init_pod_list(), w.warm_pod_list(), w.measured_pod_list())]
    placed_j, rounds_j = jax_run_with_preemption(env, ops)
    placed_t, rounds_t = workloads.run_with_preemption(sched, w)
    return placed_j, rounds_j, env, placed_t, rounds_t, sched


# ----------------------------------------------------------------- the scheduler loop


class LoopPair:
    """The same cluster in a JAX ClusterStore under the real JAX
    TPUScheduler and in the port's Store under the port's TPUScheduler
    (``device="cpu"``), each on its own FakeClock, both clocks starting
    equal; ``batch_deadline_ms=0`` on both, and ``sched_kw`` (arguments
    both schedulers take: the relay breaker's and the comparer's). With
    ``config`` (a KubeSchedulerConfiguration dict, its objects the port's)
    both loops are built by their package's ``scheduler_from_config``, the
    JAX one from the config rebuilt with ``to_jax``; ``registries`` are
    the out-of-tree registries (JAX's, the port's); ``extenders(pair)``
    gives (JAX's, the port's) in-process extenders added to the config's,
    each package's ``ExtenderConfig.instance``. Objects are built from
    the specs of this module through each package's wrappers and written to
    both stores in the same order."""

    def __init__(self, batch: int = 16, percentage: int = 0, start: bool = True,
                 sched_kw: dict = None, config: dict = None, registries=(None, None),
                 extenders=None):
        from kubernetes_tpu.apiserver.store import ClusterStore
        from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
        from kubernetes_tpu_torch.apiserver.store import Store
        from kubernetes_tpu_torch.utils.clock import FakeClock

        self.jclock, self.tclock = JFakeClock(), FakeClock()
        assert self.jclock() == self.tclock()
        self.jstore, self.tstore = ClusterStore(), Store(now_fn=self.tclock)
        # the specs' objects as they are on both sides (topo_pods_spec sets
        # minDomains on ScheduleAnyway constraints too); both admission
        # chains stay on
        self.jstore.validation_enabled = False
        self.tstore.validation_enabled = False
        self.batch, self.percentage = batch, percentage
        self.sched_kw = dict(sched_kw or {})
        self.config, self.registries, self.extenders = config, registries, extenders
        self.cycles = [0, 0]
        if start:
            self.start()

    def start(self) -> None:
        """Build both schedulers (``start=False`` defers this until the
        stores are filled: the schedulers then replay the stores' LIST)."""
        from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler as JTPUScheduler
        from kubernetes_tpu.config import Extender as JExtender
        from kubernetes_tpu.config import load_config as jax_load_config
        from kubernetes_tpu.config import scheduler_from_config as jax_from_config
        from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
        from kubernetes_tpu_torch.config import Extender, load_config, scheduler_from_config

        if self.config is None:
            self.jsched = JTPUScheduler(self.jstore, now_fn=self.jclock, batch_size=self.batch,
                                        batch_deadline_ms=0,
                                        percentage_of_nodes_to_score=self.percentage,
                                        **self.sched_kw)
            self.tsched = TPUScheduler(self.tstore, device="cpu", now_fn=self.tclock,
                                       batch_size=self.batch, batch_deadline_ms=0,
                                       percentage_of_nodes_to_score=self.percentage,
                                       **self.sched_kw)
        else:
            raw = dict(self.config)
            raw.setdefault("percentageOfNodesToScore", self.percentage)
            jcfg, tcfg = jax_load_config(to_jax(raw)), load_config(raw)
            if self.extenders is not None:
                jexts, texts = self.extenders(self)
                jcfg.extenders += [JExtender(instance=e) for e in jexts]
                tcfg.extenders += [Extender(instance=e) for e in texts]
            self.jsched = jax_from_config(self.jstore, jcfg,
                                          out_of_tree_registry=self.registries[0],
                                          scheduler_cls=JTPUScheduler, now_fn=self.jclock,
                                          batch_size=self.batch, batch_deadline_ms=0,
                                          **self.sched_kw)
            self.tsched = scheduler_from_config(self.tstore, tcfg,
                                                out_of_tree_registry=self.registries[1],
                                                scheduler_cls=TPUScheduler, device="cpu",
                                                now_fn=self.tclock, batch_size=self.batch,
                                                batch_deadline_ms=0, **self.sched_kw)
        # the pods each batch cycle popped, in pop order, per side
        self.popped = ([], [])
        for side, sched in enumerate((self.jsched, self.tsched)):
            self._record_pops(sched.queue, self.popped[side])

    def land_worker_each_cycle(self) -> None:
        """With the commit worker on, land its commits at the end of every
        batch cycle on both sides: the ring still holds its batches in
        flight and the worker commits them on its own thread, but the next
        pop no longer races the worker's requeues, so the pods popped per
        batch do not follow thread timing."""
        for sched in (self.jsched, self.tsched):
            if sched.commit_worker is None:
                continue
            cycle = sched.schedule_batch_cycle

            def landed(_cycle=cycle, _worker=sched.commit_worker):
                n = _cycle()
                _worker.flush()
                return n

            sched.schedule_batch_cycle = landed

    @staticmethod
    def _record_pops(queue, log) -> None:
        pop_batch = queue.pop_batch

        def recorded(k):
            out = pop_batch(k)
            if out:
                log.append([qp.pod.key() for qp in out])
            return out

        queue.pop_batch = recorded

    def add_pod_group(self, name: str, min_member: int, ns: str = "default",
                      timeout_s: int = 0) -> None:
        from kubernetes_tpu.api.types import ObjectMeta as JMeta, PodGroup as JPodGroup
        from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup

        self.jstore.create_object("PodGroup", JPodGroup(
            meta=JMeta(name=name, namespace=ns), min_member=min_member,
            schedule_timeout_seconds=timeout_s))
        self.tstore.create_object("PodGroup", PodGroup(
            meta=ObjectMeta(name=name, namespace=ns), min_member=min_member,
            schedule_timeout_seconds=timeout_s))

    def add_quota(self, ns: str, hard: dict, weight: int = 1, cohort: str = "") -> None:
        from kubernetes_tpu_torch.api.types import ObjectMeta, SchedulingQuota

        from kubernetes_tpu_torch.api.types import Namespace

        q = SchedulingQuota(meta=ObjectMeta(name="quota", namespace=ns), hard=dict(hard),
                            weight=weight, cohort=cohort)
        namespace = Namespace(meta=ObjectMeta(name=ns, namespace=""))
        if ns not in self.jstore.namespaces:  # the JAX store admits pods of known namespaces
            self.jstore.create_namespace(to_jax(namespace))
            self.tstore.create_namespace(namespace)
        self.jstore.create_object("SchedulingQuota", to_jax(q))
        self.tstore.create_object("SchedulingQuota", q)

    def delete_pod(self, key: str) -> None:
        self.jstore.delete_pod(key)
        self.tstore.delete_pod(key)

    def gang_state(self, which: int) -> dict:
        """``state`` with what gangs, slices and quota add: the pods popped
        per batch, the pods parked at Permit, the PodGroups' status, the
        gated count and the gang, slice and quota metrics."""
        sched = (self.jsched, self.tsched)[which]
        store = (self.jstore, self.tstore)[which]
        m = sched.smetrics

        def counter(c):
            return {k: c.labels(*k) for k in c.label_sets() if c.labels(*k)}

        def hist(h):
            return {k: (h.count(*k), round(h.sum(*k), 9)) for k in h.label_sets()}

        return {
            **self.state(which),
            "popped": self.popped[which],
            "waiting": sorted(sched.waiting_pods),
            "pod_groups": pod_group_status(store),
            "gangs_rejected": counter(m.gangs_rejected),
            "gang_wait": hist(m.gang_wait_duration),
            "slice_wait": hist(m.slice_wait_duration),
            "slice_fragmentation": counter(m.slice_fragmentation),
            "quota_usage": counter(m.quota_usage),
            "quota_borrowed": counter(m.quota_borrowed),
        }

    def assert_gang_equal(self) -> dict:
        """Every key of ``gang_state`` equal; returns the port's."""
        jax_state, port_state = self.gang_state(0), self.gang_state(1)
        for key in jax_state:
            assert port_state[key] == jax_state[key], key
        return port_state

    def create(self, method: str, *objs, kind: str = "") -> None:
        """Port API objects written through the store ``method`` of both
        stores, in order (``create_pv``, ``create_pod``, ...; ``kind``
        for ``create_object``): the port's object as it is, the JAX store a
        copy rebuilt as the JAX package's (made before the port's store
        stamps it)."""
        for obj in objs:
            jobj = to_jax(obj)
            args = (kind,) if kind else ()
            getattr(self.jstore, method)(*args, jobj)
            getattr(self.tstore, method)(*args, obj)

    def volume_state(self, which: int) -> dict:
        """``state`` with what claims and volumes add: the pods popped per
        batch, PV -> its claim, PVC -> its PV, each claim's allocated node
        and reserved-for pods, each PodSchedulingContext's node, and the
        pods the sequential path bound."""
        sched = (self.jsched, self.tsched)[which]
        store = (self.jstore, self.tstore)[which]
        contexts = store._kind_map("PodSchedulingContext")
        return {
            **self.state(which),
            "popped": self.popped[which],
            "pv_bindings": {k: pv.bound_pvc for k, pv in store.pvs.items()},
            "pvc_bindings": {k: pvc.bound_pv for k, pvc in store.pvcs.items()},
            "claims": claim_allocations(store),
            "contexts": {k: c.selected_node for k, c in contexts.items()},
            "fallback_scheduled": sched.fallback_scheduled,
        }

    def assert_volume_equal(self) -> dict:
        """Every key of ``volume_state`` equal; returns the port's."""
        jax_state, port_state = self.volume_state(0), self.volume_state(1)
        for key in jax_state:
            assert port_state[key] == jax_state[key], key
        return port_state

    def add_nodes(self, infos_j, infos_t) -> None:
        """Nodes (NodeInfos of ``build_nodes`` / ``build_topo_nodes``) and
        their pods, bound."""
        for nj, nt in zip(infos_j, infos_t):
            self.jstore.create_node(nj.node)
            self.tstore.create_node(nt.node)
        for nj, nt in zip(infos_j, infos_t):
            for pj, pt in zip(nj.pods, nt.pods):
                self.jstore.create_pod(pj)
                self.tstore.create_pod(pt)

    def add_pods(self, pods_j, pods_t) -> None:
        for pj, pt in zip(pods_j, pods_t):
            self.jstore.create_pod(pj)
            self.tstore.create_pod(pt)

    def advance(self, dt: float) -> None:
        self.jclock.advance(dt)
        self.tclock.advance(dt)
        self.jsched.queue.flush_backoff_completed()
        self.tsched.queue.flush_backoff_completed()

    def settle(self) -> None:
        self.cycles[0] += self.jsched.run_until_settled()
        self.cycles[1] += self.tsched.run_until_settled()

    def state(self, which: int) -> dict:
        """What the two runs must agree on."""
        sched = (self.jsched, self.tsched)[which]
        store = (self.jstore, self.tstore)[which]
        queued = sorted((qp.pod.key(), qp.attempts, tuple(sorted(qp.unschedulable_plugins)))
                        for qp in sched.queue.pending_pod_infos())
        return {
            "placed": {k: p.spec.node_name for k, p in store.pods.items()},
            "nominated": {k: p.status.nominated_node_name for k, p in store.pods.items()
                          if p.status.nominated_node_name},
            "metrics": {k: sched.metrics[k] for k in
                        ("schedule_attempts", "scheduled", "unschedulable")},
            "pending": dict(sched.queue.pending_pods()),
            "queued": queued,
            "cycles": self.cycles[which],
            "batches": sched.batch_counter,
            "settle_abandoned": sched.settle_abandoned,
        }

    def assert_equal(self) -> dict:
        """Every key of ``state`` equal; returns the port's."""
        jax_state, port_state = self.state(0), self.state(1)
        for key in jax_state:
            assert port_state[key] == jax_state[key], key
        return port_state

    def drive_port_unlanded(self, cycles: int, step: float) -> None:
        """The port's loop alone, ``cycles`` batch cycles with its clock
        advanced ``step`` after each and the backoff flushed, then settled:
        with the commit worker on, nothing lands its commits between
        cycles, so Permit parks and allows run on the worker while the next
        batches pop and dispatch, and the 1 s sweep meets whatever the
        worker still holds (its flush before the sweep lands it)."""
        for _ in range(cycles):
            self.tsched.schedule_batch_cycle()
            self.tclock.advance(step)
            self.tsched.queue.flush_backoff_completed()
        self.cycles[1] += self.tsched.run_until_settled()

    def assert_port_consistent(self) -> dict:
        """What holds on the port's settled loop however its worker's
        commits interleaved with its pops: no pod waits at Permit, no
        assume is left open, and every node of the cache holds exactly the
        pods the store binds to it. Returns the port's ``gang_state``."""
        from kubernetes_tpu_torch.cache.snapshot import Snapshot

        sched, store = self.tsched, self.tstore
        assert not sched.waiting_pods
        assert [k for k in store.pods if sched.cache.is_assumed(k)] == []
        snap = Snapshot()
        sched.cache.update_snapshot(snap)
        cached = {name: sorted(p.key() for p in ni.pods)
                  for name, ni in snap.node_info_map.items()}
        bound: dict = {name: [] for name in cached}
        for key, pod in store.pods.items():
            if pod.spec.node_name:
                bound.setdefault(pod.spec.node_name, []).append(key)
        assert cached == {name: sorted(keys) for name, keys in bound.items()}
        return self.gang_state(1)


# ----------------------------------------------------------------- observability


class Recorders:
    """Both packages' telemetry, latency ledger and tracer on for a block,
    each ledger on its own side's clock of ``pair`` (a LoopPair) with a
    closed tail long enough to keep every entry, and each fed its own
    loop's metrics and quota tenants; everything is turned off again at the
    exit. ``jax`` / ``port`` hold (telemetry, ledger, span exporter)."""

    def __init__(self, pair, ledger=True, telemetry=True, tracing=True, keep_closed=1 << 16):
        self.pair = pair
        self.flags = (ledger, telemetry, tracing)
        self.keep_closed = keep_closed

    def _modules(self):
        from kubernetes_tpu.backend import telemetry as jtel
        from kubernetes_tpu.metrics import latency_ledger as jled
        from kubernetes_tpu.utils import tracing as jtr
        from kubernetes_tpu_torch.backend import telemetry as ttel
        from kubernetes_tpu_torch.metrics import latency_ledger as tled
        from kubernetes_tpu_torch.utils import tracing as ttr

        return (jtel, jled, jtr), (ttel, tled, ttr)

    def __enter__(self):
        ledger, telemetry, tracing = self.flags
        out = []
        for (tel, led, tr), sched, clock in zip(self._modules(), (self.pair.jsched,
                                                                  self.pair.tsched),
                                                (self.pair.jclock, self.pair.tclock)):
            recs = [None, None, None]
            if telemetry:
                recs[0] = tel.enable(sched.smetrics)
            if ledger:
                recs[1] = led.enable(sched.smetrics, now_fn=clock,
                                     tenant_fn=sched._ns_fair_weight,
                                     keep_closed=self.keep_closed)
            if tracing:
                recs[2] = tr.InMemoryExporter()
                tr.enable(recs[2])
            out.append(recs)
        self.jax, self.port = out
        return self

    def __exit__(self, *exc):
        for tel, led, tr in self._modules():
            tel.disable()
            led.disable()
            tr.disable()


def ledger_view(ledger) -> dict:
    """pod -> (result, segments, the intervals' segment order, e2e, the
    intervals) of every entry, closed or live (a live one's e2e None)."""
    out = {}
    for e in ledger.timeline_entries():
        closed = e["closed"] is not None
        out[e["pod"]] = (e["result"], e["segments"],
                         [seg for seg, _t0, _t1 in e["intervals"]],
                         (e["closed"] - e["opened"]) if closed else None,
                         [tuple(i) for i in e["intervals"]] if closed else None)
    return out


FLIGHT_KEYS = ("type", "batchId", "bucket", "sig", "pods", "topo")


def flight_view(telemetry) -> list:
    """The flight recorder's events as (type, batchId, bucket, sig, pods,
    topo) tuples, in order."""
    return [tuple(ev.get(k) for k in FLIGHT_KEYS) for ev in telemetry.flight.dump()]


SPAN_ATTRS = ("batch", "topo", "pod", "profile", "extension_point", "worker", "packed",
              "program", "bucket", "batchId")


def span_forest(exporter) -> list:
    """The exported spans as trees in start order: (name, the compared
    attributes, children), siblings by start time then export order."""
    spans = list(exporter.spans)
    order = {id(s): i for i, s in enumerate(spans)}
    kids = {}
    ids = {s.span_id for s in spans}
    roots = []
    for s in spans:
        if s.parent_id and s.parent_id in ids:
            kids.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)

    def key(s):
        return (s.start, order[id(s)])

    def tree(s):
        attrs = tuple((k, str(s.attributes[k])) for k in SPAN_ATTRS if k in s.attributes)
        return (s.name, attrs, tuple(tree(c) for c in sorted(kids.get(s.span_id, ()), key=key)))

    return [tree(s) for s in sorted(roots, key=key)]


def _scenario_basic(pair) -> None:
    """12 nodes, 40 pods in three batches, all bound; a second settle past
    11 s."""
    spec = cluster_spec(12, 0)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(40, 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    pair.settle()
    pair.advance(11.0)
    pair.settle()
    pair.assert_equal()


def _scenario_failures(pair) -> None:
    """12 nodes, 150 pods: 22 fail (PostFilter runs for them), park
    unschedulable or in backoffQ, are retried past their backoff and park
    again."""
    spec = cluster_spec(12, 0)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(150, 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    pair.settle()
    pair.advance(11.0)
    pair.settle()
    pair.assert_equal()


def _scenario_poison(pair) -> None:
    """The first two batch commits die at their read (a transient device
    error): the ring is poisoned and requeued to backoffQ, then retried."""
    from kubernetes_tpu.backend.errors import TransientDeviceError as JError
    from kubernetes_tpu_torch.backend.errors import TransientDeviceError

    spec = cluster_spec(12, 0)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(60, 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    left = [2, 2]

    def fault(side, err):
        def fn(_op):
            if left[side] > 0:
                left[side] -= 1
                return err("scripted device fault")
            return None
        return fn

    pair.jsched.relay_fault_fn = fault(0, JError)
    pair.tsched.relay_fault_fn = fault(1, TransientDeviceError)
    pair.settle()
    pair.advance(2.0)
    pair.settle()
    pair.advance(5.0)
    pair.settle()
    pair.assert_equal()


def _scenario_gang(pair) -> None:
    """A gang of 4 whose first 3 members park at Permit until the 4th
    arrives 1.5 s later, and a gang of 3 too big for the nodes: rejected
    whole, retried past its backoff."""
    def nodes(api):
        return [api.make_node(f"node-{i}").capacity({"cpu": "4", "memory": "32Gi", "pods": 32})
                .label("kubernetes.io/hostname", f"node-{i}").obj() for i in range(4)]

    def members(api, prefix, n, group, cpu="1"):
        return [api.make_pod(f"{prefix}-{i}").req({"cpu": cpu}).pod_group(group).obj()
                for i in range(n)]

    for jn, tn in zip(nodes(jax_api()), nodes(torch_api())):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)
    pair.add_pod_group("g1", 4, timeout_s=30)
    pair.add_pod_group("g2", 3)
    pair.add_pods(members(jax_api(), "a", 3, "g1"), members(torch_api(), "a", 3, "g1"))
    pair.settle()
    pair.advance(1.5)
    pair.settle()
    pair.add_pods(members(jax_api(), "b", 1, "g1"), members(torch_api(), "b", 1, "g1"))
    pair.settle()
    pair.add_pods(members(jax_api(), "c", 3, "g2", "3"), members(torch_api(), "c", 3, "g2", "3"))
    pair.settle()
    pair.advance(3.0)
    pair.settle()
    pair.assert_gang_equal()


def _scenario_churn(pair) -> None:
    """6 nodes, 80 pods; then five pending pods and five bound ones are
    deleted, and the rest retried past their backoff."""
    spec = cluster_spec(6, 0)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(80, 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    pair.settle()
    pending = [k for k, p in pair.tstore.pods.items() if not p.spec.node_name][:5]
    bound = [k for k, p in pair.tstore.pods.items() if p.spec.node_name][:5]
    for key in pending + bound:
        pair.delete_pod(key)
    pair.advance(11.0)
    pair.settle()
    pair.assert_equal()


def _scenario_reclaim(pair) -> None:
    """SchedulingBorrow's lender burst at the borrow tests' small size (16
    nodes, 6 rounds, scale 8, 60 cycles of 0.05 s): the quota reclaim pass
    evicts the borrower's loans, each eviction through the drain
    orchestrator (``evict_wave``), to fund the burst."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_borrow(nodes=16, rounds=6, scale=8, cycles_per_round=60,
                                    tick_s=0.05)
    for ni in w.node_infos():
        pair.jstore.create_node(to_jax(ni.node))
        pair.tstore.create_node(ni.node)
    for q in w.quotas():
        pair.add_quota(q.meta.namespace, q.hard, weight=q.weight, cohort=q.cohort)
    workloads.borrow_rounds(w, pair.jstore, pair.jsched, pair.jsched._quota_plugin(),
                            pair.jclock, convert=to_jax)
    out = workloads.borrow_rounds(w, pair.tstore, pair.tsched, pair.tsched._quota_plugin(),
                                  pair.tclock)
    assert out["invariants"]["Reclaims"] > 0
    pair.assert_gang_equal()


# the loop scenarios the observability tests drive through a LoopPair
LOOP_SCENARIOS = {"basic": _scenario_basic, "failures": _scenario_failures,
                  "poison": _scenario_poison, "gang": _scenario_gang, "churn": _scenario_churn,
                  "reclaim": _scenario_reclaim}


# ----------------------------------------------------------------- the wire service


class WirePair:
    """Each package's ``WireScheduler`` against a ``serve(DeviceService)``
    on 127.0.0.1, in one process: side 0 is the JAX client, side 1 the
    port's. ``services`` names whose service each side talks to (default:
    its own; ``("port", "jax")`` crosses them); the port's service runs on
    ``device="cpu"``. Each side has its own store (validation off, both
    admission chains on) and its own FakeClock, both starting equal, which
    is also the client's retry sleep. ``plan`` gives each side a FaultPlan
    of its client's package, shared by that side's client and server.
    ``depth`` is the wire pipeline depth; every client read timeout is 10
    s. ``build(fn)`` calls ``fn(api, store)`` for each side with its
    package's ``Api``, in the same order. Use it as a context manager: the
    servers are stopped and their sockets closed at exit.

    With ``depth`` > 0 each client keeps ``depth`` batches in flight.
    Each service runs them in the order its handler threads take the lock,
    so on several lanes that order, hence what is decided, follows thread
    timing (ROADMAP C26). With ``one_lane`` (the default) both clients send
    their batches in flight on one lane, one at a time in submission
    order, and the runs are deterministic and comparable; without it each
    keeps ``depth`` lanes, and only the order-free invariants compare
    (``invariants``)."""

    def __init__(self, batch: int = 8, service_batch: int = 32, depth: int = 0,
                 percentage: int = 0, plan: bool = False, services=("jax", "port"),
                 sched_kw: dict = None, service_kw: dict = None, client_ids=("wire", "wire"),
                 one_lane: bool = True):
        from kubernetes_tpu.apiserver.store import ClusterStore
        from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
        from kubernetes_tpu_torch.apiserver.store import Store
        from kubernetes_tpu_torch.utils.clock import FakeClock

        self.clocks = (JFakeClock(), FakeClock())
        assert self.clocks[0]() == self.clocks[1]()
        self.stores = (ClusterStore(), Store(now_fn=self.clocks[1]))
        for store in self.stores:
            store.validation_enabled = False
        self.apis = (jax_api(), torch_api())
        self.services, self.servers, self.plans, self.scheds = [], [], [], []
        self.service_pkgs = services
        self.one_lane = one_lane
        self.sent_batch_ids = (set(), set())  # each client's batchIds sent
        self.cycles = [0, 0]
        try:
            for side in (0, 1):
                self._start_side(side, batch, service_batch, depth, percentage, plan,
                                 services[side], dict(sched_kw or {}), dict(service_kw or {}),
                                 client_ids[side])
        except BaseException:
            self.close()
            raise

    @staticmethod
    def _modules(pkg: str):
        if pkg == "jax":
            from kubernetes_tpu.backend import service
            from kubernetes_tpu.testing import faults
        else:
            from kubernetes_tpu_torch.backend import service
            from kubernetes_tpu_torch.testing import faults
        return service, faults

    def _start_side(self, side, batch, service_batch, depth, percentage, plan, service_pkg,
                    sched_kw, service_kw, client_id) -> None:
        client_mod, client_faults = self._modules(("jax", "port")[side])
        server_mod, _ = self._modules(service_pkg)
        fault_plan = client_faults.FaultPlan() if plan else None
        kw = dict(batch_size=service_batch, percentage_of_nodes_to_score=percentage,
                  **service_kw)
        if service_pkg == "port":
            kw["device"] = "cpu"
        service = server_mod.DeviceService(**kw)
        server, port = server_mod.serve(service, fault_plan=fault_plan)
        self.services.append(service)
        self.servers.append((service_pkg, server))
        self.plans.append(fault_plan)
        clock = self.clocks[side]
        self.scheds.append(client_mod.WireScheduler(
            self.stores[side], endpoint=f"http://127.0.0.1:{port}", batch_size=batch,
            wire_pipeline_depth=depth, batch_deadline_ms=0, read_timeout=10.0,
            now_fn=clock, sleep_fn=clock.advance, fault_plan=fault_plan,
            client_id=client_id, percentage_of_nodes_to_score=percentage, **sched_kw))
        sched = self.scheds[-1]
        sent = self.sent_batch_ids[side]
        real_send = sched.client.schedule_batch

        def send(payload, _real=real_send, _sent=sent):
            _sent.add(payload["batchId"])
            return _real(payload)

        sched.client.schedule_batch = send
        pipeline = sched._wire_pipeline
        if pipeline is not None:
            pipeline._send = send
            if self.one_lane:
                pipeline.depth = 1

    def service(self, side: int):
        """The live service behind side ``side``'s server (a restart swaps it)."""
        return self.servers[side][1].binding.service

    def close(self) -> None:
        for pkg, server in self.servers:
            server.shutdown()
            server.server_close()
        self.servers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def build(self, fn) -> None:
        for side in (0, 1):
            fn(self.apis[side], self.stores[side])

    def each(self, fn) -> list:
        """``[fn(sched, store, side) for each side]``."""
        return [fn(self.scheds[side], self.stores[side], side) for side in (0, 1)]

    def settle(self) -> None:
        for side in (0, 1):
            self.cycles[side] += self.scheds[side].run_until_settled()

    def advance(self, dt: float) -> None:
        for side in (0, 1):
            self.clocks[side].advance(dt)
            self.scheds[side].queue.flush_backoff_completed()

    def state(self, side: int) -> dict:
        """What the two runs must agree on."""
        sched, store = self.scheds[side], self.stores[side]
        queued = sorted((qp.pod.key(), qp.attempts, tuple(sorted(qp.unschedulable_plugins)))
                        for qp in sched.queue.pending_pod_infos())
        service = self.service(side)
        return {
            "placed": {k: p.spec.node_name for k, p in store.pods.items()},
            "nominated": {k: p.status.nominated_node_name for k, p in store.pods.items()
                          if p.status.nominated_node_name},
            "metrics": {k: sched.metrics[k] for k in
                        ("schedule_attempts", "scheduled", "unschedulable", "errors")},
            "pending": dict(sched.queue.pending_pods()),
            "queued": queued,
            "cycles": self.cycles[side],
            "resyncs": sched.resyncs,
            "session_rejoins": sched.session_rejoins,
            "degraded_pods": sched.degraded_pods,
            "breaker": sched.breaker.state,
            "conflicts": sched.smetrics.commit_conflicts.labels(sched.client_id),
            "service_batches": service.batch_counter,
            "service_replays": service.batch_replays,
            "service_conflicts": service.commit_conflicts,
            "settle_abandoned": sched.settle_abandoned,
        }

    def invariants(self, side: int) -> dict:
        """What holds in any order the service runs pipelined batches in:
        the pods bound, no node over its allocatable, one program run per
        batch sent and none replayed, nothing degraded."""
        sched, store = self.scheds[side], self.stores[side]
        used: dict = {}
        for pod in store.pods.values():
            if pod.spec.node_name:
                req = pod.resource_request()
                cpu, mem, n = used.get(pod.spec.node_name, (0, 0, 0))
                used[pod.spec.node_name] = (cpu + req.get("cpu", 0), mem + req.get("memory", 0),
                                            n + 1)
        over = []
        for name, node in store.nodes.items():
            cpu, mem, n = used.get(name, (0, 0, 0))
            alloc = node.allocatable_canonical()
            if (cpu > alloc.get("cpu", 0) or mem > alloc.get("memory", 0)
                    or n > alloc.get("pods", 0)):
                over.append(name)
        service = self.service(side)
        return {"bound": sum(1 for p in store.pods.values() if p.spec.node_name),
                "over_capacity": over,
                "program_runs_equal_batches": (service.batch_counter
                                               == len(self.sent_batch_ids[side])),
                "service_replays": service.batch_replays,
                "degraded_pods": sched.degraded_pods}

    def assert_equal(self, skip=()) -> dict:
        """Every key of ``state`` but ``skip`` equal; returns the port's."""
        jax_state, port_state = self.state(0), self.state(1)
        for key in jax_state:
            if key not in skip:
                assert port_state[key] == jax_state[key], (key, jax_state[key], port_state[key])
        return port_state


# ----------------------------------------------------------------- the device fabric

# the flight events a fabric scenario compares, in two groups whose relative
# order follows thread timing when a pipeline lane fails: the fabric's own
# (emitted by the failing call's thread) and the loop's (the scheduling
# thread's); each group's order is compared
FABRIC_EVENTS = ("replica_down", "poison", "failover", "replica_rejoin", "replication")
LOOP_EVENTS = ("requeue", "degrade", "pipeline_poison", "conflict")
_ENDPOINT_FIELDS = ("endpoint", "fromEndpoint")
_EVENT_FIELDS = ("verb", "pods", "reason", "restarted", "nodes", "removed", "full")


def metric_items(metric) -> list:
    """A counter or gauge of either package as sorted (labels, value)."""
    return sorted((ls, metric.labels(*ls)) for ls in metric.label_sets())


class FabricPair(WirePair):
    """Each package's ``WireScheduler`` over ``replicas`` served
    ``DeviceService``s through its device fabric (``backend/fabric.py``):
    the JAX suite's ``_FabricRig`` on both sides. Each endpoint of each side
    has its own FaultPlan of the client's package (``plans[side][i]``),
    shared by its client and server; every clock of a side (retry sleeps,
    breakers, the probe interval, pod backoff, the services' leases) rides
    that side's FakeClock. The scheduler defaults are the rig's: batch 8,
    one transport retry, no heartbeats, pod backoff 0.01-0.05 s. The
    replicator's worker thread is off on both sides: a test replicates with
    ``replication_flush()``, at the same points on both. ``state`` adds the
    fabric's view (active replica, failovers by reason, replica health,
    each service's counters) to ``WirePair.state``; ``sent_batch_ids``
    holds the batches a service answered."""

    def __init__(self, replicas: int = 2, batch: int = 8, service_batch: int = 32,
                 depth: int = 0, sched_kw: dict = None, one_lane: bool = True):
        self.replicas = replicas
        kw = dict(wire_max_retries=1, heartbeat_interval_s=0.0, pod_initial_backoff=0.01,
                  pod_max_backoff=0.05)
        kw.update(sched_kw or {})
        self.fabric_plans = ([], [])
        self.fabric_services = ([], [])
        # cleared, it holds every scheduleBatch call (the pipeline's lanes)
        # until it is set again
        self.lane_gate = threading.Event()
        self.lane_gate.set()
        super().__init__(batch=batch, service_batch=service_batch, depth=depth, plan=True,
                         sched_kw=kw, one_lane=one_lane)
        self.plans = self.fabric_plans

    def _start_side(self, side, batch, service_batch, depth, percentage, plan, service_pkg,
                    sched_kw, service_kw, client_id) -> None:
        mod, faults = self._modules(("jax", "port")[side])
        clock = self.clocks[side]
        endpoints = []
        for _ in range(self.replicas):
            plan = faults.FaultPlan()
            kw = dict(batch_size=service_batch, now_fn=clock)
            if side == 1:
                kw["device"] = "cpu"
            service = mod.DeviceService(**kw)
            server, port = mod.serve(service, fault_plan=plan)
            self.servers.append((("jax", "port")[side], server))
            self.fabric_plans[side].append(plan)
            self.fabric_services[side].append(service)
            endpoints.append(f"http://127.0.0.1:{port}")
        self.services.append(None)
        sched = mod.WireScheduler(
            self.stores[side], endpoint=endpoints, batch_size=batch, wire_pipeline_depth=depth,
            batch_deadline_ms=0, read_timeout=10.0, now_fn=clock, sleep_fn=clock.advance,
            fault_plan=self.fabric_plans[side], client_id=client_id, **sched_kw)
        sched.client._repl_worker_enabled = False
        self.scheds.append(sched)
        sent = self.sent_batch_ids[side]
        for rep in sched.client.replicas:
            real = rep.client.schedule_batch

            def send(payload, _real=real, _sent=sent, _gate=self.lane_gate):
                _gate.wait(timeout=10)
                out = _real(payload)  # a call that raised ran no program
                _sent.add(payload["batchId"])
                return out

            rep.client.schedule_batch = send
        if sched._wire_pipeline is not None and self.one_lane:
            sched._wire_pipeline.depth = 1

    def fabric(self, side: int):
        return self.scheds[side].client

    def service(self, side: int):
        """The live service behind side ``side``'s active endpoint."""
        i = self.fabric(side).active_replica().index
        return self.servers[side * self.replicas + i][1].binding.service

    def services_of(self, side: int) -> list:
        return [self.servers[side * self.replicas + i][1].binding.service
                for i in range(self.replicas)]

    def state(self, side: int) -> dict:
        out = super().state(side)
        fab = self.fabric(side)
        services = self.services_of(side)
        out.update({
            "service_batches": [s.batch_counter for s in services],
            "service_replays": [s.batch_replays for s in services],
            "service_conflicts": [s.commit_conflicts for s in services],
            "active": fab.active_replica().index,
            "fabric_failovers": fab.failovers,
            "failovers": metric_items(self.scheds[side].smetrics.fabric_failovers),
            "healthy": [r.healthy for r in fab.replicas],
            "health_gauge": [self.scheds[side].smetrics.fabric_replica_health.labels(r.endpoint)
                             for r in fab.replicas],
            "needs_full": [r.repl_needs_full for r in fab.replicas],
            "repl_seq": fab._repl_seq,
        })
        return out

    def invariants(self, side: int) -> dict:
        out = super().invariants(side)
        out["program_runs_equal_batches"] = (
            sum(s.batch_counter for s in self.services_of(side))
            == len(self.sent_batch_ids[side]))
        out["service_replays"] = sum(s.batch_replays for s in self.services_of(side))
        return out

    def flight(self, side: int, tele, kinds=FABRIC_EVENTS + LOOP_EVENTS) -> list:
        """``tele``'s events of ``kinds`` in order, endpoints as replica
        indices and batch ids as their order of appearance."""
        index = {r.endpoint: r.index for r in self.fabric(side).replicas}
        batch_ids: dict = {}
        out = []
        for ev in tele.flight.dump():
            if ev["type"] not in kinds:
                continue
            bid = ev.get("batchId")
            if bid is not None:
                bid = batch_ids.setdefault(bid, len(batch_ids))
            out.append((ev["type"], bid)
                       + tuple(index.get(ev.get(k)) for k in _ENDPOINT_FIELDS)
                       + tuple(ev.get(k) for k in _EVENT_FIELDS))
        return out

    def mirror(self, side: int) -> dict:
        """The active service's host mirror after a forced full resync:
        field -> (the rows of each node, by name). Each side's must equal
        what it held before the resync (``assert_resync_mirror_identical``)."""
        svc = self.service(side)
        state = svc.device if side == 0 else svc.state
        slots = state.encoder.node_slots
        return {f: {n: np.asarray(a[s]).tolist() for n, s in slots.items()}
                for f, a in state._mirror.items()}

    def assert_resync_mirror_identical(self) -> list:
        """On each side, a forced full resync into the active service leaves
        its mirror as it was; returns both mirrors (by node name)."""
        out = []
        for side in (0, 1):
            before = self.mirror(side)
            self.scheds[side]._full_resync(self.service(side).epoch)
            after = self.mirror(side)
            assert before == after, side
            out.append(after)
        return out


# ----------------------------------------------------------------- node-axis sharding


def _encoding(pkg: str):
    """(ClusterEncoder, SigTable, Capacities, hostname key, encoder
    keywords) of ``pkg`` ("jax" or "port"; the port's encoder on the CPU)."""
    if pkg == "jax":
        from kubernetes_tpu.backend.sig_table import SigTable
        from kubernetes_tpu.framework.plugins.podtopologyspread import HOSTNAME_KEY
        from kubernetes_tpu.ops.encode import ClusterEncoder
        from kubernetes_tpu.ops.schema import Capacities
        return ClusterEncoder, SigTable, Capacities, HOSTNAME_KEY, {}
    from kubernetes_tpu_torch.backend.sig_table import SigTable
    from kubernetes_tpu_torch.framework.plugins.interpodaffinity import HOSTNAME_KEY
    from kubernetes_tpu_torch.ops.encode import ClusterEncoder
    from kubernetes_tpu_torch.ops.schema import Capacities
    return ClusterEncoder, SigTable, Capacities, HOSTNAME_KEY, {"device": "cpu"}


def _encode_case(pkg: str, infos, pods, n_nodes: int, n_pods: int):
    encoder_cls, sig_cls, caps_cls, _host, kw = _encoding(pkg)
    enc = encoder_cls(caps_cls(nodes=n_nodes, pods=n_pods, value_words=32), **kw)
    sig = sig_cls(enc)
    nt = enc.encode_snapshot(infos)
    pb, et = enc.encode_pods(pods)
    tb = sig.encode_topo(pods)  # registers the batch's rows before the counts are read
    return enc, nt, pb, et, sig.topo_counts(), tb


def _sharding_zone_case(api, n_nodes: int, n_pods: int, topo: bool):
    """tests/test_sharding.py:build_inputs with ``api``'s objects."""
    infos = []
    for i in range(n_nodes):
        nw = api.make_node(f"node-{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 20}).label("zone", f"z{i % 4}")
        if i % 7 == 0:
            nw.taint("dedicated", "x", "NoSchedule")
        infos.append(api.NodeInfo(nw.obj()))
    pods = []
    for i in range(n_pods):
        pw = api.make_pod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).label("app", f"a{i % 2}")
        if i % 3 == 0:
            pw.node_affinity_in("zone", [f"z{i % 4}"])
        if topo:
            pw.spread_constraint(1, "zone",
                                 selector=api.LabelSelector(match_labels={"app": f"a{i % 2}"}))
            if i % 2 == 0:
                pw.pod_affinity("zone", api.LabelSelector(match_labels={"app": "a1"}), anti=True)
        pods.append(pw.obj())
    return infos, pods


def _sharding_capacity_case(api):
    infos = [api.NodeInfo(api.make_node("only").capacity(
        {"cpu": "2", "memory": "4Gi", "pods": 1}).obj())]
    infos += [api.NodeInfo(api.make_node(f"full-{i}").capacity(
        {"cpu": "0", "memory": "0", "pods": 0}).obj()) for i in range(7)]
    return infos, [api.make_pod(f"p{i}").req({"cpu": "1"}).obj() for i in range(4)]


def _sharding_anti_case(api):
    infos = [api.NodeInfo(api.make_node(f"n{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": 10}).label("zone", f"z{i % 2}").obj())
        for i in range(16)]
    sel = api.LabelSelector(match_labels={"app": "x"})
    pods = [api.make_pod(f"p{i}").req({"cpu": "1"}).label("app", "x")
            .pod_affinity("zone", sel, anti=True).obj() for i in range(4)]
    return infos, pods


def _sharding_conflict_case(api):
    infos = [api.NodeInfo(api.make_node(f"n{i}").capacity(
        {"cpu": "2", "memory": "4Gi", "pods": 3}).obj()) for i in range(8)]
    pods = [api.make_pod(f"p{i}").req({"cpu": "1500m", "memory": "1Gi"}).obj()
            for i in range(16)]
    return infos, pods


def _sharding_hostname_case(api, host_key: str):
    infos = [api.NodeInfo(api.make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": 20}).label(host_key, f"node-{i}").obj())
        for i in range(32)]
    sel = api.LabelSelector(match_labels={"app": "web"})
    pods = []
    for i in range(16):
        pw = api.make_pod(f"p{i}").req({"cpu": "1", "memory": "1Gi"}).label("app", "web")
        pw.spread_constraint(1, host_key, selector=sel)
        if i % 2 == 0:
            pw.pod_affinity(host_key, api.LabelSelector(match_labels={"app": "web"}), anti=True)
        pods.append(pw.obj())
    return infos, pods


# The nine cases of tests/test_sharding.py: name -> (builder, nodes, pods,
# the sharded program's keywords). The builder takes (api, hostname key).
SHARDING_CASES = {
    "off_scan": (lambda api, hk: _sharding_zone_case(api, 32, 8, False), 32, 8,
                 dict(topo_enabled=False)),
    "topology_scan": (lambda api, hk: _sharding_zone_case(api, 32, 8, True), 32, 8,
                      dict(topo_enabled=True)),
    "topo_carry_scan": (lambda api, hk: _sharding_zone_case(api, 32, 8, True), 32, 8,
                        dict(topo_enabled=True)),
    "capacity_scan": (lambda api, hk: _sharding_capacity_case(api), 8, 4,
                      dict(topo_enabled=False)),
    "anti_cross_shard": (lambda api, hk: _sharding_anti_case(api), 16, 4,
                         dict(topo_enabled=True)),
    "off_rounds": (lambda api, hk: _sharding_zone_case(api, 48, 16, False), 48, 16,
                   dict(topo_enabled=False, spec_decode=True)),
    "conflict_rounds": (lambda api, hk: _sharding_conflict_case(api), 8, 16,
                        dict(topo_enabled=False, spec_decode=True)),
    "host_rounds": (lambda api, hk: _sharding_hostname_case(api, hk), 32, 16,
                    dict(topo_enabled=True, spec_decode=True, topo_mode="host")),
    "general_rounds": (lambda api, hk: _sharding_zone_case(api, 48, 16, True), 48, 16,
                       dict(topo_enabled=True, spec_decode=True, topo_mode="general")),
}


def sharding_case(pkg: str, name: str):
    """(enc, nt, pb, et, tc, tb, kw) of SHARDING_CASES[name], built and
    encoded by ``pkg`` ("jax" or "port"); ``kw`` are the sharded program's
    keywords, with ``host_key`` (the hostname key's slot) in mode host."""
    build, n_nodes, n_pods, kw = SHARDING_CASES[name]
    host = _encoding(pkg)[3]
    infos, pods = build(jax_api() if pkg == "jax" else torch_api(), host)
    enc, nt, pb, et, tc, tb = _encode_case(pkg, infos, pods, n_nodes, n_pods)
    kw = dict(kw)
    if kw.get("topo_mode") == "host":
        kw["host_key"] = enc.key_slot(host)
    return enc, nt, pb, et, tc, tb, kw
