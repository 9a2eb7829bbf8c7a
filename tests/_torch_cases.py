"""Shared builders for the port's parity tests (tests/test_torch_*.py).

One seeded description of a cluster and a pod batch (plain data made with
numpy) is built twice: once with the JAX package's API objects and once with
the port's, so both packages see the same inputs.
"""

from __future__ import annotations

import dataclasses

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
    name from ``kubernetes_tpu.api.types``, field by field; memoized caches
    are not copied)."""
    from kubernetes_tpu.api import types as jtypes

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(jtypes, type(obj).__name__)
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
    equal; ``batch_deadline_ms=0`` on both. Objects are built from the
    specs of this module through each package's wrappers and written to
    both stores in the same order."""

    def __init__(self, batch: int = 16, percentage: int = 0, start: bool = True):
        from kubernetes_tpu.apiserver.store import ClusterStore
        from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
        from kubernetes_tpu_torch.apiserver.store import Store
        from kubernetes_tpu_torch.utils.clock import FakeClock

        self.jclock, self.tclock = JFakeClock(), FakeClock()
        assert self.jclock() == self.tclock()
        self.jstore, self.tstore = ClusterStore(), Store(now_fn=self.tclock)
        # the specs' objects as they are (the port's store validates nothing;
        # topo_pods_spec sets minDomains on ScheduleAnyway constraints too)
        self.jstore.validation_enabled = False
        self.batch, self.percentage = batch, percentage
        self.cycles = [0, 0]
        if start:
            self.start()

    def start(self) -> None:
        """Build both schedulers (``start=False`` defers this until the
        stores are filled: the schedulers then replay the stores' LIST)."""
        from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler as JTPUScheduler
        from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

        self.jsched = JTPUScheduler(self.jstore, now_fn=self.jclock, batch_size=self.batch,
                                    batch_deadline_ms=0,
                                    percentage_of_nodes_to_score=self.percentage)
        self.tsched = TPUScheduler(self.tstore, device="cpu", now_fn=self.tclock,
                                   batch_size=self.batch, batch_deadline_ms=0,
                                   percentage_of_nodes_to_score=self.percentage)

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
