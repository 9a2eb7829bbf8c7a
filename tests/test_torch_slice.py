"""The slice end to end on the CPU: ``BatchScheduler(device="cpu")`` against
the JAX package's DeviceState + build_schedule_batch_fn loop on a
SchedulingBasic-shaped cluster, over several batches with node churn in
between (a node removed, then re-added empty). Placements must be
identical; the port's mirror must tombstone the removed node and elide the
rows whose only change was an adopted commit. Also: the import closure of
the port and its device rule."""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from _torch_cases import SnapshotShim, jax_api, torch_api

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _nodes(api, names):
    return [api.NodeInfo(api.make_node(n).capacity({"cpu": "32", "memory": "128Gi", "pods": 110})
                         .label("topology.kubernetes.io/zone", f"zone-{i % 10}").obj())
            for i, n in enumerate(names)]


def _pods(api, prefix, count):
    pods = []
    for i in range(count):
        pw = api.make_pod(f"{prefix}-{i}").req({"cpu": "900m", "memory": "2Gi"})
        if i % 10 == 3:
            pw.host_port(8080)
        if i % 25 == 7:
            pw.req({"cpu": "31", "memory": "2Gi"})
        if i % 50 == 9:
            pw.req({"cpu": "64", "memory": "2Gi"})  # fits no node
        pods.append(pw.obj())
    return pods


def _jax_schedule(ds, fn, infos, pods, caps):
    from kubernetes_tpu.backend.batch import unpack_result_block

    out = {}
    for s in range(0, len(pods), caps.pods):
        batch = pods[s:s + caps.pods]
        ds.sync(SnapshotShim(infos.values()))
        pb, et = ds.encoder.encode_pods(batch)
        res = fn(pb, et, ds.nt, ds.tc, ds.sig_table.encode_topo(batch),
                 jax.random.PRNGKey(0), topo_enabled=False,
                 ports_enabled=ds.encoder.last_has_ports)
        node_idx = unpack_result_block(res.packed, caps.nodes)[0]
        names = ds.slot_to_name()
        for i, pod in enumerate(batch):
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
    return out


def test_batch_scheduler_matches_jax_with_node_churn():
    from kubernetes_tpu.backend.batch import build_schedule_batch_fn
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    names = [f"node-{i}" for i in range(200)]
    jcaps = JCaps(nodes=256, pods=64, value_words=32)
    jinfos = {ni.node.meta.name: ni for ni in _nodes(jax_api(), names)}
    ds = JDeviceState(jcaps)
    fn = build_schedule_batch_fn()
    sched = BatchScheduler(_nodes(torch_api(), names),
                           caps=Capacities(nodes=256, pods=64, value_words=32), device="cpu")

    placed_j = _jax_schedule(ds, fn, jinfos, _pods(jax_api(), "init", 150), jcaps)
    placed_t = sched.schedule(_pods(torch_api(), "init", 150))
    assert placed_t == placed_j

    # churn: a node that holds pods leaves, then a fresh node of that name joins
    victim = placed_t["default/init-0"]
    del jinfos[victim]
    sched.remove_node(victim)
    placed_j.update(_jax_schedule(ds, fn, jinfos, _pods(jax_api(), "mid", 40), jcaps))
    placed_t.update(sched.schedule(_pods(torch_api(), "mid", 40)))
    assert placed_t == placed_j
    jinfos[victim] = _nodes(jax_api(), [victim])[0]
    sched.add_node(_nodes(torch_api(), [victim])[0])
    placed_j.update(_jax_schedule(ds, fn, jinfos, _pods(jax_api(), "measured", 150), jcaps))
    placed_t.update(sched.schedule(_pods(torch_api(), "measured", 150)))
    assert placed_t == placed_j

    assert sched.batches == 3 + 1 + 3
    assert sched.state.nodes_removed == 1
    assert sched.state.rows_elided > 0
    assert any(v is None for v in placed_t.values())  # the 64-cpu pods fit nowhere
    assert victim in {v for k, v in placed_t.items() if k.startswith("default/measured")}
    # the mirror equals the device after the last batch's adoption + sync
    sched.state.sync(sched.snapshot)
    np.testing.assert_array_equal(sched.state.nt.requested.numpy(),
                                  sched.state._mirror["requested"])
    np.testing.assert_array_equal(np.asarray(ds.nt.requested)[:200],
                                  sched.state.nt.requested.numpy()[:200])


def test_unsupported_pod_raises():
    from kubernetes_tpu_torch.api.types import LabelSelector
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler

    api = torch_api()
    sched = BatchScheduler(_nodes(api, ["a", "b"]), device="cpu")
    gang = api.make_pod("g").pod_group("team").obj()
    vol = api.make_pod("v").pvc("data").obj()
    claim = api.make_pod("c").resource_claim("accel", claim_name="tpu-claim").obj()
    for pod in (gang, vol, claim):
        with pytest.raises(NotImplementedError):
            sched.schedule([pod])
    assert sched.batches == 0
    # spread constraints and inter-pod affinity are placed since the topology slice
    spread = api.make_pod("s").spread_constraint(1, "topology.kubernetes.io/zone").obj()
    anti = api.make_pod("x").pod_affinity("kubernetes.io/hostname",
                                          LabelSelector({"app": "x"}), anti=True).obj()
    placed = sched.schedule([spread, anti])
    assert all(v is not None for v in placed.values())
    assert sched.batch_modes == ["general"]


def test_entry_points_without_device_need_cuda():
    """No device given and no CUDA: the entry points raise instead of
    running the plain versions on the host by themselves."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from kubernetes_tpu_torch.backend.batch import schedule_batch
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.backend.device_state import DeviceState
    from kubernetes_tpu_torch.ops.encode import ClusterEncoder
    from kubernetes_tpu_torch.ops.schema import Capacities

    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScheduler(_nodes(torch_api(), ["a"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceState(Capacities())
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterEncoder(Capacities())
    ds = DeviceState(Capacities(), device="cpu")
    pb, et = ds.encoder.encode_pods(_pods(torch_api(), "p", 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        schedule_batch(pb, et, ds.nt)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_closure_has_no_jax():
    files = (sorted((ROOT / "kubernetes_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted(ROOT.glob("tools/gen_torch_*.py")))
    assert len(files) > 15
    # every package of the port, the config package and the registry too
    assert {"config", "framework", "plugins", "apiserver", "backend", "controllers",
            "testing", "cmd", "kubelet"} <= {p.parent.name for p in files}
    # the generators of the port's vendored protobuf modules
    assert ROOT / "tools" / "gen_torch_cri_pb2.py" in files
    assert ROOT / "kubernetes_tpu_torch" / "framework" / "registry.py" in files
    # the wire service's modules (its own copies of the codec and faults)
    for rel in ("backend/service.py", "api/codec.py", "testing/faults.py"):
        assert ROOT / "kubernetes_tpu_torch" / rel in files, rel
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "kubernetes_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
