"""The port's node agent (``kubernetes_tpu_torch/kubelet/``) against the JAX
package's, on the CPU: the checkpoint manager, the resource managers (CPU,
device, topology), the PLEG, the CRI (the fake runtime in process, and
over gRPC on the vendored ``native/ktpu_cri_pb2.py``, whose descriptor is
protoc's), the eviction manager, the volume and status managers, the hollow
kubelet and the kubemark cluster with the scheduler and the controller
manager.

Each case is one script run against each package (``test_torch_controllers.
run``); its record (every object of every kind in wire form with its
resource version, the runtime's state, the managers' state) must be equal.
The JAX tests' own bars (``tests/test_node_agent_cli.py``'s kubelet cases,
``tests/test_kubelet_cm.py``, ``tests/test_kubelet_depth.py``,
``tests/test_cri.py``, ``tests/test_volume_status_manager.py``) then hold on
the port's record."""

import importlib
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

from test_torch_controllers import CKit, run, settle_sequential, state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class KKit(CKit):
    """``CKit`` with the kubelet's modules."""

    def __init__(self, pkg: str):
        super().__init__(pkg)
        root = "kubernetes_tpu" if pkg == "jax" else "kubernetes_tpu_torch"
        for name in ("checkpoint", "cm", "pleg", "cri", "eviction", "volume_manager", "hollow",
                     "kubemark"):
            setattr(self, name, importlib.import_module(f"{root}.kubelet.{name}"))
        self.nodelifecycle = importlib.import_module(f"{root}.controllers.nodelifecycle")


KKITS = {pkg: KKit(pkg) for pkg in ("jax", "port")}


def krun(script):
    """``script(kit)`` on both packages with the kubelet kit."""
    return run(lambda k: script(KKITS[k.pkg]))


def _node(k, name, cpu="8", mem="8Gi", pods=20):
    return k.make_node(name).capacity({"cpu": cpu, "memory": mem, "pods": pods}).obj()


def _runtime_view(rt) -> dict:
    return {"sandboxes": sorted((s["id"], s["state"]) for s in rt.list_pod_sandbox()),
            "containers": sorted((c["id"], c["state"], c.get("exit_code"))
                                 for c in rt.containers.values()),
            "images": rt.list_images()}


# ---------------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip_corruption_and_restart():
    def script(k):
        with tempfile.TemporaryDirectory() as tmp:
            cm = k.checkpoint.CheckpointManager(tmp)
            cm.create_checkpoint("a", {"x": [1, 2], "y": "z"})
            out = [cm.get_checkpoint("a"), cm.get_checkpoint("missing"), cm.list_checkpoints()]
            with open(os.path.join(tmp, "a")) as f:
                doc = f.read()
            with open(os.path.join(tmp, "a"), "w") as f:
                f.write(doc.replace('\\"z\\"', '\\"q\\"'))
            try:
                cm.get_checkpoint("a")
                out.append("read")
            except k.checkpoint.CorruptCheckpointError:
                out.append("corrupt")
            cm.create_checkpoint("b", {"n": 1})
            out.append(k.checkpoint.CheckpointManager(tmp).get_checkpoint("b"))
            cm.remove_checkpoint("b")
            out.append(cm.list_checkpoints())
            with pytest.raises(ValueError):
                cm.create_checkpoint("../x", {})
        return out

    out = krun(script)
    assert out[0] == {"x": [1, 2], "y": "z"} and out[1] is None and out[3] == "corrupt"
    assert out[4] == {"n": 1} and out[5] == ["a"]


# ---------------------------------------------------------------- resource managers


def _guaranteed(k, name, cores, extra=None):
    pw = k.make_pod(name)
    req = {"cpu": str(cores), **(extra or {})}
    pw.pod.spec.containers[0].requests = dict(req)
    pw.pod.spec.containers[0].limits = dict(req)
    return pw.obj()


def test_cpu_manager_static_policy_and_restart():
    def script(k):
        with tempfile.TemporaryDirectory() as tmp:
            cm = k.cm.CPUManager(k.checkpoint.CheckpointManager(tmp), cores_per_numa=(4,))
            out = [cm.allocate(_guaranteed(k, "g", 2))]
            pw = k.make_pod("b")
            pw.pod.spec.containers[0].requests = {"cpu": "2"}
            pw.pod.spec.containers[0].limits = {"cpu": "4"}
            out.append(cm.allocate(pw.obj()))
            pw2 = k.make_pod("f").req({"cpu": "1500m"})
            pw2.pod.spec.containers[0].limits = {"cpu": "1500m"}
            out.append(cm.allocate(pw2.obj()))
            cm2 = k.cm.CPUManager(k.checkpoint.CheckpointManager(tmp), cores_per_numa=(4,))
            out.append(dict(cm2.assignments))
            try:
                cm2.allocate(_guaranteed(k, "big", 3))
                out.append("admitted")
            except k.cm.TopologyAffinityError as e:
                out.append(str(e))
            cm2.release("default/g")
            out.append(cm2.allocate(_guaranteed(k, "big", 3)))
            hints = k.cm.CPUManager(k.checkpoint.CheckpointManager(tmp + "/h"),
                                    cores_per_numa=(2, 4)).topology_hints(_guaranteed(k, "g", 3))
            out.append([(h.numa_nodes, h.preferred) for h in hints])
        return out

    out = krun(script)
    assert len(out[0]) == 2 and out[1] == [] and out[2] == []
    assert out[3] == {"default/g": out[0]} and out[4] != "admitted" and len(out[5]) == 3
    assert ((1,), True) in out[6]


def test_device_manager_allocates_and_checkpoints():
    def script(k):
        with tempfile.TemporaryDirectory() as tmp:
            devs = {"gpu0": 0, "gpu1": 0, "gpu2": 1}
            dm = k.cm.DeviceManager(k.checkpoint.CheckpointManager(tmp))
            dm.register_plugin("example.com/gpu", devs)
            pod = k.make_pod("g").req({"cpu": "1", "example.com/gpu": "2"}).obj()
            out = [dm.allocate(pod), [(h.numa_nodes, h.preferred) for h in
                                      dm.topology_hints(k.make_pod("q").req(
                                          {"example.com/gpu": "1"}).obj())]]
            dm2 = k.cm.DeviceManager(k.checkpoint.CheckpointManager(tmp))
            dm2.register_plugin("example.com/gpu", devs)
            out.append(dm2.allocations)
            try:
                dm2.allocate(k.make_pod("h").req({"cpu": "1", "example.com/gpu": "2"}).obj())
                out.append("admitted")
            except k.cm.TopologyAffinityError as e:
                out.append(str(e))
        return out

    out = krun(script)
    assert len(out[0]["example.com/gpu"]) == 2 and out[2]["default/g"] == out[0]
    assert out[3] != "admitted"


@pytest.mark.parametrize("policy,cpu,gpu", [
    ("single-numa-node", "2", "1"),  # aligned
    ("single-numa-node", "5", "1"),  # cannot fit one NUMA node: rejected
    ("best-effort", "5", None),      # admitted unaligned
    ("restricted", "5", None),       # a non-preferred hint: rejected
    ("none", "2", None),             # no hints
])
def test_topology_manager_policies(policy, cpu, gpu):
    def script(k):
        with tempfile.TemporaryDirectory() as tmp:
            cm = k.cm.CPUManager(k.checkpoint.CheckpointManager(tmp + "/c"),
                                 cores_per_numa=(4, 4))
            dm = k.cm.DeviceManager(k.checkpoint.CheckpointManager(tmp + "/d"))
            dm.register_plugin("example.com/gpu", {"gpu0": 0, "gpu1": 1})
            tm = k.cm.TopologyManager(policy, providers=[cm, dm])
            pod = _guaranteed(k, "p", cpu, {"example.com/gpu": gpu} if gpu else None)
            try:
                hint = tm.admit(pod)
                out = ["admitted", None if hint is None else (hint.numa_nodes, hint.preferred)]
            except k.cm.TopologyAffinityError as e:
                out = ["rejected", str(e)]
            out += [dict(cm.assignments), dm.allocations]
            tm.release("default/p")
            out += [dict(cm.assignments), dm.allocations]
        return out

    out = krun(script)
    rejected = (policy, cpu) in (("single-numa-node", "5"), ("restricted", "5"))
    assert (out[0] == "rejected") == rejected
    assert out[4] == {} and out[5] == {}


def test_topology_admit_rolls_back_and_kubelet_fails_pod():
    def script(k):
        with tempfile.TemporaryDirectory() as tmp:
            cm = k.cm.CPUManager(k.checkpoint.CheckpointManager(tmp + "/c"), cores_per_numa=(4,))
            dm = k.cm.DeviceManager(k.checkpoint.CheckpointManager(tmp + "/d"))
            dm.register_plugin("example.com/gpu", {})
            tm = k.cm.TopologyManager("none", providers=[cm, dm])
            try:
                tm.admit(_guaranteed(k, "leaky", 2, {"example.com/gpu": "1"}))
                out = ["admitted"]
            except k.cm.TopologyAffinityError:
                out = ["rejected"]
            out.append(dict(cm.assignments))
            store = k.new_store()
            kubelet = k.hollow.HollowKubelet(store, _node(k, "n1", pods=10), now_fn=lambda: 1.0)
            cm2 = k.cm.CPUManager(k.checkpoint.CheckpointManager(tmp + "/k"),
                                  cores_per_numa=(2, 2))
            kubelet.topology_manager = k.cm.TopologyManager("single-numa-node", providers=[cm2])
            for name, cores in (("fits", 2), ("toowide", 3)):
                pod = _guaranteed(k, name, cores)
                pod.spec.node_name = "n1"
                store.create_pod(pod)
            kubelet.run_once()
            out.append(state(k, store))
            store.delete_pod("default/toowide")
            store.delete_pod("default/fits")
            kubelet.run_once()
            out.append(dict(cm2.assignments))
        return out

    out = krun(script)
    assert out[0] == "rejected" and out[1] == {} and out[3] == {}
    pods = out[2]["Pod"]
    assert pods["default/fits"]["status"]["phase"] == "Running"
    assert pods["default/toowide"]["status"]["reason"] == "TopologyAffinityError"


# ---------------------------------------------------------------- PLEG


def test_pleg_event_stream_and_health():
    def script(k):
        rt = k.cri.FakeRuntimeService(now_fn=lambda: 5.0)
        pleg = k.pleg.GenericPLEG(rt, now_fn=lambda: clock[0])
        clock = [0.0]
        out = [pleg.relist()]
        sid = rt.run_pod_sandbox({"name": "web", "namespace": "default", "uid": "u1"})
        cid = rt.create_container(sid, {"name": "c", "image": "pause"})
        rt.start_container(cid)
        out.append(pleg.relist())
        rt.stop_container(cid)
        out.append(pleg.relist())
        rt.remove_container(cid)
        out.append(pleg.relist())
        rt.stop_pod_sandbox(sid)
        out.append(pleg.relist())
        rt.remove_pod_sandbox(sid)
        out.append(pleg.relist())
        out.append(pleg.healthy())
        clock[0] += 1000.0
        out.append(pleg.healthy())
        return [[(e.pod_uid, e.pod_key, e.type, e.data) for e in evs] if isinstance(evs, list)
                else evs for evs in out] + [pleg.events_emitted]

    out = krun(script)
    assert out[0] == [] and [e[2] for e in out[1]] == ["ContainerStarted"]
    assert [e[2] for e in out[2]] == ["ContainerDied"]
    assert [e[2] for e in out[3]] == ["ContainerRemoved"]
    assert out[6] is True and out[7] is False


def test_kubelet_restarts_crashed_container():
    def script(k):
        store = k.new_store()
        rt = k.cri.FakeRuntimeService(now_fn=lambda: 1.0)
        kubelet = k.hollow.HollowKubelet(store, _node(k, "n1"), runtime=rt,
                                         now_fn=lambda: 1.0)
        kubelet.register()
        pod = k.make_pod("web").req({"cpu": "1"}).obj()
        pod.spec.node_name = "n1"
        store.create_pod(pod)
        kubelet.run_once()
        kubelet.run_once()
        [c] = [c for c in rt.containers.values() if c["state"] == "CONTAINER_RUNNING"]
        rt.stop_container(c["id"])
        kubelet.run_once()
        return [kubelet.pleg_restarts, _runtime_view(rt), rt.calls, state(k, store)]

    out = krun(script)
    assert out[0] == 1
    assert sum(1 for c in out[1]["containers"] if c[1] == "CONTAINER_RUNNING") == 1


# ---------------------------------------------------------------- CRI


def test_fake_runtime_lifecycle():
    def script(k):
        rt = k.cri.FakeRuntimeService(now_fn=lambda: 2.5)
        sid = rt.run_pod_sandbox({"name": "web", "namespace": "prod"})
        out = [rt.pod_sandbox_status(sid)]
        cid = rt.create_container(sid, {"name": "app", "image": "nginx:1.25"})
        out.append(rt.container_status(cid))
        rt.start_container(cid)
        out.append(rt.container_status(cid))
        out.append(rt.list_images())
        rt.stop_pod_sandbox(sid)
        out.append(rt.container_status(cid))
        rt.remove_pod_sandbox(sid)
        out += [rt.list_pod_sandbox(), rt.list_containers()]
        sid = rt.run_pod_sandbox({"name": "p", "namespace": "default"})
        cid = rt.create_container(sid, {"name": "c", "image": "x"})
        rt.start_container(cid)
        rt.stop_container(cid)
        out += [rt.container_status(cid), rt.version(), rt.calls]
        return out

    out = krun(script)
    assert out[2]["state"] == "CONTAINER_RUNNING" and out[4]["exit_code"] == 137
    assert out[5] == [] and out[6] == [] and out[7]["exit_code"] == 0


def test_vendored_cri_descriptor_is_protocs():
    """The port's vendored module embeds protoc's descriptor bytes (the JAX
    package's on-demand build of the same schema), so both register in one
    process; the generator's check agrees."""
    from kubernetes_tpu.kubelet import cri as jcri
    from kubernetes_tpu_torch.kubelet import cri as tcri

    assert tcri.pb2_available()
    if not jcri.pb2_available():
        pytest.skip("the JAX package builds its CRI messages with protoc, absent here")
    assert jcri.pb2().DESCRIPTOR.serialized_pb == tcri.pb2().DESCRIPTOR.serialized_pb
    msg = jcri.pb2().RunPodSandboxRequest(config=jcri.pb2().PodSandboxConfig(
        name="a", namespace="b", labels={"k": "v"}))
    back = tcri.pb2().RunPodSandboxRequest.FromString(msg.SerializeToString())
    assert (back.config.name, dict(back.config.labels)) == ("a", {"k": "v"})
    if shutil.which("protoc") is not None:
        r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "gen_torch_cri_pb2.py"),
                            "--check"], capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, PYTHONPATH=""))
        assert r.returncode == 0, r.stdout + r.stderr


def test_cri_over_grpc_against_both_servers():
    """Each package's client against each package's server: the same
    answers over the wire."""
    from kubernetes_tpu.kubelet import cri as jcri
    from kubernetes_tpu_torch.kubelet import cri as tcri

    pairs = [(tcri, tcri)]
    if jcri.pb2_available():
        pairs += [(jcri, tcri), (tcri, jcri)]
    outs = []
    for server_mod, client_mod in pairs:
        rt = server_mod.FakeRuntimeService(now_fn=lambda: 3.0)
        server, port = server_mod.serve_cri(rt)
        try:
            client = client_mod.CRIClient(f"127.0.0.1:{port}")
            out = [client.version()]
            sid = client.run_pod_sandbox({"name": "web", "namespace": "prod", "uid": "u"})
            cid = client.create_container(sid, {"name": "app", "image": "nginx"})
            client.start_container(cid)
            out += [client.list_containers(sid), client.list_pod_sandbox(),
                    client.pod_sandbox_status(sid), client.container_status(cid),
                    client.pull_image("busybox"), client.list_images()]
            client.stop_container(cid)
            out.append(client.container_status(cid))
            client.remove_container(cid)
            client.remove_image("busybox")
            client.stop_pod_sandbox(sid)
            client.remove_pod_sandbox(sid)
            out += [client.list_pod_sandbox(), client.container_status("nope"),
                    client.pod_sandbox_status("nope"), rt.calls]
            client.close()
        finally:
            server.stop(0)
        outs.append(out)
    assert all(o == outs[0] for o in outs)
    assert outs[0][0]["runtime_name"] == "ktpu-hollow"
    assert outs[0][1][0]["state"] == "CONTAINER_RUNNING" and outs[0][8] == []


@pytest.mark.parametrize("case", ["ttl", "evicted", "grpc"])
def test_kubelet_over_cri(case):
    def script(k):
        clock = k.FakeClock()
        store = k.new_store()
        rt = k.cri.FakeRuntimeService(now_fn=clock)
        server = None
        runtime = rt
        if case == "grpc":
            server, port = k.cri.serve_cri(rt)
            runtime = k.cri.CRIClient(f"127.0.0.1:{port}")
        try:
            pods = 1 if case == "evicted" else 10
            kubelet = k.hollow.HollowKubelet(store, _node(k, "n1", pods=pods), now_fn=clock,
                                             runtime=runtime)
            kubelet.run_once()
            names = ("a", "b") if case == "evicted" else ("web",)
            for name in names:
                pod = k.make_pod(name).req({"cpu": "100m"}).obj()
                if case == "ttl":
                    pod.meta.annotations["kubelet/terminates-after"] = "5"
                store.create_pod(pod)
                k.bind(store, f"default/{name}", "n1")
            kubelet.run_once()
            out = [state(k, store), _runtime_view(rt)]
            clock.advance(6)
            kubelet.run_once()
            out += [state(k, store), _runtime_view(rt)]
            store.delete_pod(f"default/{names[0]}")
            kubelet.run_once()
            out += [state(k, store), _runtime_view(rt), rt.calls]
        finally:
            if server is not None:
                runtime.close()
                server.stop(0)
        return out

    out = krun(script)
    if case == "ttl":
        assert out[0]["Pod"]["default/web"]["status"]["phase"] == "Running"
        assert out[2]["Pod"]["default/web"]["status"]["phase"] == "Succeeded"
        assert out[3]["containers"][0][1:] == ("CONTAINER_EXITED", 0)
        assert out[5]["sandboxes"] == []
    elif case == "evicted":
        phases = sorted(p["status"]["phase"] for p in out[0]["Pod"].values())
        assert phases == ["Failed", "Running"] and len(out[1]["sandboxes"]) == 1
    else:
        assert out[0]["Pod"]["default/web"]["status"]["phase"] == "Running"
        assert "RunPodSandbox" in out[6] and "StartContainer" in out[6]


# ---------------------------------------------------------------- eviction


def _eviction_setup(k):
    store = k.new_store()
    store.create_node(_node(k, "n1"))
    signals = {k.eviction.SIGNAL_MEMORY_AVAILABLE: 1 << 30}
    usage = {}
    clock = [0.0]
    mgr = k.eviction.EvictionManager(
        store, "n1", stats_fn=lambda: dict(signals),
        pod_stats_fn=lambda key: usage.get(key, k.eviction.PodStats()),
        pressure_transition_period=30.0, now_fn=lambda: clock[0])
    return store, signals, usage, mgr, clock


@pytest.mark.parametrize("case", ["none", "priority", "exceeds", "transition"])
def test_eviction_manager(case):
    def script(k):
        store, signals, usage, mgr, clock = _eviction_setup(k)
        mem = k.eviction.SIGNAL_MEMORY_AVAILABLE
        pods = {"none": [("a", 0, "64Mi", 0)],
                "priority": [("low", 0, "64Mi", 100 << 20), ("high", 100, "64Mi", 200 << 20)],
                "exceeds": [("greedy", 100, "64Mi", 500 << 20), ("frugal", 0, "1Gi", 10 << 20)],
                "transition": []}[case]
        for name, prio, req, used in pods:
            p = k.make_pod(name).req({"cpu": "1", "memory": req}).priority(prio).obj()
            p.spec.node_name = "n1"
            p.status.phase = "Running"
            store.create_pod(p)
            usage[f"default/{name}"] = k.eviction.PodStats(memory_bytes=used)
        out = []
        if case != "none":
            signals[mem] = 50 << 20
        out += [mgr.synchronize(), state(k, store)]
        if case == "transition":
            signals[mem] = 4 << 30
            out += [mgr.synchronize(), store.nodes["n1"].status.memory_pressure]
            clock[0] += 31.0
            out += [mgr.synchronize(), store.nodes["n1"].status.memory_pressure]
        return out + [mgr.evicted_total]

    out = krun(script)
    want = {"none": None, "priority": "default/low", "exceeds": "default/greedy",
            "transition": None}[case]
    assert out[0] == want
    if case == "transition":
        assert out[3] is True and out[5] is False


def test_pressured_node_evicts_and_scheduler_reroutes():
    """The eviction manager, the node lifecycle controller's pressure taint,
    the ReplicaSet controller and the scheduler (the JAX sequential
    ``Scheduler``; the port's loop through ``schedule_one``)."""
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        store.create_node(_node(k, "pressured"))
        store.create_node(_node(k, "healthy"))
        sched = k.Scheduler(store, now_fn=clock)
        m = k.manager(store, controllers=["replicaset", "nodelifecycle"], clock=clock)
        template = k.make_pod("web").req({"cpu": "1", "memory": "64Mi"}).label("app", "web").obj()
        store.create_replica_set(t.ReplicaSet(
            meta=t.ObjectMeta(name="web"), replicas=2,
            selector=t.LabelSelector(match_labels={"app": "web"}), template=template))
        m.settle()
        settle_sequential(sched)
        out = [state(k, store)]
        victim = sorted(p.spec.node_name for p in store.pods.values())[0]
        signals = {k.eviction.SIGNAL_MEMORY_AVAILABLE: 10 << 20}
        ev = k.eviction.EvictionManager(store, victim, stats_fn=lambda: dict(signals),
                                        now_fn=clock)
        out.append(ev.synchronize())
        m.settle()
        settle_sequential(sched)
        out.append(state(k, store))
        return out

    out = krun(script)
    final = out[2]
    evicted = final["Pod"][out[1]]
    assert evicted["status"]["reason"] == "Evicted"
    live = [p for p in final["Pod"].values() if p["status"]["phase"] != "Failed"]
    assert len(live) == 2 and all(p["spec"]["node_name"] for p in live)


# ---------------------------------------------------------------- volume and status managers


def _store_with_claim(k):
    t = k.types
    store = k.new_store()
    store.create_node(k.make_node("n1").capacity({"cpu": "8"}).obj())
    store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name="pv1"), capacity_bytes=1 << 30,
                                       bound_pvc="default/c1"))
    store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="c1"), bound_pv="pv1"))
    pod = k.make_pod("db").req({"cpu": "1"}).pvc("c1").obj()
    pod.spec.node_name = "n1"
    store.create_pod(pod)
    return store, store.get_pod("default/db")


@pytest.mark.parametrize("case", ["attach", "leave", "other_node", "kubelet_gate"])
def test_volume_manager(case):
    def script(k):
        t = k.types
        store, pod = _store_with_claim(k)
        vm = k.volume_manager.VolumeManager(store, "n1", require_attach=case != "leave")
        out = []
        if case == "kubelet_gate":
            kubelet = k.hollow.HollowKubelet(store, store.nodes["n1"], now_fn=lambda: 1.0)
            kubelet.volume_manager = vm
            kubelet.run_once()
            out.append(state(k, store))
        else:
            out.append(vm.wait_for_attach_and_mount(pod))
        node = "other" if case == "other_node" else "n1"
        store.create_object("VolumeAttachment", t.VolumeAttachment(
            meta=t.ObjectMeta(name="va1"), pv_name="pv1", node_name=node))
        if case == "kubelet_gate":
            kubelet.run_once()
            out.append(state(k, store))
        else:
            out.append(vm.wait_for_attach_and_mount(pod))
        store.delete_pod("default/db")
        if case == "kubelet_gate":
            kubelet.run_once()
        else:
            vm.reconcile()
        return out + [sorted(vm.mounted), vm.mounts_total, vm.unmounts_total]

    out = krun(script)
    if case == "kubelet_gate":
        assert out[0]["Pod"]["default/db"]["status"]["phase"] == "Pending"
        assert out[1]["Pod"]["default/db"]["status"]["phase"] == "Running"
    else:
        assert out[:2] == {"attach": [False, True], "leave": [True, True],
                           "other_node": [False, False]}[case]
    assert out[-3] == []


@pytest.mark.parametrize("case", ["noop", "distinct", "deleted"])
def test_status_manager(case):
    def script(k):
        t = k.types
        store = k.new_store()
        store.create_pod(k.make_pod("w").req({"cpu": "1"}).obj())
        pod = store.get_pod("default/w")
        sm = k.volume_manager.StatusManager(store)
        sm.set_pod_status(pod, t.PodStatus(phase="Running"))
        out = []
        if case == "noop":
            sm.set_pod_status(pod, t.PodStatus(phase="Running"))
            out += [sm.sync(), sm.sync()]
        elif case == "distinct":
            out.append(sm.sync())
            sm.set_pod_status(pod, t.PodStatus(phase="Failed", reason="Evicted"))
            out.append(sm.sync())
        else:
            store.delete_pod("default/w")
            out += [sm.sync(), dict(sm._versions)]
        return out + [sm.api_writes, state(k, store)]

    out = krun(script)
    assert out[:2] == {"noop": [1, 0], "distinct": [1, 1], "deleted": [0, {}]}[case]


# ---------------------------------------------------------------- hollow kubelet


@pytest.mark.parametrize("case", ["run_pods", "terminates_after", "restart", "overcommit"])
def test_hollow_kubelet(case):
    def script(k):
        store = k.new_store()
        clock = k.FakeClock()
        if case == "run_pods":
            kubelet = k.hollow.HollowKubelet(store, _node(k, "n1", "4", "8Gi", 10), now_fn=clock)
            kubelet.run_once()
            store.create_pod(k.make_pod("p1").obj())
            k.bind(store, "default/p1", "n1")
            p = store.get_pod("default/p1").clone()
            p.status.phase = "Pending"
            store.update_pod(p)
            kubelet.run_once()
        elif case == "terminates_after":
            kubelet = k.hollow.HollowKubelet(store, k.make_node("n1").obj(), now_fn=clock)
            kubelet.run_once()
            pod = k.make_pod("job-pod").obj()
            pod.meta.annotations[k.hollow.TERMINATES_AFTER_ANNOTATION] = "5"
            pod.spec.node_name = "n1"
            store.create_pod(pod)
            kubelet.run_once()
            clock.advance(6.0)
            kubelet.run_once()
        elif case == "restart":
            kubelet = k.hollow.HollowKubelet(store, k.make_node("n1").obj(), now_fn=clock)
            kubelet.run_once()
            import copy

            node = copy.deepcopy(store.nodes["n1"])
            node.spec.unschedulable = True
            store.update_node(node)
            k.hollow.HollowKubelet(store, k.make_node("n1").obj(), now_fn=clock).run_once()
        else:
            kubelet = k.hollow.HollowKubelet(store, _node(k, "n1", "64", "64Gi", 2),
                                             now_fn=clock)
            kubelet.run_once()
            for i in range(4):
                p = k.make_pod(f"p{i}").obj()
                p.spec.node_name = "n1"
                store.create_pod(p)
            kubelet.run_once()
        return state(k, store)

    out = krun(script)
    lease = out["Lease"][f"{'kube-node-lease'}/n1"]
    assert lease["holder_identity"] == "n1"
    phases = sorted(p["status"]["phase"] for p in out["Pod"].values())
    assert phases == {"run_pods": ["Running"], "terminates_after": ["Succeeded"], "restart": [],
                      "overcommit": ["Failed", "Failed", "Running", "Running"]}[case]
    if case == "restart":
        assert out["Node"]["n1"]["spec"]["unschedulable"] is True


def test_heartbeat_keeps_node_ready():
    def script(k):
        store = k.new_store()
        clock = k.FakeClock()
        alive = k.hollow.HollowKubelet(store, k.make_node("alive").obj(), now_fn=clock)
        dead = k.hollow.HollowKubelet(store, k.make_node("dead").obj(), now_fn=clock)
        alive.run_once()
        dead.run_once()
        m = k.manager(store, controllers=["nodelifecycle"], clock=clock)
        for _ in range(10):
            clock.advance(10.0)
            alive.run_once()
            m.sync_round(monitor_nodes=True)
        return state(k, store)

    out = krun(script)
    assert out["Node"]["alive"]["status"]["ready"] is True
    assert out["Node"]["dead"]["status"]["ready"] is False


# ---------------------------------------------------------------- kubemark


@pytest.mark.parametrize("loop", ["sequential", "batch"])
def test_kubemark_end_to_end(loop):
    """JAX's ``test_hollow_cluster_end_to_end`` (50 hollow nodes, a Service
    and a Deployment of 200 pods, the deployment, replicaset and endpoints
    controllers): through the sequential scheduler (JAX ``Scheduler``; the
    port's loop through ``schedule_one``) and through the batch loop (both
    ``TPUScheduler``s at ``batch_deadline_ms=0``, full batches), with each
    kubelet's fake runtime and PLEG in the batch case. Every object equal."""
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        cluster = k.kubemark.HollowCluster(store, n_nodes=50, now_fn=clock,
                                           with_runtime=loop == "batch")
        cluster.register_all()
        if loop == "batch":
            if k.pkg == "jax":
                from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler

                sched = TPUScheduler(store, now_fn=clock, batch_size=64, batch_deadline_ms=0,
                                     percentage_of_nodes_to_score=100)
            else:
                from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

                sched = TPUScheduler(store, device="cpu", now_fn=clock, batch_size=64,
                                     batch_deadline_ms=0, percentage_of_nodes_to_score=100)
            settle = sched.run_until_settled
        else:
            sched = k.Scheduler(store, now_fn=clock)
            settle = lambda: settle_sequential(sched)  # noqa: E731
        m = k.manager(store, controllers=["deployment", "replicaset", "endpoints"], clock=clock)
        store.create_service(t.Service(meta=t.ObjectMeta(name="web"), selector={"app": "web"}))
        tmpl = k.make_pod("t").req({"cpu": "500m"}).label("app", "web").obj()
        store.create_object("Deployment", t.Deployment(meta=t.ObjectMeta(name="web"),
                                                       replicas=200, template=tmpl))
        for _ in range(10):
            m.settle()
            settle()
            cluster.tick()
        m.settle()
        out = [state(k, store)]
        if loop == "batch":
            out.append(sorted(_runtime_view(kl.runtime)["containers"][0][1]
                              for kl in cluster.kubelets if kl.runtime.containers))
            out.append(sum(kl.pleg.events_emitted for kl in cluster.kubelets))
        return out

    out = krun(script)
    pods = out[0]["Pod"]
    running = [p for p in pods.values() if p["status"]["phase"] == "Running"]
    assert len(running) == 200 and len({p["spec"]["node_name"] for p in running}) == 50
    assert len(out[0]["Endpoints"]["default/web"]["addresses"]) == 200


def test_kubemark_run_on_the_cpu(monkeypatch):
    """``perf/kubemark.run_kubemark``, the card phase's run, on the CPU at
    16 hollow nodes and 40 pods: its own bars hold (every pod Running in a
    sandbox that its PLEG reported after the relist tick, one commit read
    per batch, every endpoint 200, no cache drift), the binding is what
    writes Running (no kubelet transition), and a second run repeats the
    first object for object."""
    from kubernetes_tpu_torch.perf.kubemark import check_kubemark_run, run_kubemark

    for key in ("KTPU_BATCH_DEADLINE_MS", "KTPU_SPEC", "KTPU_PIPELINE_DEPTH",
                "KTPU_COMMIT_WORKER", "KTPU_LOCKTRACE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("KTPU_FULL_BATCH", "1")
    runs = [run_kubemark("cpu", nodes=16, replicas=40, batch_size=16) for _ in range(2)]
    assert check_kubemark_run("cpu", runs[0], 40) == []
    assert runs[0]["pleg_events"] == runs[0]["sandboxes"] == 40
    assert runs[0]["transitions"] == 0 and runs[0]["kubelet_ticks"] == runs[0]["turns"] + 1
    assert runs[0]["launches"] == 0 and runs[0]["batches"] > 0
    for key in ("placed", "objects", "reads", "batch_pods", "turns", "transitions",
                "pleg_events", "sandboxes", "devicestate", "cache"):
        assert runs[0][key] == runs[1][key], key


def test_kubemark_default_node_and_lookup():
    def script(k):
        store = k.new_store()
        cluster = k.kubemark.HollowCluster(store, n_nodes=4, with_runtime=True,
                                           with_volume_manager=True, now_fn=lambda: 7.0)
        cluster.register_all()
        t = k.types
        store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name="pv1"), capacity_bytes=1 << 30,
                                           bound_pvc="default/c1"))
        store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="c1"), bound_pv="pv1"))
        plain = k.make_pod("plain").req({"cpu": "1"}).obj()
        plain.spec.node_name = "hollow-node-0"
        store.create_pod(plain)
        claimed = k.make_pod("claimed").req({"cpu": "1"}).pvc("c1").obj()
        claimed.spec.node_name = "hollow-node-1"
        store.create_pod(claimed)
        transitions = cluster.settle()
        k0 = cluster.kubelet_for("hollow-node-0")
        return [transitions, state(k, store), _runtime_view(k0.runtime), k0.pleg.healthy(),
                cluster.kubelet_for("nope"), k.kubemark.default_node(7).meta.labels]

    out = krun(script)
    assert out[1]["Pod"]["default/plain"]["status"]["phase"] == "Running"
    assert out[1]["Pod"]["default/claimed"]["status"]["phase"] == "Running"
    assert any(c[1] == "CONTAINER_RUNNING" for c in out[2]["containers"]) and out[3]
    assert out[4] is None and out[5]["topology.kubernetes.io/zone"] == "zone-1"
