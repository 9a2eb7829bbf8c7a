"""The port's controller manager and its controllers (``kubernetes_tpu_torch/
controllers/``) against the JAX package's, on the CPU: the workload
controllers (ReplicaSet, Deployment rolling and recreate, StatefulSet,
DaemonSet, Job, ReplicationController), node lifecycle, the housekeeping
loops (PodGC, the garbage collector, Namespace, Endpoints, the PV binder,
ResourceQuota), the disruption controller, and the store's finalizers.

Each case is one store script run against each package through its
``ControllerManager`` on a FakeClock (``test_torch_client.both``). After
each step the script records every object of every kind the port's store
holds (``state``: each package's wire form, resource versions included; the
store's wall-clock creation stamps and the Events' timestamps left out, a
``deletion_timestamp`` as set or not set), the reconcile counts the manager
returned, and each controller's requeue counts and queue length. The two
packages' records must be equal. The JAX tests' own bars
(``tests/test_controllers.py``, ``tests/test_disruption_admission.py``)
then hold on the port's record."""

import dataclasses

import pytest

from test_torch_client import Kit, both

# every kind the port's store keeps (``Store._kind_map``)
KINDS = ("Pod", "Node", "Namespace", "PersistentVolume", "PersistentVolumeClaim",
         "StorageClass", "CSINode", "PriorityClass", "PodDisruptionBudget", "ResourceClass",
         "ResourceClaim", "ResourceClaimTemplate", "PodSchedulingContext", "PodGroup",
         "SchedulingQuota", "Service", "ReplicationController", "ReplicaSet", "StatefulSet",
         "Deployment", "DaemonSet", "Job", "CronJob", "Endpoints", "EndpointSlice",
         "VolumeAttachment", "ResourceQuota", "LimitRange", "ServiceAccount", "RuntimeClass",
         "ConfigMap", "Secret", "CertificateSigningRequest", "HorizontalPodAutoscaler",
         "ClusterRole", "ClusterRoleBinding", "Lease", "Event")
# stamped from the wall clock by the stores and the event recorder
WALL_FIELDS = ("creation_timestamp", "first_timestamp", "last_timestamp")


class CKit(Kit):
    """``Kit`` with the controllers, the manager, a FakeClock, the RBAC
    kinds (JAX: ``apiserver/auth.py``; the port: ``api/types.py``), the
    wire codec and the sequential scheduler (JAX: ``Scheduler``; the port:
    the loop's sequential path, as the harness's ``oracle`` backend)."""

    def __init__(self, pkg: str):
        super().__init__(pkg)
        if pkg == "jax":
            from kubernetes_tpu import controllers
            from kubernetes_tpu.api import codec
            from kubernetes_tpu.apiserver import auth as rbac
            from kubernetes_tpu.scheduler.scheduler import Scheduler
            from kubernetes_tpu.utils.clock import FakeClock

            self.Scheduler = Scheduler
        else:
            from kubernetes_tpu_torch import controllers
            from kubernetes_tpu_torch.api import codec
            from kubernetes_tpu_torch.api import types as rbac
            from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
            from kubernetes_tpu_torch.utils.clock import FakeClock

            self.Scheduler = lambda store, **kw: TPUScheduler(store, device="cpu", **kw)
        self.controllers, self.codec, self.rbac = controllers, codec, rbac
        self.FakeClock = FakeClock

    def mod(self, name: str):
        """The package's ``controllers.<name>`` module."""
        import importlib

        root = "kubernetes_tpu" if self.pkg == "jax" else "kubernetes_tpu_torch"
        return importlib.import_module(f"{root}.controllers.{name}")

    def manager(self, store, controllers=None, clock=None, **kw):
        return self.controllers.ControllerManager(
            store, factory=self.client.SharedInformerFactory(store), controllers=controllers,
            now_fn=clock if clock is not None else self.FakeClock(), **kw)

    def template(self, labels=None):
        pw = self.make_pod("template").req({"cpu": "100m"})
        for key, v in (labels or {}).items():
            pw.label(key, v)
        return pw.obj()


KITS = {pkg: CKit(pkg) for pkg in ("jax", "port")}


def _norm(v):
    if isinstance(v, dict):
        return {k: (bool(x) if k == "deletion_timestamp" else _norm(x))
                for k, x in v.items() if k not in WALL_FIELDS}
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


def state(k, store, m=None) -> dict:
    """Every object of every kind in wire form; with the manager ``m``, each
    controller's requeue counts and queue length."""
    out = {kind: {key: _norm(k.codec.to_wire(obj))
                  for key, obj in sorted(store.snapshot_map(kind).items())}
           for kind in KINDS}
    out["pod_metrics"] = dict(sorted(store.pod_metrics.items()))
    if m is not None:
        out["queues"] = {name: (sorted(c.queue._failures.items()), len(c.queue))
                         for name, c in m.controllers.items()}
    return out


def run(script):
    """``script(kit)`` on both packages (equal outputs); the port's output."""
    return both(lambda k: script(k if isinstance(k, CKit) else KITS[k.pkg]))


def replace(obj, **changes):
    """A copy with a copied meta (how every store writer updates)."""
    new = dataclasses.replace(obj, **changes)
    new.meta = dataclasses.replace(obj.meta)
    return new


def set_phase(store, key, phase, node=None):
    p = store.get_pod(key).clone()
    p.status.phase = phase
    if node is not None:
        p.spec.node_name = node
    store.update_pod(p)


def mark_running(store):
    for key, p in sorted(store.pods.items()):
        if p.status.phase == "Pending":
            set_phase(store, key, "Running")


def settle_sequential(sched) -> int:
    """``schedule_one`` until the active queue stays empty after a backoff
    flush (the JAX ``Scheduler.run_until_settled``, ``scheduler/
    scheduler.py:922-934``, and the harness's ``oracle`` settle)."""
    cycles = 0
    while cycles < 100000:
        if not sched.schedule_one():
            sched.queue.flush_backoff_completed()
            if sched.queue.pending_pods()["active"] > 0:
                continue
            break
        cycles += 1
    return cycles


# ------------------------------------------------------------ workloads


def test_replicaset_scale_up_down_and_restore():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["replicaset"])
        store.create_replica_set(t.ReplicaSet(
            meta=t.ObjectMeta(name="web"), selector=t.LabelSelector(match_labels={"app": "web"}),
            replicas=3, template=k.template({"app": "web"})))
        out = [m.settle(), state(k, store, m)]
        keys = sorted(store.pods)
        k.bind(store, keys[0], "n1")
        k.bind(store, keys[1], "n1")
        store.update_object("ReplicaSet", replace(store.get_replica_set("default/web"),
                                                  replicas=2))
        out += [m.settle(), state(k, store, m)]
        store.delete_pod(sorted(store.pods)[0])
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert len(out[1]["Pod"]) == 3
    assert all(p["meta"]["owner_references"][0]["name"] == "web"
               for p in out[1]["Pod"].values())
    remaining = out[3]["Pod"]
    assert len(remaining) == 2 and all(p["spec"]["node_name"] for p in remaining.values())
    assert len(out[5]["Pod"]) == 2


@pytest.mark.parametrize("what", ["create", "scale"])
def test_deployment_creates_and_scales(what):
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["deployment", "replicaset"])
        dep = t.Deployment(meta=t.ObjectMeta(name="api"), replicas=2 if what == "create" else 1,
                           template=k.template())
        store.create_object("Deployment", dep)
        out = [m.settle(), state(k, store, m)]
        if what == "scale":
            store.update_object("Deployment", replace(dep, replicas=4))
            out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert [k for k in out[1]["ReplicaSet"] if k.startswith("default/api-")]
    assert len(out[-1]["Pod"]) == (2 if what == "create" else 4)


@pytest.mark.parametrize("strategy,surge,unavailable,replicas", [
    ("RollingUpdate", 1, 1, 4), ("RollingUpdate", 0, 1, 3), ("Recreate", 1, 1, 2)],
    ids=["rolling", "zero-surge", "recreate"])
def test_deployment_rollout(strategy, surge, unavailable, replicas):
    """The JAX rollout tests (``tests/test_controllers.py:94-200``): the
    rollout driven stepwise, every step's store and queues equal."""
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["deployment", "replicaset"])
        dep = t.Deployment(meta=t.ObjectMeta(name="api"), replicas=replicas,
                           template=k.template({"v": "1"}), strategy=strategy,
                           max_surge=surge, max_unavailable=unavailable)
        store.create_object("Deployment", dep)
        out = [m.settle()]
        mark_running(store)
        out += [m.settle(), state(k, store, m)]
        store.update_object("Deployment", replace(dep, template=k.template({"v": "2"})))
        for _ in range(30):
            out += [m.settle(), state(k, store, m)]
            mark_running(store)
            if (len(store.pods) == replicas
                    and all(p.meta.labels.get("v") == "2" for p in store.pods.values())):
                break
        return out

    out = run(script)
    steps = [s for s in out if isinstance(s, dict)]
    for st in steps[1:]:
        alive = [p for p in st["Pod"].values() if p["status"]["phase"] in ("Pending", "Running")]
        assert len(alive) <= replicas + surge
        if strategy == "Recreate":
            assert len({p["meta"]["labels"]["v"] for p in alive}) <= 1
    final = steps[-1]["Pod"]
    assert {p["meta"]["labels"]["v"] for p in final.values()} == {"2"}


def test_statefulset_ordered_creation():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["statefulset"])
        store.create_stateful_set(t.StatefulSet(meta=t.ObjectMeta(name="db"), replicas=3,
                                                template=k.template()))
        out = [m.settle(), state(k, store, m)]
        for i in range(3):
            set_phase(store, f"default/db-{i}", "Running")
            out += [m.settle(), state(k, store, m)]
        store.update_object("StatefulSet", replace(store.get_stateful_set("default/db"),
                                                   replicas=1))
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert sorted(out[1]["Pod"]) == ["default/db-0"]
    assert "default/db-1" in out[3]["Pod"]
    assert sorted(out[-1]["Pod"]) == ["default/db-0"]


def test_daemonset_one_pod_per_node():
    def script(k):
        t = k.types
        store = k.new_store()
        for i in range(3):
            store.create_node(k.make_node(f"n{i}").obj())
        m = k.manager(store, ["daemonset"])
        store.create_object("DaemonSet", t.DaemonSet(meta=t.ObjectMeta(name="agent"),
                                                     template=k.template()))
        out = [m.settle(), state(k, store, m)]
        store.create_node(k.make_node("n3").obj())
        out += [m.settle(), state(k, store, m)]
        store.delete_node("n0")
        out += [m.settle(), state(k, store, m)]
        store.delete_pod(sorted(store.pods)[0])
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert [len(out[i]["Pod"]) for i in (1, 3, 5, 7)] == [3, 4, 3, 3]


def test_job_runs_to_completion():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["job"])
        store.create_object("Job", t.Job(meta=t.ObjectMeta(name="batch"), completions=3,
                                         parallelism=2, template=k.template()))
        out = [m.settle(), state(k, store, m)]
        for key in sorted(store.pods):
            set_phase(store, key, "Succeeded")
        out += [m.settle(), state(k, store, m)]
        for key, p in sorted(store.pods.items()):
            if p.status.phase == "Pending":
                set_phase(store, key, "Succeeded")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert len(out[1]["Pod"]) == 2
    assert out[3]["Job"]["default/batch"]["succeeded"] == 2
    job = out[5]["Job"]["default/batch"]
    assert job["succeeded"] == 3 and job["condition"] == "Complete"


def test_replication_controller():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["replicationcontroller"])
        store.create_replication_controller(t.ReplicationController(
            meta=t.ObjectMeta(name="old-school"), selector={"app": "x"}, replicas=3,
            template=k.template({"app": "x"})))
        out = [m.settle(), state(k, store, m)]
        store.delete_pod(sorted(store.pods)[0])
        out += [m.settle(), state(k, store, m)]
        store.update_object("ReplicationController", replace(
            store.get_replication_controller("default/old-school"), replicas=1))
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert [len(out[i]["Pod"]) for i in (1, 3, 5)] == [3, 3, 1]


# ------------------------------------------------------------ node lifecycle


@pytest.mark.parametrize("case", ["evict", "recover", "pressure"])
def test_node_lifecycle(case):
    """Missed heartbeats: NotReady and the unreachable NoExecute taint past
    the 40 s grace, the pod evicted past its 300 s default toleration;
    a renewed Lease clears both; kubelet pressure conditions mirrored as
    NoSchedule taints. The evicted-pods counter on the manager's metrics."""
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        metrics = (__import__("kubernetes_tpu.metrics.scheduler_metrics", fromlist=["x"])
                   if k.pkg == "jax" else
                   __import__("kubernetes_tpu_torch.metrics.scheduler_metrics",
                              fromlist=["x"])).SchedulerMetrics()
        m = k.manager(store, ["nodelifecycle"], clock=clock, metrics=metrics)
        nl = k.mod("nodelifecycle")
        store.create_node(k.make_node("n1").obj())
        store.create_lease(t.Lease(meta=t.ObjectMeta(name="n1",
                                                     namespace=nl.NODE_LEASE_NAMESPACE),
                                   renew_time=clock()))
        store.create_pod(k.make_pod("victim").obj())
        store.pods["default/victim"].spec.node_name = "n1"
        out = [m.sync_round(monitor_nodes=True), state(k, store, m)]
        if case == "pressure":
            node = store.nodes["n1"]
            store.update_node(replace(node, status=dataclasses.replace(
                node.status, memory_pressure=True)))
            out += [m.sync_round(monitor_nodes=True), state(k, store, m)]
            node = store.nodes["n1"]
            store.update_node(replace(node, status=dataclasses.replace(
                node.status, memory_pressure=False, disk_pressure=True)))
            out += [m.sync_round(monitor_nodes=True), state(k, store, m)]
            return out
        clock.advance(60.0)
        out += [m.sync_round(monitor_nodes=True), state(k, store, m)]
        if case == "evict":
            clock.advance(301.0)
            out += [m.sync_round(monitor_nodes=True), state(k, store, m)]
            out.append(metrics.evicted_pods.labels("taint"))
            return out
        stored = store.get_lease(f"{nl.NODE_LEASE_NAMESPACE}/n1")
        store.update_lease(replace(stored, renew_time=clock()),
                           expect_rv=stored.meta.resource_version)
        out += [m.sync_round(monitor_nodes=True), state(k, store, m)]
        return out

    out = run(script)
    node = out[1]["Node"]["n1"]
    assert node["status"]["ready"]
    if case == "pressure":
        keys = [[tt["key"] for tt in s["Node"]["n1"]["spec"]["taints"]] for s in out[3::2]]
        assert keys == [["node.kubernetes.io/memory-pressure"],
                        ["node.kubernetes.io/disk-pressure"]]
        return
    node = out[3]["Node"]["n1"]
    assert not node["status"]["ready"]
    assert [tt["key"] for tt in node["spec"]["taints"]] == ["node.kubernetes.io/unreachable"]
    assert "default/victim" in out[3]["Pod"]
    if case == "evict":
        assert "default/victim" not in out[5]["Pod"] and out[6] == 1
    else:
        node = out[5]["Node"]["n1"]
        assert node["status"]["ready"] and not node["spec"].get("taints")


# ------------------------------------------------------------ housekeeping


def test_podgc_and_garbage_collector():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["podgc", "replicaset", "garbagecollector"])
        store.create_node(k.make_node("n1").obj())
        store.create_pod(k.make_pod("p").obj())
        store.pods["default/p"].spec.node_name = "ghost-node"
        store.create_replica_set(t.ReplicaSet(meta=t.ObjectMeta(name="web"), replicas=2,
                                              template=k.template()))
        out = [m.settle(), state(k, store, m)]
        store.delete_object("ReplicaSet", "default/web")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert "default/p" not in out[1]["Pod"] and len(out[1]["Pod"]) == 2
    assert out[3]["Pod"] == {}


def test_namespace_deletion_cascades():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["namespace"])
        store.create_namespace(t.Namespace(meta=t.ObjectMeta(name="doomed")))
        store.create_pod(k.make_pod("p", namespace="doomed").obj())
        store.create_service(t.Service(meta=t.ObjectMeta(name="s", namespace="doomed")))
        ns = store.namespaces["doomed"]
        ns.meta.deletion_timestamp = 1.0
        store._notify("Namespace", "MODIFIED", ns, ns)
        return [m.settle(), state(k, store, m)]

    out = run(script)
    assert not out[1]["Pod"] and not out[1]["Service"] and "doomed" not in out[1]["Namespace"]


@pytest.mark.parametrize("case", ["running", "relabel"])
def test_endpoints_track_running_pods(case):
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["endpoints"])
        store.create_service(t.Service(meta=t.ObjectMeta(name="svc"), selector={"app": "web"}))
        p = k.make_pod("p1").label("app", "web").obj()
        if case == "relabel":
            p.status.phase = "Running"
        store.create_pod(p)
        out = [m.settle(), state(k, store, m)]
        if case == "running":
            set_phase(store, "default/p1", "Running", node="n1")
        else:
            relabeled = store.get_pod("default/p1").clone()
            relabeled.meta.labels = {"app": "other"}
            store.update_pod(relabeled)
        out += [m.settle(), state(k, store, m)]
        store.delete_object("Service", "default/svc")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    addrs = [[a["pod_key"] for a in s["Endpoints"]["default/svc"].get("addresses", [])]
             for s in (out[1], out[3])]
    assert addrs == ([[], ["default/p1"]] if case == "running" else [["default/p1"], []])
    assert not out[5]["Endpoints"]


def test_pv_binder_immediate():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["pvbinder"])
        store.create_storage_class(t.StorageClass(meta=t.ObjectMeta(name="fast"),
                                                  volume_binding_mode=t.BINDING_IMMEDIATE))
        for name, cap in (("pv-big", 100), ("pv-small", 10)):
            store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name=name),
                                               storage_class="fast", capacity_bytes=cap))
        store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="claim"),
                                                 storage_class="fast", requested_bytes=5))
        return [m.settle(), state(k, store, m)]

    out = run(script)
    assert out[1]["PersistentVolumeClaim"]["default/claim"]["bound_pv"] == "pv-small"


def test_resource_quota_controller_reconciles_after_delete():
    def script(k):
        t = k.types
        store = k.new_store()
        store.create_object("ResourceQuota", t.ResourceQuota(meta=t.ObjectMeta(name="q"),
                                                             hard={"pods": 5}))
        store.create_pod(k.make_pod("a").obj())
        store.create_pod(k.make_pod("b").obj())
        store.delete_pod("default/a")
        m = k.manager(store, ["resourcequota"])
        out = [m.settle(), state(k, store, m)]
        store.create_pod(k.make_pod("c").obj())
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert out[1]["ResourceQuota"]["default/q"]["used"] == {"pods": 1}
    assert out[3]["ResourceQuota"]["default/q"]["used"] == {"pods": 2}


# ------------------------------------------------------------ disruption


@pytest.mark.parametrize("case", ["min-available", "percent", "unbound"])
def test_disruption_status(case):
    """``tests/test_disruption_admission.py:36-82``: the PDB status from
    minAvailable / maxUnavailable (ints and percentages), following pod
    deletes; unbound pods are not healthy."""
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["disruption"])
        sel = t.LabelSelector(match_labels={"app": "db"})
        if case == "min-available":
            pdb = t.PodDisruptionBudget(meta=t.ObjectMeta(name="pdb"), selector=sel,
                                        min_available=2)
        elif case == "percent":
            pdb = t.PodDisruptionBudget(meta=t.ObjectMeta(name="pdb"), selector=sel,
                                        max_unavailable="25%")
        else:
            pdb = t.PodDisruptionBudget(meta=t.ObjectMeta(name="pdb"), selector=sel,
                                        min_available="50%")
        store.create_pdb(pdb)
        for i in range(4):
            pw = k.make_pod(f"db-{i}").label("app", "db")
            if case != "unbound" or i < 2:
                pw = pw.node("n1")
            store.create_pod(pw.obj())
        store.create_pod(k.make_pod("other").node("n1").obj())
        out = [m.settle(), state(k, store, m)]
        store.delete_pod("default/db-0")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)

    def status(st):
        p = st["PodDisruptionBudget"]["default/pdb"]
        return (p["expected_pods"], p["current_healthy"], p["desired_healthy"],
                p["disruptions_allowed"])

    want = {"min-available": [(4, 4, 2, 2), (3, 3, 2, 1)],
            "percent": [(4, 4, 3, 1), (3, 3, 2, 1)],
            "unbound": [(4, 2, 2, 0), (3, 1, 2, 0)]}[case]
    assert [status(out[1]), status(out[3])] == want


def test_preemption_reads_the_live_budgets():
    """``tests/test_disruption_admission.py:146-182``: the disruption
    controller keeps the PDB status, and the sequential scheduler's
    preemption prefers the node whose victims its budget lets go."""
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        m = k.manager(store, ["disruption"], clock=clock)
        sched = k.Scheduler(store, now_fn=clock)
        for i in range(2):
            store.create_node(k.make_node(f"n{i}").capacity(
                {"cpu": "2", "memory": "4Gi", "pods": 10}).obj())
        for i, app in enumerate(("guarded", "guarded", "free", "free")):
            store.create_pod(k.make_pod(f"low-{i}").label("app", app).priority(0)
                             .req({"cpu": "1"}).node(f"n{i // 2}").obj())
        store.create_pdb(t.PodDisruptionBudget(
            meta=t.ObjectMeta(name="guard"),
            selector=t.LabelSelector(match_labels={"app": "guarded"}), min_available=2))
        out = [m.settle(), state(k, store, m)]
        store.create_pod(k.make_pod("high").priority(100).req({"cpu": "1"}).obj())
        out.append(settle_sequential(sched))
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert out[1]["PodDisruptionBudget"]["default/guard"]["disruptions_allowed"] == 0
    high = out[4]["Pod"]["default/high"]
    assert high["status"].get("nominated_node_name") == "n1" or high["spec"]["node_name"] == "n1"
    assert "default/low-0" in out[4]["Pod"] and "default/low-1" in out[4]["Pod"]


# ------------------------------------------------------------ finalizers


@pytest.mark.parametrize("kind", ["PersistentVolumeClaim", "ConfigMap", "Namespace"])
def test_store_finalizers(kind):
    """The store's finalizer semantics (JAX ``apiserver/store.py:664-729``):
    a delete of an object with finalizers only marks it terminating (once);
    an update keeps the stored deletion mark (a Namespace keeps the
    client's); the update that clears the last finalizer completes the
    delete; the journal sees MODIFIED then DELETED."""
    def script(k):
        t = k.types
        store = k.new_store()
        ctor = {"PersistentVolumeClaim": t.PersistentVolumeClaim, "ConfigMap": t.ConfigMap,
                "Namespace": t.Namespace}[kind]
        key = "default/x" if kind != "Namespace" else "x"
        ns = "default" if kind != "Namespace" else ""
        store.create_object(kind, ctor(meta=t.ObjectMeta(name="x", namespace=ns,
                                                          finalizers=("a", "b"))))
        w = store.watch(kind, since=store.list_objects(kind)[1])
        out = [state(k, store)]
        store.delete_object(kind, key)
        store.delete_object(kind, key)  # already terminating: no second mark
        out.append(state(k, store))
        cur = store.get_object(kind, key)
        # an update cannot clear (or, but on a Namespace, move) the mark
        new = replace(cur)
        new.meta.deletion_timestamp = 0.0
        new.meta.finalizers = ("b",)
        store.update_object(kind, new)
        out.append(state(k, store))
        new = replace(store.get_object(kind, key))
        new.meta.finalizers = ()
        store.update_object(kind, new)
        out.append(state(k, store))
        out.append([(ev.type, ev.object.meta.name, tuple(ev.object.meta.finalizers),
                     bool(ev.object.meta.deletion_timestamp)) for ev in w.drain()])
        return out

    out = run(script)
    key = "default/x" if kind != "Namespace" else "x"
    bucket = kind
    assert out[1][bucket][key]["meta"]["deletion_timestamp"] is True
    if kind == "Namespace":
        # a Namespace keeps the client's (cleared) mark: the update lands
        assert out[2][bucket][key]["meta"]["deletion_timestamp"] is False
        assert key in out[3][bucket]
    else:
        assert out[2][bucket][key]["meta"]["deletion_timestamp"] is True
        assert key not in out[3][bucket]
        assert [e[0] for e in out[4]] == ["MODIFIED", "MODIFIED", "DELETED"]


def test_delete_without_finalizers_removes_at_once():
    def script(k):
        t = k.types
        store = k.new_store()
        store.create_object("ConfigMap", t.ConfigMap(meta=t.ObjectMeta(name="cm")))
        store.delete_object("ConfigMap", "default/cm")
        store.delete_object("ConfigMap", "default/cm")  # gone: a no-op
        return state(k, store)

    assert not run(script)["ConfigMap"]
