"""The rest of the port's controllers against the JAX package's, on the CPU,
as ``tests/test_torch_controllers.py`` holds them (one store script per
case through each package's ``ControllerManager`` on a FakeClock; every
object of every kind, the reconcile counts and the requeue counts equal):
serviceaccount, root-ca-cert-publisher, ttl-after-finished, pvc- and
pv-protection over the store's finalizers, nodeipam, endpointslice and its
mirroring, ephemeral-volume, horizontalpodautoscaling, ttl, cronjob with
``cron_matches``, the Job's failure policy, attachdetach, the certificate
loops (csrapproving, csrsigning, csrcleaner, clusterrole-aggregation,
tokencleaner, bootstrapsigner, persistentvolume-expander) and the podgroup
controller beside the Coscheduling plugin. They mirror
``tests/test_controllers_breadth.py``, ``tests/test_controllers_extras.py``,
``tests/test_certificates.py`` and ``tests/test_podgroup_controller.py``,
whose bars then hold on the port's record."""

import pytest

from test_torch_controllers import replace, run, set_phase, settle_sequential, state

# ------------------------------------------------------------ serviceaccount, root CA


def test_default_sa_and_ca_configmap_per_namespace():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["serviceaccount", "root-ca-cert-publisher"])
        store.create_namespace(t.Namespace(meta=t.ObjectMeta(name="team-a")))
        out = [m.settle(), state(k, store, m)]
        store.delete_object("ServiceAccount", "team-a/default")
        store.delete_object("ConfigMap", "team-a/kube-root-ca.crt")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    for st in (out[1], out[3]):
        assert "team-a/default" in st["ServiceAccount"]
        assert "ca.crt" in st["ConfigMap"]["team-a/kube-root-ca.crt"]["data"]


@pytest.mark.parametrize("ttl", [60, None], ids=["ttl", "no-ttl"])
def test_ttl_after_finished(ttl):
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        m = k.manager(store, ["ttlafterfinished"], clock=clock)
        store.create_object("Job", t.Job(meta=t.ObjectMeta(name="burn"), condition="Complete",
                                         completion_time=clock(),
                                         ttl_seconds_after_finished=ttl))
        out = [m.settle(), state(k, store, m)]
        clock.advance(61 if ttl else 10000)
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert "default/burn" in out[1]["Job"]
    assert ("default/burn" in out[3]["Job"]) == (ttl is None)


# ------------------------------------------------------------ protection finalizers


@pytest.mark.parametrize("used", [True, False], ids=["in-use", "unused"])
def test_pvc_protection(used):
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["pvcprotection"])
        store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="data")))
        out = [m.settle(), state(k, store, m)]
        if used:
            store.create_pod(k.make_pod("user").req({"cpu": "1"}).pvc("data").obj())
            out += [m.settle(), state(k, store, m)]
        store.delete_object("PersistentVolumeClaim", "default/data")
        out += [m.settle(), state(k, store, m)]
        if used:
            store.delete_pod("default/user")
            out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert out[1]["PersistentVolumeClaim"]["default/data"]["meta"]["finalizers"] == [
        "kubernetes.io/pvc-protection"]
    if used:
        assert out[5]["PersistentVolumeClaim"]["default/data"]["meta"]["deletion_timestamp"]
    assert "default/data" not in out[-1]["PersistentVolumeClaim"]


def test_pv_protection():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["pvprotection"])
        store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name="vol"), capacity_bytes=1 << 30,
                                           bound_pvc="default/data"))
        out = [m.settle()]
        store.delete_object("PersistentVolume", "vol")
        out += [m.settle(), state(k, store, m)]
        store.update_object("PersistentVolume", replace(store.get_object("PersistentVolume",
                                                                         "vol"), bound_pvc=""))
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert out[2]["PersistentVolume"]["vol"]["meta"]["deletion_timestamp"] is True
    assert "vol" not in out[4]["PersistentVolume"]


# ------------------------------------------------------------ nodeipam


def test_nodeipam_allocates_and_reuses_cidrs():
    def script(k):
        store = k.new_store()
        m = k.manager(store, ["nodeipam"])
        for i in range(5):
            store.create_node(k.make_node(f"n{i}").capacity({"cpu": "4"}).obj())
        out = [m.settle(), state(k, store, m)]
        store.delete_node("n1")
        out.append(m.settle())
        store.create_node(k.make_node("n9").capacity({"cpu": "4"}).obj())
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    cidrs = [out[1]["Node"][f"n{i}"]["spec"]["pod_cidr"] for i in range(5)]
    assert all(c.endswith("/24") for c in cidrs) and len(set(cidrs)) == 5
    assert out[4]["Node"]["n9"]["spec"]["pod_cidr"] == cidrs[1]


# ------------------------------------------------------------ endpoint slices


@pytest.mark.parametrize("selector", [False, True], ids=["selectorless", "selector"])
def test_endpointslice_mirroring(selector):
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["endpointslicemirroring"])
        store.create_service(t.Service(meta=t.ObjectMeta(name="ext"),
                                       selector={"app": "web"} if selector else {}))
        store.create_object("Endpoints", t.Endpoints(
            meta=t.ObjectMeta(name="ext"),
            addresses=(t.EndpointAddress(pod_key="x/y", node_name="n1"),)))
        return [m.settle(), state(k, store, m)]

    out = run(script)
    assert ("default/ext-mirror" in out[1]["EndpointSlice"]) == (not selector)


def test_endpointslices_shard_and_track_pods():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["endpointslice"])
        store.create_object("Service", t.Service(meta=t.ObjectMeta(name="web"),
                                                 selector={"app": "web"}))
        for i in range(150):
            p = k.make_pod(f"w{i}").req({"cpu": "1m"}).label("app", "web").node("n1").obj()
            p.status.phase = "Running"
            store.create_pod(p)
        out = [m.settle(), state(k, store, m)]
        store.delete_pod("default/w0")
        out += [m.settle(), state(k, store, m)]
        store.delete_object("Service", "default/web")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    slices = out[1]["EndpointSlice"]
    assert len(slices) == 2 and sum(len(s["addresses"]) for s in slices.values()) == 150
    assert sum(len(s["addresses"]) for s in out[3]["EndpointSlice"].values()) == 149
    assert not out[5]["EndpointSlice"]


# ------------------------------------------------------------ the full manager


@pytest.mark.parametrize("case", ["mirroring", "ephemeral-gc", "namespace-sweep"])
def test_full_manager(case):
    """The default initializer set over one store: the endpoint loops leave
    user-managed Endpoints alone; an ephemeral PVC goes with its pod; a
    terminating namespace is swept of the new kinds."""
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store)
        if case == "mirroring":
            store.create_service(t.Service(meta=t.ObjectMeta(name="ext")))
            store.create_object("Endpoints", t.Endpoints(
                meta=t.ObjectMeta(name="ext"),
                addresses=(t.EndpointAddress(pod_key="x/y", node_name="n1"),)))
            return [m.settle(), state(k, store, m)]
        if case == "ephemeral-gc":
            pod = k.make_pod("worker").req({"cpu": "1"}).obj()
            pod.spec.ephemeral_claims = ("scratch",)
            store.create_pod(pod)
            out = [m.settle(), state(k, store, m)]
            store.delete_pod("default/worker")
            return out + [m.settle(), state(k, store, m)]
        store.create_namespace(t.Namespace(meta=t.ObjectMeta(name="doomed")))
        out = [m.settle()]
        store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="data",
                                                                   namespace="doomed")))
        out += [m.settle(), state(k, store, m)]
        ns = store.namespaces["doomed"]
        ns.meta.deletion_timestamp = 1.0
        store.create_namespace(ns)  # re-notify: the store has no namespace delete verb
        return out + [m.settle(), state(k, store, m)]

    out = run(script)
    if case == "mirroring":
        assert out[1]["Endpoints"]["default/ext"]["addresses"]
        assert out[1]["EndpointSlice"]["default/ext-mirror"]["addresses"][0]["pod_key"] == "x/y"
    elif case == "ephemeral-gc":
        pvc = out[1]["PersistentVolumeClaim"]["default/worker-scratch"]
        assert pvc["meta"]["owner_references"][0]["kind"] == "Pod"
        assert "default/worker-scratch" not in out[3]["PersistentVolumeClaim"]
    else:
        assert "doomed/default" in out[2]["ServiceAccount"]
        final = out[4]
        assert "doomed" not in final["Namespace"] and "doomed/default" not in final[
            "ServiceAccount"]
        assert not final["ConfigMap"] and not final["PersistentVolumeClaim"]


# ------------------------------------------------------------ HPA


def _hpa_workload(k, store, replicas):
    t = k.types
    owner = t.OwnerReference
    store.create_object("Deployment", t.Deployment(meta=t.ObjectMeta(name="web"),
                                                   replicas=replicas))
    store.create_object("ReplicaSet", t.ReplicaSet(
        meta=t.ObjectMeta(name="web-1", owner_references=(
            owner(kind="Deployment", name="web", controller=True),)), replicas=replicas))
    for i in range(replicas):
        p = k.make_pod(f"web-{i}").req({"cpu": "1"}).obj()
        p.meta.owner_references = (owner(kind="ReplicaSet", name="web-1", controller=True),)
        p.status.phase = "Running"
        store.create_pod(p)


@pytest.mark.parametrize("case", ["scale-up", "tolerance-clamp", "stabilization",
                                  "missing-metrics"])
def test_hpa(case):
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        m = k.manager(store, ["horizontalpodautoscaling"], clock=clock)
        _hpa_workload(k, store, 5 if case == "missing-metrics" else 2)
        store.create_object("HorizontalPodAutoscaler", t.HorizontalPodAutoscaler(
            meta=t.ObjectMeta(name="web"), target_name="web", min_replicas=1,
            max_replicas=3 if case == "tolerance-clamp" else 8, target_cpu_utilization=50))
        steps = {"scale-up": [(1000, 1000)], "missing-metrics": [(1000, 1000)],
                 "tolerance-clamp": [(520, 480), (5000, 5000)],
                 "stabilization": [(1000, 1000), (10, 10), None]}[case]
        out = []
        for step in steps:
            if step is None:
                clock.advance(301)
            else:
                store.pod_metrics["default/web-0"], store.pod_metrics["default/web-1"] = step
            out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    reps = [st["Deployment"]["default/web"]["replicas"] for st in out[1::2]]
    want = {"scale-up": lambda r: r == [4], "missing-metrics": lambda r: r[0] >= 5,
            "tolerance-clamp": lambda r: r == [2, 3],
            "stabilization": lambda r: r[:2] == [4, 4] and r[2] < 4}[case]
    assert want(reps), reps


# ------------------------------------------------------------ ttl, cronjob, jobs, attach


def test_ttl_annotation_tracks_cluster_size_tier():
    def script(k):
        store = k.new_store()
        m = k.manager(store, ["ttl"])
        for i in range(5):
            store.create_node(k.make_node(f"n{i}").obj())
        out = [m.settle(), state(k, store, m)]
        for i in range(5, 120):
            store.create_node(k.make_node(f"n{i}").obj())
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    key = "node.alpha.kubernetes.io/ttl"
    assert out[1]["Node"]["n0"]["meta"]["annotations"][key] == "0"
    assert {n["meta"]["annotations"][key] for n in out[3]["Node"].values()} == {"15"}


def test_cron_matches():
    cases = [("* * * * *", 0), ("*/5 * * * *", 300), ("*/5 * * * *", 60), ("0 0 * * *", 0),
             ("0 1 * * *", 0), ("0-30 * * * *", 60 * 20), ("5,10 2-4 * 1-6 1-5", 1.7e9),
             ("0 12 1 */2 0", 1.7e9 + 86400 * 11)]

    def script(k):
        ex = k.mod("extras")
        out = [ex.cron_matches(s, ts) for s, ts in cases]
        out.append(sorted(ex.parse_cron_field("*/15,7,20-22", 0, 59)))
        out.append(ex.parse_cron_field("*", 0, 59))
        return out

    out = run(script)
    assert out[:6] == [True, True, False, True, False, True]


def test_cronjob_spawns_jobs_on_schedule():
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        m = k.manager(store, ["cronjob", "job"], clock=clock)
        clock.advance((300 - clock() % 300) % 300)
        store.create_object("CronJob", t.CronJob(meta=t.ObjectMeta(name="tick"),
                                                 schedule="*/5 * * * *",
                                                 template=k.make_pod("t").req(
                                                     {"cpu": "1m"}).obj()))
        out = [m.settle(), state(k, store, m), m.settle()]
        for dt in (300, 60):
            clock.advance(dt)
            out += [m.settle(), state(k, store, m)]
        store.cron_jobs["default/tick"].suspend = True
        clock.advance(240)
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert [len(out[i]["Job"]) for i in (1, 4, 6, 8)] == [1, 2, 2, 2]


@pytest.mark.parametrize("case", ["backoff-limit", "active-deadline", "complete"])
def test_job_failure_policy(case):
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        m = k.manager(store, ["job"], clock=clock)
        job = t.Job(meta=t.ObjectMeta(name="j"), completions=2 if case == "complete" else 1,
                    parallelism=2 if case == "complete" else 1,
                    template=k.make_pod("t").req({"cpu": "1m"}).obj())
        if case == "backoff-limit":
            job.backoff_limit = 2
        if case == "active-deadline":
            job.active_deadline_seconds = 30
        store.create_object("Job", job)
        out = []
        if case == "backoff-limit":
            for _ in range(6):
                out += [m.settle(), state(k, store, m)]
                pending = [key for key, p in sorted(store.pods.items())
                           if p.status.phase == "Pending"]
                if pending:
                    set_phase(store, pending[0], "Failed")
        elif case == "active-deadline":
            out += [m.settle(), state(k, store, m)]
            clock.advance(31)
        else:
            out.append(m.settle())
            for key in sorted(store.pods):
                set_phase(store, key, "Succeeded")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    job = out[-1]["Job"]["default/j"]
    want = {"backoff-limit": ("Failed", "BackoffLimitExceeded"),
            "active-deadline": ("Failed", "DeadlineExceeded"), "complete": ("Complete", "")}[case]
    assert (job["condition"], job["failed_reason"]) == want
    if case == "backoff-limit":
        assert job["failed"] > 2
        assert not [p for p in out[-1]["Pod"].values()
                    if p["status"]["phase"] in ("Pending", "Running")]


def test_attach_and_detach_follow_pod_lifecycle():
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["attachdetach"])
        store.create_object("PersistentVolume", t.PersistentVolume(
            meta=t.ObjectMeta(name="pv1"), capacity_bytes=1 << 30, bound_pvc="default/claim1"))
        store.create_object("PersistentVolumeClaim", t.PersistentVolumeClaim(
            meta=t.ObjectMeta(name="claim1"), bound_pv="pv1"))
        pod = k.make_pod("user").req({"cpu": "1m"}).obj()
        pod.spec.volumes = ("claim1",)
        pod.spec.node_name = "n1"
        store.create_pod(pod)
        out = [m.settle(), state(k, store, m)]
        store.delete_pod("default/user")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    va = out[1]["VolumeAttachment"]["pv1^n1"]
    assert (va["pv_name"], va["node_name"], va["attached"]) == ("pv1", "n1", True)
    assert not out[3]["VolumeAttachment"]


# ------------------------------------------------------------ certificates


def _csr(k, name="node-csr", username="system:node:n1", signer=None, **kw):
    cert = k.mod("certificates")
    return k.types.CertificateSigningRequest(
        meta=k.types.ObjectMeta(name=name), signer_name=signer or cert.KUBELET_CLIENT_SIGNER,
        username=username, usages=("client auth",), request="blob", **kw)


@pytest.mark.parametrize("case", ["kubelet", "non-node", "denied"])
def test_csr_approve_and_sign(case):
    def script(k):
        store = k.new_store()
        m = k.manager(store, ["csrapproving", "csrsigning"])
        csr = {"kubelet": lambda: _csr(k),
               "non-node": lambda: _csr(k, username="alice"),
               "denied": lambda: _csr(k, approved=True, denied=True)}[case]()
        store.create_object("CertificateSigningRequest", csr)
        return [m.settle(), state(k, store, m)]

    out = run(script)
    csr = out[1]["CertificateSigningRequest"]["node-csr"]
    signed = csr["certificate"].startswith("-----BEGIN CERTIFICATE-----")
    assert signed == (case == "kubelet")
    assert csr["approved"] == (case != "non-node")


def test_csr_cleaner_drops_stale_pending_and_old_issued():
    def script(k):
        store = k.new_store()
        clock = k.FakeClock(10_000.0)
        m = k.manager(store, ["csrcleaner"], clock=clock)
        store.create_object("CertificateSigningRequest", _csr(k, name="stale-pending"))
        store.csrs["stale-pending"].meta.creation_timestamp = 100.0
        store.create_object("CertificateSigningRequest", _csr(
            k, name="old-issued", approved=True, certificate="cert", issued_at=100.0))
        store.create_object("CertificateSigningRequest", _csr(k, name="fresh"))
        clock.advance(90_000.0)
        store.csrs["fresh"].meta.creation_timestamp = clock() - 10.0
        return [m.settle(), state(k, store, m)]

    out = run(script)
    assert sorted(out[1]["CertificateSigningRequest"]) == ["fresh"]


def test_clusterrole_aggregation():
    def script(k):
        t, rbac = k.types, k.rbac
        store = k.new_store()
        m = k.manager(store, ["clusterrole-aggregation"])
        label = {"rbac.example.com/aggregate-to-view": "true"}
        store.create_object("ClusterRole", rbac.ClusterRole(
            meta=t.ObjectMeta(name="view-pods", labels=dict(label)),
            rules=(rbac.PolicyRule(verbs=("get", "list"), resources=("Pod",)),)))
        store.create_object("ClusterRole", rbac.ClusterRole(
            meta=t.ObjectMeta(name="view"), aggregation_selectors=(dict(label),)))
        out = [m.settle(), state(k, store, m)]
        store.create_object("ClusterRole", rbac.ClusterRole(
            meta=t.ObjectMeta(name="view-services", labels=dict(label)),
            rules=(rbac.PolicyRule(verbs=("get",), resources=("Service",)),)))
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    res = [{r for rule in st["ClusterRole"]["view"].get("rules", []) for r in rule["resources"]}
           for st in (out[1], out[3])]
    assert res == [{"Pod"}, {"Pod", "Service"}]


def test_bootstrap_tokens():
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock(5000.0)
        m = k.manager(store, ["tokencleaner", "bootstrapsigner"], clock=clock)
        store.create_object("ConfigMap", t.ConfigMap(
            meta=t.ObjectMeta(name="cluster-info", namespace="kube-system"),
            data={"kubeconfig": "apiVersion: v1\nclusters: []\n"}))
        for tid, exp in (("old", "4000"), ("live", "9000")):
            store.create_object("Secret", t.Secret(
                meta=t.ObjectMeta(name=f"bootstrap-token-{tid}", namespace="kube-system"),
                type=t.SECRET_TYPE_BOOTSTRAP_TOKEN,
                data={"token-id": tid, "token-secret": f"s-{tid}", "expiration": exp}))
        out = [m.settle(), state(k, store, m)]
        store.delete_object("Secret", "kube-system/bootstrap-token-live")
        out += [m.settle(), state(k, store, m)]
        return out

    out = run(script)
    assert sorted(out[1]["Secret"]) == ["kube-system/bootstrap-token-live"]
    assert "jws-kubeconfig-live" in out[1]["ConfigMap"]["kube-system/cluster-info"]["data"]
    assert not [d for d in out[3]["ConfigMap"]["kube-system/cluster-info"]["data"]
                if d.startswith("jws-")]


@pytest.mark.parametrize("expand", [True, False], ids=["expandable", "rigid"])
def test_pv_expander(expand):
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["persistentvolume-expander"])
        store.create_storage_class(t.StorageClass(meta=t.ObjectMeta(name="sc"),
                                                  allow_volume_expansion=expand))
        store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name="pv1"), capacity_bytes=1 << 30,
                                           storage_class="sc", bound_pvc="default/c1"))
        store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="c1"),
                                                 storage_class="sc", bound_pv="pv1",
                                                 requested_bytes=2 << 30))
        return [m.settle(), state(k, store, m)]

    out = run(script)
    assert out[1]["PersistentVolume"]["pv1"]["capacity_bytes"] == (2 << 30 if expand else 1 << 30)


# ------------------------------------------------------------ podgroup


def _podgroup(k, store, clock, ttl=60.0):
    pg = k.mod("podgroup")
    factory = k.client.SharedInformerFactory(store)
    ctrl = pg.PodGroupController(store, factory, now_fn=clock, orphan_ttl_s=ttl)
    factory.wait_for_cache_sync()
    return ctrl, factory


def _group(k, store, min_member=2, **kw):
    t = k.types
    store.create_object("PodGroup", t.PodGroup(meta=t.ObjectMeta(name="g"),
                                               min_member=min_member, **kw))


def _member(k, store, name, node=""):
    pod = k.make_pod(name).req({"cpu": "100m"}).pod_group("g").obj()
    if node:
        pod.spec.node_name = node
    store.create_pod(pod)


def _pump(ctrl, factory, tick=False):
    factory.pump()
    if tick:
        ctrl.tick()
    return ctrl.sync_once()


@pytest.mark.parametrize("case", ["drift", "lost-quorum", "below-quorum", "reaped", "blip"])
def test_podgroup_controller(case):
    """Status drift repaired from the store, Running with lost quorum
    demoted, Pending vs Scheduling below quorum left alone; the orphan GC
    after its TTL, restarted by a member blip."""
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        out = []
        if case == "drift":
            _group(k, store)
            _member(k, store, "m0", "n0")
            _member(k, store, "m1", "n1")
        elif case == "lost-quorum":
            _group(k, store, phase=t.POD_GROUP_RUNNING, scheduled=2)
            _member(k, store, "m0", "n0")
        elif case == "below-quorum":
            _group(k, store, min_member=3, phase=t.POD_GROUP_SCHEDULING)
            _member(k, store, "m0")
            _member(k, store, "m1")
        elif case == "reaped":
            _group(k, store, phase=t.POD_GROUP_RUNNING, scheduled=2)
        else:
            _group(k, store, min_member=1)
        ctrl, factory = _podgroup(k, store, clock)
        out += [_pump(ctrl, factory), state(k, store)]
        if case == "reaped":
            clock.advance(61.0)
            out += [_pump(ctrl, factory, tick=True), state(k, store)]
        elif case == "blip":
            clock.advance(45.0)
            _member(k, store, "m0")
            out.append(_pump(ctrl, factory))
            clock.advance(45.0)
            store.delete_pod("default/m0")
            out.append(_pump(ctrl, factory))
            clock.advance(45.0)
            out += [_pump(ctrl, factory, tick=True), state(k, store)]
            clock.advance(30.0)
            out += [_pump(ctrl, factory, tick=True), state(k, store)]
        return out

    out = run(script)
    g = out[1]["PodGroup"].get("default/g")
    want = {"drift": ("Running", 2), "lost-quorum": ("Scheduling", 1),
            "below-quorum": ("Scheduling", 0), "reaped": ("Pending", 0),
            "blip": ("Pending", 0)}[case]
    assert (g.get("phase", "Pending"), g.get("scheduled", 0)) == want
    if case == "reaped":
        assert "default/g" not in out[3]["PodGroup"]
    if case == "blip":
        assert "default/g" in out[5]["PodGroup"] and "default/g" not in out[7]["PodGroup"]


@pytest.mark.parametrize("restart", [False, True], ids=["together", "restart"])
def test_podgroup_controller_beside_the_plugin(restart):
    """The controller and the Coscheduling plugin of a live scheduler over
    one group converge and stop writing; after a scheduler restart with a
    member gone both settle on the store's status."""
    def script(k):
        store = k.new_store()
        clock = k.FakeClock()
        for i in range(4):
            store.create_node(k.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "8Gi", "pods": 10}).obj())
        sched = k.Scheduler(store, now_fn=clock)
        _group(k, store)
        _member(k, store, "m0")
        _member(k, store, "m1")
        out = [settle_sequential(sched), state(k, store)]
        if restart:
            store.delete_pod("default/m1")
            k.Scheduler(store, now_fn=clock)
        ctrl, factory = _podgroup(k, store, k.FakeClock())
        out += [_pump(ctrl, factory), state(k, store)]
        for _ in range(5):
            out.append(_pump(ctrl, factory, tick=True))
        out.append(state(k, store))
        return out

    out = run(script)
    assert out[1]["PodGroup"]["default/g"]["phase"] == "Running"
    g = out[3]["PodGroup"]["default/g"]
    assert (g["phase"], g["scheduled"]) == (("Scheduling", 1) if restart else ("Running", 2))
    assert out[-1]["PodGroup"] == out[3]["PodGroup"]

