"""The port's admission chain against the JAX store's, through both real
scheduler loops.

The JAX ``ClusterStore`` runs ``AdmissionChain(default_chain())`` on every
create (``kubernetes_tpu/apiserver/admission.py``); the port's ``Store``
runs its own copy (``kubernetes_tpu_torch/apiserver/admission.py``). Each
case writes the same objects to both stores of a ``LoopPair`` (validation
off on both, the chains on), each package's objects made by its own
wrappers, settles both loops and requires equal placements and loop
state (``LoopPair.assert_equal``), and for every refused write the same
plugin and message. One case per ported plugin; the first three are the
ones that placed pods differently before the port had the chain (ROADMAP
C21). Then ``AdmissionChain.charge``'s rollback over two quotas, and the
quota charge a preempted victim leaves behind (never released, as in
JAX)."""

from __future__ import annotations

import dataclasses
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import LoopPair, jax_api, to_jax, torch_api  # noqa: E402

NOT_READY = "node.kubernetes.io/not-ready"
UNREACHABLE = "node.kubernetes.io/unreachable"
NODE_SELECTOR_ANNOTATION = "scheduler.alpha.kubernetes.io/node-selector"


@pytest.fixture(autouse=True)
def _sync(monkeypatch):
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")


def _outcome(fn):
    """None, or (exception class name, plugin, message) of what ``fn`` raised."""
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the outcome is compared
        return type(err).__name__, getattr(err, "plugin", None), str(err)
    return None


def _write_both(pair: LoopPair, method: str, jobj, tobj, kind: str = ""):
    """One write to each store; both outcomes equal; returns the port's."""
    args = (kind,) if kind else ()
    jout = _outcome(lambda: getattr(pair.jstore, method)(*args, jobj))
    tout = _outcome(lambda: getattr(pair.tstore, method)(*args, tobj))
    assert tout == jout
    return tout


def _create(pair: LoopPair, method: str, obj, kind: str = ""):
    """A port object written to the port's store, its JAX copy (made before
    the port's store stamps it) to the JAX store."""
    return _write_both(pair, method, to_jax(obj), obj, kind)


def _nodes(api, specs):
    """Nodes by each package's wrapper: (name, cpu, labels, taints, ready)."""
    out = []
    for name, cpu, labels, taints, ready in specs:
        nw = api.make_node(name).capacity({"cpu": cpu, "memory": "64Gi", "pods": 110})
        nw.label("kubernetes.io/hostname", name)
        for k, v in labels.items():
            nw.label(k, v)
        for key, effect in taints:
            nw.taint(key, "", effect)
        node = nw.obj()
        node.status.ready = ready
        out.append(node)
    return out


def _add_nodes(pair: LoopPair, specs) -> None:
    for jnode, tnode in zip(_nodes(jax_api(), specs), _nodes(torch_api(), specs)):
        _write_both(pair, "create_node", jnode, tnode)


def _pods(api, n: int, seed: int, prefix: str = "p", ns: str = "default", edit=None):
    """``n`` pods of seeded requests by ``api``'s wrapper; ``edit(pod_wrapper,
    i)`` adds what a case needs."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        pw = api.make_pod(f"{prefix}-{i}", namespace=ns).req(
            {"cpu": f"{rng.choice((500, 700, 900))}m", "memory": f"{rng.choice((1, 2))}Gi"})
        if edit is not None:
            edit(pw, i)
        out.append(pw.obj())
    return out


def _add_pods(pair: LoopPair, n: int, seed: int, **kw):
    """Each package's pods written to its store in order; the refusals."""
    refused = []
    for jpod, tpod in zip(_pods(jax_api(), n, seed, **kw), _pods(torch_api(), n, seed, **kw)):
        out = _write_both(pair, "create_pod", jpod, tpod)
        if out is not None:
            refused.append((tpod.key(), out[1], out[2]))
    return refused


def _settle(pair: LoopPair) -> dict:
    pair.settle()
    return pair.assert_equal()["placed"]


def _namespace(name: str, annotations=None, labels=None, terminating: bool = False):
    from kubernetes_tpu_torch.api.types import Namespace, ObjectMeta

    return Namespace(meta=ObjectMeta(name=name, namespace="", annotations=dict(annotations or {}),
                                     labels=dict(labels or {}),
                                     deletion_timestamp=1.0 if terminating else 0.0))


def _add_namespace(pair: LoopPair, ns) -> None:
    pair.jstore.create_namespace(to_jax(ns))
    pair.tstore.create_namespace(ns)


# ----------------------------------------------------------------- C21: the placements


def test_taint_nodes_by_condition():
    """A node created not Ready gets the not-ready NoSchedule taint, so the
    pods avoid the large node n0 and take n1."""
    pair = LoopPair()
    _add_nodes(pair, [("n0", "32", {}, (), False), ("n1", "8", {}, (), True)])
    assert [(t.key, t.effect) for t in pair.tstore.nodes["n0"].spec.taints] == [
        (t.key, t.effect) for t in pair.jstore.nodes["n0"].spec.taints] == [
        (NOT_READY, "NoSchedule")]
    _add_pods(pair, 3, seed=1)
    placed = _settle(pair)
    assert set(placed.values()) == {"n1"}


def test_default_toleration_seconds():
    """Every pod gains the not-ready and unreachable NoExecute tolerations,
    so the node n0, unreachable, still takes the pods (n1 fits none)."""
    pair = LoopPair()
    _add_nodes(pair, [("n0", "32", {}, ((UNREACHABLE, "NoExecute"),), True),
                      ("n1", "400m", {}, (), True)])
    _add_pods(pair, 3, seed=2)
    placed = _settle(pair)
    assert set(placed.values()) == {"n0"}
    tols = pair.tstore.get_pod("default/p-0").spec.tolerations
    assert [(t.key, t.effect, t.toleration_seconds) for t in tols] == [
        (NOT_READY, "NoExecute", 300), (UNREACHABLE, "NoExecute", 300)]


def test_pod_node_selector():
    """The namespace's node-selector annotation is merged into each pod's
    nodeSelector: team pods go to pool=b (the small n1); a pod selecting
    another pool is refused."""
    pair = LoopPair()
    _add_namespace(pair, _namespace("team", annotations={NODE_SELECTOR_ANNOTATION: "pool=b"}))
    _add_nodes(pair, [("n0", "32", {"pool": "a"}, (), True),
                      ("n1", "8", {"pool": "b"}, (), True)])
    refused = _add_pods(pair, 4, seed=3, ns="team",
                        edit=lambda pw, i: pw.node_selector({"pool": "a"}) if i == 3 else None)
    placed = _settle(pair)
    assert {k: v for k, v in placed.items()} == {f"team/p-{i}": "n1" for i in range(3)}
    assert [(k, plugin) for k, plugin, _ in refused] == [("team/p-3", "PodNodeSelector")]
    assert "conflicts with namespace selector pool=b" in refused[0][2]


# ----------------------------------------------------------------- the other plugins


def test_namespace_lifecycle():
    """A pod of an absent namespace, or of a terminating one, is refused;
    ``default`` needs no Namespace object."""
    pair = LoopPair()
    _add_namespace(pair, _namespace("going", terminating=True))
    _add_namespace(pair, _namespace("live"))
    _add_nodes(pair, [("n0", "8", {}, (), True)])
    refused = []
    for ns in ("default", "absent", "going", "live"):
        refused += _add_pods(pair, 1, seed=4, prefix=f"p{ns}", ns=ns)
    assert [(k, p) for k, p, _ in refused] == [("absent/pabsent-0", "NamespaceLifecycle"),
                                               ("going/pgoing-0", "NamespaceLifecycle")]
    placed = _settle(pair)
    assert sorted(placed) == ["default/pdefault-0", "live/plive-0"]


def test_limit_ranger():
    """A LimitRange's Container defaultRequest fills the requests a pod does
    not set (3 cpu: only n1 fits), and a request above its max refuses the
    pod."""
    from kubernetes_tpu_torch.api.types import LimitRange, LimitRangeItem, ObjectMeta

    pair = LoopPair()
    _add_namespace(pair, _namespace("lr"))
    _create(pair, "create_object", LimitRange(
        meta=ObjectMeta(name="limits", namespace="lr"),
        limits=(LimitRangeItem(default_request={"cpu": "3", "memory": "1Gi"},
                               default={"cpu": "4"}, max={"cpu": "6"}),)), kind="LimitRange")
    _add_nodes(pair, [("n0", "2", {}, (), True), ("n1", "8", {}, (), True)])

    def edit(pw, i):
        pw.pod.spec.containers[0].requests = {} if i < 2 else {"cpu": "7"}

    refused = _add_pods(pair, 3, seed=5, ns="lr", edit=edit)
    assert [(k, p) for k, p, _ in refused] == [("lr/p-2", "LimitRanger")]
    placed = _settle(pair)
    assert placed == {"lr/p-0": "n1", "lr/p-1": "n1"}
    pod = pair.tstore.get_pod("lr/p-0")
    assert pod.spec.containers[0].requests == {"cpu": "3", "memory": "1Gi"}
    assert pod.spec.containers[0].limits == {"cpu": "4"}
    assert pod.resource_request()["cpu"] == 3000


def test_service_account():
    """The account defaults to ``default``; a pod naming an account the
    store does not hold is refused; one it holds is admitted."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, ServiceAccount

    pair = LoopPair()
    _create(pair, "create_object", ServiceAccount(meta=ObjectMeta(name="deployer")),
            kind="ServiceAccount")
    _add_nodes(pair, [("n0", "8", {}, (), True)])
    names = ("", "deployer", "ghost")

    def edit(pw, i):
        pw.pod.spec.service_account_name = names[i]

    refused = _add_pods(pair, 3, seed=6, edit=edit)
    assert [(k, p, m) for k, p, m in refused] == [
        ("default/p-2", "ServiceAccount",
         "admission denied by ServiceAccount: service account 'default/ghost' not found")]
    _settle(pair)
    assert [pair.tstore.get_pod(f"default/p-{i}").spec.service_account_name
            for i in range(2)] == ["default", "deployer"]


def test_pod_security():
    """A baseline namespace refuses host namespaces and privileged
    containers; a restricted one also a pod without runAsNonRoot."""
    from kubernetes_tpu_torch.api.types import SecurityContext

    pair = LoopPair()
    label = "pod-security.kubernetes.io/enforce"
    _add_namespace(pair, _namespace("base", labels={label: "baseline"}))
    _add_namespace(pair, _namespace("strict", labels={label: "restricted"}))
    _add_nodes(pair, [("n0", "8", {}, (), True)])

    def edit(pw, i):
        if i == 1:
            pw.pod.spec.host_network = True
        elif i == 2:
            pw.pod.spec.containers[0].security_context = SecurityContext(privileged=True)

    refused = _add_pods(pair, 3, seed=7, ns="base", edit=edit)
    refused += _add_pods(pair, 1, seed=7, prefix="s", ns="strict")
    assert [(k, p) for k, p, _ in refused] == [
        ("base/p-1", "PodSecurity"), ("base/p-2", "PodSecurity"), ("strict/s-0", "PodSecurity")]
    assert _settle(pair) == {"base/p-0": "n0"}


def test_default_priority():
    """A class name sets the priority; a missing class refuses the pod."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PriorityClass

    pair = LoopPair()
    _create(pair, "create_priority_class",
            PriorityClass(meta=ObjectMeta(name="high", namespace=""), value=100))
    _add_nodes(pair, [("n0", "8", {}, (), True)])

    def edit(pw, i):
        pw.pod.spec.priority_class_name = ("high", "missing")[i]

    refused = _add_pods(pair, 2, seed=8, edit=edit)
    assert [(k, p) for k, p, _ in refused] == [("default/p-1", "Priority")]
    _settle(pair)
    assert pair.tstore.get_pod("default/p-0").spec.priority == 100


def test_default_storage_class_and_protection_finalizers():
    """A PVC without a class gets the default StorageClass; PVs and PVCs get
    their protection finalizers. The pod on the PVC binds in both loops."""
    from kubernetes_tpu_torch.api.types import (ANNOTATION_DEFAULT_STORAGE_CLASS, ROX, ObjectMeta,
                                                PersistentVolume, PersistentVolumeClaim,
                                                StorageClass)

    pair = LoopPair()
    for name, default in (("slow", "false"), ("fast", "true")):
        _create(pair, "create_storage_class", StorageClass(
            meta=ObjectMeta(name=name, namespace="",
                            annotations={ANNOTATION_DEFAULT_STORAGE_CLASS: default})))
    _add_nodes(pair, [("n0", "8", {}, (), True)])
    _create(pair, "create_pv", PersistentVolume(
        meta=ObjectMeta(name="pv-0", namespace=""), capacity_bytes=1 << 30,
        bound_pvc="default/claim-0", access_modes=(ROX,), storage_class="fast"))
    _create(pair, "create_pvc", PersistentVolumeClaim(
        meta=ObjectMeta(name="claim-0", annotations={"pv.kubernetes.io/bind-completed": "true"}),
        bound_pv="pv-0", access_modes=(ROX,), requested_bytes=1 << 30))
    for store in (pair.jstore, pair.tstore):
        assert store.pvcs["default/claim-0"].storage_class == "fast"
        assert store.pvcs["default/claim-0"].meta.finalizers == ("kubernetes.io/pvc-protection",)
        assert store.pvs["pv-0"].meta.finalizers == ("kubernetes.io/pv-protection",)
    _add_pods(pair, 1, seed=9, edit=lambda pw, i: pw.pvc("claim-0"))
    pair.settle()
    assert pair.assert_volume_equal()["placed"] == {"default/p-0": "n0"}


def test_runtime_class():
    """A RuntimeClass's overhead is added to the pod's request (1500m plus
    1 cpu: only n1 fits), its node selector merged; an unknown class and an
    overhead of the pod's own that differs are refused."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, RuntimeClass

    pair = LoopPair()
    _create(pair, "create_object", RuntimeClass(
        meta=ObjectMeta(name="kata", namespace=""), handler="kata", overhead={"cpu": "1"},
        node_selector={"kata": "yes"}), kind="RuntimeClass")
    _add_nodes(pair, [("n0", "2", {"kata": "yes"}, (), True),
                      ("n1", "6", {"kata": "yes"}, (), True),
                      ("n2", "16", {}, (), True)])

    def edit(pw, i):
        pw.pod.spec.containers[0].requests = {"cpu": "1500m"}
        pw.pod.spec.runtime_class_name = ("kata", "kata", "gvisor", "kata")[i]
        if i == 3:
            pw.overhead({"cpu": "2"})

    refused = _add_pods(pair, 4, seed=10, edit=edit)
    assert [(k, p) for k, p, _ in refused] == [("default/p-2", "RuntimeClass"),
                                               ("default/p-3", "RuntimeClass")]
    assert refused[0][2] == "admission denied by RuntimeClass: RuntimeClass 'gvisor' not found"
    assert _settle(pair) == {"default/p-0": "n1", "default/p-1": "n1"}
    pod = pair.tstore.get_pod("default/p-0")
    assert (pod.spec.overhead, pod.resource_request()["cpu"]) == ({"cpu": "1"}, 2500)


def test_resource_quota():
    """A quota of three pods and 2 cpu: creates past it are refused with
    JAX's message, and the usage charged equals JAX's."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceQuota

    pair = LoopPair()
    _add_namespace(pair, _namespace("q"))
    _create(pair, "create_object", ResourceQuota(
        meta=ObjectMeta(name="quota", namespace="q"),
        hard={"pods": 3, "requests.cpu": 2000}), kind="ResourceQuota")
    _add_nodes(pair, [("n0", "8", {}, (), True)])
    refused = _add_pods(pair, 6, seed=11, ns="q")
    assert refused and {p for _, p, _ in refused} == {"ResourceQuota"}
    placed = _settle(pair)
    assert len(placed) == 6 - len(refused)
    assert pair.tstore.resource_quotas["q/quota"].used == \
        pair.jstore.resource_quotas["q/quota"].used


# ----------------------------------------------------------------- charge


def _refusing_chain(pkg: str):
    """ResourceQuota admission, then a plugin whose charge refuses."""
    import importlib

    adm = importlib.import_module(f"{pkg}.apiserver.admission")

    class RefuseAtCharge(adm.AdmissionPlugin):
        name = "RefuseAtCharge"

        def charge(self, store, kind, obj):
            raise adm.AdmissionError(self.name, "refused after the quota charge")

    return adm.AdmissionChain([adm.ResourceQuotaAdmission(), RefuseAtCharge()])


def test_charge_rolls_back_over_two_quotas():
    """Two quotas of one namespace are charged, then a later plugin's charge
    refuses: both charges are rolled back and nothing is stored, in both
    stores. Without the refusing plugin the pod is charged to both."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceQuota

    pair = LoopPair()
    _add_namespace(pair, _namespace("q"))
    for name, hard in (("a", {"pods": 5}), ("b", {"pods": 5, "requests.cpu": 4000})):
        _create(pair, "create_object", ResourceQuota(
            meta=ObjectMeta(name=name, namespace="q"), hard=hard), kind="ResourceQuota")
    chains = (pair.jstore.admission, pair.tstore.admission)
    pair.jstore.admission = _refusing_chain("kubernetes_tpu")
    pair.tstore.admission = _refusing_chain("kubernetes_tpu_torch")
    refused = _add_pods(pair, 1, seed=12, ns="q")
    assert [(k, p) for k, p, _ in refused] == [("q/p-0", "RefuseAtCharge")]
    for store in (pair.jstore, pair.tstore):
        assert "q/p-0" not in store.pods
        assert {k: q.used for k, q in store.resource_quotas.items()} == {
            "q/a": {"pods": 0}, "q/b": {"pods": 0, "requests.cpu": 0}}
    pair.jstore.admission, pair.tstore.admission = chains
    assert _add_pods(pair, 1, seed=12, ns="q") == []
    used = {k: q.used for k, q in pair.tstore.resource_quotas.items()}
    assert used == {k: q.used for k, q in pair.jstore.resource_quotas.items()}
    assert used["q/a"] == {"pods": 1}


def test_quota_charge_survives_preemption():
    """A preemptor evicts the namespace's low-priority pods; their quota
    charge is not released on delete (the quota controller reconciles it in
    the reference), in both stores."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceQuota

    pair = LoopPair()
    _add_namespace(pair, _namespace("q"))
    _create(pair, "create_object", ResourceQuota(
        meta=ObjectMeta(name="quota", namespace="q"), hard={"pods": 10}), kind="ResourceQuota")
    _add_nodes(pair, [("n0", "2", {}, (), True)])

    def victim(pw, i):
        pw.pod.spec.containers[0].requests = {"cpu": "900m"}
        pw.priority(1)

    _add_pods(pair, 2, seed=13, prefix="v", ns="q", edit=victim)
    _settle(pair)

    def preemptor(pw, i):
        pw.pod.spec.containers[0].requests = {"cpu": "2"}
        pw.priority(100)

    _add_pods(pair, 1, seed=13, prefix="hi", ns="q", edit=preemptor)
    pair.settle()
    pair.advance(2.0)
    placed = _settle(pair)
    assert placed == {"q/hi-0": "n0"}  # both victims evicted
    assert sorted(pair.tsched.preempted) == ["q/v-0", "q/v-1"]
    assert pair.tstore.resource_quotas["q/quota"].used == \
        pair.jstore.resource_quotas["q/quota"].used == {"pods": 3}


def test_tolerations_outgrow_the_axis():
    """Pods with three tolerations of their own gain two more: five is past
    the encoder's toleration axis (4), so both loops grow their mirror; the
    placements, counters and queues stay equal."""
    pair = LoopPair()
    _add_nodes(pair, [(f"n{i}", "8", {}, (("dedicated", "NoSchedule"),) if i % 2 else (), True)
                      for i in range(4)])

    def edit(pw, i):
        for k in ("a", "b", "dedicated"):
            pw.toleration(key=k, operator="Exists")

    _add_pods(pair, 6, seed=14, edit=edit)
    placed = _settle(pair)
    assert len(placed) == 6 and all(placed.values())
    assert len(pair.tstore.get_pod("default/p-0").spec.tolerations) == 5
    assert pair.tsched.state.caps.tolerations > 4
    assert dataclasses.asdict(pair.tsched.state.caps) == dataclasses.asdict(
        pair.jsched.device.caps)


def test_default_chain_is_the_jax_chain_without_the_left_out_plugins():
    """The port's chain is the JAX chain in its order, whole: the plugins
    left out until the HTTP front came (ROADMAP A21) are in it, and no
    plugin is left out any more. Likewise the roster with the default-off
    plugins."""
    from kubernetes_tpu.apiserver.admission import all_ordered_plugins as jax_roster
    from kubernetes_tpu.apiserver.admission import default_chain as jax_chain
    from kubernetes_tpu_torch.apiserver.admission import all_ordered_plugins, default_chain

    assert [p.name for p in default_chain()] == [p.name for p in jax_chain()]
    assert [type(p).__name__ for p in default_chain()] == [
        type(p).__name__ for p in jax_chain()]
    assert [p.name for p in all_ordered_plugins()] == [p.name for p in jax_roster()]


# ----------------------------------------------------------------- the API front's plugins
# (ROADMAP A21): each case runs the same writes against a JAX ClusterStore and
# a port Store (``_torch_front.FrontPair`` without its servers: one constant
# clock), each store's chain its own package's, and requires equal outcomes
# (exception, plugin, message) and equal stored objects.


def _stores(monkeypatch, plugins=None, authorizer: bool = False):
    """A store pair; ``plugins`` (class names) replaces both chains with
    those plugins of each package; ``authorizer`` sets each package's RBAC
    authorizer on its store."""
    from _torch_front import FrontPair, packages

    pair = FrontPair(monkeypatch, serve=False)
    if plugins is not None:
        import kubernetes_tpu.apiserver.admission as jadm
        import kubernetes_tpu_torch.apiserver.admission as tadm

        pair.jstore.admission = jadm.AdmissionChain([getattr(jadm, n)() for n in plugins])
        pair.tstore.admission = tadm.AdmissionChain([getattr(tadm, n)() for n in plugins])
    if authorizer:
        jm, tm = packages()
        pair.jstore.authorizer = jm["auth"].RBACAuthorizer(pair.jstore)
        pair.tstore.authorizer = tm["auth"].RBACAuthorizer(pair.tstore)
    return pair


def _as(pair, user: str, groups=()):
    for store in (pair.jstore, pair.tstore):
        store.set_request_user(user, groups)


def _same_objects(pair, kind: str) -> dict:
    from kubernetes_tpu.api.codec import to_wire as jwire
    from kubernetes_tpu_torch.api.codec import to_wire

    got = {k: to_wire(o) for k, o in pair.tstore._kind_map(kind).items()}
    assert got == {k: jwire(o) for k, o in pair.jstore._kind_map(kind).items()}
    return got


def _grant(pair, user: str, verbs, kinds, subresources=("*",)) -> None:
    from kubernetes_tpu_torch.api.types import (ClusterRole, ClusterRoleBinding, ObjectMeta,
                                                PolicyRule)

    name = f"{user}-{'-'.join(verbs)}"
    pair.both("create_object", ClusterRole(meta=ObjectMeta(name=name, namespace=""), rules=(
        PolicyRule(verbs=tuple(verbs), resources=tuple(kinds),
                   subresources=tuple(subresources)),)), "ClusterRole")
    pair.both("create_object", ClusterRoleBinding(meta=ObjectMeta(name=name, namespace=""),
                                                  role=name, subjects=(f"user:{user}",)),
              "ClusterRoleBinding")


def test_node_restriction(monkeypatch):
    from kubernetes_tpu_torch.api.types import Lease, ObjectMeta

    pair = _stores(monkeypatch)
    for name in ("n1", "n2"):
        pair.both("create_node", torch_api().make_node(name).capacity({"cpu": "4"}).obj())
    _as(pair, "system:node:n1", ("system:nodes",))
    outcomes = [
        pair.both("update_node", torch_api().make_node("n1").capacity({"cpu": "8"}).obj()),
        pair.both("update_node", torch_api().make_node("n2").capacity({"cpu": "8"}).obj()),
        pair.both("create_pod", torch_api().make_pod("mirror").req({"cpu": "1"}).node("n1").obj()),
        pair.both("create_pod", torch_api().make_pod("other").req({"cpu": "1"}).node("n2").obj()),
        pair.both("create_lease", Lease(meta=ObjectMeta(name="n1", namespace="kube-node-lease"))),
        pair.both("create_lease", Lease(meta=ObjectMeta(name="n2", namespace="kube-node-lease"))),
    ]
    assert [o is None for o in outcomes] == [True, False, True, False, True, False]
    assert all("NodeRestriction" in o[1] for o in outcomes if o is not None)
    _as(pair, "system:admin")
    assert pair.both("update_node", torch_api().make_node("n2").capacity({"cpu": "2"}).obj()) \
        is None
    _same_objects(pair, "Node")
    _same_objects(pair, "Pod")


def test_persistent_volume_claim_resize(monkeypatch):
    from kubernetes_tpu_torch.api.types import ObjectMeta, PersistentVolumeClaim, StorageClass

    pair = _stores(monkeypatch)
    pair.both("create_storage_class", StorageClass(meta=ObjectMeta(name="rigid", namespace="")))
    pair.both("create_storage_class", StorageClass(meta=ObjectMeta(name="elastic", namespace=""),
                                                   allow_volume_expansion=True))
    outs = []
    for name, cls in (("a", "rigid"), ("b", "elastic")):
        pair.both("create_pvc", PersistentVolumeClaim(meta=ObjectMeta(name=name),
                                                      storage_class=cls, requested_bytes=100))
        for size in (200, 50, 200):
            outs.append(pair.both("update_object", PersistentVolumeClaim(
                meta=ObjectMeta(name=name), storage_class=cls, requested_bytes=size),
                "PersistentVolumeClaim"))
    assert [o is None for o in outs] == [False, False, False, True, False, True]
    assert "expansion" in outs[0][1] and "shrink" in outs[1][1]
    _same_objects(pair, "PersistentVolumeClaim")


def test_owner_references_permission_enforcement(monkeypatch):
    from kubernetes_tpu_torch.api.types import OwnerReference

    pair = _stores(monkeypatch, authorizer=True)
    _grant(pair, "carol", ("update",), ("ReplicaSet",), ("finalizers",))
    ref = OwnerReference(kind="ReplicaSet", name="rs", controller=True, block_owner_deletion=True)
    outs = []
    for user in ("alice", "carol"):
        _as(pair, user)
        pod = torch_api().make_pod(f"p-{user}").req({"cpu": "1"}).obj()
        pod.meta.owner_references = (ref,)
        outs.append(pair.both("create_pod", pod))
    assert outs[0] is not None and "blockOwnerDeletion" in outs[0][1] and outs[1] is None
    _as(pair, "system:admin")
    for store in (pair.jstore, pair.tstore):
        store.authorizer = None
    pod = torch_api().make_pod("p-open").req({"cpu": "1"}).obj()
    pod.meta.owner_references = (ref,)
    assert pair.both("create_pod", pod) is None
    _same_objects(pair, "Pod")


def _webhook(name: str, handler=None, url: str = "", policy: str = "Fail", kinds=("Pod",)):
    from kubernetes_tpu_torch.api.types import ObjectMeta
    from kubernetes_tpu_torch.apiserver.admission import WebhookConfiguration

    return WebhookConfiguration(meta=ObjectMeta(name=name, namespace=""), kinds=kinds,
                                handler=handler, url=url, failure_policy=policy)


def test_mutating_admission_webhook(monkeypatch):
    def bump(review):
        return {"allowed": True, "patch": [
            {"op": "replace", "path": "/spec/priority", "value": 7},
            {"op": "add", "path": "/meta/labels/webhook", "value": review["operation"]}]}

    pair = _stores(monkeypatch)
    pair.both("create_object", _webhook("bumper", bump), "MutatingWebhookConfiguration")
    assert pair.both("create_pod", torch_api().make_pod("p").req({"cpu": "1"}).obj()) is None
    pods = _same_objects(pair, "Pod")
    assert pods["default/p"]["spec"]["priority"] == 7
    assert pods["default/p"]["meta"]["labels"] == {"webhook": "CREATE"}
    pair.both("create_object", _webhook("bad-patch", lambda r: {"patch": [
        {"op": "move", "path": "/spec/priority"}]}), "MutatingWebhookConfiguration")
    out = pair.both("create_pod", torch_api().make_pod("q").req({"cpu": "1"}).obj())
    assert out is not None and "invalid patch" in out[1]


def test_validating_admission_webhook(monkeypatch):
    def broken(review):
        raise RuntimeError("down")

    pair = _stores(monkeypatch)
    pair.both("create_object", _webhook("flaky", broken, policy="Ignore"),
              "ValidatingWebhookConfiguration")
    assert pair.both("create_pod", torch_api().make_pod("a").req({"cpu": "1"}).obj()) is None
    pair.both("create_object", _webhook("gate", lambda r: {
        "allowed": r["name"] != "b", "message": "not today", "patch": [
            {"op": "replace", "path": "/spec/priority", "value": 9}]}),
        "ValidatingWebhookConfiguration")
    out = pair.both("create_pod", torch_api().make_pod("b").req({"cpu": "1"}).obj())
    assert out is not None and "not today" in out[1]
    assert pair.both("create_pod", torch_api().make_pod("c").req({"cpu": "1"}).obj()) is None
    pair.both("create_object", _webhook("strict", broken), "ValidatingWebhookConfiguration")
    out = pair.both("create_pod", torch_api().make_pod("d").req({"cpu": "1"}).obj())
    assert out is not None and "webhook call failed" in out[1]
    pods = _same_objects(pair, "Pod")
    assert pods["default/c"]["spec"]["priority"] == 0  # a validating webhook patches nothing


def test_admission_webhook_over_http(monkeypatch):
    """A webhook configured by URL: the AdmissionReview-shaped POST to a
    local server, whose answer both packages apply alike."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    reviews = []

    class Hook(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            review = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            reviews.append(review)
            body = json.dumps({"allowed": review["name"] != "bad", "patch": [
                {"op": "replace", "path": "/spec/priority", "value": 3}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Hook)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        pair = _stores(monkeypatch)
        url = f"http://127.0.0.1:{srv.server_address[1]}/mutate"
        pair.both("create_object", _webhook("remote", url=url), "MutatingWebhookConfiguration")
        assert pair.both("create_pod", torch_api().make_pod("ok").req({"cpu": "1"}).obj()) is None
        out = pair.both("create_pod", torch_api().make_pod("bad").req({"cpu": "1"}).obj())
        assert out is not None and "denied by webhook" in out[1]
        assert _same_objects(pair, "Pod")["default/ok"]["spec"]["priority"] == 3
        assert reviews[0] == reviews[1] and reviews[2] == reviews[3]
    finally:
        srv.shutdown()
        srv.server_close()


def test_certificate_plugins(monkeypatch):
    from kubernetes_tpu_torch.api.types import CertificateSigningRequest, ObjectMeta

    def csr(**kw):
        base = dict(meta=ObjectMeta(name="c1", namespace=""), username="alice",
                    signer_name="kubernetes.io/kube-apiserver-client", usages=("client auth",))
        base.update(kw)
        return CertificateSigningRequest(**base)

    pair = _stores(monkeypatch, authorizer=True)
    _grant(pair, "approver", ("approve",), ("CertificateSigningRequest",), ("approval",))
    _grant(pair, "signer", ("sign",), ("CertificateSigningRequest",), ("status",))
    kind = "CertificateSigningRequest"
    outs = [pair.both("create_object", csr(meta=ObjectMeta(name="m", namespace=""),
                                           groups=("system:masters",)), kind),
            pair.both("create_object", csr(), kind)]
    for user, change in (("alice", dict(approved=True)), ("approver", dict(approved=True)),
                         ("approver", dict(approved=True, certificate="X")),
                         ("signer", dict(approved=True, certificate="X")),
                         ("root", dict(approved=True, certificate="X", denied=True))):
        _as(pair, user, ("system:masters",) if user == "root" else ())
        outs.append(pair.both("update_object", csr(**change), kind))
    assert [o is None for o in outs] == [False, True, False, True, False, True, True]
    assert "CertificateSubjectRestriction" in outs[0][1]
    assert "CertificateApproval" in outs[2][1] and "CertificateSigning" in outs[4][1]
    _same_objects(pair, kind)


def test_default_ingress_class(monkeypatch):
    from kubernetes_tpu_torch.api.types import (ANNOTATION_DEFAULT_INGRESS_CLASS, Ingress,
                                                IngressClass, IngressRule, ObjectMeta)

    pair = _stores(monkeypatch)
    default = {ANNOTATION_DEFAULT_INGRESS_CLASS: "true"}
    pair.both("create_object", IngressClass(meta=ObjectMeta(name="nginx", namespace="",
                                                            annotations=default)), "IngressClass")
    pair.both("create_object", IngressClass(meta=ObjectMeta(name="other", namespace="")),
              "IngressClass")
    rules = (IngressRule(host="a.example", service_name="web", service_port=80),)
    assert pair.both("create_object", Ingress(meta=ObjectMeta(name="i1"), rules=rules),
                     "Ingress") is None
    assert pair.both("create_object", Ingress(meta=ObjectMeta(name="i2"),
                                              ingress_class_name="other"), "Ingress") is None
    pair.both("create_object", IngressClass(meta=ObjectMeta(name="traefik", namespace="",
                                                            annotations=default)),
              "IngressClass")
    out = pair.both("create_object", Ingress(meta=ObjectMeta(name="i3")), "Ingress")
    assert out is not None and "multiple IngressClasses" in out[1]
    got = _same_objects(pair, "Ingress")
    assert {k: v["ingress_class_name"] for k, v in got.items()} == {
        "default/i1": "nginx", "default/i2": "other"}


def _pod_edits():
    """Seeded pod edits the default-off plugins act on."""
    from kubernetes_tpu_torch.api.types import (Affinity, LabelSelector, PodAffinityTerm,
                                                PodAntiAffinity, SecurityContext)

    def anti(key):
        def edit(pod):
            pod.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(required=(
                PodAffinityTerm(label_selector=LabelSelector(match_labels={"a": "b"}),
                                topology_key=key),)))
        return edit

    def root(pod):
        pod.spec.containers[0].security_context = SecurityContext(run_as_user=0)

    def extended(pod):
        pod.spec.containers[0].requests["example.com/gpu"] = 1

    return {"plain": lambda pod: None, "root": root, "extended": extended,
            "anti-host": anti("kubernetes.io/hostname"),
            "anti-zone": anti("topology.kubernetes.io/zone")}


@pytest.mark.parametrize("plugin", [
    "NamespaceAutoProvision", "NamespaceExists", "SecurityContextDeny",
    "LimitPodHardAntiAffinityTopology", "AlwaysPullImages", "ExtendedResourceToleration",
    "DenyServiceExternalIPs", "AlwaysAdmit", "AlwaysDeny"])
def test_default_off_plugins(monkeypatch, plugin):
    """Each default-off plugin of ``all_ordered_plugins`` alone in both
    chains: pods with every edit in two namespaces (one absent), a Service
    with and without external IPs, and its update."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, Service

    pair = _stores(monkeypatch, plugins=[plugin])
    outs = []
    for ns in ("default", "team-a"):
        for name, edit in _pod_edits().items():
            pod = torch_api().make_pod(f"{name}-{ns}", namespace=ns).req({"cpu": "1"}).obj()
            edit(pod)
            outs.append(pair.both("create_pod", pod))
    outs.append(pair.both("create_service", Service(meta=ObjectMeta(name="s1"))))
    svc = Service(meta=ObjectMeta(name="s2"))
    svc.external_ips = ("1.2.3.4",)
    outs.append(pair.both("create_service", svc))
    upd = Service(meta=ObjectMeta(name="s1"))
    upd.external_ips = ("5.6.7.8",)
    outs.append(pair.both("update_object", upd, "Service"))
    assert any(o is None for o in outs) or plugin == "AlwaysDeny"
    for kind in ("Pod", "Namespace", "Service"):
        _same_objects(pair, kind)


def test_event_rate_limit(monkeypatch):
    from kubernetes_tpu.apiserver.admission import EventRateLimit as JEventRateLimit
    from kubernetes_tpu_torch.api.types import Event, ObjectMeta
    from kubernetes_tpu_torch.apiserver.admission import AdmissionChain, EventRateLimit

    import kubernetes_tpu.apiserver.admission as jadm

    pair = _stores(monkeypatch)
    clock = [0.0]
    pair.jstore.admission = jadm.AdmissionChain([JEventRateLimit(qps=2.0, burst=3,
                                                                 now_fn=lambda: clock[0])])
    pair.tstore.admission = AdmissionChain([EventRateLimit(qps=2.0, burst=3,
                                                           now_fn=lambda: clock[0])])
    outs = []
    for i in range(12):
        ns = ("a", "b")[i % 2]
        outs.append(pair.both("create_object", Event(meta=ObjectMeta(name=f"e{i}", namespace=ns)),
                              "Event"))
        clock[0] += 0.1 if i < 8 else 1.0
    assert any(o is None for o in outs) and any(o is not None for o in outs)
    _same_objects(pair, "Event")
