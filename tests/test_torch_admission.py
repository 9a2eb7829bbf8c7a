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
    """The port's chain is the JAX chain in its order, less the plugins
    that need the HTTP front (ROADMAP A11)."""
    from kubernetes_tpu.apiserver.admission import default_chain as jax_chain
    from kubernetes_tpu_torch.apiserver.admission import default_chain

    left_out = {"NodeRestriction", "OwnerReferencesPermissionEnforcement",
                "MutatingAdmissionWebhook", "ValidatingAdmissionWebhook", "CertificateApproval",
                "CertificateSigning", "CertificateSubjectRestriction", "DefaultIngressClass",
                "PersistentVolumeClaimResize"}
    assert [p.name for p in default_chain()] == [
        p.name for p in jax_chain() if p.name not in left_out]
