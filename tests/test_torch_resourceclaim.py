"""The port's resourceclaim controller (``kubernetes_tpu_torch/controllers/
resourceclaim.py`` on ``controllers/base.py`` and the informers of
``client/``) against the JAX controller on the CPU.

The same store script runs against each package: pods naming claim
templates get pod-owned ``<pod>-<entry>`` claims with the template's class
and selectors; a pod naming a missing template gets a Warning event (also
persisted as an Event object) and its key requeued with backoff until the
template appears; a pod naming a claim directly gets none; when a pod
goes, its owned claims are deleted, its reservations on other claims
released and its PodSchedulingContext deleted. The claims (key, class,
selectors, owners, reservations, allocation, resource version), the events
and the requeue counts must be equal. Then the claims the controller makes
for SchedulingDRA's pods equal those ``perf/workloads.scheduling_dra(...).
store()`` holds, which the port's workloads build without the controller."""

from test_torch_client import KITS, Clock, both


def _claims(store) -> dict:
    return {k: (c.resource_class_name, dict(c.selectors), c.allocated_node,
                tuple(c.reserved_for),
                tuple((o.kind, o.name, o.controller) for o in c.meta.owner_references),
                c.meta.resource_version)
            for k, c in sorted(store.resource_claims.items())}


def _controller(k, store):
    """The controller with its workqueue on a stopped clock: a failed key's
    backoff then never runs out within a round, however slow the run (on
    the workqueue's default wall clock a slow round popped it twice)."""
    if k.pkg == "jax":
        from kubernetes_tpu.controllers.resourceclaim import ResourceClaimController
    else:
        from kubernetes_tpu_torch.controllers.resourceclaim import ResourceClaimController
    factory = k.client.SharedInformerFactory(store)
    ctrl = ResourceClaimController(store, factory)
    ctrl.queue.now_fn = Clock()
    factory.wait_for_cache_sync()
    return factory, ctrl


def _round(factory, ctrl) -> int:
    factory.pump()
    return ctrl.sync_once()


def _claim_pod(k, name, template="tmpl", entry="gpu", claim_name=""):
    pw = k.make_pod(name).req({"cpu": "100m"})
    if claim_name:
        pw.resource_claim(entry, claim_name=claim_name)
    else:
        pw.resource_claim(entry, template_name=template)
    return pw.obj()


def test_controller_matches_jax():
    def script(k):
        t = k.types
        store = k.new_store()
        store.create_object("ResourceClass", t.ResourceClass(
            meta=t.ObjectMeta(name="gpu.example.com", namespace=""), driver_name="gpu"))
        store.create_object("ResourceClaimTemplate", t.ResourceClaimTemplate(
            meta=t.ObjectMeta(name="tmpl"), resource_class_name="gpu.example.com",
            selectors={"cores": ">=8"}))
        factory, ctrl = _controller(k, store)
        out = []
        for i in range(3):
            store.create_pod(_claim_pod(k, f"p{i}"))
        store.create_pod(_claim_pod(k, "late", template="later"))
        store.create_object("ResourceClaim", t.ResourceClaim(
            meta=t.ObjectMeta(name="shared"), resource_class_name="gpu.example.com"))
        store.create_pod(_claim_pod(k, "direct", claim_name="shared"))
        store.create_pod(k.make_pod("plain").obj())
        out.append(_round(factory, ctrl))
        out.append(_claims(store))
        out.append([(e.object_key, e.type, e.reason, e.note, e.count)
                    for e in ctrl.recorder.events])
        out.append(sorted((e.involved_object, e.type, e.reason, e.message)
                          for e in store.events.values()))
        out.append(ctrl.queue.num_requeues("default/late"))
        # the template appears: its event re-reconciles the waiting pod
        store.create_object("ResourceClaimTemplate", t.ResourceClaimTemplate(
            meta=t.ObjectMeta(name="later"), resource_class_name="gpu.example.com"))
        out.append(_round(factory, ctrl))
        out.append(sorted(_claims(store)))
        # a claim deleted under a live pod is made again
        store.delete_object("ResourceClaim", "default/p0-gpu")
        out.append(_round(factory, ctrl))
        out.append(_claims(store).get("default/p0-gpu"))
        # the pods go: owned claims deleted, the shared one released, the
        # scheduling context deleted
        store.allocate_claim("default/shared", "n0", "default/direct")
        store.allocate_claim("default/p1-gpu", "n0", "default/p1")
        store.create_object("PodSchedulingContext", t.PodSchedulingContext(
            meta=t.ObjectMeta(name="p1"), selected_node="n0"))
        store.delete_pod("default/p1")
        store.delete_pod("default/direct")
        out.append(_round(factory, ctrl))
        out.append(_claims(store))
        out.append(store.get_object("PodSchedulingContext", "default/p1"))
        return out

    out = both(script)
    claims = out[1]
    assert sorted(claims) == ["default/p0-gpu", "default/p1-gpu", "default/p2-gpu",
                              "default/shared"]
    assert claims["default/p0-gpu"][:2] == ("gpu.example.com", {"cores": ">=8"})
    assert claims["default/p0-gpu"][4] == (("Pod", "p0", True),)
    assert out[2] and out[2][0][1:3] == ("Warning", "FailedResourceClaimCreation")
    assert out[4] == 1 and "default/late-gpu" in out[6]
    assert "default/p1-gpu" not in out[10] and out[10]["default/shared"][3] == ()
    assert out[11] is None


def test_retries_stop_after_max_retries():
    def script(k):
        store = k.new_store()
        factory, ctrl = _controller(k, store)
        clock = [0.0]
        ctrl.queue.now_fn = lambda: clock[0]
        store.create_pod(_claim_pod(k, "p", template="never"))
        rounds = []
        for _ in range(8):
            rounds.append((_round(factory, ctrl), ctrl.queue.num_requeues("default/p")))
            clock[0] += 100.0
        return rounds, len(ctrl.recorder.events), ctrl.recorder.events[0].count

    rounds, n_events, count = both(script)
    assert rounds[-1] == (0, 0) and n_events == 1 and count == 6


def test_claims_equal_the_workload_store():
    """SchedulingDRA's pods through the controller get the claims that
    ``scheduling_dra(...).store()`` holds (key, class, selectors)."""
    from kubernetes_tpu.perf.workloads import scheduling_dra as jax_case
    from kubernetes_tpu_torch.api.types import ObjectMeta, ResourceClaimTemplate, ResourceClass
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_dra(nodes=8, init_pods=3, measured=4)
    (claim,) = jax_case(nodes=8, init_pods=3, measured=4)["ops"][1]["claims"]
    store = Store()
    store.create_object("ResourceClass", ResourceClass(
        meta=ObjectMeta(name=claim["class"], namespace=""), driver_name=claim["class"],
        selectors=dict(claim["class_selectors"])))
    store.create_object("ResourceClaimTemplate", ResourceClaimTemplate(
        meta=ObjectMeta(name=claim["template"]), resource_class_name=claim["class"],
        selectors=dict(claim["selectors"])))
    factory, ctrl = _controller(KITS["port"], store)
    for pod in w.init_pod_list() + w.measured_pod_list():
        store.create_pod(pod)
    assert _round(factory, ctrl) == 7

    def shape(s):
        return {k: (c.resource_class_name, dict(c.selectors))
                for k, c in s.resource_claims.items()}

    want = shape(w.store())
    assert shape(store) == want and len(want) == 7
