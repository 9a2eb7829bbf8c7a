"""resourceclaim controller: materializes and garbage-collects
resource.k8s.io ResourceClaims (pkg/controller/resourceclaim; an own copy
of ``kubernetes_tpu/controllers/resourceclaim.py`` over the port's
``Store``).

For every pod.spec.resourceClaims entry that names a ResourceClaimTemplate,
create the pod-owned ResourceClaim ``<pod>-<entry>`` (the ephemeral-volume
controller's naming + ownership shape); when the consuming pod goes away,
drop its reservation and delete the generated claims (ownerRef-driven GC,
done inline here because the generic GarbageCollector predates this kind's
registration in its watch set).

A pod referencing a template that does not exist YET is tolerated: the
controller emits a Warning event and raises — controllers/base.py requeues
the key with rate-limited backoff (MAX_RETRIES), so the claim materializes
as soon as the template appears instead of the controller wedging.
"""

from __future__ import annotations

from typing import List

from ..api import dra
from ..api.types import ObjectMeta, OwnerReference, ResourceClaim
from ..apiserver.store import Conflict
from ..utils.events import EventRecorder, TYPE_WARNING
from .base import Controller


class MissingTemplateError(Exception):
    """Pod references a ResourceClaimTemplate that doesn't exist (yet)."""


class ResourceClaimController(Controller):
    name = "resourceclaim"
    watch_kinds = ("Pod", "ResourceClaim", "ResourceClaimTemplate")

    def __init__(self, store, factory, recorder=None):
        super().__init__(store, factory)
        self.recorder = recorder if recorder is not None else EventRecorder(
            store=store, reporting_controller="resourceclaim-controller")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "Pod":
            return [obj.meta.key()] if obj.spec.resource_claims else []
        if kind == "ResourceClaimTemplate":
            # a template appearing may unblock every pod in its namespace
            # still waiting on it (the backoff requeue usually wins the
            # race; this closes it deterministically)
            ns = obj.meta.namespace
            return [p.meta.key() for p in self.store.snapshot_map("Pod").values()
                    if p.meta.namespace == ns and any(
                        prc.template_name == obj.meta.name
                        for prc in p.spec.resource_claims)]
        # ResourceClaim events: reconcile the owning pod (claim deleted out
        # from under a live pod -> recreate; orphaned claim -> GC)
        owner = obj.meta.controller_of()
        if owner is not None and owner.kind == "Pod":
            return [f"{obj.meta.namespace}/{owner.name}"]
        return []

    def reconcile(self, key: str) -> None:
        pod = self.store.get_pod(key)
        if pod is None or pod.meta.deletion_timestamp:
            self._gc_pod(key)
            return
        ns = pod.meta.namespace
        for prc in pod.spec.resource_claims:
            if prc.claim_name or not prc.template_name:
                continue  # user-managed claim (or malformed entry)
            claim_name = dra.effective_claim_name(pod.meta.name, prc)
            claim_key = f"{ns}/{claim_name}"
            if self.store.get_object("ResourceClaim", claim_key) is not None:
                continue
            tmpl = self.store.get_object(
                "ResourceClaimTemplate", f"{ns}/{prc.template_name}")
            if tmpl is None:
                self.recorder.eventf(
                    key, TYPE_WARNING, "FailedResourceClaimCreation",
                    "ResourceClaim",
                    f'resourceclaimtemplate "{prc.template_name}" not found')
                raise MissingTemplateError(
                    f"{key}: template {ns}/{prc.template_name} not found")
            try:
                self.store.create_object("ResourceClaim", ResourceClaim(
                    meta=ObjectMeta(
                        name=claim_name, namespace=ns,
                        owner_references=(OwnerReference(
                            kind="Pod", name=pod.meta.name, controller=True),)),
                    resource_class_name=tmpl.resource_class_name,
                    selectors=dict(tmpl.selectors)))
            except Conflict:
                pass  # raced with another worker: the claim exists

    def _gc_pod(self, pod_key: str) -> None:
        """Consuming pod gone: release its reservations everywhere, delete
        the claims it owned (claim_controller.go podResourceClaim deletion +
        reservedFor cleanup) and its PodSchedulingContext."""
        ns, _, pod_name = pod_key.partition("/")
        for claim_key, claim in self.store.snapshot_map("ResourceClaim").items():
            if claim.meta.namespace != ns:
                continue
            owner = claim.meta.controller_of()
            if owner is not None and owner.kind == "Pod" and owner.name == pod_name:
                self.store.delete_object("ResourceClaim", claim_key)
            elif pod_key in claim.reserved_for:
                self.store.release_claim(claim_key, pod_key)
        if self.store.get_object("PodSchedulingContext", pod_key) is not None:
            self.store.delete_object("PodSchedulingContext", pod_key)
