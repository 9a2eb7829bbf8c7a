"""The admission chain on the store's write path: an own copy of
``kubernetes_tpu/apiserver/admission.py`` (apiserver pkg/admission and the
kube-apiserver plugin order, pkg/kubeapiserver/options/plugins.go:64).

``Store`` runs ``AdmissionChain.run`` (every plugin's mutating ``admit``,
then every plugin's ``validate``) before a create, ``run_update`` before an
update, and ``charge`` (the stateful step, with its undo) right before a
pod's insert, after the duplicate-key check, as the JAX ``ClusterStore``
does. A plugin refuses a write by raising ``AdmissionError``. A plugin
mutates the object the caller passed in, so the store's handlers, and the
scheduler's queue behind them, see the admitted pod: its defaulted
tolerations, node selector, requests and overhead.

``default_chain()`` is the JAX default chain, every plugin in its order;
``all_ordered_plugins()`` the JAX roster with the default-off plugins a
configuration may enable. NodeRestriction, OwnerReferencesPermission-
Enforcement and the certificate plugins read the request's identity
(``Store.request_user`` / ``request_groups``, pinned by the HTTP front) and
``Store.authorizer``; the admission webhooks call a configuration's
in-process handler or POST an AdmissionReview-shaped body to its URL.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from ..api import resource as resource_api
from ..api.codec import to_wire
from ..api.types import (ANNOTATION_DEFAULT_INGRESS_CLASS, ANNOTATION_DEFAULT_STORAGE_CLASS,
                         TOLERATION_OP_EXISTS, Namespace, ObjectMeta, Pod, ResourceQuota, Taint,
                         Toleration)


class AdmissionError(Exception):
    """403: an admission plugin refused the write."""

    def __init__(self, plugin: str, message: str):
        super().__init__(f"admission denied by {plugin}: {message}")
        self.plugin = plugin


class AdmissionPlugin:
    name = "plugin"

    def admit(self, store, kind: str, obj) -> None:
        """Mutating pass; may modify obj in place."""

    def validate(self, store, kind: str, obj) -> None:
        """Validating pass; raise AdmissionError to refuse. Free of store
        side effects: it runs before the duplicate-key check."""

    def admit_update(self, store, kind: str, old, obj) -> None:
        """Mutating pass of an update."""

    def validate_update(self, store, kind: str, old, obj) -> None:
        """Validating pass of an update; raise AdmissionError to refuse."""

    def charge(self, store, kind: str, obj) -> Optional[Callable[[], None]]:
        """The stateful step, run right before the insert (after the
        duplicate-key check), so that a refused create leaves nothing
        behind. Returns an undo callable or None; raise AdmissionError to
        refuse."""
        return None


class NamespaceLifecycle(AdmissionPlugin):
    """plugin/namespace/lifecycle: no creates into a terminating or absent
    namespace; an absent ``default`` is tolerated (the reference creates it
    at startup)."""

    name = "NamespaceLifecycle"

    NAMESPACED_KINDS = ("Pod", "Service", "ReplicaSet", "StatefulSet",
                        "Deployment", "DaemonSet", "Job")

    def validate(self, store, kind: str, obj) -> None:
        if kind not in self.NAMESPACED_KINDS:
            return
        ns = store.namespaces.get(obj.meta.namespace)
        if ns is None:
            if obj.meta.namespace != "default":
                raise AdmissionError(
                    self.name, f"namespace {obj.meta.namespace!r} not found")
            return
        if ns.meta.deletion_timestamp:
            raise AdmissionError(self.name,
                                 f"namespace {obj.meta.namespace} is terminating")


class DefaultPriority(AdmissionPlugin):
    """plugin/pkg/admission/priority: a pod that names a PriorityClass and
    sets no priority gets the class's value; a class the store does not
    hold refuses the pod."""

    name = "Priority"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        pod: Pod = obj
        if pod.spec.priority_class_name and not pod.spec.priority:
            pc = store.priority_classes.get(pod.spec.priority_class_name)
            if pc is None:
                raise AdmissionError(
                    self.name, f"no PriorityClass {pod.spec.priority_class_name!r}")
            pod.spec.priority = pc.value


def pod_quota_usage(pod: Pod) -> dict:
    """The quota dimensions a pod consumes (quota/v1/evaluator/core): its
    containers' requests, without the init containers and the overhead."""
    cpu = sum(resource_api.canonical("cpu", c.requests.get("cpu", 0))
              for c in pod.spec.containers)
    mem = sum(resource_api.canonical("memory", c.requests.get("memory", 0))
              for c in pod.spec.containers)
    return {"pods": 1, "requests.cpu": cpu, "requests.memory": mem}


class ResourceQuotaAdmission(AdmissionPlugin):
    """plugin/pkg/admission/resourcequota: a pod create must fit every
    quota of its namespace. ``validate`` fails fast without writing;
    ``charge`` checks every quota, then charges them all, and returns the
    undo. Usage is never released on delete: the reference's quota
    controller reconciles it."""

    name = "ResourceQuota"

    def _matching(self, store, obj):
        return [rq for rq in store.resource_quotas.values()
                if rq.meta.namespace == obj.meta.namespace]

    def _check(self, rq: ResourceQuota, usage: dict) -> None:
        for dim, amount in usage.items():
            if dim not in rq.hard:
                continue
            if rq.used.get(dim, 0) + amount > rq.hard[dim]:
                raise AdmissionError(
                    self.name,
                    f"exceeded quota {rq.meta.name}: {dim} "
                    f"used {rq.used.get(dim, 0)} + requested {amount} > hard {rq.hard[dim]}",
                )

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        usage = pod_quota_usage(obj)
        for rq in self._matching(store, obj):
            self._check(rq, usage)

    def charge(self, store, kind: str, obj) -> Optional[Callable[[], None]]:
        if kind != "Pod":
            return None
        usage = pod_quota_usage(obj)
        quotas = self._matching(store, obj)
        # every quota checked before any is charged: a later refusal never
        # leaves a charge on an earlier one
        for rq in quotas:
            self._check(rq, usage)
        for rq in quotas:
            for dim, amount in usage.items():
                if dim in rq.hard:
                    rq.used[dim] = rq.used.get(dim, 0) + amount

        def undo() -> None:
            for rq in quotas:
                for dim, amount in usage.items():
                    if dim in rq.hard:
                        rq.used[dim] = rq.used.get(dim, 0) - amount

        return undo


class LimitRanger(AdmissionPlugin):
    """plugin/pkg/admission/limitranger: the namespace's LimitRange
    Container defaults fill unset requests and limits, then requests are
    held to min and max. It runs before ResourceQuota, which sees the
    defaulted requests."""

    name = "LimitRanger"

    def _ranges(self, store, ns: str):
        return [lr for lr in store.limit_ranges.values()
                if lr.meta.namespace == ns]

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        pod: Pod = obj
        mutated = False
        for lr in self._ranges(store, pod.meta.namespace):
            for item in lr.limits:
                if item.type != "Container":
                    continue
                for c in pod.spec.containers:
                    for r, q in item.default_request.items():
                        if r not in c.requests:
                            c.requests[r] = q
                            mutated = True
                    for r, q in item.default.items():
                        c.limits.setdefault(r, q)
        if mutated:
            pod.invalidate_request_cache()

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        pod: Pod = obj
        for lr in self._ranges(store, pod.meta.namespace):
            for item in lr.limits:
                if item.type != "Container":
                    continue
                for c in pod.spec.containers:
                    for r, q in item.max.items():
                        req = c.requests.get(r)
                        if req is not None and (
                            resource_api.canonical(r, req) > resource_api.canonical(r, q)
                        ):
                            raise AdmissionError(
                                self.name,
                                f"container {c.name!r} {r} request {req} exceeds max {q}")
                    for r, q in item.min.items():
                        req = c.requests.get(r)
                        if req is not None and (
                            resource_api.canonical(r, req) < resource_api.canonical(r, q)
                        ):
                            raise AdmissionError(
                                self.name,
                                f"container {c.name!r} {r} request {req} below min {q}")


# the default NoExecute toleration window (defaulttolerationseconds/admission.go)
DEFAULT_TOLERATION_SECONDS = 300
NOT_READY_TAINT = "node.kubernetes.io/not-ready"
UNREACHABLE_TAINT = "node.kubernetes.io/unreachable"


class DefaultTolerationSeconds(AdmissionPlugin):
    """plugin/pkg/admission/defaulttolerationseconds: every pod gets the
    not-ready and unreachable NoExecute tolerations (300 s) it does not
    already have."""

    name = "DefaultTolerationSeconds"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        pod: Pod = obj
        extra = []
        for key in (NOT_READY_TAINT, UNREACHABLE_TAINT):
            taint = Taint(key=key, effect="NoExecute")
            if not any(t.tolerates(taint) for t in pod.spec.tolerations):
                extra.append(Toleration(
                    key=key, operator=TOLERATION_OP_EXISTS, effect="NoExecute",
                    toleration_seconds=DEFAULT_TOLERATION_SECONDS))
        if extra:
            pod.spec.tolerations = tuple(pod.spec.tolerations) + tuple(extra)


class PodNodeSelector(AdmissionPlugin):
    """plugin/pkg/admission/podnodeselector: the namespace's
    ``scheduler.alpha.kubernetes.io/node-selector`` annotation is merged
    into the pod's nodeSelector; a conflicting value refuses the pod."""

    name = "PodNodeSelector"
    ANNOTATION = "scheduler.alpha.kubernetes.io/node-selector"

    @staticmethod
    def _parse(ann: str) -> dict:
        out = {}
        for part in ann.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip()
        return out

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        pod: Pod = obj
        ns = store.namespaces.get(pod.meta.namespace)
        ann = ns.meta.annotations.get(self.ANNOTATION) if ns is not None else None
        if not ann:
            return
        for k, v in self._parse(ann).items():
            cur = pod.spec.node_selector.get(k)
            if cur is not None and cur != v:
                raise AdmissionError(
                    self.name,
                    f"pod node selector {k}={cur} conflicts with namespace selector {k}={v}")
            pod.spec.node_selector[k] = v


class TaintNodesByCondition(AdmissionPlugin):
    """plugin/pkg/admission/nodetaint: a node created not Ready gets the
    ``node.kubernetes.io/not-ready`` NoSchedule taint (the JAX chain taints
    only such nodes, where the reference taints every new node and lets the
    node lifecycle controller lift it)."""

    name = "TaintNodesByCondition"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Node":
            return
        node = obj
        if node.status.ready:
            return
        if any(t.key == NOT_READY_TAINT and t.effect == "NoSchedule"
               for t in node.spec.taints):
            return
        node.spec.taints = tuple(node.spec.taints) + (
            Taint(key=NOT_READY_TAINT, effect="NoSchedule"),)


class ServiceAccountAdmission(AdmissionPlugin):
    """plugin/pkg/admission/serviceaccount: a pod's serviceAccountName
    defaults to ``default``, and any other must exist (the ``default``
    account is tolerated as absent: its controller creates it lazily)."""

    name = "ServiceAccount"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        if not obj.spec.service_account_name:
            obj.spec.service_account_name = "default"

    def admit_update(self, store, kind: str, old, obj) -> None:
        if kind != "Pod":
            return
        if not obj.spec.service_account_name:
            # the stored pod's account, else the default: an update that
            # omits the field keeps the identity
            obj.spec.service_account_name = (
                old.spec.service_account_name if old is not None else ""
            ) or "default"

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        sa_name = obj.spec.service_account_name
        if sa_name == "default":
            return
        key = f"{obj.meta.namespace}/{sa_name}"
        if key not in store.service_accounts:
            raise AdmissionError(
                self.name, f"service account {key!r} not found")

    def validate_update(self, store, kind: str, old, obj) -> None:
        # existence is checked at create, and on update only when the
        # account changes
        if (kind == "Pod" and old is not None
                and obj.spec.service_account_name != old.spec.service_account_name):
            self.validate(store, kind, obj)


# pod-security.kubernetes.io/enforce levels (pod-security-admission/api)
PS_PRIVILEGED = "privileged"
PS_BASELINE = "baseline"
PS_RESTRICTED = "restricted"
PS_ENFORCE_LABEL = "pod-security.kubernetes.io/enforce"


class PodSecurity(AdmissionPlugin):
    """plugin/pkg/admission/podsecurity: the namespace's Pod Security
    Standards level (its ``pod-security.kubernetes.io/enforce`` label).

    - baseline: no hostNetwork, hostPID or hostIPC, no privileged
      container, no capability added beyond the baseline list;
    - restricted: baseline, and runAsNonRoot, allowPrivilegeEscalation
      false, every capability dropped (NET_BIND_SERVICE alone may be
      added back).
    """

    name = "PodSecurity"

    _BASELINE_CAPS = {"AUDIT_WRITE", "CHOWN", "DAC_OVERRIDE", "FOWNER",
                      "FSETID", "KILL", "MKNOD", "NET_BIND_SERVICE",
                      "SETFCAP", "SETGID", "SETPCAP", "SETUID", "SYS_CHROOT"}

    def _level(self, store, ns_name: str) -> str:
        ns = store.namespaces.get(ns_name)
        if ns is None:
            return PS_PRIVILEGED
        return ns.meta.labels.get(PS_ENFORCE_LABEL, PS_PRIVILEGED)

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        level = self._level(store, obj.meta.namespace)
        if level == PS_PRIVILEGED:
            return
        spec = obj.spec
        if spec.host_network or spec.host_pid or spec.host_ipc:
            raise AdmissionError(
                self.name, f"host namespaces are not allowed at level {level}")
        pod_sc = spec.security_context
        for c in list(spec.containers) + list(spec.init_containers):
            sc = c.security_context
            if sc is not None:
                if sc.privileged:
                    raise AdmissionError(
                        self.name,
                        f"privileged container {c.name!r} not allowed at level {level}")
                extra = set(sc.capabilities_add) - self._BASELINE_CAPS
                if extra:
                    raise AdmissionError(
                        self.name,
                        f"container {c.name!r} adds forbidden capabilities {sorted(extra)}")
            if level == PS_RESTRICTED:
                run_as_non_root = None
                if sc is not None and sc.run_as_non_root is not None:
                    run_as_non_root = sc.run_as_non_root
                elif pod_sc is not None and pod_sc.run_as_non_root is not None:
                    run_as_non_root = pod_sc.run_as_non_root
                if not run_as_non_root:
                    raise AdmissionError(
                        self.name,
                        f"container {c.name!r} must set runAsNonRoot at level restricted")
                if sc is None or sc.allow_privilege_escalation is not False:
                    raise AdmissionError(
                        self.name,
                        f"container {c.name!r} must set allowPrivilegeEscalation: "
                        "false at level restricted")
                if sc.capabilities_add and set(sc.capabilities_add) != {"NET_BIND_SERVICE"}:
                    raise AdmissionError(
                        self.name,
                        f"container {c.name!r} may only add NET_BIND_SERVICE at "
                        "level restricted")
                if "ALL" not in sc.capabilities_drop:
                    raise AdmissionError(
                        self.name,
                        f"container {c.name!r} must drop ALL capabilities at "
                        "level restricted")

    def validate_update(self, store, kind: str, old, obj) -> None:
        # a pod whose spec is unchanged keeps updating after its namespace's
        # level tightens (the status-subresource exemption)
        if kind == "Pod" and old is not None and obj.spec == old.spec:
            return
        self.validate(store, kind, obj)


class NodeRestriction(AdmissionPlugin):
    """plugin/pkg/admission/noderestriction: a kubelet identity
    (``system:node:<name>``) may only write its own Node object, pods bound
    to itself, and its own Lease. Other users are unrestricted."""

    name = "NodeRestriction"

    @staticmethod
    def _node_of(user: str) -> Optional[str]:
        return user[len("system:node:"):] if user.startswith("system:node:") else None

    def _check(self, store, kind: str, obj, old=None) -> None:
        me = self._node_of(store.request_user())
        if me is None:
            return
        if kind == "Node":
            if obj.meta.name != me:
                raise AdmissionError(
                    self.name, f"node {me!r} may not modify node {obj.meta.name!r}")
        elif kind == "Pod":
            target = obj.spec.node_name or (old.spec.node_name if old is not None else "")
            if target != me:
                raise AdmissionError(
                    self.name, f"node {me!r} may only write pods bound to itself")
        elif kind == "Lease":
            if obj.meta.name != me:
                raise AdmissionError(
                    self.name, f"node {me!r} may not write lease {obj.meta.name!r}")

    def validate(self, store, kind: str, obj) -> None:
        self._check(store, kind, obj)

    def validate_update(self, store, kind: str, old, obj) -> None:
        self._check(store, kind, obj, old)


class DefaultStorageClass(AdmissionPlugin):
    """plugin/pkg/admission/storage/storageclass/setdefault: a PVC created
    without a storage class gets the StorageClass annotated as the
    default."""

    name = "DefaultStorageClass"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "PersistentVolumeClaim" or obj.storage_class:
            return
        for sc in store.storage_classes.values():
            if sc.meta.annotations.get(ANNOTATION_DEFAULT_STORAGE_CLASS) == "true":
                obj.storage_class = sc.meta.name
                return


class PersistentVolumeClaimResize(AdmissionPlugin):
    """plugin/pkg/admission/storage/persistentvolume/resize: growing a bound
    PVC requires its StorageClass to allow volume expansion; shrinking is
    never allowed."""

    name = "PersistentVolumeClaimResize"

    def validate_update(self, store, kind: str, old, obj) -> None:
        if kind != "PersistentVolumeClaim" or old is None:
            return
        if obj.requested_bytes < old.requested_bytes:
            raise AdmissionError(self.name, "persistent volume claims cannot shrink")
        if obj.requested_bytes > old.requested_bytes:
            sc = store.storage_classes.get(old.storage_class)
            if sc is None or not sc.allow_volume_expansion:
                raise AdmissionError(
                    self.name,
                    f"storage class {old.storage_class!r} does not allow volume expansion")


class OwnerReferencesPermissionEnforcement(AdmissionPlugin):
    """plugin/pkg/admission/gc: setting blockOwnerDeletion on an owner
    reference requires permission to update the owner's finalizers
    (checked through the store's authorizer when one is configured)."""

    name = "OwnerReferencesPermissionEnforcement"

    def _check(self, store, obj, old=None) -> None:
        if store.authorizer is None:
            return
        refs = getattr(obj.meta, "owner_references", ()) or ()
        old_blocking = set()
        if old is not None:
            old_blocking = {(r.kind, r.name) for r in
                            (getattr(old.meta, "owner_references", ()) or ())
                            if getattr(r, "block_owner_deletion", False)}
        for r in refs:
            if not getattr(r, "block_owner_deletion", False):
                continue
            if (r.kind, r.name) in old_blocking:
                continue  # pre-existing blocks are not re-checked
            user = store.request_user()
            # prefer the group-aware check when the authorizer offers one
            # (RBAC group bindings + system:masters must count here too)
            check = getattr(store.authorizer, "allowed_for", None)
            if check is not None:
                ok = check(user, store.request_groups(), "update", r.kind,
                           r.name, subresource="finalizers")
            else:
                ok = store.authorizer.allowed(user, "update", r.kind, r.name,
                                              subresource="finalizers")
            if not ok:
                raise AdmissionError(
                    self.name,
                    f"user {user!r} may not set blockOwnerDeletion on "
                    f"{r.kind}/{r.name} (cannot update finalizers)")

    def validate(self, store, kind: str, obj) -> None:
        self._check(store, obj)

    def validate_update(self, store, kind: str, old, obj) -> None:
        self._check(store, obj, old)


@dataclasses.dataclass
class WebhookConfiguration:
    """admissionregistration.k8s.io webhook configuration, reduced: a kind
    filter plus either an in-process callable or a localhost URL speaking
    AdmissionReview-shaped JSON (apiserver pkg/admission/plugin/webhook)."""

    meta: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    kinds: Tuple[str, ...] = ()          # () = all kinds
    namespaces: Tuple[str, ...] = ()     # () = all namespaces
    handler: Optional[Callable] = None   # (review: dict) -> dict
    url: str = ""                        # http://127.0.0.1:PORT/... alternative
    failure_policy: str = "Fail"         # or "Ignore"

    def matches(self, kind: str, obj) -> bool:
        if self.kinds and kind not in self.kinds:
            return False
        if self.namespaces:
            ns = getattr(obj.meta, "namespace", "")
            if ns not in self.namespaces:
                return False
        return True


def _call_webhook(cfg: WebhookConfiguration, review: dict) -> dict:
    if cfg.handler is not None:
        return cfg.handler(review)
    wire = dict(review, object=to_wire(review["object"]))
    req = urllib.request.Request(
        cfg.url, data=json.dumps(wire).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5.0) as resp:
        return json.loads(resp.read().decode())


def _apply_patch(obj, patch: List[dict]) -> None:
    """JSON-patch subset (add/replace/remove on /-separated paths) applied to
    the typed object: {"op": "replace", "path": "/spec/priority", "value": 7}.
    Intermediate segments may cross dicts; a malformed patch rejects the
    request as an AdmissionError rather than escaping as a raw attribute
    error."""
    for p in patch:
        parts = [s for s in p.get("path", "").split("/") if s]
        if not parts:
            continue
        try:
            target = obj
            for attr in parts[:-1]:
                target = target[attr] if isinstance(target, dict) else getattr(target, attr)
            leaf = parts[-1]
            op = p.get("op", "replace")
            if op == "remove":
                if isinstance(target, dict):
                    target.pop(leaf, None)
                else:
                    setattr(target, leaf, None)
            elif op in ("add", "replace"):
                if isinstance(target, dict):
                    target[leaf] = p.get("value")
                else:
                    setattr(target, leaf, p.get("value"))
            else:
                raise ValueError(f"unsupported op {op!r}")
        except AdmissionError:
            raise
        except Exception as exc:  # noqa: BLE001 — malformed webhook patch
            raise AdmissionError(
                "MutatingAdmissionWebhook",
                f"invalid patch {p.get('op', 'replace')} {p.get('path')!r}: {exc}",
            ) from exc


class MutatingAdmissionWebhook(AdmissionPlugin):
    """MutatingAdmissionWebhook: dispatch matching webhook configurations
    registered as MutatingWebhookConfiguration objects; their patches are
    applied to the object before validation."""

    name = "MutatingAdmissionWebhook"
    _configs_attr = "mutating_webhooks"
    _mutating = True

    def _dispatch(self, store, kind: str, obj, operation: str, old=None) -> None:
        for cfg in list(getattr(store, self._configs_attr).values()):
            if not isinstance(cfg, WebhookConfiguration) or not cfg.matches(kind, obj):
                continue
            review = {
                "kind": kind,
                "operation": operation,
                "name": getattr(obj.meta, "name", ""),
                "namespace": getattr(obj.meta, "namespace", ""),
                "object": obj,
            }
            try:
                resp = _call_webhook(cfg, review)
                if not isinstance(resp, dict):
                    raise TypeError(f"webhook returned {type(resp).__name__}, not a dict")
            except Exception as exc:  # noqa: BLE001 — webhook transport failure
                if cfg.failure_policy == "Ignore":
                    continue
                raise AdmissionError(self.name, f"webhook call failed: {exc}") from exc
            if not resp.get("allowed", True):
                raise AdmissionError(
                    self.name, resp.get("message", "denied by webhook"))
            if self._mutating and resp.get("patch"):
                _apply_patch(obj, resp["patch"])
                if hasattr(obj, "invalidate_request_cache"):
                    # the patch may have touched container requests/limits;
                    # a stale cached resource_request would feed the
                    # scheduler and quota silently (ADVICE r3)
                    obj.invalidate_request_cache()

    def admit(self, store, kind: str, obj) -> None:
        self._dispatch(store, kind, obj, "CREATE")

    def admit_update(self, store, kind: str, old, obj) -> None:
        self._dispatch(store, kind, obj, "UPDATE", old)


class ValidatingAdmissionWebhook(MutatingAdmissionWebhook):
    """ValidatingAdmissionWebhook: same dispatch, validating phase, no
    patches applied (runs after every mutating plugin, plugins.go order)."""

    name = "ValidatingAdmissionWebhook"
    _configs_attr = "validating_webhooks"
    _mutating = False

    def admit(self, store, kind: str, obj) -> None:  # move to validate phase
        pass

    def admit_update(self, store, kind: str, old, obj) -> None:
        pass

    def validate(self, store, kind: str, obj) -> None:
        self._dispatch(store, kind, obj, "CREATE")

    def validate_update(self, store, kind: str, old, obj) -> None:
        self._dispatch(store, kind, obj, "UPDATE", old)


class NamespaceAutoProvision(AdmissionPlugin):
    """plugin/pkg/admission/namespace/autoprovision (default-off): create
    the namespace on first use instead of rejecting."""

    name = "NamespaceAutoProvision"

    def admit(self, store, kind: str, obj) -> None:
        ns = getattr(getattr(obj, "meta", None), "namespace", "")
        if not ns or kind in store.CLUSTER_SCOPED_KINDS or kind == "Namespace":
            return
        if ns not in store.namespaces:  # the map is keyed by name
            store.create_namespace(Namespace(meta=ObjectMeta(name=ns)))


class NamespaceExists(AdmissionPlugin):
    """plugin/pkg/admission/namespace/exists (default-off): reject objects
    in namespaces that don't exist (lifecycle covers the terminating case)."""

    name = "NamespaceExists"

    def validate(self, store, kind: str, obj) -> None:
        ns = getattr(getattr(obj, "meta", None), "namespace", "")
        if not ns or kind in store.CLUSTER_SCOPED_KINDS or kind == "Namespace":
            return
        if ns == "default" or ns == "kube-system":
            return  # always-present namespaces
        if ns not in store.namespaces:  # the map is keyed by name
            raise AdmissionError(self.name, f"namespace {ns!r} does not exist")


class SecurityContextDeny(AdmissionPlugin):
    """plugin/pkg/admission/securitycontext/scdeny (default-off): reject
    pods that set privileged/user/group security context fields."""

    name = "SecurityContextDeny"

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        contexts = [obj.spec.security_context] + [
            c.security_context for c in list(obj.spec.containers)
            + list(obj.spec.init_containers)]
        for sc in contexts:
            if sc is None:
                continue
            if getattr(sc, "privileged", False) \
                    or getattr(sc, "run_as_user", None) is not None:
                # `is not None`, NOT truthiness: runAsUser 0 (root) is
                # exactly the request this plugin exists to reject
                raise AdmissionError(
                    self.name, "pod sets a forbidden securityContext field")


class LimitPodHardAntiAffinityTopology(AdmissionPlugin):
    """plugin/pkg/admission/antiaffinity (default-off): required pod
    anti-affinity may only use the hostname topology key."""

    name = "LimitPodHardAntiAffinityTopology"
    _HOSTNAME = "kubernetes.io/hostname"

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Pod" or obj.spec.affinity is None:
            return
        anti = obj.spec.affinity.pod_anti_affinity
        for term in (anti.required if anti is not None else ()):
            if term.topology_key != self._HOSTNAME:
                raise AdmissionError(
                    self.name,
                    f"required pod anti-affinity topologyKey "
                    f"{term.topology_key!r} must be {self._HOSTNAME}")


class AlwaysPullImages(AdmissionPlugin):
    """plugin/pkg/admission/alwayspullimages (default-off): force
    imagePullPolicy=Always so credentials are re-checked per node."""

    name = "AlwaysPullImages"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            c.image_pull_policy = "Always"


class ExtendedResourceToleration(AdmissionPlugin):
    """plugin/pkg/admission/extendedresourcetoleration (default-off): pods
    requesting extended resources get matching tolerations automatically."""

    name = "ExtendedResourceToleration"
    _STANDARD = {"cpu", "memory", "ephemeral-storage", "pods"}

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod":
            return
        extended = set()
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            for res in list(c.requests) + list(c.limits):
                if res not in self._STANDARD and "/" in res:
                    extended.add(res)
        have = {t.key for t in obj.spec.tolerations}
        add = tuple(
            Toleration(key=res, operator="Exists", effect="NoSchedule")
            for res in sorted(extended) if res not in have)
        if add:
            obj.spec.tolerations = tuple(obj.spec.tolerations) + add


class StorageObjectInUseProtection(AdmissionPlugin):
    """plugin/pkg/admission/storage/storageobjectinuseprotection: the
    pvc-protection and pv-protection finalizers."""

    name = "StorageObjectInUseProtection"
    PVC_FINALIZER = "kubernetes.io/pvc-protection"
    PV_FINALIZER = "kubernetes.io/pv-protection"

    def admit(self, store, kind: str, obj) -> None:
        if kind == "PersistentVolumeClaim":
            if self.PVC_FINALIZER not in obj.meta.finalizers:
                obj.meta.finalizers = tuple(obj.meta.finalizers) + (self.PVC_FINALIZER,)
        elif kind == "PersistentVolume":
            if self.PV_FINALIZER not in obj.meta.finalizers:
                obj.meta.finalizers = tuple(obj.meta.finalizers) + (self.PV_FINALIZER,)


class RuntimeClassAdmission(AdmissionPlugin):
    """plugin/pkg/admission/runtimeclass: a pod naming a RuntimeClass gets
    its overhead (when the pod sets none) and its node selector and
    tolerations merged in; an unknown class, or an overhead of the pod's
    own that differs from the class's, refuses the pod."""

    name = "RuntimeClass"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Pod" or not obj.spec.runtime_class_name:
            return
        rc = store.runtime_classes.get(obj.spec.runtime_class_name)
        if rc is None:
            raise AdmissionError(
                self.name,
                f"RuntimeClass {obj.spec.runtime_class_name!r} not found")
        if rc.overhead and not obj.spec.overhead:
            obj.spec.overhead = dict(rc.overhead)
            obj.invalidate_request_cache()
        if rc.node_selector:
            merged = dict(rc.node_selector)
            merged.update(obj.spec.node_selector)
            obj.spec.node_selector = merged
        if rc.tolerations:
            have = {(t.key, t.effect) for t in obj.spec.tolerations}
            obj.spec.tolerations = tuple(obj.spec.tolerations) + tuple(
                t for t in rc.tolerations if (t.key, t.effect) not in have)

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Pod" or not obj.spec.runtime_class_name:
            return
        rc = store.runtime_classes.get(obj.spec.runtime_class_name)
        if rc is not None and rc.overhead and obj.spec.overhead != rc.overhead:
            raise AdmissionError(self.name, "pod overhead must match RuntimeClass")


def _signer_authorized(store, verb: str, signer: str, subresource: str) -> bool:
    """Authorize a CSR state transition against the store's authorizer with
    the REQUEST's full identity (user + groups — allowed() would drop the
    groups and defeat the system:masters bypass). No authorizer = open."""
    authz = getattr(store, "authorizer", None)
    if authz is None:
        return True
    user = store.request_user()
    groups = store.request_groups()
    if hasattr(authz, "allowed_for"):
        return authz.allowed_for(user, groups, verb,
                                 "CertificateSigningRequest", signer,
                                 subresource=subresource)
    return authz.allowed(user, verb, "CertificateSigningRequest", signer,
                         subresource=subresource)


class CertificateApproval(AdmissionPlugin):
    """plugin/pkg/admission/certificates/approval: flipping a CSR to
    approved/denied requires authorization on the signer (the approve
    subresource verb)."""

    name = "CertificateApproval"

    def validate_update(self, store, kind: str, old, obj) -> None:
        if kind != "CertificateSigningRequest" or old is None:
            return
        if (obj.approved, obj.denied) == (old.approved, old.denied):
            return
        if not _signer_authorized(store, "approve", obj.signer_name, "approval"):
            raise AdmissionError(
                self.name, f"user {store.request_user()!r} may not approve "
                f"CSRs for signer {obj.signer_name!r}")


class CertificateSigning(AdmissionPlugin):
    """plugin/pkg/admission/certificates/signing: populating the issued
    certificate requires authorization on the signer (the sign verb)."""

    name = "CertificateSigning"

    def validate_update(self, store, kind: str, old, obj) -> None:
        if kind != "CertificateSigningRequest" or old is None:
            return
        if obj.certificate == old.certificate:
            return
        if not _signer_authorized(store, "sign", obj.signer_name, "status"):
            raise AdmissionError(
                self.name, f"user {store.request_user()!r} may not sign "
                f"CSRs for signer {obj.signer_name!r}")


class CertificateSubjectRestriction(AdmissionPlugin):
    """plugin/pkg/admission/certificates/subjectrestriction: reject
    kube-apiserver-client CSRs for the system:masters group."""

    name = "CertificateSubjectRestriction"

    def validate(self, store, kind: str, obj) -> None:
        if kind != "CertificateSigningRequest":
            return
        if obj.signer_name == "kubernetes.io/kube-apiserver-client" \
                and "system:masters" in obj.groups:
            raise AdmissionError(
                self.name,
                "CSRs for system:masters are not allowed through this signer")


class DenyServiceExternalIPs(AdmissionPlugin):
    """plugin/pkg/admission/denyserviceexternalips: externalIPs are a
    traffic-interception hazard; new ones are rejected outright."""

    name = "DenyServiceExternalIPs"

    def validate(self, store, kind: str, obj) -> None:
        if kind == "Service" and getattr(obj, "external_ips", ()):
            raise AdmissionError(self.name, "externalIPs are not allowed")

    def validate_update(self, store, kind: str, old, obj) -> None:
        if kind != "Service":
            return
        new_ips = set(getattr(obj, "external_ips", ()))
        old_ips = set(getattr(old, "external_ips", ()) if old is not None else ())
        if new_ips - old_ips:
            raise AdmissionError(self.name, "may not add externalIPs")


class EventRateLimit(AdmissionPlugin):
    """plugin/pkg/admission/eventratelimit (default-off): token-bucket
    limits on Event API writes per namespace, so a crash-looping component
    cannot flood the store (the reference's Namespace-type limit)."""

    name = "EventRateLimit"

    def __init__(self, qps: float = 50.0, burst: int = 100, now_fn=None):
        self.qps = qps
        self.burst = burst
        self.now_fn = now_fn or time.monotonic
        self._buckets: Dict[str, Tuple[float, float]] = {}  # ns -> (tokens, last)

    def validate(self, store, kind: str, obj) -> None:
        if kind != "Event":
            return
        ns = obj.meta.namespace
        now = self.now_fn()
        tokens, last = self._buckets.get(ns, (float(self.burst), now))
        tokens = min(float(self.burst), tokens + (now - last) * self.qps)
        if tokens < 1.0:
            raise AdmissionError(
                self.name, f"event rate limit exceeded for namespace {ns!r}")
        self._buckets[ns] = (tokens - 1.0, now)

    def validate_update(self, store, kind: str, old, obj) -> None:
        # series count bumps consume the same budget (the reference limits
        # all Event requests, not just creates)
        self.validate(store, kind, obj)


class DefaultIngressClass(AdmissionPlugin):
    """plugin/pkg/admission/network/defaultingressclass: an Ingress created
    without ingressClassName gets the cluster default (the IngressClass
    carrying the is-default-class annotation); two marked defaults reject."""

    name = "DefaultIngressClass"

    def admit(self, store, kind: str, obj) -> None:
        if kind != "Ingress" or obj.ingress_class_name:
            return
        defaults = [ic for ic in getattr(store, "ingress_classes", {}).values()
                    if ic.meta.annotations.get(ANNOTATION_DEFAULT_INGRESS_CLASS)
                    == "true"]
        if len(defaults) > 1:
            raise AdmissionError(
                self.name, "multiple IngressClasses marked as default")
        if defaults:
            obj.ingress_class_name = defaults[0].meta.name


class AlwaysAdmit(AdmissionPlugin):
    """plugin/pkg/admission/admit (default-off, deprecated no-op)."""

    name = "AlwaysAdmit"


class AlwaysDeny(AdmissionPlugin):
    """plugin/pkg/admission/deny (default-off): reject everything."""

    name = "AlwaysDeny"

    def validate(self, store, kind: str, obj) -> None:
        raise AdmissionError(self.name, "admission denied by AlwaysDeny")


def all_ordered_plugins() -> List[AdmissionPlugin]:
    """The full AllOrderedPlugins roster (plugins.go:64) in reference
    order — incl. the default-OFF plugins a config may enable."""
    return [AlwaysAdmit(), NamespaceAutoProvision(), NamespaceLifecycle(),
            NamespaceExists(), SecurityContextDeny(),
            LimitPodHardAntiAffinityTopology(), LimitRanger(),
            ServiceAccountAdmission(), NodeRestriction(),
            TaintNodesByCondition(), AlwaysPullImages(), PodSecurity(),
            PodNodeSelector(), DefaultPriority(), DefaultTolerationSeconds(),
            EventRateLimit(), ExtendedResourceToleration(), DefaultStorageClass(),
            StorageObjectInUseProtection(),
            OwnerReferencesPermissionEnforcement(),
            PersistentVolumeClaimResize(), RuntimeClassAdmission(),
            CertificateApproval(), CertificateSigning(),
            CertificateSubjectRestriction(), DefaultIngressClass(),
            DenyServiceExternalIPs(),
            MutatingAdmissionWebhook(), ValidatingAdmissionWebhook(),
            ResourceQuotaAdmission(), AlwaysDeny()]


def default_chain() -> List[AdmissionPlugin]:
    """The JAX ``default_chain()`` (AllOrderedPlugins, plugins.go:64, cut to
    the modeled plugins), in its order: NamespaceLifecycle → LimitRanger →
    ServiceAccount → NodeRestriction → TaintNodesByCondition → PodSecurity
    → PodNodeSelector → Priority → DefaultTolerationSeconds →
    DefaultStorageClass → StorageObjectInUseProtection →
    PersistentVolumeClaimResize → OwnerReferencesPermissionEnforcement →
    RuntimeClass → CertificateApproval → CertificateSigning →
    CertificateSubjectRestriction → DefaultIngressClass →
    MutatingAdmissionWebhook → ValidatingAdmissionWebhook → ResourceQuota
    (always last). DenyServiceExternalIPs is off by default upstream
    (``all_ordered_plugins`` has it)."""
    return [NamespaceLifecycle(), LimitRanger(), ServiceAccountAdmission(),
            NodeRestriction(), TaintNodesByCondition(), PodSecurity(),
            PodNodeSelector(), DefaultPriority(), DefaultTolerationSeconds(),
            DefaultStorageClass(), StorageObjectInUseProtection(),
            PersistentVolumeClaimResize(),
            OwnerReferencesPermissionEnforcement(), RuntimeClassAdmission(),
            CertificateApproval(), CertificateSigning(),
            CertificateSubjectRestriction(), DefaultIngressClass(),
            MutatingAdmissionWebhook(), ValidatingAdmissionWebhook(),
            ResourceQuotaAdmission()]


class AdmissionChain:
    def __init__(self, plugins: Optional[List[AdmissionPlugin]] = None):
        self.plugins = plugins if plugins is not None else default_chain()

    def run(self, store, kind: str, obj) -> None:
        for p in self.plugins:
            p.admit(store, kind, obj)
        for p in self.plugins:
            p.validate(store, kind, obj)

    def run_update(self, store, kind: str, old, obj) -> None:
        for p in self.plugins:
            p.admit_update(store, kind, old, obj)
        for p in self.plugins:
            p.validate_update(store, kind, old, obj)

    def charge(self, store, kind: str, obj) -> Callable[[], None]:
        """Every plugin's stateful step; returns one undo for them all. A
        refusal first rolls back the charges of the plugins before it."""
        undos: List[Callable[[], None]] = []

        def undo_all() -> None:
            for u in reversed(undos):
                u()

        for p in self.plugins:
            try:
                u = p.charge(store, kind, obj)
            except AdmissionError:
                undo_all()
                raise
            if u is not None:
                undos.append(u)
        return undo_all
