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

``default_chain()`` holds, in the JAX order, every plugin of the JAX
default chain that acts on a kind the port's store holds; its docstring
names the plugins left out and why.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..api import resource as resource_api
from ..api.types import (ANNOTATION_DEFAULT_STORAGE_CLASS, TOLERATION_OP_EXISTS, Pod,
                         ResourceQuota, Taint, Toleration)


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


def default_chain() -> List[AdmissionPlugin]:
    """The JAX ``default_chain()`` (AllOrderedPlugins, plugins.go:64) in its
    order, cut to the plugins that act on a kind the port's store holds:
    NamespaceLifecycle → LimitRanger → ServiceAccount →
    TaintNodesByCondition → PodSecurity → PodNodeSelector → Priority →
    DefaultTolerationSeconds → DefaultStorageClass →
    StorageObjectInUseProtection → RuntimeClass → ResourceQuota (always
    last).

    Left out until the HTTP front comes (ROADMAP A21): NodeRestriction and
    OwnerReferencesPermissionEnforcement, which read the request's
    identity, which the port's store does not carry; the Mutating and
    Validating admission webhooks, which call out over HTTP;
    CertificateApproval, CertificateSigning, CertificateSubjectRestriction
    and DefaultIngressClass, which act on kinds the port has no store for;
    PersistentVolumeClaimResize, which checks PVC updates the port never
    makes."""
    return [NamespaceLifecycle(), LimitRanger(), ServiceAccountAdmission(),
            TaintNodesByCondition(), PodSecurity(), PodNodeSelector(), DefaultPriority(),
            DefaultTolerationSeconds(), DefaultStorageClass(),
            StorageObjectInUseProtection(), RuntimeClassAdmission(),
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
