"""API field validation on the store's write path: an own copy of
``kubernetes_tpu/api/validation.py`` (pkg/apis/core/validation/
validation.go, distilled), cut to the kinds the port's store writes.

The checks that change behaviour: name and label syntax, container shape,
request and limit consistency, enum domains, numeric ranges, the pod's
immutable fields on update. ``Store`` runs ``validate`` right after the
admission chain on every create (``validate_update`` on an update), the
strategy.Validate position, unless ``validation_enabled`` is False. Each
validator mirrors its reference function and returns ``field.Path:
message`` strings; ``validate`` raises ``ValidationError`` with the JAX
message format.
"""

from __future__ import annotations

import re
from typing import List, Optional

from . import resource as resource_api
from .types import QUOTA_CLAIMS, QUOTA_CPU, QUOTA_MEMORY, QUOTA_PODS

# util/validation/validation.go IsDNS1123Subdomain / IsDNS1123Label /
# IsQualifiedName / IsValidLabelValue
_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")
_QUALIFIED_NAME_PART = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")
_LABEL_VALUE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?$")

MAX_DNS1123_SUBDOMAIN = 253
MAX_DNS1123_LABEL = 63
MAX_LABEL_VALUE = 63

VALID_RESTART_POLICIES = {"Always", "OnFailure", "Never", ""}
VALID_TAINT_EFFECTS = {"NoSchedule", "PreferNoSchedule", "NoExecute"}
VALID_TOLERATION_OPERATORS = {"Exists", "Equal", ""}
VALID_WHEN_UNSATISFIABLE = {"DoNotSchedule", "ScheduleAnyway"}
VALID_PREEMPTION_POLICIES = {"PreemptLowerPriority", "Never", ""}
# the user-priority ceiling (validation.go ValidatePriorityClass; values
# above 1e9 are reserved for system classes)
HIGHEST_USER_PRIORITY = 1_000_000_000


class ValidationError(Exception):
    """errors.NewInvalid analog: carries the per-field error list."""

    def __init__(self, kind: str, name: str, errors: List[str]):
        self.kind = kind
        self.name = name
        self.errors = errors
        super().__init__(
            f"{kind} {name!r} is invalid: " + "; ".join(errors[:8]))


def is_dns1123_subdomain(value: str) -> bool:
    return (0 < len(value) <= MAX_DNS1123_SUBDOMAIN
            and _DNS1123_SUBDOMAIN.match(value) is not None)


def is_dns1123_label(value: str) -> bool:
    return (0 < len(value) <= MAX_DNS1123_LABEL
            and _DNS1123_LABEL.match(value) is not None)


def is_qualified_name(value: str) -> List[str]:
    """IsQualifiedName: [prefix/]name; prefix a DNS subdomain, name ≤63."""
    errs = []
    parts = value.split("/")
    if len(parts) == 1:
        name = parts[0]
    elif len(parts) == 2:
        prefix, name = parts
        if not prefix:
            errs.append("prefix part must be non-empty")
        elif not is_dns1123_subdomain(prefix):
            errs.append(f"prefix part {prefix!r} must be a DNS subdomain")
    else:
        return [f"a qualified name {value!r} must have at most one '/'"]
    if not name:
        errs.append("name part must be non-empty")
    elif len(name) > MAX_DNS1123_LABEL or not _QUALIFIED_NAME_PART.match(name):
        errs.append(f"name part {name!r} must consist of alphanumerics, "
                    "'-', '_' or '.', ≤63 chars, alphanumeric-bounded")
    return errs


def validate_labels(labels, path: str) -> List[str]:
    """unversioned validation ValidateLabels."""
    errs = []
    for k, v in (labels or {}).items():
        errs += [f"{path}.{k}: {m}" for m in is_qualified_name(str(k))]
        sv = str(v)
        if len(sv) > MAX_LABEL_VALUE or not _LABEL_VALUE.match(sv):
            errs.append(f"{path}.{k}: label value {sv!r} must be ≤63 chars "
                        "of alphanumerics, '-', '_' or '.'")
    return errs


def validate_object_meta(meta, requires_namespace: bool, path="metadata") -> List[str]:
    """ValidateObjectMeta (validation.go:356): name syntax, namespace
    syntax/presence, label syntax."""
    errs = []
    if not meta.name:
        errs.append(f"{path}.name: name is required")
    elif not is_dns1123_subdomain(meta.name):
        errs.append(f"{path}.name: {meta.name!r} must be a lowercase RFC-1123 "
                    "subdomain (a-z0-9, '-', '.')")
    ns = getattr(meta, "namespace", "")
    if requires_namespace:
        if not ns:
            errs.append(f"{path}.namespace: namespace is required")
        elif not is_dns1123_label(ns):
            errs.append(f"{path}.namespace: {ns!r} must be a lowercase "
                        "RFC-1123 label")
    errs += validate_labels(getattr(meta, "labels", None), f"{path}.labels")
    return errs


# ------------------------------------------------------------------- pods


def _validate_resource_amounts(requests, limits, path) -> List[str]:
    """validateContainerResourceRequirements: parseable, non-negative,
    request ≤ limit per resource."""
    errs = []
    parsed = {}
    for field_name, amounts in (("requests", requests), ("limits", limits)):
        for res, q in (amounts or {}).items():
            try:
                v = resource_api.canonical(res, q)
            except Exception:  # noqa: BLE001 — unparseable quantity
                errs.append(f"{path}.{field_name}.{res}: quantity {q!r} is invalid")
                continue
            if v < 0:
                errs.append(f"{path}.{field_name}.{res}: must be ≥ 0")
            parsed[(field_name, res)] = v
    for res, _q in (limits or {}).items():
        req = parsed.get(("requests", res))
        lim = parsed.get(("limits", res))
        if req is not None and lim is not None and req > lim:
            errs.append(f"{path}.requests.{res}: must be ≤ the {res} limit")
    return errs


def _validate_containers(containers, path, init=False) -> List[str]:
    """validateContainers (validation.go:3013): non-empty (main set), unique
    DNS-label names, image set, port ranges, resource consistency."""
    errs = []
    if not containers and not init:
        return [f"{path}: must contain at least one container"]
    seen = set()
    for i, c in enumerate(containers or ()):
        p = f"{path}[{i}]"
        if not c.name:
            errs.append(f"{p}.name: name is required")
        elif not is_dns1123_label(c.name):
            errs.append(f"{p}.name: {c.name!r} must be a lowercase RFC-1123 label")
        elif c.name in seen:
            errs.append(f"{p}.name: duplicate container name {c.name!r}")
        seen.add(c.name)
        for j, port in enumerate(getattr(c, "ports", ()) or ()):
            for attr in ("container_port", "host_port"):
                v = getattr(port, attr, 0)
                if v and not (0 < v <= 65535):
                    errs.append(f"{p}.ports[{j}].{attr}: {v} must be in 1-65535")
        errs += _validate_resource_amounts(
            getattr(c, "requests", None), getattr(c, "limits", None),
            f"{p}.resources")
    return errs


def _validate_tolerations(tolerations, path) -> List[str]:
    """validateTolerations: operator/effect domains; Exists forbids value;
    empty key requires Exists."""
    errs = []
    for i, t in enumerate(tolerations or ()):
        p = f"{path}[{i}]"
        if t.operator not in VALID_TOLERATION_OPERATORS:
            errs.append(f"{p}.operator: {t.operator!r} must be Exists or Equal")
        if t.effect and t.effect not in VALID_TAINT_EFFECTS:
            errs.append(f"{p}.effect: {t.effect!r} must be one of "
                        f"{sorted(VALID_TAINT_EFFECTS)}")
        if t.operator == "Exists" and t.value:
            errs.append(f"{p}.value: must be empty when operator is Exists")
        if not t.key and t.operator not in ("Exists", ""):
            errs.append(f"{p}.operator: must be Exists when key is empty")
    return errs


def _validate_spread_constraints(constraints, path) -> List[str]:
    """validateTopologySpreadConstraints: maxSkew ≥ 1, topologyKey set,
    whenUnsatisfiable domain, no duplicate {key, whenUnsatisfiable}."""
    errs = []
    seen = set()
    for i, c in enumerate(constraints or ()):
        p = f"{path}[{i}]"
        if c.max_skew < 1:
            errs.append(f"{p}.maxSkew: {c.max_skew} must be ≥ 1")
        if not c.topology_key:
            errs.append(f"{p}.topologyKey: topologyKey is required")
        if c.when_unsatisfiable not in VALID_WHEN_UNSATISFIABLE:
            errs.append(f"{p}.whenUnsatisfiable: {c.when_unsatisfiable!r} "
                        "must be DoNotSchedule or ScheduleAnyway")
        dup = (c.topology_key, c.when_unsatisfiable)
        if dup in seen:
            errs.append(f"{p}.topologyKey: duplicate constraint "
                        f"{{{c.topology_key}, {c.when_unsatisfiable}}}")
        seen.add(dup)
        # validateMinDomains: ≥ 1, and only with DoNotSchedule
        md = getattr(c, "min_domains", None)
        if md is not None:
            if md < 1:
                errs.append(f"{p}.minDomains: {md} must be greater than 0")
            if c.when_unsatisfiable != "DoNotSchedule":
                errs.append(f"{p}.minDomains: can only be specified when "
                            "whenUnsatisfiable is DoNotSchedule")
        errs += _validate_label_selector(getattr(c, "label_selector", None),
                                        f"{p}.labelSelector")
    return errs


_SELECTOR_SET_OPS = {"In", "NotIn"}
_SELECTOR_EXIST_OPS = {"Exists", "DoesNotExist"}
_SELECTOR_NUM_OPS = {"Gt", "Lt"}


def _validate_requirement(req, path, node: bool) -> List[str]:
    """ValidateLabelSelectorRequirement / ValidateNodeSelectorRequirement:
    operator domain; In/NotIn need ≥1 value; Exists/DoesNotExist forbid
    values; node-only Gt/Lt need exactly one integer value."""
    errs = [f"{path}.key: {m}" for m in is_qualified_name(req.key)] if req.key \
        else [f"{path}.key: key is required"]
    op = req.operator
    allowed = _SELECTOR_SET_OPS | _SELECTOR_EXIST_OPS | (
        _SELECTOR_NUM_OPS if node else set())
    if op not in allowed:
        errs.append(f"{path}.operator: {op!r} is not a valid operator")
        return errs
    if op in _SELECTOR_SET_OPS and not req.values:
        errs.append(f"{path}.values: must be specified when operator is {op}")
    if op in _SELECTOR_EXIST_OPS and req.values:
        errs.append(f"{path}.values: may not be specified when operator is {op}")
    if op in _SELECTOR_NUM_OPS:
        if len(req.values) != 1:
            errs.append(f"{path}.values: must have a single element for {op}")
        else:
            try:
                int(req.values[0])
            except ValueError:
                errs.append(f"{path}.values[0]: {req.values[0]!r} must be an integer")
    return errs


def _validate_label_selector(sel, path) -> List[str]:
    """ValidateLabelSelector (metav1 validation)."""
    if sel is None:
        return []
    errs = validate_labels(sel.match_labels, f"{path}.matchLabels")
    for i, req in enumerate(sel.match_expressions or ()):
        errs += _validate_requirement(req, f"{path}.matchExpressions[{i}]",
                                      node=False)
    return errs


def _validate_pod_affinity_term(term, path) -> List[str]:
    """validatePodAffinityTerm (validation.go:3280): topologyKey required,
    selector shapes valid, namespace names valid."""
    errs = []
    if not term.topology_key:
        errs.append(f"{path}.topologyKey: can not be empty")
    errs += _validate_label_selector(term.label_selector, f"{path}.labelSelector")
    errs += _validate_label_selector(term.namespace_selector,
                                     f"{path}.namespaceSelector")
    for i, ns in enumerate(term.namespaces or ()):
        if not is_dns1123_label(ns):
            errs.append(f"{path}.namespaces[{i}]: {ns!r} must be a DNS label")
    return errs


def _validate_affinity(affinity, path) -> List[str]:
    """validateAffinity (validation.go:3236): node selector terms' expression
    shape, pod (anti-)affinity term shape, preferred weights in 1-100."""
    errs = []
    if affinity is None:
        return errs
    na = affinity.node_affinity
    if na is not None:
        base = f"{path}.nodeAffinity"
        if na.required is not None:
            for ti, term in enumerate(na.required.terms or ()):
                tp = f"{base}.required.nodeSelectorTerms[{ti}]"
                for ei, req in enumerate(term.match_expressions or ()):
                    errs += _validate_requirement(
                        req, f"{tp}.matchExpressions[{ei}]", node=True)
        for pi, pref in enumerate(na.preferred or ()):
            pp = f"{base}.preferred[{pi}]"
            if not (1 <= pref.weight <= 100):
                errs.append(f"{pp}.weight: {pref.weight} must be in the range 1-100")
            for ei, req in enumerate(pref.preference.match_expressions or ()):
                errs += _validate_requirement(
                    req, f"{pp}.preference.matchExpressions[{ei}]", node=True)
    for attr, key in (("pod_affinity", "podAffinity"),
                      ("pod_anti_affinity", "podAntiAffinity")):
        pa = getattr(affinity, attr)
        if pa is None:
            continue
        base = f"{path}.{key}"
        for ti, term in enumerate(pa.required or ()):
            errs += _validate_pod_affinity_term(term, f"{base}.required[{ti}]")
        for ti, wt in enumerate(pa.preferred or ()):
            tp = f"{base}.preferred[{ti}]"
            if not (1 <= wt.weight <= 100):
                errs.append(f"{tp}.weight: {wt.weight} must be in the range 1-100")
            errs += _validate_pod_affinity_term(wt.term, f"{tp}.podAffinityTerm")
    return errs


def validate_pod(pod) -> List[str]:
    """ValidatePod / ValidatePodSpec (validation.go:3488)."""
    errs = validate_object_meta(pod.meta, requires_namespace=True)
    spec = pod.spec
    errs += _validate_containers(spec.containers, "spec.containers")
    errs += _validate_containers(spec.init_containers,
                                 "spec.initContainers", init=True)
    # init container names must not collide with main containers
    main = {c.name for c in spec.containers}
    for i, c in enumerate(spec.init_containers or ()):
        if c.name in main:
            errs.append(f"spec.initContainers[{i}].name: duplicates a "
                        f"container name {c.name!r}")
    # AccumulateUniqueHostPorts (validation.go:3003): a (hostIP, protocol,
    # hostPort) triple may appear at most once across the pod's containers
    seen_hp = set()
    for ci, c in enumerate(spec.containers or ()):
        for pi, port in enumerate(getattr(c, "ports", ()) or ()):
            hp = getattr(port, "host_port", 0)
            if not hp:
                continue
            key = (getattr(port, "host_ip", ""), getattr(port, "protocol", "TCP"), hp)
            if key in seen_hp:
                errs.append(f"spec.containers[{ci}].ports[{pi}].hostPort: "
                            f"duplicate host port {key}")
            seen_hp.add(key)
    errs += _validate_tolerations(spec.tolerations, "spec.tolerations")
    errs += _validate_spread_constraints(
        spec.topology_spread_constraints, "spec.topologySpreadConstraints")
    errs += _validate_affinity(spec.affinity, "spec.affinity")
    errs += validate_labels(spec.node_selector, "spec.nodeSelector")
    if spec.preemption_policy not in VALID_PREEMPTION_POLICIES:
        errs.append(f"spec.preemptionPolicy: {spec.preemption_policy!r} must "
                    "be PreemptLowerPriority or Never")
    if spec.priority_class_name and not is_dns1123_subdomain(spec.priority_class_name):
        errs.append("spec.priorityClassName: must be a DNS subdomain")
    return errs


def validate_pod_update(old, new) -> List[str]:
    """ValidatePodUpdate (validation.go:4262): spec is immutable except
    node_name (binding), tolerations additions, and container images —
    the reference allows image updates and toleration appends only."""
    errs = []
    if old.spec.node_name and new.spec.node_name != old.spec.node_name:
        errs.append("spec.nodeName: may not be changed once set (pods/binding"
                    " is the only writer)")
    for attr, label in (
        ("node_selector", "spec.nodeSelector"),
        ("priority", "spec.priority"),
        ("scheduler_name", "spec.schedulerName"),
        ("host_network", "spec.hostNetwork"),
    ):
        if getattr(new.spec, attr) != getattr(old.spec, attr):
            errs.append(f"{label}: field is immutable")
    if len(new.spec.containers or ()) != len(old.spec.containers or ()):
        errs.append("spec.containers: may not add or remove containers")
    return errs


# ------------------------------------------------------------ other kinds


def validate_node(node) -> List[str]:
    """ValidateNode (validation.go:5022): meta + taint domains + capacity."""
    errs = validate_object_meta(node.meta, requires_namespace=False)
    seen_taints = set()
    for i, t in enumerate(node.spec.taints or ()):
        p = f"spec.taints[{i}]"
        if not t.key:
            errs.append(f"{p}.key: key is required")
        else:
            errs += [f"{p}.key: {m}" for m in is_qualified_name(t.key)]
        if t.effect not in VALID_TAINT_EFFECTS:
            errs.append(f"{p}.effect: {t.effect!r} must be one of "
                        f"{sorted(VALID_TAINT_EFFECTS)}")
        if t.value and _LABEL_VALUE.match(t.value) is None:
            errs.append(f"{p}.value: {t.value!r} is not a valid taint value")
        # validateNodeTaints: duplicate (key, effect) pairs rejected
        pair = (t.key, t.effect)
        if pair in seen_taints:
            errs.append(f"{p}: duplicate taint {pair}")
        seen_taints.add(pair)
    for res, q in (node.status.capacity or {}).items():
        try:
            if resource_api.canonical(res, q) < 0:
                errs.append(f"status.capacity.{res}: must be ≥ 0")
        except Exception:  # noqa: BLE001
            errs.append(f"status.capacity.{res}: quantity {q!r} is invalid")
    return errs


def validate_service(svc) -> List[str]:
    """ValidateService (validation.go:4497): port ranges + selector labels."""
    errs = validate_object_meta(svc.meta, requires_namespace=True)
    for i, port in enumerate(getattr(svc, "ports", ()) or ()):
        v = getattr(port, "port", 0)
        if not (0 < v <= 65535):
            errs.append(f"spec.ports[{i}].port: {v} must be in 1-65535")
    errs += validate_labels(getattr(svc, "selector", None), "spec.selector")
    return errs


def validate_priority_class(pc) -> List[str]:
    """ValidatePriorityClass: user values below the system ceiling."""
    errs = validate_object_meta(pc.meta, requires_namespace=False)
    if getattr(pc, "value", 0) > HIGHEST_USER_PRIORITY \
            and not pc.meta.name.startswith("system-"):
        errs.append(f"value: must be ≤ {HIGHEST_USER_PRIORITY}")
    return errs


def validate_namespace(ns) -> List[str]:
    errs = []
    if not ns.meta.name:
        errs.append("metadata.name: name is required")
    elif not is_dns1123_label(ns.meta.name):
        errs.append(f"metadata.name: {ns.meta.name!r} must be a lowercase "
                    "RFC-1123 label")
    errs += validate_labels(ns.meta.labels, "metadata.labels")
    return errs


# the JAX lists cut to the kinds the port's store holds (RuntimeClass is in
# neither, as in JAX: its objects are not validated)
_CLUSTER_SCOPED_META_ONLY = (
    "PersistentVolume", "StorageClass", "CSINode", "ResourceClass",
)
_NAMESPACED_META_ONLY = (
    "PersistentVolumeClaim", "ServiceAccount", "ReplicaSet", "ReplicationController",
    "StatefulSet", "PodDisruptionBudget", "ResourceQuota", "LimitRange", "ResourceClaim",
    "PodSchedulingContext",
)


def validate_pod_group(pg) -> list:
    errs = validate_object_meta(pg.meta, requires_namespace=True)
    if pg.min_member < 1:
        errs.append("spec.minMember: must be >= 1")
    if pg.schedule_timeout_seconds < 0:
        errs.append("spec.scheduleTimeoutSeconds: must be >= 0")
    return errs


def validate_scheduling_quota(sq) -> list:
    errs = validate_object_meta(sq.meta, requires_namespace=True)
    if sq.weight < 0:
        errs.append("spec.weight: must be >= 0")
    if sq.cohort and not is_dns1123_label(sq.cohort):
        errs.append(f"spec.cohort: {sq.cohort!r} must be a lowercase "
                    "RFC-1123 label")
    for dim, v in sq.hard.items():
        if dim not in _QUOTA_DIMENSIONS:
            errs.append(f"spec.hard[{dim}]: unknown quota dimension "
                        f"(expected one of {sorted(_QUOTA_DIMENSIONS)})")
        elif not isinstance(v, int) or v < 0:
            errs.append(f"spec.hard[{dim}]: must be a non-negative integer")
    return errs


# one source of truth with the ledger's dimension keys (api/types.py /
# framework/plugins/quota.py) — a dimension added there validates here
_QUOTA_DIMENSIONS = frozenset(
    (QUOTA_PODS, QUOTA_CPU, QUOTA_MEMORY, QUOTA_CLAIMS))


def validate(kind: str, obj) -> None:
    """Strategy.Validate dispatch; raises ValidationError on failure."""
    if kind == "PodGroup":
        errs = validate_pod_group(obj)
        if errs:
            raise ValidationError(kind, obj.meta.name, errs)
        return
    if kind == "SchedulingQuota":
        errs = validate_scheduling_quota(obj)
        if errs:
            raise ValidationError(kind, obj.meta.name, errs)
        return
    if kind == "Pod":
        errs = validate_pod(obj)
    elif kind == "Node":
        errs = validate_node(obj)
    elif kind == "Service":
        errs = validate_service(obj)
    elif kind == "PriorityClass":
        errs = validate_priority_class(obj)
    elif kind == "Namespace":
        errs = validate_namespace(obj)
    elif kind in _CLUSTER_SCOPED_META_ONLY:
        errs = validate_object_meta(obj.meta, requires_namespace=False)
    elif kind in _NAMESPACED_META_ONLY:
        errs = validate_object_meta(obj.meta, requires_namespace=True)
    else:
        return  # kinds without field checks (RuntimeClass, the scheduling kinds above)
    if errs:
        raise ValidationError(kind, getattr(obj.meta, "name", ""), errs)


def validate_update(kind: str, old, new) -> None:
    validate(kind, new)
    if kind == "Pod" and old is not None:
        errs = validate_pod_update(old, new)
        if errs:
            raise ValidationError(kind, new.meta.name, errs)
