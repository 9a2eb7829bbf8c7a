"""core/v1 (+ apps/batch/policy/storage/scheduling/autoscaling) external
wire conversions: the REFERENCE's camelCase JSON manifest shapes ⇄ this
framework's internal dataclasses.

This is the L1 conversion layer (staging/src/k8s.io/api shapes to internal
types, apimachinery conversion functions): a standard Kubernetes manifest —
`spec.containers[].resources.requests`, `affinity.nodeAffinity.required...`,
`topologySpreadConstraints`, `tolerations` — decodes to the internal Pod,
and internal objects encode back to manifest-shaped dicts. register() wires
every kind into a Scheme (api/scheme.py). An own copy of
``kubernetes_tpu/api/corev1.py``, whole: for the same manifest both packages
decode equal objects, and encode equal manifests.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import types as t
from .scheme import GroupVersionKind, Scheme

# --------------------------------------------------------------------- meta


def meta_from(md: dict) -> t.ObjectMeta:
    refs = tuple(
        t.OwnerReference(kind=r.get("kind", ""), name=r.get("name", ""),
                         controller=bool(r.get("controller", False)),
                         block_owner_deletion=bool(r.get("blockOwnerDeletion", False)))
        for r in (md.get("ownerReferences") or ()))
    return t.ObjectMeta(
        name=md.get("name", ""),
        namespace=md.get("namespace", "default"),
        uid=str(md.get("uid", "")),
        labels=dict(md.get("labels") or {}),
        annotations=dict(md.get("annotations") or {}),
        owner_references=refs,
        finalizers=tuple(md.get("finalizers") or ()),
    )


def meta_to(m: t.ObjectMeta) -> dict:
    md: dict = {"name": m.name, "namespace": m.namespace}
    if m.uid:
        md["uid"] = m.uid
    if m.labels:
        md["labels"] = dict(m.labels)
    if m.annotations:
        md["annotations"] = dict(m.annotations)
    if m.resource_version:
        md["resourceVersion"] = str(m.resource_version)
    if m.owner_references:
        md["ownerReferences"] = [
            {"kind": r.kind, "name": r.name, "controller": r.controller,
             "blockOwnerDeletion": r.block_owner_deletion}
            for r in m.owner_references]
    if m.finalizers:
        md["finalizers"] = list(m.finalizers)
    if m.deletion_timestamp:
        md["deletionTimestamp"] = m.deletion_timestamp
    return md


# ---------------------------------------------------------------- selectors


def label_selector_from(sel: Optional[dict]) -> Optional[t.LabelSelector]:
    if sel is None:
        return None
    return t.LabelSelector(
        match_labels=dict(sel.get("matchLabels") or {}),
        match_expressions=tuple(
            t.Requirement(key=e.get("key", ""), operator=e.get("operator", "In"),
                          values=tuple(e.get("values") or ()))
            for e in (sel.get("matchExpressions") or ())),
    )


def label_selector_to(sel: Optional[t.LabelSelector]) -> Optional[dict]:
    if sel is None:
        return None
    out: dict = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": r.key, "operator": r.operator, "values": list(r.values)}
            for r in sel.match_expressions]
    return out


def _nst_from(term: dict) -> t.NodeSelectorTerm:
    fields_name = None
    for f in term.get("matchFields") or ():
        if f.get("key") == "metadata.name" and f.get("operator") == "In":
            vals = f.get("values") or ()
            fields_name = vals[0] if vals else None
    return t.NodeSelectorTerm(
        match_expressions=tuple(
            t.Requirement(key=e.get("key", ""), operator=e.get("operator", "In"),
                          values=tuple(e.get("values") or ()))
            for e in (term.get("matchExpressions") or ())),
        match_fields_name=fields_name,
    )


def _nst_to(term: t.NodeSelectorTerm) -> dict:
    out: dict = {}
    if term.match_expressions:
        out["matchExpressions"] = [
            {"key": r.key, "operator": r.operator, "values": list(r.values)}
            for r in term.match_expressions]
    if term.match_fields_name is not None:
        out["matchFields"] = [{"key": "metadata.name", "operator": "In",
                               "values": [term.match_fields_name]}]
    return out


def _pat_from(term: dict) -> t.PodAffinityTerm:
    return t.PodAffinityTerm(
        label_selector=label_selector_from(term.get("labelSelector")),
        topology_key=term.get("topologyKey", ""),
        namespaces=tuple(term.get("namespaces") or ()),
        namespace_selector=label_selector_from(term.get("namespaceSelector")),
    )


def _pat_to(term: t.PodAffinityTerm) -> dict:
    out: dict = {"topologyKey": term.topology_key}
    if term.label_selector is not None:
        out["labelSelector"] = label_selector_to(term.label_selector)
    if term.namespaces:
        out["namespaces"] = list(term.namespaces)
    if term.namespace_selector is not None:
        out["namespaceSelector"] = label_selector_to(term.namespace_selector)
    return out


def affinity_from(aff: Optional[dict]) -> Optional[t.Affinity]:
    if not aff:
        return None
    na = pa = paa = None
    if aff.get("nodeAffinity"):
        n = aff["nodeAffinity"]
        req = n.get("requiredDuringSchedulingIgnoredDuringExecution")
        na = t.NodeAffinity(
            required=t.NodeSelector(terms=tuple(
                _nst_from(term) for term in (req.get("nodeSelectorTerms") or ())))
            if req else None,
            preferred=tuple(
                t.PreferredSchedulingTerm(weight=int(p.get("weight", 1)),
                                          preference=_nst_from(p.get("preference") or {}))
                for p in (n.get("preferredDuringSchedulingIgnoredDuringExecution") or ())),
        )
    for src_key, anti in (("podAffinity", False), ("podAntiAffinity", True)):
        if not aff.get(src_key):
            continue
        p = aff[src_key]
        required = tuple(_pat_from(term) for term in
                         (p.get("requiredDuringSchedulingIgnoredDuringExecution") or ()))
        preferred = tuple(
            t.WeightedPodAffinityTerm(weight=int(w.get("weight", 1)),
                                      term=_pat_from(w.get("podAffinityTerm") or {}))
            for w in (p.get("preferredDuringSchedulingIgnoredDuringExecution") or ()))
        if anti:
            paa = t.PodAntiAffinity(required=required, preferred=preferred)
        else:
            pa = t.PodAffinity(required=required, preferred=preferred)
    if na is None and pa is None and paa is None:
        return None
    return t.Affinity(node_affinity=na, pod_affinity=pa, pod_anti_affinity=paa)


def affinity_to(aff: Optional[t.Affinity]) -> Optional[dict]:
    if aff is None:
        return None
    out: dict = {}
    if aff.node_affinity is not None:
        n: dict = {}
        if aff.node_affinity.required is not None:
            n["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [
                    _nst_to(term) for term in aff.node_affinity.required.terms]}
        if aff.node_affinity.preferred:
            n["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": p.weight, "preference": _nst_to(p.preference)}
                for p in aff.node_affinity.preferred]
        out["nodeAffinity"] = n
    for attr, key in (("pod_affinity", "podAffinity"),
                      ("pod_anti_affinity", "podAntiAffinity")):
        pa = getattr(aff, attr)
        if pa is None:
            continue
        p: dict = {}
        if pa.required:
            p["requiredDuringSchedulingIgnoredDuringExecution"] = [
                _pat_to(term) for term in pa.required]
        if pa.preferred:
            p["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": w.weight, "podAffinityTerm": _pat_to(w.term)}
                for w in pa.preferred]
        out[key] = p
    return out


# ---------------------------------------------------------------------- pod


def _security_context_from(sc: Optional[dict]) -> Optional[t.SecurityContext]:
    if not sc:
        return None
    caps = sc.get("capabilities") or {}
    return t.SecurityContext(
        privileged=sc.get("privileged"),
        allow_privilege_escalation=sc.get("allowPrivilegeEscalation"),
        run_as_non_root=sc.get("runAsNonRoot"),
        run_as_user=sc.get("runAsUser"),
        capabilities_add=tuple(caps.get("add") or ()),
        capabilities_drop=tuple(caps.get("drop") or ()),
    )


def _security_context_to(sc: Optional[t.SecurityContext]) -> Optional[dict]:
    if sc is None:
        return None
    out: dict = {}
    for attr, key in (("privileged", "privileged"),
                      ("allow_privilege_escalation", "allowPrivilegeEscalation"),
                      ("run_as_non_root", "runAsNonRoot"),
                      ("run_as_user", "runAsUser")):
        v = getattr(sc, attr)
        if v is not None:
            out[key] = v
    if sc.capabilities_add or sc.capabilities_drop:
        out["capabilities"] = {}
        if sc.capabilities_add:
            out["capabilities"]["add"] = list(sc.capabilities_add)
        if sc.capabilities_drop:
            out["capabilities"]["drop"] = list(sc.capabilities_drop)
    return out


def _container_from(c: dict) -> t.Container:
    res = c.get("resources") or {}
    return t.Container(
        name=c.get("name", ""),
        image=c.get("image", ""),
        requests=dict(res.get("requests") or {}),
        limits=dict(res.get("limits") or {}),
        ports=tuple(
            t.ContainerPort(host_port=int(p.get("hostPort", 0)),
                            container_port=int(p.get("containerPort", 0)),
                            protocol=p.get("protocol", t.PROTO_TCP),
                            host_ip=p.get("hostIP", ""))
            for p in (c.get("ports") or ())),
        security_context=_security_context_from(c.get("securityContext")),
    )


def _container_to(c: t.Container) -> dict:
    out: dict = {"name": c.name, "image": c.image}
    res: dict = {}
    if c.requests:
        res["requests"] = {k: str(v) for k, v in c.requests.items()}
    if c.limits:
        res["limits"] = {k: str(v) for k, v in c.limits.items()}
    if res:
        out["resources"] = res
    if c.ports:
        out["ports"] = [
            {k: v for k, v in (("hostPort", p.host_port),
                               ("containerPort", p.container_port),
                               ("protocol", p.protocol), ("hostIP", p.host_ip)) if v}
            for p in c.ports]
    sc = _security_context_to(c.security_context)
    if sc:
        out["securityContext"] = sc
    return out


def pod_from(doc: dict) -> t.Pod:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    volumes = []
    ephemeral = []
    for v in spec.get("volumes") or ():
        pvc = v.get("persistentVolumeClaim")
        if pvc and pvc.get("claimName"):
            volumes.append(pvc["claimName"])
        elif v.get("ephemeral") is not None:
            ephemeral.append(v.get("name", ""))
    tolerations = tuple(
        t.Toleration(key=x.get("key", ""), operator=x.get("operator", "Equal"),
                     value=x.get("value", ""), effect=x.get("effect", ""),
                     toleration_seconds=x.get("tolerationSeconds"))
        for x in (spec.get("tolerations") or ()))
    spreads = tuple(
        t.TopologySpreadConstraint(
            max_skew=int(c.get("maxSkew", 1)),
            topology_key=c.get("topologyKey", ""),
            when_unsatisfiable=c.get("whenUnsatisfiable", t.DO_NOT_SCHEDULE),
            label_selector=label_selector_from(c.get("labelSelector")),
            min_domains=c.get("minDomains"))
        for c in (spec.get("topologySpreadConstraints") or ()))
    resource_claims = tuple(
        t.PodResourceClaim(
            name=rc.get("name", ""),
            claim_name=(rc.get("source") or {}).get("resourceClaimName", ""),
            template_name=(rc.get("source") or {}).get(
                "resourceClaimTemplateName", ""))
        for rc in (spec.get("resourceClaims") or ()))
    pod_spec = t.PodSpec(
        containers=[_container_from(c) for c in (spec.get("containers") or ())],
        init_containers=[_container_from(c) for c in (spec.get("initContainers") or ())],
        node_name=spec.get("nodeName", ""),
        node_selector=dict(spec.get("nodeSelector") or {}),
        affinity=affinity_from(spec.get("affinity")),
        tolerations=tolerations,
        topology_spread_constraints=spreads,
        priority=int(spec.get("priority") or 0),
        priority_class_name=spec.get("priorityClassName", ""),
        preemption_policy=spec.get("preemptionPolicy") or "PreemptLowerPriority",
        scheduler_name=spec.get("schedulerName") or "default-scheduler",
        overhead=dict(spec.get("overhead") or {}),
        volumes=tuple(volumes),
        ephemeral_claims=tuple(ephemeral),
        resource_claims=resource_claims,
        service_account_name=spec.get("serviceAccountName", ""),
        host_network=bool(spec.get("hostNetwork", False)),
        host_pid=bool(spec.get("hostPID", False)),
        host_ipc=bool(spec.get("hostIPC", False)),
        security_context=_security_context_from(spec.get("securityContext")),
    )
    return t.Pod(
        meta=meta_from(doc.get("metadata") or {}),
        spec=pod_spec,
        status=t.PodStatus(
            phase=status.get("phase", "Pending"),
            nominated_node_name=status.get("nominatedNodeName", ""),
        ),
    )


def pod_to(pod: t.Pod) -> dict:
    spec: dict = {}
    if pod.spec.containers:
        spec["containers"] = [_container_to(c) for c in pod.spec.containers]
    if pod.spec.init_containers:
        spec["initContainers"] = [_container_to(c) for c in pod.spec.init_containers]
    if pod.spec.node_name:
        spec["nodeName"] = pod.spec.node_name
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    aff = affinity_to(pod.spec.affinity)
    if aff:
        spec["affinity"] = aff
    if pod.spec.tolerations:
        spec["tolerations"] = [
            {k: v for k, v in (("key", x.key), ("operator", x.operator),
                               ("value", x.value), ("effect", x.effect),
                               ("tolerationSeconds", x.toleration_seconds))
             if v not in ("", None)}
            for x in pod.spec.tolerations]
    if pod.spec.topology_spread_constraints:
        spec["topologySpreadConstraints"] = [
            {k: v for k, v in (
                ("maxSkew", c.max_skew), ("topologyKey", c.topology_key),
                ("whenUnsatisfiable", c.when_unsatisfiable),
                ("labelSelector", label_selector_to(c.label_selector)),
                ("minDomains", c.min_domains)) if v is not None}
            for c in pod.spec.topology_spread_constraints]
    if pod.spec.priority:
        spec["priority"] = pod.spec.priority
    if pod.spec.priority_class_name:
        spec["priorityClassName"] = pod.spec.priority_class_name
    if pod.spec.preemption_policy != "PreemptLowerPriority":
        spec["preemptionPolicy"] = pod.spec.preemption_policy
    if pod.spec.scheduler_name != "default-scheduler":
        spec["schedulerName"] = pod.spec.scheduler_name
    if pod.spec.overhead:
        spec["overhead"] = {k: str(v) for k, v in pod.spec.overhead.items()}
    vols = [{"name": name, "persistentVolumeClaim": {"claimName": name}}
            for name in pod.spec.volumes]
    vols += [{"name": name, "ephemeral": {}} for name in pod.spec.ephemeral_claims]
    if vols:
        spec["volumes"] = vols
    if pod.spec.resource_claims:
        spec["resourceClaims"] = [
            {"name": rc.name,
             "source": ({"resourceClaimName": rc.claim_name} if rc.claim_name
                        else {"resourceClaimTemplateName": rc.template_name})}
            for rc in pod.spec.resource_claims]
    if pod.spec.service_account_name:
        spec["serviceAccountName"] = pod.spec.service_account_name
    for attr, key in (("host_network", "hostNetwork"), ("host_pid", "hostPID"),
                      ("host_ipc", "hostIPC")):
        if getattr(pod.spec, attr):
            spec[key] = True
    sc = _security_context_to(pod.spec.security_context)
    if sc:
        spec["securityContext"] = sc
    status: dict = {"phase": pod.status.phase}
    if pod.status.nominated_node_name:
        status["nominatedNodeName"] = pod.status.nominated_node_name
    return {"metadata": meta_to(pod.meta), "spec": spec, "status": status}


# --------------------------------------------------------------------- node


def node_from(doc: dict) -> t.Node:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    ready = True
    for cond in status.get("conditions") or ():
        if cond.get("type") == "Ready":
            ready = cond.get("status") == "True"
    return t.Node(
        meta=meta_from(doc.get("metadata") or {}),
        spec=t.NodeSpec(
            unschedulable=bool(spec.get("unschedulable", False)),
            taints=tuple(
                t.Taint(key=x.get("key", ""), value=x.get("value", ""),
                        effect=x.get("effect", t.TAINT_NO_SCHEDULE))
                for x in (spec.get("taints") or ())),
            pod_cidr=spec.get("podCIDR", ""),
        ),
        status=t.NodeStatus(
            capacity=dict(status.get("capacity") or {}),
            allocatable=dict(status.get("allocatable")
                             or status.get("capacity") or {}),
            images=tuple(
                t.ContainerImage(names=tuple(i.get("names") or ()),
                                 size_bytes=int(i.get("sizeBytes", 0)))
                for i in (status.get("images") or ())),
            ready=ready,
            device_attributes=dict(status.get("deviceAttributes") or {}),
        ),
    )


def node_to(node: t.Node) -> dict:
    spec: dict = {}
    if node.spec.unschedulable:
        spec["unschedulable"] = True
    if node.spec.taints:
        spec["taints"] = [
            {k: v for k, v in (("key", x.key), ("value", x.value),
                               ("effect", x.effect)) if v}
            for x in node.spec.taints]
    if node.spec.pod_cidr:
        spec["podCIDR"] = node.spec.pod_cidr
    status: dict = {
        "capacity": {k: str(v) for k, v in node.status.capacity.items()},
        "allocatable": {k: str(v) for k, v in node.status.allocatable.items()},
        "conditions": [{"type": "Ready",
                        "status": "True" if node.status.ready else "False"}],
    }
    if node.status.images:
        status["images"] = [{"names": list(i.names), "sizeBytes": i.size_bytes}
                            for i in node.status.images]
    if node.status.device_attributes:
        status["deviceAttributes"] = dict(node.status.device_attributes)
    return {"metadata": meta_to(node.meta), "spec": spec, "status": status}


# ------------------------------------------------------------- other kinds


def namespace_from(doc: dict) -> t.Namespace:
    return t.Namespace(meta=meta_from(doc.get("metadata") or {}))


def namespace_to(ns: t.Namespace) -> dict:
    return {"metadata": meta_to(ns.meta)}


def priority_class_from(doc: dict) -> t.PriorityClass:
    return t.PriorityClass(meta=meta_from(doc.get("metadata") or {}),
                           value=int(doc.get("value", 0)))


def priority_class_to(pc: t.PriorityClass) -> dict:
    return {"metadata": meta_to(pc.meta), "value": pc.value}


def pdb_from(doc: dict) -> t.PodDisruptionBudget:
    spec = doc.get("spec") or {}
    return t.PodDisruptionBudget(
        meta=meta_from(doc.get("metadata") or {}),
        selector=label_selector_from(spec.get("selector")),
        min_available=spec.get("minAvailable"),
        max_unavailable=spec.get("maxUnavailable"),
    )


def pdb_to(pdb: t.PodDisruptionBudget) -> dict:
    spec: dict = {}
    if pdb.selector is not None:
        spec["selector"] = label_selector_to(pdb.selector)
    if pdb.min_available is not None:
        spec["minAvailable"] = pdb.min_available
    if pdb.max_unavailable is not None:
        spec["maxUnavailable"] = pdb.max_unavailable
    return {"metadata": meta_to(pdb.meta), "spec": spec,
            "status": {"disruptionsAllowed": pdb.disruptions_allowed,
                       "currentHealthy": pdb.current_healthy,
                       "desiredHealthy": pdb.desired_healthy,
                       "expectedPods": pdb.expected_pods}}


def service_from(doc: dict) -> t.Service:
    spec = doc.get("spec") or {}
    def _int_port(v) -> int:
        # named (string) targetPorts are resolved against container ports in
        # the reference; this model is int-only — degrade to 0, don't crash
        try:
            return int(v or 0)
        except (TypeError, ValueError):
            return 0

    ports = tuple(
        t.ServicePort(
            name=p.get("name", ""), protocol=p.get("protocol", "TCP"),
            port=_int_port(p.get("port")),
            target_port=_int_port(p.get("targetPort", p.get("port", 0))),
            node_port=_int_port(p.get("nodePort")),
        )
        for p in spec.get("ports") or ()
    )
    affinity_cfg = ((spec.get("sessionAffinityConfig") or {}).get("clientIP")
                    or {})
    cluster_ip = spec.get("clusterIP", "")
    return t.Service(
        meta=meta_from(doc.get("metadata") or {}),
        selector=dict(spec.get("selector") or {}),
        external_ips=tuple(spec.get("externalIPs") or ()),
        type=spec.get("type", "ClusterIP"),
        headless=cluster_ip == "None",
        cluster_ip="" if cluster_ip == "None" else cluster_ip,
        ports=ports,
        session_affinity=spec.get("sessionAffinity", "None"),
        session_affinity_timeout_s=int(affinity_cfg.get("timeoutSeconds", 10800)),
    )


def service_to(svc: t.Service) -> dict:
    spec: dict = {}
    if svc.selector:
        spec["selector"] = dict(svc.selector)
    if svc.external_ips:
        spec["externalIPs"] = list(svc.external_ips)
    if svc.type != "ClusterIP":
        spec["type"] = svc.type
    if svc.headless:
        spec["clusterIP"] = "None"  # explicit headless marker round-trips
    elif svc.cluster_ip:
        spec["clusterIP"] = svc.cluster_ip
    if svc.ports:
        spec["ports"] = [
            {k: v for k, v in (
                ("name", p.name), ("protocol", p.protocol), ("port", p.port),
                ("targetPort", p.target_port), ("nodePort", p.node_port),
            ) if v not in ("", 0) or k == "port"}
            for p in svc.ports
        ]
    if svc.session_affinity != "None":
        spec["sessionAffinity"] = svc.session_affinity
        spec["sessionAffinityConfig"] = {
            "clientIP": {"timeoutSeconds": svc.session_affinity_timeout_s}}
    return {"metadata": meta_to(svc.meta), "spec": spec}


def storage_class_from(doc: dict) -> t.StorageClass:
    return t.StorageClass(
        meta=meta_from(doc.get("metadata") or {}),
        provisioner=doc.get("provisioner", ""),
        volume_binding_mode=doc.get("volumeBindingMode", t.BINDING_IMMEDIATE),
        allow_volume_expansion=bool(doc.get("allowVolumeExpansion", False)),
    )


def storage_class_to(sc: t.StorageClass) -> dict:
    out = {"metadata": meta_to(sc.meta), "provisioner": sc.provisioner,
           "volumeBindingMode": sc.volume_binding_mode}
    if sc.allow_volume_expansion:
        out["allowVolumeExpansion"] = True
    return out


def pvc_from(doc: dict) -> t.PersistentVolumeClaim:
    spec = doc.get("spec") or {}
    req = ((spec.get("resources") or {}).get("requests") or {}).get("storage", 0)
    from . import resource as resource_api

    return t.PersistentVolumeClaim(
        meta=meta_from(doc.get("metadata") or {}),
        storage_class=spec.get("storageClassName", ""),
        access_modes=tuple(spec.get("accessModes") or ()),
        requested_bytes=int(resource_api.parse_quantity(req)) if req else 0,
    )


def pvc_to(pvc: t.PersistentVolumeClaim) -> dict:
    spec: dict = {}
    if pvc.storage_class:
        spec["storageClassName"] = pvc.storage_class
    if pvc.access_modes:
        spec["accessModes"] = list(pvc.access_modes)
    if pvc.requested_bytes:
        spec["resources"] = {"requests": {"storage": str(pvc.requested_bytes)}}
    out = {"metadata": meta_to(pvc.meta), "spec": spec}
    if pvc.bound_pv:
        out["spec"]["volumeName"] = pvc.bound_pv
    return out


def _pod_template_from(tpl: Optional[dict], namespace: str) -> Optional[t.Pod]:
    if not tpl:
        return None
    doc = {"metadata": dict(tpl.get("metadata") or {}), "spec": tpl.get("spec") or {}}
    doc["metadata"].setdefault("name", "template")
    doc["metadata"].setdefault("namespace", namespace)
    return pod_from(doc)


def _pod_template_to(tpl: Optional[t.Pod]) -> Optional[dict]:
    if tpl is None:
        return None
    d = pod_to(tpl)
    return {"metadata": {k: v for k, v in d["metadata"].items()
                         if k in ("labels", "annotations")},
            "spec": d["spec"]}


def _int_or_percent(v, total: int, default: int, round_up: bool) -> int:
    """metav1 IntOrString resolution (intstr.GetScaledValueFromIntOrPercent):
    "25%" scales against ``total`` (surge rounds up, unavailable down)."""
    if v is None:
        return default
    if isinstance(v, str) and v.endswith("%"):
        import math

        frac = int(v[:-1]) * total / 100.0
        return math.ceil(frac) if round_up else math.floor(frac)
    return int(v)


def deployment_from(doc: dict) -> t.Deployment:
    spec = doc.get("spec") or {}
    strategy = spec.get("strategy") or {}
    rolling = strategy.get("rollingUpdate") or {}
    meta = meta_from(doc.get("metadata") or {})
    r = spec.get("replicas")
    replicas = 1 if r is None else int(r)  # explicit 0 = scale-to-zero
    return t.Deployment(
        meta=meta,
        selector=label_selector_from(spec.get("selector")),
        replicas=replicas,
        template=_pod_template_from(spec.get("template"), meta.namespace),
        strategy=strategy.get("type", "RollingUpdate"),
        max_surge=_int_or_percent(rolling.get("maxSurge"), replicas, 1, True),
        max_unavailable=_int_or_percent(rolling.get("maxUnavailable"),
                                        replicas, 1, False),
    )


def deployment_to(d: t.Deployment) -> dict:
    spec: dict = {"replicas": d.replicas}
    if d.selector is not None:
        spec["selector"] = label_selector_to(d.selector)
    tpl = _pod_template_to(d.template)
    if tpl:
        spec["template"] = tpl
    spec["strategy"] = {"type": d.strategy}
    if d.strategy == "RollingUpdate":
        spec["strategy"]["rollingUpdate"] = {"maxSurge": d.max_surge,
                                             "maxUnavailable": d.max_unavailable}
    return {"metadata": meta_to(d.meta), "spec": spec}


def job_from(doc: dict) -> t.Job:
    spec = doc.get("spec") or {}
    meta = meta_from(doc.get("metadata") or {})
    return t.Job(
        meta=meta,
        completions=int(spec.get("completions", 1)),
        parallelism=int(spec.get("parallelism", 1)),
        template=_pod_template_from(spec.get("template"), meta.namespace),
        backoff_limit=int(spec.get("backoffLimit", 6)),
        active_deadline_seconds=spec.get("activeDeadlineSeconds"),
        ttl_seconds_after_finished=spec.get("ttlSecondsAfterFinished"),
    )


def job_to(j: t.Job) -> dict:
    spec: dict = {"completions": j.completions, "parallelism": j.parallelism,
                  "backoffLimit": j.backoff_limit}
    if j.active_deadline_seconds is not None:
        spec["activeDeadlineSeconds"] = j.active_deadline_seconds
    if j.ttl_seconds_after_finished is not None:
        spec["ttlSecondsAfterFinished"] = j.ttl_seconds_after_finished
    tpl = _pod_template_to(j.template)
    if tpl:
        spec["template"] = tpl
    status = {"succeeded": j.succeeded, "failed": j.failed}
    if j.condition:
        status["conditions"] = [{"type": j.condition, "status": "True",
                                 "reason": j.failed_reason}]
    return {"metadata": meta_to(j.meta), "spec": spec, "status": status}


def hpa_from(doc: dict) -> t.HorizontalPodAutoscaler:
    spec = doc.get("spec") or {}
    ref = spec.get("scaleTargetRef") or {}
    target_util = 80
    for m in spec.get("metrics") or ():
        res = m.get("resource") or {}
        if res.get("name") == "cpu":
            target_util = int((res.get("target") or {}).get("averageUtilization", 80))
    return t.HorizontalPodAutoscaler(
        meta=meta_from(doc.get("metadata") or {}),
        target_kind=ref.get("kind", "Deployment"),
        target_name=ref.get("name", ""),
        min_replicas=int(spec.get("minReplicas", 1)),
        max_replicas=int(spec.get("maxReplicas", 10)),
        target_cpu_utilization=target_util,
    )


def hpa_to(h: t.HorizontalPodAutoscaler) -> dict:
    return {"metadata": meta_to(h.meta),
            "spec": {"scaleTargetRef": {"kind": h.target_kind, "name": h.target_name},
                     "minReplicas": h.min_replicas, "maxReplicas": h.max_replicas,
                     "metrics": [{"type": "Resource", "resource": {
                         "name": "cpu", "target": {
                             "type": "Utilization",
                             "averageUtilization": h.target_cpu_utilization}}}]},
            "status": {"currentReplicas": h.current_replicas,
                       "desiredReplicas": h.desired_replicas}}


# ----------------------------------------------------------------- register


def _default_pod(pod: t.Pod) -> None:
    """core/v1 pod defaulting (defaults.go): container resource limits
    default requests; toleration operator; protocol handled at decode."""
    for c in list(pod.spec.containers) + list(pod.spec.init_containers):
        for r, q in c.limits.items():
            c.requests.setdefault(r, q)


def api_service_from(doc: dict) -> t.APIService:
    spec = doc.get("spec") or {}
    svc_ref = spec.get("service") or {}
    endpoint = doc.get("service_endpoint", "")
    if not endpoint and svc_ref:
        # apiregistration's ServiceReference (ns/name/port) reduced to a
        # host:port the plain-HTTP proxy can dial
        endpoint = f"{svc_ref.get('name', '')}:{svc_ref.get('port', 443)}"
    return t.APIService(
        meta=meta_from(doc.get("metadata") or {}),
        group=spec.get("group", doc.get("group", "")),
        version=spec.get("version", doc.get("version", "v1")),
        service_endpoint=endpoint,
        insecure_skip_tls_verify=bool(
            spec.get("insecureSkipTLSVerify",
                     doc.get("insecure_skip_tls_verify", True))),
        group_priority_minimum=int(
            spec.get("groupPriorityMinimum",
                     doc.get("group_priority_minimum", 1000))),
        version_priority=int(
            spec.get("versionPriority", doc.get("version_priority", 15))),
    )


def api_service_to(svc: t.APIService) -> dict:
    return {"metadata": meta_to(svc.meta),
            "spec": {"group": svc.group, "version": svc.version,
                     "insecureSkipTLSVerify": svc.insecure_skip_tls_verify,
                     "groupPriorityMinimum": svc.group_priority_minimum,
                     "versionPriority": svc.version_priority},
            "service_endpoint": svc.service_endpoint}


# ------------------------------------------------- resource.k8s.io/v1alpha2


def resource_class_from(doc: dict) -> t.ResourceClass:
    return t.ResourceClass(
        meta=meta_from(doc.get("metadata") or {}),
        driver_name=doc.get("driverName", ""),
        selectors=dict(doc.get("selectors") or {}))


def resource_class_to(rc: t.ResourceClass) -> dict:
    out: dict = {"metadata": meta_to(rc.meta)}
    if rc.driver_name:
        out["driverName"] = rc.driver_name
    if rc.selectors:
        out["selectors"] = dict(rc.selectors)
    return out


def resource_claim_from(doc: dict) -> t.ResourceClaim:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return t.ResourceClaim(
        meta=meta_from(doc.get("metadata") or {}),
        resource_class_name=spec.get("resourceClassName", ""),
        selectors=dict(spec.get("selectors") or {}),
        allocated_node=(status.get("allocation") or {}).get("nodeName", ""),
        reserved_for=tuple(status.get("reservedFor") or ()))


def resource_claim_to(claim: t.ResourceClaim) -> dict:
    spec: dict = {}
    if claim.resource_class_name:
        spec["resourceClassName"] = claim.resource_class_name
    if claim.selectors:
        spec["selectors"] = dict(claim.selectors)
    status: dict = {}
    if claim.allocated_node:
        status["allocation"] = {"nodeName": claim.allocated_node}
    if claim.reserved_for:
        status["reservedFor"] = list(claim.reserved_for)
    out: dict = {"metadata": meta_to(claim.meta), "spec": spec}
    if status:
        out["status"] = status
    return out


def resource_claim_template_from(doc: dict) -> t.ResourceClaimTemplate:
    spec = doc.get("spec") or {}
    return t.ResourceClaimTemplate(
        meta=meta_from(doc.get("metadata") or {}),
        resource_class_name=spec.get("resourceClassName", ""),
        selectors=dict(spec.get("selectors") or {}))


def resource_claim_template_to(tmpl: t.ResourceClaimTemplate) -> dict:
    spec: dict = {}
    if tmpl.resource_class_name:
        spec["resourceClassName"] = tmpl.resource_class_name
    if tmpl.selectors:
        spec["selectors"] = dict(tmpl.selectors)
    return {"metadata": meta_to(tmpl.meta), "spec": spec}


def pod_scheduling_context_from(doc: dict) -> t.PodSchedulingContext:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return t.PodSchedulingContext(
        meta=meta_from(doc.get("metadata") or {}),
        selected_node=spec.get("selectedNode", status.get("selectedNode", "")),
        potential_nodes=tuple(spec.get("potentialNodes") or ()))


def pod_scheduling_context_to(ctx: t.PodSchedulingContext) -> dict:
    spec: dict = {}
    if ctx.selected_node:
        spec["selectedNode"] = ctx.selected_node
    if ctx.potential_nodes:
        spec["potentialNodes"] = list(ctx.potential_nodes)
    return {"metadata": meta_to(ctx.meta), "spec": spec}


# ------------------------------------------- scheduling.x-k8s.io/v1alpha1


def pod_group_from(doc: dict) -> t.PodGroup:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return t.PodGroup(
        meta=meta_from(doc.get("metadata") or {}),
        min_member=int(spec.get("minMember", 1)),
        schedule_timeout_seconds=int(spec.get("scheduleTimeoutSeconds", 0)),
        phase=status.get("phase", t.POD_GROUP_PENDING),
        scheduled=int(status.get("scheduled", 0)))


def pod_group_to(pg: t.PodGroup) -> dict:
    spec: dict = {"minMember": pg.min_member}
    if pg.schedule_timeout_seconds:
        spec["scheduleTimeoutSeconds"] = pg.schedule_timeout_seconds
    status: dict = {}
    if pg.phase and pg.phase != t.POD_GROUP_PENDING:
        status["phase"] = pg.phase
    if pg.scheduled:
        status["scheduled"] = pg.scheduled
    out: dict = {"metadata": meta_to(pg.meta), "spec": spec}
    if status:
        out["status"] = status
    return out


def scheduling_quota_from(doc: dict) -> t.SchedulingQuota:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    return t.SchedulingQuota(
        meta=meta_from(doc.get("metadata") or {}),
        hard={k: int(v) for k, v in (spec.get("hard") or {}).items()},
        weight=int(spec.get("weight", 1)),
        cohort=str(spec.get("cohort", "") or ""),
        used={k: int(v) for k, v in (status.get("used") or {}).items()})


def scheduling_quota_to(sq: t.SchedulingQuota) -> dict:
    spec: dict = {"weight": sq.weight}
    if sq.hard:
        spec["hard"] = dict(sq.hard)
    if sq.cohort:
        spec["cohort"] = sq.cohort
    out: dict = {"metadata": meta_to(sq.meta), "spec": spec}
    if sq.used:
        out["status"] = {"used": dict(sq.used)}
    return out


def register(scheme: Scheme) -> None:
    """Register every modeled external version (AddToScheme analog)."""
    core = [
        ("Pod", t.Pod, pod_from, pod_to),
        ("Node", t.Node, node_from, node_to),
        ("Namespace", t.Namespace, namespace_from, namespace_to),
        ("Service", t.Service, service_from, service_to),
        ("PersistentVolumeClaim", t.PersistentVolumeClaim, pvc_from, pvc_to),
    ]
    for kind, typ, dec, enc in core:
        scheme.add_known_type(GroupVersionKind("", "v1", kind), typ, dec, enc)
    scheme.add_known_type(
        GroupVersionKind("scheduling.k8s.io", "v1", "PriorityClass"),
        t.PriorityClass, priority_class_from, priority_class_to)
    scheme.add_known_type(
        GroupVersionKind("policy", "v1", "PodDisruptionBudget"),
        t.PodDisruptionBudget, pdb_from, pdb_to)
    scheme.add_known_type(
        GroupVersionKind("storage.k8s.io", "v1", "StorageClass"),
        t.StorageClass, storage_class_from, storage_class_to)
    scheme.add_known_type(
        GroupVersionKind("apps", "v1", "Deployment"),
        t.Deployment, deployment_from, deployment_to)
    scheme.add_known_type(
        GroupVersionKind("batch", "v1", "Job"), t.Job, job_from, job_to)
    scheme.add_known_type(
        GroupVersionKind("autoscaling", "v2", "HorizontalPodAutoscaler"),
        t.HorizontalPodAutoscaler, hpa_from, hpa_to)
    scheme.add_known_type(
        GroupVersionKind("apiregistration.k8s.io", "v1", "APIService"),
        t.APIService, api_service_from, api_service_to)
    for kind, typ, dec, enc in (
        ("ResourceClass", t.ResourceClass,
         resource_class_from, resource_class_to),
        ("ResourceClaim", t.ResourceClaim,
         resource_claim_from, resource_claim_to),
        ("ResourceClaimTemplate", t.ResourceClaimTemplate,
         resource_claim_template_from, resource_claim_template_to),
        ("PodSchedulingContext", t.PodSchedulingContext,
         pod_scheduling_context_from, pod_scheduling_context_to),
    ):
        scheme.add_known_type(
            GroupVersionKind("resource.k8s.io", "v1alpha2", kind),
            typ, dec, enc)
    scheme.add_known_type(
        GroupVersionKind("scheduling.x-k8s.io", "v1alpha1", "PodGroup"),
        t.PodGroup, pod_group_from, pod_group_to)
    scheme.add_known_type(
        GroupVersionKind("scheduling.x-k8s.io", "v1alpha1", "SchedulingQuota"),
        t.SchedulingQuota, scheduling_quota_from, scheduling_quota_to)
    scheme.add_defaulter(t.Pod, _default_pod)
