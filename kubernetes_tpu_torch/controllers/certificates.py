"""Certificate / security control loops of NewControllerInitializers
(cmd/kube-controller-manager/app/controllermanager.go:412); an own copy of
``kubernetes_tpu/controllers/certificates.py``:

  * csrapproving — pkg/controller/certificates/approver: auto-approve
    kubelet client CSRs whose attributes match the node-bootstrap policy.
  * csrsigning — pkg/controller/certificates/signer: issue a certificate
    for approved CSRs of the known signer names. (The x509 bytes are
    environment; the control flow — approved → certificate populated,
    denied → never signed — is the parity surface.)
  * csrcleaner — pkg/controller/certificates/cleaner: drop stale pending
    (1h), denied (1h) and long-issued (24h) CSRs.
  * clusterrole-aggregation — pkg/controller/clusterroleaggregation: a
    ClusterRole with an aggregationRule gets its rules overwritten with
    the union of every label-matching ClusterRole's rules.
  * tokencleaner — pkg/controller/bootstrap: delete expired bootstrap
    token secrets (type bootstrap.kubernetes.io/token) in kube-system.
  * bootstrapsigner — sign the cluster-info ConfigMap with each bootstrap
    token (JWS in the reference; a keyed digest here).
  * persistentvolume-expander — pkg/controller/volume/expand: grow a PV to
    its bound PVC's requested size when the StorageClass allows expansion.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import List, Optional

from ..api.types import SECRET_TYPE_BOOTSTRAP_TOKEN, CertificateSigningRequest
from .base import Controller

KUBELET_CLIENT_SIGNER = "kubernetes.io/kube-apiserver-client-kubelet"
KUBELET_SERVING_SIGNER = "kubernetes.io/kubelet-serving"
KNOWN_SIGNERS = {KUBELET_CLIENT_SIGNER, KUBELET_SERVING_SIGNER,
                 "kubernetes.io/kube-apiserver-client"}

PENDING_TTL = 3600.0      # cleaner.go pendingExpiration (reduced from 24h)
DENIED_TTL = 3600.0       # deniedExpiration
ISSUED_TTL = 86400.0      # approvedExpiration


class CSRApprovingController(Controller):
    """certificates/approver/sarapprove.go: auto-approve node-bootstrap
    client CSRs — requestor in system:nodes (or the bootstrappers group)
    asking for client auth under the kubelet client signer."""

    name = "csrapproving"
    watch_kinds = ("CertificateSigningRequest",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.name]  # CSRs are cluster-scoped: bare-name keys

    def reconcile(self, key: str) -> None:
        csr: Optional[CertificateSigningRequest] = self.store.csrs.get(key)
        if csr is None or csr.approved or csr.denied:
            return
        if csr.signer_name != KUBELET_CLIENT_SIGNER:
            return  # only the node-bootstrap flow is auto-approved
        is_node = (csr.username.startswith("system:node:")
                   or "system:bootstrappers" in csr.groups
                   or "system:nodes" in csr.groups)
        if not is_node or "client auth" not in csr.usages:
            return
        new = dataclasses.replace(
            csr, approved=True,
            approval_reason="AutoApproved kubelet client certificate")
        new.meta = dataclasses.replace(csr.meta)
        self.store.update_object("CertificateSigningRequest", new)


class CSRSigningController(Controller):
    """certificates/signer/signer.go: issue certificates for approved CSRs
    of known signers; denied or unknown-signer CSRs are never signed."""

    name = "csrsigning"
    watch_kinds = ("CertificateSigningRequest",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.name]  # CSRs are cluster-scoped: bare-name keys

    def __init__(self, store, factory, now_fn=time.time):
        super().__init__(store, factory)
        self.now_fn = now_fn

    def reconcile(self, key: str) -> None:
        csr: Optional[CertificateSigningRequest] = self.store.csrs.get(key)
        if csr is None or not csr.approved or csr.denied or csr.certificate:
            return
        if csr.signer_name not in KNOWN_SIGNERS:
            return
        blob = hashlib.sha256(
            f"{csr.signer_name}|{csr.username}|{csr.request}".encode()
        ).hexdigest()
        cert = (f"-----BEGIN CERTIFICATE-----\n{blob}\n"
                f"-----END CERTIFICATE-----\n")
        new = dataclasses.replace(csr, certificate=cert,
                                  issued_at=self.now_fn())
        new.meta = dataclasses.replace(csr.meta)
        self.store.update_object("CertificateSigningRequest", new)


class CSRCleanerController(Controller):
    """certificates/cleaner/cleaner.go: garbage-collect CSRs — pending too
    long, denied a while ago, or issued long ago (their cert is in use;
    the request object is just clutter)."""

    name = "csrcleaner"
    watch_kinds = ("CertificateSigningRequest",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [obj.meta.name]  # CSRs are cluster-scoped: bare-name keys

    def __init__(self, store, factory, now_fn=time.time):
        super().__init__(store, factory)
        self.now_fn = now_fn

    def tick(self) -> None:
        for key in list(self.store.csrs):
            self.queue.add(key)
        self.sync_once()

    def reconcile(self, key: str) -> None:
        csr: Optional[CertificateSigningRequest] = self.store.csrs.get(key)
        if csr is None:
            return
        now = self.now_fn()
        created = csr.meta.creation_timestamp or 0.0
        stale = (
            (csr.certificate and csr.issued_at
             and now - csr.issued_at > ISSUED_TTL)
            or (csr.denied and now - created > DENIED_TTL)
            or (not csr.approved and not csr.denied
                and now - created > PENDING_TTL)
        )
        if stale:
            self.store.delete_object("CertificateSigningRequest", key)


class ClusterRoleAggregationController(Controller):
    """clusterroleaggregation_controller.go: rules of an aggregated role =
    union of every ClusterRole matching any of its label selectors."""

    name = "clusterrole-aggregation"
    watch_kinds = ("ClusterRole",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        # any role change may feed any aggregated role: re-reconcile all
        # roles that carry an aggregation rule
        return [name for name, r in self.store.cluster_roles.items()
                if getattr(r, "aggregation_selectors", ())]

    def reconcile(self, key: str) -> None:
        role = self.store.cluster_roles.get(key)
        if role is None or not getattr(role, "aggregation_selectors", ()):
            return
        rules = []
        seen = set()
        for name, r in sorted(self.store.cluster_roles.items()):
            if name == key:
                continue
            labels = r.meta.labels or {}
            if not any(all(labels.get(k) == v for k, v in sel.items())
                       for sel in role.aggregation_selectors):
                continue
            for rule in r.rules:
                sig = (rule.verbs, rule.resources, rule.resource_names,
                       rule.subresources)
                if sig not in seen:
                    seen.add(sig)
                    rules.append(rule)
        if tuple(rules) == tuple(role.rules):
            return
        new = dataclasses.replace(role, rules=tuple(rules))
        new.meta = dataclasses.replace(role.meta)
        self.store.update_object("ClusterRole", new)


BOOTSTRAP_TOKEN_NS = "kube-system"
CLUSTER_INFO_KEY = f"{BOOTSTRAP_TOKEN_NS}/cluster-info"


class TokenCleanerController(Controller):
    """bootstrap/tokencleaner.go: delete expired bootstrap token secrets."""

    name = "tokencleaner"
    watch_kinds = ("Secret",)

    def __init__(self, store, factory, now_fn=time.time):
        super().__init__(store, factory)
        self.now_fn = now_fn

    def tick(self) -> None:
        for key, s in list(self.store.secrets.items()):
            if getattr(s, "type", "") == SECRET_TYPE_BOOTSTRAP_TOKEN:
                self.queue.add(key)
        self.sync_once()

    def reconcile(self, key: str) -> None:
        s = self.store.secrets.get(key)
        if s is None or getattr(s, "type", "") != SECRET_TYPE_BOOTSTRAP_TOKEN:
            return
        expiry = s.data.get("expiration", "")
        try:
            if expiry and float(expiry) < self.now_fn():
                self.store.delete_object("Secret", key)
        except ValueError:
            pass  # unparseable expiration: leave it (the reference logs)


class BootstrapSignerController(Controller):
    """bootstrap/bootstrapsigner.go: keep a signature of the cluster-info
    ConfigMap per bootstrap token (JWS in the reference; a token-keyed
    digest here) so joining nodes can verify it with only the token."""

    name = "bootstrapsigner"
    watch_kinds = ("Secret", "ConfigMap")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [CLUSTER_INFO_KEY]

    def reconcile(self, key: str) -> None:
        if key != CLUSTER_INFO_KEY:
            return
        cm = self.store.config_maps.get(CLUSTER_INFO_KEY)
        if cm is None:
            return
        payload = cm.data.get("kubeconfig", "")
        want = {}
        for s in self.store.secrets.values():
            if getattr(s, "type", "") != SECRET_TYPE_BOOTSTRAP_TOKEN:
                continue
            token_id = s.data.get("token-id", "")
            token_secret = s.data.get("token-secret", "")
            if not token_id or not token_secret:
                continue
            sig = hashlib.sha256(f"{token_secret}|{payload}".encode()).hexdigest()
            want[f"jws-kubeconfig-{token_id}"] = sig
        have = {k: v for k, v in cm.data.items() if k.startswith("jws-kubeconfig-")}
        if have == want:
            return
        data = {k: v for k, v in cm.data.items()
                if not k.startswith("jws-kubeconfig-")}
        data.update(want)
        new = dataclasses.replace(cm, data=data)
        new.meta = dataclasses.replace(cm.meta)
        self.store.update_object("ConfigMap", new)


class PVExpanderController(Controller):
    """volume/expand/expand_controller.go: when a bound PVC requests more
    than its PV provides and the StorageClass allows expansion, grow the
    PV (the cloud-volume resize is environment; the API surface is the
    capacity update)."""

    name = "persistentvolume-expander"
    watch_kinds = ("PersistentVolumeClaim",)

    def reconcile(self, key: str) -> None:
        pvc = self.store.pvcs.get(key)
        if pvc is None or not pvc.bound_pv:
            return
        pv = self.store.pvs.get(pvc.bound_pv)
        if pv is None or pvc.requested_bytes <= pv.capacity_bytes:
            return
        sc = self.store.storage_classes.get(pvc.storage_class or pv.storage_class)
        if sc is None or not sc.allow_volume_expansion:
            return
        new = dataclasses.replace(pv, capacity_bytes=pvc.requested_bytes)
        new.meta = dataclasses.replace(pv.meta)
        self.store.update_object("PersistentVolume", new)
