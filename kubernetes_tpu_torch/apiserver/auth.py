"""Authn / authz / flow-control middleware for the HTTP apiserver front (an
own copy of ``kubernetes_tpu/apiserver/auth.py``): the reference's
DefaultBuildHandlerChain stages (apiserver pkg/server/config.go:806:
authentication → authorization, flowcontrol APF in pkg/util/flowcontrol),
reduced to the shapes this framework needs:

- Authenticator: bearer-token map + authenticating-proxy headers
  (X-Remote-User / X-Remote-Group) + optional anonymous.
- RBACAuthorizer: ClusterRole/ClusterRoleBinding objects from the store
  (data-driven, like rbac.authorization.k8s.io), with system:masters bypass.
  Also satisfies the ``store.authorizer`` seam used by admission
  (OwnerReferencesPermissionEnforcement).
- FlowController: API Priority & Fairness analog — priority levels with
  concurrency limits and bounded queues; a full queue rejects (HTTP 429),
  matching APF's reject-when-queue-full behavior.

The RBAC objects (``PolicyRule``, ``ClusterRole``, ``ClusterRoleBinding``)
are the port's ``api/types.py`` dataclasses, re-exported here under the JAX
module's names.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..api.types import ClusterRole, ClusterRoleBinding, PolicyRule

__all__ = ["ANONYMOUS", "GROUP_UNAUTHENTICATED", "GROUP_AUTHENTICATED", "GROUP_MASTERS",
           "UserInfo", "AuthenticationError", "Authenticator", "PolicyRule", "ClusterRole",
           "ClusterRoleBinding", "RBACAuthorizer", "NodeAuthorizer", "PriorityLevel",
           "FlowSchema", "default_flow_config", "FlowController", "AuthConfig"]

ANONYMOUS = "system:anonymous"
GROUP_UNAUTHENTICATED = "system:unauthenticated"
GROUP_AUTHENTICATED = "system:authenticated"
GROUP_MASTERS = "system:masters"


@dataclasses.dataclass(frozen=True)
class UserInfo:
    name: str
    groups: Tuple[str, ...] = ()


class AuthenticationError(Exception):
    """401: credentials presented and rejected."""


class Authenticator:
    """Union authenticator (apiserver pkg/authentication): bearer tokens,
    authenticating-proxy headers, then anonymous."""

    def __init__(self, tokens: Optional[Dict[str, UserInfo]] = None,
                 allow_anonymous: bool = True,
                 trust_proxy_headers: Optional[bool] = None):
        self.tokens = tokens or {}
        self.allow_anonymous = allow_anonymous
        # X-Remote-* headers assert an identity the server cannot verify —
        # the reference only trusts them from a cert-verified front proxy.
        # Default: trust them ONLY when no token auth is configured (the
        # trusted-sidecar topology); with tokens present, an explicit opt-in
        # is required, else any client could spoof system:masters.
        if trust_proxy_headers is None:
            trust_proxy_headers = not self.tokens
        self.trust_proxy_headers = trust_proxy_headers

    def authenticate(self, headers) -> UserInfo:
        authz = headers.get("Authorization", "")
        if authz.startswith("Bearer "):
            token = authz[len("Bearer "):].strip()
            user = self.tokens.get(token)
            if user is None:
                raise AuthenticationError("invalid bearer token")
            return UserInfo(user.name, tuple(user.groups) + (GROUP_AUTHENTICATED,))
        if self.trust_proxy_headers:
            name = headers.get("X-Remote-User", "")
            if name:
                groups = tuple(
                    g.strip() for g in headers.get("X-Remote-Group", "").split(",")
                    if g.strip())
                return UserInfo(name, groups + (GROUP_AUTHENTICATED,))
        if self.allow_anonymous:
            return UserInfo(ANONYMOUS, (GROUP_UNAUTHENTICATED,))
        raise AuthenticationError("no credentials")


# --------------------------------------------------------------------- RBAC

class RBACAuthorizer:
    """Data-driven RBAC over the store's ClusterRole/ClusterRoleBinding maps
    (plugin/pkg/auth/authorizer/rbac). system:masters always passes."""

    def __init__(self, store):
        self.store = store

    def _user_matches(self, subject: str, user: str, groups: Tuple[str, ...]) -> bool:
        if subject.startswith("user:"):
            return subject[5:] == user
        if subject.startswith("group:"):
            return subject[6:] in groups
        return subject == user  # bare subject = user name

    def allowed_for(self, user: str, groups: Tuple[str, ...], verb: str,
                    kind: str, name: str = "", subresource: str = "") -> bool:
        if GROUP_MASTERS in groups:
            return True
        for b in self.store.cluster_role_bindings.values():
            if not any(self._user_matches(s, user, groups) for s in b.subjects):
                continue
            role = self.store.cluster_roles.get(b.role)
            if role is None:
                continue
            for rule in role.rules:
                if rule.matches(verb, kind, name, subresource):
                    return True
        return False

    def allowed(self, user: str, verb: str, kind: str, name: str = "",
                subresource: str = "") -> bool:
        """store.authorizer seam (admission's blockOwnerDeletion check)."""
        return self.allowed_for(user, (), verb, kind, name, subresource)


class NodeAuthorizer:
    """Graph-based node authorizer (plugin/pkg/auth/authorizer/node
    node_authorizer.go): a kubelet identity (``system:node:<name>``) may
    read a Secret/ConfigMap/PVC only when some pod BOUND TO THAT NODE
    references it, and may touch its own Node/Lease and pods bound to
    itself. Non-node users delegate to the wrapped authorizer (RBAC)."""

    _GRAPH_KINDS = {"Secret", "ConfigMap", "PersistentVolumeClaim"}
    _READ_VERBS = {"get", "list", "watch"}

    def __init__(self, store, delegate=None):
        self.store = store
        self.delegate = delegate

    @staticmethod
    def _node_of(user: str):
        return user[len("system:node:"):] if user.startswith("system:node:") else None

    # kinds a kubelet may READ freely (the informer surfaces a node agent
    # list/watches); everything else is default-deny for node identities
    _OPEN_READ_KINDS = {"Node", "Pod", "Service", "Endpoints", "EndpointSlice",
                        "Namespace", "Lease", "StorageClass", "CSINode",
                        "PersistentVolume", "RuntimeClass"}

    def _referenced_on_node(self, kind: str, name: str, node: str) -> bool:
        # name must be the fully-qualified store key ("ns/name"): a bare
        # name would let a node read the same-named object in ANY namespace
        if "/" not in name:
            return False
        with self.store._lock:  # threaded API server: pods map is shared
            pods = list(self.store.pods.values())
        for pod in pods:
            if pod.spec.node_name != node:
                continue
            ns = pod.meta.namespace
            if kind == "Secret":
                refs = pod.spec.secret_volumes
            elif kind == "ConfigMap":
                refs = pod.spec.config_map_volumes
            else:  # PersistentVolumeClaim
                refs = pod.spec.volumes
            if any(f"{ns}/{r}" == name for r in refs):
                return True
        return False

    def allowed_for(self, user: str, groups: Tuple[str, ...], verb: str,
                    kind: str, name: str = "", subresource: str = "") -> bool:
        node = self._node_of(user)
        if node is None:
            return (self.delegate.allowed_for(user, groups, verb, kind, name,
                                              subresource)
                    if self.delegate is not None else False)
        if kind in self._GRAPH_KINDS:
            return (verb in self._READ_VERBS
                    and bool(name) and self._referenced_on_node(kind, name, node))
        if kind in ("Node", "Lease"):
            # own object only for writes; reads are unrestricted (kubelets
            # watch the node corpus for their own object updates). Lease
            # names arrive namespace-qualified ("kube-node-lease/<node>")
            # from the HTTP gate — compare the bare object name.
            if verb in self._READ_VERBS:
                return True
            return name.rsplit("/", 1)[-1] in ("", node)
        if kind == "Pod":
            if verb in self._READ_VERBS:
                return True
            # writes only against pods already bound to this node (status
            # updates, deletes on eviction) — enforced here as well as by
            # NodeRestriction admission, since the two are configured
            # independently (node_authorizer.go does the same)
            pod = self.store.pods.get(name)
            return pod is not None and pod.spec.node_name == node
        if kind == "Event":
            return verb == "create"
        if verb in self._READ_VERBS and kind in self._OPEN_READ_KINDS:
            return True
        # default-deny: a kubelet identity gets nothing else (in particular
        # no RBAC/webhook/workload writes — node_authorizer.go fails closed)
        return False

    def allowed(self, user: str, verb: str, kind: str, name: str = "",
                subresource: str = "") -> bool:
        return self.allowed_for(user, (), verb, kind, name, subresource)


# ---------------------------------------------------------------------- APF

@dataclasses.dataclass
class PriorityLevel:
    """flowcontrol/v1beta2 PriorityLevelConfiguration, reduced: concurrency
    shares become an absolute in-flight limit; a full queue rejects."""

    name: str
    concurrency: int = 4
    queue_length: int = 16
    exempt: bool = False


@dataclasses.dataclass
class FlowSchema:
    """Maps (user, groups, verb) to a priority level, first match wins
    (flowcontrol FlowSchema matchingPrecedence order)."""

    name: str
    level: str
    users: Tuple[str, ...] = ()      # () = any
    groups: Tuple[str, ...] = ()
    verbs: Tuple[str, ...] = ()

    def matches(self, user: str, groups: Tuple[str, ...], verb: str) -> bool:
        if self.users and user not in self.users:
            return False
        if self.groups and not (set(self.groups) & set(groups)):
            return False
        if self.verbs and verb not in self.verbs:
            return False
        return True


def default_flow_config() -> Tuple[List[PriorityLevel], List[FlowSchema]]:
    """The reference's suggested configuration, reduced
    (apf bootstrap configuration: exempt, system, workload-high,
    global-default, catch-all)."""
    levels = [
        PriorityLevel("exempt", exempt=True),
        PriorityLevel("system", concurrency=16, queue_length=64),
        PriorityLevel("workload-high", concurrency=8, queue_length=32),
        PriorityLevel("global-default", concurrency=4, queue_length=16),
        PriorityLevel("catch-all", concurrency=2, queue_length=0),
    ]
    schemas = [
        FlowSchema("exempt", "exempt", groups=(GROUP_MASTERS,)),
        FlowSchema("system-nodes", "system", groups=("system:nodes",)),
        FlowSchema("system-components", "system",
                   users=("system:kube-scheduler", "system:kube-controller-manager")),
        FlowSchema("watches", "exempt", verbs=("watch",)),  # long-lived streams
        FlowSchema("global-default", "global-default",
                   groups=(GROUP_AUTHENTICATED,)),
        FlowSchema("catch-all", "catch-all"),
    ]
    return levels, schemas


class FlowController:
    """In-flight concurrency control per priority level. ``dispatch`` returns
    a release callable, or None when the level's queue is full (→ 429).
    Waiting requests block up to ``wait_timeout`` for a slot (the queueing
    behavior APF models with fair queuing, collapsed to FIFO)."""

    def __init__(self, levels: Optional[List[PriorityLevel]] = None,
                 schemas: Optional[List[FlowSchema]] = None,
                 wait_timeout: float = 5.0):
        if levels is None or schemas is None:
            levels, schemas = default_flow_config()
        self.levels = {l.name: l for l in levels}
        self.schemas = schemas
        self.wait_timeout = wait_timeout
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._in_flight: Dict[str, int] = {l: 0 for l in self.levels}
        self._queued: Dict[str, int] = {l: 0 for l in self.levels}
        self.rejected_total: Dict[str, int] = {l: 0 for l in self.levels}
        self.dispatched_total: Dict[str, int] = {l: 0 for l in self.levels}

    def classify(self, user: str, groups: Tuple[str, ...], verb: str) -> str:
        for s in self.schemas:
            if s.matches(user, groups, verb) and s.level in self.levels:
                return s.level
        # unmatched traffic takes the LAST non-exempt (lowest-priority,
        # catch-all) level — never fail open into an exempt level, even
        # with a custom level list whose last entry happens to be exempt
        for name in reversed(self.levels):
            if not self.levels[name].exempt:
                return name
        return next(iter(self.levels))  # all-exempt config: nothing to guard

    def dispatch(self, user: str, groups: Tuple[str, ...], verb: str
                 ) -> Optional[Callable[[], None]]:
        level_name = self.classify(user, groups, verb)
        level = self.levels[level_name]
        if level.exempt:
            with self._lock:  # += on a shared counter is read-modify-write
                self.dispatched_total[level_name] += 1
            return lambda: None
        deadline = None
        with self._cond:
            if self._in_flight[level_name] >= level.concurrency:
                if self._queued[level_name] >= level.queue_length:
                    self.rejected_total[level_name] += 1
                    return None
                self._queued[level_name] += 1
                deadline = time.monotonic() + self.wait_timeout
                try:
                    while self._in_flight[level_name] >= level.concurrency:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not self._cond.wait(remaining):
                            if self._in_flight[level_name] < level.concurrency:
                                break
                            self.rejected_total[level_name] += 1
                            return None
                finally:
                    self._queued[level_name] -= 1
            self._in_flight[level_name] += 1
            self.dispatched_total[level_name] += 1

        def release() -> None:
            with self._cond:
                self._in_flight[level_name] -= 1
                self._cond.notify_all()

        return release


@dataclasses.dataclass
class AuthConfig:
    """The middleware bundle serve_api accepts; every field optional —
    None disables that stage (matching the previous open server)."""

    authenticator: Optional[Authenticator] = None
    authorizer: Optional[RBACAuthorizer] = None
    flow: Optional[FlowController] = None
