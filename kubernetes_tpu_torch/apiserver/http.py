"""HTTP REST + watch front for the port's ``Store`` (the L2 seam; an own
copy of ``kubernetes_tpu/apiserver/http.py``).

The reference's apiserver serves typed REST over HTTPS with LIST/WATCH
streaming (staging/src/k8s.io/apiserver pkg/endpoints; watch cache
cacher.go:227). This module is that surface for the in-process store:
reference-shaped paths, JSON bodies through the reflection codec
(api/codec.py), resourceVersion LIST/WATCH semantics with 410 Gone, and the
pods/{name}/binding subresource the scheduler writes through
(registry/core/pod/storage/storage.go:169).

  GET    /api/v1/nodes                       LIST (cluster-scoped)
  GET    /api/v1/namespaces/{ns}/pods        LIST (namespaced)
  GET    .../pods?watch=1&resourceVersion=N  WATCH (JSON-lines stream)
  GET    .../pods/{name}                     GET
  POST   .../pods                            CREATE (admission chain runs)
  PUT    .../pods/{name}                     UPDATE
  DELETE .../pods/{name}                     DELETE
  POST   .../pods/{name}/binding             BIND

The handler chain (config.go:806 DefaultBuildHandlerChain) runs
authentication → flow control (APF) → authorization when serve_api is given
an AuthConfig (apiserver/auth.py): bearer tokens / proxy headers resolve the
user (401 on bad credentials), the FlowController bounds per-priority-level
in-flight requests (429 when a level's queue is full), and the RBAC
authorizer gates verb×kind (403). All three stages are optional — a bare
serve_api() is the previous open server. The resolved user is pinned on the
store for the request (NodeRestriction admission reads it).

For the same requests against stores holding the same objects, this front
and the JAX one answer with the same status codes and bodies, resource
versions included. The binding subresource calls the port's
``Store.bind(pod_key, node_name)`` with the Binding's two fields.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..api import types as api_types
from ..api.codec import from_wire, to_wire
from ..api.corev1 import meta_from
from ..api.protobuf import decode_object, encode_list, encode_object
from ..api.scheme import default_scheme
from ..api.types import CustomResource, CustomResourceDefinition
from ..api.validation import ValidationError
from .admission import AdmissionError
from .auth import ANONYMOUS, GROUP_UNAUTHENTICATED, AuthenticationError
from .store import Conflict, Expired, NotFound, Store

# protobuf content negotiation (api/protobuf.py; the reference's
# application/vnd.kubernetes.protobuf serializer seam)
_PROTO_CT = "application/vnd.kubernetes.protobuf"
_PROTO_BODY_KEY = "__ktpu_protobuf_body__"

# (group-path-prefix, plural) -> kind; plural -> python type via api.types
RESOURCES = {
    ("api/v1", "pods"): "Pod",
    ("api/v1", "nodes"): "Node",
    ("api/v1", "namespaces"): "Namespace",
    ("api/v1", "services"): "Service",
    ("api/v1", "endpoints"): "Endpoints",
    ("api/v1", "replicationcontrollers"): "ReplicationController",
    ("api/v1", "persistentvolumes"): "PersistentVolume",
    ("api/v1", "persistentvolumeclaims"): "PersistentVolumeClaim",
    ("api/v1", "resourcequotas"): "ResourceQuota",
    ("api/v1", "limitranges"): "LimitRange",
    ("api/v1", "configmaps"): "ConfigMap",
    ("api/v1", "secrets"): "Secret",
    ("api/v1", "serviceaccounts"): "ServiceAccount",
    ("apis/apps/v1", "deployments"): "Deployment",
    ("apis/apps/v1", "replicasets"): "ReplicaSet",
    ("apis/apps/v1", "statefulsets"): "StatefulSet",
    ("apis/apps/v1", "daemonsets"): "DaemonSet",
    ("apis/batch/v1", "jobs"): "Job",
    ("apis/batch/v1", "cronjobs"): "CronJob",
    ("apis/discovery.k8s.io/v1", "endpointslices"): "EndpointSlice",
    ("apis/storage.k8s.io/v1", "volumeattachments"): "VolumeAttachment",
    ("apis/policy/v1", "poddisruptionbudgets"): "PodDisruptionBudget",
    ("apis/scheduling.k8s.io/v1", "priorityclasses"): "PriorityClass",
    ("apis/storage.k8s.io/v1", "storageclasses"): "StorageClass",
    ("apis/storage.k8s.io/v1", "csinodes"): "CSINode",
    ("apis/coordination.k8s.io/v1", "leases"): "Lease",
    ("apis/certificates.k8s.io/v1", "certificatesigningrequests"):
        "CertificateSigningRequest",
    ("apis/node.k8s.io/v1", "runtimeclasses"): "RuntimeClass",
    ("apis/networking.k8s.io/v1", "ingresses"): "Ingress",
    ("apis/networking.k8s.io/v1", "ingressclasses"): "IngressClass",
    ("apis/resource.k8s.io/v1alpha2", "resourceclasses"): "ResourceClass",
    ("apis/resource.k8s.io/v1alpha2", "resourceclaims"): "ResourceClaim",
    ("apis/resource.k8s.io/v1alpha2", "resourceclaimtemplates"):
        "ResourceClaimTemplate",
    ("apis/resource.k8s.io/v1alpha2", "podschedulingcontexts"):
        "PodSchedulingContext",
    ("apis/scheduling.x-k8s.io/v1alpha1", "podgroups"): "PodGroup",
    ("apis/scheduling.x-k8s.io/v1alpha1", "schedulingquotas"): "SchedulingQuota",
    ("apis/apiextensions.k8s.io/v1", "customresourcedefinitions"):
        "CustomResourceDefinition",
    ("apis/apiregistration.k8s.io/v1", "apiservices"): "APIService",
    ("api/v1", "events"): "Event",
}

_KIND_TYPES = {kind: getattr(api_types, kind) for (_g, _p), kind in RESOURCES.items()}


def _route(path: str) -> Optional[Tuple[str, str, Optional[str], Optional[str], Optional[str]]]:
    """path -> (group, kind, namespace, name, subresource) or None."""
    parts = [p for p in path.split("/") if p]
    for (group, plural), kind in RESOURCES.items():
        gparts = group.split("/")
        if parts[:len(gparts)] != gparts:
            continue
        rest = parts[len(gparts):]
        ns = None
        # "namespaces/{ns}/{plural}/..." is a namespaced-resource path;
        # "namespaces" / "namespaces/{name}" address Namespace objects
        if len(rest) >= 3 and rest[0] == "namespaces":
            ns = rest[1]
            rest = rest[2:]
        if not rest or rest[0] != plural:
            continue
        name = rest[1] if len(rest) > 1 else None
        sub = rest[2] if len(rest) > 2 else None
        return group, kind, ns, name, sub
    return None


class _Handler(BaseHTTPRequestHandler):
    store: Store = None  # bound by serve_api()
    auth = None                 # Optional[AuthConfig], bound by serve_api()
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY on every connection: a reply is its header block and its
    # body in two writes, and with Nagle's algorithm the body waits for the
    # client's delayed ACK of the headers (about 40 ms per keep-alive
    # request on Linux); the JAX front leaves it on (ROADMAP C35)
    disable_nagle_algorithm = True

    def _maybe_aggregate(self, path: str, body_doc=None) -> bool:
        """kube-aggregator arm: when no built-in or CRD route claims an
        /apis/{group}/{version} path but a non-local APIService does, proxy
        the request verbatim to its backend and relay the response
        (kube-aggregator pkg/apiserver/handler_proxy.go, minus TLS/auth
        forwarding). Returns True when the request was proxied."""
        parts = [p for p in path.split("/") if p]
        if len(parts) < 3 or parts[0] != "apis":
            return False
        svc = self.store.api_service_for(parts[1], parts[2])
        if svc is None:
            return False
        endpoint = svc.service_endpoint
        if "://" not in endpoint:
            endpoint = f"http://{endpoint}"
        target = endpoint.rstrip("/") + self.path
        body = None
        if body_doc is not None:
            body = json.dumps(body_doc).encode()
        else:
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length:
                body = self.rfile.read(length)
        req = urllib.request.Request(
            target, data=body, method=self.command,
            headers={k: v for k, v in self.headers.items()
                     if k.lower() in ("content-type", "accept")})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = resp.read()
                self.send_response(resp.status)
                self.send_header("Content-Type",
                                 resp.headers.get("Content-Type",
                                                  "application/json"))
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
        except urllib.error.HTTPError as e:
            payload = e.read()
            self.send_response(e.code)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except OSError as e:
            self._error(503, "ServiceUnavailable",
                        f"aggregated apiserver {svc.meta.name}: {e}")
        return True

    def _resolve(self, path: str):
        """Static route table first, then registered CRDs (the
        apiextensions customresource_handler.go dynamic path)."""
        r = _route(path)
        if r is not None:
            return r
        parts = [p for p in path.split("/") if p]
        if len(parts) >= 4 and parts[0] == "apis":
            group, version = parts[1], parts[2]
            rest = parts[3:]
            ns = None
            if len(rest) >= 3 and rest[0] == "namespaces":
                ns = rest[1]
                rest = rest[2:]
            if rest:
                crd = self.store.crd_for_plural(group, rest[0])
                if crd is not None and crd.version == version:
                    name = rest[1] if len(rest) > 1 else None
                    sub = rest[2] if len(rest) > 2 else None
                    return (f"apis/{group}/{version}", crd.kind, ns, name, sub)
        return None

    def log_message(self, *args):
        pass

    # ------------------------------------------------- handler-chain middleware

    _VERB_BY_METHOD = {"POST": "create", "PUT": "update", "DELETE": "delete"}

    def _request_verb(self) -> str:
        if self.command == "GET":
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if q.get("watch", ["0"])[0] in ("1", "true"):
                return "watch"
            r = self._resolve(url.path)
            return "get" if (r is not None and r[3] is not None) else "list"
        return self._VERB_BY_METHOD.get(self.command, "get")

    def _gate(self):
        """authn → flow control → authz. Returns a release callable to run
        when the request finishes, or None if a response was already sent.
        Gate failures close the connection: the request body may be undrained
        on the socket, which would corrupt keep-alive reuse."""
        verb = self._request_verb()
        user_name, groups = "system:admin", ()
        cfg = self.auth
        if cfg is not None and cfg.authenticator is not None:
            try:
                user = cfg.authenticator.authenticate(self.headers)
            except AuthenticationError as e:
                self.close_connection = True
                self._error(401, "Unauthorized", str(e))
                return None
            user_name, groups = user.name, user.groups
        elif cfg is not None and cfg.authorizer is not None:
            # authorization without authentication: unauthenticated traffic
            # is ANONYMOUS, never the admin default (everyone-is-admin) and
            # never a spoofable X-Remote-User header — asserting an identity
            # against an active authorizer requires an Authenticator that
            # opted into proxy-header trust.
            user_name, groups = ANONYMOUS, (GROUP_UNAUTHENTICATED,)
        elif self.headers.get("X-Remote-User"):
            # no authenticator and no authorizer (open server): trust the
            # proxy header so the NodeRestriction admission seam still sees
            # kubelet identities
            user_name = self.headers["X-Remote-User"]
        self.store.set_request_user(user_name, groups)
        release = lambda: None  # noqa: E731
        if cfg is not None and cfg.flow is not None:
            release = cfg.flow.dispatch(user_name, groups, verb)
            if release is None:
                self.close_connection = True
                self._error(429, "TooManyRequests",
                            "request rejected by priority-and-fairness")
                return None
        if cfg is not None and cfg.authorizer is not None:
            r = self._resolve(urlparse(self.path).path)
            kind = r[1] if r is not None else ""
            name = r[3] or "" if r is not None else ""
            sub = r[4] or "" if r is not None else ""
            if r is not None and name and r[2] is not None \
                    and kind not in self.store.CLUSTER_SCOPED_KINDS:
                # namespaced objects authorize by their store key — a bare
                # name would collapse same-named objects across namespaces
                # (the NodeAuthorizer graph check depends on this)
                name = f"{r[2]}/{name}"
            if not cfg.authorizer.allowed_for(user_name, groups, verb, kind,
                                              name, sub):
                release()
                self.close_connection = True
                self._error(403, "Forbidden",
                            f"user {user_name!r} cannot {verb} {kind}")
                return None
        return release

    # ------------------------------------------------------------- helpers

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, reason: str, message: str) -> None:
        # metav1.Status shape
        self._send_json(code, {
            "kind": "Status", "apiVersion": "v1", "status": "Failure",
            "reason": reason, "message": message, "code": code,
        })

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n)
        # content negotiation (runtime/serializer/protobuf): a protobuf
        # body rides through _decode_body via the raw-bytes marker
        if _PROTO_CT in (self.headers.get("Content-Type") or ""):
            return {_PROTO_BODY_KEY: raw}
        return json.loads(raw or b"{}")

    def _wants_proto(self) -> bool:
        return _PROTO_CT in (self.headers.get("Accept") or "")

    def _send_proto(self, code: int, payload: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", _PROTO_CT)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _obj_wire(self, kind: str, obj) -> dict:
        d = to_wire(obj)
        d["kind"] = kind
        return d

    def _decode_body(self, kind: str, body: dict):
        """Three wire dialects on the write path: protobuf (magic-prefixed
        KObject bytes via content negotiation), a REFERENCE-shaped manifest
        (apiVersion + metadata) through the versioned scheme
        (api/scheme.py), else this framework's snake_case reflection
        format."""
        if _PROTO_BODY_KEY in body:
            got_kind, obj = decode_object(body[_PROTO_BODY_KEY], kind)
            if got_kind != kind:
                raise ValueError(f"protobuf body is a {got_kind}, not {kind}")
            return obj
        if kind == "CustomResourceDefinition" and "metadata" in body:
            # apiextensions manifest: registration fields live at the top
            # level of the reduced CRD model
            spec = body.get("spec") or {}
            names = spec.get("names") or {}
            versions = spec.get("versions") or ()
            version = (versions[0].get("name", "v1") if versions
                       else body.get("version", "v1"))
            return CustomResourceDefinition(
                meta=meta_from(body.get("metadata") or {}),
                group=spec.get("group", body.get("group", "")),
                version=version,
                kind=names.get("kind", body.get("kind_", "")),
                plural=names.get("plural", body.get("plural", "")),
                namespaced=(spec.get("scope", "Namespaced") == "Namespaced"
                            if "scope" in spec
                            else bool(body.get("namespaced", True))),
            )
        if kind not in _KIND_TYPES:
            # dynamic (CRD-served) kind: manifest-shaped body → CustomResource
            return CustomResource(
                meta=meta_from(body.get("metadata") or {}),
                api_version=body.get("apiVersion", ""),
                kind=body.get("kind", kind),
                spec=dict(body.get("spec") or {}),
                status=dict(body.get("status") or {}),
            )
        if "apiVersion" in body and "metadata" in body:
            # a manifest-shaped body MUST decode through the scheme: an
            # unregistered apiVersion is a clear 400, never a silent
            # fall-through to the reflection decoder (which would turn
            # camelCase keys into a default-valued object)
            obj = default_scheme().decode(dict(body, kind=body.get("kind") or kind))
            if not isinstance(obj, _KIND_TYPES[kind]):
                raise ValueError(
                    f"body kind {type(obj).__name__} does not match "
                    f"path resource {kind}")
            return obj
        return from_wire(_KIND_TYPES[kind], body)

    def _cluster_scoped(self, kind: str) -> bool:
        return self.store.is_cluster_scoped(kind)

    def _match(self, kind: str, ns: Optional[str], obj) -> bool:
        return (ns is None or self._cluster_scoped(kind)
                or obj.meta.namespace == ns)

    # ------------------------------------------------------------- verbs

    def do_GET(self):  # noqa: N802
        release = self._gate()
        if release is None:
            return
        try:
            return self._serve_get()
        finally:
            release()

    def _serve_get(self):
        url = urlparse(self.path)
        r = self._resolve(url.path)
        if r is None:
            if self._maybe_aggregate(url.path):
                return
            return self._error(404, "NotFound", f"unknown path {url.path}")
        _g, kind, ns, name, _sub = r
        q = parse_qs(url.query)
        if name is None and q.get("watch", ["0"])[0] in ("1", "true"):
            rv_raw = q.get("resourceVersion", [None])[0]
            if rv_raw is None:
                # unset = "from current state" (reference semantics): never
                # 410, no backlog replay — long-lived servers trim the
                # journal, and an rv-less watch must still establish
                _objs, since = self.store.list_objects(kind)
            else:
                try:
                    since = int(rv_raw)
                except ValueError:
                    return self._error(400, "BadRequest",
                                       f"invalid resourceVersion {rv_raw!r}")
            return self._watch(kind, ns, since)
        if name is None:
            objs, rv = self.store.list_objects(kind)
            matched = [o for o in objs if self._match(kind, ns, o)]
            if self._wants_proto():
                return self._send_proto(200, encode_list(kind, matched, rv))
            return self._send_json(200, {
                "kind": f"{kind}List", "apiVersion": "v1",
                "metadata": {"resourceVersion": str(rv)},
                "items": [self._obj_wire(kind, o) for o in matched],
            })
        key = name if self._cluster_scoped(kind) else f"{ns}/{name}"
        obj = self.store.get_object(kind, key)
        if obj is None or not self._match(kind, ns, obj):
            return self._error(404, "NotFound", f"{kind} {key} not found")
        if self._wants_proto():
            return self._send_proto(200, encode_object(kind, obj))
        return self._send_json(200, self._obj_wire(kind, obj))

    def _watch(self, kind: str, ns: Optional[str], since: int) -> None:
        try:
            w = self.store.watch(kind, since)
        except Expired as e:
            return self._error(410, "Expired", str(e))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            while True:
                ev = w.next(timeout=0.5)
                if ev is None:
                    if self.server.__shutdown_request__:
                        break
                    continue
                obj = ev.object
                if not self._match(kind, ns, obj):
                    continue
                line = json.dumps({
                    "type": ev.type,
                    "object": self._obj_wire(kind, obj),
                    "resourceVersion": str(ev.seq),
                }).encode() + b"\n"
                self.wfile.write(hex(len(line))[2:].encode() + b"\r\n" + line + b"\r\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            w.stop()
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

    def do_POST(self):  # noqa: N802
        release = self._gate()
        if release is None:
            return
        try:
            return self._serve_post()
        finally:
            release()

    def _serve_post(self):
        body = self._body()  # drain FIRST: keep-alive sockets must not carry leftovers
        r = self._resolve(urlparse(self.path).path)
        if r is None:
            if self._maybe_aggregate(urlparse(self.path).path, body_doc=body):
                return
            return self._error(404, "NotFound", "unknown path")
        _g, kind, ns, name, sub = r
        if kind == "Pod" and name is not None and sub == "binding":
            # BindingREST.Create (storage.go:169)
            target = body.get("target", {}).get("name", "")
            if not target:
                return self._error(400, "BadRequest", "binding target.name is required")
            try:
                self.store.bind(f"{ns}/{name}", target)
            except NotFound as e:
                return self._error(404, "NotFound", str(e))
            except Conflict as e:
                return self._error(409, "Conflict", str(e))
            return self._send_json(201, {"kind": "Status", "status": "Success"})
        if name is not None:
            return self._error(405, "MethodNotAllowed", "POST to a named resource")
        try:
            obj = self._decode_body(kind, body)
        except Exception as e:  # noqa: BLE001 — malformed body is a 400
            return self._error(400, "BadRequest", f"decode: {e}")
        if ns is not None and not self._cluster_scoped(kind):
            obj.meta.namespace = ns
        try:
            self.store.create_object(kind, obj)
        except Conflict as e:
            return self._error(409, "AlreadyExists", str(e))
        except AdmissionError as e:
            return self._error(403, "Forbidden", str(e))
        except ValidationError as e:
            return self._error(422, "Invalid", str(e))
        return self._send_json(201, self._obj_wire(kind, obj))

    def do_PUT(self):  # noqa: N802
        release = self._gate()
        if release is None:
            return
        try:
            return self._serve_put()
        finally:
            release()

    def _serve_put(self):
        body = self._body()  # drain first (keep-alive)
        r = self._resolve(urlparse(self.path).path)
        if r is None or r[3] is None:
            if r is None and self._maybe_aggregate(
                    urlparse(self.path).path, body_doc=body):
                return
            return self._error(404, "NotFound", "unknown path")
        _g, kind, ns, name, _sub = r
        try:
            obj = self._decode_body(kind, body)
        except Exception as e:  # noqa: BLE001
            return self._error(400, "BadRequest", f"decode: {e}")
        if obj.meta.name and obj.meta.name != name:
            return self._error(400, "BadRequest",
                               f"body name {obj.meta.name!r} != URL name {name!r}")
        obj.meta.name = name
        if ns is not None and not self._cluster_scoped(kind):
            obj.meta.namespace = ns
        try:
            self.store.update_object(kind, obj)
        except NotFound as e:
            return self._error(404, "NotFound", str(e))
        except Conflict as e:
            return self._error(409, "Conflict", str(e))
        except AdmissionError as e:
            return self._error(403, "Forbidden", str(e))
        except ValidationError as e:
            return self._error(422, "Invalid", str(e))
        return self._send_json(200, self._obj_wire(kind, obj))

    def do_DELETE(self):  # noqa: N802
        release = self._gate()
        if release is None:
            return
        try:
            return self._serve_delete()
        finally:
            release()

    def _serve_delete(self):
        self._body()  # drain DeleteOptions bodies (keep-alive invariant)
        r = self._resolve(urlparse(self.path).path)
        if r is None or r[3] is None:
            if r is None and self._maybe_aggregate(urlparse(self.path).path):
                return
            return self._error(404, "NotFound", "unknown path")
        _g, kind, ns, name, _sub = r
        key = name if self._cluster_scoped(kind) else f"{ns}/{name}"
        if kind == "Pod":
            try:
                self.store.delete_pod(key)
            except NotFound as e:
                return self._error(404, "NotFound", str(e))
        else:
            if self.store.get_object(kind, key) is None:
                return self._error(404, "NotFound", f"{kind} {key} not found")
            self.store.delete_object(kind, key)
        return self._send_json(200, {"kind": "Status", "status": "Success"})


def serve_api(store: Store, port: int = 0, auth=None):
    """Serve the REST+watch API on localhost; returns (server, port).
    ``auth`` is an optional apiserver.auth.AuthConfig enabling the
    authn/flow-control/authz handler chain."""
    handler = type("BoundAPIHandler", (_Handler,), {"store": store, "auth": auth})
    authz_member = False
    if auth is not None and auth.authorizer is not None:
        # the admission seam (OwnerReferencesPermissionEnforcement) shares
        # the HTTP layer's authorizer; refcounted ON THE STORE so the LAST
        # authz-enabled server clears it on shutdown (no stale policy, no
        # clearing out from under a still-live sibling server, and no
        # touching an authorizer the caller installed manually — servers
        # only join the refcount when serve_api itself performed or shares
        # the install)
        with _AUTHZ_LOCK:
            count = getattr(store, "_authz_install_count", 0)
            if store.authorizer is None:
                store.authorizer = auth.authorizer
                store._authz_install_count = count + 1
                authz_member = True
            elif count > 0:  # a sibling serve_api installed it: share it
                store._authz_install_count = count + 1
                authz_member = True
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    server.__ktpu_installed_authorizer__ = (store if authz_member else None)
    server.__shutdown_request__ = False
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


_AUTHZ_LOCK = threading.Lock()


def shutdown_api(server) -> None:
    server.__shutdown_request__ = True
    store = getattr(server, "__ktpu_installed_authorizer__", None)
    if store is not None:
        with _AUTHZ_LOCK:
            n = getattr(store, "_authz_install_count", 1) - 1
            store._authz_install_count = max(n, 0)
            if n <= 0:
                store.authorizer = None  # last installer clears the seam
    server.shutdown()
    server.server_close()
