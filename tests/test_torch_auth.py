"""The port's authentication, authorization and flow control
(``kubernetes_tpu_torch/apiserver/auth.py``) against the JAX package's.

A table of identities (bearer tokens, proxy headers, anonymous, a bad
token) and requests goes through both packages' ``Authenticator``,
``RBACAuthorizer``, ``NodeAuthorizer`` (with RBAC behind it) and
``FlowController``, with equal decisions; then through both HTTP fronts
with the whole chain on, with equal 401 / 403 / 429 / 2xx answers and
bodies. The flow controller's queue limits are checked with limits that
decide without waiting (a full level with no queue, a zero wait), so no
case reads the wall clock. ``Store.as_user`` pins an identity that
NodeRestriction reads, groups restored on exit."""

from __future__ import annotations

import itertools
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import jax_api, torch_api  # noqa: E402
from _torch_front import FrontPair, packages  # noqa: E402

TOKENS = {"alice-tok": ("alice", ("devs",)), "root-tok": ("root", ("system:masters",)),
          "sched-tok": ("system:kube-scheduler", ()),
          "kubelet-tok": ("system:node:n1", ("system:nodes",))}
IDENTITIES = {
    "alice": {"Authorization": "Bearer alice-tok"},
    "root": {"Authorization": "Bearer root-tok"},
    "scheduler": {"Authorization": "Bearer sched-tok"},
    "kubelet-n1": {"Authorization": "Bearer kubelet-tok"},
    "bad-token": {"Authorization": "Bearer wrong"},
    "proxy-n2": {"X-Remote-User": "system:node:n2", "X-Remote-Group": "system:nodes, x"},
    "anonymous": {},
}


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as err:  # noqa: BLE001 - compared
        return type(err).__name__, str(err)


def _authenticator(auth, trust=None, anonymous=True):
    tokens = {t: auth.UserInfo(n, g) for t, (n, g) in TOKENS.items()}
    return auth.Authenticator(tokens=tokens, allow_anonymous=anonymous,
                              trust_proxy_headers=trust)


def test_authenticator_decisions():
    (jm, tm) = packages()
    for trust, anonymous in itertools.product((None, True, False), (True, False)):
        for headers in IDENTITIES.values():
            got = [_outcome(lambda m=m: _authenticator(m["auth"], trust, anonymous)
                            .authenticate(headers)) for m in (jm, tm)]
            got = [(o[0], (o[1].name, o[1].groups) if o[0] == "ok" else o[1]) for o in got]
            assert got[0] == got[1], (trust, anonymous, headers)
    plain = [m["auth"].Authenticator() for m in (jm, tm)]
    for headers in IDENTITIES.values():
        outs = [_outcome(lambda a=a: a.authenticate(headers)) for a in plain]
        assert [(o[0], getattr(o[1], "name", o[1])) for o in outs][0] == [
            (o[0], getattr(o[1], "name", o[1])) for o in outs][1]


def _policy(pair: FrontPair) -> None:
    """Roles and bindings, two nodes, a Secret and a ConfigMap, and a pod on
    n1 that references both and a PVC."""
    from kubernetes_tpu_torch.api.types import (ClusterRole, ClusterRoleBinding, ConfigMap,
                                                ObjectMeta, PolicyRule, Secret)

    roles = {
        "pod-reader": (PolicyRule(verbs=("get", "list", "watch"), resources=("Pod",)),),
        "binder": (PolicyRule(verbs=("create",), resources=("Pod",), subresources=("binding",)),
                   PolicyRule(verbs=("get", "list", "watch"), resources=("Node", "Pod"))),
        "named": (PolicyRule(verbs=("get",), resources=("Secret",),
                             resource_names=("db-creds",)),),
    }
    for name, rules in roles.items():
        pair.both("create_object", ClusterRole(meta=ObjectMeta(name=name, namespace=""),
                                               rules=rules), "ClusterRole")
    for name, role, subjects in (("rb-read", "pod-reader", ("user:alice", "group:auditors")),
                                 ("rb-sched", "binder", ("system:kube-scheduler",)),
                                 ("rb-named", "named", ("group:devs",))):
        pair.both("create_object", ClusterRoleBinding(
            meta=ObjectMeta(name=name, namespace=""), role=role, subjects=subjects),
            "ClusterRoleBinding")
    for name in ("n1", "n2"):
        pair.both("create_node", torch_api().make_node(name).capacity({"cpu": "8"}).obj())
    pair.both("create_object", Secret(meta=ObjectMeta(name="db-creds")), "Secret")
    pair.both("create_object", ConfigMap(meta=ObjectMeta(name="cfg")), "ConfigMap")
    pod = torch_api().make_pod("web").obj()
    pod.spec.secret_volumes = ("db-creds",)
    pod.spec.config_map_volumes = ("cfg",)
    pod.spec.volumes = ("data",)
    pod.spec.node_name = "n1"
    pair.both("create_pod", pod)


USERS = [("alice", ("devs",)), ("bob", ("auditors",)), ("root", ("system:masters",)),
         ("system:kube-scheduler", ()), ("system:node:n1", ("system:nodes",)),
         ("system:node:n2", ("system:nodes",)), ("system:anonymous", ())]
VERBS = ("get", "list", "watch", "create", "update", "delete")
TARGETS = [("Pod", ""), ("Pod", "default/web"), ("Pod", "default/other"), ("Node", "n1"),
           ("Node", "n2"), ("Lease", "kube-node-lease/n1"), ("Secret", "default/db-creds"),
           ("Secret", "db-creds"), ("Secret", "default/other"), ("ConfigMap", "default/cfg"),
           ("PersistentVolumeClaim", "default/data"), ("Event", ""), ("Service", ""),
           ("ClusterRole", "binder")]


def test_authorizer_decisions(monkeypatch):
    pair = FrontPair(monkeypatch, serve=False)
    _policy(pair)
    jm, tm = packages()
    jrbac, trbac = jm["auth"].RBACAuthorizer(pair.jstore), tm["auth"].RBACAuthorizer(pair.tstore)
    jnode = jm["auth"].NodeAuthorizer(pair.jstore, delegate=jrbac)
    tnode = tm["auth"].NodeAuthorizer(pair.tstore, delegate=trbac)
    bare = (jm["auth"].NodeAuthorizer(pair.jstore), tm["auth"].NodeAuthorizer(pair.tstore))
    decided = [0, 0]
    for (user, groups), verb, (kind, name), sub in itertools.product(
            USERS, VERBS, TARGETS, ("", "binding", "status")):
        for j, t in ((jrbac, trbac), (jnode, tnode), bare):
            a = j.allowed_for(user, groups, verb, kind, name, sub)
            assert t.allowed_for(user, groups, verb, kind, name, sub) == a, (
                user, verb, kind, name, sub)
            decided[a] += 1
        assert trbac.allowed(user, verb, kind, name, sub) == jrbac.allowed(
            user, verb, kind, name, sub)
    assert decided[0] > 100 and decided[1] > 100
    rule = tm["auth"].PolicyRule(verbs=("get",), resources=("Secret",),
                                 resource_names=("db-creds",))
    assert rule.matches("get", "Secret", "default/db-creds", "")
    assert not rule.matches("get", "Secret", "default/other", "")


def test_flow_classification_and_queue_limits():
    jm, tm = packages()
    fcs = [m["auth"].FlowController() for m in (jm, tm)]
    for (user, groups), verb in itertools.product(
            USERS + [("anyone", ("system:authenticated",))], VERBS):
        assert fcs[1].classify(user, groups, verb) == fcs[0].classify(user, groups, verb)
    # custom levels: a catch-all last, an all-exempt configuration
    for levels, schemas in (
            ([("fast", 4, 8, False), ("slow", 1, 0, False)], [("only-alice", "fast", ("alice",))]),
            ([("ex", 1, 1, True)], [])):
        got = []
        for m in (jm, tm):
            a = m["auth"]
            fc = a.FlowController(
                levels=[a.PriorityLevel(n, concurrency=c, queue_length=q, exempt=e)
                        for n, c, q, e in levels],
                schemas=[a.FlowSchema(n, lv, users=u) for n, lv, u in schemas])
            got.append([fc.classify(u, g, "get") for u, g in USERS])
        assert got[0] == got[1]
    # queue limits, decided without waiting: concurrency 2, no queue; then a
    # queue of one with a zero wait
    for queue, wait in ((0, 5.0), (1, 0.0)):
        trace = []
        for m in (jm, tm):
            a = m["auth"]
            fc = a.FlowController(levels=[a.PriorityLevel("only", concurrency=2,
                                                          queue_length=queue)],
                                  schemas=[a.FlowSchema("all", "only")], wait_timeout=wait)
            held = [fc.dispatch("u", (), "get") for _ in range(3)]
            steps = [r is not None for r in held]
            held[0]()
            again = fc.dispatch("u", (), "get")
            steps.append(again is not None)
            steps.append(fc.dispatch("u", (), "get") is not None)
            trace.append((steps, dict(fc.rejected_total), dict(fc.dispatched_total),
                          dict(fc._in_flight), dict(fc._queued)))
        assert trace[0] == trace[1]
        assert trace[1][0] == [True, True, False, True, False]
    exempt = [m["auth"].FlowController().dispatch("root", ("system:masters",), "get")
              for m in (jm, tm)]
    assert all(r is not None for r in exempt)


def _auth_config(mods, store):
    a = mods["auth"]
    levels, schemas = a.default_flow_config()
    # a level that never admits: every request of its user is a 429
    levels.append(a.PriorityLevel("closed", concurrency=0, queue_length=0))
    schemas.insert(0, a.FlowSchema("throttled", "closed", users=("system:node:n2",)))
    return a.AuthConfig(authenticator=_authenticator(a, trust=True),
                        authorizer=a.NodeAuthorizer(store, delegate=a.RBACAuthorizer(store)),
                        flow=a.FlowController(levels, schemas))


REQUESTS = [
    ("GET", "/api/v1/namespaces/default/pods", None),
    ("GET", "/api/v1/namespaces/default/pods/web", None),
    ("GET", "/api/v1/nodes", None),
    ("GET", "/api/v1/nodes/n2", None),
    ("GET", "/api/v1/namespaces/default/secrets/db-creds", None),
    ("GET", "/api/v1/namespaces/default/configmaps/cfg", None),
    ("POST", "/api/v1/namespaces/default/pods",
     {"meta": {"name": "p-new"}, "spec": {"containers": [{"name": "c", "requests": {"cpu": "1"}}]}}),
    ("POST", "/api/v1/namespaces/default/pods/web/binding", {"target": {"name": "n2"}}),
    ("PUT", "/api/v1/nodes/n1", {"meta": {"name": "n1"}, "status": {"ready": True}}),
    ("DELETE", "/api/v1/namespaces/default/configmaps/cfg", None),
    ("GET", "/apis/rbac.authorization.k8s.io/v1/clusterroles", None),
]


def test_the_chain_over_http(monkeypatch):
    pair = FrontPair(monkeypatch, auth=_auth_config, serve=False)
    _policy(pair)
    pair.serve()
    try:
        codes = {}
        for who, headers in IDENTITIES.items():
            for method, path, body in REQUESTS:
                code, _ = pair.request(method, path, body, headers)
                codes.setdefault(code, []).append((who, method, path))
        assert {401, 403, 429, 200, 201} <= set(codes), sorted(codes)
        assert all(who == "bad-token" for who, _m, _p in codes[401])
        assert all(who == "proxy-n2" for who, _m, _p in codes[429])
        # the flow controllers counted alike
        jfc, tfc = (srv.RequestHandlerClass.auth.flow for _mod, srv in pair.servers)
        assert tfc.dispatched_total == jfc.dispatched_total
        assert tfc.rejected_total == jfc.rejected_total
        assert pair.tstore.authorizer is not None
    finally:
        pair.close()
    assert pair.tstore.authorizer is None and pair.jstore.authorizer is None


def test_open_front_trusts_the_proxy_header(monkeypatch):
    """No AuthConfig: the proxy header's identity reaches NodeRestriction."""
    pair = FrontPair(monkeypatch)
    try:
        for name in ("n1", "n2"):
            pair.both("create_node", torch_api().make_node(name).capacity({"cpu": "4"}).obj())
        body = {"meta": {"name": "n2"}, "spec": {}, "status": {"ready": True}}
        code, _ = pair.request("PUT", "/api/v1/nodes/n2", body,
                               {"X-Remote-User": "system:node:n1"})
        assert code == 403
        code, _ = pair.request("PUT", "/api/v1/nodes/n1", dict(body, meta={"name": "n1"}),
                               {"X-Remote-User": "system:node:n1"})
        assert code == 200
    finally:
        pair.close()


def test_as_user(monkeypatch):
    pair = FrontPair(monkeypatch, serve=False)
    stores = (pair.jstore, pair.tstore)
    apis = (jax_api(), torch_api())
    for store in stores:
        assert (store.request_user(), store.request_groups()) == ("system:admin", ())
    outs = []
    for store, api in zip(stores, apis):
        got = []
        with store.as_user("system:node:n1", ("system:nodes",)):
            got.append((store.request_user(), store.request_groups()))
            got.append(_outcome(lambda: store.create_node(
                api.make_node("n2").capacity({"cpu": "4"}).obj())))
            got.append(_outcome(lambda: store.create_node(
                api.make_node("n1").capacity({"cpu": "4"}).obj())))
            with store.as_user("alice"):
                got.append((store.request_user(), store.request_groups()))
            got.append((store.request_user(), store.request_groups()))
        got.append((store.request_user(), store.request_groups()))
        store.set_request_user("bob", ("g",))
        got.append((store.request_user(), store.request_groups()))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][1][0] == "AdmissionError" and outs[1][2] == ("ok", None)
    assert outs[1][5] == ("system:admin", ())


@pytest.mark.parametrize("verb", ["update", "create"])
def test_owner_reference_enforcement_uses_the_request_groups(monkeypatch, verb):
    """OwnerReferencesPermissionEnforcement asks the store's authorizer with
    the request's identity, groups included (system:masters passes)."""
    from kubernetes_tpu_torch.api.types import ConfigMap, ObjectMeta, OwnerReference

    pair = FrontPair(monkeypatch, serve=False)
    jm, tm = packages()
    pair.jstore.authorizer = jm["auth"].RBACAuthorizer(pair.jstore)
    pair.tstore.authorizer = tm["auth"].RBACAuthorizer(pair.tstore)
    ref = OwnerReference(kind="Deployment", name="web", controller=True,
                         block_owner_deletion=True)
    for user, groups in (("alice", ()), ("root", ("system:masters",))):
        cm = ConfigMap(meta=ObjectMeta(name=f"cm-{user}", owner_references=(ref,)))
        for store in (pair.jstore, pair.tstore):
            store.set_request_user(user, groups)
        if verb == "create":
            pair.both("create_object", cm, "ConfigMap")
        else:
            plain = ConfigMap(meta=ObjectMeta(name=f"cm-{user}"))
            for store in (pair.jstore, pair.tstore):
                store.set_request_user("system:admin", ())
            pair.both("create_object", plain, "ConfigMap")
            for store in (pair.jstore, pair.tstore):
                store.set_request_user(user, groups)
            pair.both("update_object", cm, "ConfigMap")
    assert "default/cm-root" in pair.tstore.config_maps
