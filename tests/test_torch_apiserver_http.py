"""The port's HTTP front (``kubernetes_tpu_torch/apiserver/http.py``) against
the JAX package's: one request script against both ``serve_api``s (the JAX
one over a ``ClusterStore``, the port's over a ``Store``), every response
equal in status code and body bytes, resource versions included.

The script covers LIST (JSON and protobuf), GET, POST in the framework's
format, as a core/v1 manifest and as a protobuf body, PUT, DELETE, the
binding subresource, every error status the front gives (400, 403, 404,
405, 409, 410, 422, 503), the watch stream with its resume and a 410, a
CRD and its custom objects, and APIService aggregation to a local backend.
Then each package's scheduler loop (the port's on the CPU) behind its own
front, fed the same POSTs, places every pod alike. Objects come from one
seeded numpy generator (``SEED``)."""

from __future__ import annotations

import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import build_nodes, build_pods, cluster_spec, pods_spec, torch_api  # noqa: E402
from _torch_front import FrontPair  # noqa: E402

SEED = 24
PROTO = "application/vnd.kubernetes.protobuf"


@pytest.fixture(autouse=True)
def _sync(monkeypatch):
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")


@pytest.fixture()
def pair(monkeypatch):
    p = FrontPair(monkeypatch)
    yield p
    p.close()


def _manifest(kind: str, obj) -> dict:
    from kubernetes_tpu_torch.api.scheme import default_scheme

    doc = default_scheme().encode(obj)
    assert doc["kind"] == kind
    return doc


def _wire(obj) -> dict:
    from kubernetes_tpu_torch.api.codec import to_wire

    return to_wire(obj)


def _proto(kind: str, obj) -> bytes:
    from kubernetes_tpu_torch.api.protobuf import encode_object

    return encode_object(kind, obj)


def _seeded_objects():
    nodes = [ni.node for ni in build_nodes(torch_api(), cluster_spec(6, SEED))]
    pods = build_pods(torch_api(), pods_spec(9, SEED))
    for pod in pods:
        pod.spec.node_name = ""
        pod.status.nominated_node_name = ""
    return nodes, pods


def test_crud_binding_and_errors(pair):
    nodes, pods = _seeded_objects()
    base = "/api/v1"
    # nodes: the framework's format, a manifest, protobuf
    for i, node in enumerate(nodes):
        body = [_wire(node), _manifest("Node", node), _proto("Node", node)][i % 3]
        hdrs = {"Content-Type": PROTO} if i % 3 == 2 else None
        code, _ = pair.request("POST", f"{base}/nodes", body, hdrs)
        assert code == 201
    for i, pod in enumerate(pods):
        body = [_wire(pod), _manifest("Pod", pod), _proto("Pod", pod)][i % 3]
        hdrs = {"Content-Type": PROTO} if i % 3 == 2 else None
        code, _ = pair.request("POST", f"{base}/namespaces/default/pods", body, hdrs)
        assert code == 201
    assert len(pair.tstore.pods) == len(pods) and len(pair.tstore.nodes) == len(nodes)
    name = pods[0].meta.name
    code, doc = pair.json("GET", f"{base}/namespaces/default/pods/{name}")
    assert code == 200 and doc["kind"] == "Pod" and doc["meta"]["name"] == name
    code, doc = pair.json("GET", f"{base}/namespaces/default/pods")
    assert code == 200 and doc["kind"] == "PodList" and len(doc["items"]) == len(pods)
    assert pair.json("GET", f"{base}/namespaces/other/pods")[1]["items"] == []
    assert pair.json("GET", f"{base}/nodes")[1]["metadata"]["resourceVersion"] == str(
        pair.tstore._event_seq)
    # protobuf replies
    assert pair.request("GET", f"{base}/nodes", headers={"Accept": PROTO})[0] == 200
    assert pair.request("GET", f"{base}/namespaces/default/pods/{name}",
                        headers={"Accept": PROTO})[0] == 200
    # PUT: an update through the store's guarded update
    upd = _wire(pair.tstore.get_pod(f"default/{name}"))
    upd["meta"]["labels"] = {"edited": "yes"}
    code, doc = pair.json("PUT", f"{base}/namespaces/default/pods/{name}", upd)
    assert code == 200 and doc["meta"]["labels"] == {"edited": "yes"}
    assert pair.json("PUT", f"{base}/namespaces/default/pods/other-name", upd)[0] == 400
    assert pair.json("PUT", f"{base}/namespaces/default/pods/absent",
                     dict(upd, meta=dict(upd["meta"], name="absent")))[0] == 404
    # the binding subresource
    target = nodes[1].meta.name
    path = f"{base}/namespaces/default/pods/{pods[1].meta.name}/binding"
    assert pair.json("POST", path, {"target": {"name": target}})[0] == 201
    assert pair.tstore.get_pod(f"default/{pods[1].meta.name}").spec.node_name == target
    assert pair.json("POST", path, {"target": {"name": target}})[0] == 409
    assert pair.json("POST", path, {"target": {}})[0] == 400
    assert pair.json("POST", f"{base}/namespaces/default/pods/ghost/binding",
                     {"target": {"name": target}})[0] == 404
    # DELETE, then the errors
    assert pair.json("DELETE", f"{base}/namespaces/default/pods/{pods[2].meta.name}")[0] == 200
    assert pair.json("GET", f"{base}/namespaces/default/pods/{pods[2].meta.name}")[0] == 404
    assert pair.json("DELETE", f"{base}/nodes/ghost")[0] == 404
    assert pair.json("POST", f"{base}/nodes", _wire(nodes[0]))[0] == 409
    assert pair.json("POST", f"{base}/nodes/n0", _wire(nodes[0]))[0] == 405
    assert pair.json("GET", "/api/v1/widgets")[0] == 404
    assert pair.json("POST", f"{base}/namespaces/ghost/pods", _wire(pods[3]))[0] == 403
    bad = _wire(pods[3])
    bad["meta"]["name"] = "Bad_Name"
    assert pair.json("POST", f"{base}/namespaces/default/pods", bad)[0] == 422
    assert pair.json("POST", f"{base}/namespaces/default/pods",
                     {"apiVersion": "v9", "kind": "Pod", "metadata": {"name": "x"}})[0] == 400
    assert pair.json("POST", f"{base}/namespaces/default/pods", _manifest("Node", nodes[0]))[
        0] == 400
    assert pair.request("POST", f"{base}/namespaces/default/pods", b"k8s\x00garbage",
                        {"Content-Type": PROTO})[0] == 400
    # a generic kind of another group
    code, _ = pair.json("POST", "/apis/apps/v1/namespaces/default/deployments",
                        {"meta": {"name": "web"}, "replicas": 2})
    assert code == 201
    assert len(pair.json("GET", "/apis/apps/v1/namespaces/default/deployments")[1]["items"]) == 1
    assert pair.json("DELETE", "/apis/apps/v1/namespaces/default/deployments/web")[0] == 200
    assert pair.tstore._rv == pair.jstore._rv and pair.tstore._event_seq == pair.jstore._event_seq


def _watch_lines(port: int, path: str, n: int, out: list, ready: threading.Event) -> None:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        ready.set()
        for line in resp:
            out.append(line)
            if len(out) >= n:
                break


def test_watch_resume_and_410(pair):
    nodes, pods = _seeded_objects()
    for node in nodes[:2]:
        pair.both("create_node", node)
    code, doc = pair.json("GET", "/api/v1/namespaces/default/pods")
    rv = int(doc["metadata"]["resourceVersion"])
    lines = ([], [])
    threads = []
    for side, port in enumerate(pair.ports):
        ready = threading.Event()
        t = threading.Thread(target=_watch_lines, daemon=True, args=(
            port, f"/api/v1/namespaces/default/pods?watch=1&resourceVersion={rv}", 5,
            lines[side], ready))
        t.start()
        assert ready.wait(10)
        threads.append(t)
    for pod in pods[:3]:
        pair.both("create_pod", pod)
    pair.tstore.bind(pods[0].key(), nodes[0].meta.name)
    from kubernetes_tpu.api.types import Binding

    pair.jstore.bind(Binding(pod_key=pods[0].key(), node_name=nodes[0].meta.name))
    pair.tstore.delete_pod(pods[1].key())
    pair.jstore.delete_pod(pods[1].key())
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert lines[0] == lines[1]
    events = [json.loads(x) for x in lines[1]]
    assert [e["type"] for e in events] == ["ADDED"] * 3 + ["MODIFIED", "DELETED"]
    # resume from the second event: the backlog from there, equal
    resume = int(events[1]["resourceVersion"])
    backlog = ([], [])
    for side, port in enumerate(pair.ports):
        _watch_lines(port, f"/api/v1/namespaces/default/pods?watch=1&resourceVersion={resume}",
                     3, backlog[side], threading.Event())
    assert backlog[0] == backlog[1] == lines[1][2:]
    # a journal that no longer covers the version: 410 Gone
    for store in (pair.jstore, pair.tstore):
        store._journal_capacity = 4
    for pod in pods[3:8]:
        pair.both("create_pod", pod)
    code, doc = pair.json("GET", f"/api/v1/namespaces/default/pods?watch=1&resourceVersion={rv}")
    assert code == 410 and doc["reason"] == "Expired"
    assert pair.json("GET", "/api/v1/namespaces/default/pods?watch=1&resourceVersion=x")[0] == 400


def test_crd_and_custom_resources(pair):
    crd = {"apiVersion": "apiextensions.k8s.io/v1", "kind": "CustomResourceDefinition",
           "metadata": {"name": "widgets.x.io"},
           "spec": {"group": "x.io", "scope": "Namespaced",
                    "names": {"kind": "Widget", "plural": "widgets"},
                    "versions": [{"name": "v1"}]}}
    code, doc = pair.json("POST", "/apis/apiextensions.k8s.io/v1/customresourcedefinitions", crd)
    assert code == 201 and doc["kind"] == "CustomResourceDefinition"
    assert pair.json("POST", "/apis/apiextensions.k8s.io/v1/customresourcedefinitions",
                     crd)[0] == 409
    rng = np.random.default_rng(SEED)
    for i in range(3):
        body = {"apiVersion": "x.io/v1", "kind": "Widget", "metadata": {"name": f"w{i}"},
                "spec": {"size": int(rng.integers(1, 9))}}
        assert pair.json("POST", "/apis/x.io/v1/namespaces/default/widgets", body)[0] == 201
    code, doc = pair.json("GET", "/apis/x.io/v1/namespaces/default/widgets")
    assert code == 200 and len(doc["items"]) == 3
    assert pair.json("GET", "/apis/x.io/v1/namespaces/default/widgets/w1")[0] == 200
    assert pair.json("GET", "/apis/x.io/v2/namespaces/default/widgets")[0] == 404
    assert pair.json("DELETE", "/apis/x.io/v1/namespaces/default/widgets/w1")[0] == 200
    assert pair.tstore.get_object("Widget", "default/w0").spec == pair.jstore.get_object(
        "Widget", "default/w0").spec


def test_apiservice_aggregation(pair, monkeypatch):
    """A non-local APIService's group is proxied to its backend (here the
    port's own front over a third store, serving the group through a CRD);
    a dead backend answers 503."""
    from kubernetes_tpu_torch.api.types import CustomResourceDefinition, ObjectMeta
    from kubernetes_tpu_torch.apiserver.http import serve_api, shutdown_api
    from kubernetes_tpu_torch.apiserver.store import Store

    backend = Store(now_fn=lambda: pair.now)
    backend.create_crd(CustomResourceDefinition(
        meta=ObjectMeta(name="nodemetrics.metrics.k8s.io", namespace=""),
        group="metrics.k8s.io", version="v1beta1", kind="NodeMetrics",
        plural="nodemetrics", namespaced=False))
    server, bport = serve_api(backend)
    try:
        svc = {"apiVersion": "apiregistration.k8s.io/v1", "kind": "APIService",
               "metadata": {"name": "v1beta1.metrics.k8s.io"},
               "spec": {"group": "metrics.k8s.io", "version": "v1beta1"},
               "service_endpoint": f"127.0.0.1:{bport}"}
        assert pair.json("POST", "/apis/apiregistration.k8s.io/v1/apiservices", svc)[0] == 201
        body = {"apiVersion": "metrics.k8s.io/v1beta1", "kind": "NodeMetrics",
                "metadata": {"name": "node-a"}, "spec": {"cpu": "250m"}}
        # through the JAX front first, then the port's: the second is a 409
        # from the backend, relayed alike
        codes = [FrontPair.send(port, "POST", "/apis/metrics.k8s.io/v1beta1/nodemetrics",
                                body)[0] for port in pair.ports]
        assert codes == [201, 409]
        code, doc = pair.json("GET", "/apis/metrics.k8s.io/v1beta1/nodemetrics/node-a")
        assert code == 200 and doc["spec"] == {"cpu": "250m"}
        assert pair.json("GET", "/apis/unclaimed.io/v1/things")[0] == 404
        dead = {"apiVersion": "apiregistration.k8s.io/v1", "kind": "APIService",
                "metadata": {"name": "v1.dead.io"}, "spec": {"group": "dead.io", "version": "v1"},
                "service_endpoint": "127.0.0.1:1"}
        assert pair.json("POST", "/apis/apiregistration.k8s.io/v1/apiservices", dead)[0] == 201
        assert pair.json("GET", "/apis/dead.io/v1/things")[0] == 503
    finally:
        shutdown_api(server)


def test_loops_behind_the_fronts_place_alike(pair):
    """Each package's loop on its own store, fed over HTTP: the nodes and
    pods POSTed (manifests and protobuf), settled after each half; equal
    placements and pod lists, every pod bound."""
    from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler as JTPUScheduler
    from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    jsched = JTPUScheduler(pair.jstore, now_fn=JFakeClock(), batch_size=16, batch_deadline_ms=0,
                           percentage_of_nodes_to_score=100)
    tsched = TPUScheduler(pair.tstore, device="cpu", now_fn=FakeClock(), batch_size=16,
                          batch_deadline_ms=0, percentage_of_nodes_to_score=100)
    nodes = [ni.node for ni in build_nodes(torch_api(), cluster_spec(12, SEED))]
    for node in nodes:
        assert pair.request("POST", "/api/v1/nodes", _manifest("Node", node))[0] == 201
    pods = build_pods(torch_api(), pods_spec(40, SEED + 1))
    for half in (pods[:20], pods[20:]):
        for i, pod in enumerate(half):
            pod.spec.node_name = ""
            pod.status.nominated_node_name = ""
            body, hdrs = ((_proto("Pod", pod), {"Content-Type": PROTO}) if i % 2
                          else (_manifest("Pod", pod), None))
            assert pair.request("POST", "/api/v1/namespaces/default/pods", body, hdrs)[0] == 201
        jsched.run_until_settled()
        tsched.run_until_settled()
        placed = {k: p.spec.node_name for k, p in pair.tstore.pods.items()}
        assert placed == {k: p.spec.node_name for k, p in pair.jstore.pods.items()}
    assert sum(bool(n) for n in placed.values()) == sum(
        bool(p.spec.node_name) for p in pair.jstore.pods.values()) > 30
    assert tsched.batch_counter == jsched.batch_counter
    code, _ = pair.request("GET", "/api/v1/namespaces/default/pods")
    assert code == 200


def test_run_loop_apiserver_on_the_cpu(monkeypatch):
    """``perf/apiserver.py`` (what ``chip_smoke.py``'s loop_apiserver phase
    runs on the card) at a small size on the CPU: Run A and the crash's Run
    B pass every check, and both place every pod as ``run_loop`` does with
    the same workload created in process."""
    from kubernetes_tpu_torch.perf import workloads
    from kubernetes_tpu_torch.perf.apiserver import check_apiserver_run, run_loop_apiserver

    w = workloads.scheduling_basic(80, 48, 48)
    a = run_loop_apiserver(w, "cpu", batch_size=16)
    b = run_loop_apiserver(w, "cpu", crash=True, batch_size=16)
    assert check_apiserver_run("A", w, a, False) == []
    assert check_apiserver_run("B", w, b, True) == []
    ref = workloads.run_loop(w, "cpu", percentage=100, batch_size=16)
    assert a["placed"] == b["placed"] == ref["placed"]
    assert a["posts"] == {"manifest": 48, "protobuf": 48}
    assert a["wal"]["lines"] == len(a["batch_lines"]) + 80 + 96 + 2  # binds, nodes, pods, RBAC
    assert b["informer_events"] == 48 and a["informer_events"] == 96
