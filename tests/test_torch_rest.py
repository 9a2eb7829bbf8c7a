"""The port's REST client (``kubernetes_tpu_torch/client/rest.py``) and its
informers over HTTP, against both packages' fronts.

The port's ``APIClient`` lists and watches the JAX front and the port's
front over stores given the same writes: equal lists, equal watch event
sequences (type, resourceVersion, object), and informers (JAX
``tests/test_rest_informers.py``'s cases) whose handlers see the same
events per object and whose caches end equal to the stores. The JAX
package's client on the port's front streams the same events. A watch
whose resourceVersion fell off the journal is ``Expired`` on both fronts,
and a dropped stream makes the reflector relist."""

from __future__ import annotations

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import torch_api  # noqa: E402
from _torch_front import FrontPair  # noqa: E402


@pytest.fixture()
def pair(monkeypatch):
    p = FrontPair(monkeypatch)
    yield p
    p.close()


def _clients(pair, token: str = ""):
    from kubernetes_tpu_torch.client.rest import APIClient

    return [APIClient(f"http://127.0.0.1:{port}", token=token) for port in pair.ports]


def _wire(obj):
    from kubernetes_tpu_torch.api.codec import to_wire

    return to_wire(obj)


def _jwire(obj):
    from kubernetes_tpu.api.codec import to_wire

    return to_wire(obj)


def _until(cond, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _nodes(n: int):
    return [torch_api().make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": 20})
            .obj() for i in range(n)]


def _pods(prefix: str, n: int):
    return [torch_api().make_pod(f"{prefix}{i}").req({"cpu": f"{100 * (i % 3 + 1)}m"}).obj()
            for i in range(n)]


def _writes(pair) -> None:
    """Creates, binds, an update and a delete, on both stores."""
    from kubernetes_tpu.api.types import Binding

    for pod in _pods("w", 4):
        pair.both("create_pod", pod)
    pair.tstore.bind("default/w0", "n0")
    pair.jstore.bind(Binding(pod_key="default/w0", node_name="n0"))
    upd = pair.tstore.get_pod("default/w1").clone()
    upd.meta.labels = {"v": "2"}
    pair.both("update_pod", upd)
    pair.tstore.delete_pod("default/w2")
    pair.jstore.delete_pod("default/w2")


def _drain(watch, n: int, stop: bool = True) -> list:
    out = []
    deadline = time.monotonic() + 20
    while len(out) < n and time.monotonic() < deadline:
        ev = watch.next(timeout=0.2)
        if ev is not None:
            out.append(ev)
    if stop:
        watch.stop()
    return out


def test_list_and_watch_sequences_equal(pair):
    from kubernetes_tpu.client.rest import APIClient as JAPIClient

    for node in _nodes(3):
        pair.both("create_node", node)
    clients = _clients(pair)
    lists = [c.list_objects("Node") for c in clients]
    assert [(rv, [_wire(o) for o in objs]) for objs, rv in lists][0] == [
        (rv, [_wire(o) for o in objs]) for objs, rv in lists][1]
    rv = lists[1][1]
    watches = [c.watch("Pod", rv) for c in clients]
    jwatch = JAPIClient(f"http://127.0.0.1:{pair.ports[1]}").watch("Pod", rv)
    _writes(pair)
    seqs = [[(e.seq, e.type, _wire(e.object)) for e in _drain(w, 7)] for w in watches]
    # the JAX watch is left to the server's shutdown, which ends its stream
    # (its stop() would wait on the idle read: C34)
    jseq = [(e.seq, e.type, _jwire(e.object)) for e in _drain(jwatch, 7, stop=False)]
    assert len(seqs[1]) == 7
    assert seqs[0] == seqs[1] == jseq
    assert [t for _s, t, _o in seqs[1]] == ["ADDED"] * 4 + ["MODIFIED", "MODIFIED", "DELETED"]


def test_informers_over_both_fronts(pair):
    """JAX ``test_rest_informers.py``: a Node informer's list and live adds,
    a Pod informer's add, update and delete, each over both fronts."""
    from kubernetes_tpu_torch.client.informer import SharedInformerFactory

    pair.both("create_node", _nodes(1)[0])
    seen = ([], [])
    informers = []
    for side, client in enumerate(_clients(pair)):
        factory = SharedInformerFactory(client)
        nodes, pods = factory.informer_for("Node"), factory.informer_for("Pod")
        for inf in (nodes, pods):
            inf.add_event_handler(lambda ev, old, new, s=seen[side], k=inf.kind: s.append(
                (k, ev, (new or old).meta.name, (new or old).spec.node_name
                 if k == "Pod" else "")))
        assert factory.wait_for_cache_sync()
        informers.append((nodes, pods))
    for node in _nodes(2)[1:]:
        pair.both("create_node", node)
    _writes(pair)

    def synced():
        for nodes, pods in informers:
            nodes.pump()
            pods.pump()
        return all(sorted(inf.indexer.list_keys()) == sorted(
            pair.tstore._kind_map(inf.kind)) for both in informers for inf in both)

    assert _until(synced)
    for side, (store, wire) in enumerate(((pair.jstore, _jwire), (pair.tstore, _wire))):
        for inf in informers[side]:
            assert {k: wire(v) for k, v in store._kind_map(inf.kind).items()} == {
                k: _wire(inf.indexer.get(k)) for k in inf.indexer.list_keys()}

    def per_object(events):
        out = {}
        for kind, ev, name, node in events:
            out.setdefault((kind, name), []).append((ev, node))
        return out

    # the same events per object; each object's last state is the store's
    assert per_object(seen[0]) == per_object(seen[1])
    assert per_object(seen[1])[("Pod", "w2")][-1][0] == "delete"
    assert ("Node", "add", "n1", "") in seen[1]


def test_expired_watch_and_relist(pair):
    from kubernetes_tpu_torch.apiserver.store import Expired
    from kubernetes_tpu_torch.client.informer import SharedInformerFactory

    for store in (pair.jstore, pair.tstore):
        store._journal_capacity = 4
    informers = []
    for client in _clients(pair):
        inf = SharedInformerFactory(client).informer_for("Pod")
        inf.start()
        informers.append(inf)
    for pod in _pods("x", 10):
        pair.both("create_pod", pod)
    for client in _clients(pair):
        with pytest.raises(Expired):
            client.watch("Pod", 1)
    # a dropped stream reads as Expired; the reflector relists to the truth
    for inf in informers:
        inf.reflector._watch.stop()
        with pytest.raises(Expired):
            inf.reflector.step()
        inf.reflector.relist()
        assert _until(lambda inf=inf: inf.pump() >= 0 and sorted(inf.indexer.list_keys())
                      == sorted(pair.tstore.pods))
    assert [_wire(informers[0].indexer.get(k)) for k in sorted(pair.tstore.pods)] == [
        _wire(informers[1].indexer.get(k)) for k in sorted(pair.tstore.pods)]
    for inf in informers:
        inf.reflector.stop()


def test_token_reaches_the_rbac_gate(monkeypatch):
    """``APIClient(token=...)`` sends the bearer token: the scheduler's
    identity lists pods through RBAC, an unknown client is refused."""
    import urllib.error

    from kubernetes_tpu_torch.api.types import ClusterRole, ClusterRoleBinding, ObjectMeta
    from kubernetes_tpu_torch.api.types import PolicyRule

    def auth(mods, store):
        a = mods["auth"]
        return a.AuthConfig(
            authenticator=a.Authenticator(tokens={"t": a.UserInfo("system:kube-scheduler")},
                                          allow_anonymous=False),
            authorizer=a.RBACAuthorizer(store), flow=a.FlowController())

    p = FrontPair(monkeypatch, auth=auth, serve=False)
    p.both("create_object", ClusterRole(meta=ObjectMeta(name="r", namespace=""), rules=(
        PolicyRule(verbs=("list", "watch"), resources=("Pod",)),)), "ClusterRole")
    p.both("create_object", ClusterRoleBinding(meta=ObjectMeta(name="b", namespace=""),
                                               role="r", subjects=("system:kube-scheduler",)),
           "ClusterRoleBinding")
    p.both("create_pod", _pods("t", 1)[0])
    p.serve()
    try:
        for client in _clients(p, token="t"):
            objs, _rv = client.list_objects("Pod")
            assert [o.meta.name for o in objs] == ["t0"]
            client.watch("Pod", _rv).stop()
        for client in _clients(p):
            with pytest.raises(urllib.error.HTTPError) as err:
                client.list_objects("Pod")
            assert err.value.code == 401
    finally:
        p.close()


def test_c34_stop_wakes_a_reader_blocked_on_an_idle_stream(pair):
    """ROADMAP C34: the port's ``RESTWatch.stop`` returns at once while its
    reader waits on an idle stream, and the stream is closed. The JAX
    watch's ``stop`` waits for that read: it is still blocked a second
    later, and returns once the server ends the stream."""
    import threading

    from kubernetes_tpu.client.rest import APIClient as JAPIClient

    port_watch = _clients(pair)[1].watch("Pod", pair.tstore._event_seq)
    t0 = time.monotonic()
    port_watch.stop()
    assert time.monotonic() - t0 < 5.0
    port_watch._thread.join(5)
    assert not port_watch._thread.is_alive()
    jax_watch = JAPIClient(f"http://127.0.0.1:{pair.ports[0]}").watch(
        "Pod", pair.jstore._event_seq)
    stopper = threading.Thread(target=jax_watch.stop, daemon=True)
    stopper.start()
    stopper.join(1.0)
    assert stopper.is_alive()
    pair.close()  # the JAX front ends its streams within its 0.5 s poll
    stopper.join(10)
    assert not stopper.is_alive()
