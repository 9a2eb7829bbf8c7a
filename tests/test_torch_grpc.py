"""The gRPC binding of the device service (``kubernetes_tpu_torch/backend/
grpc_service.py``) against the JAX package's (``kubernetes_tpu/backend/
grpc_service.py``; the counterparts of ``tests/test_grpc_service.py``), on
the CPU: the codecs byte for byte both ways, each package's client against
the other's server, the port's placements over gRPC equal to HTTP's and to
the JAX client's over gRPC, the status mappings, two clients on one service,
and the vendored schema (byte-equal to the JAX one, both modules in one
process, the port importing without grpc)."""

import json
import os
import subprocess
import sys

import pytest

from _torch_cases import WirePair, jax_api, torch_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gs(pkg):
    if pkg == "jax":
        from kubernetes_tpu.backend import grpc_service
    else:
        from kubernetes_tpu_torch.backend import grpc_service
    return grpc_service


def _codec(pkg):
    if pkg == "jax":
        from kubernetes_tpu.api.codec import to_wire
    else:
        from kubernetes_tpu_torch.api.codec import to_wire
    return to_wire


def _api(pkg):
    return jax_api() if pkg == "jax" else torch_api()


def _batch(pkg, n=64):
    """A scheduleBatch payload of ``n`` pods in three shapes, a claim row, a
    trace parent, the session stamps and an idempotency key."""
    api, to_wire = _api(pkg), _codec(pkg)
    pods = []
    for i in range(n):
        b = api.make_pod(f"p{i}").req({"cpu": ("500m", "1", "2")[i % 3], "memory": "1Gi"})
        if i % 3 == 2:
            b = b.label("app", "web")
        pods.append(to_wire(b.obj()))
    return {"pods": pods, "tieSeeds": list(range(n)), "batchId": "b-7",
            "traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
            "expectEpoch": "e-1", "clientId": "A", "sessionGen": 3,
            "claims": [{"pod": 1, "selectors": [["tpu.dev/gen", 1, 2, "v5"],
                                                ["tpu.dev/cores", 5, 1, 8]],
                        "allocatedNodes": ["n3"]}]}


def _deltas(pkg):
    api, to_wire = _api(pkg), _codec(pkg)
    node = api.make_node("n0").capacity({"cpu": "4", "memory": "8Gi", "pods": 10}).obj()
    pod = api.make_pod("p0").req({"cpu": "1"}).obj()
    return {"full": True, "nodes": [{"gen": 4, "node": to_wire(node), "pods": [to_wire(pod)]}],
            "removed": ["gone"], "namespaces": {"default": {"team": "a"}},
            "expectEpoch": "e-2", "clientId": "B", "sessionGen": 2,
            "inflightBatchIds": ["b-1", "b-2"], "replicator": True}


RESULTS = {"results": [
    {"nodeName": "n1"},
    {"nodeName": None, "conflict": True, "error": "owned by A"},
    {"nodeName": None, "unschedulablePlugins": ["NodeResourcesFit"],
     "statuses": {"n0": "NodeResourcesFit"},
     "preempt": {"candidates": ["n0", "n2"], "best": "n2"}},
    {"nodeName": None, "unschedulablePlugins": ["TaintToleration"], "statuses": {},
     "preempt": {"candidates": None, "best": "n4"}},
    {"nodeName": None, "unschedulablePlugins": [], "statuses": {}},
], "deviceTime": {"dwellMs": 0.25, "execMs": 1.5, "fetchMs": 0.125, "deviceMs": 1.625}}


def _bytes(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


def test_batch_codec_matches_jax_both_ways():
    """Template deduplication and the wire bytes equal JAX's, and each
    package decodes the other's request to what it decodes from its own."""
    jgs, tgs = _gs("jax"), _gs("port")
    jreq, treq = jgs._batch_to_proto(_batch("jax")), tgs._batch_to_proto(_batch("port"))
    assert len(treq.templates) == len(jreq.templates) == 3 and len(treq.pods) == 64
    assert _bytes(treq) == _bytes(jreq)
    raw = _bytes(treq)
    jback = jgs._batch_from_proto(jgs.pb2().ScheduleBatchRequest.FromString(raw))
    tback = tgs._batch_from_proto(tgs.pb2().ScheduleBatchRequest.FromString(raw))
    assert tback == jback
    assert [p["meta"]["name"] for p in tback["pods"]] == [f"p{i}" for i in range(64)]
    assert tback["claims"] == _batch("port")["claims"]
    json_size = len(json.dumps(_batch("port")).encode())
    assert len(raw) * 5 < json_size


def test_deltas_codec_matches_jax_both_ways():
    jgs, tgs = _gs("jax"), _gs("port")
    jreq, treq = jgs._deltas_to_proto(_deltas("jax")), tgs._deltas_to_proto(_deltas("port"))
    assert _bytes(treq) == _bytes(jreq)
    raw = _bytes(treq)
    jback = jgs._deltas_from_proto(jgs.pb2().ApplyDeltasRequest.FromString(raw))
    tback = tgs._deltas_from_proto(tgs.pb2().ApplyDeltasRequest.FromString(raw))
    assert tback == jback and tback["replicator"] and tback["inflightBatchIds"] == ["b-1", "b-2"]


def test_results_codec_matches_jax_both_ways():
    """Placements, conflicts, failures with their preemption hints (a
    candidate list, a truncated one) and the echoed deviceTime."""
    jgs, tgs = _gs("jax"), _gs("port")
    jresp, tresp = jgs._results_to_proto(RESULTS), tgs._results_to_proto(RESULTS)
    jgs._device_time_to_proto(jresp, RESULTS)
    tgs._device_time_to_proto(tresp, RESULTS)
    assert _bytes(tresp) == _bytes(jresp)
    raw = _bytes(tresp)
    for mod in (jgs, tgs):
        resp = mod.pb2().ScheduleBatchResponse.FromString(raw)
        back = mod._results_from_proto(resp)
        assert back["results"] == RESULTS["results"]
        assert mod._device_time_from_proto(resp) == RESULTS["deviceTime"]


def _serve(pkg, **kw):
    if pkg == "jax":
        from kubernetes_tpu.backend.service import DeviceService
    else:
        from kubernetes_tpu_torch.backend.service import DeviceService
        kw["device"] = "cpu"
    service = DeviceService(**kw)
    server, port = _gs(pkg).serve_grpc(service)
    return service, server, f"127.0.0.1:{port}"


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"), ("port", "jax")])
def test_client_against_the_other_packages_server(client_pkg, server_pkg):
    """Each package's GrpcClient speaks to the other's serve_grpc: pushes,
    a batch with a replay, Health, Heartbeat and the session table."""
    _service, server, endpoint = _serve(server_pkg, batch_size=8)
    client = _gs(client_pkg).GrpcClient(endpoint)
    try:
        api, to_wire = _api(client_pkg), _codec(client_pkg)
        node = api.make_node("n0").capacity({"cpu": "4", "memory": "8Gi", "pods": 10}).obj()
        out = client.apply_deltas({"clientId": "A", "full": True,
                                   "nodes": [{"gen": 1, "node": to_wire(node), "pods": []}]})
        assert out["nodes"] == 1 and out["sessionGen"] >= 1
        req = {"clientId": "A", "sessionGen": out["sessionGen"], "batchId": "a-1",
               "pods": [to_wire(api.make_pod("p").req({"cpu": "1"}).obj()),
                        to_wire(api.make_pod("q").req({"cpu": "8"}).obj())]}
        first = client.schedule_batch(req)
        again = client.schedule_batch(req)
        assert first["results"][0] == {"nodeName": "n0"} and first["batchId"] == "a-1"
        assert first["results"][1]["nodeName"] is None
        assert again["results"] == first["results"]
        health = client.health()
        assert health["status"] == "serving" and health["epoch"] == out["epoch"]
        hb = client.heartbeat({"clientId": "A", "sessionGen": out["sessionGen"]})
        assert hb["sessions"] == 1 and hb["epoch"] == out["epoch"]
        table = {s["clientId"]: s for s in client.sessions_dump()["sessions"]}
        assert table["A"]["fenced"] is False
    finally:
        client.close()
        server.stop(0)


def test_status_mappings():
    """A per-result conflict verdict, ABORTED as ConflictError for a fenced
    session's commit, FAILED_PRECONDITION as StaleEpochError with the
    current epoch; the same verdicts from the JAX client."""
    from kubernetes_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    for pkg in ("port", "jax"):
        errors = (__import__("kubernetes_tpu.backend.errors", fromlist=["x"]) if pkg == "jax"
                  else __import__("kubernetes_tpu_torch.backend.errors", fromlist=["x"]))
        service, server, endpoint = _serve("port", batch_size=8, lease_ttl_s=5.0, now_fn=clock)
        client = _gs(pkg).GrpcClient(endpoint)
        try:
            api, to_wire = _api(pkg), _codec(pkg)
            node = api.make_node("n0").capacity({"cpu": "4", "memory": "8Gi", "pods": 10}).obj()
            entry = {"gen": 1, "node": to_wire(node), "pods": []}
            gen_a = client.apply_deltas({"clientId": "A", "nodes": [entry]})["sessionGen"]
            client.apply_deltas({"clientId": "B", "nodes": [entry]})
            pod = to_wire(api.make_pod("raced").req({"cpu": "1"}).obj())
            first = client.schedule_batch({"clientId": "A", "sessionGen": gen_a, "pods": [pod],
                                           "batchId": "a-1"})
            second = client.schedule_batch({"clientId": "B", "pods": [pod], "batchId": "b-1"})
            assert first["results"][0]["nodeName"] == "n0"
            assert second["results"][0]["nodeName"] is None and second["results"][0]["conflict"]
            client.heartbeat({"clientId": "B"})
            clock.advance(3.0)
            client.heartbeat({"clientId": "B"})
            clock.advance(3.0)
            assert "A" in client.heartbeat({"clientId": "B"})["fenced"]
            with pytest.raises(errors.ConflictError):
                client.schedule_batch({"clientId": "A", "sessionGen": gen_a, "pods": [pod],
                                       "batchId": "a-2"})
            with pytest.raises(errors.StaleEpochError) as ei:
                client.apply_deltas({"clientId": "B", "nodes": [], "expectEpoch": "old"})
            assert ei.value.epoch == service.epoch
        finally:
            client.close()
            server.stop(0)


def _build_cluster(api, store):
    for i in range(6):
        store.create_node(api.make_node(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": 20}).label("zone", f"z{i % 2}").obj())
    for i in range(24):
        store.create_pod(api.make_pod(f"p{i}").req({"cpu": "900m", "memory": "1Gi"}).obj())


def _run(client_pkg, server_pkg, transport, depth=0):
    """Placements, counters and the queue of ``client_pkg``'s WireScheduler
    against ``server_pkg``'s service over ``transport`` (one lane)."""
    client_mod, _faults = WirePair._modules(client_pkg)
    server_mod, _ = WirePair._modules(server_pkg)
    kw = {"device": "cpu"} if server_pkg == "port" else {}
    service = server_mod.DeviceService(batch_size=32, **kw)
    if transport == "grpc":
        server, port = _gs(server_pkg).serve_grpc(service)
        endpoint = f"127.0.0.1:{port}"
    else:
        server, port = server_mod.serve(service)
        endpoint = f"http://127.0.0.1:{port}"
    try:
        if client_pkg == "jax":
            from kubernetes_tpu.apiserver.store import ClusterStore as Store
        else:
            from kubernetes_tpu_torch.apiserver.store import Store
        store = Store()
        store.validation_enabled = False
        sched = client_mod.WireScheduler(store, endpoint=endpoint, batch_size=8,
                                         transport=transport, wire_pipeline_depth=depth,
                                         batch_deadline_ms=0)
        if sched._wire_pipeline is not None:
            sched._wire_pipeline.depth = 1
        _build_cluster(_api(client_pkg), store)
        sched.run_until_settled()
        if hasattr(sched, "close"):
            sched.close()
        return {"placed": {k: p.spec.node_name for k, p in store.pods.items()},
                "metrics": {k: sched.metrics[k] for k in ("schedule_attempts", "scheduled")},
                "pending": dict(sched.queue.pending_pods()),
                "batches": service.batch_counter}
    finally:
        if transport == "grpc":
            server.stop(0)
        else:
            server.shutdown()
            server.server_close()


@pytest.mark.parametrize("depth", [0, 3])
def test_grpc_placements_equal_http_and_jax(depth):
    """The port over gRPC == the port over HTTP == the JAX client over gRPC,
    with each package's client against the other's server too."""
    port_grpc = _run("port", "port", "grpc", depth)
    assert all(port_grpc["placed"].values()) and port_grpc["batches"] == 3
    assert _run("port", "port", "http", depth) == port_grpc
    assert _run("jax", "jax", "grpc", depth) == port_grpc
    assert _run("port", "jax", "grpc", depth) == port_grpc
    assert _run("jax", "port", "grpc", depth) == port_grpc


def test_preemption_hints_over_grpc():
    """A high-priority pod that does not fit preempts through the hints the
    port's service sends back over gRPC."""
    from kubernetes_tpu_torch.api.types import ObjectMeta, PriorityClass
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.service import WireScheduler

    _service, server, endpoint = _serve("port", batch_size=16)
    try:
        api = torch_api()
        store = Store()
        store.create_priority_class(PriorityClass(meta=ObjectMeta(name="high", namespace=""),
                                                  value=1000))
        sched = WireScheduler(store, endpoint=endpoint, batch_size=8, transport="grpc",
                              batch_deadline_ms=0)
        store.create_node(api.make_node("n0").capacity(
            {"cpu": "2", "memory": "4Gi", "pods": 10}).obj())
        store.create_pod(api.make_pod("low").req({"cpu": "1800m"}).obj())
        sched.run_until_settled()
        hi = api.make_pod("hi").req({"cpu": "1500m"}).obj()
        hi.spec.priority = 1000
        store.create_pod(hi)
        sched.run_until_settled()
        assert sched.nominations or store.get_pod("default/hi").spec.node_name == "n0"
        low = store.get_pod("default/low")
        assert low is None or not low.spec.node_name
        sched.close()
    finally:
        server.stop(0)


def test_two_grpc_clients_on_one_service_never_oversubscribe():
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.service import WireScheduler

    _service, server, endpoint = _serve("port", batch_size=32)
    try:
        api = torch_api()
        store = Store()
        for i in range(2):
            store.create_node(api.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "8Gi", "pods": 10}).obj())
        a, b = (WireScheduler(store, endpoint=endpoint, batch_size=4, transport="grpc",
                              client_id=cid, wire_pipeline_depth=0, batch_deadline_ms=0,
                              pod_initial_backoff=0.05, pod_max_backoff=0.1)
                for cid in ("A", "B"))
        for i in range(8):  # 8 x 1 cpu == 2 nodes x 4 cpu: an exact fill
            store.create_pod(api.make_pod(f"p{i}").req({"cpu": "1"}).obj())
        for _ in range(50):
            a.schedule_batch_cycle()
            b.schedule_batch_cycle()
            if all(p.spec.node_name for p in store.pods.values()):
                break
            a.queue.flush_backoff_completed()
            b.queue.flush_backoff_completed()
        per_node = {}
        for p in store.pods.values():
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + 1
        assert per_node == {"n0": 4, "n1": 4}
        a.close()
        b.close()
    finally:
        server.stop(0)


def test_grpc_fabric_fails_over():
    """The device fabric over gRPC: the primary killed after the first
    batch, one transient failover, every pod bound once on the standby."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_basic(60, 40, 40)
    run = workloads.run_loop_wire(w, "cpu", 0, batch_size=16, percentage=100,
                                  transport="grpc", fabric_replicas=2, kill_primary_after=1)
    assert all(run["placed"].values()) and run["placements"] == run["binds"] == 80
    assert run["failovers"] == {"transient": 1} and run["active"] == 1
    assert not run["double_binds"] and not run["over_capacity"]
    assert [r["batches"] for r in run["per_replica"]][0] == 1
    assert 0 < run["promote_ms"] < run["failover_ms"]


# ------------------------------------------------------------ the schema


def test_vendored_descriptor_matches_the_generator_and_jax():
    """The port's vendored module is what ``tools/gen_pb2.py``'s
    ``build_file_descriptor`` makes from the port's ``.proto`` (``tools/gen_torch_pb2.py --check``),
    and its serialized descriptor is the JAX package's, byte for byte."""
    from kubernetes_tpu.native import ktpu_device_pb2 as jpb2
    from kubernetes_tpu_torch.native import ktpu_device_pb2 as tpb2
    from tools import gen_pb2, gen_torch_pb2

    with open(gen_torch_pb2.PROTO) as f:
        package, messages = gen_pb2.parse_proto(f.read())
    built = gen_pb2.build_file_descriptor(package, messages, "ktpu_device.proto")
    assert tpb2.DESCRIPTOR.serialized_pb == built.SerializeToString()
    assert tpb2.DESCRIPTOR.serialized_pb == jpb2.DESCRIPTOR.serialized_pb
    assert package == "ktpu.v1" and _gs("port").SERVICE == _gs("jax").SERVICE
    with open(gen_torch_pb2.OUT, encoding="utf-8") as f:
        assert f.read() == gen_torch_pb2.generate()


def test_stale_schema_without_protoc_names_the_fix(monkeypatch):
    """A hash that no longer matches the .proto rejects the vendored module
    before importing it: no protoc is tried, and the call raises
    PermanentDeviceError naming the generator."""
    from kubernetes_tpu_torch.backend.errors import PermanentDeviceError
    from kubernetes_tpu_torch.native import ktpu_device_pb2 as vendored

    gs = _gs("port")
    assert gs._vendored_hash() == vendored.PROTO_SHA256 == gs._proto_sha256()
    monkeypatch.setattr(gs, "_proto_sha256", lambda: "0" * 64)
    monkeypatch.setattr(gs, "_pb2", None)
    with pytest.raises(PermanentDeviceError, match="tools/gen_torch_pb2.py"):
        gs.pb2()


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("order", ["port_first", "jax_first"])
def test_both_pb2_modules_load_in_one_process(order):
    mods = ["kubernetes_tpu_torch.native.ktpu_device_pb2", "kubernetes_tpu.native.ktpu_device_pb2"]
    if order == "jax_first":
        mods.reverse()
    out = _python("import importlib\n"
                  + "".join(f"m{i} = importlib.import_module({m!r})\n" for i, m in enumerate(mods))
                  + "assert m0.DESCRIPTOR.serialized_pb == m1.DESCRIPTOR.serialized_pb\n"
                  "print(m1.PodRef.FromString(m0.PodRef(name='x').SerializeToString()).name)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "x"


def test_port_imports_and_serves_http_without_grpc():
    """With grpc and google.protobuf unimportable, the port's service module
    imports and a WireScheduler over HTTP (one endpoint and a fabric) binds
    its pods; asking for gRPC raises ImportError."""
    out = _python(
        "import sys\n"
        "sys.modules['grpc'] = None\n"
        "sys.modules['google.protobuf'] = None\n"
        "from kubernetes_tpu_torch.backend import service, fabric\n"
        "from kubernetes_tpu_torch.api.wrappers import make_node, make_pod\n"
        "from kubernetes_tpu_torch.apiserver.store import Store\n"
        "servers = []\n"
        "for n in (1, 2):\n"
        "    new = [service.serve(service.DeviceService(batch_size=8, device='cpu'))"
        " for _ in range(n)]\n"
        "    servers += new\n"
        "    endpoint = [f'http://127.0.0.1:{p}' for _s, p in new]\n"
        "    store = Store()\n"
        "    store.create_node(make_node('n0').capacity({'cpu': '4', 'memory': '8Gi',"
        " 'pods': 10}).obj())\n"
        "    store.create_pod(make_pod('p').req({'cpu': '1'}).obj())\n"
        "    sched = service.WireScheduler(store, endpoint=endpoint, batch_size=8,"
        " batch_deadline_ms=0)\n"
        "    sched.run_until_settled()\n"
        "    sched.close()\n"
        "    assert store.get_pod('default/p').spec.node_name == 'n0'\n"
        "try:\n"
        "    service.WireScheduler(Store(), endpoint='127.0.0.1:1', transport='grpc')\n"
        "except ImportError:\n"
        "    print('no grpc')\n"
        "for s, _p in servers:\n"
        "    service.stop(s)\n"
        "assert 'grpc' not in [m for m in sys.modules if sys.modules[m] is not None]\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no grpc"
