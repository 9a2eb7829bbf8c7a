"""The port's scheduler binary and API server binary
(``kubernetes_tpu_torch/cmd/``) against the JAX package's, on the CPU.

- ``ComponentServer``: /healthz, /readyz, /configz, /metrics, /debug and
  404s answer with the same status and body in both packages.
- The /debug family over ``SchedulerApp`` (the JAX sequential scheduler
  against the port's loop driven through ``schedule_one``, and both
  ``TPUScheduler``s): the index, the queue, the cache, the quota cohort
  view, the flight recorder, ``?limit=`` caps, /debug/devicestate and
  /debug/slices off the host mirror, /debug/sessions on a
  ``WireScheduler``.
- ``SchedulerApp``: leader election gating the loop, /configz; ``setup``'s
  feature gates and its informer topology (``use_informers=True``), whose
  placements equal JAX's.
- The binaries: ``main(["--simulate", ...])`` in process and
  ``python -m kubernetes_tpu_torch.cmd.server``, and
  ``python -m kubernetes_tpu_torch.cmd.apiserver`` serving and restoring
  its WAL.
- The device rule: ``setup``, ``SchedulerApp`` and ``main`` raise without a
  card when no device is named; ``utils/platform.force_cpu`` hides it."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from test_torch_controllers import CKit, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("KTPU_PIPELINE", "KTPU_PIPELINE_DEPTH", "KTPU_COMMIT_WORKER", "KTPU_FULL_BATCH",
                "KTPU_SPEC", "KTPU_LEDGER", "KTPU_TELEMETRY", "KTPU_TRACE_FILE",
                "KTPU_LOCKTRACE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("KTPU_BATCH_DEADLINE_MS", "0")


class SKit(CKit):
    """``CKit`` with the scheduler binary."""

    def __init__(self, pkg: str):
        super().__init__(pkg)
        if pkg == "jax":
            from kubernetes_tpu.backend import telemetry
            from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
            from kubernetes_tpu.cmd import server
            from kubernetes_tpu.metrics import registry
            from kubernetes_tpu.utils import featuregate, tracing
        else:
            from kubernetes_tpu_torch.backend import telemetry
            from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
            from kubernetes_tpu_torch.cmd import server
            from kubernetes_tpu_torch.metrics import registry
            from kubernetes_tpu_torch.utils import featuregate, tracing
        self.server, self.registry, self.featuregate = server, registry, featuregate
        self.telemetry, self.tracing = telemetry, tracing
        self._tpu = TPUScheduler

    def app(self, store, **kw):
        """The package's ``SchedulerApp`` (the port's on the CPU)."""
        if self.pkg == "port":
            kw.setdefault("device", "cpu")
        return self.server.SchedulerApp(store, **kw)

    def setup(self, store, **kw):
        """The package's ``setup``. The port's takes no ``tpu`` (it always
        builds its batch loop; ``SchedulerApp(tpu=...)`` picks how it is
        driven), so the flag is dropped for it."""
        if self.pkg == "port":
            kw.setdefault("device", "cpu")
            kw.pop("tpu", None)
        return self.server.setup(store, **kw)

    def tpu(self, store, **kw):
        """The package's batch loop (the port's on the CPU)."""
        if self.pkg == "port":
            kw.setdefault("device", "cpu")
        return self._tpu(store, **kw)


SKITS = {pkg: SKit(pkg) for pkg in ("jax", "port")}


def srun(script):
    return run(lambda k: script(SKITS[k.pkg]))


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _nodes(k, store, n, cpu="4", pods=10):
    for i in range(n):
        store.create_node(k.make_node(f"n{i}").capacity(
            {"cpu": cpu, "memory": "8Gi", "pods": pods}).obj())


# ---------------------------------------------------------------- ComponentServer


def test_component_server_mux():
    def script(k):
        reg = k.registry.Registry()
        c = k.registry.Counter("test_requests_total", "help")
        reg.register(c)
        c.inc()
        srv = k.server.ComponentServer(configz={"a": {"b": 1}}, registry=reg,
                                       ready_fn=lambda: False,
                                       debug={"echo": lambda limit=None: {"limit": limit}})
        port = srv.start()
        try:
            return [_get(port, p) for p in ("/healthz", "/readyz", "/configz", "/metrics",
                                             "/debug", "/debug/echo", "/debug/echo?limit=2",
                                             "/debug/nope", "/nope")]
        finally:
            srv.stop()

    out = srun(script)
    assert out[0] == (200, "ok") and out[1] == (500, "not ready")
    assert json.loads(out[2][1]) == {"a": {"b": 1}} and "test_requests_total 1" in out[3][1]
    assert json.loads(out[6][1]) == {"limit": 2} and out[7][0] == 404 and out[8][0] == 404


# ---------------------------------------------------------------- the /debug family


DEBUG_ENDPOINTS = {"/debug/queue", "/debug/cache", "/debug/devicestate", "/debug/slices",
                   "/debug/spans", "/debug/circuit", "/debug/sessions", "/debug/fabric",
                   "/debug/flightrecorder", "/debug/quota", "/debug/locktrace",
                   "/debug/ledger", "/debug/timeline", "/debug/dispatch", "/debug/rebalance"}


def test_debug_mux_over_http():
    def script(k):
        store = k.new_store()
        _nodes(k, store, 3)
        app = k.app(store, raw_config=None)
        port = app.server.start()
        out = {}
        try:
            store.create_pod(k.make_pod("ok").req({"cpu": "100m"}).obj())
            store.create_pod(k.make_pod("huge").req({"cpu": "64"}).obj())
            app.tick()
            status, body = _get(port, "/debug")
            index = json.loads(body)["endpoints"]
            out["index"] = (status, index)
            for ep in index:
                status, body = _get(port, ep)
                out[ep] = (status, json.loads(body))
            k.tracing.enable()
            try:
                with k.tracing.span("probe"):
                    pass
                status, body = _get(port, "/debug/spans")
                out["spans"] = (status, [s["name"] for s in json.loads(body)])
            finally:
                k.tracing.disable()
            out["nope"] = _get(port, "/debug/nope")[0]
        finally:
            app.server.stop()
        out.pop("/debug/spans")  # the tail of the process-wide exporter
        queue = out["/debug/queue"][1]
        for e in queue["unschedulable"]:
            e.pop("parkedFor")  # wall time parked
        timeline = out.pop("/debug/timeline")
        out["timeline"] = (timeline[0], isinstance(timeline[1]["traceEvents"], list))
        return out

    out = srun(script)
    assert set(out["index"][1]) == DEBUG_ENDPOINTS
    assert all(out[ep][0] == 200 for ep in DEBUG_ENDPOINTS - {"/debug/spans", "/debug/timeline"})
    q = out["/debug/queue"][1]
    assert q["counts"]["unschedulable"] == 1 and q["unschedulable"][0]["pod"] == "default/huge"
    assert "NodeResourcesFit" in q["unschedulable"][0]["unschedulablePlugins"]
    cache = out["/debug/cache"][1]
    assert cache["nodes"] == 3 and cache["pods"] >= 1 and cache["inSync"] is True
    for ep in ("/debug/devicestate", "/debug/circuit", "/debug/ledger", "/debug/rebalance",
               "/debug/fabric", "/debug/locktrace"):
        assert out[ep][1] == {"enabled": False}, ep
    assert out["spans"] == (200, ["probe"]) and out["nope"] == 404


def test_debug_limit_caps_unbounded_dumps():
    def script(k):
        store = k.new_store()
        _nodes(k, store, 3, cpu="32", pods=110)
        app = k.app(store, raw_config=None)
        port = app.server.start()
        try:
            for i in range(8):
                store.create_pod(k.make_pod(f"huge{i}").req({"cpu": "640"}).obj())
            app.tick()
            out = []
            for path in ("/debug/queue?limit=3", "/debug/queue", "/debug/queue?limit=0",
                         "/debug/queue?limit=bogus", "/debug/cache?limit=1000",
                         "/debug/spans?limit=0"):
                status, body = _get(port, path)
                doc = json.loads(body)
                if isinstance(doc, dict):
                    for e in doc.get("unschedulable", ()):
                        e.pop("parkedFor")
                out.append((status, doc))
            return out + [k.server.DEFAULT_DEBUG_LIMIT]
        finally:
            app.server.stop()

    out = srun(script)
    capped, whole = out[0][1], out[1][1]
    assert capped["counts"]["unschedulable"] == 8 and len(capped["unschedulable"]) == 3
    assert capped["truncated"]["unschedulable"] == 8
    assert len(whole["unschedulable"]) == 8 and "truncated" not in whole
    assert out[2][1]["unschedulable"] == [] and out[3][0] == 200
    assert "truncated" not in out[4][1] and out[5] == (200, [])


def test_debug_quota_cohort_view():
    def script(k):
        t = k.types
        store = k.new_store()
        store.create_node(k.make_node("n0").capacity(
            {"cpu": "32", "memory": "64Gi", "pods": 64}).obj())
        for ns in ("team-a", "team-b"):
            store.create_namespace(t.Namespace(meta=t.ObjectMeta(name=ns)))
            store.create_object("SchedulingQuota", t.SchedulingQuota(
                meta=t.ObjectMeta(name="q", namespace=ns), hard={"pods": 3}, cohort="ml"))
        app = k.app(store, raw_config=None)
        port = app.server.start()
        try:
            for i in range(5):
                store.create_pod(k.make_pod(f"b{i}", namespace="team-b").req(
                    {"cpu": "100m"}).obj())
            app.tick()
            out = [json.loads(_get(port, "/debug/quota")[1]),
                   json.loads(_get(port, "/debug/quota?limit=1")[1])]
        finally:
            app.server.stop()
        for doc in out:
            for loan in doc["cohorts"]["ml"]["loans"]:
                loan.pop("since", None)
        return out

    out = srun(script)
    ml = out[0]["cohorts"]["ml"]
    assert sorted(ml["members"]) == ["team-a", "team-b"] and ml["lent"]["pods"] == 2
    assert out[0]["namespaces"]["team-b"]["borrowed"]["pods"] == 2
    assert out[1]["cohorts"]["ml"]["loansTruncated"] == 2


def test_debug_flightrecorder_endpoint():
    def script(k):
        store = k.new_store()
        app = k.app(store, raw_config=None)
        port = app.server.start()
        try:
            out = [_get(port, "/debug/flightrecorder")]
            t = k.telemetry.enable()
            for i in range(5):
                t.event("dispatch", batchId=f"b{i}")
            doc = json.loads(_get(port, "/debug/flightrecorder?limit=2")[1])
            out.append([doc["enabled"], doc["ring"]["held"],
                        [e["batchId"] for e in doc["events"]], doc["truncated"],
                        "compile" in doc, "transfer" in doc])
        finally:
            k.telemetry.disable()
            app.server.stop()
        return out

    out = srun(script)
    assert json.loads(out[0][1]) == {"enabled": False}
    assert out[1] == [True, 5, ["b3", "b4"], {"events": 5}, True, True]


def test_devicestate_and_slices_on_the_batch_loop():
    """/debug/devicestate and /debug/slices over each package's batch loop:
    the same body (the batch sizer's wall-clock fit left out), read off the
    host mirror."""
    def script(k):
        from kubernetes_tpu_torch.ops.encode import TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL

        store = k.new_store()
        for i in range(8):
            store.create_node(k.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "8Gi", "pods": 10})
                .label(TOPO_SUPERPOD_LABEL, str(i // 4)).label(TOPO_SLOT_LABEL, str(i % 4)).obj())
        sched = k.tpu(store, batch_size=8, batch_deadline_ms=0)
        for i in range(5):
            store.create_pod(k.make_pod(f"p{i}").req({"cpu": "100m"}).obj())
        sched.run_until_settled()
        handlers = k.server.build_debug_handlers(sched)
        dev = json.loads(json.dumps(handlers["devicestate"](), default=str))
        for key in ("a", "b", "updates"):
            dev["batchSizer"].pop(key)
        capped = handlers["devicestate"](limit=3)
        return [dev, handlers["slices"](), handlers["slices"](limit=1),
                capped["topology"]["nodes"], capped["topology"]["nodesTruncated"]]

    out = srun(script)
    dev = out[0]
    assert dev["enabled"] is True and dev["nodesMirrored"] == 8 and dev["batchCounter"] >= 1
    assert dev["topology"]["chipsPerNode"] == 4 and len(dev["topology"]["nodes"]) == 8
    assert len(out[1]["superpods"]) == 2 and sum(r["used"] for r in out[1]["superpods"]) == 5
    assert out[2]["superpodsTruncated"] == 2 and len(out[3]) == 3 and out[4] == 8


def test_debug_sessions_on_wire_scheduler():
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.service import DeviceService, WireScheduler, serve, stop
    from kubernetes_tpu_torch.cmd.server import ComponentServer, build_debug_handlers

    service = DeviceService(batch_size=16, device="cpu")
    dev_server, dev_port = serve(service)
    try:
        store = Store()
        sched = WireScheduler(store, endpoint=f"http://127.0.0.1:{dev_port}", batch_size=8,
                              client_id="muxed")
        store.create_node(make_node("n0").capacity({"cpu": "4", "memory": "8Gi",
                                                    "pods": 10}).obj())
        store.create_pod(make_pod("p0").req({"cpu": "500m"}).obj())
        sched.run_until_settled()
        srv = ComponentServer(configz={}, debug=build_debug_handlers(sched))
        port = srv.start()
        try:
            doc = json.loads(_get(port, "/debug/sessions")[1])
            circuit = json.loads(_get(port, "/debug/circuit")[1])
        finally:
            srv.stop()
            sched.close()
    finally:
        stop(dev_server)
    assert doc["enabled"] is True and doc["clientId"] == "muxed"
    row = {s["clientId"]: s for s in doc["service"]["sessions"]}["muxed"]
    assert row["deltaSeq"] >= 1 and row["batches"] >= 1 and row["fenced"] is False
    assert circuit["state"] == "closed"


# ---------------------------------------------------------------- SchedulerApp and setup


def test_app_schedules_serves_and_elects():
    def script(k):
        store = k.new_store()
        _nodes(k, store, 5)
        app = k.app(store, raw_config={"apiVersion": "kubescheduler.config.k8s.io/v1beta3",
                                       "leaderElection": {"leaderElect": True}})
        app.server.start()
        try:
            for i in range(10):
                store.create_pod(k.make_pod(f"p{i}").req({"cpu": "100m"}).obj())
            app.tick()
            configz = _get(app.server.port, "/configz")
            metrics = _get(app.server.port, "/metrics")[0]
        finally:
            app.server.stop()
        lease = store.get_lease("kube-system/kube-scheduler")
        standby = k.app(store, raw_config=None, identity="b")
        store.create_pod(k.make_pod("late").req({"cpu": "100m"}).obj())
        return [sorted(k2 for k2, p in store.pods.items() if p.spec.node_name),
                lease.holder_identity, configz, metrics, standby.tick(), app.tick() > 0]

    out = srun(script)
    assert len(out[0]) == 10 and out[1] == "kube-scheduler-0"
    assert "kubescheduler.config.k8s.io" in out[2][1] and out[3] == 200
    assert out[4] == 0 and out[5]


def test_debug_queue_under_the_queue_lock():
    """/debug/queue is served from the mux's thread while the loop's thread
    pushes and pops, so ``SchedulingQueue.dump`` holds the queue's lock, as
    JAX's does: no other thread can take the lock while a dump runs, and GETs
    made while ``app.run()`` schedules pods of three quota tenants (the
    fair-share heaps that the dump walks) all answer 200 with every pod
    placed."""
    def script(k):
        t = k.types
        store = k.new_store()
        _nodes(k, store, 4, pods=20)
        for i in range(3):
            store.create_namespace(t.Namespace(meta=t.ObjectMeta(name=f"ns{i}")))
            store.create_object("SchedulingQuota", t.SchedulingQuota(
                meta=t.ObjectMeta(name="q", namespace=f"ns{i}"), hard={"pods": 100}))
        app = k.app(store, raw_config=None)
        q = app.sched.queue
        now_fn, probes = q.now_fn, []

        def probing_now():
            # another thread tries the queue's lock while dump is running
            def attempt():
                got = q._lock.acquire(blocking=False)
                if got:
                    q._lock.release()
                probes.append(got)

            probe = threading.Thread(target=attempt)
            probe.start()
            probe.join(10)
            return now_fn()

        q.now_fn = probing_now
        counts = q.dump()["counts"]
        q.now_fn = now_fn
        thread = app.run(tick_interval=0.001)
        statuses = []
        try:
            for i in range(60):
                store.create_pod(k.make_pod(f"p{i}", namespace=f"ns{i % 3}").req(
                    {"cpu": "100m"}).obj())
                statuses.append(_get(app.server.port, "/debug/queue")[0])
            for _ in range(2000):
                if all(p.spec.node_name for p in store.pods.values()):
                    break
                statuses.append(_get(app.server.port, "/debug/queue")[0])
        finally:
            app.stop()
            thread.join(30)
        return [probes, counts, set(statuses),
                sum(1 for p in store.pods.values() if p.spec.node_name)]

    out = srun(script)
    assert out[0] == [False]
    assert out[1] == {"active": 0, "backoff": 0, "unschedulable": 0, "gated": 0}
    assert out[2] == {200} and out[3] == 60


def test_setup_with_feature_gates():
    def script(k):
        gate = k.featuregate.DEFAULT_FEATURE_GATE
        saved = dict(gate._enabled)
        try:
            sched = k.setup(k.new_store(), raw=None, feature_gates="PodOverhead=false")
            out = [type(sched).__name__ != "", gate.enabled("PodOverhead")]
            with pytest.raises(ValueError):
                k.setup(k.new_store(), raw=None, feature_gates="DefaultPodTopologySpread=false")
        finally:
            gate._enabled.clear()
            gate._enabled.update(saved)
        return out

    assert srun(script) == [True, False]


@pytest.mark.parametrize("tpu", [True, False])
def test_setup_informer_topology_places_as_jax(tpu):
    """``setup(use_informers=True)``: pod and node events reach the loop
    through a ``SharedInformerFactory`` pumped each cycle (JAX
    ``scheduler/scheduler.py:294-300``, ``:462-463``,
    ``backend/tpu_scheduler.py:502-510``). The JAX setup builds its batch
    loop with ``tpu`` and its sequential ``Scheduler`` without; the port
    builds its loop both times, and runs it through ``schedule_one`` alone
    without. Placements, the pods popped and the cache equal JAX's."""
    def script(k):
        store = k.new_store()
        clock = k.FakeClock()
        _nodes(k, store, 6, cpu="2")
        kw = dict(now_fn=clock)
        if tpu:
            kw.update(batch_size=8, batch_deadline_ms=0)
        sched = k.setup(store, raw={"percentageOfNodesToScore": 100}, use_informers=True,
                        tpu=tpu, **kw)
        out = [type(sched.informer_factory).__name__]
        for i in range(20):
            store.create_pod(k.make_pod(f"p{i}").req({"cpu": "300m"}).obj())
        store.create_node(k.make_node("late").capacity(
            {"cpu": "8", "memory": "8Gi", "pods": 10}).obj())
        if tpu:
            sched.run_until_settled()
        else:
            k.server.settle_sequential(sched) if k.pkg == "port" else sched.run_until_settled()
        out.append({key: p.spec.node_name for key, p in sorted(store.pods.items())})
        out.append(sched.cache.stats()[:2])
        out.append(sched.queue.pending_pods())
        return out

    out = srun(script)
    assert out[0] == "SharedInformerFactory"
    assert sum(1 for n in out[1].values() if n) == 20


def test_main_simulate_in_process(capsys):
    from kubernetes_tpu_torch.cmd.server import main

    assert main(["--simulate", "nodes=50,pods=200", "--port", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "simulation complete: 200 pods bound" in out and "device=cpu" in out


def test_binaries_run_as_modules(tmp_path):
    """``python -m kubernetes_tpu_torch.cmd.server --simulate`` to its end,
    and ``python -m kubernetes_tpu_torch.cmd.apiserver`` with a WAL and
    token auth: served over HTTP, stopped, restarted, the state restored."""
    r = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.server", "--simulate",
                        "nodes=20,pods=40", "--port", "0", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, env=ENV, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "simulation complete: 40 pods bound" in r.stdout

    wal = str(tmp_path / "store.wal")
    tokens = tmp_path / "tokens.csv"
    tokens.write_text('tok-admin,admin,uid1,"system:masters"\n')

    def launch():
        return subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.apiserver", "--port", "0",
             "--wal", wal, "--token-auth-file", str(tokens), "--authorization-mode", "RBAC"],
            env=ENV, cwd=REPO, stderr=subprocess.PIPE, text=True)

    def read_port(proc, timeout=60.0):
        killer = threading.Timer(timeout, proc.kill)
        killer.start()
        try:
            for line in proc.stderr:
                if "listening on" in line:
                    return int(line.split("127.0.0.1:")[1].split()[0])
            raise AssertionError("apiserver exited before listening")
        finally:
            killer.cancel()

    admin = {"Authorization": "Bearer tok-admin", "Content-Type": "application/json"}
    proc = launch()
    try:
        port = read_port(proc)
        body = json.dumps({"meta": {"name": "n1"},
                           "status": {"capacity": {"cpu": "4"}}}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/nodes", data=body,
                                     headers=admin, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 201
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/nodes",
                                     data=json.dumps({"meta": {"name": "n2"}}).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 403
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    proc = launch()
    try:
        port = read_port(proc)
        status, body = _get(port, "/api/v1/nodes/n1", {"Authorization": "Bearer tok-admin"})
        assert status == 200 and json.loads(body)["meta"]["name"] == "n1"
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0


def test_apiserver_build_auth_matches_jax(tmp_path):
    import argparse

    from kubernetes_tpu.cmd import apiserver as japi
    from kubernetes_tpu_torch.cmd import apiserver as tapi

    tokens = tmp_path / "tokens.csv"
    tokens.write_text('# comment\ntok-a,alice,u1,"g1,g2"\ntok-b,bob,u2\n')
    shapes = []
    for mod, store in ((japi, SKITS["jax"].new_store()), (tapi, SKITS["port"].new_store())):
        args = argparse.Namespace(token_auth_file=str(tokens), authorization_mode="Node,RBAC",
                                  enable_priority_and_fairness=True)
        cfg = mod.build_auth(args, store)
        shapes.append((type(cfg.authorizer).__name__, type(cfg.authorizer.delegate).__name__,
                       type(cfg.flow).__name__,
                       {t: (u.name, tuple(u.groups))
                        for t, u in cfg.authenticator.tokens.items()}))
        bad = argparse.Namespace(token_auth_file="", authorization_mode="ABAC",
                                 enable_priority_and_fairness=False)
        with pytest.raises(SystemExit):
            mod.build_auth(bad, store)
        none = argparse.Namespace(token_auth_file="", authorization_mode="",
                                  enable_priority_and_fairness=False)
        assert mod.build_auth(none, store) is None
    assert shapes[0] == shapes[1]
    assert shapes[1][3]["tok-a"] == ("alice", ("g1", "g2"))


# ---------------------------------------------------------------- the device rule


def test_entry_points_raise_without_a_card(monkeypatch):
    import torch

    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.cmd import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.setup(Store())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.SchedulerApp(Store(), tpu=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.setup(Store(), device_endpoints="http://127.0.0.1:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--simulate", "nodes=2,pods=2", "--port", "0"])


def test_force_cpu_hides_the_card():
    """In a fresh interpreter ``force_cpu()`` hides the card before CUDA is
    touched: an entry point without a device then raises, on any machine."""
    code = ("from kubernetes_tpu_torch.utils.platform import force_cpu; force_cpu()\n"
            "import os, torch\n"
            "assert os.environ['CUDA_VISIBLE_DEVICES'] == '' and not torch.cuda.is_available()\n"
            "from kubernetes_tpu_torch.apiserver.store import Store\n"
            "from kubernetes_tpu_torch.cmd.server import setup\n"
            "try:\n"
            "    setup(Store())\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=ENV, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "raised: no CUDA device" in r.stdout
