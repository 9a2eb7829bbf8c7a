"""kube-scheduler in front of a kubemark cluster: the scheduler binary's
``SchedulerApp`` (``cmd/server.py``), the controller manager and a fleet of
hollow kubelets (``kubelet/kubemark.py``) over one store on one FakeClock,
as the JAX package's ``tests/test_node_agent_cli.py::TestKubemark`` runs
them, at any size.

``run_kubemark`` builds the cluster (``HollowCluster(store, n_nodes,
with_runtime=True)``: JAX's ``default_node``, cpu 8, 32Gi, 110 pods, three
zones, each kubelet with a ``FakeRuntimeService`` and a PLEG), the scheduler
(``SchedulerApp(store, tpu=True, device=...)``, leader election on through
the store's Lease, its ``ComponentServer`` on port 0, the informer topology)
and a ``ControllerManager`` with the deployment, replicaset and endpoints
controllers. The workload is a Service and a Deployment of ``replicas``
pods of ``cpu: 500m``. Each turn settles the manager, runs one leader-gated
``app.tick()`` and one fleet ``cluster.tick()``, until every pod is Running
(at most ``max_turns``). The binding writes phase Running (the store's
binding subresource, as JAX's), so a kubelet's sync finds its pods Running
and starts their sandboxes in its fake runtime; one more fleet tick lets
each PLEG relist them (a ContainerStarted event per pod). The manager
settles once more for the Endpoints.

The record holds what must repeat on another device (placements, every
Pod, Node, Lease and Endpoints object in wire form with its resource
version, the device-read tallies, the /debug/devicestate body without the
batch sizer's wall-clock fit, the /debug/cache drift report) and what need
not (seconds, fused launches)."""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Dict, Optional

from ..api import codec
from ..api.types import Deployment, ObjectMeta, Service
from ..api.wrappers import make_pod
from ..apiserver.store import Store
from ..client.informer import SharedInformerFactory
from ..cmd.server import SchedulerApp
from ..controllers import ControllerManager
from ..kubelet import HollowCluster
from ..ops import fused_step
from ..utils import relay
from ..utils.clock import FakeClock
from ..utils.device import DeviceLike

KINDS = ("Pod", "Node", "Lease", "Endpoints")
# stamped from the wall clock by the store
WALL_FIELDS = ("creation_timestamp",)
ENDPOINTS = ("/healthz", "/configz", "/metrics", "/debug/devicestate", "/debug/cache")


def _norm(v):
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items() if k not in WALL_FIELDS}
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


def objects(store: Store) -> Dict[str, dict]:
    """Every object of ``KINDS`` in wire form, resource versions included."""
    return {kind: {key: _norm(codec.to_wire(obj))
                   for key, obj in sorted(store.snapshot_map(kind).items())}
            for kind in KINDS}


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.read().decode()


def run_kubemark(device: DeviceLike, nodes: int = 5000, replicas: int = 2000,
                 max_turns: int = 10, raw_config: Optional[dict] = None,
                 batch_size: int = 128) -> dict:
    """The kubemark run on ``device`` (None: the card); see the module doc.
    The loop pops whole batches (``batch_deadline_ms=0``)."""
    t_phase = time.perf_counter()
    clock = FakeClock()
    store = Store(now_fn=clock)
    cluster = HollowCluster(store, n_nodes=nodes, now_fn=clock, with_runtime=True)
    t = time.perf_counter()
    cluster.register_all()
    register_s = time.perf_counter() - t
    app = SchedulerApp(store, raw_config=raw_config, tpu=True, device=device, now_fn=clock,
                       batch_size=batch_size, batch_deadline_ms=0)
    manager = ControllerManager(store, factory=SharedInformerFactory(store),
                                controllers=["deployment", "replicaset", "endpoints"],
                                now_fn=clock)
    store.create_service(Service(meta=ObjectMeta(name="web"), selector={"app": "web"}))
    template = make_pod("t").req({"cpu": "500m"}).label("app", "web").obj()
    store.create_object("Deployment", Deployment(meta=ObjectMeta(name="web"),
                                                 replicas=replicas, template=template))
    port = app.server.start()
    launches0 = fused_step.LAUNCHES
    seconds = {"controllers": 0.0, "scheduler": 0.0, "kubelets": 0.0}
    turns, transitions = 0, 0
    try:
        with relay.track() as reads:
            for _ in range(max_turns):
                turns += 1
                t = time.perf_counter()
                manager.settle()
                t1 = time.perf_counter()
                app.tick()
                t2 = time.perf_counter()
                transitions += cluster.tick()
                t3 = time.perf_counter()
                seconds["controllers"] += t1 - t
                seconds["scheduler"] += t2 - t1
                seconds["kubelets"] += t3 - t2
                pods = store.snapshot_map("Pod").values()
                if len(pods) == replicas and all(p.status.phase == "Running" for p in pods):
                    break
            t = time.perf_counter()
            transitions += cluster.tick()  # the PLEG relists the sandboxes started
            t1 = time.perf_counter()
            manager.settle()
            seconds["kubelets"] += t1 - t
            seconds["controllers"] += time.perf_counter() - t1
        http = {}
        for path in ENDPOINTS:
            status, body = _get(port, path)
            http[path] = status
            if path == "/debug/devicestate":
                devicestate = json.loads(body)
            elif path == "/debug/cache":
                cache = json.loads(body)
    finally:
        app.stop()
    sched = app.sched
    # the batch sizer's latency fit follows the wall clock, not the run
    sizer = devicestate.get("batchSizer", {})
    wall_fit = {k: sizer.pop(k, None) for k in ("a", "b", "updates")}
    pods = store.snapshot_map("Pod")
    running = sum(1 for p in pods.values() if p.status.phase == "Running")
    bound = sum(1 for p in pods.values() if p.spec.node_name)
    return {
        "placed": {k: p.spec.node_name for k, p in sorted(pods.items())},
        "objects": objects(store),
        "reads": dict(reads),
        "batches": sched.batch_counter,
        "paths": list(sched.batch_paths),
        "batch_pods": list(sched.batch_pods),
        "launches": fused_step.LAUNCHES - launches0,
        "turns": turns,
        "kubelet_ticks": turns + 1,
        "transitions": transitions,
        "running": running,
        "bound": bound,
        "pods": len(pods),
        "http": http,
        "devicestate": devicestate,
        "wall_fit": wall_fit,
        "cache": cache,
        "leader": store.get_lease("kube-system/kube-scheduler").holder_identity,
        "pleg_events": sum(k.pleg.events_emitted for k in cluster.kubelets),
        "sandboxes": sum(len(k.runtime.sandboxes) for k in cluster.kubelets),
        "seconds": dict(seconds, register=register_s, wall=time.perf_counter() - t_phase),
    }


def check_kubemark_run(name: str, run: dict, replicas: int) -> list:
    """The run's own bars: every pod Running in a sandbox that its PLEG
    reported, one commit read per batch and no other read, every endpoint
    200, the cache in sync, the scheduler the lease's holder; the faults
    found, [] when none."""
    faults = []
    if run["pods"] != replicas or run["running"] != replicas:
        faults.append(f"{name}: {run['running']} of {run['pods']} pods Running, "
                      f"want {replicas}")
    if run["reads"] != ({"commit-read": run["batches"]} if run["batches"] else {}):
        faults.append(f"{name}: device reads {run['reads']} for {run['batches']} batches")
    bad = {p: s for p, s in run["http"].items() if s != 200}
    if bad:
        faults.append(f"{name}: endpoints answered {bad}")
    cache = run["cache"]
    if not cache["inSync"]:
        faults.append(f"{name}: /debug/cache reports drift {cache}")
    if run["leader"] != "kube-scheduler-0":
        faults.append(f"{name}: the scheduler lease is held by {run['leader']}")
    if run["sandboxes"] != replicas or run["pleg_events"] != replicas:
        faults.append(f"{name}: {run['sandboxes']} sandboxes and {run['pleg_events']} "
                      f"PLEG events for {replicas} pods")
    return faults
