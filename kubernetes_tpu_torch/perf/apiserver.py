"""The scheduler loop behind the API front: a workload's nodes and pods
POSTed over HTTP to ``serve_api`` on a durable, authenticated ``Store``,
scheduled by ``TPUScheduler`` on the store, watched back by a REST
informer; and the crash of that server, restored from its write-ahead log.

``run_loop_apiserver(w, device)`` (Run A): a ``Store`` with ``attach_wal``
on a file of a temporary directory (no fsync, the JAX default), served on
127.0.0.1 with token authentication (an admin in ``system:masters`` and
``system:kube-scheduler``), RBAC (the scheduler may read pods and nodes and
create bindings) and the default flow control; the loop on the store
(``batch_deadline_ms=0``, ``percentage_of_nodes_to_score=100``); a REST
informer on Pods as the scheduler's identity (``client/rest.py``), pumped
by a thread of its own. The nodes are POSTed as core/v1 manifests, the pods
alternately as manifests and as protobuf bodies, one keep-alive connection
in order (the order the loop sees is the order the store wrote); the loop
settles after the init pods and after the measured ones.

``run_loop_apiserver(w, device, crash=True)`` (Run B, as JAX
``tests/test_wal.py:56-95``): the init pods bind, ``WriteAheadLog.snapshot``
compacts, the measured pods are POSTed, then the server, the loop and the
store are dropped with those pods unscheduled; ``restore`` rebuilds the
store, a new server and a fresh loop finish the work, and every bind is
counted: none lost, none made twice.

Both return what the checks and the report read: ``placed``, the batches
and their paths, the fused launches, the WAL's lines, records and bytes and
each bind batch's lines, ms per ``append_batch``, the creates' seconds per
codec, the informer's lag from bind to event, the restore's seconds and
the restored placements, the measured window (first measured POST to the
settle). Every time is on the host's clock."""

from __future__ import annotations

import gc
import http.client
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List

from ..api.protobuf import CONTENT_TYPE as PROTOBUF, encode_object
from ..api.scheme import default_scheme
from ..api.types import ClusterRole, ClusterRoleBinding, ObjectMeta, PolicyRule
from ..apiserver.auth import (AuthConfig, Authenticator, FlowController, RBACAuthorizer,
                              UserInfo)
from ..apiserver.http import serve_api, shutdown_api
from ..apiserver.store import Expired, Store
from ..apiserver.wal import attach_wal, restore
from ..client.informer import SharedInformerFactory
from ..client.rest import APIClient
from .workloads import LOOP_BATCH, Workload

ADMIN_TOKEN = "admin-token"
SCHEDULER_TOKEN = "scheduler-token"
SCHEDULER_USER = "system:kube-scheduler"


def _auth_config(store: Store) -> AuthConfig:
    """Tokens for the admin and the scheduler, the scheduler's RBAC role
    (created unless the store holds it: a restored store does), the default
    priority levels and flow schemas."""
    if SCHEDULER_USER not in store.cluster_roles:
        store.create_object("ClusterRole", ClusterRole(
            meta=ObjectMeta(name=SCHEDULER_USER, namespace=""),
            rules=(PolicyRule(verbs=("get", "list", "watch"), resources=("Pod", "Node")),
                   PolicyRule(verbs=("create",), resources=("Pod",),
                              subresources=("binding",)))))
        store.create_object("ClusterRoleBinding", ClusterRoleBinding(
            meta=ObjectMeta(name=SCHEDULER_USER, namespace=""), role=SCHEDULER_USER,
            subjects=(f"user:{SCHEDULER_USER}",)))
    return AuthConfig(
        authenticator=Authenticator(tokens={
            ADMIN_TOKEN: UserInfo("admin", ("system:masters",)),
            SCHEDULER_TOKEN: UserInfo(SCHEDULER_USER)}, allow_anonymous=False),
        authorizer=RBACAuthorizer(store), flow=FlowController())


CODECS = ("manifest", "protobuf")


class _Poster:
    """POSTs on one keep-alive connection as the admin; seconds and count
    per codec since the last ``reset``."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        self.reset()

    def reset(self) -> None:
        self.seconds: Dict[str, float] = dict.fromkeys(CODECS, 0.0)
        self.count: Dict[str, int] = dict.fromkeys(CODECS, 0)

    def post(self, path: str, kind: str, obj, codec: str) -> None:
        if codec == "protobuf":
            body, ctype = encode_object(kind, obj), PROTOBUF
        else:
            body, ctype = json.dumps(default_scheme().encode(obj)).encode(), "application/json"
        t0 = time.perf_counter()
        self.conn.request("POST", path, body=body, headers={
            "Content-Type": ctype, "Authorization": f"Bearer {ADMIN_TOKEN}"})
        resp = self.conn.getresponse()
        reply = resp.read()
        self.seconds[codec] += time.perf_counter() - t0
        self.count[codec] += 1
        if resp.status != 201:
            raise RuntimeError(f"POST {path} ({codec}): {resp.status} {reply[:300]!r}")

    def close(self) -> None:
        self.conn.close()


class _Watcher:
    """A REST informer on Pods as the scheduler, pumped by its own thread;
    the host time each pod's bind reached its handler."""

    def __init__(self, port: int):
        self.seen: Dict[str, float] = {}
        self.informer = SharedInformerFactory(
            APIClient(f"http://127.0.0.1:{port}", token=SCHEDULER_TOKEN)).informer_for("Pod")
        self.informer.add_event_handler(self._on_event)
        self.informer.start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="rest-informer")
        self._thread.start()

    def _on_event(self, event: str, old, new) -> None:
        if new is not None and new.spec.node_name:
            self.seen.setdefault(new.key(), time.perf_counter())

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.informer.reflector.step(timeout=0.05)
            except Expired:
                self.informer.reflector.relist()
            self.informer.pump()

    def wait_for(self, keys, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(k in self.seen for k in keys):
                return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10)
        self.informer.reflector.stop()


class _Front:
    """A served store, its loop, its informer and the counters of its
    binds; ``close`` drops them all."""

    def __init__(self, store: Store, device, batch_size: int):
        from ..backend.tpu_scheduler import TPUScheduler

        self.store = store
        self.bind_t: Dict[str, float] = {}
        self.binds: Dict[str, int] = {}
        store.add_event_handler("Pod", self._on_pod)
        self.server, self.port = serve_api(store, auth=_auth_config(store))
        self.sched = TPUScheduler(store, device=device, batch_size=batch_size,
                                  batch_deadline_ms=0, percentage_of_nodes_to_score=100)
        self.batch_lines: List[tuple] = []  # (bindings, WAL lines) per bind batch
        self.append_ms: List[float] = []
        self._instrument(store._wal)
        self.watcher = _Watcher(self.port)
        self.poster = _Poster(self.port)

    def _on_pod(self, event: str, old, new) -> None:
        if new is not None and new.spec.node_name and (old is None or not old.spec.node_name):
            self.bind_t[new.key()] = time.perf_counter()
            self.binds[new.key()] = self.binds.get(new.key(), 0) + 1

    def _instrument(self, wal) -> None:
        store, bind_batch, append_batch = self.store, self.store.bind_batch, wal.append_batch

        def counted(bindings):
            before = wal.lines_written
            out = bind_batch(bindings)
            self.batch_lines.append((len(bindings), wal.lines_written - before))
            return out

        def timed(records):
            t0 = time.perf_counter()
            append_batch(records)
            self.append_ms.append((time.perf_counter() - t0) * 1e3)

        store.bind_batch = counted
        wal.append_batch = timed

    def close(self) -> None:
        self.poster.close()
        self.watcher.close()
        self.sched.close()
        shutdown_api(self.server)


def _quantiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "max": 0.0}
    s = sorted(xs)
    return {"p50": s[len(s) // 2], "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
            "max": s[-1]}


def run_loop_apiserver(w: Workload, device, crash: bool = False,
                       batch_size: int = LOOP_BATCH) -> dict:
    """Run A (``crash=False``) or Run B (``crash=True``) of ``w`` on
    ``device``; see the module's docstring for what the dict holds."""
    from ..ops import fused_step

    tmp = tempfile.mkdtemp(prefix="ktpu-apiserver-")
    try:
        path = os.path.join(tmp, "store.wal")
        store = Store()
        wal = attach_wal(store, path)
        launches0 = fused_step.LAUNCHES
        front = _Front(store, device, batch_size)
        fronts = [front]
        t0 = time.perf_counter()
        for ni in w.node_infos():
            front.poster.post("/api/v1/nodes", "Node", ni.node, "manifest")
        nodes_s = time.perf_counter() - t0
        front.poster.reset()

        def post_pods(pods) -> None:
            for i, pod in enumerate(pods):
                front.poster.post(f"/api/v1/namespaces/{pod.meta.namespace}/pods", "Pod", pod,
                                  ("manifest", "protobuf")[i % 2])

        init, measured = w.init_pod_list(), w.measured_pod_list()
        init_keys, measured_keys = [p.key() for p in init], [p.key() for p in measured]
        post_pods(init)
        cycles = [front.sched.run_until_settled()]
        gc.collect()
        restore_s, lost, rebound, restored_placed = 0.0, [], 0, {}
        if crash:
            wal.snapshot(store)  # the compaction, then a tail of unscheduled pods
        t0 = time.perf_counter()
        post_pods(measured)
        create_s = time.perf_counter() - t0
        if crash:
            bound_before = {k: store.pods[k].spec.node_name for k in init_keys}
            front.close()  # the crash: server, loop and informer gone
            wal.close()
            t_restore = time.perf_counter()
            store = restore(path)
            restore_s = time.perf_counter() - t_restore
            lost = [k for k, n in bound_before.items() if store.pods[k].spec.node_name != n]
            front = _Front(store, device, batch_size)
            fronts.append(front)
            t1 = time.perf_counter()
            cycles.append(front.sched.run_until_settled())
            measured_s = create_s + time.perf_counter() - t1
            rebound = sum(front.binds.get(k, 0) for k in init_keys)
            seen_keys = measured_keys  # what the new server's informer saw bound
        else:
            cycles.append(front.sched.run_until_settled())
            measured_s = time.perf_counter() - t0
            seen_keys = init_keys + measured_keys
        launches = fused_step.LAUNCHES - launches0
        informer_ok = front.watcher.wait_for(seen_keys)
        bind_t = {k: t for f in fronts for k, t in f.bind_t.items()}
        lag_ms = [(front.watcher.seen[k] - bind_t[k]) * 1e3 for k in seen_keys
                  if k in front.watcher.seen and k in bind_t]
        binds: Dict[str, int] = {}
        for f in fronts:
            for k, n in f.binds.items():
                binds[k] = binds.get(k, 0) + n
        listing, _rv = APIClient(f"http://127.0.0.1:{front.port}",
                                 token=SCHEDULER_TOKEN).list_objects("Pod")
        live_wal = store._wal
        out = {
            "placed": {k: p.spec.node_name for k, p in store.pods.items()},
            "rest_placed": {p.key(): p.spec.node_name for p in listing},
            "batches": sum(f.sched.batch_counter for f in fronts),
            "paths": [p for f in fronts for p in f.sched.batch_paths],
            "batch_pods": [n for f in fronts for n in f.sched.batch_pods],
            "launches": launches, "cycles": cycles, "binds": binds, "lost": lost,
            "rebound": rebound,
            "batch_lines": [bl for f in fronts for bl in f.batch_lines],
            "append_ms": [ms for f in fronts for ms in f.append_ms],
            "wal": {"lines": live_wal.lines_written, "records": live_wal.records_appended,
                    "bytes": live_wal.bytes_written},
            "nodes_post_s": nodes_s,
            "posts": {c: sum(f.poster.count[c] for f in fronts) for c in CODECS},
            "post_s": {c: sum(f.poster.seconds[c] for f in fronts) for c in CODECS},
            "informer_saw_every_bind": informer_ok, "informer_lag_ms": _quantiles(lag_ms),
            "informer_events": len(lag_ms),
            "measured_s": measured_s, "create_s": create_s,
            "pods_per_s": len(measured) / measured_s,
        }
        front.close()
        if not crash:
            # the restore's cost, on a copy (restore compacts its own path)
            copy = os.path.join(tmp, "copy.wal")
            shutil.copyfile(path, copy)
            t_restore = time.perf_counter()
            restored_placed = {k: p.spec.node_name for k, p in restore(copy).pods.items()}
            restore_s = time.perf_counter() - t_restore
        live_wal.close()
        out.update(restore_s=restore_s, restored_placed=restored_placed)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_apiserver_run(name: str, w: Workload, run: dict, crash: bool) -> List[str]:
    """What every Run A / Run B must hold; the faults found (empty: none):
    every pod bound once, the REST listing and the informer agreeing with
    the store, one WAL line per bind batch, and (Run A) the restore's
    placements equal to the live store's, (Run B) no bind lost or made
    again after the crash."""
    faults = []
    pods = w.n_init + w.n_measured
    if len(run["placed"]) != pods or not all(run["placed"].values()):
        faults.append(f"{name}: {sum(map(bool, run['placed'].values()))} of {pods} pods bound")
    if run["rest_placed"] != run["placed"]:
        faults.append(f"{name}: the REST listing differs from the store")
    if not run["informer_saw_every_bind"]:
        faults.append(f"{name}: the informer missed binds ({run['informer_events']} seen)")
    doubled = sorted(k for k, n in run["binds"].items() if n != 1)
    if doubled or len(run["binds"]) != pods:
        faults.append(f"{name}: {len(run['binds'])} pods bound, {len(doubled)} not once: "
                      f"{doubled[:5]}")
    bad_lines = [bl for bl in run["batch_lines"] if bl[1] != 1]
    if bad_lines or not run["batch_lines"]:
        faults.append(f"{name}: bind batches with other than one WAL line: {bad_lines[:5]}")
    if crash:
        if run["lost"] or run["rebound"]:
            faults.append(f"{name}: {len(run['lost'])} binds lost, "
                          f"{run['rebound']} init pods bound again")
    elif run["restored_placed"] != run["placed"]:
        faults.append(f"{name}: the restored store's placements differ from the live store's")
    return faults
