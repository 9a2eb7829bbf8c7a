"""The control plane's two halves over one store on one clock: the
controller manager (``controllers/manager.py``, its default initializers)
and the scheduler loop (``backend/tpu_scheduler.py``), taking turns as the
JAX package's ``tests/test_controllers.py::TestControlPlaneTogether`` runs
them, at any size.

``settle`` alternates ``ControllerManager.settle`` and the loop's
``run_until_settled`` until neither has work. ``run_control_plane`` drives
these steps over SchedulingBasic's nodes, each with a Lease in
``kube-node-lease``:

1. ``workloads``: a Deployment of SchedulingBasic's pod (900m, 2Gi) under a
   PodDisruptionBudget of ``minAvailable: 90%``, a StatefulSet, and a Job
   run in parallel, until every pod is bound;
2. ``node_loss``: a share of the nodes stop renewing their Leases; past the
   40 s grace the node lifecycle controller marks them NotReady with the
   unreachable NoExecute taint, and they are cordoned (an operator's
   reaction: the JAX lifecycle controller taints only NoExecute, which the
   pods' default 300 s tolerations tolerate, so nothing else keeps new pods
   off them); past the 300 s toleration their pods are evicted, PodGC runs,
   the owners make replacements and the scheduler places them;
3. ``scale_<n>`` for each ``n`` of ``scale_to``: the Deployment rescaled.

``run_preemption_budgets`` is PreemptionBasic's cluster (``perf/
workloads.py:preemption_basic``) with its victims owned by two
ReplicaSets: a quarter under a PodDisruptionBudget of ``minAvailable:
100%`` created with a stale status (``disruptionsAllowed`` its size),
which the disruption controller corrects to 0 before the preemptors come,
and the rest under none. Preemption then has to take its victims from the
unguarded ReplicaSet.

Each step returns a record of what must repeat on another device:
placements, PDB statuses, taints, evictions, the objects per kind, the
reconciles and the pods popped; and its seconds, which need not. The
objects come from ``api``: any namespace with ``types``, ``make_node`` and
``make_pod`` (this package's by default), so one driver runs either
package's store, manager and loop."""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from ..apiserver.admission import DEFAULT_TOLERATION_SECONDS
from ..controllers.nodelifecycle import DEFAULT_GRACE_PERIOD, NODE_LEASE_NAMESPACE

NODE_CAPACITY = {"cpu": "32", "memory": "128Gi", "pods": 110}  # SchedulingBasic's node
POD_REQUEST = {"cpu": "900m", "memory": "2Gi"}                 # SchedulingBasic's pod
PREEMPTION_NODE = {"cpu": "4", "memory": "16Gi", "pods": 32}   # PreemptionBasic's node
VICTIM_REQUEST, VICTIM_PRIORITY = {"cpu": "900m", "memory": "2Gi"}, 1
PREEMPTOR_REQUEST, PREEMPTOR_PRIORITY = {"cpu": "2", "memory": "4Gi"}, 100
BACKOFF_S = 10.0  # the loop's default pod_max_backoff: a failed pod's longest wait
PREEMPTION_ROUNDS = 16
# the kinds a record counts
KINDS = ("Pod", "Node", "Lease", "ReplicaSet", "Deployment", "StatefulSet", "Job",
         "PodDisruptionBudget", "Endpoints", "EndpointSlice", "VolumeAttachment",
         "ServiceAccount", "ConfigMap", "Event")


def port_api() -> SimpleNamespace:
    from ..api import types
    from ..api.wrappers import make_node, make_pod

    return SimpleNamespace(types=types, make_node=make_node, make_pod=make_pod)


def settle(manager, sched, max_turns: int = 1000) -> Dict[str, float]:
    """The manager's ``settle`` and the loop's ``run_until_settled`` in
    turns until a turn of both does nothing; their work and seconds."""
    out = {"turns": 0, "reconciles": 0, "popped": 0, "controllers_s": 0.0, "scheduler_s": 0.0}
    for _ in range(max_turns):
        t0 = time.perf_counter()
        n = manager.settle()
        t1 = time.perf_counter()
        popped = sched.run_until_settled()
        t2 = time.perf_counter()
        out["turns"] += 1
        out["reconciles"] += n
        out["popped"] += popped
        out["controllers_s"] += t1 - t0
        out["scheduler_s"] += t2 - t1
        if n == 0 and popped == 0:
            return out
    raise RuntimeError(f"the control plane did not settle in {max_turns} turns")


def _pdb_status(pdb) -> tuple:
    return (pdb.expected_pods, pdb.current_healthy, pdb.desired_healthy, pdb.disruptions_allowed)


def record(store, manager, work: Optional[dict] = None) -> dict:
    """What a step must repeat: placements (pod key -> node, "" unbound),
    PDB statuses, each tainted node's taint keys and unschedulable flag,
    the taint manager's evictions, the objects per kind, and the
    reconciles and pods popped."""
    nodes = store.snapshot_map("Node")
    metrics = manager.metrics
    out = {
        "placed": {k: p.spec.node_name for k, p in sorted(store.snapshot_map("Pod").items())},
        "pdbs": {k: _pdb_status(p)
                 for k, p in sorted(store.snapshot_map("PodDisruptionBudget").items())},
        "taints": {n: (tuple(t.key for t in node.spec.taints), node.spec.unschedulable,
                       node.status.ready)
                   for n, node in sorted(nodes.items())
                   if node.spec.taints or node.spec.unschedulable or not node.status.ready},
        "evicted": metrics.evicted_pods.labels("taint") if metrics is not None else 0,
        "kinds": {kind: len(store.snapshot_map(kind)) for kind in KINDS},
    }
    if work is not None:
        out["reconciles"], out["popped"] = work["reconciles"], work["popped"]
    return out


def _template(api, labels: Dict[str, str], req: Dict[str, str], priority: int = 0):
    pw = api.make_pod("template").req(dict(req))
    for k, v in labels.items():
        pw.label(k, v)
    if priority:
        pw.priority(priority)
    return pw.obj()


def _scale(store, kind: str, key: str, replicas: int) -> None:
    cur = store.get_object(kind, key)
    new = dataclasses.replace(cur, replicas=replicas)
    new.meta = dataclasses.replace(cur.meta)
    store.update_object(kind, new)


def add_nodes(api, store, clock, count: int, capacity: Dict[str, object],
              leases: bool = True, zones: int = 10) -> List[str]:
    """SchedulingBasic's nodes ``node-0`` .. (zone and hostname labels), each
    with a Lease renewed now."""
    t = api.types
    names = []
    for i in range(count):
        name = f"node-{i}"
        nw = api.make_node(name).capacity(dict(capacity))
        if zones:
            nw.label("topology.kubernetes.io/zone", f"zone-{i % zones}")
            nw.label("kubernetes.io/hostname", name)
        store.create_node(nw.obj())
        if leases:
            store.create_lease(t.Lease(meta=t.ObjectMeta(name=name,
                                                         namespace=NODE_LEASE_NAMESPACE),
                                       holder_identity=name, renew_time=clock()))
        names.append(name)
    return names


def renew_leases(store, clock, names) -> None:
    """The kubelets of ``names`` heartbeat now."""
    for name in names:
        cur = store.get_lease(f"{NODE_LEASE_NAMESPACE}/{name}")
        new = dataclasses.replace(cur, renew_time=clock())
        new.meta = dataclasses.replace(cur.meta)
        store.update_lease(new, expect_rv=cur.meta.resource_version)


def _cordon(store, name: str) -> None:
    cur = store.nodes[name]
    new = dataclasses.replace(cur, spec=dataclasses.replace(cur.spec, unschedulable=True))
    new.meta = dataclasses.replace(cur.meta)
    store.update_node(new)


def run_control_plane(store, manager, sched, clock, *, nodes: List[str], replicas: int = 2000,
                      stateful: int = 100, job: int = 200, lost: int = 250,
                      scale_to=(3000, 1500), api=None,
                      on_step: Callable[[str, dict], None] = lambda name, rec: None) -> dict:
    """The steps over a store holding ``nodes`` with their Leases; ``on_step
    (name, record)`` after each. Returns {step: record with its seconds}."""
    api = api or port_api()
    t = api.types
    steps = {}

    def step(name: str, body: Callable[[], dict]) -> None:
        t0 = time.perf_counter()
        work = body()
        rec = record(store, manager, work)
        rec["seconds"] = {"wall": time.perf_counter() - t0,
                          "controllers": work["controllers_s"],
                          "scheduler": work["scheduler_s"], "turns": work["turns"]}
        steps[name] = rec
        on_step(name, rec)

    def workloads() -> dict:
        web = {"app": "web"}
        store.create_object("Deployment", t.Deployment(
            meta=t.ObjectMeta(name="web"), selector=t.LabelSelector(match_labels=dict(web)),
            replicas=replicas, template=_template(api, web, POD_REQUEST)))
        store.create_pdb(t.PodDisruptionBudget(
            meta=t.ObjectMeta(name="web"), selector=t.LabelSelector(match_labels=dict(web)),
            min_available="90%"))
        store.create_stateful_set(t.StatefulSet(
            meta=t.ObjectMeta(name="db"), selector=t.LabelSelector(match_labels={"app": "db"}),
            replicas=stateful, template=_template(api, {"app": "db"}, POD_REQUEST)))
        store.create_object("Job", t.Job(
            meta=t.ObjectMeta(name="batch"), completions=job, parallelism=job,
            template=_template(api, {"app": "batch"}, POD_REQUEST)))
        return settle(manager, sched)

    def node_loss() -> dict:
        gone, alive = nodes[-lost:], nodes[:-lost]
        clock.advance(DEFAULT_GRACE_PERIOD + 1.0)
        renew_leases(store, clock, alive)
        work = {"turns": 0, "reconciles": manager.sync_round(monitor_nodes=True), "popped": 0,
                "controllers_s": 0.0, "scheduler_s": 0.0}
        for name in gone:
            _cordon(store, name)
        _add(work, settle(manager, sched))
        clock.advance(DEFAULT_TOLERATION_SECONDS + 1.0)
        renew_leases(store, clock, alive)
        work["reconciles"] += manager.sync_round(monitor_nodes=True)
        _add(work, settle(manager, sched))
        return work

    def rescale(n: int) -> Callable[[], dict]:
        def body() -> dict:
            _scale(store, "Deployment", "default/web", n)
            return settle(manager, sched)
        return body

    step("workloads", workloads)
    if lost:
        step("node_loss", node_loss)
    for n in scale_to:
        step(f"scale_{n}", rescale(n))
    return steps


def _add(work: dict, part: dict) -> None:
    for k, v in part.items():
        work[k] += v


def run_preemption_budgets(store, manager, sched, clock, *, nodes: int = 500,
                           victims: int = 2000, preemptors: int = 500, api=None) -> dict:
    """PreemptionBasic's cluster with owned victims and a live budget: the
    guarded ReplicaSet (a quarter of the victims, placed first, so one
    per node) under ``minAvailable: 100%`` created with the stale status
    ``disruptionsAllowed = guarded``; then the unguarded rest; then the
    preemptors, settled again after ``BACKOFF_S`` on the clock while one
    is unbound (a nominated pod waits out its backoff), at most
    ``PREEMPTION_ROUNDS`` times. Returns the record, the PDB status before
    the preemptors, the guarded pods evicted, the preemptors bound and the
    rounds."""
    api = api or port_api()
    t = api.types
    t0 = time.perf_counter()
    add_nodes(api, store, None, nodes, PREEMPTION_NODE, leases=False, zones=0)
    guarded = victims // 4
    sel = {"app": "guarded"}
    evicted = []

    def watch(event, old, new):
        if event == "DELETED" and old.meta.labels.get("app") == "guarded":
            evicted.append(old.meta.key())

    store.add_event_handler("Pod", watch)
    store.create_replica_set(t.ReplicaSet(
        meta=t.ObjectMeta(name="guarded"), selector=t.LabelSelector(match_labels=dict(sel)),
        replicas=guarded, template=_template(api, sel, VICTIM_REQUEST, VICTIM_PRIORITY)))
    store.create_pdb(t.PodDisruptionBudget(
        meta=t.ObjectMeta(name="guarded"), selector=t.LabelSelector(match_labels=dict(sel)),
        min_available="100%", disruptions_allowed=guarded))
    work = settle(manager, sched)
    store.create_replica_set(t.ReplicaSet(
        meta=t.ObjectMeta(name="free"), selector=t.LabelSelector(match_labels={"app": "free"}),
        replicas=victims - guarded,
        template=_template(api, {"app": "free"}, VICTIM_REQUEST, VICTIM_PRIORITY)))
    _add(work, settle(manager, sched))
    before = _pdb_status(store.pdbs["default/guarded"])
    keys = []
    for i in range(preemptors):
        pod = api.make_pod(f"preemptor-{i}").req(dict(PREEMPTOR_REQUEST)).priority(
            PREEMPTOR_PRIORITY).obj()
        store.create_pod(pod)
        keys.append(pod.key())
    _add(work, settle(manager, sched))
    rounds = 0
    while rounds < PREEMPTION_ROUNDS and not all(store.pods[k].spec.node_name for k in keys):
        rounds += 1
        clock.advance(BACKOFF_S)
        _add(work, settle(manager, sched))
    rec = record(store, manager, work)
    rec["pdb_before"] = before
    rec["guarded_evicted"] = len(evicted)
    rec["preemptors_bound"] = sum(1 for k in keys if rec["placed"][k])
    rec["rounds"] = rounds
    rec["nominated"] = sum(1 for p in store.snapshot_map("Pod").values()
                           if p.status.nominated_node_name)
    rec["seconds"] = {"wall": time.perf_counter() - t0,
                      "controllers": work["controllers_s"], "scheduler": work["scheduler_s"],
                      "turns": work["turns"]}
    return rec
