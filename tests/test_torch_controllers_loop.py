"""The port's controller manager as a whole, and the control plane (the
manager and the scheduler loop over one store, ``kubernetes_tpu_torch/perf/
control_plane.py``) against the JAX package's, on the CPU.

- ``new_controller_initializers``: the same names, each building a
  controller of the same class, watching the same kinds; ``_wall_now``.
- ``ControllerManager.settle`` and ``sync_round`` over a script touching
  every controller's kinds at once, and leader election: two managers on
  one Lease, the standby doing nothing until the leader stops renewing and
  the lease runs out. ``run`` and ``stop`` drive the rounds on a thread.
- The control plane: one driver (``run_control_plane``,
  ``run_preemption_budgets``) runs each package's store, manager and loop
  (the JAX ``TPUScheduler``; the port's on ``device="cpu"``) on FakeClocks
  in this process (C14): a Deployment to bound pods under a live PDB, a
  StatefulSet and a Job; node loss (the lifecycle controller's NotReady and
  unreachable taint, the eviction past the 300 s toleration, the
  replacements); the rescales; and PreemptionBasic's cluster with a guarded
  ReplicaSet whose budget the disruption controller keeps. Every step's
  record (placements, PDB statuses, taints, evictions, objects per kind,
  reconciles, pods popped) is equal, and the steps' own bars hold."""

import time
from types import SimpleNamespace

import pytest

from test_torch_controllers import KITS, run, state


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("KTPU_PIPELINE", "KTPU_PIPELINE_DEPTH", "KTPU_COMMIT_WORKER", "KTPU_FULL_BATCH",
                "KTPU_SPEC", "KTPU_LEDGER", "KTPU_TELEMETRY", "KTPU_TRACE_FILE"):
        monkeypatch.delenv(key, raising=False)


def test_initializers_match_jax():
    def script(k):
        mgr = k.mod("manager")
        inits = mgr.new_controller_initializers()
        store = k.new_store()
        m = k.manager(store, clock=k.FakeClock())
        return [list(inits), {name: (type(c).__name__, tuple(c.watch_kinds), c.name)
                              for name, c in m.controllers.items()},
                mgr._wall_now(m) is m.now_fn,
                mgr._wall_now(SimpleNamespace(now_fn=time.monotonic)) is time.time]

    out = run(script)
    assert len(out[0]) == 36 and out[2] and out[3]


def test_settle_over_every_controller():
    """One script writing the kinds of every loop at once, settled by the
    full manager; then a node monitor round."""
    def script(k):
        t = k.types
        store = k.new_store()
        clock = k.FakeClock()
        m = k.manager(store, clock=clock)
        store.create_namespace(t.Namespace(meta=t.ObjectMeta(name="team")))
        for i in range(3):
            store.create_node(k.make_node(f"n{i}").obj())
        store.create_object("Deployment", t.Deployment(meta=t.ObjectMeta(name="api"), replicas=2,
                                                       template=k.template({"app": "api"})))
        store.create_object("DaemonSet", t.DaemonSet(meta=t.ObjectMeta(name="agent"),
                                                     template=k.template()))
        store.create_service(t.Service(meta=t.ObjectMeta(name="api"), selector={"app": "api"}))
        store.create_pdb(t.PodDisruptionBudget(
            meta=t.ObjectMeta(name="api"), selector=t.LabelSelector(match_labels={"app": "api"}),
            max_unavailable=1))
        store.create_object("Job", t.Job(meta=t.ObjectMeta(name="j"), completions=2,
                                         parallelism=1, template=k.template()))
        store.create_object("ResourceQuota", t.ResourceQuota(meta=t.ObjectMeta(name="q"),
                                                             hard={"pods": 50}))
        store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="data")))
        out = [m.settle(), state(k, store, m)]
        for key in sorted(store.pods):
            p = store.get_pod(key).clone()
            p.status.phase = "Running"
            p.spec.node_name = p.spec.node_name or "n0"
            store.update_pod(p)
        out += [m.settle(), state(k, store, m)]
        clock.advance(100.0)
        out += [m.sync_round(monitor_nodes=True), state(k, store, m)]
        return out

    out = run(script)
    st = out[3]
    assert len(st["Endpoints"]["default/api"]["addresses"]) == 2
    assert st["PodDisruptionBudget"]["default/api"]["disruptions_allowed"] == 1
    assert "team/default" in st["ServiceAccount"] and st["ResourceQuota"]["default/q"]["used"]


def test_leader_election():
    def script(k):
        store = k.new_store()
        clock = k.FakeClock()
        a = k.manager(store, ["replicaset"], clock=clock, leader_election=True, identity="kcm-a")
        b = k.manager(store, ["replicaset"], clock=clock, leader_election=True, identity="kcm-b")
        t = k.types
        store.create_replica_set(t.ReplicaSet(meta=t.ObjectMeta(name="web"), replicas=2,
                                              template=k.template()))
        out = [a.sync_round(), b.sync_round(), state(k, store)]
        clock.advance(5.0)
        out += [b.sync_round(), a.sync_round()]
        clock.advance(60.0)  # a stops renewing: past the lease b takes over
        out += [b.sync_round(), state(k, store), a.sync_round()]
        lease = store.get_lease("kube-system/kube-controller-manager")
        out.append((lease.holder_identity, lease.lease_transitions))
        return out

    out = run(script)
    assert out[0] > 0 and out[1] == 0 and out[3] == 0
    assert out[-1][0] == "kcm-b"


def test_run_and_stop():
    """``run`` drives the rounds on a thread until ``stop``."""
    def script(k):
        t = k.types
        store = k.new_store()
        m = k.manager(store, ["replicaset"], clock=k.FakeClock())
        store.create_replica_set(t.ReplicaSet(meta=t.ObjectMeta(name="web"), replicas=3,
                                              template=k.template()))
        th = m.run(tick=0.005)
        deadline = time.monotonic() + 20.0
        while len(store.pods) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        m.stop()
        th.join(5.0)
        return [sorted(store.pods), th.is_alive()]

    out = run(script)
    assert out == [["default/web-0", "default/web-1", "default/web-2"], False]


class _Side:
    """One package's store, manager (default initializers) and loop on a
    FakeClock."""

    def __init__(self, pkg: str, batch: int = 16):
        k = KITS[pkg]
        self.clock = k.FakeClock()
        if pkg == "jax":
            from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler

            self.store = k.new_store()
            self.sched = TPUScheduler(self.store, now_fn=self.clock, batch_size=batch,
                                      batch_deadline_ms=0)
        else:
            from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

            self.store = k.new_store(now_fn=self.clock)
            self.sched = TPUScheduler(self.store, device="cpu", now_fn=self.clock,
                                      batch_size=batch, batch_deadline_ms=0)
        self.api = SimpleNamespace(types=k.types, make_node=k.make_node, make_pod=k.make_pod)
        self.k = k

    def manager(self):
        return self.k.manager(self.store, clock=self.clock, metrics=self.sched.smetrics)


def _strip(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "seconds"}


def test_control_plane_matches_jax():
    from kubernetes_tpu_torch.perf import control_plane as cp

    sizes = dict(replicas=40, stateful=3, job=6, lost=3, scale_to=(60, 30))
    out = {}
    for pkg in ("jax", "port"):
        side = _Side(pkg)
        nodes = cp.add_nodes(side.api, side.store, side.clock, 24, cp.NODE_CAPACITY)
        m = side.manager()
        steps = cp.run_control_plane(side.store, m, side.sched, side.clock, nodes=nodes,
                                     api=side.api, **sizes)
        out[pkg] = {name: _strip(rec) for name, rec in steps.items()}
    assert out["port"] == out["jax"]
    steps = out["port"]
    assert list(steps) == ["workloads", "node_loss", "scale_60", "scale_30"]
    for name, rec in steps.items():
        assert all(rec["placed"].values()), name  # every pod bound
    assert len(steps["workloads"]["placed"]) == 40 + 3 + 6
    assert steps["workloads"]["pdbs"] == {"default/web": (40, 40, 36, 4)}
    loss = steps["node_loss"]
    tainted = {n for n, v in loss["taints"].items()
               if "node.kubernetes.io/unreachable" in v[0]}
    assert tainted == {"node-21", "node-22", "node-23"}
    assert loss["evicted"] > 0 and not [k for k, n in loss["placed"].items() if n in tainted]
    assert steps["scale_30"]["pdbs"] == {"default/web": (30, 30, 27, 3)}


def test_preemption_budgets_match_jax():
    from kubernetes_tpu_torch.perf import control_plane as cp

    out = {}
    for pkg in ("jax", "port"):
        side = _Side(pkg)
        rec = cp.run_preemption_budgets(side.store, side.manager(), side.sched, side.clock,
                                        nodes=16, victims=64, preemptors=16, api=side.api)
        out[pkg] = _strip(rec)
    assert out["port"] == out["jax"]
    rec = out["port"]
    assert rec["pdb_before"] == (16, 16, 16, 0)  # the stale 16 corrected
    assert rec["guarded_evicted"] == 0 and rec["preemptors_bound"] == 16
