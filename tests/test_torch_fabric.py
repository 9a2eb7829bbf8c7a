"""The device fabric (``kubernetes_tpu_torch/backend/fabric.py``) against the
JAX package's (``kubernetes_tpu/backend/fabric.py``), on the CPU.

Two layers, as in the JAX suite:

  * unit parity (``tests/test_fabric.py``'s classes): each package's
    ``DeviceFabric`` over the same scripted stub clients, driven by the same
    script on its own FakeClock. Each scenario returns what it observed
    (active index, failovers by reason, the flight events in order, replica
    health, the calls and pushes each stub saw, the dump) and asserts the
    JAX suite's expectations on it; the port's observation must equal the
    JAX one.
  * the fabric scenarios of ``tests/test_chaos.py`` over real sockets
    (``_torch_cases.FabricPair``: each package's ``WireScheduler`` over two
    served ``DeviceService``s, one FaultPlan per endpoint): placements,
    counters, the queue, failovers and the fabric's flight events equal,
    and the surviving mirror unchanged by a forced full resync.

The replicator's worker thread is off on both sides: replication runs at
the ``replication_flush()`` calls the scripts make, at the same points.
"""

import re
import threading
from types import SimpleNamespace

import pytest

from _torch_cases import FABRIC_EVENTS, LOOP_EVENTS, FabricPair, metric_items

PKGS = ("jax", "port")


def _kit(pkg: str) -> SimpleNamespace:
    """One package's fabric, errors, telemetry, metrics, clock, service and
    fault plans."""
    if pkg == "jax":
        from kubernetes_tpu.backend import errors, fabric, service, telemetry
        from kubernetes_tpu.metrics.scheduler_metrics import SchedulerMetrics
        from kubernetes_tpu.testing.faults import FaultPlan
        from kubernetes_tpu.utils.clock import FakeClock
        from kubernetes_tpu.apiserver.store import ClusterStore as Store
        from kubernetes_tpu.api.wrappers import make_node
    else:
        from kubernetes_tpu_torch.backend import errors, fabric, service, telemetry
        from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics
        from kubernetes_tpu_torch.testing.faults import FaultPlan
        from kubernetes_tpu_torch.utils.clock import FakeClock
        from kubernetes_tpu_torch.apiserver.store import Store
        from kubernetes_tpu_torch.api.wrappers import make_node
    return SimpleNamespace(pkg=pkg, errors=errors, DeviceFabric=fabric.DeviceFabric,
                           service=service, telemetry=telemetry,
                           SchedulerMetrics=SchedulerMetrics, FaultPlan=FaultPlan,
                           FakeClock=FakeClock, Store=Store, make_node=make_node)


_REPL_ID = re.compile(r"^fabric-repl-[0-9a-f]+-\d+$")


def _norm(value):
    """A payload with the replicator's process-unique client id replaced."""
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_norm(v) for v in value]
    if isinstance(value, str) and _REPL_ID.match(value):
        return "fabric-repl"
    return value


class _Stub:
    """A scripted transport client (``tests/test_fabric.py``'s
    ``_RecordingStub``): ``fail`` raises on the batch-path verbs,
    ``fail_health`` on Health; ``calls`` and ``payloads`` record what it
    saw. ``check`` runs at every call (the lock test)."""

    supports_dra = True
    supports_health = True
    supports_sessions = True

    def __init__(self, endpoint, check=None):
        self.endpoint = endpoint
        self.epoch = f"epoch-{endpoint}"
        self.calls = []
        self.payloads = []
        self.fail = None
        self.fail_health = None
        self.check = check

    def _out(self, **extra):
        if self.check is not None:
            self.check()
        out = {"apiVersion": "ktpu/v1", "epoch": self.epoch, "deltaSeq": 1}
        out.update(extra)
        return out

    def apply_deltas(self, payload):
        self.calls.append("apply_deltas")
        self.payloads.append(("apply_deltas", payload))
        if self.fail is not None:
            raise self.fail
        return self._out(nodes=len(payload.get("nodes", ())))

    def schedule_batch(self, payload):
        self.calls.append("schedule_batch")
        if self.fail is not None:
            raise self.fail
        return self._out(results=[])

    def heartbeat(self, payload):
        self.calls.append("heartbeat")
        self.payloads.append(("heartbeat", payload))
        if self.fail is not None:
            raise self.fail
        return self._out(fenced=[])

    def health(self):
        self.calls.append("health")
        if self.fail_health is not None:
            raise self.fail_health
        return self._out(status="serving")

    def sessions_dump(self):
        self.calls.append("sessions")
        if self.fail is not None:
            raise self.fail
        return self._out(sessions=[])


class _Rig:
    """A fabric over ``n`` stubs (``ep0``..), a FakeClock, optional metrics
    and probe stubs, the package's flight recorder on."""

    def __init__(self, K, n=3, metrics=False, probes=False, replication=False,
                 probe_interval_s=5.0, check=None):
        self.K = K
        self.clock = K.FakeClock()
        self.metrics = K.SchedulerMetrics() if metrics else None
        self.mains, self.probes = {}, {}

        def factory(ep, i):
            self.mains[ep] = _Stub(ep, check)
            return self.mains[ep]

        def pfactory(ep, i):
            self.probes[ep] = _Stub(ep, check)
            return self.probes[ep]

        self.fab = K.DeviceFabric(
            [f"ep{i}" for i in range(n)], factory,
            probe_client_factory=pfactory if probes else None, metrics=self.metrics,
            now_fn=self.clock, probe_interval_s=probe_interval_s, replication=replication,
            replication_worker=False)

    def err(self, kind: str, msg: str):
        return getattr(self.K.errors, kind)(msg)

    def raises(self, fn, *args) -> str:
        """The name of the error ``fn(*args)`` raised ("" for none)."""
        try:
            fn(*args)
        except self.K.errors.DeviceServiceError as exc:
            return type(exc).__name__
        return ""

    def observed(self) -> dict:
        fab = self.fab
        out = {
            "active": fab.active_replica().index,
            "failovers": fab.failovers,
            "healthy": [r.healthy for r in fab.replicas],
            "calls": {ep: list(c.calls) for ep, c in sorted(self.mains.items())},
            "probe_calls": {ep: list(c.calls) for ep, c in sorted(self.probes.items())},
            "pushes": {ep: _norm(c.payloads) for ep, c in sorted(self.mains.items())},
            "probe_pushes": {ep: _norm(c.payloads) for ep, c in sorted(self.probes.items())},
            "needs_full": [r.repl_needs_full for r in fab.replicas],
            "synced": [r.repl_synced_seq for r in fab.replicas],
            "repl_session_gen": [r.repl_session_gen for r in fab.replicas],
            "repl_errors": [r.repl_last_error.split(":")[0] for r in fab.replicas],
        }
        m = self.metrics
        if m is not None:
            out["metrics"] = {
                name: metric_items(getattr(m, name))
                for name in ("fabric_active_replica", "fabric_failovers",
                             "fabric_replica_health", "standby_replication_lag",
                             "standby_resync_bytes")}
        return out


def _events(tele) -> list:
    keys = ("endpoint", "fromEndpoint", "batchId", "verb", "pods", "reason", "restarted",
            "nodes", "removed", "full")
    return [(ev["type"],) + tuple(ev.get(k) for k in keys) for ev in tele.flight.dump()]


# ------------------------------------------------------------ unit scenarios


def sc_selection(K):
    r = _Rig(K)
    out = r.fab.schedule_batch({"pods": [], "batchId": "b-1"})
    assert out["epoch"] == "epoch-ep0" and r.mains["ep1"].calls == []
    assert r.fab.supports_dra and r.fab.supports_health and r.fab.supports_sessions
    try:
        K.DeviceFabric([], lambda ep, i: _Stub(ep))
        empty = ""
    except ValueError as exc:
        empty = str(exc)
    return {**r.observed(), "empty": empty}


def sc_protocol_verdicts(K):
    r = _Rig(K)
    r.mains["ep0"].fail = K.errors.StaleEpochError("fresh-epoch")
    stale = r.raises(r.fab.apply_deltas, {"nodes": []})
    r.mains["ep0"].fail = K.errors.ConflictError("raced")
    conflict = r.raises(r.fab.schedule_batch, {"pods": [], "batchId": "b-2"})
    assert (stale, conflict) == ("StaleEpochError", "ConflictError")
    assert r.fab.failovers == 0 and r.fab.replicas[0].healthy
    return {**r.observed(), "raised": [stale, conflict]}


def sc_primary_loss(K):
    r = _Rig(K, metrics=True)
    r.mains["ep0"].fail = r.err("TransientDeviceError", "connection reset")
    try:
        r.fab.schedule_batch({"pods": [{}], "batchId": "b-7"})
        raise AssertionError("no failover")
    except K.errors.FailoverError as exc:
        err = (exc.from_endpoint, exc.to_endpoint,
               isinstance(exc, K.errors.TransientDeviceError))
    assert err == ("ep0", "ep1", True) and r.mains["ep1"].calls == ["health"]
    return {**r.observed(), "error": err}


def sc_dead_standby_skipped(K):
    r = _Rig(K, n=3)
    r.mains["ep0"].fail = r.err("TransientDeviceError", "down")
    r.mains["ep1"].fail_health = r.err("TransientDeviceError", "also down")
    raised = r.raises(r.fab.apply_deltas, {"nodes": []})
    assert raised == "FailoverError" and r.fab.active_endpoint() == "ep2"
    return {**r.observed(), "raised": raised}


def sc_all_down(K):
    r = _Rig(K, n=2)
    exc = r.err("TransientDeviceError", "primary gone")
    r.mains["ep0"].fail = exc
    r.mains["ep1"].fail_health = r.err("TransientDeviceError", "standby gone")
    try:
        r.fab.schedule_batch({"pods": [], "batchId": "b-1"})
        same = False
    except K.errors.TransientDeviceError as got:
        same = got is exc
    assert same and r.fab.failovers == 0 and r.fab.active_endpoint() == "ep0"
    return {**r.observed(), "original": same}


def sc_permanent(K):
    r = _Rig(K, metrics=True)
    r.mains["ep0"].fail = r.err("PermanentDeviceError", "version skew: 400")
    raised = r.raises(r.fab.apply_deltas, {"nodes": []})
    assert raised == "FailoverError"
    assert r.metrics.fabric_failovers.labels("permanent") == 1
    return {**r.observed(), "raised": raised}


def sc_health_fails_over(K):
    r = _Rig(K)
    r.mains["ep0"].fail = r.err("TransientDeviceError", "dead")
    r.mains["ep0"].fail_health = r.err("TransientDeviceError", "dead")
    out = r.fab.health()
    assert out["epoch"] == "epoch-ep1" and r.fab.failovers == 1
    return {**r.observed(), "health": out}


def sc_poison_then_failover(K):
    tele = K.telemetry.enable()
    try:
        r = _Rig(K)
        r.mains["ep0"].fail = r.err("TransientDeviceError", "mid-batch death")
        r.raises(r.fab.schedule_batch, {"pods": [{}, {}], "batchId": "b-9"})
        # a push's failure poisons nothing
        r.mains["ep1"].fail = r.err("TransientDeviceError", "down too")
        r.raises(r.fab.apply_deltas, {"nodes": []})
        events = _events(tele)
    finally:
        K.telemetry.disable()
    kinds = [e[0] for e in events]
    assert kinds[:3] == ["replica_down", "poison", "failover"]
    assert kinds.count("poison") == 1
    return {**r.observed(), "events": events}


def _failed_over(K, metrics=False, probes=False):
    r = _Rig(K, n=2, metrics=metrics, probes=probes)
    r.fab.apply_deltas({"nodes": []})  # learn ep0's epoch
    r.mains["ep0"].fail = r.err("TransientDeviceError", "down")
    r.mains["ep0"].fail_health = r.err("TransientDeviceError", "down")
    r.raises(r.fab.apply_deltas, {"nodes": []})
    return r


def sc_rejoin_sticky(K):
    r = _failed_over(K, metrics=True)
    r.mains["ep0"].fail = r.mains["ep0"].fail_health = None
    r.clock.advance(6.0)
    tele = K.telemetry.enable()
    try:
        r.fab.schedule_batch({"pods": [], "batchId": "b-2"})
        events = _events(tele)
    finally:
        K.telemetry.disable()
    assert r.fab.replicas[0].healthy and r.fab.active_endpoint() == "ep1"
    return {**r.observed(), "events": events}


def sc_rejoin_restarted(K):
    r = _failed_over(K)
    r.mains["ep0"].fail = r.mains["ep0"].fail_health = None
    r.mains["ep0"].epoch = "epoch-ep0-RESTARTED"
    r.clock.advance(6.0)
    tele = K.telemetry.enable()
    try:
        r.fab.schedule_batch({"pods": [], "batchId": "b-3"})
        events = _events(tele)
    finally:
        K.telemetry.disable()
    assert events and events[0][0] == "replica_rejoin" and events[0][7] is True
    return {**r.observed(), "events": events}


def sc_probe_rate_limited(K):
    r = _failed_over(K)
    r.mains["ep0"].fail_health = None
    counts = [r.mains["ep0"].calls.count("health")]
    r.fab.schedule_batch({"pods": [], "batchId": "b-4"})
    counts.append(r.mains["ep0"].calls.count("health"))
    r.clock.advance(6.0)
    r.fab.schedule_batch({"pods": [], "batchId": "b-5"})
    counts.append(r.mains["ep0"].calls.count("health"))
    r.fab.schedule_batch({"pods": [], "batchId": "b-6"})
    counts.append(r.mains["ep0"].calls.count("health"))
    assert counts[1] == counts[0] and counts[2] == counts[3] == counts[0] + 1
    return {**r.observed(), "counts": counts}


def sc_failback(K):
    r = _failed_over(K)
    r.mains["ep0"].fail = r.mains["ep0"].fail_health = None
    r.clock.advance(6.0)
    r.fab.schedule_batch({"pods": [], "batchId": "b-7"})
    r.mains["ep1"].fail = r.err("TransientDeviceError", "standby dies")
    raised = r.raises(r.fab.schedule_batch, {"pods": [], "batchId": "b-8"})
    assert raised == "FailoverError" and r.fab.active_endpoint() == "ep0"
    assert r.fab.failovers == 2
    return {**r.observed(), "raised": raised}


def sc_probe_client(K):
    r = _Rig(K, n=2, probes=True)
    r.mains["ep0"].fail = r.err("TransientDeviceError", "down")
    r.raises(r.fab.apply_deltas, {"nodes": []})
    assert r.probes["ep1"].calls == ["health"] and r.mains["ep1"].calls == []
    r.clock.advance(6.0)
    r.fab.schedule_batch({"pods": [], "batchId": "b-1"})
    assert r.probes["ep0"].calls == ["health"] and "health" not in r.mains["ep0"].calls
    return r.observed()


def sc_sessions_dump_reads_only(K):
    r = _Rig(K)
    r.mains["ep0"].fail = r.err("TransientDeviceError", "down")
    raised = r.raises(r.fab.sessions_dump)
    assert raised == "TransientDeviceError" and r.fab.failovers == 0
    assert r.fab.replicas[0].healthy and r.mains["ep1"].calls == []
    return {**r.observed(), "raised": raised}


def sc_dump_shape(K):
    r = _Rig(K, n=2)
    r.mains["ep0"].fail = r.err("TransientDeviceError", "down")
    r.raises(r.fab.apply_deltas, {"nodes": []})
    out = r.fab.dump()
    assert out["active"] == "ep1" and out["activeIndex"] == 1 and out["failovers"] == 1
    assert out["replicas"][0]["breaker"]["state"] == "open"
    assert "TransientDeviceError" in out["replicas"][0]["lastError"]
    return {**r.observed(), "dump": _norm(out)}


def _entry(name, gen=1):
    return {"gen": gen, "node": {"meta": {"name": name}}, "pods": []}


def _deltas(fab, entries, removed=(), full=False, client="sched-A"):
    payload = {"nodes": entries, "removed": list(removed), "clientId": client}
    if full:
        payload["full"] = True
    return fab.apply_deltas(payload)


def sc_repl_first_flush_seeds(K):
    r = _Rig(K, n=2, replication=True)
    _deltas(r.fab, [_entry("n0"), _entry("n1")])
    pushes = r.fab.replication_flush()
    op, payload = r.mains["ep1"].payloads[0]
    assert pushes == 1 and payload["full"] is True and payload["replicator"] is True
    assert r.fab.replicas[1].repl_synced_seq == r.fab._repl_seq
    return {**r.observed(), "made": pushes}


def sc_repl_coalesces(K):
    r = _Rig(K, n=2, replication=True)
    _deltas(r.fab, [_entry("n0"), _entry("n1")])
    made = [r.fab.replication_flush()]
    for gen in (2, 3, 4):
        _deltas(r.fab, [_entry("n0", gen=gen)])
    made += [r.fab.replication_flush(), r.fab.replication_flush()]
    _op, payload = r.mains["ep1"].payloads[-1]
    assert made == [1, 1, 0] and "full" not in payload
    assert [e["node"]["meta"]["name"] for e in payload["nodes"]] == ["n0"]
    assert payload["nodes"][0]["gen"] == 4
    return {**r.observed(), "made": made}


def sc_repl_removals(K):
    r = _Rig(K, n=2, replication=True)
    _deltas(r.fab, [_entry("n0"), _entry("n1"), _entry("n2")])
    r.fab.replication_flush()
    _deltas(r.fab, [], removed=["n2"])
    r.fab.replication_flush()
    assert r.mains["ep1"].payloads[-1][1]["removed"] == ["n2"]
    _deltas(r.fab, [_entry("n0", gen=5)], full=True)
    r.fab.replication_flush()
    assert r.mains["ep1"].payloads[-1][1]["removed"] == ["n1"]
    return {**r.observed(), "nodes": sorted(r.fab._repl_nodes)}


def sc_repl_skips_active_backs_off(K):
    r = _Rig(K, n=3, replication=True)
    _deltas(r.fab, [_entry("n0")])
    r.mains["ep2"].fail = r.err("TransientDeviceError", "standby down")
    made = [r.fab.replication_flush()]
    assert all(p["clientId"] == "sched-A" for _op, p in r.mains["ep0"].payloads)
    r.mains["ep2"].fail = None
    made.append(r.fab.replication_flush())
    r.clock.advance(6.0)
    made.append(r.fab.replication_flush())
    assert made == [1, 0, 1] and r.fab.replicas[2].repl_needs_full is False
    return {**r.observed(), "made": made}


def sc_repl_stale_and_conflict(K):
    r = _Rig(K, n=2, replication=True)
    _deltas(r.fab, [_entry("n0")])
    r.fab.replication_flush()
    r.mains["ep1"].fail = K.errors.StaleEpochError("fresh-epoch")
    _deltas(r.fab, [_entry("n0", gen=2)])
    r.fab.replication_flush()
    assert r.fab.replicas[1].repl_needs_full and r.fab.replicas[1].repl_session_gen is None
    r.mains["ep1"].fail = None
    r.fab.replication_flush()
    assert r.mains["ep1"].payloads[-1][1]["full"] is True
    r.mains["ep1"].fail = K.errors.ConflictError("lease fenced")
    _deltas(r.fab, [_entry("n0", gen=3)])
    r.fab.replication_flush()
    r.mains["ep1"].fail = None
    r.fab.replication_flush()
    assert "sessionGen" not in r.mains["ep1"].payloads[-1][1]
    return r.observed()


def sc_repl_keep_warm(K):
    r = _Rig(K, n=2, replication=True)
    _deltas(r.fab, [_entry("n0")])
    r.fab.heartbeat({"clientId": "sched-A"})
    r.clock.advance(6.0)
    r.fab.replication_flush()
    beats = [p for op, p in r.mains["ep1"].payloads if op == "heartbeat"]
    sched_beat = [p for p in beats if p["clientId"] == "sched-A"][0]
    assert "sessionGen" not in sched_beat and "replicator" not in sched_beat
    assert any(_REPL_ID.match(p["clientId"]) for p in beats)
    return r.observed()


def sc_repl_lag_and_metrics(K):
    r = _Rig(K, n=2, replication=True, metrics=True)
    r.mains["ep1"].fail = r.err("TransientDeviceError", "lagging")
    for gen in (1, 2, 3):
        _deltas(r.fab, [_entry("n0", gen=gen)])
    r.fab.replication_flush()
    lags = [r.fab.replication_lag(r.fab.replicas[1])]
    r.mains["ep1"].fail = None
    r.clock.advance(6.0)
    r.fab.replication_flush()
    lags.append(r.fab.replication_lag(r.fab.replicas[1]))
    assert lags == [3, 0] and r.metrics.standby_resync_bytes.labels("full") > 0
    dump = r.fab.dump()
    assert dump["replication"]["enabled"] is True
    return {**r.observed(), "lags": lags, "dump": _norm(dump)}


def sc_repl_rejoin_reseeds(K):
    r = _Rig(K, n=2, replication=True)
    _deltas(r.fab, [_entry("n0")])
    r.fab.replication_flush()
    r.fab._mark_health(r.fab.replicas[1], False)
    _deltas(r.fab, [_entry("n0", gen=2)])
    made = [r.fab.replication_flush()]
    r.clock.advance(6.0)
    _deltas(r.fab, [_entry("n0", gen=3)])
    assert r.fab.replicas[1].healthy and r.fab.replicas[1].repl_needs_full
    made.append(r.fab.replication_flush())
    payload = [p for op, p in r.mains["ep1"].payloads if op == "apply_deltas"][-1]
    assert made == [0, 1] and payload["full"] is True
    return {**r.observed(), "made": made}


UNIT_SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
                  if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(UNIT_SCENARIOS))
def test_fabric_unit_matches_jax(scenario):
    jax_obs = UNIT_SCENARIOS[scenario](_kit("jax"))
    port_obs = UNIT_SCENARIOS[scenario](_kit("port"))
    assert port_obs == jax_obs


def test_fabric_io_runs_outside_its_locks():
    """No transport call, health probe, replication push or keep-warm
    heartbeat runs under the fabric lock or the replicator's: a stub checks
    both at every call, through a failover, a rejoin and replication
    rounds."""
    K = _kit("port")
    box = {}

    def check():
        fab = box["fab"]
        assert not fab._lock.locked()
        assert fab._repl_cv.acquire(blocking=False)
        fab._repl_cv.release()

    r = _Rig(K, n=3, replication=True, probes=True, check=check)
    box["fab"] = r.fab
    _deltas(r.fab, [_entry("n0"), _entry("n1")])
    r.fab.heartbeat({"clientId": "sched-A"})
    r.clock.advance(6.0)
    assert r.fab.replication_flush() == 2
    r.mains["ep0"].fail = r.err("TransientDeviceError", "down")
    r.probes["ep0"].fail_health = r.err("TransientDeviceError", "down")
    assert r.raises(r.fab.schedule_batch, {"pods": [{}], "batchId": "b-1"}) == "FailoverError"
    _deltas(r.fab, [_entry("n0", gen=2)])
    r.probes["ep0"].fail_health = None
    r.clock.advance(6.0)
    r.fab.schedule_batch({"pods": [], "batchId": "b-2"})
    assert r.fab.replicas[0].healthy and r.fab.active_endpoint() == "ep1"
    assert r.fab.replication_flush() == 2
    calls = sum(len(c.calls) for c in list(r.mains.values()) + list(r.probes.values()))
    assert calls >= 10


def test_concurrent_failers_promote_once():
    """Several lanes fail on the dead active at once: one promotion, one
    failover counted, every caller gets FailoverError naming the new active."""
    K = _kit("port")
    r = _Rig(K, n=3, metrics=True)
    inside = threading.Barrier(4)
    dead = r.mains["ep0"]

    def dying(payload):
        dead.calls.append("schedule_batch")
        inside.wait(timeout=10)  # every lane has picked ep0 before any fails
        raise r.err("TransientDeviceError", "down")

    dead.schedule_batch = dying
    got = []

    def lane(i):
        try:
            r.fab.schedule_batch({"pods": [{}], "batchId": f"b-{i}"})
        except K.errors.FailoverError as exc:
            got.append(exc.to_endpoint)

    threads = [threading.Thread(target=lane, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert got == ["ep1"] * 4
    assert r.fab.failovers == 1 and r.metrics.fabric_failovers.labels("transient") == 1
    assert r.mains["ep1"].calls == ["health"] and r.mains["ep2"].calls == []


@pytest.mark.parametrize("endpoint", ["http://127.0.0.1:9, http://127.0.0.1:10",
                                      ["http://127.0.0.1:9", "http://127.0.0.1:10"]])
def test_wire_scheduler_builds_the_fabric_as_jax(endpoint):
    """Each package's WireScheduler over two endpoints: a fabric with the
    same endpoints, single-attempt probe clients beside the retrying main
    clients, replication on, the same debug dump (before any call)."""
    dumps = []
    for pkg in PKGS:
        K = _kit(pkg)
        store = K.Store()
        store.create_node(K.make_node("n0").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 10}).obj())
        sched = K.service.WireScheduler(store, endpoint=endpoint)
        fab = sched.client
        assert isinstance(fab, K.DeviceFabric)
        for rep in fab.replicas:
            assert rep.probe is not rep.client
            assert rep.probe.retry.max_retries == 0 and rep.client.retry.max_retries == 3
        assert fab.replication_enabled
        d = sched.debug_fabric()
        for rep in d["replicas"]:
            rep["breaker"].pop("openedAt", None)
        dumps.append(_norm(d))
    assert dumps[1] == dumps[0]


# ------------------------------------------------------------ over the socket

GROUP = "train"


def _nodes(pair, n=4, cap="4"):
    def build(api, store):
        for i in range(n):
            store.create_node(api.make_node(f"n{i}").capacity(
                {"cpu": cap, "memory": "16Gi", "pods": 10}).obj())
    pair.build(build)


def _pods(pair, n, prefix="p", cpu="500m", mem=None):
    def build(api, store):
        req = {"cpu": cpu}
        if mem:
            req["memory"] = mem
        for i in range(n):
            store.create_pod(api.make_pod(f"{prefix}{i}").req(req).obj())
    pair.build(build)


def _settle(pair, rounds=2, step=1.1):
    """The rig's settle: run, then ``rounds`` times advance and run again."""
    pair.settle()
    for _ in range(rounds):
        pair.advance(step)
        pair.settle()


def _bound(store) -> dict:
    return {p.meta.name: p.spec.node_name for p in store.pods.values() if p.spec.node_name}


class _Flight:
    """Both packages' flight recorders on for a block."""

    def __enter__(self):
        from kubernetes_tpu.backend import telemetry as jtel
        from kubernetes_tpu_torch.backend import telemetry as ttel

        self.mods = (jtel, ttel)
        self.tele = (jtel.enable(), ttel.enable())
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.disable()


def _check(pair, flight=None, skip=()) -> dict:
    """Port == JAX: the state, the fabric's flight events (when recorded),
    and both sides' surviving mirror unchanged by a forced full resync;
    returns the port's state."""
    state = pair.assert_equal(skip=skip)
    if flight is not None:
        for kinds in (FABRIC_EVENTS, LOOP_EVENTS):
            want = pair.flight(0, flight.tele[0], kinds)
            assert pair.flight(1, flight.tele[1], kinds) == want
    for side in (0, 1):
        store = pair.stores[side]
        bound = _bound(store)
        assert len(bound) == len(store.pods), side
    pair.assert_resync_mirror_identical()
    return state


def test_primary_kill_mid_gang():
    """The primary dies while the gang's batch is on the wire: the whole
    gang lands on the standby, nothing replayed, no degrade (chaos
    ``test_primary_kill_mid_gang_fails_over_whole_gang``)."""
    with FabricPair() as pair, _Flight() as flight:
        _nodes(pair, cap="8")

        def gang(api, store):
            if api is pair.apis[0]:
                from kubernetes_tpu.api.types import ObjectMeta, PodGroup
            else:
                from kubernetes_tpu_torch.api.types import ObjectMeta, PodGroup
            store.create_object("PodGroup", PodGroup(meta=ObjectMeta(name=GROUP), min_member=4,
                                                     schedule_timeout_seconds=30))
            for i in range(4):
                store.create_pod(api.make_pod(f"{GROUP}-{i}").req(
                    {"cpu": "1", "memory": "1Gi"}).pod_group(GROUP).obj())

        pair.build(gang)
        for side in (0, 1):
            pair.plans[side][0].partition("schedule_batch")
        _settle(pair)
        state = _check(pair, flight)
        assert state["active"] == 1 and state["failovers"] == [(("transient",), 1)]
        assert state["service_batches"][0] == 0 and state["service_batches"][1] >= 1
        assert state["degraded_pods"] == 0 and state["breaker"] == "closed"
        assert len(set(_bound(pair.stores[1]).values())) == 4


def test_primary_kill_mid_drain():
    """The primary dies after batch 1 of a multi-batch queue: batch 1's
    binds stay, the rest lands on the re-seeded standby."""
    with FabricPair() as pair, _Flight() as flight:
        _nodes(pair, cap="8")
        _pods(pair, 12, cpu="1", mem="1Gi")
        for side in (0, 1):
            pair.scheds[side].schedule_batch_cycle()
        before = [_bound(s) for s in pair.stores]
        assert before[0] == before[1] and len(before[1]) == 8
        for side in (0, 1):
            pair.plans[side][0].kill()
        _settle(pair)
        state = _check(pair, flight)
        after = _bound(pair.stores[1])
        assert all(after[k] == v for k, v in before[1].items())
        assert state["fabric_failovers"] == 1 and state["degraded_pods"] == 0


def test_asymmetric_partition():
    """Batch traffic to the primary drops while its Health answers: the
    fabric still fails over, and the partitioned primary rejoins as a
    standby, never re-adopted."""
    with FabricPair() as pair, _Flight() as flight:
        _nodes(pair)
        for side in (0, 1):
            pair.plans[side][0].partition()
        _pods(pair, 6)
        _settle(pair)
        pair.advance(6.0)
        _pods(pair, 1, prefix="late")
        _settle(pair, rounds=1)
        state = _check(pair, flight)
        assert state["active"] == 1 and state["healthy"] == [True, True]
        assert state["health_gauge"] == [1, 1]


def test_slow_standby():
    """A laggy-but-live standby does not fail the primary over; when the
    primary dies the slow standby is adopted."""
    with FabricPair() as pair, _Flight() as flight:
        _nodes(pair, cap="8")
        for side in (0, 1):
            pair.plans[side][1].slow(0.05)
        _pods(pair, 4, prefix="a", cpu="1")
        _settle(pair, rounds=1)
        assert pair.each(lambda s, st, side: s.client.failovers) == [0, 0]
        for side in (0, 1):
            pair.plans[side][0].kill()
        _pods(pair, 4, prefix="b", cpu="1")
        _settle(pair)
        state = _check(pair, flight)
        assert state["fabric_failovers"] == 1
        assert any(k == "delay" for _, _, k in pair.plans[1][1].log)


def test_flapping_primary_reseeded_on_failback():
    """Partition A, fail over to B, heal A (a stale mirror on its old
    epoch), kill B, fail back to A: a full resync re-seeds A."""
    with FabricPair() as pair, _Flight() as flight:
        _nodes(pair, cap="8")
        _pods(pair, 4, prefix="w1-", cpu="1")
        _settle(pair, rounds=1)
        for side in (0, 1):
            pair.plans[side][0].partition()
        _pods(pair, 4, prefix="w2-", cpu="1")
        _settle(pair)
        resyncs_mid = pair.each(lambda s, st, side: s.resyncs)
        for side in (0, 1):
            pair.plans[side][0].heal()
        pair.advance(6.0)
        _pods(pair, 2, prefix="w3-", cpu="1")
        _settle(pair, rounds=1)
        for side in (0, 1):
            pair.plans[side][1].kill()
        _pods(pair, 2, prefix="w4-", cpu="1")
        _settle(pair)
        state = _check(pair, flight)
        assert state["fabric_failovers"] == 2 and state["active"] == 0
        assert state["resyncs"] > resyncs_mid[1]


def test_all_replicas_down_then_heal():
    """Every replica dead: the breaker opens and the pods take the
    sequential path, with nothing dispatched; a replica heals, the
    half-open probe rides the fabric's health() and the batched path
    resumes on it."""
    with FabricPair(sched_kw={"breaker_threshold": 2}) as pair, _Flight() as flight:
        _nodes(pair, cap="8")
        for side in (0, 1):
            pair.plans[side][0].kill()
            pair.plans[side][1].kill()
        _pods(pair, 6, cpu="1")
        _settle(pair)
        state = pair.assert_equal()
        assert state["breaker"] == "open" and state["degraded_pods"] >= 6
        assert state["service_batches"] == [0, 0] and state["fabric_failovers"] == 0
        for side in (0, 1):
            pair.plans[side][1].heal()
        pair.advance(5.5)
        _pods(pair, 2, prefix="q", cpu="1")
        _settle(pair)
        state = _check(pair, flight)
        assert state["breaker"] == "closed" and state["active"] == 1
        assert state["service_batches"][0] == 0 and state["service_batches"][1] > 0


@pytest.mark.parametrize("depth", [0, 3])
def test_permanent_failovers_never_open_the_breaker(monkeypatch, depth):
    """Every replica's batch program fails on the card (the same build):
    each cycle fails over with reason ``permanent`` and raises the
    ``PermanentDeviceError`` out of the cycle, as one service's failure
    does. The breaker counts none of them, so no pod takes the host's
    sequential path; once every standby's own breaker is open the last
    replica's error is raised bare, and the pods wait in the queue. The
    port's side only: the JAX client counts these against its breaker."""
    from kubernetes_tpu_torch.backend import service as svc
    from kubernetes_tpu_torch.backend.errors import PermanentDeviceError

    def boom(*args, **kwargs):
        raise RuntimeError("dispatch_device_batch failed on the card")

    monkeypatch.setattr(svc, "dispatch_device_batch", boom)
    with FabricPair(replicas=4, depth=depth) as pair:
        api, store, sched = pair.apis[1], pair.stores[1], pair.scheds[1]
        store.create_node(api.make_node("n0").capacity(
            {"cpu": "8", "memory": "8Gi", "pods": 10}).obj())
        for i in range(3):
            store.create_pod(api.make_pod(f"p{i}").req({"cpu": "1"}).obj())
        for cycle in range(4):
            if cycle:
                pair.clocks[1].advance(0.1)
            with pytest.raises(PermanentDeviceError, match="failed on the card"):
                sched.run_until_settled()
            assert sched.degraded_pods == 0 and sched.breaker.state == "closed"
            assert sched.breaker.consecutive_failures == 0
        fab = pair.fabric(1)
        assert metric_items(sched.smetrics.fabric_failovers) == [(("permanent",), 3)]
        assert fab.active_replica().index == 3 and fab.failovers == 3
        assert [s.batch_counter for s in pair.services_of(1)] == [1, 1, 1, 1]
        assert sched.metrics["scheduled"] == 0
        assert sorted(qp.pod.key() for qp in sched.queue.pending_pod_infos()) == [
            f"default/p{i}" for i in range(3)]
        assert not any(p.spec.node_name for p in store.pods.values())


def test_failover_event_order():
    """The failover event comes strictly after the last poison and names
    both endpoints and that batch; the poisoned pods are requeued after."""
    with FabricPair() as pair, _Flight() as flight:
        _nodes(pair)
        for side in (0, 1):
            pair.plans[side][0].partition("schedule_batch")
        _pods(pair, 4)
        _settle(pair)
        _check(pair, flight)
        events = pair.flight(1, flight.tele[1])
        kinds = [e[0] for e in events]
        last_poison = max(i for i, k in enumerate(kinds) if k == "poison")
        fo = kinds.index("failover")
        assert fo > last_poison and events[fo][1] == events[last_poison][1]
        assert events[fo][2:4] == (1, 0)
        assert "requeue" in kinds[fo:]


def test_churn_with_failover_leaves_no_ghost():
    """Nodes churn while the primary dies: the standby's full seed carries
    no row of the deleted node."""
    with FabricPair() as pair, _Flight() as flight:
        _nodes(pair, cap="8")
        _pods(pair, 6, cpu="1", mem="1Gi")
        _settle(pair)

        def churn(api, store):
            for key in [k for k, p in store.pods.items() if p.spec.node_name == "n0"]:
                pod = store.pods[key]
                store.delete_pod(key)
                store.create_pod(api.make_pod(pod.meta.name).req(
                    {"cpu": "1", "memory": "1Gi"}).obj())
            store.delete_node("n0")
            store.create_node(api.make_node("n9").capacity(
                {"cpu": "8", "memory": "16Gi", "pods": 10}).obj())

        pair.build(churn)
        for side in (0, 1):
            pair.plans[side][0].kill()
        _settle(pair, rounds=4)
        _check(pair, flight)
        for side in (0, 1):
            svc = pair.service(side)
            assert svc is pair.services_of(side)[1]
            state = svc.device if side == 0 else svc.state
            assert "n0" not in svc.infos and "n0" not in state.encoder.node_slots
            assert "n0" not in set(_bound(pair.stores[side]).values())


@pytest.mark.parametrize("dead", [1, 2])
def test_kill_with_batches_in_flight(dead):
    """Three batches in flight on one lane when the batch path of the
    primary (``dead`` 1) or of both replicas (2) dies. The first failing
    call fails over once; with the standby alive the later batches re-send
    to it after the resync, with both dead every batch in flight is
    poisoned and the breaker takes the last to the sequential path. Every
    pod lands once, nothing replayed."""
    with FabricPair(depth=3, batch=4, sched_kw={"wire_max_retries": 0}) as pair, \
            _Flight() as flight:
        _nodes(pair, n=6)
        _pods(pair, 12)
        for side in (0, 1):
            for i in range(dead):
                pair.plans[side][i].partition("schedule_batch")
        # the lane sends nothing until the three batches are in flight: the
        # pushes of the three cycles all reach the primary
        pair.lane_gate.clear()
        for _ in range(3):
            for side in (0, 1):
                pair.scheds[side].schedule_batch_cycle()
        assert pair.each(lambda s, st, side: len(s._wire_inflight)) == [3, 3]
        pair.lane_gate.set()
        for side in (0, 1):
            pair.scheds[side]._drain_wire_inflight()
            pair.plans[side][0].heal()
            pair.plans[side][1].heal()
        pair.advance(6.0)
        _settle(pair, rounds=3)
        state = _check(pair, flight)
        kinds = [e[0] for e in pair.flight(1, flight.tele[1])]
        assert kinds.count("pipeline_poison") == (1 if dead == 1 else 3)
        assert kinds.count("failover") == 1 and sum(state["service_replays"]) == 0
        assert (state["degraded_pods"] > 0) == (dead == 2)


def _steady_state(pair, pods=32):
    """Settle a workload, push the settled truth with one more pod, and
    replicate it (chaos ``TestWarmStandbyChaos._steady_state``)."""
    _pods(pair, pods)
    _settle(pair)
    _pods(pair, 1, prefix="trail", cpu="100m")
    _settle(pair, rounds=1)
    for side in (0, 1):
        pair.fabric(side).replication_flush()


def _uploaded(pair, side) -> tuple:
    svc = pair.services_of(side)[1]
    state = svc.device if side == 0 else svc.state
    return id(state), state.upload_bytes


def test_promote_resyncs_only_the_dirty_suffix():
    """A warm standby's promote-time resync uploads a small part of the
    cold seed: the same DeviceState survives the promote."""
    with FabricPair(batch=16, depth=3, sched_kw={"heartbeat_interval_s": 1.0}) as pair, \
            _Flight() as flight:
        _nodes(pair, n=64, cap="8")
        _steady_state(pair)
        before = [_uploaded(pair, side) for side in (0, 1)]
        assert all(b[1] > 0 for b in before)
        for side in (0, 1):
            pair.plans[side][0].kill()
        _pods(pair, 4, prefix="x", cpu="250m")
        _settle(pair, rounds=4)
        for side in (0, 1):
            ident, now = _uploaded(pair, side)
            assert ident == before[side][0]
            assert (now - before[side][1]) * 4 < before[side][1], side
        state = _check(pair, flight)
        assert state["active"] == 1 and state["fabric_failovers"] == 1


def test_lagging_standby_loses_nothing():
    """The standby's delta path is partitioned when the primary dies with
    batches in flight: the poison precedes the failover, the full resync
    repairs the stale mirror, every pod lands once."""
    with FabricPair(batch=16, depth=3, sched_kw={"heartbeat_interval_s": 1.0}) as pair, \
            _Flight() as flight:
        _nodes(pair, n=8, cap="8")
        _steady_state(pair, pods=8)
        for side in (0, 1):
            pair.plans[side][1].partition("apply_deltas")
        _pods(pair, 6, prefix="lag", cpu="250m")
        _settle(pair, rounds=1)
        lags = []
        for side in (0, 1):
            fab = pair.fabric(side)
            fab.replication_flush()
            lags.append(fab.replication_lag(fab.replicas[1]))
        assert lags[0] == lags[1] > 0
        for side in (0, 1):
            pair.plans[side][1].heal()
            pair.plans[side][0].partition("schedule_batch")
        _pods(pair, 4, prefix="x", cpu="250m")
        _settle(pair, rounds=4)
        state = _check(pair, flight)
        kinds = [e[0] for e in pair.flight(1, flight.tele[1])]
        assert kinds.index("poison") < kinds.index("failover")
        assert state["fabric_failovers"] == 1 and state["service_replays"][1] == 0


def test_standby_sessions_survive_lease_windows():
    """Keep-warm heartbeats carry the replicator's and the client's standby
    sessions across several lease TTLs; the promote still finds the warm
    DeviceState."""
    with FabricPair(batch=16, depth=3, sched_kw={"heartbeat_interval_s": 1.0}) as pair, \
            _Flight() as flight:
        _nodes(pair, n=64, cap="8")
        _steady_state(pair, pods=8)
        before = [_uploaded(pair, side) for side in (0, 1)]
        for _ in range(6):
            pair.advance(6.0)
            pair.settle()
            for side in (0, 1):
                pair.fabric(side).replication_flush()
        for side in (0, 1):
            standby = pair.services_of(side)[1]
            repl = standby.sessions[pair.fabric(side)._repl_client_id]
            assert not repl.fenced and repl.replicator
            assert not standby.sessions[pair.scheds[side].client_id].fenced
        for side in (0, 1):
            pair.plans[side][0].kill()
        _pods(pair, 1, prefix="late", cpu="250m")
        _settle(pair, rounds=4)
        for side in (0, 1):
            ident, now = _uploaded(pair, side)
            assert ident == before[side][0]
            assert (now - before[side][1]) * 4 < before[side][1], side
        state = _check(pair, flight)
        assert state["fabric_failovers"] == 1


def test_three_lanes_hold_the_invariants():
    """The pipelined transport on three lanes (C26: the order the services
    run the batches in follows thread timing, so only the order-free
    invariants compare): a kill with batches in flight, every pod bound
    once, no node over capacity, one program run per batch sent, nothing
    replayed or degraded."""
    with FabricPair(depth=3, batch=4, one_lane=False) as pair:
        _nodes(pair, n=6)
        _pods(pair, 12)
        for side in (0, 1):
            pair.scheds[side].schedule_batch_cycle()
            pair.plans[side][0].kill()
        _settle(pair, rounds=3)
        want = pair.invariants(0)
        got = pair.invariants(1)
        assert got == want
        assert got["bound"] == 12 and not got["over_capacity"]
        assert got["program_runs_equal_batches"] and got["service_replays"] == 0
        assert pair.fabric(1).failovers == pair.fabric(0).failovers == 1
