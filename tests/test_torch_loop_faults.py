"""The scheduler loop's failure model in the port
(``kubernetes_tpu_torch.backend.tpu_scheduler.TPUScheduler``,
``device="cpu"``) against the real JAX ``TPUScheduler`` under
``JAX_PLATFORMS=cpu``, with exact equality (``tests/_torch_cases.py:
LoopPair``): the relay breaker (``backend/circuit.py`` against the JAX
copy; degrade, stay open, heal through the probe, and a failed probe, as
tests/test_faults.py:641 drives them, here through ``relay_fault_fn`` on
both loops; the breaker's state, the degraded seconds and pods, the
sequential binds and the placements after every settle), the stale-mirror
poison that does not count, the device flap of the soak
(tests/test_soak.py:135's size, with the oracle comparer every second
landed winner), the comparer, ``warm_buckets`` and ``_calibrate_sizer``,
and the reclaim pass's SLO breaker (tests/test_quota.py:761). On the port
alone: an error at the read that is not a ``TransientDeviceError`` (a
sticky CUDA error, an out-of-memory, a fault of the commit code) is
raised, not counted; while the
breaker is open no batch is encoded or dispatched; a corrupted placement
is flagged by the comparer. Ring depth 0, depth 2, and depth 2 with the
commit worker on both sides (its commits landed at the end of each cycle)
where the scenario runs through the ring."""

import logging

import numpy as np
import pytest

from _torch_cases import (HOST, ZONE, LoopPair, _topo_wrapper, build_topo_nodes, jax_api,
                          to_jax, topo_cluster_spec, topo_pods_spec, torch_api)

MODES = [("0", "0"), ("2", "0"), ("2", "1")]


@pytest.fixture(params=MODES, ids=["depth0", "depth2", "depth2-worker"])
def mode(request, monkeypatch):
    depth, worker = request.param
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)
    return request.param


@pytest.fixture(autouse=True)
def _quiet():
    """The scripted faults log a traceback per failed commit."""
    logging.disable(logging.ERROR)
    yield
    logging.disable(logging.NOTSET)


def _pair(batch: int = 16, land: bool = True, **sched_kw) -> LoopPair:
    pair = LoopPair(batch=batch, sched_kw=sched_kw)
    if land:
        pair.land_worker_each_cycle()
    return pair


def _close(pair: LoopPair) -> None:
    for sched in (pair.jsched, pair.tsched):
        sched._drain_inflight()
        if sched.commit_worker is not None:
            sched.commit_worker.stop()


def _nodes(pair, n=4, cpu="4"):
    def build(api):
        return [api.make_node(f"node-{i}").capacity({"cpu": cpu, "memory": "32Gi", "pods": 32})
                .label(HOST, f"node-{i}").obj() for i in range(n)]

    for jn, tn in zip(build(jax_api()), build(torch_api())):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)


def _pods(pair, prefix, n, cpu="100m"):
    def build(api):
        return [api.make_pod(f"{prefix}-{i}").req({"cpu": cpu}).obj() for i in range(n)]

    pair.add_pods(build(jax_api()), build(torch_api()))


def _transient():
    # the port's class: the JAX loop counts any exception at the read
    from kubernetes_tpu_torch.backend.errors import TransientDeviceError

    return TransientDeviceError("relay dropped mid-flight")


class _Fault:
    """A scripted device fault for ``relay_fault_fn``: while ``on``, every
    batch commit raises ``make()`` at its read; ``times`` limits the
    faults (None: no limit)."""

    def __init__(self, make=_transient, times=None):
        self.make, self.times, self.on, self.raised = make, times, False, 0

    def __call__(self, _op):
        if not self.on or (self.times is not None and self.raised >= self.times):
            return None
        self.raised += 1
        return self.make()


def _arm(pair: LoopPair, **kw):
    """One fault script per loop, both set as ``relay_fault_fn``."""
    faults = (_Fault(**kw), _Fault(**kw))
    pair.jsched.relay_fault_fn, pair.tsched.relay_fault_fn = faults
    return faults


def _relay_state(pair: LoopPair, which: int) -> dict:
    sched = (pair.jsched, pair.tsched)[which]
    b = sched.relay_breaker
    return {**pair.state(which), "breaker": b.state, "opens": b.opens,
            "failures": b.consecutive_failures, "degraded_pods": sched.relay_degraded_pods,
            "fallback": sched.fallback_scheduled, "batch_scheduled": sched.batch_scheduled,
            "degraded_s": sched.smetrics.degraded_seconds.labels(),
            "gauge": sched.smetrics.backend_circuit_state.labels()}


def _step(pair: LoopPair, faults, on: bool, advance: float = 0.0) -> dict:
    """Advance both clocks, set the fault, settle both loops, and return
    the port's relay state after asserting it equals the JAX loop's."""
    for f in faults:
        f.on = on
    if advance:
        pair.advance(advance)
    pair.settle()
    jax_state, port_state = _relay_state(pair, 0), _relay_state(pair, 1)
    for key in jax_state:
        assert port_state[key] == jax_state[key], key
    return port_state


# ---------------------------------------------------------------- the breaker


BREAKER_SCRIPTS = {
    # threshold, reset, steps: "f" failure, "s" success, "a" allow, a
    # number advances the clock
    "threshold-then-heal": (2, 0.5, ["a", "f", "a", "f", "a", 0.3, "a", 0.3, "a", "s", "a"]),
    "failed-probe": (3, 5.0, ["f", "f", "s", "f", "f", "f", "a", 5.0, "a", "f", "a", 5.1,
                              "a", "f", 4.0, "a", 1.5, "a", "s", "f"]),
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_circuit_breaker_matches_jax(script):
    """The same FakeClock script drives both breakers: equal states, allow
    answers, opens, transitions and ``dump()`` after every step."""
    from kubernetes_tpu.backend.circuit import CircuitBreaker as JBreaker
    from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
    from kubernetes_tpu_torch.backend.circuit import CircuitBreaker
    from kubernetes_tpu_torch.utils.clock import FakeClock

    threshold, reset, steps = BREAKER_SCRIPTS[script]
    clocks = (JFakeClock(), FakeClock())
    seen = ([], [])
    breakers = [cls(failure_threshold=threshold, reset_timeout_s=reset, now_fn=clock,
                    on_state_change=lambda old, new, log=log: log.append((old, new)))
                for cls, clock, log in zip((JBreaker, CircuitBreaker), clocks, seen)]
    for step in steps:
        answers = []
        for b, clock in zip(breakers, clocks):
            if step == "a":
                answers.append(b.allow())
            elif step == "f":
                b.record_failure(RuntimeError("x"))
            elif step == "s":
                b.record_success()
            else:
                clock.advance(step)
        assert answers[:1] == answers[1:]
        assert breakers[1].dump() == breakers[0].dump()
        assert seen[1] == seen[0]
    assert breakers[1].opens >= 1


def test_relay_death_degrades_and_probe_heals(mode):
    """tests/test_faults.py:641 on both loops: two commits die (threshold
    2), the breaker opens and every pod takes the sequential path, counted
    as degraded; healed, the breaker stays open until its probe interval,
    then the probe batch commits on the device and closes it."""
    pair = _pair(batch=4, relay_breaker_threshold=2, relay_probe_interval_s=5.0)
    faults = _arm(pair)
    _nodes(pair)
    _pods(pair, "p", 4)
    got = _step(pair, faults, True)
    assert got["breaker"] == "closed" and got["failures"] == 1
    assert got["metrics"]["scheduled"] == 0 and got["pending"]["backoff"] == 4
    got = _step(pair, faults, True, advance=1.1)
    assert got["breaker"] == "open" and got["gauge"] == 2 and got["degraded_s"] == 0
    got = _step(pair, faults, True, advance=2.1)
    assert got["breaker"] == "open"
    assert got["metrics"]["scheduled"] == got["degraded_pods"] == got["fallback"] == 4
    _pods(pair, "q", 2)
    got = _step(pair, faults, False, advance=1.0)
    assert got["breaker"] == "open" and got["metrics"]["scheduled"] == 6
    assert got["degraded_pods"] == 6 and got["batch_scheduled"] == 0
    _pods(pair, "r", 2)
    got = _step(pair, faults, False, advance=2.0)
    _close(pair)
    assert got["breaker"] == "closed" and got["gauge"] == 0
    assert got["metrics"]["scheduled"] == 8 and got["batch_scheduled"] == 2
    assert got["degraded_pods"] == 6 and got["fallback"] == 6
    assert got["degraded_s"] == pytest.approx(5.1)


def test_failed_probe_reopens(mode):
    """The probe batch's commit dies too: the breaker opens again at once
    (two openings) and heals at the next probe."""
    pair = _pair(batch=4, relay_breaker_threshold=2, relay_probe_interval_s=5.0)
    faults = _arm(pair)
    _nodes(pair)
    _pods(pair, "p", 2)
    _step(pair, faults, True)
    got = _step(pair, faults, True, advance=1.1)
    assert got["breaker"] == "open" and got["opens"] == 1
    got = _step(pair, faults, True, advance=5.1)
    assert got["breaker"] == "open" and got["opens"] == 2
    assert got["metrics"]["scheduled"] == 0 and got["degraded_pods"] == 0
    got = _step(pair, faults, False, advance=5.1)
    _close(pair)
    assert got["breaker"] == "closed" and got["metrics"]["scheduled"] == 2
    assert got["batch_scheduled"] == 2 and got["fallback"] == 0


def test_stale_mirror_poison_does_not_count(monkeypatch):
    """With the worker and a ring of depth 2, the first commit dies with
    two more batches in flight on the dropped mirror: they are poisoned
    when they reach the worker, without counting against the breaker (one
    failure, not three), on both loops."""
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "2")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "1")
    pair = _pair(batch=16)
    faults = _arm(pair, times=1)
    _nodes(pair)
    _pods(pair, "p", 64)
    for f in faults:
        f.on = True
    for sched in (pair.jsched, pair.tsched):
        for _ in range(4):
            sched.schedule_batch_cycle()
    for which in (0, 1):
        b = (pair.jsched, pair.tsched)[which].relay_breaker
        assert (b.state, b.consecutive_failures) == ("closed", 1), which
    assert pair.tsched.pipelined_batches == pair.jsched.pipelined_batches
    _step(pair, faults, True, advance=1.1)
    got = _step(pair, faults, True, advance=2.1)
    _close(pair)
    assert got["metrics"]["scheduled"] == 64 and got["failures"] == 0


@pytest.mark.parametrize("kind", ["runtime", "accelerator", "oom", "index", "key"])
def test_sticky_cuda_error_is_raised(kind, mode):
    """Port only: an error at the read that is not a
    ``TransientDeviceError`` (a sticky CUDA error: the text torch gives an
    illegal address, ``torch.AcceleratorError`` where torch has it; a CUDA
    out-of-memory; an IndexError or KeyError of a commit gone wrong)
    poisons the ring, drops the mirror and is raised out of the loop; the
    breaker does not count it."""
    import torch

    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    text = "CUDA error: an illegal memory access was encountered"
    makers = {"runtime": lambda: RuntimeError(text),
              "accelerator": lambda: torch.AcceleratorError(text),
              "oom": lambda: torch.OutOfMemoryError("CUDA out of memory"),
              "index": lambda: IndexError("index 5120 is out of bounds"),
              "key": lambda: KeyError("node-9")}
    if kind == "accelerator" and not hasattr(torch, "AcceleratorError"):
        pytest.skip("this torch has no AcceleratorError")
    make = makers[kind]
    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = TPUScheduler(store, device="cpu", now_fn=clock, batch_size=16, batch_deadline_ms=0)
    for node in (torch_api().make_node(f"node-{i}").capacity({"cpu": "4", "pods": 32}).obj()
                 for i in range(4)):
        store.create_node(node)
    for i in range(8):
        store.create_pod(torch_api().make_pod(f"p-{i}").req({"cpu": "100m"}).obj())
    fault = _Fault(make=make, times=1)
    fault.on = True
    sched.relay_fault_fn = fault
    with pytest.raises(type(make())):
        sched.run_until_settled()
    assert fault.raised == 1 and sched.state is None and not sched._inflight
    assert sched.relay_breaker.consecutive_failures == 0
    assert sched.relay_breaker.state == "closed"
    assert sched.queue.pending_pods()["backoff"] == 8
    clock.advance(1.1)
    sched.queue.flush_backoff_completed()
    sched.run_until_settled()
    sched.close()
    assert sched.metrics["scheduled"] == 8 and sched.relay_breaker.opens == 0


def test_open_breaker_touches_no_device(monkeypatch):
    """Port only: while the breaker is open, a cycle builds no mirror,
    encodes and dispatches nothing (each raises here if called) and sends
    every pod down the sequential path; the probe past the interval runs
    the batch again."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend import device_state, tpu_scheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = tpu_scheduler.TPUScheduler(store, device="cpu", now_fn=clock, batch_size=4,
                                       batch_deadline_ms=0, relay_breaker_threshold=1,
                                       relay_probe_interval_s=5.0)
    for node in (torch_api().make_node(f"node-{i}").capacity({"cpu": "4", "pods": 32}).obj()
                 for i in range(4)):
        store.create_node(node)
    for i in range(4):
        store.create_pod(torch_api().make_pod(f"p-{i}").req({"cpu": "100m"}).obj())
    fault = _Fault(times=1)
    fault.on = True
    sched.relay_fault_fn = fault
    sched.run_until_settled()
    assert sched.relay_breaker.state == "open" and sched.state is None

    def forbidden(*_a, **_k):
        raise AssertionError("the device was touched while the breaker is open")

    saved = {name: getattr(tpu_scheduler, name)
             for name in ("encode_device_batch", "dispatch_device_batch", "run_batch_program")}
    for name in saved:
        monkeypatch.setattr(tpu_scheduler, name, forbidden)
    monkeypatch.setattr(tpu_scheduler.TPUScheduler, "_ensure_device", forbidden)
    monkeypatch.setattr(device_state.DeviceState, "sync", forbidden)
    monkeypatch.setattr(device_state.DeviceState, "__init__", forbidden)
    clock.advance(1.1)
    sched.queue.flush_backoff_completed()
    for i in range(3):
        store.create_pod(torch_api().make_pod(f"q-{i}").req({"cpu": "100m"}).obj())
    sched.run_until_settled()
    assert sched.metrics["scheduled"] == 7 and sched.relay_degraded_pods == 7
    assert sched.batch_counter == 1 and sched.state is None
    monkeypatch.undo()
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    store.create_pod(torch_api().make_pod("r-0").req({"cpu": "100m"}).obj())
    clock.advance(5.0)
    sched.run_until_settled()
    assert sched.relay_breaker.state == "closed" and sched.batch_scheduled == 1
    assert sched.metrics["scheduled"] == 8 and sched.batch_counter == 2


# ---------------------------------------------------------------- the soak's flap


@pytest.mark.parametrize("claims", [True, False], ids=["claims", "noclaims"])
def test_flap_soak_matches_jax(claims, mode):
    """tests/test_soak.py:135's size (32 nodes, 4 rounds, scale 6; gangs,
    claim pods and preemptors) through ``workloads.soak_rounds`` on both
    loops with the device flap and the comparer every second landed
    winner: equal binds, pops, queues, ledgers, claims, the breaker's state
    after every cycle and the invariants; the flap spent its three batches,
    degraded seconds accrued, the comparer checked as many winners and
    found nothing on the port (the JAX comparer also flags, through the
    ring, winners whose quota the batch committed before them used up:
    ROADMAP C18)."""
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_soak(nodes=32, rounds=4, scale=6, claims=claims)
    pair = _pair(batch=32, comparer_every_n=2)
    for ni in w.node_infos():
        pair.create("create_node", ni.node)
    for q in w.quotas():
        pair.add_quota(q.meta.namespace, q.hard, weight=q.weight, cohort=q.cohort)
    jout = workloads.soak_rounds(w, pair.jstore, pair.jsched, pair.jsched._quota_plugin(),
                                 pair.jclock, convert=to_jax)
    tout = workloads.soak_rounds(w, pair.tstore, pair.tsched, pair.tsched._quota_plugin(),
                                 pair.tclock)
    _close(pair)
    pair.assert_volume_equal()
    assert pair.assert_gang_equal()["waiting"] == []
    j_mismatches = jout.pop("comparer_mismatches")
    assert tout.pop("comparer_mismatches") == 0 and j_mismatches >= 0
    assert tout == jout
    assert tout["flap_batches"] == 3 and tout["degraded_s"] > 0 and 2 in tout["breaker"]
    assert tout["breaker_state"] == 0 and tout["oversubscription"] == 0
    assert tout["comparer_checks"] > 0
    assert sum(tout["bound"].values()) > 0
    assert pair.tsched.relay_breaker.opens == pair.jsched.relay_breaker.opens == 1
    assert pair.tsched.relay_degraded_pods == pair.jsched.relay_degraded_pods


# ---------------------------------------------------------------- the comparer


def test_comparer_matches_jax(mode):
    """Every landed winner checked (``comparer_every_n=1``) on a
    topology cluster with seeded pods: equal placements and checks on both
    loops, no mismatch on the port (the JAX comparer, reading the snapshot
    before the batch's winners are assumed, flags winners whose affinity an
    earlier winner of the batch satisfied: ROADMAP C18)."""
    pair = _pair(batch=16, comparer_every_n=1)
    spec = topo_cluster_spec(12, 5)
    pair.add_nodes(build_topo_nodes(jax_api(), spec), build_topo_nodes(torch_api(), spec))
    pods = topo_pods_spec(40, 6)
    pair.add_pods([_topo_wrapper(jax_api(), d).obj() for d in pods],
                  [_topo_wrapper(torch_api(), d).obj() for d in pods])
    pair.settle()
    got = pair.assert_equal()
    _close(pair)
    assert pair.tsched.comparer_checks == pair.jsched.comparer_checks
    assert pair.tsched.comparer_checks == pair.tsched.batch_scheduled > 0
    assert pair.tsched.comparer_mismatches == 0
    assert sum(map(bool, got["placed"].values())) > 0


def test_comparer_flags_a_corrupted_placement(monkeypatch):
    """Port only: the packed block's read is rewritten so that the first
    pod lands on the tainted node the device did not choose: the comparer
    counts one mismatch."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend import commit_plane, tpu_scheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = tpu_scheduler.TPUScheduler(store, device="cpu", now_fn=clock, batch_size=4,
                                       batch_deadline_ms=0, comparer_every_n=1)
    store.create_node(torch_api().make_node("node-0").capacity({"cpu": "4", "pods": 32})
                      .taint("dedicated", "x").obj())
    store.create_node(torch_api().make_node("node-1").capacity({"cpu": "4", "pods": 32}).obj())
    store.create_pod(torch_api().make_pod("p-0").req({"cpu": "100m"}).obj())
    real = commit_plane.materialize_result

    def corrupted(disp, n_nodes):
        node_idx, ff, sw, qw = real(disp, n_nodes)
        node_idx = node_idx.copy()
        node_idx[0] = sched.state.encoder.node_slots["node-0"]
        return node_idx, ff, sw, qw

    # the loop reads through commit_plane.materialize_profiled, which calls it
    monkeypatch.setattr(commit_plane, "materialize_result", corrupted)
    sched.run_until_settled()
    sched.close()
    assert sched.comparer_checks == 1 and sched.comparer_mismatches == 1


# ---------------------------------------------------------------- warm_buckets


def _mirror(sched) -> dict:
    """The port's mirror tensors, copied."""
    import dataclasses

    state = sched.state
    out = {}
    for group in (state.nt, state.tc):
        for f in dataclasses.fields(group):
            v = getattr(group, f.name)
            if hasattr(v, "clone"):
                out[f"{type(group).__name__}.{f.name}"] = v.clone()
    return out


SAMPLES = {
    "default": None,
    # a zone spread constraint: the topology program and its carry variant
    "spread": {"name": "warm-0", "cpu": "100m", "mem": "128Mi", "labels": {"app": "web"},
               "spread": [(1, ZONE, "DoNotSchedule", {"app": "web"}, None)],
               "affinity": [], "preferred": [], "port": 0, "nominated": ""},
}


@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_warm_buckets_match_jax(sample, monkeypatch):
    """Both loops warm every bucket of a 32-pod sizer (16 and 32) after
    their init pods settle: the same count of programs; the port's mirror,
    batch records and sampling carry unchanged; then the measured pods
    settle to the JAX loop's placements, and to those of a port loop that
    never warmed."""
    import torch

    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "2")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    spec = topo_cluster_spec(12, 7)
    init, measured = topo_pods_spec(10, 8), topo_pods_spec(30, 9)
    pair = _pair(batch=32)
    pair.add_nodes(build_topo_nodes(jax_api(), spec), build_topo_nodes(torch_api(), spec))
    alone_clock = FakeClock()
    alone_store = Store(now_fn=alone_clock)
    alone_store.validation_enabled = False  # as the pair's stores (the specs as they are)
    alone = TPUScheduler(alone_store, device="cpu", now_fn=alone_clock, batch_size=32,
                         batch_deadline_ms=0)
    for ni in build_topo_nodes(torch_api(), spec):
        alone_store.create_node(ni.node)
        for p in ni.pods:
            alone_store.create_pod(p)

    def add(pods):
        pair.add_pods([_topo_wrapper(jax_api(), d).obj() for d in pods],
                      [_topo_wrapper(torch_api(), d).obj() for d in pods])
        for d in pods:
            alone_store.create_pod(_topo_wrapper(torch_api(), d).obj())

    add(init)
    pair.settle()
    alone.run_until_settled()
    t = pair.tsched
    # the sync warm_buckets starts with (what the next batch would run)
    t.cache.update_snapshot(t.snapshot)
    t._sync_grown()
    before = (_mirror(t), t.batch_counter, list(t.batch_modes), list(t.batch_paths),
              dict(t.stage_seconds), t._start_carry, t.state)
    d = SAMPLES[sample]
    jn = pair.jsched.warm_buckets(None if d is None else [_topo_wrapper(jax_api(), d).obj()])
    tn = t.warm_buckets(None if d is None else [_topo_wrapper(torch_api(), d).obj()])
    assert tn == jn and tn >= 4
    mirror, *records, state = before
    assert [t.batch_counter, t.batch_modes, t.batch_paths, t.stage_seconds,
            t._start_carry] == records and t.state is state
    after = _mirror(t)
    assert after.keys() == mirror.keys()
    for k, v in mirror.items():
        assert torch.equal(after[k], v), k
    assert t.warm_launches == 0  # the plain versions on the CPU
    add(measured)
    pair.settle()
    alone.run_until_settled()
    got = pair.assert_equal()
    _close(pair)
    alone.close()
    assert got["placed"] == {k: p.spec.node_name for k, p in alone_store.pods.items()}
    assert sum(map(bool, got["placed"].values())) > 20


TIMINGS = {
    "linear": [(16, 0.0021), (32, 0.0034), (64, 0.0061), (128, 0.0113)],
    "noisy": [(16, 0.004), (32, 0.0031), (64, 0.0079), (128, 0.0102)],
    "flat": [(16, 0.005), (32, 0.004)],  # a slope <= 0 leaves the sizer as it was
    "one": [(16, 0.003)],
}


@pytest.mark.parametrize("timings", sorted(TIMINGS))
@pytest.mark.parametrize("depth", ["0", "2"])
def test_calibrate_sizer_matches_jax(timings, depth, monkeypatch):
    """The same warm timings leave both sizers bit-equal (the latency and
    commit-wait fits, their update counts, the sticky bucket) at a 500 ms
    deadline and ring depths 0 and 2; the next target too."""
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    pair = _pair(batch=128)
    sizers = []
    for sched in (pair.jsched, pair.tsched):
        sched.sizer.deadline_s = 0.5
        sched._calibrate_sizer(TIMINGS[timings])
        s = sched.sizer
        sizers.append((s._fit.a, s._fit.b, s._fit.updates, s._fit.outliers, s._wfit.a,
                       s._wfit.b, s._wfit.updates, s._bucket, s.target()))
    _close(pair)
    assert sizers[1] == sizers[0]


# ---------------------------------------------------------------- the reclaim breaker


def test_reclaim_breaker_suspends_on_slo_regression():
    """tests/test_quota.py:761 on both loops: a guard that judges every
    wave a lender-SLO regression; three lender pods, one at a time, each
    8 s after the last (past the 5 s reclaim cooldown): two passes evict
    and count, the third finds the breaker open and the pass suspended;
    the ledger's dump, evictions and placements equal."""
    pair = _pair(batch=16)
    _nodes(pair, cpu="8")
    pair.add_quota("lend", {"pods": 6}, weight=2, cohort="pool")
    pair.add_quota("hungry", {"pods": 2}, cohort="pool")
    plugins = (pair.jsched._quota_plugin(), pair.tsched._quota_plugin())
    for p in plugins:
        p.reclaim_guard_fn = lambda: False

    def pods(prefix, n, ns):
        def build(api):
            return [api.make_pod(f"{prefix}{i}", namespace=ns).req({"cpu": "1", "memory": "1Gi"})
                    .obj() for i in range(n)]

        pair.add_pods(build(jax_api()), build(torch_api()))

    def churn(rounds=40):
        for _ in range(rounds):
            pair.advance(0.2)
            pair.settle()

    pods("b", 8, "hungry")
    pair.settle()
    assert [p.borrowed("hungry")["pods"] for p in plugins] == [6, 6]
    for i in range(3):
        pods(f"l{i}-", 1, "lend")
        churn()
    got = pair.assert_gang_equal()
    _close(pair)
    jp, tp = plugins
    assert tp.reclaim_breaker.state == jp.reclaim_breaker.state == "open"
    assert tp.reclaim_suspended is jp.reclaim_suspended is True
    assert tp.reclaims_executed == jp.reclaims_executed == 2
    assert pair.tsched.smetrics.quota_reclaims.labels("suspended") >= 1
    for key in ("evicted", "noop", "suspended"):
        assert (pair.tsched.smetrics.quota_reclaims.labels(key)
                == pair.jsched.smetrics.quota_reclaims.labels(key)), key
    assert tp.dump() == jp.dump()
    assert sum(1 for k, n in got["placed"].items() if n and k.startswith("lend/")) >= 2


def test_slot_reuse_metric_matches_jax(mode):
    """A node leaves and two join: the first newcomer takes the
    tombstoned slot, and ``device_slot_reuse`` counts it on both loops."""
    pair = _pair(batch=16)
    _nodes(pair, n=4)
    _pods(pair, "p", 8)
    pair.settle()
    for key in [k for k, p in pair.tstore.pods.items() if p.spec.node_name == "node-3"]:
        pair.delete_pod(key)
    pair.jstore.delete_node("node-3")
    pair.tstore.delete_node("node-3")
    for name in ("node-4", "node-5"):
        for store, api in ((pair.jstore, jax_api()), (pair.tstore, torch_api())):
            store.create_node(api.make_node(name).capacity(
                {"cpu": "4", "memory": "32Gi", "pods": 32}).label(HOST, name).obj())
    _pods(pair, "q", 8)
    pair.settle()
    pair.assert_equal()
    _close(pair)
    reuse = [s.smetrics.device_slot_reuse.labels() for s in (pair.jsched, pair.tsched)]
    assert reuse[1] == reuse[0] >= 1


def test_relay_death_script_matches_jax(mode):
    """``workloads.relay_death`` on both loops at a small size (12 nodes,
    batch 16, waves of 16, 8 and 16 pods): equal steps, placements, queues
    and degraded seconds; the breaker opens at the second step, every pod
    retried or arriving while it is open takes the sequential path, no
    batch is dispatched meanwhile, and the probe batch closes it."""
    from kubernetes_tpu_torch.perf import workloads

    pair = _pair(batch=16, relay_breaker_threshold=workloads.RELAY_DEATH_THRESHOLD,
                 relay_probe_interval_s=workloads.RELAY_DEATH_PROBE_S)
    _nodes(pair, n=12)
    waves = [[torch_api().make_pod(f"w{k}-{i}").req({"cpu": "100m"}).obj() for i in range(n)]
             for k, n in enumerate((16, 8, 16))]
    jout = workloads.relay_death(pair.jstore, pair.jsched, pair.jclock, waves, convert=to_jax)
    tout = workloads.relay_death(pair.tstore, pair.tsched, pair.tclock, waves)
    _close(pair)
    got = pair.assert_equal()
    assert tout == jout
    steps = tout["steps"]
    assert [st["state"] for st in steps] == ["closed", "open", "open", "open", "closed"]
    assert steps[3]["degraded_pods"] == steps[3]["fallback_scheduled"] == 24
    assert len({st["batches"] for st in steps[1:4]}) == 1
    assert steps[4]["batch_scheduled"] == 16 and tout["faults"] == 2
    assert tout["degraded_s"] == pytest.approx(5.1)
    assert sum(map(bool, got["placed"].values())) == 40
