"""The port's pod-lifetime latency ledger (``kubernetes_tpu_torch/metrics/
latency_ledger.py``) against the JAX package's on the CPU.

The JAX ledger tests' mechanics (``tests/test_latency_ledger.py:45-170``)
are fed to both ledgers, each on its own FakeClock: segment accumulation and
the close's observations, the tenant label bound, a deleted pod skipping
the tenant SLO, the cap and its eviction counter, one clock read per batch
transition, no resurrection of a dropped entry, and the ``chrome_trace``
document; the entry views, the metrics and the documents are equal.

Through ``LoopPair`` (both loops on the CPU, each ledger on its own side's
FakeClock): basic batches, failures across attempts (backoffQ and the
unschedulable map), a ring poison and requeue, a gang's Permit park and a
whole-gang reject, deletes under churn, quota tenants (the gated park
and the fair-share wait), and SchedulingBorrow's quota reclaim (evicted
pods recreated unbound), at ring depth 0 and 2. Every entry, closed or
live, equals the JAX loop's: its result, its segments (zero-length ones
included), the order of its intervals, its e2e and its intervals' clock
values. Every closed entry's e2e equals the sum of its segments to 1e-9
relative, and every pod the loop bound closed as scheduled."""

import json

import pytest

from _torch_cases import LOOP_SCENARIOS, LoopPair, Recorders, jax_api, ledger_view, torch_api


@pytest.fixture(autouse=True)
def _ledgers_off():
    yield
    from kubernetes_tpu.metrics import latency_ledger as jled
    from kubernetes_tpu_torch.metrics import latency_ledger as tled

    jled.disable()
    tled.disable()


def _both():
    """(JAX module, JAX metrics class, JAX FakeClock), the port's."""
    from kubernetes_tpu.metrics import latency_ledger as jled
    from kubernetes_tpu.metrics.scheduler_metrics import SchedulerMetrics as JMetrics
    from kubernetes_tpu.utils.clock import FakeClock as JClock
    from kubernetes_tpu_torch.metrics import latency_ledger as tled
    from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics
    from kubernetes_tpu_torch.utils.clock import FakeClock

    return (jled, JMetrics, JClock), (tled, SchedulerMetrics, FakeClock)


def _hist(h, *labels):
    return (h.count(*labels), round(h.sum(*labels), 9))


def _accumulate(mod, metrics_cls, clock_cls):
    clock, m = clock_cls(), metrics_cls()
    led = mod.PodLatencyLedger(m, now_fn=clock, tenant_fn=lambda ns: 2 if ns == "t" else None)
    for seg, dt in (("queue.active", 1.0), ("cycle.host", 0.5), ("queue.backoff", 2.0),
                    ("cycle.host", 0.25), ("bind", 0.125)):
        led.transition("t/p", seg, namespace="t")
        clock.advance(dt)
    led.close("t/p", "scheduled")
    return (led.entry("t/p"), len(led), _hist(m.pod_e2e_duration, "scheduled"),
            _hist(m.pod_latency_segment, "cycle.host"), _hist(m.tenant_e2e_duration, "t"))


def _tenant_bound(mod, metrics_cls, clock_cls):
    m = metrics_cls()
    led = mod.PodLatencyLedger(m, now_fn=clock_cls(),
                               tenant_fn=lambda ns: 1 if ns == "quota" else None)
    for ns in ("quota", "default", "anon-1", "anon-2"):
        led.transition(f"{ns}/p", "queue.active", namespace=ns)
        led.close(f"{ns}/p", "scheduled")
    return m.tenant_e2e_duration.label_sets(), m.pod_e2e_duration.count("scheduled")


def _deleted(mod, metrics_cls, clock_cls):
    m = metrics_cls()
    led = mod.PodLatencyLedger(m, now_fn=clock_cls(), tenant_fn=lambda ns: 1)
    led.transition("t/p", "queue.active", namespace="t")
    led.drop("t/p")
    return m.pod_e2e_duration.count("deleted"), m.tenant_e2e_duration.label_sets()


def _cap(mod, metrics_cls, clock_cls):
    m = metrics_cls()
    led = mod.PodLatencyLedger(m, cap=4, now_fn=clock_cls())
    for i in range(10):
        led.transition(f"ns/p{i}", "queue.active", namespace="ns")
    return (len(led), led.evicted, m.ledger_evicted.labels(), led.entry("ns/p0"),
            led.entry("ns/p9"), led.dump())


def _batch(mod, metrics_cls, clock_cls):
    clock = clock_cls()
    led = mod.PodLatencyLedger(now_fn=clock)
    keys = ["a/1", "a/2", "a/3"]
    led.transition_many(keys, "queue.active", create=True)
    clock.advance(1.0)
    led.transition_many(keys, "device.inflight", batch_id="b7")
    clock.advance(0.5)
    led.close_many(keys, "scheduled")
    return [led.entry(k) for k in keys]


def _no_resurrection(mod, metrics_cls, clock_cls):
    m = metrics_cls()
    led = mod.PodLatencyLedger(m, now_fn=clock_cls())
    led.transition("ns/p", "queue.active", namespace="ns")
    led.transition_many(["ns/p"], "device.inflight", batch_id="b1")
    led.drop("ns/p")
    led.transition_many(["ns/p"], "commit.host")
    led.transition("ns/p", "bind", create=False)
    live = len(led)
    led.close_many(["ns/p"], "scheduled")
    mod.close_skipped("ns/p", None)  # the module hook with no ledger on
    return (live, m.pod_e2e_duration.count("deleted"), m.pod_e2e_duration.count("scheduled"),
            led.dump())


def _chrome(mod, metrics_cls, clock_cls):
    clock = clock_cls(1000.0)
    led = mod.PodLatencyLedger(now_fn=clock)
    led.transition("ns/p", "queue.active", namespace="ns")
    clock.advance(1.0)
    led.transition("ns/p", "device.inflight", batch_id="b1")
    clock.advance(1.0)
    led.close("ns/p", "scheduled")
    led.transition("ns/q", "queue.backoff", namespace="ns")  # live: closed at 'now'
    dispatch = [{"t": 1002.0, "program": "schedule_batch", "bucket": "16/off", "batchId": "b1",
                 "window": {"dwell": 0.25, "exec": 0.5, "fetch": 0.125}}]
    doc = mod.chrome_trace(flight=[{"seq": 1, "t": 1001.0, "type": "dispatch", "batchId": "b1"}],
                           ledger=led, dispatch=dispatch)
    return json.loads(json.dumps(doc))


MECHANICS = {"accumulate": _accumulate, "tenant_bound": _tenant_bound, "deleted": _deleted,
             "cap": _cap, "batch": _batch, "no_resurrection": _no_resurrection,
             "chrome_trace": _chrome}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_mechanics_match_jax(case):
    jax_side, port_side = _both()
    want, got = MECHANICS[case](*jax_side), MECHANICS[case](*port_side)
    assert got == want


def test_mechanics_values():
    """The port's own numbers on the mechanics above (the JAX ledger's
    asserted values)."""
    _, port_side = _both()
    entry, live, e2e, cycle, tenant = _accumulate(*port_side)
    assert entry["segments"] == {"queue.active": 1.0, "cycle.host": 0.75,
                                 "queue.backoff": 2.0, "bind": 0.125}
    assert entry["closed"] - entry["opened"] == pytest.approx(3.875)
    assert live == 0 and e2e[0] == 1 and cycle == (1, 0.75) and tenant[0] == 1
    assert _tenant_bound(*port_side) == ([("quota",)], 4)
    assert _deleted(*port_side) == (1, [])
    assert _cap(*port_side)[:4] == (4, 6, 6, None)
    live, deleted, scheduled, _dump = _no_resurrection(*port_side)
    assert (live, deleted, scheduled) == (0, 1, 0)
    doc = _chrome(*port_side)
    slices = [e for e in doc["traceEvents"] if e.get("cat") == "ledger"]
    assert {e["name"] for e in slices} == {"queue.active", "device.inflight", "queue.backoff"}
    assert [e["name"] for e in doc["traceEvents"] if e.get("cat") == "dispatch"] == [
        "schedule_batch.fetch", "schedule_batch.exec", "schedule_batch.dwell"]


def test_segments_are_the_jax_registry():
    jax_side, port_side = _both()
    assert port_side[0].SEGMENTS == jax_side[0].SEGMENTS


@pytest.mark.parametrize("hook", ["transition", "transition_many", "close", "close_many",
                                  "drop", "close_skipped"])
def test_disabled_module_hook(hook):
    """Off by default: each module hook is one global read and returns."""
    _, (tled, _m, _c) = _both()
    assert tled.get() is None
    args = {"transition": ("ns/p", "queue.active"), "transition_many": (["ns/p"], "bind"),
            "close": ("ns/p",), "close_many": (["ns/p"],), "drop": ("ns/p",),
            "close_skipped": ("ns/p", None)}[hook]
    assert getattr(tled, hook)(*args) is None


def test_enable_from_env(monkeypatch):
    """``KTPU_LEDGER=1`` turns the ledger on when a loop is built, fed by
    its metrics and bounded by its quota tenants."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.metrics import latency_ledger as tled

    monkeypatch.setenv("KTPU_LEDGER", "1")
    sched = TPUScheduler(Store(), device="cpu")
    led = tled.get()
    assert led is not None and led.metrics is sched.smetrics
    assert led.tenant_fn == sched._ns_fair_weight


# ------------------------------------------------------------------ through the loops


def _scenario_tenants(pair) -> None:
    """Two quota tenants over their caps (the gated park, the release move
    on delete) beside default-namespace pods (the fair-share wait)."""
    def nodes(api):
        return [api.make_node(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": 32})
                .label("kubernetes.io/hostname", f"node-{i}").obj() for i in range(4)]

    def pods(api, ns, n):
        return [api.make_pod(f"{ns}-{i}", namespace=ns).req({"cpu": "100m"}).obj()
                for i in range(n)]

    for jn, tn in zip(nodes(jax_api()), nodes(torch_api())):
        pair.jstore.create_node(jn)
        pair.tstore.create_node(tn)
    pair.add_quota("t1", {"pods": 4}, weight=2)
    pair.add_quota("t2", {"pods": 3}, weight=1)
    for ns, n in (("t1", 8), ("t2", 6), ("default", 6)):
        pair.add_pods(pods(jax_api(), ns, n), pods(torch_api(), ns, n))
    pair.settle()
    # t2 at its cap: PreEnqueue parks these gated at once
    pair.add_pods(pods(jax_api(), "t2", 9)[6:], pods(torch_api(), "t2", 9)[6:])
    pair.settle()
    bound = sorted(k for k, p in pair.tstore.pods.items()
                   if p.spec.node_name and k.startswith("t1/"))[:2]
    for key in bound:
        pair.delete_pod(key)
    pair.advance(2.0)
    pair.settle()
    pair.assert_gang_equal()


SCENARIOS = {**LOOP_SCENARIOS, "tenants": _scenario_tenants}


@pytest.fixture(params=["0", "2"], ids=["depth0", "depth2"])
def depth(request, monkeypatch):
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", request.param)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    monkeypatch.delenv("KTPU_FULL_BATCH", raising=False)
    monkeypatch.delenv("KTPU_SPEC", raising=False)
    return request.param


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_loop_ledger_matches_jax(scenario, depth):
    pair = LoopPair(batch=16)
    with Recorders(pair, telemetry=False, tracing=False) as rec:
        SCENARIOS[scenario](pair)
        want, got = ledger_view(rec.jax[1]), ledger_view(rec.port[1])
    assert got == want
    closed = {k: v for k, v in got.items() if v[3] is not None}
    assert closed
    for result, segments, _order, e2e, _intervals in closed.values():
        assert e2e == pytest.approx(sum(segments.values()), rel=1e-9, abs=1e-12)
    # every pod the loop bound closed as scheduled (the pods bound before
    # the loop started have no entry); a scheduled one no longer bound was
    # deleted since
    scheduled = {k for k, v in closed.items() if v[0] == "scheduled"}
    bound = {k for k, p in pair.tstore.pods.items() if p.spec.node_name}
    assert {k for k in bound if k in got} <= scheduled
    assert all(k not in pair.tstore.pods for k in scheduled - bound)
    segs = {s for v in got.values() for s in v[2]}
    expect = {"basic": {"device.inflight", "commit.host", "bind"},
              "failures": {"queue.unschedulable"},
              "poison": {"queue.backoff"},
              "gang": {"gang.permit_park"},
              "churn": {"queue.backoff"},
              "tenants": {"queue.gated", "queue.drr_wait"},
              "reclaim": {"queue.gated", "bind"}}[scenario]
    assert expect <= segs
    if scenario == "churn":
        assert any(v[0] == "deleted" for v in closed.values())
