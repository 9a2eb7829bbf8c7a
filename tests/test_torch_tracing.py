"""The port's span tracing (``kubernetes_tpu_torch/utils/tracing.py``,
``utils/trace.py``) against the JAX package's on the CPU.

The JAX tracer tests' cases (``tests/test_tracing.py:13-140``) run on the
port's tracer: nesting and the OTLP shape, the disabled no-op, the JSON
lines exporter, ``KTPU_TRACE_FILE``, the W3C traceparent round trip and
the remote parent, ``tail``; and on the port's loop: the sequential
cycle's span with its extension-point children and the batch phases.

Through ``LoopPair`` (both loops on the CPU): each cycle's span tree equals
the JAX loop's (names, parents, sibling order, the attributes ``batch``,
``topo``, ``pod``, ``profile``, ``extension_point``, ``worker``,
``packed``, ``program``, ``bucket``, ``batchId``) in basic batches,
failures (PostFilter under the commit), a ring poison, a gang's Permit
park and reject, deletes under churn, and SchedulingBorrow's quota
reclaim, at ring depth 0 and 2; and with
pods of a second profile on the sequential path, whose cycles carry the
PreFilter, Filter, PreScore and Score points and their plugins, and whose
bind tail runs the per-pod points; there the trees are compared whole: a
failed sequential pod's PostFilter gets the cycle's PreFilter state, as
the JAX loop's does, so its DefaultPreemption runs no PreFilter again. The
dispatch ledger's ``device.dispatch.*`` children sum to their
``device.commit.wait``."""

import json

import pytest

from _torch_cases import (LOOP_SCENARIOS, LoopPair, Recorders, build_nodes, build_pods,
                          cluster_spec, jax_api, pods_spec, span_forest, torch_api)


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    from kubernetes_tpu.backend import telemetry as jtel
    from kubernetes_tpu.utils import tracing as jtr
    from kubernetes_tpu_torch.backend import telemetry as ttel
    from kubernetes_tpu_torch.utils import tracing as ttr

    for m in (jtel, jtr, ttel, ttr):
        m.disable()


def _tracing():
    from kubernetes_tpu_torch.utils import tracing

    return tracing


# ------------------------------------------------------------------ the tracer


def test_nesting_and_otlp_shape():
    tracing = _tracing()
    tracer = tracing.enable()
    with tracing.span("parent", cluster="test"):
        with tracing.span("child"):
            pass
    exp = tracer.exporter
    assert [s.name for s in exp.spans] == ["child", "parent"]
    c, p = exp.spans
    assert c.trace_id == p.trace_id and c.parent_id == p.span_id
    otlp = p.to_otlp()
    assert otlp["name"] == "parent" and otlp["parentSpanId"] == ""
    assert {"key": "cluster", "value": {"stringValue": "test"}} in otlp["attributes"]
    assert c.duration_s >= 0


def test_disabled_is_noop():
    tracing = _tracing()
    assert tracing.get() is None
    with tracing.span("nothing") as s:
        assert s is None
    assert tracing.current() is None and tracing.annotate(x=1) is None
    assert tracing.emit("x", 0, 1) is None and tracing.tail() == []


def test_json_file_exporter(tmp_path):
    tracing = _tracing()
    path = str(tmp_path / "spans.jsonl")
    tracing.enable(tracing.JsonFileExporter(path))
    with tracing.span("one"):
        pass
    line = json.loads(open(path).read().strip())
    assert line["name"] == "one" and line["endTimeUnixNano"] > 0


def test_env_enable(tmp_path, monkeypatch):
    tracing = _tracing()
    monkeypatch.setenv("KTPU_TRACE_FILE", str(tmp_path / "t.jsonl"))
    tracing.maybe_enable_from_env()
    assert tracing.get() is not None


def test_traceparent_roundtrip():
    tracing = _tracing()
    tracing.enable()
    assert tracing.format_traceparent() is None  # no open span
    with tracing.span("outer") as s:
        tp = tracing.format_traceparent()
        assert tp == f"00-{s.trace_id}-{s.span_id}-01"
        assert tracing.parse_traceparent(tp) == (s.trace_id, s.span_id)
    for bad in (None, "", "junk", "00-short-short-01", 42):
        assert tracing.parse_traceparent(bad) is None


def test_traceparent_disabled_is_noop():
    tracing = _tracing()
    assert tracing.format_traceparent() is None
    with tracing.span_from_remote("00-" + "a" * 32 + "-" + "b" * 16 + "-01", "child") as s:
        assert s is None


def test_span_from_remote_parents_across_boundary():
    tracing = _tracing()
    tracing.enable()
    with tracing.span("client.op") as parent:
        tp = tracing.format_traceparent()
    with tracing.span_from_remote(tp, "server.op") as child:
        with tracing.span("server.inner") as inner:
            pass
    assert child.trace_id == parent.trace_id and child.parent_id == parent.span_id
    assert inner.trace_id == parent.trace_id and inner.parent_id == child.span_id
    with tracing.span_from_remote("not-a-traceparent", "server.op") as s:
        assert s.parent_id is None and s.trace_id != parent.trace_id


def test_tail_and_emit():
    tracing = _tracing()
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [s.name for s in tracing.tail(2)] == ["s3", "s4"] and tracing.tail(0) == []
    with tracing.span("open") as s:
        tracing.emit("done", 10, 20, k="v")
        tracing.annotate(extra=3)
    done = tracing.tail(2)[0]
    assert done.name == "done" and done.parent_id == s.span_id and done.duration_s == 1e-8
    assert s.attributes["extra"] == 3
    tracing.disable()
    assert tracing.tail() == []


def test_trace_logs_only_long_cycles():
    """``Trace``: the steps are kept; the text appears past the
    threshold, as the JAX copy's."""
    from kubernetes_tpu.utils.clock import FakeClock as JClock
    from kubernetes_tpu.utils.trace import Trace as JTrace
    from kubernetes_tpu_torch.utils.clock import FakeClock
    from kubernetes_tpu_torch.utils.trace import Trace

    out = []
    for trace_cls, clock in ((JTrace, JClock()), (Trace, FakeClock())):
        tr = trace_cls("Scheduling", now_fn=clock, pod="ns/p")
        clock.advance(0.02)
        tr.step("Snapshotting done")
        short = tr.log_if_long(0.1, sink=lambda _t: None)
        clock.advance(0.2)
        tr.step("Computing predicates done")
        out.append((short, tr.log_if_long(0.1, sink=lambda _t: None)))
    assert out[1] == out[0] and out[1][0] is None and "+200.0ms" in out[1][1]


def test_port_sequential_cycle_and_batch_phases():
    """The port's loop: a pod of a profile that does not ride the batch
    gets a ``scheduling.cycle`` (``pod``) with the framework's points and
    plugins under it, and a root ``framework.bind``; a batch gets its
    phase spans."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.config import scheduler_from_config
    from kubernetes_tpu_torch.perf.workloads import profiles_config

    tracing = _tracing()
    tracer = tracing.enable()
    store = Store()
    sched = scheduler_from_config(store, raw=profiles_config("default-scheduler", "no-scoring"),
                                  device="cpu", batch_deadline_ms=0)
    for i in range(3):
        store.create_node(torch_api().make_node(f"n{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 10}).obj())
    seq = torch_api().make_pod("p").req({"cpu": "100m"}).obj()
    seq.spec.scheduler_name = "no-scoring"
    store.create_pod(seq)
    for i in range(4):
        store.create_pod(torch_api().make_pod(f"b{i}").req({"cpu": "100m"}).obj())
    sched.run_until_settled()
    sched.close()
    spans = tracer.exporter.spans
    cycle = next(s for s in tracer.exporter.by_name("scheduling.cycle")
                 if s.attributes.get("pod") == "default/p")
    children = {s.name for s in spans if s.trace_id == cycle.trace_id}
    assert {"framework.pre_filter", "framework.filter", "framework.pre_score",
            "framework.score"} <= children
    assert any(n.startswith("plugin.") for n in children)
    assert tracer.exporter.by_name("framework.bind")
    names = {s.name for s in spans}
    assert {"device.encode", "device.dispatch", "device.commit.wait", "host.commit",
            "device.commit.reconcile", "framework.reserve", "framework.post_bind"} <= names


# ------------------------------------------------------------------ through the loops


@pytest.fixture(params=["0", "2"], ids=["depth0", "depth2"])
def depth(request, monkeypatch):
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", request.param)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    monkeypatch.delenv("KTPU_FULL_BATCH", raising=False)
    monkeypatch.delenv("KTPU_SPEC", raising=False)
    return request.param


def _phase_sums(exporter) -> int:
    """Check that each ``device.commit.wait``'s dispatch children sum to it;
    returns the waits checked."""
    spans = exporter.spans
    waits = [s for s in spans if s.name == "device.commit.wait"]
    for w in waits:
        kids = [s for s in spans if s.parent_id == w.span_id]
        assert sorted(k.name for k in kids) == ["device.dispatch.dwell", "device.dispatch.exec",
                                                "device.dispatch.fetch"]
        start, end = min(k.start for k in kids), max(k.end for k in kids)
        assert sum(k.end - k.start for k in kids) == end - start
    return len(waits)


@pytest.mark.parametrize("scenario", sorted(LOOP_SCENARIOS))
def test_loop_span_trees_match_jax(scenario, depth):
    pair = LoopPair(batch=16)
    with Recorders(pair, ledger=False) as rec:
        LOOP_SCENARIOS[scenario](pair)
        want, got = span_forest(rec.jax[2]), span_forest(rec.port[2])
    assert got == want
    cycles = [t for t in got if t[0] == "scheduling.cycle"]
    assert len(cycles) == pair.tsched.batch_counter  # one per batch
    # one wait per batch read (a poisoned batch has none)
    assert _phase_sums(rec.port[2]) == len(rec.port[0].flight.events("commit")) > 0


def test_sequential_span_trees_match_jax(depth):
    """Every seventh pod names the ``no-scoring`` profile, which does not
    ride the batch: the sequential path's cycle spans with their
    extension-point children, the per-pod bind tail, and the failures,
    whose PostFilter runs each PreFilter once (in the cycle)."""
    from kubernetes_tpu_torch.perf.workloads import profiles_config

    pair = LoopPair(batch=16, config=profiles_config("default-scheduler", "no-scoring"))
    with Recorders(pair, ledger=False) as rec:
        spec = cluster_spec(12, 0)
        pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
        pods = pods_spec(150, 1)
        pods_j, pods_t = build_pods(jax_api(), pods), build_pods(torch_api(), pods)
        for i in range(0, 150, 7):
            pods_j[i].spec.scheduler_name = pods_t[i].spec.scheduler_name = "no-scoring"
        pair.add_pods(pods_j, pods_t)
        pair.settle()
        pair.advance(11.0)
        pair.settle()
        pair.assert_equal()
        want, got = span_forest(rec.jax[2]), span_forest(rec.port[2])
    assert got == want
    seq = [t for t in got if t[0] == "scheduling.cycle" and dict(t[1]).get("pod")]
    assert len(seq) > 0
    kids = {k[0] for t in seq for k in t[2]}
    assert {"framework.pre_filter", "framework.filter", "framework.pre_score",
            "framework.score"} <= kids
    roots = {t[0] for t in got}
    assert {"framework.reserve", "framework.permit", "framework.pre_bind", "framework.bind",
            "framework.post_bind"} <= roots
