"""The port's device telemetry (``kubernetes_tpu_torch/backend/
telemetry.py``) against the JAX package's (``kubernetes_tpu/backend/
telemetry.py``) on the CPU.

The same call sequences go into both packages' FlightRecorder,
CompileLedger (``record_compile`` under ``dispatch`` and ``calibration``,
the storm detector), DispatchLedger (``record_window`` / ``record_phases``
with injected timestamps, the cost slots) and DeviceTelemetry
(``transfer``): the ``dump()``s are equal, wall-clock ``t`` fields
dropped. The disabled contract holds per hook: with the recorder off each
returns at once (``dispatch`` and ``calibration`` hand back the one shared
null context manager) and touches no recorder. ``sample_hbm`` is None on
the CPU in both. ``DeviceState.sync`` counts the same upload bytes as the
JAX mirror on the same snapshot.

Through ``LoopPair`` (both loops on the CPU, FakeClocks): the flight
recorder's (type, batchId, bucket, sig, pods, topo) sequence equals the
JAX loop's in basic batches, failures across attempts, a ring poison and
requeue, a gang's Permit park and whole-gang reject, deletes under
churn, and SchedulingBorrow's quota reclaim (one ``evict_wave`` per
eviction, through the drain orchestrator), at ring depth 0 and 2 (JAX's ``retrace_storm`` events, which an XLA
recompile fires, are left out: the port builds its kernel once per
process). The port's placements with the three recorders on equal them
off. The build ledger counts an ``nvcc`` build of the fused kernel under
the dispatch that triggered it and nothing for a library already built;
the cost ledger holds the fused kernel's bytes for ``schedule_batch`` on
the fused path and no entry for a program without a count.
``KTPU_PROFILE_DIR`` writes a Chrome trace of the first batch cycles, and a
profiler that cannot start leaves the loop as it was."""

import pytest

from _torch_cases import (FLIGHT_KEYS, LOOP_SCENARIOS, LoopPair, Recorders, SnapshotShim,
                          build_nodes, build_pods, cluster_spec, flight_view, jax_api, pods_spec,
                          torch_api)


@pytest.fixture(autouse=True)
def _recorders_off():
    yield
    from kubernetes_tpu.backend import telemetry as jtel
    from kubernetes_tpu.metrics import latency_ledger as jled
    from kubernetes_tpu.utils import tracing as jtr
    from kubernetes_tpu_torch.backend import telemetry as ttel
    from kubernetes_tpu_torch.metrics import latency_ledger as tled
    from kubernetes_tpu_torch.utils import tracing as ttr

    for m in (jtel, jled, jtr, ttel, tled, ttr):
        m.disable()


def _modules():
    from kubernetes_tpu.backend import telemetry as jtel
    from kubernetes_tpu_torch.backend import telemetry as ttel

    return jtel, ttel


def _strip_t(obj):
    """``obj`` with every wall-clock ``t`` key dropped, recursively."""
    if isinstance(obj, dict):
        return {k: _strip_t(v) for k, v in obj.items() if k != "t"}
    if isinstance(obj, list):
        return [_strip_t(v) for v in obj]
    return obj


# ------------------------------------------------------------------ recorders


def _flight_script(fr):
    for i in range(20):
        fr.record("encode", batchId=f"b{i}", bucket=16, pods=i)
    fr.record("poison", batchId="b3", error="x")
    return fr.dump(), fr.dump(limit=3), fr.dump(limit=0), fr.events("encode", "b17"), fr.recorded


def test_flight_recorder_matches_jax():
    jtel, ttel = _modules()
    jout = _flight_script(jtel.FlightRecorder(capacity=8))
    tout = _flight_script(ttel.FlightRecorder(capacity=8))
    assert _strip_t(list(tout)) == _strip_t(list(jout))
    assert tout[-1] == 21 and len(tout[0]) == 8


def _compile_script(tel, metrics):
    led = tel.CompileLedger(metrics, tel.FlightRecorder())
    with led.dispatch("prog", bucket="16/off"):
        led.record_compile(0.5)
    with led.dispatch("prog", bucket="16/off"):
        led.record_compile(0.25)  # one dispatch may build twice: one retrace at most
        led.record_compile(0.25)
    for i in range(tel.STORM_RETRACES):
        with led.dispatch("prog", bucket=f"{32 * (i + 1)}/off"):
            led.record_compile(0.1)
    with led.calibration():
        for i in range(tel.STORM_RETRACES):
            with led.dispatch("warm", bucket=str(i)):
                led.record_compile(0.05)
    led.record_compile(0.2)  # no dispatch open: the "(other)" program
    with led.dispatch("outer"):
        with led.dispatch("inner", bucket="8"):
            led.record_compile(0.3)
        led.record_compile(0.3)  # the outer context again
    with led.probe_guard():
        led.record_compile(9.0)  # a cost probe's build: not counted
    return (led.dump(), led.total_compilations(), led.total_retraces(),
            [e["type"] for e in led.flight.dump()])


def test_compile_ledger_matches_jax():
    from kubernetes_tpu.metrics.scheduler_metrics import SchedulerMetrics as JMetrics
    from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics

    jtel, ttel = _modules()
    jm, tm = JMetrics(), SchedulerMetrics()
    jout, tout = _compile_script(jtel, jm), _compile_script(ttel, tm)
    assert tout == jout
    assert tout[0]["storms"] == {"prog": 1} and tout[-1] == ["retrace_storm"]
    for labels in (("prog", "16/off"), ("(other)", "-"), ("inner", "8"), ("outer", "-")):
        assert tm.xla_compilations.labels(*labels) == jm.xla_compilations.labels(*labels)
    for prog in ("prog", "warm", "outer"):
        assert tm.xla_retraces.labels(prog) == jm.xla_retraces.labels(prog)
        assert tm.xla_compile_duration.count(prog) == jm.xla_compile_duration.count(prog)


def _dispatch_script(led):
    # a ring of three: submits at 0, 1, 2; each executes 1.5 s; the waits
    # start late, so dwell, exec and fetch all show
    led.record_window("schedule_batch", "16/off", t_submit=0.0, t_wait0=0.5, t_exec_done=1.5,
                      t_wait_end=1.75, batch_id="b1", pods=16, fetch_bytes=1024)
    led.record_window("schedule_batch", "16/off", t_submit=1.0, t_wait0=2.0, t_exec_done=3.0,
                      t_wait_end=3.5, batch_id="b2", pods=16, fetch_bytes=1024)
    led.record_window("schedule_batch", "32/host", t_submit=2.0, t_wait0=4.0, t_exec_done=4.5,
                      t_wait_end=4.5, batch_id="b3", pods=20, fetch_bytes=2048)
    led.record_phases("schedule_batch", "16/off", dwell_s=0.1, exec_s=0.2, fetch_s=0.05,
                      batch_id="b4", pods=3, fetch_bytes=64)
    led.record_phases("gang_verdicts", None, dwell_s=0.0, exec_s=0.01, fetch_s=0.0, wait_s=0.5)
    led.maybe_cost("schedule_batch", "16/off", lambda: {"bytesAccessed": 4096.0})
    led.maybe_cost("schedule_batch", "16/off", lambda: {"bytesAccessed": 1.0})  # claimed
    led.maybe_cost("claim_mask", "16x4", lambda: None)  # no count: no entry
    return led.dump(), led.dump(limit=2), led.dump(limit=0)


def test_dispatch_ledger_matches_jax():
    """The JAX ledger's probe lowers an XLA program for its cost; here it
    calls the same count function the port's does."""
    jtel, ttel = _modules()
    jled = jtel.DispatchLedger(capacity=4)
    jled._probe_cost = lambda fn, args, kwargs: fn(*args, **kwargs)
    jout, tout = _dispatch_script(jled), _dispatch_script(ttel.DispatchLedger(capacity=4))
    assert _strip_t(list(tout)) == _strip_t(list(jout))
    programs = tout[0]["programs"]
    assert programs["schedule_batch@16/off"]["bytesAccessed"] == 4096.0
    assert "claim_mask@16x4" not in programs
    assert len(tout[0]["records"]) == 4 and tout[1]["truncated"] == {"records": 4}
    for rec in tout[0]["records"][:2]:  # b2 and b3, from their timestamps
        assert sum(rec["window"].values()) == pytest.approx(rec["waitS"], abs=1e-12)


def test_dispatch_record_carries_device_exec():
    """The port's record keeps the CUDA-event time of the batch program
    (``deviceExecS``) when given, and sums it per program."""
    _, ttel = _modules()
    led = ttel.DispatchLedger()
    rec = led.record_window("schedule_batch", "128/off", t_submit=0.0, t_wait0=0.0,
                            t_exec_done=0.002, t_wait_end=0.003, device_exec_s=0.0015)
    assert rec["deviceExecS"] == 0.0015
    assert led.dump()["programs"]["schedule_batch@128/off"]["deviceExecS"] == 0.0015
    plain = led.record_window("schedule_batch", "16/off", t_submit=0.0, t_wait0=0.0,
                              t_exec_done=0.0, t_wait_end=0.0)
    assert "deviceExecS" not in plain


def _transfer_script(tel):
    t = tel.DeviceTelemetry()
    t.transfer("upload", 4096)
    t.transfer("fetch", 512)
    t.transfer("fetch", 512)
    t.event("commit", batchId="b1", pods=4)
    return t.dump()


def test_device_telemetry_transfer_matches_jax():
    jtel, ttel = _modules()
    jout, tout = _transfer_script(jtel), _transfer_script(ttel)
    assert _strip_t(tout) == _strip_t(jout)
    assert tout["transfer"] == {"uploadBytes": 4096, "fetchBytes": 1024, "uploads": 1,
                                "fetches": 2}


def test_sample_hbm_is_none_on_cpu():
    jtel, ttel = _modules()
    assert jtel.DeviceTelemetry().sample_hbm() is None
    t = ttel.DeviceTelemetry()
    assert t.sample_hbm("cpu") is None
    assert t.hbm == {} and t.dump()["hbm"] == {}


# ------------------------------------------------------------------ disabled contract


def _telemetry_hooks(ttel):
    return {
        "event": lambda: ttel.event("dispatch", batchId="x"),
        "compiled": lambda: ttel.compiled(0.1),
        "dispatch_window": lambda: ttel.dispatch_window(
            "p", t_submit=0.0, t_wait0=0.0, t_exec_done=0.0, t_wait_end=0.0),
        "dispatch_phases": lambda: ttel.dispatch_phases("p", dwell_s=0.0, exec_s=0.0,
                                                        fetch_s=0.0),
        "cost_probe": lambda: ttel.cost_probe("p", "b", lambda: {"bytesAccessed": 1.0}),
        "emit_phase_spans": lambda: ttel.emit_phase_spans(None),
        "transfer": lambda: ttel.transfer("upload", 1024),
        "sample_hbm": lambda: ttel.sample_hbm(),
    }


def _ledger_hooks(tled):
    return {
        "transition": lambda: tled.transition("ns/p", "queue.active"),
        "transition_many": lambda: tled.transition_many(["ns/p"], "bind"),
        "close": lambda: tled.close("ns/p"),
        "close_many": lambda: tled.close_many(["ns/p"]),
        "drop": lambda: tled.drop("ns/p"),
        "close_skipped": lambda: tled.close_skipped("ns/p", None),
    }


HOOKS = ([("telemetry", h) for h in ("event", "compiled", "dispatch_window", "dispatch_phases",
                                     "cost_probe", "emit_phase_spans", "transfer",
                                     "sample_hbm")]
         + [("ledger", h) for h in ("transition", "transition_many", "close", "close_many",
                                    "drop", "close_skipped")])


@pytest.mark.parametrize("module,hook", HOOKS)
def test_disabled_hook_returns_at_once(module, hook, monkeypatch):
    """With the recorder off the hook returns None and reaches no
    recorder: every recorder method raises if called."""
    from kubernetes_tpu_torch.backend import telemetry as ttel
    from kubernetes_tpu_torch.metrics import latency_ledger as tled

    def boom(*_a, **_k):
        raise AssertionError("a disabled hook reached the recorder")

    if module == "telemetry":
        assert ttel.get() is None
        for cls in (ttel.DeviceTelemetry, ttel.DispatchLedger, ttel.CompileLedger,
                    ttel.FlightRecorder):
            for name in ("event", "transfer", "sample_hbm", "record_window", "record_phases",
                         "maybe_cost", "record_compile", "record"):
                if hasattr(cls, name):
                    monkeypatch.setattr(cls, name, boom)
        assert _telemetry_hooks(ttel)[hook]() is None
    else:
        assert tled.get() is None
        for name in ("transition", "transition_many", "close", "close_many", "drop"):
            monkeypatch.setattr(tled.PodLatencyLedger, name, boom)
        assert _ledger_hooks(tled)[hook]() is None


@pytest.mark.parametrize("hook", ["dispatch", "calibration"])
def test_disabled_context_is_the_shared_null(hook):
    _, ttel = _modules()
    assert ttel.get() is None
    cm = (ttel.dispatch("schedule_batch", bucket="128/off") if hook == "dispatch"
          else ttel.calibration())
    assert cm is ttel._NULL_CM
    with cm:
        pass


def test_enable_from_env(monkeypatch):
    """``KTPU_TELEMETRY=1`` turns the layer on when a loop is built, fed
    by its metrics; a second loop attaches its own."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend import telemetry as ttel
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler

    monkeypatch.setenv("KTPU_TELEMETRY", "1")
    a = TPUScheduler(Store(), device="cpu")
    rec = ttel.get()
    assert rec is not None and rec.metrics_sets == [a.smetrics]
    b = TPUScheduler(Store(), device="cpu")
    assert ttel.get() is rec and rec.metrics_sets == [a.smetrics, b.smetrics]


# ------------------------------------------------------------------ the device mirror


def test_sync_upload_bytes_match_jax():
    """Both mirrors synced from the same nodes (then again after a commit
    changed some rows) count the same upload bytes, and each upload runs
    under the ``apply_rows`` dispatch."""
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu_torch.backend.device_state import DeviceState
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.ops.schema import Capacities

    jtel, ttel = _modules()
    jrec, trec = jtel.enable(), ttel.enable()
    spec = cluster_spec(20, 3)
    jinfos, tinfos = build_nodes(jax_api(), spec), build_nodes(torch_api(), spec)
    jds = JDeviceState(JCaps(nodes=32, pods=16))
    tds = DeviceState(Capacities(nodes=32, pods=16), device="cpu")
    jds.sync(SnapshotShim(jinfos))
    tds.sync(Snapshot(tinfos))
    assert trec.transfer_bytes["upload"] == jrec.transfer_bytes["upload"] > 0
    # a second round: more pods on four nodes
    pods_j, pods_t = build_pods(jax_api(), pods_spec(4, 9)), build_pods(torch_api(),
                                                                          pods_spec(4, 9))
    for i, (pj, pt) in enumerate(zip(pods_j, pods_t)):
        jinfos[i].add_pod(pj)
        tinfos[i].add_pod(pt)
    jds.sync(SnapshotShim(jinfos))
    tds.sync(Snapshot(tinfos))
    assert trec.transfer_bytes == jrec.transfer_bytes
    assert trec.transfers == jrec.transfers
    assert trec.ledger.dispatches["apply_rows"] == jrec.ledger.dispatches["apply_rows"] == 2


# ------------------------------------------------------------------ the build and cost ledgers


def test_nvcc_build_is_counted_once(tmp_path, monkeypatch):
    """A build of the fused kernel's library reports its duration to the
    dispatch open on its thread; a library already in the build directory
    counts nothing (``nvcc`` is stood in for: the CPU has none)."""
    import subprocess

    from kubernetes_tpu_torch.backend import telemetry as ttel
    from kubernetes_tpu_torch.ops import fused_step

    def fake_nvcc(cmd, **_kw):
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").write(b"library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(fused_step, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(fused_step, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(fused_step.subprocess, "run", fake_nvcc)
    rec = ttel.enable()
    with ttel.dispatch("schedule_batch", bucket="128/off"):
        path = fused_step.build_library()
    assert path.exists()
    with ttel.dispatch("schedule_batch", bucket="128/off"):
        assert fused_step.build_library() == path  # found: no build
    led = rec.ledger.dump()
    assert led["compilations"] == {"schedule_batch@128/off": 1}
    assert led["retraces"] == {} and led["dispatches"] == {"schedule_batch": 2}


def test_fused_cost_is_the_kernel_bytes(monkeypatch):
    """With telemetry on, the loop's fused batches give ``schedule_batch``
    the fused kernel's bytes (its inputs and outputs, from their shapes);
    the sampled batches (the scan) add no entry."""
    from kubernetes_tpu_torch.backend import telemetry as ttel
    from kubernetes_tpu_torch.ops.fused_step import fused_step_bytes

    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    pair = LoopPair(batch=16)
    rec = ttel.enable()
    spec = cluster_spec(12, 0)
    pair.add_nodes(build_nodes(jax_api(), spec), build_nodes(torch_api(), spec))
    pods = pods_spec(40, 1)
    pair.add_pods(build_pods(jax_api(), pods), build_pods(torch_api(), pods))
    pair.tsched.run_until_settled()
    assert set(pair.tsched.batch_paths) == {"fused"}
    nt = pair.tsched.state.nt
    n, r = nt.allocatable.shape
    programs = rec.dispatch_ledger.dump()["programs"]
    entry = programs["schedule_batch@16/off"]
    assert entry["count"] == pair.tsched.batch_counter == 3
    assert entry["bytesAccessed"] == fused_step_bytes(16, n, r, nt.port_bits.shape[1])
    assert entry["fetchBytes"] > 0
    dump = rec.dump()
    assert dump["transfer"]["fetches"] == 3 and dump["transfer"]["uploads"] >= 1


def test_fused_step_bytes_counts_every_tensor():
    """``fused_step_bytes`` equals the bytes of the wrapper's inputs and
    outputs, tensor by tensor (the plain version's outputs)."""
    import torch

    from kubernetes_tpu_torch.ops import fused_step

    p, n, r, w = 5, 37, 6, 3
    g = torch.Generator().manual_seed(0)
    i32 = lambda *s: torch.randint(0, 9, s, generator=g, dtype=torch.int32)  # noqa: E731
    f32 = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    args = (i32(n, r) + 100, i32(n, r), i32(n, r), i32(n, w), i32(p, r), i32(p, r), i32(p, w),
            torch.ones(p, n, dtype=torch.bool), torch.zeros(p, n, dtype=torch.int8),
            f32(p, n), f32(p, n), f32(p, n), f32(p, n), torch.full((p,), -1, dtype=torch.int32),
            torch.ones(p, dtype=torch.bool))
    out = fused_step.fused_step_batch(*args, (1.0, 1.0, 3.0, 2.0, 1.0))
    total = sum(t.numel() * t.element_size() for t in (*args, *out))
    assert fused_step.fused_step_bytes(p, n, r, w) == total


# ------------------------------------------------------------------ through the loops


MODES = ["0", "2"]


@pytest.fixture(params=MODES, ids=["depth0", "depth2"])
def depth(request, monkeypatch):
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", request.param)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    monkeypatch.delenv("KTPU_FULL_BATCH", raising=False)
    monkeypatch.delenv("KTPU_SPEC", raising=False)
    return request.param


def _jax_flight(rec) -> list:
    return [ev for ev in flight_view(rec.jax[0]) if ev[0] != "retrace_storm"]


@pytest.mark.parametrize("scenario", ["basic", "failures", "poison", "gang", "churn", "reclaim"])
def test_flight_events_match_jax(scenario, depth):
    pair = LoopPair(batch=16)
    with Recorders(pair, ledger=False, tracing=False) as rec:
        LOOP_SCENARIOS[scenario](pair)
        want, got = _jax_flight(rec), flight_view(rec.port[0])
    assert got == want
    assert len(got) > 0 and all(len(ev) == len(FLIGHT_KEYS) for ev in got)
    from kubernetes_tpu_torch.backend.telemetry import EVENT_KINDS

    assert {ev[0] for ev in got} <= EVENT_KINDS


@pytest.mark.parametrize("scenario", ["failures", "poison", "gang", "churn"])
def test_recorders_change_no_placement(scenario, depth):
    """The port alone, the same scenario twice: with telemetry, the ledger
    and tracing on, placements, queues and counters equal the run with all
    three off."""
    states = []
    for on in (False, True):
        pair = LoopPair(batch=16)
        if on:
            with Recorders(pair):
                LOOP_SCENARIOS[scenario](pair)
        else:
            LOOP_SCENARIOS[scenario](pair)
        states.append(pair.state(1))
    assert states[1] == states[0]


@pytest.mark.parametrize("starts", [True, False], ids=["captures", "profiler-fails"])
def test_profile_dir_captures_the_first_batches(starts, tmp_path, monkeypatch):
    """``KTPU_PROFILE_DIR``: a ``torch.profiler`` capture of the first
    ``KTPU_PROFILE_BATCHES`` batch cycles, exported as a Chrome trace; a
    profiler that cannot start turns profiling off and the loop places the
    same pods."""
    import json

    import torch.profiler

    from kubernetes_tpu_torch.perf import workloads

    monkeypatch.setenv("KTPU_PROFILE_BATCHES", "2")
    w = workloads.scheduling_basic(60, 40, 80)
    plain = workloads.run_loop(w, "cpu", batch_size=16)
    monkeypatch.setenv("KTPU_PROFILE_DIR", str(tmp_path / "prof"))
    if not starts:
        def refuse(*_a, **_k):
            raise RuntimeError("no profiler here")

        monkeypatch.setattr(torch.profiler, "profile", refuse)
    run = workloads.run_loop(w, "cpu", batch_size=16)
    assert run["placed"] == plain["placed"] and run["batches"] == plain["batches"] > 2
    traces = list((tmp_path / "prof").glob("loop-*.json")) if starts else []
    assert len(traces) == (1 if starts else 0)
    if starts:
        assert json.loads(traces[0].read_text())["traceEvents"]
    else:
        assert not (tmp_path / "prof").exists()
