"""The port's scheduler_perf harness (``kubernetes_tpu_torch/perf/harness.py``,
``perf/cases.py``, ``python -m kubernetes_tpu_torch.perf``) against the JAX
harness (``kubernetes_tpu/perf/harness.py``) on the CPU, at the sizes of
``tests/test_perf_harness.py`` and ``tests/test_dra.py:527``.

Each case runs one test case's op list through both harnesses in one
process (C14), the port's with ``device="cpu"``, both with
``KTPU_BATCH_DEADLINE_MS=0`` (batches cut at the batch size, not by wall
time). The placements (every pod's node in the store), the scheduled
count and the DataItems' names, labels, units, data keys and ``Count``
fields, in order, must be equal. The latency DataItems hold the port's
exact quantiles: each equals ``numpy.quantile`` of the phase's
observations. Two of these cases found faults of the port, settled here
(ROADMAP C29, C30): a sampled attempt's Reserve of a batch pod without
PreFilter state, and a sampled sequential attempt's PostFilter, recorded no
``plugin_execution_duration_seconds``. The ``wire`` and ``grpc`` runs also
check that ``close`` shut their server down.

Besides: the ThroughputCollector's summary and the MetricsCollector's
scrape delta against the JAX ones on the same samples,
``data_items_to_json`` byte-equal for equal items, and
``__main__.main(["--device", "cpu", ...])`` writing the JAX layout (one
DataItems file per case and ``summary.json``). The oracle backend takes the
sequential path only (no batch cycles, no fused launches)."""

import json

import numpy as np
import pytest

@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KTPU_BATCH_DEADLINE_MS", "0")
    for key in ("KTPU_PIPELINE", "KTPU_PIPELINE_DEPTH", "KTPU_COMMIT_WORKER", "KTPU_FULL_BATCH",
                "KTPU_SPEC", "KTPU_LEDGER", "KTPU_TELEMETRY", "KTPU_TRACE_FILE"):
        monkeypatch.delenv(key, raising=False)
    yield
    from kubernetes_tpu.metrics import latency_ledger as jled
    from kubernetes_tpu_torch.metrics import latency_ledger as tled

    jled.disable()
    tled.disable()


def run_case(pkg: str, name: str, backend: str, kw: dict, **runner_kw):
    """One test case through ``pkg``'s Runner (as ``run_workload`` runs it:
    the ops, ``close``, the TestCase and Backend labels); the Runner."""
    if pkg == "jax":
        from kubernetes_tpu.perf import harness
        from kubernetes_tpu.perf.workloads import TEST_CASES
    else:
        from kubernetes_tpu_torch.perf import harness
        from kubernetes_tpu_torch.perf.cases import TEST_CASES

        runner_kw.setdefault("device", "cpu")
    tc = TEST_CASES[name](**kw)
    r = harness.Runner(scheduler_config=tc.get("schedulerConfig"), backend=backend, **runner_kw)
    try:
        r.run_ops(tc["ops"])
    finally:
        r.close()
    for it in r.data_items:
        it.labels.setdefault("TestCase", tc.get("name", "unnamed"))
        it.labels.setdefault("Backend", backend)
    return r


def placements(r) -> dict:
    return {k: p.spec.node_name for k, p in r.store.pods.items()}


def shape(items) -> list:
    """What is deterministic of each DataItem: unit, labels, data keys and
    Count."""
    return [(it.unit, sorted(it.labels.items()), sorted(it.data), it.data.get("Count"))
            for it in items]


def assert_same_run(jr, tr) -> None:
    assert placements(tr) == placements(jr)
    assert tr.scheduler.metrics["scheduled"] == jr.scheduler.metrics["scheduled"]
    assert shape(tr.data_items) == shape(jr.data_items)


def assert_exact_quantiles(r) -> None:
    """The measured phase's attempt-latency DataItem is the exact quantiles
    of the scheduled attempts it timed (the last ``n`` observations)."""
    hist = r.scheduler.smetrics.scheduling_attempt_duration
    for it in r.data_items:
        if it.labels.get("Name") != "scheduling_attempt_duration_seconds":
            continue
        vals = hist.values(it.labels["result"], "default-scheduler")
        for q, key in ((0.5, "Perc50"), (0.9, "Perc90"), (0.99, "Perc99")):
            assert any(it.data[key] == float(np.quantile(vals[-n:], q))
                       for n in range(1, len(vals) + 1)), key


# the JAX harness tests' cases: (test case, sizes, backend, Runner keywords)
CASES = [
    ("SchedulingBasic", dict(nodes=50, init_pods=20, measured=30), "oracle", {}),
    ("SchedulingBasic", dict(nodes=32, init_pods=10, measured=20), "tpu", dict(batch_size=16)),
    ("SchedulingBasic", dict(nodes=16, init_pods=4, measured=12), "tpu", dict(batch_size=8)),
    ("SchedulingPodAntiAffinity", dict(nodes=24, init_pods=8, measured=12), "tpu",
     dict(batch_size=8)),
    ("SchedulingPodAffinity", dict(nodes=16, init_pods=6, measured=8), "tpu",
     dict(batch_size=8)),
    ("PreemptionBasic", dict(nodes=8, init_pods=24, measured=4), "oracle", {}),
    ("Unschedulable", dict(nodes=16, init_pods=5, measured=10), "oracle", {}),
    ("SchedulingSecrets", dict(nodes=16, init_pods=6, measured=8), "tpu", dict(batch_size=8)),
    ("SchedulingInTreePVs", dict(nodes=16, init_pods=6, measured=8), "tpu",
     dict(batch_size=8)),
    ("SchedulingCSIPVs", dict(nodes=12, init_pods=5, measured=6), "tpu", dict(batch_size=8)),
    ("MixedSchedulingBasePod", dict(nodes=24, init_pods=4, measured=8), "tpu",
     dict(batch_size=8)),
    ("SchedulingPreferredPodAffinity", dict(nodes=12, init_pods=4, measured=6), "tpu",
     dict(batch_size=8)),
    ("SchedulingPreferredPodAntiAffinity", dict(nodes=12, init_pods=4, measured=6), "tpu",
     dict(batch_size=8)),
    ("SchedulingWithChurn", dict(nodes=16, measured=20), "oracle", {}),
    ("SchedulingDRA", dict(nodes=16, init_pods=6, measured=8), "oracle", {}),
    ("SchedulingDRA", dict(nodes=16, init_pods=6, measured=8), "tpu", {}),
    ("SchedulingBasic", dict(nodes=24, init_pods=10, measured=20), "wire", {}),
    ("SchedulingBasic", dict(nodes=24, init_pods=10, measured=20), "grpc", {}),
]


@pytest.mark.parametrize("name,kw,backend,runner_kw", CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[1]['nodes']}" for c in CASES])
def test_workload_matches_jax(name, kw, backend, runner_kw):
    if backend == "grpc":
        pytest.importorskip("grpc")
    jr = run_case("jax", name, backend, kw, **runner_kw)
    tr = run_case("port", name, backend, kw, **runner_kw)
    assert_same_run(jr, tr)
    tput = [it for it in tr.data_items if it.labels["Name"] == "SchedulingThroughput"]
    assert len(tput) == 1 and tput[0].unit == "pods/s" and tput[0].data["Average"] > 0
    assert tput[0].labels["TestCase"] == jr.data_items[0].labels["TestCase"]
    assert_exact_quantiles(tr)
    if backend == "oracle":
        # the sequential path alone: no batch ever ran
        assert tr.scheduler.batch_counter == 0 and tr.scheduler.state is None
    elif backend == "tpu":
        assert tr.scheduler.batch_counter > 0
    else:
        # close() shut the server down and released its socket
        assert tr._server is None and tr._service.batch_log


def test_dra_claims_made_by_the_controller():
    """SchedulingDRA's claims come from the resourceclaim controller through
    the informers, named ``<pod>-accel`` and owned by their pod, allocated
    where their pod landed: as the JAX run's."""
    kw = dict(nodes=16, init_pods=6, measured=8)
    jr = run_case("jax", "SchedulingDRA", "tpu", kw)
    tr = run_case("port", "SchedulingDRA", "tpu", kw)

    def claims(r):
        return {k: (c.resource_class_name, dict(c.selectors), c.allocated_node,
                    tuple(c.reserved_for),
                    tuple((o.kind, o.name, o.controller) for o in c.meta.owner_references))
                for k, c in r.store.resource_claims.items()}

    got = claims(tr)
    assert got == claims(jr)
    assert len(got) == 14
    pods = tr.store.pods
    for key, (_cls, _sel, node, reserved, owners) in got.items():
        pod_key = f"default/{owners[0][1]}"
        assert key == f"{pod_key}-accel" and reserved == (pod_key,)
        assert node == pods[pod_key].spec.node_name


def test_metrics_collector_per_phase_dataitems():
    """The per-phase DataItems ride along on the batched backend: the
    extension points and the batch phases, as the JAX test checks them."""
    tr = run_case("port", "SchedulingBasic", "tpu", dict(nodes=16, init_pods=4, measured=12),
                  batch_size=8)
    items = tr.data_items
    assert len([it for it in items if it.labels["Name"] == "SchedulingThroughput"]) == 1
    ext = [it for it in items if it.labels["Name"] == "framework_extension_point_duration_seconds"]
    assert ext
    for it in ext:
        assert it.unit == "s" and it.data["Count"] > 0
        assert it.data["Perc99"] >= it.data["Perc50"] >= 0
        assert {"extension_point", "status", "profile"} <= set(it.labels)
    batch = [it for it in items if it.labels["Name"] == "tpu_batch_duration_seconds"]
    assert {it.labels["phase"] for it in batch} >= {"upload", "encode", "compute",
                                                      "commit_wait", "commit_host", "commit"}


def test_metrics_collector_scrape_delta():
    """Pre-phase samples are left out, a labelset first seen mid-phase
    counts from zero; Counts equal the JAX collector's on the same samples,
    the percentiles are the exact ones."""
    from kubernetes_tpu.metrics import Histogram as JHistogram, Registry as JRegistry
    from kubernetes_tpu.perf.harness import MetricsCollector as JCollector
    from kubernetes_tpu_torch.metrics.registry import Histogram, Registry
    from kubernetes_tpu_torch.perf.harness import MetricsCollector

    name = "scheduler_framework_extension_point_duration_seconds"
    out = []
    for reg, hist, col in ((JRegistry(), JHistogram, JCollector),
                           (Registry(), Histogram, MetricsCollector)):
        h = reg.register(hist(name, "t", ["extension_point", "status", "profile"]))
        h.observe(5.0, "filter", "Success", "p")
        c = col(reg)
        c.start()
        for i in range(10):
            h.observe(0.002 + 0.0001 * i, "filter", "Success", "p")
        h.observe(0.004, "bind", "Success", "p")
        out.append({it.labels["extension_point"]: it for it in c.collect()})
    jitems, titems = out
    assert {k: (v.unit, v.labels, v.data["Count"]) for k, v in titems.items()} == \
        {k: (v.unit, v.labels, v.data["Count"]) for k, v in jitems.items()}
    assert titems["filter"].data["Count"] == 10 and titems["filter"].data["Perc99"] < 1.0
    vals = [0.002 + 0.0001 * i for i in range(10)]
    assert titems["filter"].data["Perc90"] == float(np.quantile(vals, 0.9))
    assert titems["bind"].data == {"Perc50": 0.004, "Perc90": 0.004, "Perc99": 0.004,
                                   "Count": 1.0}


def test_throughput_collector_matches_jax():
    from kubernetes_tpu.perf.harness import ThroughputCollector as JCollector
    from kubernetes_tpu_torch.perf.harness import ThroughputCollector

    rng = np.random.RandomState(7)
    steps = rng.randint(0, 300, size=40)
    dts = rng.uniform(0.2, 1.7, size=40)
    out = []
    for cls in (JCollector, ThroughputCollector):
        count = [0]
        col = cls(lambda: count[0], interval=1.0)
        t = 0.0
        col.start(t)
        for n, dt in zip(steps, dts):
            count[0] += int(n)
            t += float(dt)
            col.maybe_sample(t)
        count[0] += 17
        col.finish(t + 0.5)
        out.append((col.samples, col.summary()))
    assert out[1] == out[0]
    assert out[1][1]["Perc99"] >= out[1][1]["Perc50"]


def test_throughput_collector_window():
    """The whole window's rate against the samples' mean: 200 pods in the
    first 1 s sample and 800 in a 0.125 s tail give an Average of 3300
    pods/s, while the window ran 1000 pods in 1.125 s."""
    from kubernetes_tpu_torch.perf.harness import ThroughputCollector

    count = [0]
    col = ThroughputCollector(lambda: count[0], interval=1.0)
    assert col.window() == (0, 0.0)
    col.start(10.0)
    count[0] = 200
    col.maybe_sample(11.0)
    count[0] = 1000
    col.finish(11.125)
    assert col.samples == [200.0, 6400.0] and col.summary()["Average"] == 3300.0
    assert col.window() == (1000, 1.125)


def test_measured_windows():
    """Each measurePods op records its window: the measured pods and the
    seconds from the collector's start to its finish."""
    r = run_case("port", "SchedulingBasic", "oracle", dict(nodes=12, init_pods=4, measured=9))
    (win,) = r.measured_windows
    assert win["label"] == "SchedulingThroughput" and win["pods"] == 9 and win["seconds"] > 0


def test_data_items_json_byte_equal():
    from kubernetes_tpu.perf.harness import DataItem as JItem, data_items_to_json as jjson
    from kubernetes_tpu_torch.perf.harness import DataItem, data_items_to_json

    specs = [({"Average": 12.5, "Perc50": 10.0}, "pods/s", {"Name": "SchedulingThroughput"}),
             ({"Perc99": 0.25, "Count": 3.0}, "s", {"Name": "x", "result": "scheduled"}),
             ({}, "", {})]
    got = data_items_to_json([DataItem(*s) for s in specs], version="v2")
    assert got == jjson([JItem(*s) for s in specs], version="v2")
    assert data_items_to_json([DataItem(*s) for s in specs]) == jjson([JItem(*s) for s in specs])


def test_cases_match_jax():
    """``perf/cases.py`` holds the JAX op lists: the same 25 factories,
    names, defaults and dicts."""
    import inspect

    from kubernetes_tpu.perf.workloads import TEST_CASES as JCASES
    from kubernetes_tpu_torch.perf.cases import TEST_CASES

    assert list(TEST_CASES) == list(JCASES) and len(TEST_CASES) == 25
    for name, factory in TEST_CASES.items():
        assert str(inspect.signature(factory)) == str(inspect.signature(JCASES[name])), name
        assert factory() == JCASES[name](), name


def test_main_writes_the_jax_layout(tmp_path):
    from kubernetes_tpu.perf.__main__ import main as jmain
    from kubernetes_tpu_torch.perf.__main__ import main

    args = ["--scale", "0.002", "--cases", "SchedulingBasic,SchedulingDRA"]
    assert main(["--device", "cpu", "--out", str(tmp_path / "port")] + args) == 0
    assert jmain(["--out", str(tmp_path / "jax")] + args) == 0
    for what in ("port", "jax"):
        assert sorted(p.name for p in (tmp_path / what).iterdir()) == [
            "SchedulingBasic.json", "SchedulingDRA.json", "summary.json"]
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "summary.json").read_text())
    assert got == {"backend": "tpu", "scale": 0.002, "cases": 2, "failures": 0}
    for case in ("SchedulingBasic", "SchedulingDRA"):
        tdoc = json.loads((tmp_path / "port" / f"{case}.json").read_text())
        jdoc = json.loads((tmp_path / "jax" / f"{case}.json").read_text())
        assert tdoc["version"] == jdoc["version"] == "v1"
        assert [(it["unit"], it["labels"], sorted(it["data"]), it["data"].get("Count"))
                for it in tdoc["dataItems"]] == [
            (it["unit"], it["labels"], sorted(it["data"]), it["data"].get("Count"))
            for it in jdoc["dataItems"]]
        assert tdoc["dataItems"][0]["labels"] == {"Name": "SchedulingThroughput",
                                                   "TestCase": f"{case}/10Nodes",
                                                   "Backend": "tpu"}


def test_main_reports_an_unknown_case(tmp_path, capsys):
    from kubernetes_tpu_torch.perf.__main__ import main

    assert main(["--device", "cpu", "--out", str(tmp_path), "--cases", "NoSuchCase"]) == 1
    assert "unknown case 'NoSuchCase'" in capsys.readouterr().err
    assert json.loads((tmp_path / "summary.json").read_text())["failures"] == 1


def test_batched_backend_needs_the_card_by_default():
    """``device=None`` is the card: without one the batched backends raise
    rather than run on the CPU."""
    import torch

    from kubernetes_tpu_torch.perf import Runner

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner(backend="tpu")


def test_unknown_backend_raises():
    from kubernetes_tpu_torch.perf import Runner

    with pytest.raises(ValueError, match="unknown backend"):
        Runner(backend="sequential", device="cpu")


def test_c31_batch_postfilter_prefilters_unsampled():
    """C31 (settled): a batch pod that fails runs its PreFilters inside the
    PostFilter (DefaultPreemption), whose state is None; the Framework hands
    the attempt's sampling to that run (``FilterRunner.attempt_sampled``),
    so a sampled failed attempt records the per-plugin PreFilter durations
    the JAX loop records on its sampled CycleState. Unschedulable/16Nodes on
    ``tpu``: the placements and every DataItem (unit, labels, data keys,
    Count) are equal, those PreFilter items included."""
    kw = dict(nodes=16, init_pods=5, measured=10)
    jr = run_case("jax", "Unschedulable", "tpu", kw)
    tr = run_case("port", "Unschedulable", "tpu", kw)
    assert placements(tr) == placements(jr)

    def c31(it):
        return (it.labels.get("Name") == "plugin_execution_duration_seconds"
                and it.labels.get("extension_point") == "pre_filter")

    want = [it for it in jr.data_items if c31(it)]
    got = [it for it in tr.data_items if c31(it)]
    assert want and all(it.data["Count"] == 1.0 for it in want)
    assert shape(got) == shape(want)
    assert shape(tr.data_items) == shape(jr.data_items)
