"""The port's lock-order / blocking-under-lock tracer (``kubernetes_tpu_torch/
testing/locktrace.py``) against the JAX package's, on the CPU.

- The tracer alone: one script of acquisitions, inversions, reentrant
  locks and blocking marks on both packages, the same report, cycles and
  ``assert_clean`` verdict.
- The factories: plain ``threading`` primitives with ``KTPU_LOCKTRACE``
  unset, traced wrappers under ``KTPU_LOCKTRACE=1``.
- The port's locks are built through the factories under the JAX lock
  names: under ``KTPU_LOCKTRACE=1`` a loop run (the in-flight ring with the
  commit worker, a WAL-backed store) in each package ends ``assert_clean()``
  with the same lock names acquired; the retry sleep and the WAL append
  are marked as blocking."""

import os
import threading

import pytest


def _mods():
    from kubernetes_tpu.testing import locktrace as jlt
    from kubernetes_tpu_torch.testing import locktrace as tlt

    return jlt, tlt


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("KTPU_LOCKTRACE", "1")
    for lt in _mods():
        lt.reset()
    yield
    for lt in _mods():
        lt.reset()


def _tracer_script(lt):
    a, b, r = lt.make_lock("A"), lt.make_lock("B"), lt.make_rlock("R")
    with a:
        with b:
            lt.note_blocking("sleep", "under both")
    with r:
        with r:
            with a:
                lt.note_blocking("fsync", "reviewed", allowed="a deliberate hold")
    out = [lt.tracer().cycles()]
    try:
        lt.assert_clean()
        out.append("clean")
    except AssertionError as e:
        out.append(str(e).split("\n", 1)[1].split(" at ")[0])
    done = threading.Event()

    def other():
        with b:
            with a:
                pass
        done.set()

    threading.Thread(target=other).start()
    done.wait(10)
    out.append(lt.tracer().cycles())
    report = lt.tracer().report()
    for ev in report["blockingViolations"] + report["blockingAllowed"]:
        ev.pop("site")
    out.append({k: {e: v["count"] for e, v in report[k].items()} if k == "edges" else report[k]
                for k in report})
    out.append(lt.TracedLock("X", threading.Lock()).locked())
    return out


def test_tracer_matches_jax(traced):
    jlt, tlt = _mods()
    want, got = _tracer_script(jlt), _tracer_script(tlt)
    assert got == want
    assert got[0] == [] and got[2] == [["A", "B"]]
    assert got[3]["acquisitions"] == {"A": 3, "B": 2, "R": 2}


def test_factories_plain_when_off(monkeypatch):
    monkeypatch.delenv("KTPU_LOCKTRACE", raising=False)
    _, tlt = _mods()
    assert type(tlt.make_lock("x")) is type(threading.Lock())
    assert type(tlt.make_rlock("x")) is type(threading.RLock())
    tlt.note_blocking("sleep", "nothing recorded")
    monkeypatch.setenv("KTPU_LOCKTRACE", "1")
    assert isinstance(tlt.make_lock("x"), tlt.TracedLock)
    monkeypatch.setenv("KTPU_LOCKTRACE", "0")
    assert not tlt.enabled()


def _loop_run(pkg, tmp_path):
    """The ring with the commit worker over a WAL-backed store, settled;
    then the tracer's lock names, its verdict and the allowed marks."""
    if pkg == "jax":
        from kubernetes_tpu.api.wrappers import make_node, make_pod
        from kubernetes_tpu.apiserver.store import ClusterStore as Store
        from kubernetes_tpu.apiserver.wal import attach_wal
        from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
        from kubernetes_tpu.metrics import latency_ledger
        from kubernetes_tpu.testing import locktrace as lt
        from kubernetes_tpu.utils.clock import FakeClock
        kw = {}
    else:
        from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
        from kubernetes_tpu_torch.apiserver.store import Store
        from kubernetes_tpu_torch.apiserver.wal import attach_wal
        from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
        from kubernetes_tpu_torch.metrics import latency_ledger
        from kubernetes_tpu_torch.testing import locktrace as lt
        from kubernetes_tpu_torch.utils.clock import FakeClock
        kw = {"device": "cpu"}
    clock = FakeClock()
    store = Store()
    attach_wal(store, str(tmp_path / f"{pkg}.wal"))
    sched = TPUScheduler(store, now_fn=clock, batch_size=16, batch_deadline_ms=0,
                         percentage_of_nodes_to_score=100, **kw)
    latency_ledger.enable(sched.smetrics, now_fn=clock)
    try:
        for i in range(12):
            store.create_node(make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "8Gi", "pods": 20}).obj())
        for i in range(60):
            store.create_pod(make_pod(f"p{i}").req({"cpu": "200m"}).obj())
        store.create_pod(make_pod("huge").req({"cpu": "64"}).obj())
        sched.run_until_settled()
        if sched.commit_worker is not None:
            sched.commit_worker.flush()
        placed = sorted((k, p.spec.node_name) for k, p in store.pods.items())
    finally:
        if pkg == "port":
            sched.close()
        elif sched.commit_worker is not None:
            sched.commit_worker.stop()
        latency_ledger.disable()
    report = lt.tracer().report()
    lt.assert_clean()
    return [sorted(report["acquisitions"]), placed,
            sorted({(e["kind"], e["allowed"]) for e in report["blockingAllowed"]})]


@pytest.mark.parametrize("worker", ["0", "1"])
def test_loop_run_is_clean_with_the_jax_lock_names(traced, monkeypatch, tmp_path, worker):
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "2")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", worker)
    want = _loop_run("jax", tmp_path)
    got = _loop_run("port", tmp_path)
    assert got[1] == want[1]
    assert {"Cache", "SchedulingQueue", "ClusterStore", "LatencyLedger"} <= set(got[0])
    assert got[0] == want[0]
    assert ("wal_append", "WAL order must match the store journal order") in got[2]


def test_retry_sleep_under_a_traced_lock_is_flagged(traced):
    from kubernetes_tpu_torch.backend.errors import RetryPolicy, TransientDeviceError
    from kubernetes_tpu_torch.testing import locktrace as lt

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise TransientDeviceError("x")
        return "ok"

    policy = RetryPolicy(sleep_fn=lambda s: None)
    with lt.make_lock("DeviceService"):
        assert policy.run("batch", flaky) == "ok"
    assert [v["kind"] for v in lt.tracer().blocking_violations] == ["sleep"]
    with pytest.raises(AssertionError, match="blocking under lock: sleep"):
        lt.assert_clean()
