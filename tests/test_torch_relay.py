"""The port's device-read accounting (``kubernetes_tpu_torch/utils/
relay.py``) against the JAX package's, on the CPU: the batch path's
contract is one blocking read per batch, the packed result block's
("commit-read"); the preemption screen's read ("preempt-read") and the
flat gangs' verdicts ("gang-read") add theirs only when they run on the
device, and failure diagnosis rides the packed block. The JAX tests'
cases (``tests/test_relay_matrix.py``) through both loops, the tallies
equal; and ``probe_platform``, which reports what it found and switches
nothing."""

import os
import sys

import pytest


class _Pkg:
    def __init__(self, pkg):
        if pkg == "jax":
            from kubernetes_tpu.api.wrappers import make_node, make_pod
            from kubernetes_tpu.apiserver.store import ClusterStore as Store
            from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
            from kubernetes_tpu.utils import relay
            from kubernetes_tpu.utils.clock import FakeClock
        else:
            from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
            from kubernetes_tpu_torch.apiserver.store import Store
            from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
            from kubernetes_tpu_torch.utils import relay
            from kubernetes_tpu_torch.utils.clock import FakeClock
        self.pkg, self.make_node, self.make_pod, self.Store = pkg, make_node, make_pod, Store
        self.relay, self.FakeClock = relay, FakeClock
        self._tpu = TPUScheduler

    def loop(self, store, clock, batch):
        kw = dict(now_fn=clock, batch_size=batch, batch_deadline_ms=0,
                  percentage_of_nodes_to_score=100)
        if self.pkg == "port":
            kw["device"] = "cpu"
        return self._tpu(store, **kw)


PKGS = {p: _Pkg(p) for p in ("jax", "port")}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("KTPU_PIPELINE_DEPTH", "KTPU_COMMIT_WORKER", "KTPU_FULL_BATCH", "KTPU_SPEC"):
        monkeypatch.delenv(key, raising=False)


def _case(k, case):
    clock = k.FakeClock()
    store = k.Store(now_fn=clock) if k.pkg == "port" else k.Store()
    batch = {"feasible": 64, "failing": 32, "mixed": 16, "preempt": 16}[case]
    sched = k.loop(store, clock, batch)
    nodes = {"feasible": (32, "8", 50), "failing": (1, "1", 4), "mixed": (2, "4", 50),
             "preempt": (2, "2", 50)}[case]
    for i in range(nodes[0]):
        store.create_node(k.make_node(f"n{i}").capacity(
            {"cpu": nodes[1], "memory": "16Gi", "pods": nodes[2]}).obj())
    with k.relay.track() as counts:
        if case == "feasible":
            for i in range(128):
                store.create_pod(k.make_pod(f"p{i}").req({"cpu": "100m",
                                                          "memory": "128Mi"}).obj())
        elif case == "failing":
            for i in range(8):
                store.create_pod(k.make_pod(f"big{i}").req({"cpu": "4"}).obj())
        elif case == "mixed":
            for i in range(6):
                store.create_pod(k.make_pod(f"ok{i}").req({"cpu": "100m",
                                                           "memory": "64Mi"}).obj())
            for i in range(2):
                store.create_pod(k.make_pod(f"big{i}").req({"cpu": "32"}).obj())
        else:
            for i in range(4):
                store.create_pod(k.make_pod(f"low{i}").req({"cpu": "900m"}).priority(1).obj())
            sched.run_until_settled()
            for i in range(2):
                store.create_pod(k.make_pod(f"high{i}").req({"cpu": "1500m"})
                                 .priority(100).obj())
        sched.run_until_settled()
    placed = {key: p.spec.node_name for key, p in sorted(store.pods.items())}
    return dict(counts), sched.batch_counter, dict(sched.metrics), placed


@pytest.mark.parametrize("case", ["feasible", "failing", "mixed", "preempt"])
def test_one_read_per_batch_matches_jax(case):
    want = _case(PKGS["jax"], case)
    got = _case(PKGS["port"], case)
    assert got == want
    counts, batches = got[0], got[1]
    assert batches > 0 and counts["commit-read"] == batches
    assert counts.get("diagnosis-read", 0) == 0
    if case == "preempt":
        assert counts.get("preempt-read", 0) >= 1
    else:
        assert sum(counts.values()) == counts["commit-read"]
    if case == "feasible":
        assert got[2]["scheduled"] == 128


def test_track_is_scoped_and_per_thread():
    import threading

    relay = PKGS["port"].relay
    relay.count_sync("outside")
    with relay.track() as outer:
        relay.count_sync("a")
        with relay.track() as inner:
            relay.count_sync("b")
        t = threading.Thread(target=relay.count_sync, args=("other-thread",))
        t.start()
        t.join()
        relay.count_sync("a")
    assert dict(outer) == {"a": 2} and dict(inner) == {"b": 1}


def test_probe_platform_reports_and_switches_nothing(monkeypatch):
    relay = PKGS["port"].relay
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert relay.probe_platform() == ("cpu", {"outcome": "forced-cpu"})
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setenv("BENCH_PROBE_ATTEMPTS", "1")
    before = dict(os.environ)
    platform, diag = relay.probe_platform(timeout_s=120)
    assert dict(os.environ) == before
    assert diag["outcome"] == "ok" and diag["attempt"] == 0
    import torch

    assert platform == ("cuda:" + torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else "cpu")


def test_probe_platform_failure_is_reported(monkeypatch):
    """A child that fails at once ends the probe after one attempt (no gap
    is slept): its exit code and error's tail are reported, the platform is
    "unreachable", and the environment is left as it was."""
    relay = PKGS["port"].relay
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("BENCH_PROBE_ATTEMPTS", "3")
    monkeypatch.setenv("BENCH_PROBE_GAP", "600")
    monkeypatch.setattr(relay, "_PROBE", "import sys; sys.exit('no card here')")
    before = dict(os.environ)
    platform, diag = relay.probe_platform(timeout_s=60)
    assert platform == "unreachable" and dict(os.environ) == before
    assert diag["outcome"] == "rc=1" and diag["attempt"] == 0
    assert "no card here" in diag["error_tail"]
