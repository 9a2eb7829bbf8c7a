"""The port's cache debugger (``kubernetes_tpu_torch/cache/debugger.py``:
``CacheComparer``, ``CacheDumper``, ``CacheDebugger`` on SIGUSR2) and the
queue's /debug dump (``SchedulingQueue.dump``) against the JAX package's, on
the CPU: the JAX debugger cases of ``tests/test_spread_limits_debugger.py``,
one script on both packages, equal."""

import logging
import os
import signal

import pytest


class _Pkg:
    def __init__(self, pkg):
        if pkg == "jax":
            from kubernetes_tpu.api.wrappers import make_node, make_pod
            from kubernetes_tpu.apiserver.store import ClusterStore as Store
            from kubernetes_tpu.cache.cache import Cache
            from kubernetes_tpu.cache.debugger import CacheComparer, CacheDebugger
            from kubernetes_tpu.queue.scheduling_queue import SchedulingQueue
        else:
            from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
            from kubernetes_tpu_torch.apiserver.store import Store
            from kubernetes_tpu_torch.cache.cache import Cache
            from kubernetes_tpu_torch.cache.debugger import CacheComparer, CacheDebugger
            from kubernetes_tpu_torch.queue.scheduling_queue import SchedulingQueue
        self.make_node, self.make_pod, self.Store, self.Cache = make_node, make_pod, Store, Cache
        self.CacheComparer, self.CacheDebugger = CacheComparer, CacheDebugger
        self.SchedulingQueue = SchedulingQueue


PKGS = {p: _Pkg(p) for p in ("jax", "port")}


def both(script):
    want, got = script(PKGS["jax"]), script(PKGS["port"])
    assert got == want
    return got


def _setup(k):
    return k.Store(), k.Cache(now_fn=lambda: 5.0), k.SchedulingQueue(now_fn=lambda: 5.0)


def test_in_sync():
    def script(k):
        store, cache, queue = _setup(k)
        node = k.make_node("n1").obj()
        store.create_node(node)
        cache.add_node(node)
        pod = k.make_pod("p1").node("n1").obj()
        store.pods[pod.meta.key()] = pod
        cache.add_pod(pod)
        queued = k.make_pod("q").obj()
        store.pods[queued.meta.key()] = queued
        queue.add(queued)
        c = k.CacheComparer(store, cache, queue)
        return [c.compare_nodes(), c.compare_pods(), c.compare()]

    assert both(script) == [([], []), ([], []), True]


def test_drift_detected(caplog):
    def script(k):
        store, cache, queue = _setup(k)
        store.create_node(k.make_node("n1").obj())
        ghost = k.make_node("ghost").obj()
        cache.add_node(ghost)
        pod = k.make_pod("p").node("ghost").obj()
        cache.add_pod(pod)
        store.pods["default/lost"] = k.make_pod("lost").obj()
        c = k.CacheComparer(store, cache, queue)
        with caplog.at_level(logging.WARNING):
            ok = c.compare()
        return [c.compare_nodes(), c.compare_pods(), ok]

    assert both(script) == [(["n1"], ["ghost"]), (["default/lost"], ["default/p"]), False]


def test_dumper_output(caplog):
    def script(k):
        store, cache, queue = _setup(k)
        node = k.make_node("n1").capacity({"cpu": "4", "memory": "8Gi", "pods": 10}).obj()
        cache.add_node(node)
        cache.add_pod(k.make_pod("r").req({"cpu": "500m"}).node("n1").obj())
        queue.add(k.make_pod("p1").obj())
        dbg = k.CacheDebugger(store, cache, queue)
        with caplog.at_level(logging.INFO):
            return dbg.dumper.dump_all()

    text = both(script)
    assert "Node: n1" in text and "Pod: default/p1" in text and "cpu=500m" in text


def test_sigusr2_runs_comparer_and_dumper():
    def script(k):
        store, cache, queue = _setup(k)
        store.create_node(k.make_node("n1").obj())
        dbg = k.CacheDebugger(store, cache, queue)
        seen = []
        dbg.comparer.compare = lambda: seen.append("compare") or True
        dbg.dumper.dump_all = lambda: seen.append("dump") or ""
        old = signal.getsignal(signal.SIGUSR2)
        try:
            dbg.listen_for_signal()
            os.kill(os.getpid(), signal.SIGUSR2)
        finally:
            signal.signal(signal.SIGUSR2, old)
        return seen

    assert both(script) == ["compare", "dump"]


@pytest.mark.parametrize("flush", [False, True])
def test_queue_dump(flush):
    """``SchedulingQueue.dump``, the /debug/queue body: active, backoff,
    unschedulable and gated entries, counts, cycles and the fair-share view."""
    def script(k):
        t = [100.0]
        queue = k.SchedulingQueue(now_fn=lambda: t[0])
        for i, prio in enumerate((5, 1, 9)):
            queue.add(k.make_pod(f"a{i}").priority(prio).obj())
        qp = queue.pop()
        queue.add_unschedulable_if_not_present(qp, queue.scheduling_cycle)
        qp2 = queue.pop()
        qp2.unschedulable_plugins = {"NodeResourcesFit"}
        queue.add_unschedulable_if_not_present(qp2, queue.scheduling_cycle)
        t[0] += 0.5
        if flush:
            queue.flush_backoff_completed()
            t[0] += 301.0
            queue.flush_unschedulable_left_over()
        return queue.dump()

    out = both(script)
    assert sum(out["counts"].values()) == 3 and "fairShare" in out
