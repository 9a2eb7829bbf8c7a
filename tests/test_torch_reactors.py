"""The port's store reaction hooks (``kubernetes_tpu_torch/testing/
reactors.py``, client-go's PrependReactor) and the ``testing`` package's
exports against the JAX package's, on the CPU: the JAX cases of
``tests/test_reactors_scale.py``, one script on both packages, equal; the
bind conflict through each package's loop (the JAX sequential scheduler;
the port's loop through ``schedule_one``, and both batch loops)."""

import pytest

from test_torch_controllers import CKit, run, settle_sequential


class RKit(CKit):
    def __init__(self, pkg):
        super().__init__(pkg)
        if pkg == "jax":
            from kubernetes_tpu import testing
            from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler
            from kubernetes_tpu.testing import reactors
        else:
            from kubernetes_tpu_torch import testing
            from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
            from kubernetes_tpu_torch.testing import reactors
        self.testing, self.reactors, self._tpu = testing, reactors, TPUScheduler

    def tpu(self, store, **kw):
        if self.pkg == "port":
            kw["device"] = "cpu"
        return self._tpu(store, batch_deadline_ms=0, **kw)


RKITS = {pkg: RKit(pkg) for pkg in ("jax", "port")}


def rrun(script):
    return run(lambda k: script(RKITS[k.pkg]))


def test_exports_match_jax():
    def script(k):
        return [sorted(k.testing.__all__), k.reactors.VERBS,
                k.testing.ReactionError.__mro__[1].__name__,
                k.testing.with_reactors is k.reactors.with_reactors]

    out = rrun(script)
    assert out[0] == ["Fault", "FaultPlan", "ReactionError", "locktrace", "with_reactors"]


def test_observe_and_swallow_calls():
    def script(k):
        store = k.new_store()
        tracker = k.testing.with_reactors(store)
        store.create_node(k.make_node("n1").obj())
        store.create_pod(k.make_pod("p").obj())
        tracker.prepend("create_pod", lambda v, a: True)
        store.create_pod(k.make_pod("ghost").obj())
        seen = []
        tracker.prepend("*", lambda v, a: seen.append(v) and False)
        store.create_pod(k.make_pod("again").obj())
        with pytest.raises(ValueError):
            tracker.prepend("nope", lambda v, a: False)
        with pytest.raises(k.testing.ReactionError):
            tracker.prepend("delete_pod", lambda v, a: k.reactors.raise_(
                k.testing.ReactionError("boom")))
            store.delete_pod("default/p")
        return [[v for v, _ in tracker.calls], store.get_pod("default/ghost") is None,
                store.get_pod("default/p") is not None, seen]

    out = rrun(script)
    assert out[0] == ["create_node", "create_pod", "create_pod", "create_pod", "delete_pod"]
    assert out[1] and out[2] and out[3] == ["create_pod"]


def test_injected_bind_conflict_requeues():
    """A bind that answers 409 rolls the assume back and the pod retries
    (the error path); the cache keeps no leaked assume. The sequential path
    binds through the store's ``bind`` in both packages (the DefaultBinder's
    call), which the reactor intercepts."""
    def script(k):
        store = k.new_store()
        clock = k.FakeClock()
        sched = k.Scheduler(store, now_fn=clock)
        tracker = k.testing.with_reactors(store)
        store.create_node(k.make_node("n1").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 10}).obj())
        left = [1]

        def bind_conflict(verb, args):
            if left[0]:
                left[0] -= 1
                k.reactors.raise_(k.store_mod.Conflict("simulated bind 409"))
            return False

        tracker.prepend("bind", bind_conflict)
        store.create_pod(k.make_pod("p").req({"cpu": "100m"}).obj())
        settle_sequential(sched)
        first = store.get_pod("default/p").spec.node_name
        clock.advance(301.0)
        sched.queue.flush_unschedulable_left_over()
        settle_sequential(sched)
        return [first, store.get_pod("default/p").spec.node_name,
                sched.cache.nodes["n1"].requested.milli_cpu, dict(sched.metrics),
                [v for v, _ in tracker.calls]]

    out = rrun(script)
    assert out[0] == "" and out[1] == "n1" and out[2] == 100
    assert out[4].count("bind") == 2


def test_batch_loop_writes_observed():
    """The verbs a batch loop's run writes through, as a reactor sees them:
    its binds go through ``bind_batch``, which neither package wraps."""
    def script(k):
        store = k.new_store()
        clock = k.FakeClock()
        sched = k.tpu(store, now_fn=clock, batch_size=8)
        tracker = k.testing.with_reactors(store)
        for i in range(3):
            store.create_node(k.make_node(f"n{i}").capacity(
                {"cpu": "4", "memory": "8Gi", "pods": 10}).obj())
        for i in range(10):
            store.create_pod(k.make_pod(f"p{i}").req({"cpu": "100m"}).obj())
        sched.run_until_settled()
        return [[v for v, _ in tracker.calls],
                sorted((key, p.spec.node_name) for key, p in store.pods.items())]

    out = rrun(script)
    assert out[0] == ["create_node"] * 3 + ["create_pod"] * 10
    assert all(n for _, n in out[1])
