"""PriorityClass admission in the port's store against the JAX store.

The JAX store runs its admission chain on every pod create; its
DefaultPriority plugin (``kubernetes_tpu/apiserver/admission.py:79-94``)
turns ``priorityClassName`` into ``spec.priority`` and refuses a class
that does not exist. The port's store runs the same plugin
(``kubernetes_tpu_torch/apiserver/admission.py``), so a pod that names a
class sorts, preempts and is preempted at the class's value in both
packages. Every comparison is exact.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import to_jax  # noqa: E402


def _stores():
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.store import Store

    jstore, tstore = ClusterStore(), Store()
    jstore.validation_enabled = False
    return jstore, tstore


def _class(name: str, value: int):
    from kubernetes_tpu_torch.api.types import ObjectMeta, PriorityClass

    return PriorityClass(meta=ObjectMeta(name=name, namespace=""), value=value)


def test_priority_class_sets_the_same_priority_in_both_stores():
    """The repair: a pod that sets only ``priorityClassName`` gets the
    class's value as its priority in the port's store, as in the JAX store
    (before the repair the port left it at 0)."""
    from kubernetes_tpu_torch.api.wrappers import make_pod

    jstore, tstore = _stores()
    for pc in (_class("high", 100), _class("low", 1)):
        jstore.create_priority_class(to_jax(pc))
        tstore.create_priority_class(pc)
    for name, cls in (("a", "high"), ("b", "low"), ("c", "")):
        pod = make_pod(name).req({"cpu": "100m"}).obj()
        pod.spec.priority_class_name = cls
        jstore.create_pod(to_jax(pod))
        tstore.create_pod(pod)
    got = {k: p.spec.priority for k, p in tstore.pods.items()}
    want = {k: p.spec.priority for k, p in jstore.pods.items()}
    assert got == want == {"default/a": 100, "default/b": 1, "default/c": 0}
    assert sorted(tstore.priority_classes) == sorted(jstore.priority_classes)


def test_explicit_priority_wins_over_the_class():
    """A pod whose priority is already set keeps it, in both stores."""
    from kubernetes_tpu_torch.api.wrappers import make_pod

    jstore, tstore = _stores()
    jstore.create_priority_class(to_jax(_class("high", 100)))
    tstore.create_priority_class(_class("high", 100))
    pod = make_pod("a").priority(7).obj()
    pod.spec.priority_class_name = "high"
    jstore.create_pod(to_jax(pod))
    tstore.create_pod(pod)
    assert tstore.get_pod("default/a").spec.priority == jstore.get_pod(
        "default/a").spec.priority == 7


def test_missing_class_is_refused_by_both_stores():
    """A pod naming a class that does not exist is refused before the
    write: neither store holds it and no handler sees it."""
    from kubernetes_tpu.apiserver.admission import AdmissionError as JAdmissionError
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.apiserver.admission import AdmissionError

    jstore, tstore = _stores()
    seen = []
    tstore.add_event_handler("Pod", lambda ev, old, new: seen.append(ev))
    pod = make_pod("a").obj()
    pod.spec.priority_class_name = "missing"
    with pytest.raises(JAdmissionError, match="no PriorityClass 'missing'"):
        jstore.create_pod(to_jax(pod))
    with pytest.raises(AdmissionError, match="no PriorityClass 'missing'"):
        tstore.create_pod(pod)
    assert not tstore.pods and not jstore.pods and not seen


def _preemption_pair(classes: bool):
    """A small PreemptionBasic through both loops (``LoopPair``): its
    PriorityClasses first, then the nodes, the victims, the warm and the
    measured preemptors, each wave settled."""
    from _torch_cases import LoopPair
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.preemption_basic(nodes=12, init_pods=48, measured=12, classes=classes)
    pair = LoopPair(batch=16)
    pair.create("create_priority_class", *(_class(n, v) for n, v in w.priority_classes))
    pair.create("create_node", *(ni.node for ni in w.node_infos()))
    for pods in (w.init_pod_list(), w.warm_pod_list(), w.measured_pod_list()):
        pair.create("create_pod", *pods)
        pair.settle()
    return pair


def test_preemption_with_classes_equals_numbers_and_jax():
    """PreemptionBasic with its priorities from PriorityClasses (``low`` 1,
    ``high`` 100): every preemptor binds; placements, nominations, victims
    and counters equal the JAX loop's and the numeric run's."""
    with_classes = _preemption_pair(True)
    got = with_classes.assert_equal()
    numeric = _preemption_pair(False)
    want = numeric.assert_equal()
    assert got == want
    assert with_classes.tsched.preempted == numeric.tsched.preempted
    assert with_classes.tsched.nominations == numeric.tsched.nominations
    assert with_classes.tsched.preempted
    assert all(node for key, node in got["placed"].items()
               if key.startswith("default/preemptor-"))
    assert {p.spec.priority for p in with_classes.tstore.pods.values()} == {1, 100}
