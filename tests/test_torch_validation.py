"""The port's field validation (``kubernetes_tpu_torch/api/validation.py``)
against the JAX package's on the same objects.

Every case of the JAX reject corpus (``tests/test_validation_corpus.py``)
and of ``tests/test_validation.py`` is rebuilt from the port's types; the
JAX copy of each object is made with ``to_jax``. Each case requires the
port's error list (``validate_pod``, ``validate_node``) or its outcome
(``validate`` / ``validate_update``: the ``ValidationError``'s kind, name,
errors and message) to equal the JAX one exactly, and to carry the
fragment the JAX test looks for. Then the port's store refuses what the
JAX store refuses, and writes nothing."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import to_jax  # noqa: E402


def _t():
    from kubernetes_tpu_torch.api import types

    return types


def _pod(name="p", ns="default", containers=None, **spec_kw):
    t = _t()
    return t.Pod(meta=t.ObjectMeta(name=name, namespace=ns),
                 spec=t.PodSpec(containers=list(containers) if containers is not None
                                else [t.Container(name="c", image="img")], **spec_kw))


def _node_term(*reqs):
    t = _t()
    return t.Affinity(node_affinity=t.NodeAffinity(required=t.NodeSelector(
        terms=(t.NodeSelectorTerm(match_expressions=tuple(reqs)),))))


def _spread(**kw):
    t = _t()
    return _pod(topology_spread_constraints=(t.TopologySpreadConstraint(**kw),))


def _ported_pod(edit=None):
    from kubernetes_tpu_torch.api.wrappers import make_pod

    pod = make_pod("web").req({"cpu": "1"}).obj()
    if edit is not None:
        edit(pod)
    return pod


def _with_tolerations(*tols):
    pod = _pod()
    pod.spec.tolerations = tuple(tols)
    return pod


def _node(edit):
    from kubernetes_tpu_torch.api.wrappers import make_node

    nw = make_node("n")
    node = edit(nw)
    return node


def _bad_taint_value(nw):
    t = _t()
    node = nw.obj()
    node.spec.taints = (t.Taint(key="k", value="bad value!", effect="NoSchedule"),)
    return node


def _bad_taint_effect(nw):
    t = _t()
    node = nw.capacity({"cpu": "4"}).obj()
    node.spec.taints = (t.Taint(key="k", effect="Eventually"),)
    return node


def _bad_label_key(pod):
    pod.meta.labels["-bad/key!"] = "v"


# (case id, the function that makes the port object, the fragment the JAX test expects)
POD_CASES = [
    # tests/test_validation.py
    ("valid_pod", lambda: _ported_pod(), None),
    ("bad_name", lambda: _pod(name="Bad_Name"), "metadata.name"),
    ("no_name", lambda: _pod(name=""), "name is required"),
    ("no_containers", lambda: _pod(containers=[]), "at least one container"),
    ("duplicate_container_names", lambda: _pod(containers=[
        _t().Container(name="c", image="a"), _t().Container(name="c", image="b")]),
     "duplicate container name"),
    ("request_above_limit", lambda: _pod(containers=[_t().Container(
        name="c", image="a", requests={"cpu": "2"}, limits={"cpu": "1"})]),
     "must be ≤ the cpu limit"),
    ("unparseable_quantity", lambda: _pod(containers=[_t().Container(
        name="c", image="a", requests={"cpu": "banana"})]), "is invalid"),
    ("bad_host_port", lambda: _pod(containers=[_t().Container(
        name="c", image="a", ports=(_t().ContainerPort(container_port=80, host_port=99999),))]),
     "1-65535"),
    ("toleration_operator", lambda: _with_tolerations(
        _t().Toleration(key="k", operator="Sometimes")), "Exists or Equal"),
    ("toleration_exists_value", lambda: _with_tolerations(
        _t().Toleration(key="k", operator="Exists", value="v")),
     "must be empty when operator is Exists"),
    ("bad_spread_constraint", lambda: _spread(max_skew=0, topology_key="",
                                              when_unsatisfiable="Whenever"), "maxSkew"),
    ("bad_label_key", lambda: _ported_pod(_bad_label_key), "labels"),
    # tests/test_validation_corpus.py
    ("in_requires_values", lambda: _pod(affinity=_node_term(
        _t().Requirement(key="zone", operator="In"))), "values: must be specified"),
    ("exists_forbids_values", lambda: _pod(affinity=_node_term(
        _t().Requirement(key="zone", operator="Exists", values=("a",)))),
     "values: may not be specified"),
    ("gt_single_integer", lambda: _pod(affinity=_node_term(
        _t().Requirement(key="cores", operator="Gt", values=("ten",)))), "must be an integer"),
    ("unknown_operator", lambda: _pod(affinity=_node_term(
        _t().Requirement(key="k", operator="Near"))), "not a valid operator"),
    ("pod_affinity_topology_key", lambda: _pod(affinity=_t().Affinity(
        pod_affinity=_t().PodAffinity(required=(
            _t().PodAffinityTerm(label_selector=_t().LabelSelector()),)))),
     "topologyKey: can not be empty"),
    ("preferred_pod_weight", lambda: _pod(affinity=_t().Affinity(
        pod_anti_affinity=_t().PodAntiAffinity(preferred=(_t().WeightedPodAffinityTerm(
            weight=500, term=_t().PodAffinityTerm(topology_key="zone")),)))),
     "must be in the range 1-100"),
    ("preferred_node_weight", lambda: _pod(affinity=_t().Affinity(
        node_affinity=_t().NodeAffinity(preferred=(_t().PreferredSchedulingTerm(weight=0),)))),
     "must be in the range 1-100"),
    ("bad_selector_key_in_term", lambda: _pod(affinity=_t().Affinity(
        pod_affinity=_t().PodAffinity(required=(_t().PodAffinityTerm(
            topology_key="zone", label_selector=_t().LabelSelector(match_expressions=(
                _t().Requirement(key="-bad-", operator="Exists"),))),)))),
     "matchExpressions[0].key"),
    ("min_domains_do_not_schedule", lambda: _spread(
        max_skew=1, topology_key="zone", when_unsatisfiable="ScheduleAnyway", min_domains=2),
     "minDomains: can only be specified"),
    ("min_domains_positive", lambda: _spread(
        max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule", min_domains=0),
     "minDomains: 0 must be greater than 0"),
    ("max_skew_positive", lambda: _spread(max_skew=0, topology_key="zone",
                                          when_unsatisfiable="DoNotSchedule"), "maxSkew"),
    ("spread_selector_shape", lambda: _spread(
        max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule",
        label_selector=_t().LabelSelector(match_expressions=(
            _t().Requirement(key="app", operator="In"),))),
     "labelSelector.matchExpressions[0].values"),
    ("duplicate_host_port", lambda: _pod(containers=(
        _t().Container(name="a", ports=(_t().ContainerPort(container_port=80, host_port=8080),)),
        _t().Container(name="b", ports=(_t().ContainerPort(container_port=81, host_port=8080),)),
    )), "duplicate host port"),
    ("out_of_range_host_port", lambda: _pod(containers=(_t().Container(
        name="a", ports=(_t().ContainerPort(container_port=80, host_port=70000),)),)),
     "must be in 1-65535"),
    ("request_exceeding_limit", lambda: _pod(containers=(_t().Container(
        name="a", requests={"cpu": "2"}, limits={"cpu": "1"}),)), "must be ≤ the cpu limit"),
    ("unparseable_quantity_corpus", lambda: _pod(containers=(_t().Container(
        name="a", requests={"cpu": "two"}),)), "quantity 'two' is invalid"),
    ("exists_toleration_with_value", lambda: _ported_pod(lambda p: setattr(
        p.spec, "tolerations", (_t().Toleration(key="k", operator="Exists", value="v"),))),
     "must be empty when operator is Exists"),
]

NODE_CASES = [
    ("duplicate_taint", lambda: _node(lambda nw: nw.taint("k", "v").taint("k", "w").obj()),
     "duplicate taint"),
    ("bad_taint_value", lambda: _node(_bad_taint_value), "not a valid taint value"),
    ("bad_taint_effect", lambda: _node(_bad_taint_effect), "must be one of"),
    ("valid_node", lambda: _node(lambda nw: nw.capacity({"cpu": "1"}).obj()), None),
]


@pytest.mark.parametrize("build,fragment", [c[1:] for c in POD_CASES],
                         ids=[c[0] for c in POD_CASES])
def test_validate_pod_matches_jax(build, fragment):
    from kubernetes_tpu.api.validation import validate_pod as jax_validate_pod
    from kubernetes_tpu_torch.api.validation import validate_pod

    pod = build()
    errs = validate_pod(pod)
    assert errs == jax_validate_pod(to_jax(pod))
    if fragment is None:
        assert errs == []
    else:
        assert any(fragment in e for e in errs), (fragment, errs)


@pytest.mark.parametrize("build,fragment", [c[1:] for c in NODE_CASES],
                         ids=[c[0] for c in NODE_CASES])
def test_validate_node_matches_jax(build, fragment):
    from kubernetes_tpu.api.validation import validate_node as jax_validate_node
    from kubernetes_tpu_torch.api.validation import validate_node

    node = build()
    errs = validate_node(node)
    assert errs == jax_validate_node(to_jax(node))
    if fragment is None:
        assert errs == []
    else:
        assert any(fragment in e for e in errs), (fragment, errs)


def _outcome(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - compared with the JAX outcome
        return (type(err).__name__, getattr(err, "kind", None), getattr(err, "name", None),
                getattr(err, "errors", None), str(err))
    return None


def _kind_objects():
    t = _t()
    return [
        ("Pod", _pod(name="Bad_Name")),
        ("Pod", _ported_pod()),
        ("Node", _node(lambda nw: nw.capacity({"cpu": "1"}).obj())),
        ("Namespace", t.Namespace(meta=t.ObjectMeta(name="Not.A.Label"))),
        ("Namespace", t.Namespace(meta=t.ObjectMeta(name="ok", namespace=""))),
        ("PriorityClass", t.PriorityClass(meta=t.ObjectMeta(name="big", namespace=""),
                                          value=2_000_000_000)),
        ("Service", t.Service(meta=t.ObjectMeta(name="svc"), selector={"bad key!": "v"})),
        ("PodGroup", t.PodGroup(meta=t.ObjectMeta(name="g"), min_member=0)),
        ("SchedulingQuota", t.SchedulingQuota(meta=t.ObjectMeta(name="q"), hard={"gpus": 1})),
        ("ResourceClaim", t.ResourceClaim(meta=t.ObjectMeta(name="Claim_1"))),
        ("ResourceClass", t.ResourceClass(meta=t.ObjectMeta(name="tpu.example.com",
                                                            namespace=""))),
        ("PersistentVolumeClaim", t.PersistentVolumeClaim(meta=t.ObjectMeta(name="c",
                                                                            namespace=""))),
        ("LimitRange", t.LimitRange(meta=t.ObjectMeta(name="UPPER"))),
        ("ResourceQuota", t.ResourceQuota(meta=t.ObjectMeta(name="quota"))),
        ("RuntimeClass", t.RuntimeClass(meta=t.ObjectMeta(name="Not_Checked", namespace=""))),
    ]


@pytest.mark.parametrize("index", range(15))
def test_validate_dispatch_matches_jax(index):
    """``validate`` by kind: the same ValidationError (kind, name, errors,
    message) or none."""
    from kubernetes_tpu.api.validation import validate as jax_validate
    from kubernetes_tpu_torch.api.validation import validate

    kind, obj = _kind_objects()[index]
    jobj = to_jax(obj)
    assert _outcome(lambda: validate(kind, obj)) == _outcome(lambda: jax_validate(kind, jobj))


def _update_pair(edit):
    old = _ported_pod()
    old.spec.node_name = "n1"
    new = old.clone()
    new.spec.containers = [_t().Container(name=c.name, image=c.image, requests=dict(c.requests))
                           for c in old.spec.containers]
    edit(new)
    return old, new


UPDATE_CASES = [
    ("node_name_immutable", lambda new: setattr(new.spec, "node_name", "n2")),
    ("image_update_allowed", lambda new: setattr(new.spec.containers[0], "image", "other:latest")),
    ("priority_immutable", lambda new: setattr(new.spec, "priority", 9)),
    ("containers_added", lambda new: new.spec.containers.append(_t().Container(name="d"))),
]


@pytest.mark.parametrize("edit", [c[1] for c in UPDATE_CASES], ids=[c[0] for c in UPDATE_CASES])
def test_validate_update_matches_jax(edit):
    from kubernetes_tpu.api.validation import validate_update as jax_validate_update
    from kubernetes_tpu_torch.api.validation import validate_update

    old, new = _update_pair(edit)
    jold, jnew = to_jax(old), to_jax(new)
    assert _outcome(lambda: validate_update("Pod", old, new)) == _outcome(
        lambda: jax_validate_update("Pod", jold, jnew))


def _store_writes():
    t = _t()
    bad_pod = _pod(affinity=t.Affinity(pod_affinity=t.PodAffinity(required=(
        t.PodAffinityTerm(),))))
    return [
        ("create_pod", (_pod(name="Not-Valid-Name!"),)),
        ("create_pod", (bad_pod,)),
        ("create_node", (_node(_bad_taint_effect),)),
        ("create_object", ("PodGroup", t.PodGroup(meta=t.ObjectMeta(name="g"), min_member=0))),
        ("create_pvc", (t.PersistentVolumeClaim(meta=t.ObjectMeta(name="Bad_Claim")),)),
    ]


@pytest.mark.parametrize("index", range(5))
def test_store_refuses_what_jax_refuses(index):
    """The port's store raises the JAX store's ValidationError, after
    admission, and stores nothing."""
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.apiserver.store import Store

    method, args = _store_writes()[index]
    jstore, tstore = ClusterStore(), Store()
    jargs = tuple(to_jax(a) for a in args)
    got = _outcome(lambda: getattr(tstore, method)(*args))
    assert got is not None and got[0] == "ValidationError"
    assert got == _outcome(lambda: getattr(jstore, method)(*jargs))
    assert not tstore.pods and not tstore.nodes and not tstore.pod_groups and not tstore.pvcs


def test_validation_switch():
    """``validation_enabled = False`` lets the write through, as on the JAX
    store."""
    from kubernetes_tpu_torch.apiserver.store import Store

    store = Store()
    store.validation_enabled = False
    store.create_pod(_pod(name="Not-Valid-Name!"))
    assert list(store.pods) == ["default/Not-Valid-Name!"]
