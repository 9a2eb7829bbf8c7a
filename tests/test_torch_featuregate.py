"""The port's feature gates (``kubernetes_tpu_torch/utils/featuregate.py``)
against the JAX package's, and C36: VolumeBinding's VolumeCapacityPriority
score behind its gate.

- The known features, their defaults and locks, the flag form and its
  errors: one script, both packages, equal.
- C36. JAX's VolumeBinding reads the VolumeCapacityPriority gate at
  construction and, with it on, scores a node by the utilization of the
  PVs its Filter chose there (``kubernetes_tpu/framework/plugins/
  volume.py:263-270``, ``:344-364``, integer truncation included). The
  plugin alone on JAX's case (a tight and a loose PV); and both loops on a
  delayed-binding case with VolumeBinding in the profile's Score list: the
  pod lands on the tight PV's node, where the plain scores prefer the
  other. With the gate on, ``_framework_batchable`` judges the profiles
  alike in both packages, and both loops send the same pods down the same
  path. The loop case fails on a port whose score is 0."""

import pytest

from _torch_cases import LoopPair


def _gates():
    from kubernetes_tpu.utils import featuregate as jfg
    from kubernetes_tpu_torch.utils import featuregate as tfg

    return jfg, tfg


def _script(fg_mod):
    out = []
    fg = fg_mod.FeatureGate()
    out.append([(name, (s.default, s.pre_release, s.locked_to_default))
                for name, s in fg.known_features()])
    fg.set_from_string("TPUBatchedScheduling=false,ReadWriteOncePod=true")
    out.append((fg.enabled("TPUBatchedScheduling"), fg.enabled("ReadWriteOncePod")))
    for bad in ("DefaultPodTopologySpread=false", "NoSuchFeature=true", "PodOverhead",
                "PodOverhead=maybe"):
        try:
            fg.set_from_string(bad)
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    try:
        fg.enabled("NoSuchFeature")
    except KeyError as e:
        out.append(str(e))
    fg.add({"MyGate": fg_mod.FeatureSpec(False)})
    out.append(fg.enabled("MyGate"))
    try:
        fg.add({"MyGate": fg_mod.FeatureSpec(True)})
    except ValueError as e:
        out.append(str(e))
    fg.set_from_string("")
    out.append(fg_mod.DEFAULT_FEATURE_GATE.enabled("VolumeCapacityPriority"))
    return out


def test_feature_gate_matches_jax():
    jfg, tfg = _gates()
    want, got = _script(jfg), _script(tfg)
    assert got == want
    assert ("VolumeCapacityPriority", (False, "ALPHA", False)) in got[0]
    assert got[1] == (False, True) and got[-1] is False and got[-3] is False


@pytest.fixture
def capacity_priority():
    """VolumeCapacityPriority on in both packages' process-wide gates, for
    the plugins built while it is on; restored after."""
    saved = []
    for fg in _gates():
        gate = fg.DEFAULT_FEATURE_GATE
        saved.append((gate, dict(gate._enabled)))
        gate.set_from_map({"VolumeCapacityPriority": True})
    yield
    for gate, enabled in saved:
        gate._enabled.clear()
        gate._enabled.update(enabled)


def _vb_cluster(api):
    """JAX's case: n1 holds a tight 10 GiB PV, n2 a loose 100 GiB one, and a
    WaitForFirstConsumer claim of 9 GiB."""
    t = api.types
    store = api.store()
    store.create_storage_class(t.StorageClass(meta=t.ObjectMeta(name="wffc", namespace=""),
                                              volume_binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name="pv-tight", namespace=""),
                                       storage_class="wffc", capacity_bytes=10 * 2**30,
                                       node_affinity={"host": ("n1",)}))
    store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name="pv-loose", namespace=""),
                                       storage_class="wffc", capacity_bytes=100 * 2**30,
                                       node_affinity={"host": ("n2",)}))
    store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="claim"),
                                             storage_class="wffc", requested_bytes=9 * 2**30))
    return store


class _Api:
    def __init__(self, pkg):
        if pkg == "jax":
            from kubernetes_tpu.api import types, wrappers
            from kubernetes_tpu.apiserver.store import ClusterStore as store
            from kubernetes_tpu.framework.plugins.volume import VolumeBinding
            from kubernetes_tpu.framework.types import NodeInfo
        else:
            from kubernetes_tpu_torch.api import types, wrappers
            from kubernetes_tpu_torch.apiserver.store import Store as store
            from kubernetes_tpu_torch.framework.plugins.volume import VolumeBinding
            from kubernetes_tpu_torch.framework.types import NodeInfo
        self.pkg, self.types, self.wrappers, self.store = pkg, types, wrappers, store
        self.VolumeBinding, self.NodeInfo = VolumeBinding, NodeInfo


def _plugin_scores(api, gate):
    store = _vb_cluster(api)
    pl = api.VolumeBinding(client=store, volume_capacity_priority=gate)
    pod = api.wrappers.make_pod("p").pvc("claim").obj()
    nodes = [api.NodeInfo(api.wrappers.make_node(n).label("host", n).obj()) for n in ("n1", "n2")]
    if api.pkg == "jax":
        from kubernetes_tpu.framework.interface import CycleState

        state = CycleState()
        _, st = pl.pre_filter(state, pod)
        assert st.is_success()
        assert all(pl.filter(state, pod, ni).is_success() for ni in nodes)
        return [pl.score_node(state, pod, ni)[0] for ni in nodes]
    from kubernetes_tpu_torch.framework.runtime import PreFilterState

    state = PreFilterState()
    assert pl.pre_filter(state, pod)[1] is None
    assert all(pl.filter(state, pod, ni) is None for ni in nodes)
    return [pl.score_node(state, pod, ni) for ni in nodes]


@pytest.mark.parametrize("gate", [True, False, None])
def test_c36_plugin_score(gate, capacity_priority):
    """The plugin alone: with the gate on (given, or read from the
    process-wide gate when None) the tight PV's node scores 90, the loose
    one's 9; off, both 0."""
    want = _plugin_scores(_Api("jax"), gate)
    got = _plugin_scores(_Api("port"), gate)
    assert got == want == ([0, 0] if gate is False else [90, 9])


def test_c36_gate_read_at_construction():
    """``volume_capacity_priority=None`` reads the process-wide gate when
    the plugin is built (the registry builds it so), in both packages."""
    out = []
    for pkg in ("jax", "port"):
        api = _Api(pkg)
        fg = _gates()[pkg == "port"]
        gate = fg.DEFAULT_FEATURE_GATE
        saved = dict(gate._enabled)
        try:
            off = api.VolumeBinding().volume_capacity_priority
            gate.set_from_string("VolumeCapacityPriority=true")
            on = api.VolumeBinding().volume_capacity_priority
        finally:
            gate._enabled.clear()
            gate._enabled.update(saved)
        out.append((off, on))
    assert out == [(False, True), (False, True)]


VB_PROFILE = {"schedulerName": "vcp",
              "plugins": {"score": {"enabled": [{"name": "VolumeBinding", "weight": 1}]}}}
CONFIG = {"apiVersion": "kubescheduler.config.k8s.io/v1beta3",
          "profiles": [{"schedulerName": "default-scheduler"}, VB_PROFILE]}


def _loop_case(pair):
    from kubernetes_tpu_torch.api.types import (BINDING_WAIT_FOR_FIRST_CONSUMER, ObjectMeta,
                                                PersistentVolume, PersistentVolumeClaim,
                                                StorageClass)
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod

    for n in ("n1", "n2"):
        pair.create("create_node", make_node(n).capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 10}).label("host", n).obj())
    pair.create("create_storage_class", StorageClass(
        meta=ObjectMeta(name="wffc", namespace=""),
        volume_binding_mode=BINDING_WAIT_FOR_FIRST_CONSUMER))
    for name, size, node in (("pv-tight", 10, "n1"), ("pv-loose", 100, "n2")):
        pair.create("create_pv", PersistentVolume(
            meta=ObjectMeta(name=name, namespace=""), storage_class="wffc",
            capacity_bytes=size * 2**30, node_affinity={"host": (node,)}))
    pair.create("create_pvc", PersistentVolumeClaim(meta=ObjectMeta(name="claim"),
                                                    storage_class="wffc",
                                                    requested_bytes=9 * 2**30))
    # n1 half full: the plain scores prefer n2
    busy = make_pod("busy").req({"cpu": "2", "memory": "4Gi"}).obj()
    busy.spec.node_name = "n1"
    pair.create("create_pod", busy)
    pod = make_pod("vol").req({"cpu": "100m"}).pvc("claim").obj()
    pod.spec.scheduler_name = "vcp"
    plain = make_pod("plain").req({"cpu": "100m"}).obj()
    pair.create("create_pod", pod, plain)
    pair.settle()
    return pair


def _batchable(pair):
    return [{name: sched._framework_batchable(fwk) for name, fwk in sched.profiles.items()}
            for sched in (pair.jsched, pair.tsched)]


def test_c36_through_both_loops(capacity_priority):
    pair = _loop_case(LoopPair(batch=8, percentage=100, config=CONFIG))
    got = pair.assert_volume_equal()
    assert got["placed"]["default/vol"] == "n1"  # the tight PV's node
    assert got["pvc_bindings"]["default/claim"] == "pv-tight"
    jb, tb = _batchable(pair)
    assert jb == tb == {"default-scheduler": True, "vcp": False}
    assert got["fallback_scheduled"] == pair.jsched.fallback_scheduled == 1


def test_c36_gate_off_keeps_the_plain_scores():
    pair = _loop_case(LoopPair(batch=8, percentage=100, config=CONFIG))
    got = pair.assert_volume_equal()
    assert got["placed"]["default/vol"] == "n2"
    assert got["pvc_bindings"]["default/claim"] == "pv-loose"
