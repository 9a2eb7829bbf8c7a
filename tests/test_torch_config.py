"""The port's KubeSchedulerConfiguration decoding against the JAX package's.

``kubernetes_tpu_torch.config.load_config``, ``validate_config`` and
``expand_profile`` over a table of configs, each decoded by both packages:
the defaults, v1beta2, the leader election and client connection blocks
with durations, per-point disable (``*`` too) and a plugin re-enabled with
a weight (it moves to the back), ``multiPoint`` with ``enabled`` and
``disabled``, ``pluginConfig``, several profiles, extenders; every field of
the dataclasses and each expanded list must be equal. Every
``ConfigError`` the JAX package raises is raised by the port for the same
config, with the same message.
"""

from __future__ import annotations

import dataclasses

import pytest

V1BETA3 = "kubescheduler.config.k8s.io/v1beta3"
V1BETA2 = "kubescheduler.config.k8s.io/v1beta2"

CONFIGS = {
    "defaults": None,
    "empty": {},
    "v1beta2": {"apiVersion": V1BETA2, "kind": "KubeSchedulerConfiguration",
                "percentageOfNodesToScore": 40},
    "envelope": {
        "apiVersion": V1BETA3, "parallelism": 32, "podInitialBackoffSeconds": 2,
        "podMaxBackoffSeconds": 20,
        "leaderElection": {"leaderElect": False, "leaseDuration": "2m30s",
                           "renewDeadline": "15s", "retryPeriod": "100ms"},
        "clientConnection": {"qps": 5000, "burst": 5000},
    },
    "disable_and_reenable": {"profiles": [{
        "schedulerName": "custom",
        "plugins": {
            "score": {"disabled": [{"name": "ImageLocality"}],
                      "enabled": [{"name": "TaintToleration", "weight": 7},
                                  {"name": "SelectorSpread"}]},
            "filter": {"disabled": [{"name": "*"}],
                       "enabled": ["NodeResourcesFit", {"name": "EBSLimits"}]},
            "preScore": {"enabled": [{"name": "SelectorSpread"}]},
        },
    }]},
    "multi_point": {"profiles": [{
        "schedulerName": "mp",
        "plugins": {
            "multiPoint": {"enabled": [{"name": "SelectorSpread", "weight": 4},
                                       {"name": "PrioritySort"}, {"name": "VolumeBinding"}],
                           "disabled": [{"name": "ImageLocality"}, {"name": "Coscheduling"}]},
            "queueSort": {"disabled": [{"name": "*"}]},
        },
    }]},
    "multi_point_all_disabled": {"profiles": [{
        "schedulerName": "mp-star",
        "plugins": {"multiPoint": {"enabled": ["NodeResourcesFit", "NodeName"],
                                   "disabled": [{"name": "*"}]}},
    }]},
    "plugin_config": {"profiles": [
        {"schedulerName": "default-scheduler"},
        {"schedulerName": "most-allocated",
         "pluginConfig": [
             {"name": "NodeResourcesFit",
              "args": {"strategy": "MostAllocated", "resources": [["cpu", 2], ["memory", 1]]}},
             {"name": "InterPodAffinity", "args": {"hard_pod_affinity_weight": 5}},
             {"name": "DefaultPreemption"}]},
        {"schedulerName": "no-scoring", "plugins": {"score": {"disabled": [{"name": "*"}]}}},
    ]},
    "extenders": {"extenders": [{"urlPrefix": "http://127.0.0.1:8888", "filterVerb": "filter",
                                 "weight": 3, "managedResources": [{"name": "x/gpu"}, "y"],
                                 "ignorable": True}]},
}

ERRORS = {
    "unsupported_version": {"apiVersion": "kubescheduler.config.k8s.io/v1beta1"},
    "parallelism": {"parallelism": 0},
    "percentage": {"percentageOfNodesToScore": 101},
    "initial_backoff": {"podInitialBackoffSeconds": 0},
    "max_backoff": {"podMaxBackoffSeconds": 0.5},
    "duplicate_profile": {"profiles": [{"schedulerName": "a"}, {"schedulerName": "a"}]},
    "empty_scheduler_name": {"profiles": [{"schedulerName": ""}]},
    "duplicate_enabled": {"profiles": [{"plugins": {"score": {"enabled": [
        {"name": "NodeResourcesFit"}, {"name": "NodeResourcesFit"}]}}}]},
    "extender_url": {"extenders": [{"filterVerb": "filter"}]},
    "extender_weight": {"extenders": [{"urlPrefix": "http://127.0.0.1:1", "weight": 0}]},
    "duration": {"leaderElection": {"leaseDuration": "5x"}},
    "duration_unit_only": {"leaderElection": {"retryPeriod": "s"}},
}


def _as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_and_expand_equal_jax(name):
    from kubernetes_tpu.config import expand_profile as jexpand
    from kubernetes_tpu.config import load_config as jload
    from kubernetes_tpu_torch.config import expand_profile, load_config

    raw = CONFIGS[name]
    jcfg, tcfg = jload(raw), load_config(raw)
    assert _as_dict(tcfg) == _as_dict(jcfg)
    assert [expand_profile(p) for p in tcfg.profiles] == [jexpand(p) for p in jcfg.profiles]


def test_reenabled_plugin_moves_to_the_back():
    from kubernetes_tpu_torch.config import expand_profile, load_config

    score = expand_profile(load_config(CONFIGS["disable_and_reenable"]).profiles[0])["score"]
    assert "ImageLocality" not in dict(score)
    assert score[-2:] == [("TaintToleration", 7), ("SelectorSpread", 1)]


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_config_errors_equal_jax(name):
    from kubernetes_tpu.config import ConfigError as JConfigError
    from kubernetes_tpu.config import load_config as jload
    from kubernetes_tpu_torch.config import ConfigError, load_config

    with pytest.raises(JConfigError) as jerr:
        jload(ERRORS[name])
    with pytest.raises(ConfigError) as terr:
        load_config(ERRORS[name])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["no_profiles", "unknown_point"])
def test_validate_config_errors_equal_jax(case):
    """The two checks no decoded dict reaches: a config without profiles,
    and a profile naming an unknown extension point."""
    from kubernetes_tpu.config import ConfigError as JConfigError
    from kubernetes_tpu.config import types as jtypes
    from kubernetes_tpu_torch.config import ConfigError
    from kubernetes_tpu_torch.config import types as ttypes

    def build(types):
        cfg = types.KubeSchedulerConfiguration()
        if case == "no_profiles":
            cfg.profiles = []
        else:
            cfg.profiles[0].plugins["bogus"] = types.PluginSet()
        return cfg

    with pytest.raises(JConfigError) as jerr:
        jtypes.validate_config(build(jtypes))
    with pytest.raises(ConfigError) as terr:
        ttypes.validate_config(build(ttypes))
    assert str(terr.value) == str(jerr.value)
