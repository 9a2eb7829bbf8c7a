"""A KubeSchedulerConfiguration -> a running scheduler (the
cmd/kube-scheduler/app Setup of server.go:300): an own copy of
``kubernetes_tpu/config/factory.py``.

``scheduler_from_config(store, raw=cfg, scheduler_cls=TPUScheduler,
device=...)`` decodes the config, merges ``out_of_tree_registry`` (the
app.WithPlugin hook, server.go:293: name -> factory taking ``(handle,
args)``; a name the in-tree registry holds raises) into the in-tree
registry, and builds one profile per ``profiles`` entry: its expanded
plugin lists, its pluginConfig args and the registry, and the config's
extenders (``scheduler/extender.py:build_extenders``: an entry's
``instance`` as it is, else an ``HTTPExtender`` on its ``urlPrefix``). The
loop runs on the card unless ``device="cpu"`` is given
(``utils/device.py``).
"""

from __future__ import annotations

from typing import Optional

from ..apiserver.store import Store
from ..framework.registry import in_tree_registry
from ..scheduler.extender import build_extenders
from .types import KubeSchedulerConfiguration, expand_profile, load_config


def scheduler_from_config(store: Store, cfg: Optional[KubeSchedulerConfiguration] = None,
                          raw: Optional[dict] = None, registry=None,
                          out_of_tree_registry: Optional[dict] = None, scheduler_cls=None,
                          **scheduler_kwargs):
    """The scheduler ``scheduler_cls`` (default ``TPUScheduler``) built from
    ``cfg`` or its dict form ``raw``; ``scheduler_kwargs`` go to its
    constructor (``device``, ``batch_size``, ...)."""
    if cfg is None:
        cfg = load_config(raw)
    if out_of_tree_registry:
        merged = in_tree_registry()
        for name, factory in out_of_tree_registry.items():
            if name in merged:
                raise ValueError(f"plugin {name!r} already registered")
            merged[name] = factory
        registry = merged
    profiles = {p.scheduler_name: {"plugin_config": expand_profile(p),
                                   "plugin_args": p.plugin_config, "registry": registry}
                for p in cfg.profiles}
    if scheduler_cls is None:
        from ..backend.tpu_scheduler import TPUScheduler as scheduler_cls
    return scheduler_cls(store, profiles=profiles,
                         percentage_of_nodes_to_score=cfg.percentage_of_nodes_to_score,
                         pod_initial_backoff=cfg.pod_initial_backoff_seconds,
                         pod_max_backoff=cfg.pod_max_backoff_seconds,
                         extenders=build_extenders(cfg.extenders), **scheduler_kwargs)
