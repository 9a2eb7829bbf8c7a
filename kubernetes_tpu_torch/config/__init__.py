"""The scheduler's component configuration (KubeSchedulerConfiguration)."""

from .factory import scheduler_from_config
from .types import (API_VERSION, DEFAULT_SCHEDULER_NAME, ConfigError, Extender,
                    KubeSchedulerConfiguration, PluginEntry, PluginSet, Profile, expand_profile,
                    load_config, validate_config)

__all__ = [
    "API_VERSION",
    "ConfigError",
    "DEFAULT_SCHEDULER_NAME",
    "Extender",
    "KubeSchedulerConfiguration",
    "PluginEntry",
    "PluginSet",
    "Profile",
    "expand_profile",
    "load_config",
    "validate_config",
    "scheduler_from_config",
]
