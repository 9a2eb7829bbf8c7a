"""The scheduler's component configuration (KubeSchedulerConfiguration).

An own copy of ``kubernetes_tpu/config/types.py``: the dataclasses of
pkg/scheduler/apis/config/types.go (:41 KubeSchedulerConfiguration, :102
KubeSchedulerProfile, :129 Plugins/PluginSet) with v1beta3 defaulting
(apis/config/v1beta3/defaults.go:104-160); ``load_config`` decodes a config
dict (the YAML object form; v1beta2 and v1beta3), applies the defaults and
validates it (``validate_config``, every ``ConfigError`` of the JAX
package); ``expand_profile`` merges a profile's per-point enable / disable
and its MultiPoint shorthand into the default plugin set
(runtime/framework.go:430). Plugin arguments keep the JAX registry's
snake_case keys (``strategy``, ``hard_pod_affinity_weight``), not
upstream's camelCase ones. Extenders are decoded and validated here and
built by ``config/factory.py``; an in-process one is set on an entry's
``instance`` after decoding, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..framework.interface import EXTENSION_POINTS
from ..framework.registry import DEFAULT_PLUGINS

API_VERSION = "kubescheduler.config.k8s.io/v1beta3"
API_VERSION_V1BETA2 = "kubescheduler.config.k8s.io/v1beta2"
SUPPORTED_VERSIONS = (API_VERSION, API_VERSION_V1BETA2)

# name used when a profile doesn't set one (v1beta3/defaults.go)
DEFAULT_SCHEDULER_NAME = "default-scheduler"

# camelCase extension-point names as they appear in config files → internal
_POINT_NAMES = {
    "queueSort": "queue_sort",
    "preEnqueue": "pre_enqueue",
    "preFilter": "pre_filter",
    "filter": "filter",
    "postFilter": "post_filter",
    "preScore": "pre_score",
    "score": "score",
    "reserve": "reserve",
    "permit": "permit",
    "preBind": "pre_bind",
    "bind": "bind",
    "postBind": "post_bind",
}
_MULTI_POINT = "multiPoint"

# which points carry weights (only score does)
_WEIGHTED_POINTS = {"score"}

# default weights used when MultiPoint enables a scoring plugin without an
# explicit weight (default_plugins.go:32-51)
_DEFAULT_SCORE_WEIGHTS = {name: w for name, w in DEFAULT_PLUGINS["score"]}


@dataclass
class PluginEntry:
    name: str
    weight: int = 0


@dataclass
class PluginSet:
    enabled: List[PluginEntry] = field(default_factory=list)
    disabled: List[PluginEntry] = field(default_factory=list)


@dataclass
class Profile:
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    # point (internal name) -> PluginSet; "multiPoint" handled at expansion
    plugins: Dict[str, PluginSet] = field(default_factory=dict)
    multi_point: PluginSet = field(default_factory=PluginSet)
    plugin_config: Dict[str, dict] = field(default_factory=dict)  # plugin name -> args


@dataclass
class Extender:
    """HTTP extender config (apis/config/types.go:246 Extender)."""

    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    enable_https: bool = False
    node_cache_capable: bool = False
    ignorable: bool = False
    managed_resources: Tuple[str, ...] = ()
    # an in-process extender object in place of the URL
    instance: Optional[object] = None


@dataclass
class KubeSchedulerConfiguration:
    parallelism: int = 16
    percentage_of_nodes_to_score: int = 0  # 0 = adaptive
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    profiles: List[Profile] = field(default_factory=lambda: [Profile()])
    extenders: List[Extender] = field(default_factory=list)
    api_version: str = API_VERSION
    # leaderElection (component-base/config LeaderElectionConfiguration)
    leader_elect: bool = True
    leader_elect_lease_duration: float = 15.0
    leader_elect_renew_deadline: float = 10.0
    leader_elect_retry_period: float = 2.0
    # clientConnection envelope (qps/burst; scheduler_perf uses 5000/5000)
    client_qps: float = 50.0
    client_burst: int = 100


class ConfigError(ValueError):
    pass


def _parse_duration(v) -> float:
    """metav1.Duration string ('15s', '2m30s', '100ms') or number → seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    total, num = 0.0, ""
    i = 0
    while i < len(s):
        c = s[i]
        if c.isdigit() or c == ".":
            num += c
            i += 1
            continue
        for u in ("ms", "h", "m", "s"):
            if s.startswith(u, i):
                if not num:
                    raise ConfigError(f"invalid duration {v!r}")
                total += float(num) * units[u]
                num = ""
                i += len(u)
                break
        else:
            raise ConfigError(f"invalid duration {v!r}")
    if num:  # bare number tail
        total += float(num)
    return total


# ---------------------------------------------------------------------------
# decode


def _decode_plugin_set(raw: dict) -> PluginSet:
    ps = PluginSet()
    for e in raw.get("enabled", []) or []:
        if isinstance(e, str):
            ps.enabled.append(PluginEntry(e))
        else:
            ps.enabled.append(PluginEntry(e["name"], int(e.get("weight", 0))))
    for e in raw.get("disabled", []) or []:
        name = e if isinstance(e, str) else e["name"]
        ps.disabled.append(PluginEntry(name))
    return ps


def load_config(raw: Optional[dict]) -> KubeSchedulerConfiguration:
    """Decode a config dict (the YAML object form), apply defaults, validate."""
    cfg = KubeSchedulerConfiguration()
    raw = raw or {}
    if "apiVersion" in raw and raw["apiVersion"] not in SUPPORTED_VERSIONS:
        raise ConfigError(f"unsupported apiVersion {raw['apiVersion']!r}")
    # v1beta2 → internal conversion: same field surface for what this
    # framework models; v1beta2 predates multiPoint, which simply won't
    # appear in such configs (apis/config/v1beta2/conversion.go)
    cfg.api_version = raw.get("apiVersion", API_VERSION)

    le = raw.get("leaderElection") or {}
    cfg.leader_elect = bool(le.get("leaderElect", cfg.leader_elect))
    cfg.leader_elect_lease_duration = float(
        _parse_duration(le.get("leaseDuration", cfg.leader_elect_lease_duration)))
    cfg.leader_elect_renew_deadline = float(
        _parse_duration(le.get("renewDeadline", cfg.leader_elect_renew_deadline)))
    cfg.leader_elect_retry_period = float(
        _parse_duration(le.get("retryPeriod", cfg.leader_elect_retry_period)))

    cc = raw.get("clientConnection") or {}
    cfg.client_qps = float(cc.get("qps", cfg.client_qps))
    cfg.client_burst = int(cc.get("burst", cfg.client_burst))
    cfg.parallelism = int(raw.get("parallelism", cfg.parallelism))
    cfg.percentage_of_nodes_to_score = int(
        raw.get("percentageOfNodesToScore", cfg.percentage_of_nodes_to_score)
    )
    cfg.pod_initial_backoff_seconds = float(
        raw.get("podInitialBackoffSeconds", cfg.pod_initial_backoff_seconds)
    )
    cfg.pod_max_backoff_seconds = float(
        raw.get("podMaxBackoffSeconds", cfg.pod_max_backoff_seconds)
    )

    if "profiles" in raw and raw["profiles"]:
        cfg.profiles = []
        for rp in raw["profiles"]:
            p = Profile(scheduler_name=rp.get("schedulerName", DEFAULT_SCHEDULER_NAME))
            for raw_point, internal in _POINT_NAMES.items():
                if raw_point in (rp.get("plugins") or {}):
                    p.plugins[internal] = _decode_plugin_set(rp["plugins"][raw_point])
            if _MULTI_POINT in (rp.get("plugins") or {}):
                p.multi_point = _decode_plugin_set(rp["plugins"][_MULTI_POINT])
            for pc in rp.get("pluginConfig", []) or []:
                p.plugin_config[pc["name"]] = pc.get("args", {}) or {}
            cfg.profiles.append(p)

    if "extenders" in raw:
        for re_ in raw["extenders"]:
            cfg.extenders.append(
                Extender(
                    url_prefix=re_.get("urlPrefix", ""),
                    filter_verb=re_.get("filterVerb", ""),
                    prioritize_verb=re_.get("prioritizeVerb", ""),
                    bind_verb=re_.get("bindVerb", ""),
                    preempt_verb=re_.get("preemptVerb", ""),
                    weight=int(re_.get("weight", 1)),
                    enable_https=bool(re_.get("enableHTTPS", False)),
                    node_cache_capable=bool(re_.get("nodeCacheCapable", False)),
                    ignorable=bool(re_.get("ignorable", False)),
                    managed_resources=tuple(
                        m["name"] if isinstance(m, dict) else m
                        for m in re_.get("managedResources", [])
                    ),
                )
            )

    validate_config(cfg)
    return cfg


# ---------------------------------------------------------------------------
# validation (apis/config/validation/validation.go)


def validate_config(cfg: KubeSchedulerConfiguration) -> None:
    if cfg.parallelism <= 0:
        raise ConfigError("parallelism must be greater than 0")
    if not (0 <= cfg.percentage_of_nodes_to_score <= 100):
        raise ConfigError("percentageOfNodesToScore must be in [0, 100]")
    if cfg.pod_initial_backoff_seconds <= 0:
        raise ConfigError("podInitialBackoffSeconds must be greater than 0")
    if cfg.pod_max_backoff_seconds < cfg.pod_initial_backoff_seconds:
        raise ConfigError("podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
    if not cfg.profiles:
        raise ConfigError("at least one profile is required")
    names = [p.scheduler_name for p in cfg.profiles]
    if len(set(names)) != len(names):
        raise ConfigError("duplicated scheduler name in profiles")
    for p in cfg.profiles:
        if not p.scheduler_name:
            raise ConfigError("schedulerName is needed")
        for point, ps in p.plugins.items():
            if point not in EXTENSION_POINTS:
                raise ConfigError(f"unknown extension point {point!r}")
            seen = set()
            for e in ps.enabled:
                if e.name in seen:
                    raise ConfigError(f"duplicated enabled plugin {e.name!r} at {point}")
                seen.add(e.name)
    for ext in cfg.extenders:
        if ext.instance is None and not ext.url_prefix:
            raise ConfigError("extender urlPrefix is required")
        if ext.weight <= 0:
            raise ConfigError("extender weight must be positive")


# ---------------------------------------------------------------------------
# expansion: defaults + profile overrides -> framework plugin_config


def expand_profile(profile: Profile) -> Dict[str, List[Tuple[str, int]]]:
    """Merge the default plugin set with the profile's per-point
    enable/disable and MultiPoint shorthand (runtime/framework.go:430).

    Order semantics (the reference's expandMultiPointPlugins + mergePlugins):
    defaults first (minus disabled), then profile-enabled appended in config
    order; '*' in disabled clears the whole default set for that point.
    """
    out: Dict[str, List[Tuple[str, int]]] = {}

    # MultiPoint: a plugin listed there joins every point it implements — at
    # config level we can't introspect implementations, so MultiPoint entries
    # are offered to every point and the Framework keeps only those whose
    # instance actually implements the point's method (registry factories
    # produce one instance per name, so this is safe and cheap).
    mp_enabled = [(e.name, e.weight) for e in profile.multi_point.enabled]
    mp_disabled = {e.name for e in profile.multi_point.disabled}

    for point in EXTENSION_POINTS:
        defaults = list(DEFAULT_PLUGINS.get(point, []))
        ps = profile.plugins.get(point)
        disabled = {e.name for e in ps.disabled} if ps else set()
        if "*" in disabled or "*" in mp_disabled:
            merged: List[Tuple[str, int]] = []
        else:
            merged = [
                (n, w) for (n, w) in defaults if n not in disabled and n not in mp_disabled
            ]
        if ps:
            have = {n for n, _ in merged}
            for e in ps.enabled:
                w = e.weight
                if point in _WEIGHTED_POINTS and w == 0:
                    w = _DEFAULT_SCORE_WEIGHTS.get(e.name, 1)
                if e.name in have:
                    # re-enabling overrides weight and moves to the back
                    merged = [(n, ww) for (n, ww) in merged if n != e.name]
                merged.append((e.name, w))
        for name, w in mp_enabled:
            if name not in {n for n, _ in merged}:
                ww = w
                if point in _WEIGHTED_POINTS and ww == 0:
                    ww = _DEFAULT_SCORE_WEIGHTS.get(name, 1)
                merged.append((name, ww))
        out[point] = merged
    return out
