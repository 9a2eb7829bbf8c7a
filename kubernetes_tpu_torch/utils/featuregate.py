"""Feature gates (component-base/featuregate/feature_gate.go:117,159): an
own copy of ``kubernetes_tpu/utils/featuregate.py``, with the JAX defaults
and locked features.

A mutable known-features registry with per-feature default + lock-in
(GA features cannot be disabled), set from a --feature-gates map string.
Plugins receive a distilled view (plugins/registry.go:47 feature.Features).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    pre_release: str = BETA
    locked_to_default: bool = False  # GA lock (featuregate LockToDefault)


# the scheduling-relevant 1.25-era gates (pkg/features/kube_features.go subset)
DEFAULT_FEATURES: Dict[str, FeatureSpec] = {
    "DefaultPodTopologySpread": FeatureSpec(True, GA, True),
    "MinDomainsInPodTopologySpread": FeatureSpec(False, ALPHA),
    "NodeInclusionPolicyInPodTopologySpread": FeatureSpec(False, ALPHA),
    "PodAffinityNamespaceSelector": FeatureSpec(True, GA, True),
    "PodDisruptionBudget": FeatureSpec(True, GA, True),
    "PodOverhead": FeatureSpec(True, BETA),
    "ReadWriteOncePod": FeatureSpec(False, ALPHA),
    "VolumeCapacityPriority": FeatureSpec(False, ALPHA),
    # this framework's own gates
    "TPUBatchedScheduling": FeatureSpec(True, BETA),
    "TPUPallasKernels": FeatureSpec(True, BETA),
}


class FeatureGate:
    def __init__(self, known: Dict[str, FeatureSpec] = None):
        self._lock = threading.Lock()
        self._known = dict(known if known is not None else DEFAULT_FEATURES)
        self._enabled: Dict[str, bool] = {}

    def add(self, features: Dict[str, FeatureSpec]) -> None:
        """Register additional known features (featuregate Add)."""
        with self._lock:
            for name, spec in features.items():
                existing = self._known.get(name)
                if existing is not None and existing != spec:
                    raise ValueError(f"feature {name} already registered differently")
                self._known[name] = spec

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name in self._enabled:
                return self._enabled[name]
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name}")
            return spec.default

    def set_from_map(self, overrides: Dict[str, bool]) -> None:
        """Apply explicit settings (SetFromMap); locked features reject
        non-default values."""
        with self._lock:
            for name, value in overrides.items():
                spec = self._known.get(name)
                if spec is None:
                    raise ValueError(f"unknown feature gate {name}")
                if spec.locked_to_default and value != spec.default:
                    raise ValueError(
                        f"cannot set feature gate {name} to {value}: locked to {spec.default}"
                    )
                self._enabled[name] = value

    def set_from_string(self, s: str) -> None:
        """--feature-gates 'A=true,B=false' flag form."""
        if not s:
            return
        overrides = {}
        for part in s.split(","):
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"missing = in feature gate {part!r}")
            name, _, val = part.partition("=")
            if val.lower() not in ("true", "false"):
                raise ValueError(f"invalid feature gate value {part!r}")
            overrides[name.strip()] = val.lower() == "true"
        self.set_from_map(overrides)

    def known_features(self) -> Iterable[Tuple[str, FeatureSpec]]:
        with self._lock:
            return sorted(self._known.items())


# process-global gate (the reference's DefaultFeatureGate)
DEFAULT_FEATURE_GATE = FeatureGate()
