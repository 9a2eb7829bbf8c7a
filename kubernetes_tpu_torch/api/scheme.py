"""runtime.Scheme analog: the versioned-conversion + defaulting + codec
registry (apimachinery pkg/runtime/scheme.go:46, serializer/); an own copy
of ``kubernetes_tpu/api/scheme.py``, whole.

The reference keeps one INTERNAL (hub) type per kind and converts each
EXTERNAL (versioned, wire-shaped) representation to/from it through
registered conversion functions, applying registered defaulters on decode.
Here the internal types are this framework's dataclasses (api/types.py) and
external versions are JSON-shaped dicts (e.g. core/v1 camelCase manifests —
api/corev1.py registers those). The codec path:

    decode: bytes/dict --(convert_from)--> internal obj --(defaulters)--> obj
    encode: internal obj --(convert_to)--> dict with apiVersion/kind --> bytes

Unknown apiVersion/kind raise SchemeError (the NotRegisteredErr analog).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Tuple


class SchemeError(Exception):
    """Unregistered group/version/kind or failed conversion."""


@dataclasses.dataclass(frozen=True)
class GroupVersionKind:
    group: str
    version: str
    kind: str

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version

    @staticmethod
    def from_api_version(api_version: str, kind: str) -> "GroupVersionKind":
        if "/" in api_version:
            g, v = api_version.split("/", 1)
        else:
            g, v = "", api_version
        return GroupVersionKind(g, v, kind)


class Scheme:
    def __init__(self):
        # gvk -> (internal type, from_external, to_external)
        self._kinds: Dict[GroupVersionKind, Tuple[type, Callable, Callable]] = {}
        self._defaulters: Dict[type, List[Callable]] = {}
        # internal type -> preferred gvk for encoding
        self._preferred: Dict[type, GroupVersionKind] = {}

    # ------------------------------------------------------------ registry

    def add_known_type(self, gvk: GroupVersionKind, internal_type: type,
                       from_external: Callable[[dict], object],
                       to_external: Callable[[object], dict],
                       preferred: bool = True) -> None:
        """Register one external version of a kind with its conversions
        (AddKnownTypes + AddConversionFunc collapsed: external versions here
        are wire dicts, not Go structs)."""
        self._kinds[gvk] = (internal_type, from_external, to_external)
        if preferred or internal_type not in self._preferred:
            self._preferred[internal_type] = gvk

    def add_defaulter(self, internal_type: type, fn: Callable[[object], None]) -> None:
        """Registered defaulters run on every decode (AddTypeDefaultingFunc)."""
        self._defaulters.setdefault(internal_type, []).append(fn)

    def recognizes(self, gvk: GroupVersionKind) -> bool:
        return gvk in self._kinds

    def registered_kinds(self) -> List[GroupVersionKind]:
        return list(self._kinds)

    # --------------------------------------------------------------- codec

    def default(self, obj: object) -> object:
        for t in type(obj).__mro__:
            for fn in self._defaulters.get(t, ()):
                fn(obj)
        return obj

    def decode(self, data) -> object:
        """Wire (bytes/str/dict with apiVersion+kind) → defaulted internal
        object (the UniversalDecoder path: external → internal → default)."""
        if isinstance(data, (bytes, str)):
            data = json.loads(data)
        if not isinstance(data, dict):
            raise SchemeError(f"cannot decode {type(data).__name__}")
        api_version = data.get("apiVersion", "")
        kind = data.get("kind", "")
        if not kind:
            raise SchemeError("missing kind")
        gvk = GroupVersionKind.from_api_version(api_version, kind)
        reg = self._kinds.get(gvk)
        if reg is None:
            raise SchemeError(f"no kind registered for {gvk}")
        _t, from_external, _to = reg
        obj = from_external(data)
        return self.default(obj)

    def encode(self, obj: object,
               gvk: Optional[GroupVersionKind] = None) -> dict:
        """Internal object → wire dict with apiVersion/kind (versioned
        encode; the preferred external version unless one is named)."""
        if gvk is None:
            gvk = self._preferred.get(type(obj))
            if gvk is None:
                raise SchemeError(f"no version registered for {type(obj).__name__}")
        reg = self._kinds.get(gvk)
        if reg is None:
            raise SchemeError(f"no kind registered for {gvk}")
        internal_type, _from, to_external = reg
        if not isinstance(obj, internal_type):
            raise SchemeError(
                f"{gvk} encodes {internal_type.__name__}, got {type(obj).__name__}")
        out = {"apiVersion": gvk.api_version, "kind": gvk.kind}
        out.update(to_external(obj))
        return out

    def encode_json(self, obj: object,
                    gvk: Optional[GroupVersionKind] = None) -> bytes:
        return json.dumps(self.encode(obj, gvk)).encode()


_scheme: Optional[Scheme] = None


def default_scheme() -> Scheme:
    """The process-global scheme with every in-tree version registered
    (the legacyscheme.Scheme analog)."""
    global _scheme
    if _scheme is None:
        _scheme = Scheme()
        from . import corev1

        corev1.register(_scheme)
    return _scheme
