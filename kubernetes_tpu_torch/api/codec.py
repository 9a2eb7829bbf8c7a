"""Generic JSON wire codec for the API dataclasses (own copy of
``kubernetes_tpu/api/codec.py``, whole).

Every API type is a plain typed dataclass, so one reflection codec covers
the whole surface: dataclass fields round-trip by name, tuples, lists,
dicts and Optionals recurse by their type hints (``typing.get_type_hints``
on this package's ``api/types.py``). Field names stay snake_case. The wire
format is a contract between the two packages: for the same objects this
``to_wire`` gives the JAX package's bytes, so either package's client can
talk to either package's device service (``backend/service.py``).
"""

from __future__ import annotations

import dataclasses
import typing
from functools import lru_cache
from typing import Any, Dict, get_args, get_origin, get_type_hints


def to_wire(obj: Any) -> Any:
    """Dataclass → JSON-compatible structure (recursive)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue  # omitempty
            out[f.name] = to_wire(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    raise TypeError(f"not wire-encodable: {type(obj).__name__}")


@lru_cache(maxsize=None)
def _hints(cls) -> Dict[str, Any]:
    return get_type_hints(cls)


def _from_hint(hint: Any, v: Any) -> Any:
    if v is None:
        return None
    origin = get_origin(hint)
    if origin is typing.Union:  # Optional[T] and unions: first matching arm
        args = [a for a in get_args(hint) if a is not type(None)]
        return _from_hint(args[0], v) if args else v
    if origin in (list, typing.List):
        (item,) = get_args(hint) or (Any,)
        return [_from_hint(item, x) for x in v]
    if origin in (tuple, typing.Tuple):
        args = get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_from_hint(args[0], x) for x in v)
        if args:
            return tuple(_from_hint(a, x) for a, x in zip(args, v))
        return tuple(v)
    if origin in (dict, typing.Dict):
        kt, vt = get_args(hint) or (Any, Any)
        return {_from_hint(kt, k): _from_hint(vt, x) for k, x in v.items()}
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        return from_wire(hint, v)
    if hint is Any or hint is object:
        return v
    if isinstance(hint, type) and isinstance(v, hint):
        return v
    if isinstance(hint, type):
        return hint(v)  # int/float/str/bool coercion
    return v


def from_wire(cls, data: Dict[str, Any]):
    """JSON structure → dataclass of type ``cls`` (recursive, hint-driven).
    Unknown fields are ignored (forward compatibility)."""
    hints = _hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _from_hint(hints.get(f.name, Any), data[f.name])
    return cls(**kwargs)
