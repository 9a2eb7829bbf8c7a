"""Protobuf serialization of API objects (an own copy of
``kubernetes_tpu/api/protobuf.py``).

The reference negotiates ``application/vnd.kubernetes.protobuf`` beside
JSON on every REST endpoint (runtime/serializer/protobuf/protobuf.go: the
``k8s\\x00`` magic over a runtime.Unknown envelope). The API types here are
reflection-encoded dataclasses, so the binary form is one struct-shaped
schema (``native/ktpu_api.proto``'s ``KValue``) that carries the field tree
the JSON codec produces, in real protobuf wire bytes, under a ``KObject`` /
``KObjectList`` envelope with the magic prefix and the kind.

The messages come from the vendored ``native/ktpu_api_pb2.py``
(``tools/gen_torch_api_pb2.py``), used only while its ``PROTO_SHA256``
matches the ``.proto`` beside it; a stale or missing one raises, and no
``protoc`` is ever run. Its descriptor bytes are the JAX package's, so both
register in one process and each decodes the other's bytes.
"""

from __future__ import annotations

import os
import threading
from typing import Any, List, Tuple

from ..native import proto_sha256, vendored_sha256
from . import types as api_types
from .codec import from_wire, to_wire

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_PROTO = os.path.join(_NATIVE, "ktpu_api.proto")
_VENDORED = os.path.join(_NATIVE, "ktpu_api_pb2.py")

# runtime/serializer/protobuf/protobuf.go:43: the 4-byte envelope prefix
MAGIC = b"k8s\x00"
CONTENT_TYPE = "application/vnd.kubernetes.protobuf"

_pb2 = None
_pb2_lock = threading.Lock()


def _vendored_matches() -> bool:
    """The vendored module records the hash of the ``.proto`` beside it."""
    try:
        return vendored_sha256(_VENDORED) == proto_sha256(_PROTO)
    except OSError:
        return False


def pb2_available() -> bool:
    """True when ``pb2()`` will succeed."""
    return _pb2 is not None or _vendored_matches()


def pb2():
    """The vendored message module; RuntimeError when it is stale or
    missing."""
    global _pb2
    if _pb2 is not None:
        return _pb2
    with _pb2_lock:
        if _pb2 is None:
            if not _vendored_matches():
                raise RuntimeError(
                    "the vendored kubernetes_tpu_torch/native/ktpu_api_pb2.py is stale or "
                    "missing; run `python tools/gen_torch_api_pb2.py`")
            from ..native import ktpu_api_pb2

            _pb2 = ktpu_api_pb2
        return _pb2


# ----------------------------------------------------- wire tree <-> KValue


def _to_kvalue(v: Any):
    p = pb2()
    kv = p.KValue()
    if isinstance(v, bool):          # bool before int: bool is an int subtype
        kv.b = v
    elif isinstance(v, int):
        kv.i = v
    elif isinstance(v, float):
        kv.d = v
    elif isinstance(v, str):
        kv.s = v
    elif isinstance(v, (list, tuple)):
        kv.list.SetInParent()  # an empty list still sets the oneof arm
        kv.list.items.extend(_to_kvalue(x) for x in v)
    elif isinstance(v, dict):
        kv.map.SetInParent()  # likewise the empty map
        for k, x in v.items():
            kv.map.fields[str(k)].CopyFrom(_to_kvalue(x))
    elif v is None:
        kv.raw = b""
    else:
        raise TypeError(f"not protobuf-encodable: {type(v).__name__}")
    return kv


def _from_kvalue(kv) -> Any:
    which = kv.WhichOneof("kind")
    if which == "s":
        return kv.s
    if which == "i":
        return int(kv.i)
    if which == "d":
        return kv.d
    if which == "b":
        return kv.b
    if which == "list":
        return [_from_kvalue(x) for x in kv.list.items]
    if which == "map":
        return {k: _from_kvalue(x) for k, x in kv.map.fields.items()}
    return None  # raw / None


# ------------------------------------------------------------ object codecs


def _type_of(kind: str):
    cls = getattr(api_types, kind, None)
    if cls is None:
        raise TypeError(f"unknown kind {kind!r}")
    return cls


def encode_object(kind: str, obj, api_version: str = "v1") -> bytes:
    """A typed object as magic-prefixed protobuf bytes."""
    p = pb2()
    ko = p.KObject(kind=kind, api_version=api_version)
    ko.value.CopyFrom(_to_kvalue(to_wire(obj)))
    return MAGIC + ko.SerializeToString()


def decode_object(data: bytes, expected_kind: str = ""):
    """Magic-prefixed protobuf bytes as ``(kind, typed object)``; the kind
    from the envelope."""
    if not data.startswith(MAGIC):
        raise ValueError("missing protobuf magic prefix")
    ko = pb2().KObject.FromString(data[len(MAGIC):])
    kind = ko.kind or expected_kind
    return kind, from_wire(_type_of(kind), _from_kvalue(ko.value))


def encode_list(kind: str, objs: List[Any], resource_version: int = 0) -> bytes:
    p = pb2()
    kl = p.KObjectList(kind=kind, resource_version=resource_version)
    for obj in objs:
        ko = kl.items.add()
        ko.kind = kind
        ko.value.CopyFrom(_to_kvalue(to_wire(obj)))
    return MAGIC + kl.SerializeToString()


def decode_list(data: bytes) -> Tuple[str, List[Any], int]:
    if not data.startswith(MAGIC):
        raise ValueError("missing protobuf magic prefix")
    kl = pb2().KObjectList.FromString(data[len(MAGIC):])
    cls = _type_of(kl.kind)
    return kl.kind, [from_wire(cls, _from_kvalue(ko.value)) for ko in kl.items], \
        int(kl.resource_version)
