"""The port's copies of the wire schemes and their vendored message
modules: the device service's (``ktpu_device.proto``,
``ktpu_device_pb2.py``, written by ``tools/gen_torch_pb2.py``) and the API
objects' (``ktpu_api.proto``, ``ktpu_api_pb2.py``, written by
``tools/gen_torch_api_pb2.py``). Nothing here is imported until the gRPC
transport or the protobuf codec asks for it (``backend/grpc_service.pb2``,
``api/protobuf.pb2``)."""

import hashlib
import re


def proto_sha256(proto_path: str) -> str:
    """The sha256 of a ``.proto`` file's bytes."""
    with open(proto_path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def vendored_sha256(module_path: str) -> str:
    """The ``PROTO_SHA256`` a vendored module records, read from its text
    before it is imported (a stale module never reaches protobuf's
    descriptor pool); "" when the module or the literal is missing."""
    try:
        with open(module_path, encoding="utf-8") as f:
            m = re.search(r'^PROTO_SHA256 = "([0-9a-f]{64})"', f.read(4096), re.M)
    except OSError:
        return ""
    return m.group(1) if m else ""
