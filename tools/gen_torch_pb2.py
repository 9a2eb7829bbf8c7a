#!/usr/bin/env python3
"""Vendor the PyTorch port's device-service protobuf module without protoc.

The port keeps its own copy of the wire schema,
``kubernetes_tpu_torch/native/ktpu_device.proto``, and its own generated
module beside it. This tool writes that module with ``tools/gen_pb2.py``'s
``parse_proto`` and ``build_file_descriptor``, so the serialized
``FileDescriptorProto`` is the one the JAX package vendors, byte for byte,
whenever the two ``.proto`` files declare the same schema: both modules then
register the same file in protobuf's default descriptor pool, which accepts
a second registration only when its bytes are identical.

    python tools/gen_torch_pb2.py            # (re)generate the vendored module
    python tools/gen_torch_pb2.py --check    # exit 1 when it is stale
"""

from __future__ import annotations

import hashlib
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.gen_pb2 import _blob_literal, build_file_descriptor, parse_proto  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "kubernetes_tpu_torch", "native")
PROTO = os.path.join(NATIVE, "ktpu_device.proto")
OUT = os.path.join(NATIVE, "ktpu_device_pb2.py")

TEMPLATE = '''\
# Generated by tools/gen_torch_pb2.py from kubernetes_tpu_torch/native/
# ktpu_device.proto; DO NOT EDIT. After editing the .proto, regenerate with
#
#     python tools/gen_torch_pb2.py
#
# backend/grpc_service.pb2() uses this module only while PROTO_SHA256 matches
# the .proto beside it.
"""Vendored protobuf messages of the batched device service's wire format."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

PROTO_SHA256 = "{sha}"

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
{blob}
)

_globals = globals()
_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, _globals)
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "ktpu_device_pb2", _globals)
'''


def descriptor_bytes(proto_path: str = PROTO) -> bytes:
    """The serialized FileDescriptorProto of ``proto_path``."""
    with open(proto_path, "rb") as f:
        package, messages = parse_proto(f.read().decode())
    return build_file_descriptor(package, messages, os.path.basename(proto_path)) \
        .SerializeToString()


def generate() -> str:
    with open(PROTO, "rb") as f:
        raw = f.read()
    return TEMPLATE.format(sha=hashlib.sha256(raw).hexdigest(),
                           blob=_blob_literal(descriptor_bytes()))


def main(argv) -> int:
    content = generate()
    if "--check" in argv:
        try:
            with open(OUT, encoding="utf-8") as f:
                current = f.read()
        except OSError:
            current = None
        if current != content:
            print(f"stale: {OUT} does not match {PROTO}; run python tools/gen_torch_pb2.py")
            return 1
        print("ok: the port's vendored ktpu_device_pb2 matches its .proto")
        return 0
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(content)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
