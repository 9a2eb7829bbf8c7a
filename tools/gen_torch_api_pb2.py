#!/usr/bin/env python3
"""Vendor the PyTorch port's API-object protobuf module.

The port keeps its own copy of the API objects' wire schema,
``kubernetes_tpu_torch/native/ktpu_api.proto`` (a ``oneof`` and a ``map``,
which ``tools/gen_pb2.py``'s parser does not take), and a generated module
beside it, so that nothing in the port runs ``protoc``. This tool asks
``protoc --descriptor_set_out`` for the schema's ``FileDescriptorProto``
and clears the ``json_name`` of every field, which the descriptor set adds
and ``protoc --python_out`` leaves out: the bytes it embeds are then those
of protoc's own Python module for the same schema, the JAX package's
``native/build/ktpu_api_pb2.py``. Both modules register the same file in
protobuf's default descriptor pool, which accepts a second registration only
when its bytes are identical.

    python tools/gen_torch_api_pb2.py            # (re)generate the vendored module
    python tools/gen_torch_api_pb2.py --check    # exit 1 when it is stale

Both need ``protoc`` on ``PATH``; without it ``--check`` compares only the
``.proto``'s hash that the module records.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kubernetes_tpu_torch.native import proto_sha256, vendored_sha256  # noqa: E402
from tools.gen_pb2 import _blob_literal  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "kubernetes_tpu_torch", "native")
PROTO = os.path.join(NATIVE, "ktpu_api.proto")
OUT = os.path.join(NATIVE, "ktpu_api_pb2.py")

TEMPLATE = '''\
# Generated by tools/gen_torch_api_pb2.py from kubernetes_tpu_torch/native/
# ktpu_api.proto; DO NOT EDIT. After editing the .proto, regenerate with
#
#     python tools/gen_torch_api_pb2.py
#
# api/protobuf.pb2() uses this module only while PROTO_SHA256 matches the
# .proto beside it.
"""Vendored protobuf messages of the API objects' wire form (KValue)."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

PROTO_SHA256 = "{sha}"

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
{blob}
)

_globals = globals()
_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, _globals)
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "ktpu_api_pb2", _globals)
'''


def descriptor_bytes(proto_path: str = PROTO) -> bytes:
    """The serialized ``FileDescriptorProto`` of ``proto_path`` as protoc's
    Python generator embeds it (no source info, no ``json_name``)."""
    from google.protobuf import descriptor_pb2

    with tempfile.TemporaryDirectory(prefix="gen_torch_api_pb2-") as tmp:
        out = os.path.join(tmp, "set.pb")
        subprocess.run(["protoc", f"--descriptor_set_out={out}",
                        "-I", os.path.dirname(proto_path), proto_path],
                       check=True, capture_output=True, timeout=60)
        with open(out, "rb") as f:
            fds = descriptor_pb2.FileDescriptorSet.FromString(f.read())
    (fdp,) = fds.file

    def strip(messages):
        for msg in messages:
            for fld in msg.field:
                fld.ClearField("json_name")
            strip(msg.nested_type)

    strip(fdp.message_type)
    return fdp.SerializeToString()


def generate() -> str:
    return TEMPLATE.format(sha=proto_sha256(PROTO), blob=_blob_literal(descriptor_bytes()))


def main(argv) -> int:
    if "--check" in argv:
        if shutil.which("protoc") is None:
            if vendored_sha256(OUT) != proto_sha256(PROTO):
                print(f"stale: {OUT} records another .proto hash; run "
                      "python tools/gen_torch_api_pb2.py")
                return 1
            print("ok: the vendored ktpu_api_pb2 records the .proto's hash "
                  "(no protoc on PATH: the descriptor bytes were not regenerated)")
            return 0
        try:
            with open(OUT, encoding="utf-8") as f:
                current = f.read()
        except OSError:
            current = None
        if current != generate():
            print(f"stale: {OUT} does not match {PROTO}; run python tools/gen_torch_api_pb2.py")
            return 1
        print("ok: the port's vendored ktpu_api_pb2 matches its .proto")
        return 0
    content = generate()
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(content)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
