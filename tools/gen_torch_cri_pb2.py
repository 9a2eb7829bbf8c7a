#!/usr/bin/env python3
"""Vendor the PyTorch port's kubelet CRI protobuf module.

The port keeps its own copy of the reduced CRI schema,
``kubernetes_tpu_torch/native/ktpu_cri.proto``, and a generated module
beside it, ``ktpu_cri_pb2.py``, so that nothing in the port runs ``protoc``
(the machine with the card may have none). The descriptor bytes it embeds
are made by ``tools/gen_torch_api_pb2.py:descriptor_bytes`` (``protoc
--descriptor_set_out`` with every field's ``json_name`` cleared): they are
those of protoc's own Python module for the same schema, the JAX package's
``native/build/ktpu_cri_pb2.py``, so both packages can register the file in
protobuf's default descriptor pool in one process.

    python tools/gen_torch_cri_pb2.py            # (re)generate the vendored module
    python tools/gen_torch_cri_pb2.py --check    # exit 1 when it is stale

Both need ``protoc`` on ``PATH``; without it ``--check`` compares only the
``.proto``'s hash that the module records.
"""

from __future__ import annotations

import os
import shutil
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kubernetes_tpu_torch.native import proto_sha256, vendored_sha256  # noqa: E402
from tools.gen_pb2 import _blob_literal  # noqa: E402
from tools.gen_torch_api_pb2 import descriptor_bytes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "kubernetes_tpu_torch", "native")
PROTO = os.path.join(NATIVE, "ktpu_cri.proto")
OUT = os.path.join(NATIVE, "ktpu_cri_pb2.py")

TEMPLATE = '''\
# Generated by tools/gen_torch_cri_pb2.py from kubernetes_tpu_torch/native/
# ktpu_cri.proto; DO NOT EDIT. After editing the .proto, regenerate with
#
#     python tools/gen_torch_cri_pb2.py
#
# kubelet/cri.pb2() uses this module only while PROTO_SHA256 matches the
# .proto beside it.
"""Vendored protobuf messages of the kubelet's reduced CRI (ktpu.cri.v1)."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

PROTO_SHA256 = "{sha}"

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
{blob}
)

_globals = globals()
_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, _globals)
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "ktpu_cri_pb2", _globals)
'''


def generate() -> str:
    return TEMPLATE.format(sha=proto_sha256(PROTO),
                           blob=_blob_literal(descriptor_bytes(PROTO)))


def main(argv) -> int:
    if "--check" in argv:
        if shutil.which("protoc") is None:
            if vendored_sha256(OUT) != proto_sha256(PROTO):
                print(f"stale: {OUT} records another .proto hash; run "
                      "python tools/gen_torch_cri_pb2.py")
                return 1
            print("ok: the vendored ktpu_cri_pb2 records the .proto's hash "
                  "(no protoc on PATH: the descriptor bytes were not regenerated)")
            return 0
        try:
            with open(OUT, encoding="utf-8") as f:
                current = f.read()
        except OSError:
            current = None
        if current != generate():
            print(f"stale: {OUT} does not match {PROTO}; run python tools/gen_torch_cri_pb2.py")
            return 1
        print("ok: the port's vendored ktpu_cri_pb2 matches its .proto")
        return 0
    content = generate()
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(content)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
