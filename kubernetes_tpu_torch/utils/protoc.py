"""Shared protoc-build availability check (an own copy of
``kubernetes_tpu/utils/protoc.py``).

The port's protobuf modules are vendored beside their ``.proto``
(``native/``) and never run protoc; this is the rule for a module that is
compiled on demand into a build directory instead (the kubelet's CRI, not
yet ported), kept in one place so every such ``pb2()`` gate agrees.
"""

from __future__ import annotations

import os


def build_available(cached_module, pb2_path: str, proto_path: str) -> bool:
    """True when an on-demand protoc build will succeed (or already did):
    the module object is already imported, a cached build at ``pb2_path``
    is at least as fresh as ``proto_path``, or protoc is on PATH."""
    import shutil

    if cached_module is not None:
        return True
    if not os.path.exists(proto_path):
        # the pb2() builders compare mtimes against the .proto even when
        # a cached build exists, so a missing source means every path
        # through pb2() raises — having protoc changes nothing
        return False
    try:
        if (os.path.exists(pb2_path)
                and os.path.getmtime(pb2_path) >= os.path.getmtime(proto_path)):
            return True
    except OSError:
        return False
    return shutil.which("protoc") is not None
