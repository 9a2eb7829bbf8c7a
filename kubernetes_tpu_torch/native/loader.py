"""Build-on-demand ctypes loader for the native helpers: an own copy of
``kubernetes_tpu/native/loader.py``.

The shared object is compiled from ``ktpu_quantity.cpp`` beside this file
with plain ``g++ -O2 -shared -fPIC`` into the package's ``_build/``, under a
name keyed by the hash of the source and the flags, as the port builds its
kernel (``ops/fused_step.py:build_library``). A lock between processes
(``fcntl.flock`` on a file in ``_build/``) lets one builder compile while
the others wait and then load its library, so test workers started at once
do not race. This is host parsing with exact answers, not the device: a
missing compiler falls back to the Fraction path of ``api/resource.py``,
never to an error.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
_SRC = Path(__file__).resolve().parent / "ktpu_quantity.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for this source and flag set lives."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libktpu-{tag}.so"


def _build(out: Path) -> bool:
    """Compile into ``out`` under the build lock; True when it exists after.
    A builder that finds the library already there (another process built
    it while this one waited) compiles nothing."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "libktpu.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return True
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, out)  # atomic: a loader sees all or nothing
                return True
            except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
                logger.info("native build unavailable (%s); using Python fallback", e)
                return False
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:  # lock-free fast path: set-once fields
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
            lib.kt_canonical.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_longlong)]
            lib.kt_canonical.restype = ctypes.c_int
            lib.kt_version.restype = ctypes.c_longlong
            if lib.kt_version() != _ABI_VERSION:
                logger.warning("native ABI mismatch; using Python fallback")
                return None
            _lib = lib
        except OSError as e:
            logger.info("native load failed (%s); using Python fallback", e)
            return None
        return _lib


def native_available() -> bool:
    return _load() is not None


# canonical classes — must match ktpu_quantity.cpp
CLS_COUNT = 0
CLS_MILLI = 1
CLS_KIB = 2
CLS_MIB = 3


def canonical_native(value: str, cls: int) -> Optional[int]:
    """Parse a quantity string to its canonical int via the native parser;
    None when the native library is unavailable or the string is rejected
    (the caller falls back to the exact Python path)."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.c_longlong(0)
    rc = lib.kt_canonical(value.encode(), cls, ctypes.byref(out))
    if rc != 0:
        return None
    return out.value
