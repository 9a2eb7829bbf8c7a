"""The port's native quantity parser (``kubernetes_tpu_torch/native/
loader.py`` over its own ``ktpu_quantity.cpp``) against the JAX package's
and the exact Fraction path, on the CPU; and its build: ``g++`` into the
hash-keyed ``_build/``, two processes building at once under the lock
between processes.

The port's ``api/resource.canonical`` stays on the exact Fraction path
(its results are memoized per quantity string, so a second parser could
gain nothing there); the JAX package's calls its native parser first. Both
give the same integers, and with no compiler the loader refuses every
string (host parsing with exact answers, not the device)."""

import math
import os
import subprocess
import sys
import textwrap

import pytest

from kubernetes_tpu.api import resource as jres
from kubernetes_tpu.native import canonical_native as jnative
from kubernetes_tpu_torch.api import resource as tres
from kubernetes_tpu_torch.native import canonical_native, loader, native_available
from kubernetes_tpu_torch.native.loader import CLS_COUNT, CLS_KIB, CLS_MIB, CLS_MILLI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX test's corpus (tests/test_native.py), every suffix class and edge
CORPUS = [
    ("0", "cpu"), ("1", "cpu"), ("2", "cpu"), ("100m", "cpu"), ("1500m", "cpu"),
    ("0.1", "cpu"), ("0.5", "cpu"), ("2.5", "cpu"), ("0.001", "cpu"),
    ("1n", "cpu"), ("999999999n", "cpu"), ("250u", "cpu"), ("3.14159", "cpu"),
    ("1k", "cpu"), ("+2", "cpu"),
    ("0", "memory"), ("128", "memory"), ("1Ki", "memory"), ("1500", "memory"),
    ("1Mi", "memory"), ("32Gi", "memory"), ("1Ti", "memory"), ("2Pi", "memory"),
    ("1.5Gi", "memory"), ("100M", "memory"), ("1G", "memory"), ("1023", "memory"),
    ("1025", "memory"), ("0.5Ki", "memory"), ("123456789", "memory"),
    ("10Gi", "ephemeral-storage"), ("1048577", "ephemeral-storage"),
    ("2Mi", "hugepages-2Mi"), ("1Gi", "hugepages-1Gi"),
    ("3", "pods"), ("110", "pods"), ("4", "example.com/gpu"),
]
REFUSED = [("abc", CLS_COUNT), ("1..2", CLS_MILLI), ("", CLS_KIB), ("1Xi", CLS_MIB),
           ("1.0000000000000000001", CLS_COUNT), ("12345678901234567890", CLS_COUNT)]


def _cls(resource):
    """The canonical class of a resource (the JAX ``resource._native_cls``)."""
    if resource == tres.CPU:
        return CLS_MILLI
    if resource == tres.MEMORY:
        return CLS_KIB
    if resource == tres.EPHEMERAL_STORAGE or resource.startswith(tres.HUGEPAGES_PREFIX):
        return CLS_MIB
    return CLS_COUNT


def _fraction(resource, value):
    """The exact Fraction path, bypassing the native parser."""
    if resource == tres.CPU:
        return tres.milli_value(value)
    if resource == tres.MEMORY:
        return math.ceil(tres.parse_quantity(value) / 2**10)
    if resource == tres.EPHEMERAL_STORAGE or resource.startswith(tres.HUGEPAGES_PREFIX):
        return math.ceil(tres.parse_quantity(value) / 2**20)
    return tres.int_value(value)


def test_native_builds_here():
    """This sandbox has g++: the library is built into ``_build/`` under a
    name keyed by the source's hash."""
    assert native_available()
    path = loader.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.name.startswith("libktpu-") and path.suffix == ".so"


@pytest.mark.parametrize("value,resource", CORPUS)
def test_matches_jax_and_the_fraction_path(value, resource):
    cls = _cls(resource)
    assert cls == jres._native_cls(resource)
    got = canonical_native(value, cls)
    assert got is not None, value
    assert got == jnative(value, cls) == _fraction(resource, value)
    assert tres.canonical(resource, value) == jres.canonical(resource, value) == got


@pytest.mark.parametrize("value,cls", REFUSED)
def test_refused_strings_fall_through_to_the_exact_path(value, cls):
    assert canonical_native(value, cls) is None and jnative(value, cls) is None


def test_exact_fallbacks_and_whitespace():
    deep = "1.0000000000000000001"
    for res in (tres, jres):
        assert res.canonical("pods", deep) == 2 and res.canonical("cpu", deep) == 1001
        assert res.canonical("pods", "1.0000000000000000000") == 1
        with pytest.raises(ValueError):
            res.canonical("cpu", "not-a-quantity")
    assert canonical_native(" 100m ", CLS_MILLI) == 100 == jnative(" 100m ", CLS_MILLI)
    assert canonical_native("-1", CLS_MILLI) == -1000 == jnative("-1", CLS_MILLI)


def test_missing_compiler_falls_back(tmp_path):
    """With no ``g++`` on PATH and an empty build directory the loader
    builds nothing, refuses every string, and ``canonical`` answers on the
    Fraction path."""
    code = textwrap.dedent(f"""
        import pathlib
        from kubernetes_tpu_torch.native import loader
        loader._BUILD_DIR = pathlib.Path({str(tmp_path / "b")!r})
        from kubernetes_tpu_torch.api import resource
        assert not loader.native_available()
        assert loader.canonical_native("1.5Gi", loader.CLS_KIB) is None
        assert resource.canonical("memory", "1.5Gi") == 1572864
        print("fallback ok")
    """)
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH="")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "fallback ok" in r.stdout


def test_two_processes_build_at_once(tmp_path):
    """Two interpreters started together against one empty build directory
    (as test workers start): one compiles under the lock, the other waits
    and loads the same library; both parse, and no temporary file is
    left."""
    build = tmp_path / "build"
    code = textwrap.dedent(f"""
        import pathlib, sys
        from kubernetes_tpu_torch.native import loader
        loader._BUILD_DIR = pathlib.Path({str(build)!r})
        assert loader.native_available(), "no library"
        assert loader.canonical_native("1500m", loader.CLS_MILLI) == 1500
        print(loader.library_path().name)
    """)
    env = dict(os.environ, PYTHONPATH="")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-1000:] for o in outs]
    names = {o[0].strip() for o in outs}
    assert len(names) == 1
    files = sorted(f.name for f in build.iterdir())
    assert files == sorted([names.pop(), "libktpu.lock"])
