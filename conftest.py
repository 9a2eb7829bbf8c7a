"""Build the JAX package's native library once, before pytest-xdist starts
its workers.

``kubernetes_tpu/native/loader.py`` compiles ``native/ktpu_quantity.cpp``
into ``native/build/libktpu.so`` on first use. Under xdist every worker
imports the package at once, each compiles to the same path with no lock
between processes, and a worker whose load meets a half-written library
caches the failure: its ``tests/test_native.py`` then skips
``TestNativeParity`` ("no native toolchain"). Building here, in the xdist
controller (or in a run without xdist), leaves every worker a finished
library newer than its source, which the loader only loads.

The loader is run by path: it imports only the standard library, so
nothing here imports ``jax`` ahead of ``tests/conftest.py``. Without a
compiler the loader logs and the tests take their fallback, as before.
"""

import importlib.util
import os

_LOADER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "kubernetes_tpu", "native", "loader.py")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    if not os.path.exists(_LOADER):
        return
    spec = importlib.util.spec_from_file_location("_ktpu_native_loader_prebuild", _LOADER)
    loader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loader)
    loader.native_available()
