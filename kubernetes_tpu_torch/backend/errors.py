"""The device path's error type the scheduler loop raises (a trimmed copy of
``kubernetes_tpu/backend/errors.py``, which also types the wire transport's
failures; the port has no wire transport yet)."""

from __future__ import annotations


class PermanentDeviceError(RuntimeError):
    """Retrying the identical call cannot help: a capacity dimension the
    loop does not know how to grow, or capacities that do not converge."""
