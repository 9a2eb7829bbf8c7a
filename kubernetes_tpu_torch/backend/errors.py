"""The device path's error types (a trimmed copy of
``kubernetes_tpu/backend/errors.py``; the retry policy and the wire
transport's mapping come with the wire service).

  * ``TransientDeviceError``: the call may succeed if repeated; the loop
    counts it against its relay breaker.
  * ``PermanentDeviceError``: retrying the identical call cannot help (a
    capacity dimension the loop does not know how to grow, or capacities
    that do not converge).
  * ``StaleEpochError``: the device restarted since the client last synced;
    its state is a fresh empty mirror, so the client resyncs in full.

All three subclass RuntimeError through ``DeviceServiceError``.
"""

from __future__ import annotations


class DeviceServiceError(RuntimeError):
    """Base of the device-path taxonomy."""


class TransientDeviceError(DeviceServiceError):
    """The call may succeed if repeated: retry, then breaker-count it."""


class PermanentDeviceError(DeviceServiceError):
    """Retrying the identical call cannot help; surface it."""


class StaleEpochError(DeviceServiceError):
    """The device restarted since the last sync: its state is a fresh empty
    mirror under a new process epoch. Carries the current epoch so the
    client can resync and re-stamp in one round trip."""

    def __init__(self, epoch: str, message: str = ""):
        super().__init__(message or f"device epoch changed (now {epoch!r}); "
                         "full resync required")
        self.epoch = epoch
