"""The device path's error taxonomy and the wire transport's retry policy
(own copy of ``kubernetes_tpu/backend/errors.py``, whole).

  * ``TransientDeviceError``: the call may succeed if repeated (connection
    refused or reset, read timeout, 502/503/504); the wire client retries
    it with backoff inside its deadline budget, then the breaker counts it.
    The loop counts it against its relay breaker.
  * ``PermanentDeviceError``: retrying the identical call cannot help (a
    4xx, a protocol violation, a service-side exception answered as 500,
    a capacity dimension the loop cannot grow). Never retried at the
    transport; the pods re-enter the backoff queue.
  * ``StaleEpochError``: the device restarted since the client last synced;
    its state is a fresh empty mirror, so the client resyncs in full.
  * ``FailoverError``: the device fabric's active replica was lost
    (transient by taxonomy; the fabric itself is not ported yet).
  * ``ConflictError``: another scheduler replica won a race this client
    lost (HTTP 409 with ``conflict: true``); neither a resync nor a retry
    helps, the pods re-enter the backoff queue and a fenced session
    rejoins.

All subclass RuntimeError through ``DeviceServiceError``.

``RetryPolicy`` is the retry loop with exponential backoff and jitter
bounded by a per-call deadline; its ``sleep_fn``, ``now_fn`` and ``rng``
are injectable so that no test sleeps against the wall clock.
``raise_injected_fault`` is the client-side hook of ``testing/faults.py``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


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


class FailoverError(TransientDeviceError):
    """The device fabric's active replica was lost and a standby promoted:
    the batch in flight is requeued, nothing replayed. Carries both
    endpoints."""

    def __init__(self, message: str = "device fabric failover",
                 from_endpoint: str = "", to_endpoint: str = ""):
        super().__init__(message)
        self.from_endpoint = from_endpoint
        self.to_endpoint = to_endpoint


class ConflictError(DeviceServiceError):
    """Another scheduler replica owns the pod (or this client's session was
    fenced): the service is healthy and the client's base is fine, so the
    pods re-enter the backoff queue and a fenced session rejoins."""

    def __init__(self, message: str = "commit conflict"):
        super().__init__(message)


def raise_injected_fault(fault_plan, op: str, read_timeout: float) -> None:
    """The client-side fault hook: consume the next scripted fault for
    ``op`` and raise what the network would have (``drop`` and ``error``
    as a transient failure, a ``delay`` at or past the read deadline as
    its timeout). Nothing sleeps."""
    if fault_plan is None:
        return
    fault = fault_plan.next_client(op)
    if fault is None:
        return
    if fault.kind in ("drop", "error"):
        raise TransientDeviceError(f"injected {fault.kind}: {op}")
    if fault.kind == "delay" and fault.seconds >= read_timeout:
        raise TransientDeviceError(
            f"injected timeout: {op} delayed {fault.seconds}s "
            f"> read deadline {read_timeout}s")


class RetryPolicy:
    """Exponential backoff with jitter over transient failures, bounded by
    a per-call deadline budget and a retry count."""

    def __init__(self, max_retries: int = 3, backoff_base: float = 0.05,
                 backoff_max: float = 2.0, deadline_s: float = 60.0,
                 jitter: float = 0.5,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 now_fn: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None,
                 on_retry: Optional[Callable[[str], None]] = None):
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.deadline_s = deadline_s
        self.jitter = jitter
        self.sleep_fn = sleep_fn
        self.now_fn = now_fn
        # seeded by default: retry timing adds no nondeterminism
        self.rng = rng if rng is not None else random.Random(0)
        self.on_retry = on_retry  # scheduler_wire_retries_total

    def backoff_for(self, attempt: int) -> float:
        """The backoff before retry ``attempt`` (1-based): base * 2^(attempt
        - 1), capped, scaled by a jitter factor in [1 - jitter, 1]."""
        d = min(self.backoff_base * (2 ** (attempt - 1)), self.backoff_max)
        return d * (1.0 - self.jitter + self.jitter * self.rng.random())

    def run(self, op: str, fn):
        """``fn()``, retrying a TransientDeviceError. Every other error
        propagates at once; the last transient one (retries or budget
        spent) propagates for the breaker."""
        start = self.now_fn()
        attempt = 0
        while True:
            try:
                return fn()
            except TransientDeviceError:
                attempt += 1
                elapsed = self.now_fn() - start
                if attempt > self.max_retries or elapsed >= self.deadline_s:
                    raise
                delay = min(self.backoff_for(attempt),
                            max(self.deadline_s - elapsed, 0.0))
                if self.on_retry is not None:
                    self.on_retry(op)
                # a retry sleep under a component lock wedges that component
                # for the whole backoff: the lock tracer flags it
                from ..testing.locktrace import note_blocking

                note_blocking("sleep", f"retry backoff: {op}")
                self.sleep_fn(delay)
