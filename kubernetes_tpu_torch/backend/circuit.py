"""The circuit breaker of the device path (a copy of
``kubernetes_tpu/backend/circuit.py``).

After ``failure_threshold`` consecutive failures the breaker OPENS and the
caller stops using what it guards: the scheduler loop sends every pod down
its sequential path, and the quota plugin suspends its reclaim pass. After
``reset_timeout_s`` the next attempt is a HALF_OPEN probe: success closes
the breaker, failure opens it again for another timeout.

Driven by the caller's ``now_fn``, so tests advance a FakeClock instead of
sleeping. The loop that drives it is single-threaded; no locking.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# the backend_circuit_state gauge's encoding
STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 3, reset_timeout_s: float = 5.0,
                 now_fn: Callable[[], float] = time.monotonic,
                 on_state_change: Optional[Callable[[str, str], None]] = None):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.now_fn = now_fn
        self.on_state_change = on_state_change
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.opens = 0  # open transitions over the breaker's life
        self.last_error: str = ""

    def _transition(self, new: str) -> None:
        if new == self.state:
            return
        old, self.state = self.state, new
        if new == OPEN:
            self.opens += 1
            self.opened_at = self.now_fn()
        if self.on_state_change is not None:
            self.on_state_change(old, new)

    def allow(self) -> bool:
        """Whether an attempt may proceed. An OPEN breaker past its reset
        timeout turns HALF_OPEN and admits the one probe."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.now_fn() - self.opened_at >= self.reset_timeout_s:
                self._transition(HALF_OPEN)
                return True
            return False
        return True  # HALF_OPEN: the loop is sequential, this is the probe

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._transition(CLOSED)

    def record_failure(self, error: Optional[BaseException] = None) -> None:
        self.consecutive_failures += 1
        if error is not None:
            self.last_error = f"{type(error).__name__}: {error}"
        if self.state == HALF_OPEN or self.consecutive_failures >= self.failure_threshold:
            # a failed probe, or one failure more while open, restarts the
            # reset timer
            self.opened_at = self.now_fn()
            self._transition(OPEN)

    def dump(self) -> dict:
        """The breaker's state as a JSON-ready dict."""
        now = self.now_fn()
        return {
            "state": self.state,
            "consecutiveFailures": self.consecutive_failures,
            "failureThreshold": self.failure_threshold,
            "resetTimeoutS": self.reset_timeout_s,
            "opens": self.opens,
            "openFor": (now - self.opened_at
                        if self.state == OPEN and self.opened_at is not None else 0.0),
            "lastError": self.last_error,
        }
