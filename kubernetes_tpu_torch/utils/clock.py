"""Injectable clock (``kubernetes_tpu/utils/clock.py``): the real monotonic
clock by default, and a ``FakeClock`` that moves only when told, so backoff
expiry, assume TTLs and Coscheduling's rejection backoff are deterministic
in tests. Every timestamp of the scheduler loop comes from its ``now_fn``."""

from __future__ import annotations


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

