"""utiltrace (k8s.io/utils/trace): an own copy of ``kubernetes_tpu/utils/
trace.py``, the always-on cheap latency attribution of a scheduling cycle.

The reference opens a trace per scheduling cycle and logs step timings only
when the cycle exceeds a threshold (schedule_one.go:312 utiltrace.New +
LogIfLong(100ms)). Steps are recorded unconditionally (two clock reads); the
formatting cost is paid only on slow cycles. The sequential path's
``schedule_pod`` keeps one.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

logger = logging.getLogger("kubernetes_tpu_torch.trace")


class Trace:
    __slots__ = ("name", "fields", "start", "steps", "now_fn")

    def __init__(self, name: str, now_fn=time.monotonic, **fields):
        self.name = name
        self.fields = fields
        self.now_fn = now_fn
        self.start = now_fn()
        self.steps: List[Tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self.steps.append((self.now_fn(), msg))

    def total(self) -> float:
        return self.now_fn() - self.start

    def log_if_long(self, threshold_s: float, sink=None) -> Optional[str]:
        total = self.total()
        if total < threshold_s:
            return None
        fields = ", ".join(f"{k}={v}" for k, v in self.fields.items())
        parts = [f'Trace "{self.name}" ({fields}) total={total*1000:.1f}ms:']
        prev = self.start
        for t, msg in self.steps:
            parts.append(f"  +{(t - prev)*1000:.1f}ms {msg}")
            prev = t
        text = "\n".join(parts)
        (sink or logger.info)(text)
        return text
