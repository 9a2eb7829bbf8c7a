"""Device-read accounting and platform probing: an own copy of
``kubernetes_tpu/utils/relay.py``.

The batch path's contract is ONE blocking device read per batch cycle: the
packed result block's read at commit. Hot-path code reports each blocking
read through ``count_sync(tag)``, and tests wrap a workload in ``track()``
to hold it to that budget. The loop's tags are the JAX package's:
"commit-read" (the packed block), "preempt-read" (the preemption screen's
read, when the device screen runs), "gang-read" (the flat gangs' verdicts)
and "diagnosis-read"; the port's failure diagnosis always rides the packed
block, so it never reads again and that tag never fires. The warm sweep's
reads are not counted, as in JAX.

``probe_platform`` asks a child interpreter whether CUDA is available and
what the card is called, with the JAX probe's attempts, gaps and timeouts.
It only reports what it found: unlike the JAX probe, which sets
``JAX_PLATFORMS=cpu`` when the probe fails, it switches nothing.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from typing import Optional, Tuple

_local = threading.local()


def count_sync(tag: str) -> None:
    """Record one blocking device read on this thread (a no-op unless
    inside ``track()``)."""
    c = getattr(_local, "counter", None)
    if c is not None:
        c[tag] += 1


@contextlib.contextmanager
def track():
    """Collect read counts on this thread: ``with track() as c: ...``;
    ``c`` is a Counter of tag -> reads."""
    prev = getattr(_local, "counter", None)
    c: Counter = Counter()
    _local.counter = c
    try:
        yield c
    finally:
        _local.counter = prev


_PROBE = ("import torch; print('cuda:' + torch.cuda.get_device_name(0) "
          "if torch.cuda.is_available() else 'cpu')")


def probe_platform(timeout_s: Optional[float] = None) -> Tuple[str, dict]:
    """Probe the platform in a child interpreter, without touching CUDA in
    this process. Returns ("cuda:<card name>" or "cpu", a diagnostic dict),
    or ("unreachable", diag) when no attempt answered. ``CUDA_VISIBLE_DEVICES``
    set to "" (``utils/platform.force_cpu``) answers "cpu" at once."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("BENCH_PROBE_TIMEOUT", "60"))
    if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
        return "cpu", {"outcome": "forced-cpu"}
    diag: dict = {}
    # attempts spread over a window, as the JAX probe spreads them
    attempts = int(os.environ.get("BENCH_PROBE_ATTEMPTS", "3"))
    gap_s = float(os.environ.get("BENCH_PROBE_GAP", "30"))
    for attempt in range(attempts):
        if attempt:
            time.sleep(gap_s)
        t0 = time.perf_counter()
        try:
            out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                                 text=True, timeout=timeout_s)
            if out.returncode != 0:
                outcome = f"rc={out.returncode}"
            elif not out.stdout.strip():
                outcome = "empty-stdout"
            else:
                outcome = "ok"
            diag = {"outcome": outcome, "duration_s": round(time.perf_counter() - t0, 2),
                    "attempt": attempt}
            if out.returncode != 0:
                diag["error_tail"] = out.stderr.strip()[-300:]
            if outcome == "ok":
                return out.stdout.strip().splitlines()[-1], diag
            if out.returncode != 0 and diag["duration_s"] < 5:
                break  # a fast, deterministic failure (torch broken or absent)
        except subprocess.TimeoutExpired:
            diag = {"outcome": "timeout", "duration_s": round(time.perf_counter() - t0, 2),
                    "attempt": attempt}
    return "unreachable", diag
