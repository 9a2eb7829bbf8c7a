"""Deadline batch sizing (``kubernetes_tpu/backend/sizer.py``).

``BatchSizer.target()`` is the batch the scheduler loop pops next: the
largest pod-axis bucket whose predicted pop-to-commit latency fits the
deadline (``deadline_s`` 0 disables the cut, and every batch is
``max_batch``). The latency model ``a + b * bucket`` is fitted from each
committed batch's span (``update``). A second model, of the commit wait
(the time the ring's blocking read of a batch's packed block waited for the
device; ``update_wait``), caps the target where the predicted wait passes
``STALL_TARGET_S`` (15 ms, the reference's default). Both fits read the
loop's clock, so on a wall clock batch sizes vary from run to run unless
the deadline is 0.
"""

from __future__ import annotations

from typing import Optional

# the commit wait the stall model allows a batch (the reference's
# ``KTPU_STALL_TARGET_MS`` default)
STALL_TARGET_S = 0.015


class _DecayedFit:
    """Exponentially-decayed least squares y(x) = a + b·x with compile-blip
    outlier rejection: the pop→commit latency model."""

    def __init__(self, a: float, b: float, decay: float = 0.95, floor: float = 0.0):
        self.a = a
        self.b = b
        self.decay = decay
        self.floor = floor  # the least prediction the outlier test compares with
        self.updates = 0
        self.outliers = 0  # consecutive rejected observations
        self._sw = self._sx = self._sy = self._sxx = self._sxy = 0.0

    def update(self, x: float, y: float) -> None:
        if x <= 0:
            return
        # outlier rejection: a jit-compile cycle reads as 10-100x the model
        # prediction; folding it in would shrink the target, switch buckets,
        # trigger ANOTHER compile, and feed back into a collapse. Warmup
        # observations (first few) always fold in, and THREE consecutive
        # outliers mean the machine genuinely got slower — accept then.
        predicted = self.a + self.b * x
        if (self.updates >= 3 and y > 4.0 * max(predicted, self.floor)
                and self.outliers < 2):
            self.outliers += 1
            return
        self.outliers = 0
        self.updates += 1
        d = self.decay
        self._sw = self._sw * d + 1.0
        self._sx = self._sx * d + x
        self._sy = self._sy * d + y
        self._sxx = self._sxx * d + x * x
        self._sxy = self._sxy * d + x * y
        xm = self._sx / self._sw
        ym = self._sy / self._sw
        var = self._sxx / self._sw - xm * xm
        if var > 1e-6:
            cov = self._sxy / self._sw - xm * ym
            slope = cov / var
            # a degenerate or negative slope (one bucket size observed, or a
            # machine-speed shift inverting the decayed samples) KEEPS the
            # prior per-unit estimate — snapping b to a floor would read as
            # "units are free" and blow the target out
            if slope > 1e-5:
                self.b = slope
        self.a = max(ym - self.b * xm, 0.0)


class BatchSizer:
    """Deadline-based batch cutting (SURVEY §7 hard-part 7: iso-p99 needs
    the batch size bounded by a latency budget, not just throughput).

    The controlled quantity is the POP→COMMIT attempt latency itself — the
    histogram BASELINE.md's iso-p99 is defined over — observed per landed
    batch at the commit site (it spans the batch's own dispatch plus the
    overlapped next cycle; modeling raw cycle time instead systematically
    underestimates, because a batch's async device execution lands in the
    NEXT cycle's commit wait). Latency is modeled as ``a + b·B`` via an
    exponentially-decayed least-squares fit over (B, span) observations;
    the target batch is the largest B with ``a + b·B ≤ deadline ·
    _P99_HEADROOM`` — the headroom (0.6) keeps the OBSERVED p99 (slow
    first-after-drain batches run ~1.6-2x the mean span) inside the
    declared deadline, not just the average. Under light load the queue
    pops less than the target anyway; under heavy load this trades peak
    throughput for a bounded p99. ``deadline_s=0`` disables cutting."""

    def __init__(self, max_batch: int, deadline_s: float, min_batch: int = 16):
        self.max_batch = max_batch
        self.min_batch = min(min_batch, max_batch)
        self.deadline_s = deadline_s
        self._bucket: Optional[int] = None  # sticky chosen bucket
        # exponentially-decayed least squares over (B, latency): the old
        # alternating a/b EMA decomposition was biased — with mixed bucket
        # sizes it attributed nearly everything to the fixed cost (a→0.2s,
        # b→0) and collapsed the target to min_batch. Seeds: one relay RTT
        # fixed + ~0.3 ms/pod encode+commit.
        self._fit = _DecayedFit(a=0.040, b=0.0003)
        # the commit-wait residual: the time a batch's read blocked on the
        # device after its copy was staged at dispatch. Where the wait grows
        # with the bucket, capping its prediction at the stall target picks
        # the bucket where device time meets the overlapped host work.
        # Inactive until fed (b = 0).
        # floor 1 ms: near-zero predictions would flag every first real
        # wait as a 4x outlier
        self._wfit = _DecayedFit(a=0.0, b=0.0, floor=1e-3)

    def update(self, batch_size: int, latency_s: float) -> None:
        self._fit.update(batch_size, latency_s)

    @property
    def updates(self) -> int:
        """Observations folded into the latency model."""
        return self._fit.updates

    def update_wait(self, batch_size: int, wait_s: float) -> None:
        """Feed one commit-wait observation (the ring's blocking read)."""
        self._wfit.update(batch_size, wait_s)

    # pod-axis buckets: the compiled program's step count is the PADDED pod
    # capacity, so the target quantizes to a small set of compile shapes;
    # the sticky-bucket hysteresis in target() keeps adjacent-bucket
    # oscillation (each flip costs a compile) from thrashing.
    _BUCKETS = (16, 32, 64, 128, 256, 512, 1024)

    def _ladder(self):
        for b in self._BUCKETS:
            if b < self.max_batch:
                yield b
        yield self.max_batch

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, clipped to max_batch."""
        for b in self._ladder():
            if b >= n:
                return b
        return self.max_batch

    # the a+b·B model tracks the MEAN batch span; the p99 over pods is set
    # by occasional slow batches (first-after-drain syncs, chain breaks) at
    # ~1.6-2x the mean. Targeting a fraction of the deadline keeps the
    # OBSERVED p99 inside it instead of just the average.
    _P99_HEADROOM = 0.6

    def target(self) -> int:
        if not self.deadline_s:
            return self.max_batch
        budget = self.deadline_s * self._P99_HEADROOM - self._fit.a
        if budget <= 0 or self._fit.b <= 0:
            return self.min_batch
        raw = max(self.min_batch, min(self.max_batch, int(budget / self._fit.b)))
        # the stall cap: past the bucket whose predicted commit wait meets
        # the target, a larger batch turns overlapped host work into blocked
        # device wait one for one
        if self._wfit.b > 0:
            stall_budget = STALL_TARGET_S - self._wfit.a
            raw_stall = int(stall_budget / self._wfit.b) if stall_budget > 0 else 0
            raw = max(self.min_batch, min(raw, raw_stall))
        # sticky hysteresis: keep the current bucket while the model's raw
        # target stays in its neighborhood (a switch = a new compiled shape)
        cur = self._bucket
        if cur is not None and cur <= raw < 1.9 * cur and cur <= self.max_batch:
            return cur
        # floor to a bucket: popping more than the bucket floor would pad to
        # the NEXT bucket and pay its full program for a part-filled batch
        best = self.min_batch
        for b in self._ladder():
            if b <= raw:
                best = max(best, b)
        self._bucket = best
        return best
