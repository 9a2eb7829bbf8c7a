"""The SLO-guarded continuous rebalancer (``kubernetes_tpu/controllers/
rebalance.py``), a descheduler driven from the loop's housekeeping.

* **Scoring**: ``packing_entropy`` is the normalized Shannon entropy of the
  per-node used resources, per axis: load spread evenly over every node
  scores 1.0, load on one node 0.0. On the scheduler loop the inputs are
  the device mirror's rows (``DeviceState._mirror``), read under the
  loop's device mutex; the score runs on the loop's device, in the idle
  gaps the commit worker leaves. The per-superpod slice fragmentation
  (``ops/slice.py:fragmentation_host``) is a second trigger axis.
* **Migration waves**: past the trigger band, the least occupied nodes
  (within a per-wave migration budget) go through
  ``DrainOrchestrator.drain_wave`` with ``uncordon_after``: whole gangs,
  the PDB gate, delete then create unbound; the nodes stay cordoned until
  their pods bound elsewhere.
* **Self-defense**: a hysteresis band, a cooldown between waves, and an
  SLO guardrail: after a wave each tenant's windowed e2e p99 (the JAX
  registry's bucket estimate of ``tenant_e2e_duration``) is held against
  its pre-wave p99, and a regression past the tolerance opens a circuit
  breaker (``rebalance_suspended``), which only a clean window after its
  half-open probe wave closes (``rebalance_resume``).

``packing_entropy`` is the JAX package's XLA program (``:63-81``), here
plain PyTorch on the given device; its logs are ``ops/topology.py:
log_f32``, with the bits of ``jnp.log``. Its sums are torch's, whose order
is not XLA's: the score can differ from the JAX package's in the last
bits (about 1e-7).

The rebalancer runs on the scheduling thread, so its own state needs no
lock; the device mirror is shared with the commit worker, and is read
under the loop's ``device_mutex``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..backend import telemetry
from ..backend.circuit import CircuitBreaker
from ..ops.schema import COL_PODS
from ..ops.slice import fragmentation_host
from ..ops.topology import log_f32
from ..utils.device import DeviceLike, resolve_device
from .drain import DrainOrchestrator

#: the resource axes of the [N, R] requested rows (ops/schema.py COL_* order)
AXIS_NAMES = ("cpu", "memory", "ephemeral", "pods")


def packing_entropy(requested: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-axis normalized bin-packing entropy over the valid nodes, on the
    inputs' device. ``requested`` [N, R] float32, ``valid`` [N] bool. Each
    axis's usage over the valid nodes is a distribution; its entropy over
    log(n_valid) lies in [0, 1]. Axes with no usage are dead: 0.0, and left
    out of the mean. Returns (the mean over the live axes, a 0-d tensor;
    the per-axis [R])."""
    used = torch.where(valid[:, None], requested, 0.0)
    total = used.sum(0)                                              # [R]
    p = used / torch.clamp_min(total, 1e-9)[None, :]
    h = -torch.where(p > 0, p * log_f32(p), 0.0).sum(0)             # [R]
    n = torch.clamp_min(valid.to(torch.float32).sum(), 2.0)
    per_axis = h / log_f32(n)
    live = total > 0
    per_axis = torch.where(live, per_axis, 0.0)
    mean = per_axis.sum() / torch.clamp_min(live.to(torch.float32).sum(), 1.0)
    return mean, per_axis


def _entropy_of(requested: np.ndarray, valid: np.ndarray,
                device: DeviceLike = None) -> Dict[str, float]:
    """Run the score on ``device`` (None: CUDA) and read the scalars back."""
    dev = resolve_device(device)
    with telemetry.dispatch("packing_entropy", bucket=str(len(valid))):
        mean, per_axis = packing_entropy(
            torch.from_numpy(np.ascontiguousarray(requested, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev))
        vals = torch.cat([mean[None], per_axis]).cpu().numpy()
    out = {"entropy": float(vals[0])}
    for i, name in enumerate(AXIS_NAMES[:len(vals) - 1]):
        out[f"entropy_{name}"] = float(vals[1 + i])
    return out


def score_cluster(sched) -> Optional[Dict[str, float]]:
    """The whole cluster's packing score. A scheduler loop with a device
    mirror (``sched.state``) is scored from the mirror's rows, read under
    its ``device_mutex``, on its device; any other scheduler from its host
    snapshot (``score_from_snapshot``). None when no node is known yet.
    ``frag_max`` is the largest per-superpod fragmentation (0.0 without a
    torus)."""
    state = getattr(sched, "state", None)
    if state is not None:
        with sched.device_mutex:
            inputs = mirror_score_inputs(state)
            frag = _mirror_frag_max(state, state._mirror,
                                    state._mirror["valid"].reshape(-1).astype(bool))
        if not inputs["valid"].any():
            return None
        out = _entropy_of(inputs["requested"], inputs["valid"], sched.device)
        out["frag_max"] = frag
        return out
    return score_from_snapshot(sched, getattr(sched, "device", None))


def mirror_score_inputs(state) -> Optional[Dict[str, np.ndarray]]:
    """The score's inputs read off a DeviceState's host mirror (the caller
    holds the loop's device mutex): ``requested`` [N, R] float32 and
    ``valid`` [N] bool (valid rows of uncordoned nodes), both copies; None
    for no state."""
    if state is None:
        return None
    m = state._mirror
    valid = m["valid"].reshape(-1).astype(bool) & ~m["unschedulable"].reshape(-1).astype(bool)
    return {"requested": m["requested"].astype(np.float32), "valid": valid}


def score_from_snapshot(sched, device: DeviceLike = None) -> Optional[Dict[str, float]]:
    """The packing score of the scheduler's host snapshot (cpu, memory,
    ephemeral storage and pod count per node; cordoned nodes left out),
    scored on ``device`` (None: CUDA): the store's truth, without the
    device mirror, so that any scheduler is judged by the same measure."""
    rows = [ni for ni in sched.snapshot.list() if ni.node is not None]
    if not rows:
        return None
    requested = np.zeros((len(rows), 4), np.float32)
    valid = np.zeros(len(rows), bool)
    for i, ni in enumerate(rows):
        valid[i] = not ni.node.spec.unschedulable
        r = ni.requested
        requested[i] = (r.milli_cpu, r.memory, r.ephemeral_storage, len(ni.pods))
    if not valid.any():
        return None
    out = _entropy_of(requested, valid, device)
    out["frag_max"] = 0.0
    return out


def _mirror_frag_max(state, mirror, valid: np.ndarray) -> float:
    """The largest per-superpod fragmentation of the mirror (the caller
    holds the mutex)."""
    caps = state.caps
    grid = (getattr(caps, "superpods", 0), getattr(caps, "sp_slots", 0))
    if not grid[0] or not grid[1]:
        return 0.0
    topo_sp = mirror["topo_sp"].reshape(-1)
    if not (topo_sp[valid] >= 0).any():
        return 0.0
    free = valid & (mirror["requested"][:, COL_PODS] == 0)
    rows = fragmentation_host(topo_sp, mirror["topo_pos"].reshape(-1), valid, free, grid)
    return max((r["frag"] for r in rows), default=0.0)


class Rebalancer:
    """The continuous descheduler of ``sched`` (the loop, or any scheduler
    with a store, a snapshot and a queue); ``maybe_run`` is one tick of its
    control loop. The knobs and their defaults are the JAX package's."""

    def __init__(self, sched, *, entropy_high: float = 0.92, entropy_low: float = 0.80,
                 frag_high: float = 0.60, frag_low: float = 0.40,
                 max_migrations_per_wave: int = 8, cooldown_s: float = 30.0,
                 score_interval_s: float = 5.0, slo_tolerance_pct: float = 50.0,
                 slo_floor_s: float = 0.02, slo_min_samples: int = 20,
                 breaker_threshold: int = 2, probe_interval_s: float = 120.0,
                 headroom_factor: float = 1.2, now_fn=None):
        self.sched = sched
        self.now_fn = now_fn or getattr(sched, "now_fn", time.monotonic)
        self.drain = DrainOrchestrator(sched.store, metrics=getattr(sched, "smetrics", None),
                                       queue=getattr(sched, "queue", None), now_fn=self.now_fn)
        self.entropy_high, self.entropy_low = entropy_high, entropy_low
        self.frag_high, self.frag_low = frag_high, frag_low
        self.max_migrations_per_wave = max_migrations_per_wave
        self.cooldown_s = cooldown_s
        self.score_interval_s = score_interval_s
        self.slo_tolerance_pct = slo_tolerance_pct
        self.slo_floor_s = slo_floor_s
        self.slo_min_samples = slo_min_samples
        self.headroom_factor = headroom_factor
        self.breaker = CircuitBreaker(failure_threshold=breaker_threshold,
                                      reset_timeout_s=probe_interval_s, now_fn=self.now_fn,
                                      on_state_change=self._slo_state_change)
        self.armed = False
        self.suspended = False
        self.last_score: Optional[Dict[str, float]] = None
        self.waves_executed = 0
        self.migrations = 0
        self.last_waves: deque = deque(maxlen=64)
        self.score_seconds: deque = deque(maxlen=4096)  # wall seconds of each score
        self._last_score_at = float("-inf")
        self._last_wave_at = float("-inf")
        # per tenant the SLO watch each wave arms: (baseline p99, snapshot)
        self._slo_watch: Dict[str, tuple] = {}

    # ------------------------------------------------------------ control

    def maybe_run(self, now: Optional[float] = None) -> Dict[str, object]:
        """One tick: completes pending uncordons; then, when the score
        interval has passed and the commit worker is idle, scores the
        cluster, judges the SLO window, moves the trigger band and, when
        armed, out of cooldown and allowed by the guardrail, runs a wave."""
        if now is None:
            now = self.now_fn()
        self.drain.poll_pending_uncordons()
        worker = getattr(self.sched, "commit_worker", None)
        if worker is not None and not worker.idle():
            return {"ran": False, "reason": "commit-plane-busy"}
        if now - self._last_score_at < self.score_interval_s:
            return {"ran": False, "reason": "interval"}
        self._last_score_at = now
        t0 = time.perf_counter()
        score = score_cluster(self.sched)
        self.score_seconds.append(time.perf_counter() - t0)
        if score is None:
            return {"ran": False, "reason": "no-node-truth"}
        self.last_score = score
        metrics = getattr(self.sched, "smetrics", None)
        if metrics is not None:
            metrics.packing_entropy.set(value=score["entropy"])
        self._judge_slo()
        self._update_trigger(score)
        if not self.armed:
            return {"ran": False, "reason": "in-band", "score": score}
        if now - self._last_wave_at < self.cooldown_s:
            return {"ran": False, "reason": "cooldown", "score": score}
        if not self.breaker.allow():
            if metrics is not None:
                metrics.rebalance_waves.inc("suspended")
            return {"ran": False, "reason": "slo-suspended", "score": score}
        return self._run_wave(now, score)

    def _update_trigger(self, score: Dict[str, float]) -> None:
        """Arm above the high band on either axis; disarm only below the low
        band on both."""
        hot = score["entropy"] >= self.entropy_high or score["frag_max"] >= self.frag_high
        cool = score["entropy"] <= self.entropy_low and score["frag_max"] <= self.frag_low
        if not self.armed and hot:
            self.armed = True
        elif self.armed and cool:
            self.armed = False

    # -------------------------------------------------------------- waves

    def _run_wave(self, now: float, score: Dict[str, float]) -> Dict[str, object]:
        metrics = getattr(self.sched, "smetrics", None)
        victims = self._pick_victims()
        if not victims:
            if metrics is not None:
                metrics.rebalance_waves.inc("empty")
            return {"ran": False, "reason": "no-victims", "score": score}
        self._arm_slo_watch()
        result = self.drain.drain_wave(victims, uncordon_after=True,
                                       allow_fn=self.drain._pdb_disruption_gate())
        self._last_wave_at = now
        self.waves_executed += 1
        self.migrations += result["evicted"]
        telemetry.event("rebalance_wave", nodes=result["nodes"], pods=result["evicted"],
                        gangs=result["gangs"], entropy=round(score["entropy"], 4),
                        frag=round(score["frag_max"], 4))
        if metrics is not None:
            metrics.rebalance_waves.inc("executed")
            metrics.rebalance_migrations.inc(value=result["evicted"])
        self.last_waves.append({"at": now, "nodes": victims, "evicted": result["evicted"],
                                "gangs": result["gangs"], "entropy": score["entropy"],
                                "frag": score["frag_max"]})
        return {"ran": True, "wave": result, "score": score}

    def _pick_victims(self) -> List[str]:
        """The least occupied schedulable nodes, within the migration
        budget, each only when its load fits (times ``headroom_factor``)
        into the free capacity of the schedulable nodes left; the densest
        occupied node is never one."""
        rows = [ni for ni in self.sched.snapshot.list()
                if ni.node is not None and not ni.node.spec.unschedulable]
        occupied = [ni for ni in rows if ni.pods]
        if len(occupied) <= 1:
            return []

        def occ(ni) -> float:
            a, r = ni.allocatable, ni.requested
            axes = []
            if a.milli_cpu:
                axes.append(r.milli_cpu / a.milli_cpu)
            if a.memory:
                axes.append(r.memory / a.memory)
            if a.allowed_pod_number:
                axes.append(len(ni.pods) / a.allowed_pod_number)
            return sum(axes) / max(len(axes), 1)

        occupied.sort(key=occ)
        free = np.zeros(3, np.float64)  # cpu, memory, pod slots
        for ni in rows:
            free += (max(ni.allocatable.milli_cpu - ni.requested.milli_cpu, 0),
                     max(ni.allocatable.memory - ni.requested.memory, 0),
                     max(ni.allocatable.allowed_pod_number - len(ni.pods), 0))
        victims: List[str] = []
        budget = self.max_migrations_per_wave
        for ni in occupied[:-1]:
            need = np.array((ni.requested.milli_cpu, ni.requested.memory, len(ni.pods)),
                            np.float64)
            node_free = np.array((ni.allocatable.milli_cpu - ni.requested.milli_cpu,
                                  ni.allocatable.memory - ni.requested.memory,
                                  ni.allocatable.allowed_pod_number - len(ni.pods)), np.float64)
            if len(ni.pods) > budget:
                break  # sorted ascending: no later node fits either
            if np.any(need * self.headroom_factor > free - node_free):
                continue  # no room elsewhere for this node's load
            victims.append(ni.node.meta.name)
            budget -= len(ni.pods)
            free -= node_free + need  # the node leaves the pool
        return victims

    # ------------------------------------------------------ SLO guardrail

    def _tenant_hist(self):
        return getattr(getattr(self.sched, "smetrics", None), "tenant_e2e_duration", None)

    def _arm_slo_watch(self) -> None:
        """At a wave: each tenant's whole-run p99 as its baseline, and a
        snapshot that opens the window the guardrail judges."""
        hist = self._tenant_hist()
        if hist is None:
            return
        for labels in hist.label_sets():
            ns = labels[0]
            if hist.count(ns):
                self._slo_watch[ns] = (hist.estimate(0.99, ns), hist.snapshot(ns))

    def _judge_slo(self) -> None:
        """Each watched tenant with enough samples since its snapshot: a p99
        past ``baseline * (1 + tolerance) + floor`` counts a failure on the
        breaker (which may open); a clean judged window after a wave counts
        a success, unless the breaker is open (only its half-open probe
        closes it). Each judged window rolls forward."""
        hist = self._tenant_hist()
        if hist is None or not self._slo_watch:
            return
        judged = False
        worst = None
        for ns, (baseline, snap) in list(self._slo_watch.items()):
            if hist.count_since(snap, ns) < self.slo_min_samples:
                continue
            p99 = hist.estimate_since(snap, 0.99, ns)
            fence = baseline * (1.0 + self.slo_tolerance_pct / 100.0) + self.slo_floor_s
            if p99 > fence and (worst is None or p99 - fence > worst[1]):
                worst = (ns, p99 - fence, p99, baseline)
            self._slo_watch[ns] = (baseline, hist.snapshot(ns))
            judged = True
        if worst is not None:
            self.breaker.record_failure()
            telemetry.event("rebalance_suspended", tenant=worst[0], p99=round(worst[2], 4),
                            baseline=round(worst[3], 4))
        elif judged and self.waves_executed and self.breaker.state != "open":
            self.breaker.record_success()

    def _slo_state_change(self, _old: str, new: str) -> None:
        metrics = getattr(self.sched, "smetrics", None)
        if new == "open":
            self.suspended = True
            if metrics is not None:
                metrics.rebalance_suspended.set(value=1)
        elif new == "closed" and self.suspended:
            self.suspended = False
            telemetry.event("rebalance_resume")
            if metrics is not None:
                metrics.rebalance_suspended.set(value=0)

    # -------------------------------------------------------------- debug

    def debug_dump(self, limit: Optional[int] = None) -> Dict[str, object]:
        """The rebalancer's state as JSON-clean data (``/debug/rebalance``):
        the band, budget, breaker, score, counters, the last waves (the
        newest ``limit``) and the pending uncordons."""
        waves = list(self.last_waves)
        truncated = None
        if limit is not None and len(waves) > limit:
            truncated = len(waves)
            waves = waves[-limit:]
        out = {
            "enabled": True,
            "armed": self.armed,
            "suspended": self.suspended,
            "score": self.last_score,
            "bands": {"entropy_high": self.entropy_high, "entropy_low": self.entropy_low,
                      "frag_high": self.frag_high, "frag_low": self.frag_low},
            "budget": {"max_migrations_per_wave": self.max_migrations_per_wave,
                       "cooldown_s": self.cooldown_s},
            "breaker": self.breaker.dump(),
            "waves_executed": self.waves_executed,
            "migrations": self.migrations,
            "last_waves": waves,
            "pending_uncordons": [dict(w) for w in self.drain.pending_uncordons],
        }
        if truncated is not None:
            out["truncated"] = {"last_waves": truncated}
        return out
