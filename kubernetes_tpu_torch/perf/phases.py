"""The round loops of the JAX harness's soak, borrow, replay and elastic
phases (``kubernetes_tpu/perf/harness.py:784-1516``), once for the port.

Two drivers call them. ``perf/harness.py``'s ``Runner`` builds each
round's pods from a test case's op-list mix and turns the result into
DataItems. ``perf/workloads.py``'s ``*_rounds`` build them from a
``Workload`` object and drive either package's scheduler loop (the JAX
loop too, for the parity tests). What a driver supplies:

* ``arrive(r)`` creates round ``r``'s pods, with the objects they need
  (PodGroups, claims), in the store and returns their keys in creation
  order;
* ``cycle()`` runs one scheduling cycle and says whether it made
  progress;
* ``clock`` is the loop's clock: ``tick_s`` > 0 advances it after every
  cycle when it has ``advance`` (a FakeClock);
* ``on_cycle()``, when given, runs after every cycle's own bookkeeping
  (the harness samples its throughput collector there).

Every loop lands the loop's ring (``_drain_inflight``, where the loop has
one) before its final accounting, as the JAX phases do.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

from ..api import resource as resource_api
from ..backend.circuit import STATE_VALUES
from ..backend.errors import TransientDeviceError


def quota_oversubscription(quota, namespaces: Sequence[str]) -> int:
    """Dimensions over their cap in the ledger, the JAX harness's check
    (``kubernetes_tpu/perf/harness.py:838-864``): a namespace's usage less
    its loans against its own caps, and every pool's usage against the sum
    of its members' caps."""
    bad = 0
    cohorts = set()
    for ns in namespaces:
        hard = quota.effective_hard(ns)
        if not hard:
            continue
        used, loans = quota.usage(ns), quota.borrowed(ns)
        bad += sum(1 for dim, cap in hard.items() if used.get(dim, 0) - loans.get(dim, 0) > cap)
        if quota.cohort_for(ns):
            cohorts.add(quota.cohort_for(ns))
    for cohort in cohorts:
        caps, used = quota.cohort_state(cohort)
        bad += sum(1 for dim, cap in caps.items() if used.get(dim, 0) > cap)
    return bad


def elastic_oversubscribed(store) -> int:
    """Nodes whose bound pods ask more cpu than the node allocates, or
    outnumber its pod capacity (``harness.py:1377-1402``; a pod bound to a
    deleted node is not counted)."""
    used: Dict[str, int] = {}
    npods: Dict[str, int] = {}
    for p in store.pods.values():
        n = p.spec.node_name
        if not n:
            continue
        used[n] = used.get(n, 0) + p.resource_request().get(resource_api.CPU, 0)
        npods[n] = npods.get(n, 0) + 1
    bad = 0
    for n, cpu in used.items():
        node = store.nodes.get(n)
        if node is None:
            continue
        alloc = node.status.allocatable
        cap = resource_api.canonical(resource_api.CPU, alloc.get(resource_api.CPU, "0"))
        pods_cap = int(alloc.get(resource_api.PODS, 0) or 0)
        if cpu > cap or (pods_cap and npods.get(n, 0) > pods_cap):
            bad += 1
    return bad


def _ticker(clock, tick_s: float) -> Optional[Callable[[], None]]:
    advance = getattr(clock, "advance", None) if tick_s else None
    return None if advance is None else (lambda: advance(tick_s))


def run_cycles(sched, cycle: Callable[[], bool], count: int,
               tick: Optional[Callable[[], None]] = None,
               after: Callable[[], None] = lambda: None,
               idle: Callable[[], bool] = lambda: True) -> int:
    """Up to ``count`` cycles, each followed by ``tick`` and ``after``;
    they stop after a cycle that made no progress when, after a backoff
    flush, the queue is empty and ``idle()``. Returns the cycles run."""
    n = 0
    for _ in range(count):
        progressed = cycle()
        n += 1
        if tick is not None:
            tick()
        after()
        if not progressed:
            sched.queue.flush_backoff_completed()
            if len(sched.queue) == 0 and idle():
                break
    return n


def _land(sched) -> None:
    drain = getattr(sched, "_drain_inflight", None)
    if drain is not None:
        drain()


def _churn(store, bound: Dict[str, List[str]], frac: float) -> None:
    """``frac`` of each tenant's phase-bound pods still in the store
    leave, oldest first."""
    for ns in bound:
        keys = bound[ns]
        n = int(len(keys) * frac)
        for key in keys[:n]:
            if store.get_pod(key) is not None:
                store.delete_pod(key)
        bound[ns] = keys[n:]


def soak_loop(store, sched, quota, clock, rounds: int, arrive: Callable[[int], List[str]],
              tenants: Iterable[str], cycle: Callable[[], bool], cycles_per_round: int,
              tick_s: float = 0.0, churn_frac: float = 0.0, breaker=None,
              flap_round: Optional[int] = None, flap_batches: int = 0,
              on_cycle: Callable[[], None] = lambda: None) -> dict:
    """The soak phase (``kubernetes_tpu/perf/harness.py:784-990``). Each
    round: the arrivals, then, when ``r == flap_round``, the loop's
    ``relay_fault_fn`` is set so that the next ``flap_batches`` batch
    commits raise a ``TransientDeviceError`` at their read and take the
    relay death path (the hook clears itself when spent); then up to
    ``cycles_per_round`` cycles, after each the new binds of the phase's
    pods noted and the ledger (``quota``, None for none) checked for
    oversubscription; then, with ``churn_frac``, that share of each
    tenant's phase-bound pods leaves and the check runs again.

    Returns ``bound`` and ``waits`` (per tenant: the phase's pods that
    bound, and each one's wait from creation to bind on ``clock``),
    ``oversubscription`` (over every check), ``checks``, ``rounds`` (per
    round the ledger's usage per tenant after the churn), ``cycles``,
    ``breaker`` (``breaker``'s ``STATE_VALUES`` after each cycle, -1
    without one) and the JAX soak's invariants (``:975-990``):
    ``degraded_s`` (degraded seconds over the phase), ``breaker_state``
    (at the end), ``flap_batches`` (commits the flap failed),
    ``comparer_checks`` and ``comparer_mismatches``."""
    tenants = list(tenants)
    bound_seen = {k for k, p in store.pods.items() if p.spec.node_name}
    created_at: Dict[str, float] = {}
    soak_bound: Dict[str, List[str]] = {ns: [] for ns in tenants}
    bound = dict.fromkeys(tenants, 0)
    waits: Dict[str, List[float]] = {ns: [] for ns in tenants}
    out = {"oversubscription": 0, "checks": 0, "rounds": [], "cycles": 0, "breaker": []}
    flap = {"left": 0, "failed": 0}

    def relay_fault(_op: str):
        if flap["left"] <= 0:
            sched.relay_fault_fn = None
            return None
        flap["left"] -= 1
        flap["failed"] += 1
        return TransientDeviceError("scripted device flap (soak)")

    def note_new_bindings() -> None:
        for key, p in list(store.pods.items()):
            if p.spec.node_name and key not in bound_seen:
                bound_seen.add(key)
                ns, t0 = p.meta.namespace, created_at.get(key)
                if ns in bound and t0 is not None:
                    bound[ns] += 1
                    waits[ns].append(clock() - t0)
                    soak_bound[ns].append(key)

    def check() -> None:
        if quota is not None:
            out["oversubscription"] += quota_oversubscription(quota, tenants)
        out["checks"] += 1

    def after() -> None:
        out["breaker"].append(STATE_VALUES.get(getattr(breaker, "state", None), -1))
        note_new_bindings()
        check()
        on_cycle()

    degraded0 = sched.smetrics.degraded_seconds.labels()
    tick = _ticker(clock, tick_s)
    for r in range(rounds):
        for key in arrive(r):
            created_at[key] = clock()
        if r == flap_round:
            flap["left"] = flap_batches
            sched.relay_fault_fn = relay_fault
        out["cycles"] += run_cycles(sched, cycle, cycles_per_round, tick, after)
        if churn_frac > 0.0:
            _churn(store, soak_bound, churn_frac)
            note_new_bindings()
            check()
        out["rounds"].append({ns: quota.usage(ns) for ns in tenants} if quota is not None
                             else {})
    _land(sched)
    note_new_bindings()
    check()
    out.update(bound=bound, waits=waits,
               degraded_s=sched.smetrics.degraded_seconds.labels() - degraded0,
               breaker_state=STATE_VALUES.get(getattr(breaker, "state", None), -1),
               flap_batches=flap["failed"],
               comparer_checks=getattr(sched, "comparer_checks", 0),
               comparer_mismatches=getattr(sched, "comparer_mismatches", 0))
    return out


def borrow_loop(store, sched, quota, clock, rounds: int, arrive: Callable[[int], List[str]],
                tenants: Sequence[str], pool: Sequence[str], cycle: Callable[[], bool],
                cycles_per_round: int, tick_s: float = 0.0, burst_round: int = -1,
                on_cycle: Callable[[], None] = lambda: None) -> dict:
    """The borrow phase (``kubernetes_tpu/perf/harness.py:999-1150``).
    Each round: the arrivals, then up to ``cycles_per_round`` cycles, after
    each the new binds noted and the invariants sampled over the ``pool``
    namespaces (nothing without a ledger ``quota``). The latency ledger,
    when on, feeds ``sched.smetrics.tenant_e2e_duration``.

    Returns ``invariants`` (``PoolUtilizationMean`` / ``Peak``: the pool's
    used pods over its summed caps per sample; ``LoansOutstandingPeak``;
    ``Reclaims``: reclaim passes that evicted; ``OversubscriptionViolations``
    over every sample, borrow-aware as ``quota_oversubscription``;
    ``BurstRound``), ``tenants`` (per namespace ``Admitted``,
    ``BorrowedPeak``, ``E2eP50`` / ``E2eP99`` / ``E2eCount`` of
    ``tenant_e2e_duration`` over the phase: exact quantiles on the port,
    bucket estimates on the JAX registry) and ``cycles``."""
    tenants, pool = list(tenants), list(pool)
    hist = sched.smetrics.tenant_e2e_duration
    snaps = {ns: hist.snapshot(ns) for ns in tenants}
    admitted = dict.fromkeys(tenants, 0)
    borrowed_peak = dict.fromkeys(list(tenants) + pool, 0)
    bound_seen = {k for k, p in store.pods.items() if p.spec.node_name}
    reclaims0 = quota.reclaims_executed if quota is not None else 0
    util: List[float] = []
    state = {"loans_peak": 0, "oversub": 0}

    def note_new_bindings() -> None:
        for key, p in list(store.pods.items()):
            if p.spec.node_name and key not in bound_seen:
                bound_seen.add(key)
                if p.meta.namespace in admitted:
                    admitted[p.meta.namespace] += 1

    def sample() -> None:
        if quota is None:
            return
        cap = used = loans = 0
        for ns in pool:
            hard = quota.effective_hard(ns)
            if not hard:
                continue
            ns_loans = quota.borrowed(ns).get("pods", 0)
            cap += hard.get("pods", 0)
            used += quota.usage(ns).get("pods", 0)
            loans += ns_loans
            borrowed_peak[ns] = max(borrowed_peak[ns], ns_loans)
        state["oversub"] += quota_oversubscription(quota, pool)
        state["loans_peak"] = max(state["loans_peak"], loans)
        if cap:
            util.append(used / cap)

    def after() -> None:
        note_new_bindings()
        sample()
        on_cycle()

    tick = _ticker(clock, tick_s)
    cycles = 0
    for r in range(rounds):
        arrive(r)
        cycles += run_cycles(sched, cycle, cycles_per_round, tick, after)
    _land(sched)
    note_new_bindings()
    sample()
    return {
        "invariants": {
            "PoolUtilizationMean": sum(util) / len(util) if util else 0.0,
            "PoolUtilizationPeak": max(util) if util else 0.0,
            "LoansOutstandingPeak": float(state["loans_peak"]),
            "Reclaims": float(quota.reclaims_executed - reclaims0 if quota is not None else 0),
            "OversubscriptionViolations": float(state["oversub"]),
            "BurstRound": float(burst_round),
        },
        "tenants": {ns: {"Admitted": float(admitted[ns]),
                         "BorrowedPeak": float(borrowed_peak[ns]),
                         "E2eP50": hist.percentile_since(snaps[ns], 0.50, ns),
                         "E2eP99": hist.percentile_since(snaps[ns], 0.99, ns),
                         "E2eCount": float(hist.count_since(snaps[ns], ns))}
                    for ns in tenants},
        "cycles": cycles,
    }


def replay_loop(store, sched, clock, rounds: int, arrive: Callable[[int], List[str]],
                tenants: Sequence[str], cycle: Callable[[], bool], cycles_per_round: int,
                score: Callable[[], Optional[dict]], rebalancer=None, tick_s: float = 0.0,
                churn_frac: float = 0.0, on_cycle: Callable[[], None] = lambda: None) -> dict:
    """The replay phase (``kubernetes_tpu/perf/harness.py:1152-1330``).
    Each round: the arrivals; then up to ``cycles_per_round`` cycles, after
    each the new binds noted and ``rebalancer`` (None for none) ticked,
    until a cycle makes no progress and, after a backoff flush, the queue is
    empty and no wave waits to reopen its nodes; then, with
    ``churn_frac``, that share of each tenant's phase-bound pods leaves;
    then ``score()``, the packing score of the host snapshot (None for
    none). Then the ring is landed and up to ``cycles_per_round`` more
    cycles complete the waves (no new one). The latency ledger, when on,
    feeds ``tenant_e2e_duration``.

    Returns ``invariants`` (the JAX ReplayInvariants: ``PackingEff``, one
    minus the mean entropy over the second half of the rounds;
    ``FinalEntropy``, ``FinalFrag``; ``TenantP99Max``, the largest tenant
    p99 as the JAX registry estimates it, ``Histogram.estimate_since`` on
    the port; ``Waves``, ``Migrations``, ``Suspended``,
    ``PendingUncordons``, ``PendingAtEnd``), ``tenants`` (per namespace
    ``Weight``, ``E2eP50`` / ``E2eP99`` (``percentile_since``: exact on the
    port, bucket estimates on the JAX registry) and ``E2eCount``),
    ``waves`` (per wave: when, its nodes, pods evicted, gangs, entropy),
    ``entropies`` (per round), ``cycles`` and ``score_s`` (the wall seconds
    of each of the rebalancer's scores, when it records them)."""
    tenants = list(tenants)
    rb = rebalancer
    hist = sched.smetrics.tenant_e2e_duration
    snaps = {ns: hist.snapshot(ns) for ns in tenants}
    bound_seen = {k for k, p in store.pods.items() if p.spec.node_name}
    replay_bound: Dict[str, List[str]] = {ns: [] for ns in tenants}
    entropies: List[float] = []

    def note_new_bindings() -> None:
        for key, p in list(store.pods.items()):
            if p.spec.node_name and key not in bound_seen:
                bound_seen.add(key)
                if p.meta.namespace in replay_bound:
                    replay_bound[p.meta.namespace].append(key)

    def after_round_cycle() -> None:
        note_new_bindings()
        if rb is not None:
            rb.maybe_run(clock())
        on_cycle()

    def after_tail_cycle() -> None:
        note_new_bindings()
        if rb is not None:
            rb.drain.poll_pending_uncordons()
        on_cycle()

    def idle() -> bool:
        return rb is None or not rb.drain.pending_uncordons

    tick = _ticker(clock, tick_s)
    cycles = 0
    for r in range(rounds):
        arrive(r)
        cycles += run_cycles(sched, cycle, cycles_per_round, tick, after_round_cycle, idle)
        if churn_frac > 0.0:
            _churn(store, replay_bound, churn_frac)
            note_new_bindings()
        sample = score()
        if sample is not None:
            entropies.append(sample["entropy"])
    _land(sched)
    # the trace is over: the waves in flight complete, no new one starts
    cycles += run_cycles(sched, cycle, cycles_per_round, tick, after_tail_cycle, idle)
    note_new_bindings()
    final = score() or {"entropy": 0.0, "frag_max": 0.0}
    steady = entropies[len(entropies) // 2:] or [final["entropy"]]
    estimate = getattr(hist, "estimate_since", None) or hist.percentile_since
    p99s = [estimate(snaps[ns], 0.99, ns) for ns in tenants if hist.count_since(snaps[ns], ns)]
    quota_of = getattr(sched, "_quota_plugin", None)
    quota = quota_of() if quota_of is not None else None
    pending = sched.queue.pending_pods()
    return {
        "invariants": {
            "PackingEff": float(1.0 - sum(steady) / len(steady)),
            "FinalEntropy": float(final["entropy"]),
            "FinalFrag": float(final["frag_max"]),
            "TenantP99Max": float(max(p99s, default=0.0)),
            "Waves": float(rb.waves_executed if rb is not None else 0.0),
            "Migrations": float(rb.migrations if rb is not None else 0.0),
            "Suspended": float(1.0 if rb is not None and rb.suspended else 0.0),
            "PendingUncordons": float(len(rb.drain.pending_uncordons) if rb is not None
                                      else 0.0),
            "PendingAtEnd": float(sum(pending.values())),
        },
        "tenants": {ns: {"Weight": float((quota.weight_for(ns) if quota is not None else None)
                                         or 0.0),
                         "E2eP50": hist.percentile_since(snaps[ns], 0.50, ns),
                         "E2eP99": hist.percentile_since(snaps[ns], 0.99, ns),
                         "E2eCount": float(hist.count_since(snaps[ns], ns))}
                    for ns in tenants},
        "waves": [{"at": wv["at"], "nodes": list(wv["nodes"]), "evicted": wv["evicted"],
                   "gangs": wv["gangs"], "entropy": wv["entropy"]}
                  for wv in (rb.last_waves if rb is not None else ())],
        "entropies": entropies,
        "cycles": cycles,
        "score_s": list(getattr(rb, "score_seconds", ())),
    }


def elastic_loop(store, sched, clock, rounds: int, arrive: Callable[[int], List[str]],
                 cycle: Callable[[], bool], cycles_per_round: int, drain,
                 add_nodes: Callable[[int], None], device_state: Callable[[], object],
                 tick_s: float = 0.0, storm_frac: float = 0.0, drain_nodes: int = 0,
                 spot_frac: float = 0.0, settle_rounds: int = 1,
                 on_cycle: Callable[[], None] = lambda: None) -> dict:
    """The elastic phase (``kubernetes_tpu/perf/harness.py:1332-1517``),
    evicting through ``drain``, a DrainOrchestrator of the store's package.
    Each round: the arrivals; up to ``cycles_per_round`` cycles until a
    cycle makes no progress and the queue is empty after a backoff flush;
    the round's chaos step in turn (a storm: ``storm_frac`` of the live
    nodes drained, deleted and replaced through ``add_nodes(count)``; a
    rolling drain of the last ``drain_nodes``, uncordoned at the next; a
    spot reclamation of ``spot_frac``, replaced); the cycles again; an
    oversubscription check. Then every cordon is lifted,
    ``settle_rounds`` drives settle the loop, the ring is landed, and two
    syncs of the settled snapshot through ``device_state()`` (the loop's
    DeviceState, None for none) measure the upload of the second.

    Returns ``invariants`` (the JAX ElasticInvariants: ``LostPods``,
    ``Oversubscribed``, ``RowCapacity`` (the mirror's node axis),
    ``SlotReuses``, ``NodesRemoved``, ``NodesAdded``, ``EvictedPods``,
    ``UploadBytesSteady``, ``HbmPeakBytes`` (the port's device telemetry's
    peak: 0 with it off, and on the CPU), ``PendingAtEnd``), ``evicted``
    (pods evicted by reason), ``nodes`` (the live node names at the end)
    and ``cycles``."""
    from ..backend import telemetry

    m = sched.smetrics
    reasons = ("drain", "spot", "taint")
    reuse0 = m.device_slot_reuse.labels()
    evict0 = {r: m.evicted_pods.labels(r) for r in reasons}
    created: set = set()
    state = {"cycles": 0, "added": 0, "removed": 0, "oversub": 0}
    cordoned: List[str] = []
    tick = _ticker(clock, tick_s)

    def drive_round() -> None:
        state["cycles"] += run_cycles(sched, cycle, cycles_per_round, tick, on_cycle)

    def replace(count: int) -> None:
        state["removed"] += count
        add_nodes(count)
        state["added"] += count

    for r in range(rounds):
        created.update(arrive(r))
        drive_round()
        live = sorted(store.nodes)
        phase = r % 3
        if phase == 0 and storm_frac > 0:
            storm = live[:max(1, int(len(live) * storm_frac))]
            drain.drain_wave(storm)
            for name in storm:
                store.delete_node(name)
            replace(len(storm))
        elif phase == 1 and drain_nodes > 0:
            for name in cordoned:
                drain.uncordon(name)
            cordoned = live[-drain_nodes:]
            drain.drain_wave(cordoned)
        elif phase == 2 and spot_frac > 0:
            spot = live[:max(1, int(len(live) * spot_frac))]
            drain.spot_reclaim(spot, delete_nodes=True)
            replace(len(spot))
        drive_round()
        state["oversub"] += elastic_oversubscribed(store)
    for name in cordoned:
        drain.uncordon(name)
    for name in sorted(store.nodes):
        drain.uncordon(name)
    for _s in range(max(settle_rounds, 1)):
        drive_round()
    _land(sched)
    state["oversub"] += elastic_oversubscribed(store)
    ds = device_state()
    upload_steady = None
    if ds is not None:
        # the second sync of a settled snapshot uploads nothing
        for _ in range(2):
            sched.cache.update_snapshot(sched.snapshot)
            ds.sync(sched.snapshot)
        upload_steady = ds.last_upload_bytes
    rec = telemetry.get()
    return {
        "invariants": {
            "LostPods": float(sum(1 for k in created if store.get_pod(k) is None)),
            "Oversubscribed": float(state["oversub"]),
            "RowCapacity": float(ds.caps.nodes) if ds is not None else 0.0,
            "SlotReuses": float(m.device_slot_reuse.labels() - reuse0),
            "NodesRemoved": float(state["removed"]),
            "NodesAdded": float(state["added"]),
            "EvictedPods": float(sum(m.evicted_pods.labels(r) - evict0[r] for r in reasons)),
            "UploadBytesSteady": float(upload_steady if upload_steady is not None else -1),
            "HbmPeakBytes": float(rec.hbm_peak if rec is not None else 0),
            "PendingAtEnd": float(sum(sched.queue.pending_pods().values())),
        },
        "evicted": {r: m.evicted_pods.labels(r) - evict0[r] for r in reasons},
        "nodes": sorted(store.nodes),
        "cycles": state["cycles"],
    }
