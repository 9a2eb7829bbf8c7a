"""QuotaAdmission, the scheduler-side namespace quota over SchedulingQuota.

The port's own copy of ``kubernetes_tpu/framework/plugins/quota.py``,
trimmed to what the batch path reads. A namespace's SchedulingQuota caps
what the scheduler admits (assumed and bound pods), per dimension of
``QUOTA_DIM_ORDER``:

  * PreFilter (``pre_filter``): the host gate before encode. An over-quota
    pod is UnschedulableAndUnresolvable: evicting pods from nodes cannot
    raise a namespace's quota, so it takes no batch row and never preempts;
  * Reserve (``reserve``): the authoritative charge, in batch order at
    bind; ``unreserve`` and ``pod_deleted`` release it;
  * ``device_quota_table``: the ledger as the [NS, Q] used / limit rows the
    device screen (``ops/quota.py``) judges a batch's winners against.

Gangs are priced whole: a member's fits check prices the gang's members
not yet charged (``min_member`` less the charged count), so a PodGroup
whose tail cannot fit never charges its head. Quotas that share a
``cohort`` lend their unused guaranteed headroom: a namespace over its own
caps may still admit by borrowing from the pool (a loan), unless a lender
of the pool, blocked only by loans, has recorded reclaim demand. The pool's
cap per dimension is the sum of its members' caps, and its usage sums the
same members, loans included.

The ledger is seeded per namespace on first touch from the pods bound in
the caller's cluster (``bound_pods_fn``; the JAX plugin reads its store's
pods), in pod-key order, each charge classified own-quota first.

The scheduler loop's half (``:284-288``, ``:525-559``, ``:576-800``):

  * PreEnqueue (``pre_enqueue``): the queue's admission gate, the
    fits check again;
  * ``weight_for``: a namespace's fair-share weight (the largest of its
    quotas'), None for a namespace without quota;
  * a release (``unreserve``, ``pod_deleted``) calls ``on_release(ns)``
    for the namespace and every other member of its pool: the loop's
    targeted release move, gated by ``shadow_admitter(ns)``, which charges
    a shadow copy of the ledger so one freed slot admits one pod;
  * ``pod_observed_bound``: a pod bound outside Reserve is charged;
  * ``run_reclaim`` (from the loop's 1 s sweep): for a pool whose
    recorded lender demand does not fit, evict its loans newest first
    through ``on_evict(pods, reason)`` (the loop's gang-closure eviction)
    until it fits, at most once per ``DEFAULT_RECLAIM_COOLDOWN_S`` per pool unless
    new demand arrived. An SLO breaker (``:176-185``, ``:602-638``) guards
    the pass: ``reclaim_guard_fn``, judged after each wave that evicted,
    returns False for a lender-SLO regression, which counts against
    ``reclaim_breaker`` (threshold ``RECLAIM_BREAKER_THRESHOLD``, reset
    ``RECLAIM_BREAKER_RESET_S``); while it is open the pass is suspended
    (``reclaim_suspended``, the ``suspended`` outcome of
    ``quota_reclaims``), and a clean wave after its half-open probe heals
    it. Without a guard function it never opens;
  * the gauges ``quota_usage`` and ``quota_borrowed`` on ``metrics``;
  * ``dump``: the ledger per namespace and per pool, with the reclaim
    breaker's state;
  * ``share_ledger``: a second profile's instance charges and reads the
    first's ledger;
  * flight events (``backend/telemetry.py``; ``:516``, ``:611``,
    ``:624``): ``borrow_grant`` per loan, ``borrow_reclaim`` per reclaim
    wave, ``reclaim_suspended`` when the breaker suspends the pass.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import time

from ...api import resource as resource_api
from ...api.types import (QUOTA_CLAIMS, QUOTA_CPU, QUOTA_DIM_ORDER, QUOTA_MEMORY, QUOTA_PODS,
                          Pod, SchedulingQuota)
from ...backend import telemetry
from ...backend.circuit import OPEN, CircuitBreaker
from ..types import ALL, SCHEDULING_QUOTA, ClusterEvent
from ..interface import Fail
from .coscheduling import pod_group_key

NAME = "QuotaAdmission"
ERR_REASON_QUOTA_EXCEEDED = "QuotaExceeded"
DEFAULT_RECLAIM_COOLDOWN_S = 5.0
# the reclaim pass's SLO breaker: open after this many waves the guard
# judged regressions, probed again after the reset
RECLAIM_BREAKER_THRESHOLD = 2
RECLAIM_BREAKER_RESET_S = 30.0

# int32 ceiling of the device table's rows (ops/quota.py QUOTA_NO_LIMIT)
_NO_LIMIT = 2**31 - 1

Request = Dict[str, int]


def pod_quota_request(pod: Pod) -> Request:
    """The SchedulingQuota dimensions one pod consumes: its cpu and memory
    request (canonical ints), one pod slot and its claim count."""
    req = pod.resource_request()
    return {
        QUOTA_PODS: 1,
        QUOTA_CPU: req.get(resource_api.CPU, 0),
        QUOTA_MEMORY: req.get(resource_api.MEMORY, 0),
        QUOTA_CLAIMS: len(pod.spec.resource_claims),
    }


class Refusal(str):
    """A refusal reason that names its plugin, as the queue's gate reads it."""

    plugin = NAME


class QuotaAdmission:
    """``client`` is the object store the SchedulingQuotas and PodGroups
    live in; ``bound_pods_fn`` lists the pods bound in the cluster;
    ``now_fn`` is the reclaim breaker's clock."""

    def __init__(self, client, bound_pods_fn: Callable[[], Iterable[Pod]], metrics=None,
                 now_fn: Optional[Callable[[], float]] = None):
        self.client = client
        self.bound_pods_fn = bound_pods_fn
        self.metrics = metrics
        # the loop's hooks: the targeted release move, fn(ns), and the
        # gang-closure eviction of the reclaim pass, fn(pods, reason) -> n
        self.on_release: Optional[Callable[[str], int]] = None
        self.on_evict: Optional[Callable[[List[Pod], str], int]] = None
        # the SLO guard, judged after each wave that evicted: False is a
        # lender-SLO regression and counts against the breaker
        self.reclaim_guard_fn: Optional[Callable[[], bool]] = None
        self.reclaim_breaker = CircuitBreaker(
            failure_threshold=RECLAIM_BREAKER_THRESHOLD,
            reset_timeout_s=RECLAIM_BREAKER_RESET_S, now_fn=now_fn or time.monotonic)
        self.reclaim_suspended = False
        self.reclaims_executed = 0
        self._last_reclaim: Dict[str, float] = {}  # cohort -> time of its last pass
        self._demand_fresh: Set[str] = set()       # cohorts with demand since their pass
        self._usage: Dict[str, Request] = {}     # ns -> charged usage, loans included
        self._charged: Dict[str, Tuple[str, Request]] = {}  # pod key -> (ns, charge)
        self._seeded: Set[str] = set()
        self._borrowed: Dict[str, Request] = {}  # ns -> the loan part of _usage
        self._loans: Dict[str, Tuple[str, Request, int]] = {}  # pod key -> (ns, charge, seq)
        # boxed, so that a profile's instance that shares this ledger
        # (``share_ledger``) numbers its loans in the same sequence
        self._loan_seq: Dict[str, int] = {"n": 0}
        self._gang_counts: Dict[str, int] = {}   # gang key -> charged members
        self._gang_charged: Dict[str, str] = {}  # pod key -> gang key
        # cohort -> pod key -> priced request: a lender's demand, blocked
        # only by loans, that freezes new loans in the pool
        self._reclaim_demand: Dict[str, Dict[str, Request]] = {}
        self._demand_pods: Dict[str, str] = {}   # pod key -> cohort
        self._quota_index: Optional[Dict[str, List[SchedulingQuota]]] = None
        self._cohort_index: Dict[str, List[str]] = {}
        self._index_version = -1
        self._derived: Dict[str, Tuple[Optional[Request], Optional[float], Optional[str]]] = {}

    @staticmethod
    def events_to_register() -> List[ClusterEvent]:
        return [ClusterEvent(SCHEDULING_QUOTA, ALL, "SchedulingQuotaChange")]

    # ------------------------------------------------------------- quota view

    def _quota_map(self) -> Dict[str, SchedulingQuota]:
        return self.client.scheduling_quotas if self.client is not None else {}

    def _index(self) -> Dict[str, List[SchedulingQuota]]:
        """The namespace and cohort index over the store's quotas, rebuilt
        whenever a SchedulingQuota was created or updated since (the JAX
        plugin rebuilds on the store's SchedulingQuota events)."""
        m = self._quota_map()
        version = self.client.kind_version("SchedulingQuota") if self.client is not None else 0
        if self._quota_index is None or version != self._index_version:
            idx: Dict[str, List[SchedulingQuota]] = {}
            cidx: Dict[str, List[str]] = {}
            for q in m.values():
                idx.setdefault(q.meta.namespace, []).append(q)
            for ns, quotas in idx.items():
                for q in quotas:
                    if q.cohort:
                        members = cidx.setdefault(q.cohort, [])
                        if ns not in members:
                            members.append(ns)
                        break
            self._quota_index = idx
            self._cohort_index = cidx
            self._index_version = version
            self._derived.clear()
        return self._quota_index

    def _derived_for(self, ns: str) -> Tuple[Optional[Request], Optional[float], Optional[str]]:
        self._index()
        d = self._derived.get(ns)
        if d is None:
            quotas = self._index().get(ns, [])
            d = (None, None, None)
            if quotas:
                hard: Request = {}
                cohort: Optional[str] = None
                for q in quotas:
                    for dim, cap in q.hard.items():
                        hard[dim] = min(hard[dim], cap) if dim in hard else cap
                    if cohort is None and q.cohort:
                        cohort = q.cohort
                d = (hard, float(max(q.weight for q in quotas)), cohort)
            self._derived[ns] = d
        return d

    def effective_hard(self, ns: str) -> Optional[Request]:
        """Per-dimension caps (the minimum over the namespace's quotas), or
        None when it has no SchedulingQuota: unlimited."""
        return self._derived_for(ns)[0]

    def weight_for(self, ns: str) -> Optional[float]:
        """The namespace's fair-share weight, or None: not a tenant."""
        return self._derived_for(ns)[1]

    def cohort_for(self, ns: str) -> Optional[str]:
        return self._derived_for(ns)[2]

    def cohort_members(self, cohort: str) -> List[str]:
        self._index()
        return list(self._cohort_index.get(cohort, []))

    # ---------------------------------------------------------------- ledger

    def _ensure_seeded(self, ns: str) -> None:
        """First touch of a namespace: charge its bound pods, in key order."""
        if ns in self._seeded:
            return
        self._seeded.add(ns)
        bound = [p for p in self.bound_pods_fn() if p.meta.namespace == ns]
        for pod in sorted(bound, key=lambda p: p.key()):
            self._charge(pod)

    def usage(self, ns: str) -> Request:
        self._ensure_seeded(ns)
        return dict(self._usage.get(ns, {}))

    def borrowed(self, ns: str) -> Request:
        """The part of ``usage(ns)`` charged against cohort headroom."""
        self._ensure_seeded(ns)
        return dict(self._borrowed.get(ns, {}))

    @staticmethod
    def _violated(hard: Request, used: Request, req: Request) -> Optional[str]:
        for dim, cap in hard.items():
            if used.get(dim, 0) + req.get(dim, 0) > cap:
                return dim
        return None

    def cohort_state(self, cohort: str) -> Tuple[Request, Request]:
        """(caps, used) of a pool per dimension, over the members that
        declare the dimension."""
        caps: Request = {}
        used: Request = {}
        for ns in self.cohort_members(cohort):
            hard = self.effective_hard(ns)
            if hard is None:
                continue
            self._ensure_seeded(ns)
            ns_used = self._usage.get(ns, {})
            for dim, cap in hard.items():
                caps[dim] = caps.get(dim, 0) + cap
                used[dim] = used.get(dim, 0) + ns_used.get(dim, 0)
        return caps, used

    def _cohort_violated(self, cohort: str, req: Request) -> Optional[str]:
        caps, used = self.cohort_state(cohort)
        return self._violated(caps, used, req)

    def cohort_headroom(self, cohort: str) -> Request:
        caps, used = self.cohort_state(cohort)
        return {dim: max(cap - used.get(dim, 0), 0) for dim, cap in caps.items()}

    def _gang_remaining(self, pod: Pod) -> int:
        """How many members the fits check prices: a gang's members not
        yet charged (at least 1); 1 for a pod outside a gang."""
        gkey = pod_group_key(pod)
        if gkey is None or self.client is None:
            return 1
        pg = self.client.get_object("PodGroup", gkey)
        if pg is None:
            return 1
        return max(int(pg.min_member) - self._gang_counts.get(gkey, 0), 1)

    def _fits(self, pod: Pod) -> Optional[str]:
        """None when the pod fits its namespace's headroom (or is charged
        already, or its namespace has no quota), else the reason. A lender
        that fits its own caps but finds its pool exhausted records reclaim
        demand; a borrower is refused while such demand is outstanding."""
        ns = pod.meta.namespace
        hard = self.effective_hard(ns)
        if hard is None or pod.key() in self._charged:
            return None
        self._ensure_seeded(ns)
        mult = self._gang_remaining(pod)
        req = pod_quota_request(pod)
        if mult != 1:
            req = {d: v * mult for d, v in req.items()}
        used = self._usage.get(ns, {})
        cohort = self.cohort_for(ns)
        dim = self._violated(hard, used, req)
        if dim is None:
            if cohort is not None:
                cdim = self._cohort_violated(cohort, req)
                if cdim is not None:
                    self._note_reclaim_demand(cohort, pod, req)
                    return _reason(ns, "cohort exhausted by loans", cdim)
            self._drop_demand(pod.key())
            return None
        if (cohort is not None and not self._reclaim_demand.get(cohort)
                and self._cohort_violated(cohort, req) is None):
            self._drop_demand(pod.key())
            return None
        return _reason(ns, "over quota", dim)

    def _charge(self, pod: Pod) -> bool:
        """Charge one pod: a loan when it does not fit its namespace's own
        caps and the namespace is in a cohort, else own quota."""
        key = pod.key()
        if key in self._charged:
            return False
        ns = pod.meta.namespace
        req = pod_quota_request(pod)
        hard = self.effective_hard(ns)
        loan = (hard is not None and self.cohort_for(ns) is not None
                and self._violated(hard, self._usage.get(ns, {}), req) is not None)
        used = self._usage.setdefault(ns, {})
        for dim, v in req.items():
            used[dim] = used.get(dim, 0) + v
        self._charged[key] = (ns, req)
        gkey = pod_group_key(pod)
        if gkey is not None:
            self._gang_charged[key] = gkey
            self._gang_counts[gkey] = self._gang_counts.get(gkey, 0) + 1
        if loan:
            b = self._borrowed.setdefault(ns, {})
            for dim, v in req.items():
                b[dim] = b.get(dim, 0) + v
            self._loan_seq["n"] += 1
            self._loans[key] = (ns, req, self._loan_seq["n"])
            telemetry.event("borrow_grant", pod=key, namespace=ns,
                            cohort=self.cohort_for(ns) or "")
        self._drop_demand(key)
        self._sync_metrics(ns)
        return True

    def _release(self, pod_key: str) -> Optional[str]:
        """Release a pod's charge; returns its namespace, or None when it
        held none."""
        entry = self._charged.pop(pod_key, None)
        if entry is None:
            return None
        ns, req = entry
        used = self._usage.setdefault(ns, {})
        for dim, v in req.items():
            used[dim] = max(used.get(dim, 0) - v, 0)
        gkey = self._gang_charged.pop(pod_key, None)
        if gkey is not None:
            n = self._gang_counts.get(gkey, 0) - 1
            if n > 0:
                self._gang_counts[gkey] = n
            else:
                self._gang_counts.pop(gkey, None)
        if self._loans.pop(pod_key, None) is not None:
            b = self._borrowed.setdefault(ns, {})
            for dim, v in req.items():
                b[dim] = max(b.get(dim, 0) - v, 0)
        self._sync_metrics(ns)
        return ns

    def _sync_metrics(self, ns: str) -> None:
        if self.metrics is None:
            return
        used = self._usage.get(ns, {})
        borrowed = self._borrowed.get(ns, {})
        for dim in (QUOTA_PODS, QUOTA_CPU, QUOTA_MEMORY, QUOTA_CLAIMS):
            self.metrics.quota_usage.set(ns, dim, value=used.get(dim, 0))
            self.metrics.quota_borrowed.set(ns, dim, value=borrowed.get(dim, 0))

    def _note_reclaim_demand(self, cohort: str, pod: Pod, req: Request) -> None:
        if pod.key() not in self._demand_pods:
            self._demand_fresh.add(cohort)
        self._reclaim_demand.setdefault(cohort, {})[pod.key()] = dict(req)
        self._demand_pods[pod.key()] = cohort

    def _drop_demand(self, pod_key: str) -> None:
        cohort = self._demand_pods.pop(pod_key, None)
        if cohort is not None:
            demands = self._reclaim_demand.get(cohort)
            if demands is not None:
                demands.pop(pod_key, None)
                if not demands:
                    self._reclaim_demand.pop(cohort, None)

    # ------------------------------------------------------- extension points

    def name(self) -> str:
        return NAME

    def pre_filter(self, state, pod: Pod):
        """(None, None) when the pod may take a batch row, else (None, the
        unresolvable failure)."""
        reason = self._fits(pod)
        return None, (None if reason is None else Fail(NAME, reason, True))

    def reserve(self, state, pod: Pod, node_name: str) -> Optional[str]:
        """The authoritative charge: None when charged (or unquota'd), else
        the reason it was refused."""
        if self.effective_hard(pod.meta.namespace) is None:
            return None
        reason = self._fits(pod)
        if reason is None:
            self._charge(pod)
        return reason

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        ns = self._release(pod.key())
        if ns is not None:
            self._fire_release(ns)

    def share_ledger(self, other: "QuotaAdmission") -> None:
        """Alias this instance's ledger onto ``other``'s (``quota.py:297``):
        usage is cluster state, so every profile's instance charges and
        reads one ledger."""
        for attr in ("_usage", "_charged", "_seeded", "_borrowed", "_loans", "_loan_seq",
                     "_gang_counts", "_gang_charged", "_reclaim_demand", "_demand_pods",
                     "_last_reclaim", "_demand_fresh"):
            setattr(self, attr, getattr(other, attr))

    def pod_deleted(self, pod: Pod) -> None:
        self._drop_demand(pod.key())
        ns = self._release(pod.key())
        if ns is not None:
            self._fire_release(ns)

    def pod_observed_bound(self, pod: Pod) -> None:
        """A pod bound outside this scheduler's Reserve is charged too."""
        if self.effective_hard(pod.meta.namespace) is None:
            return
        self._ensure_seeded(pod.meta.namespace)
        self._charge(pod)

    def pre_enqueue(self, pod: Pod) -> Optional[Refusal]:
        """The PreEnqueue gate: None to admit, else the refusal."""
        reason = self._fits(pod)
        return None if reason is None else Refusal(reason)

    # ---------------------------------------------------------- release waves

    def _fire_release(self, ns: str) -> None:
        """Freed headroom in ``ns`` wakes its gated pods, and, as pool
        headroom, every other member's of its cohort."""
        if self.on_release is None:
            return
        if self._index().get(ns):
            self.on_release(ns)
        cohort = self.cohort_for(ns)
        if cohort:
            for member in self.cohort_members(cohort):
                if member != ns and self._index().get(member):
                    self.on_release(member)

    def shadow_admitter(self, ns: str) -> Callable[[Pod], Optional[Refusal]]:
        """The gate of one release wave: each admitted pod charges a shadow
        copy of the namespace's usage (and of its pool's), so one freed
        slot admits one gated pod, not the whole parked backlog."""
        self._ensure_seeded(ns)
        shadow = dict(self._usage.get(ns, {}))
        hard = self.effective_hard(ns)
        cohort = self.cohort_for(ns)
        ccaps, cshadow = {}, {}
        if cohort is not None:
            ccaps, cused = self.cohort_state(cohort)
            cshadow = dict(cused)

        def admit(pod: Pod) -> Optional[Refusal]:
            if hard is None or pod.meta.namespace != ns:
                return self.pre_enqueue(pod)
            req = pod_quota_request(pod)
            dim = self._violated(hard, shadow, req)
            cdim = self._violated(ccaps, cshadow, req) if cohort is not None else None
            if dim is not None and cohort is not None and self._reclaim_demand.get(cohort):
                cdim = cdim or dim  # lender demand freezes new loans
            if dim is not None and (cohort is None or cdim is not None):
                return Refusal(_reason(ns, "over quota", dim))
            if dim is None and cdim is not None:
                return Refusal(_reason(ns, "cohort exhausted by loans", cdim))
            for d, v in req.items():
                shadow[d] = shadow.get(d, 0) + v
                if cohort is not None:
                    cshadow[d] = cshadow.get(d, 0) + v
            return None

        return admit

    # ---------------------------------------------------------------- reclaim

    def run_reclaim(self, now: float) -> int:
        """The reclaim pass: for every pool whose recorded lender demand,
        summed, does not fit, evict its loans newest first until it does
        (``_reclaim_cohort``); a pool is passed over within the cooldown of
        its last pass unless new demand arrived, and every pool is passed
        over while the SLO breaker is open. Returns pods evicted."""
        if self.on_evict is None or not self._reclaim_demand:
            return 0
        evicted_total = 0
        for cohort in list(self._reclaim_demand):
            live = self._live_demand(cohort)
            if not live:
                continue
            agg: Request = {}
            for r in live.values():
                for d, v in r.items():
                    agg[d] = agg.get(d, 0) + v
            if self._cohort_violated(cohort, agg) is None:
                continue
            last = self._last_reclaim.get(cohort)
            if (last is not None and now - last < DEFAULT_RECLAIM_COOLDOWN_S
                    and cohort not in self._demand_fresh):
                continue
            if not self.reclaim_breaker.allow():
                if not self.reclaim_suspended:
                    self.reclaim_suspended = True
                    telemetry.event("reclaim_suspended", cohort=cohort,
                                    breaker=self.reclaim_breaker.state)
                    if self.metrics is not None:
                        self.metrics.quota_reclaims.inc("suspended")
                continue
            self.reclaim_suspended = False
            self._last_reclaim[cohort] = now
            self._demand_fresh.discard(cohort)
            n = self._reclaim_cohort(cohort, agg)
            evicted_total += n
            telemetry.event("borrow_reclaim", cohort=cohort, evicted=n, demands=len(live))
            if self.metrics is not None:
                self.metrics.quota_reclaims.inc("evicted" if n else "noop")
            if n:
                self.reclaims_executed += 1
                # a judged regression counts against the breaker; a clean
                # wave heals it (an open breaker only through its probe)
                if self.reclaim_guard_fn is not None and not self.reclaim_guard_fn():
                    self.reclaim_breaker.record_failure()
                elif self.reclaim_breaker.state != OPEN:
                    self.reclaim_breaker.record_success()
        return evicted_total

    def _live_demand(self, cohort: str) -> Dict[str, Request]:
        """Drop the demands whose pod is gone, bound or charged since."""
        demands = self._reclaim_demand.get(cohort, {})
        pods = getattr(self.client, "pods", {})
        for key in list(demands):
            pod = pods.get(key)
            if pod is None or pod.spec.node_name or key in self._charged:
                demands.pop(key, None)
                self._demand_pods.pop(key, None)
        if not demands:
            self._reclaim_demand.pop(cohort, None)
        return demands

    def _reclaim_cohort(self, cohort: str, agg: Request) -> int:
        """Evict the pool's loans newest first until ``agg`` fits. Each
        eviction deletes through the store, so its release lands here at
        once and the next check sees the freed headroom."""
        evicted = 0
        loans = sorted(((seq, key, ns) for key, (ns, _r, seq) in self._loans.items()
                        if self.cohort_for(ns) == cohort), reverse=True)
        pods = getattr(self.client, "pods", {})
        for _seq, key, _ns in loans:
            if self._cohort_violated(cohort, agg) is None:
                break
            pod = pods.get(key)
            if pod is None:
                # a loan of a pod the store no longer holds
                ns = self._release(key)
                if ns is not None:
                    self._fire_release(ns)
                continue
            evicted += self.on_evict([pod], "quota_reclaim")
        return evicted

    # ----------------------------------------------------------------- debug

    def dump(self) -> dict:
        """The ledger as the JAX plugin's dump (``:839-882``) gives it: per
        namespace its caps, usage, loans, pool, weight and charged pods;
        under ``_cohorts`` per pool its members, guaranteed caps, usage,
        lent amounts, headroom, loans newest first, pending demand and the
        reclaim breaker."""
        out: dict = {}
        for q in list(self._quota_map().values()):
            ns = q.meta.namespace
            out[ns] = {
                "hard": self.effective_hard(ns) or {},
                "used": self.usage(ns),
                "borrowed": self.borrowed(ns),
                "cohort": self.cohort_for(ns) or "",
                "weight": self.weight_for(ns),
                "charged_pods": sum(1 for _k, (n, _r) in self._charged.items() if n == ns),
            }
        cohorts: dict = {}
        self._index()
        for cohort in self._cohort_index:
            caps, used = self.cohort_state(cohort)
            lent: Request = {}
            for ns in self.cohort_members(cohort):
                for dim, v in self._borrowed.get(ns, {}).items():
                    lent[dim] = lent.get(dim, 0) + v
            loans = sorted(((seq, key, ns) for key, (ns, _r, seq) in self._loans.items()
                            if self.cohort_for(ns) == cohort), reverse=True)
            cohorts[cohort] = {
                "members": self.cohort_members(cohort),
                "guaranteed": caps,
                "used": used,
                "lent": lent,
                "headroom": {dim: max(cap - used.get(dim, 0), 0) for dim, cap in caps.items()},
                "loans": [{"pod": key, "namespace": ns, "seq": seq} for seq, key, ns in loans],
                "pending_demand": len(self._reclaim_demand.get(cohort, {})),
                "reclaim_breaker": self.reclaim_breaker.dump(),
                "reclaim_suspended": self.reclaim_suspended,
            }
        if cohorts:
            out["_cohorts"] = cohorts
        return out

    # ----------------------------------------------------------- device view

    def device_quota_table(self) -> Dict[str, Tuple[List[int], List[int]]]:
        """ns -> (used, limit) int rows in QUOTA_DIM_ORDER for the device
        screen. ``limit`` is the namespace's own cap plus its pool's current
        headroom (every member of a pool sees the whole headroom), capped at
        the int32 ceiling; an undeclared dimension never limits."""
        table: Dict[str, Tuple[List[int], List[int]]] = {}
        headroom: Dict[str, Request] = {}
        for ns in list(self._index()):
            hard = self.effective_hard(ns)
            if hard is None:
                continue
            self._ensure_seeded(ns)
            used = self._usage.get(ns, {})
            cohort = self.cohort_for(ns)
            free: Request = {}
            if cohort is not None:
                if cohort not in headroom:
                    headroom[cohort] = self.cohort_headroom(cohort)
                free = headroom[cohort]
            used_row = [min(int(used.get(dim, 0)), _NO_LIMIT) for dim in QUOTA_DIM_ORDER]
            limit_row = [min(int(hard[dim]) + int(free.get(dim, 0)), _NO_LIMIT)
                         if dim in hard else _NO_LIMIT for dim in QUOTA_DIM_ORDER]
            table[ns] = (used_row, limit_row)
        return table


def _reason(ns: str, what: str, dim: str) -> str:
    return f'{ERR_REASON_QUOTA_EXCEEDED}: namespace "{ns}" {what} on {dim}'
