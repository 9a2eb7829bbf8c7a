"""Namespace quota in the port against the JAX package: the device screen,
the namespace rows of DeviceState, the packed block's quota column, the
QuotaAdmission ledger, and BatchScheduler's quota path end to end (small
SchedulingSoak runs included). Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_cases as tc

I32_MAX = 2**31 - 1


# ----------------------------------------------------------------- the screen


def _screen_case(seed: int, regime: str):
    """(node_idx [P], ns_idx [P], req [P, Q], used [NS, Q], limit [NS, Q])
    int32: losers, unscreened and padding rows, runs of one namespace, and
    in the ``ceiling`` regime sums that pass 2**31 - 1."""
    rng = np.random.RandomState(seed)
    p = int(rng.choice([1, 7, 32, 128]))
    ns_n = int(rng.choice([1, 3, 8, 16]))
    node_idx = np.where(rng.uniform(size=p) < 0.2, -1, rng.randint(0, 64, p)).astype(np.int32)
    ns_idx = rng.randint(-1, ns_n, p).astype(np.int32)
    if p > 8:
        ns_idx[2:8] = ns_idx[2]  # a same-namespace run
        ns_idx[-3:] = -1         # padding rows
    if regime == "ceiling":
        used = rng.randint(I32_MAX - 3000, I32_MAX, (ns_n, 4)).astype(np.int32)
        req = rng.randint(0, 2000, (p, 4)).astype(np.int32)
        limit = np.full((ns_n, 4), I32_MAX, np.int32)
        limit[:, 0] = rng.randint(I32_MAX - 2000, I32_MAX, ns_n)
    else:
        used = rng.randint(0, 20, (ns_n, 4)).astype(np.int32)
        req = rng.randint(0, 4, (p, 4)).astype(np.int32)
        headroom = 3 if regime == "tight" else 40
        limit = (used + rng.randint(0, headroom, (ns_n, 4))).astype(np.int32)
        limit[rng.uniform(size=(ns_n, 4)) < 0.2] = I32_MAX
    return node_idx, ns_idx, req, used, limit


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("regime", ["tight", "loose", "ceiling"])
def test_screen_matches_jax(seed, regime):
    import jax.numpy as jnp

    from kubernetes_tpu.ops import quota as jquota
    from kubernetes_tpu_torch.ops import quota as tquota

    node_idx, ns_idx, req, used, limit = _screen_case(seed, regime)
    jw = np.asarray(jquota.quota_screen(jnp.asarray(node_idx), jnp.asarray(ns_idx),
                                        jnp.asarray(req), jnp.asarray(used),
                                        jnp.asarray(limit)))
    tw = tquota.quota_screen(torch.from_numpy(node_idx), ns_idx, torch.from_numpy(req),
                             torch.from_numpy(used), torch.from_numpy(limit))
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), jw)
    if regime != "ceiling":  # the host oracle adds in int64: it agrees below the ceiling
        np.testing.assert_array_equal(
            tw.numpy(), jquota.quota_screen_host(node_idx, ns_idx, req, used, limit))
    if regime == "tight" and len(node_idx) > 8:
        flagged = (node_idx >= 0) & (tw.numpy() == tquota.QUOTA_SCREEN_BIT)
        assert flagged.any()


def test_screen_wraps_like_the_jax_carry():
    """A charge that lands the usage carry past 2**31 - 1 wraps in int32 in
    both, and the next pod of that namespace is judged on the wrapped
    usage."""
    import jax.numpy as jnp

    from kubernetes_tpu.ops import quota as jquota
    from kubernetes_tpu_torch.ops import quota as tquota

    used = np.array([[I32_MAX - 5, 0, 0, 0]], np.int32)
    limit = np.full((1, 4), I32_MAX, np.int32)
    req = np.array([[5, 0, 0, 0], [1, 0, 0, 0], [3, 0, 0, 0]], np.int32)
    node_idx = np.array([0, 1, 2], np.int32)
    ns_idx = np.zeros(3, np.int32)
    jw = np.asarray(jquota.quota_screen(*(jnp.asarray(a) for a in
                                         (node_idx, ns_idx, req, used, limit))))
    tw = tquota.quota_screen(torch.from_numpy(node_idx), ns_idx, torch.from_numpy(req),
                             torch.from_numpy(used), torch.from_numpy(limit)).numpy()
    np.testing.assert_array_equal(tw, jw)
    # the first fits exactly; the second wraps to a negative sum, which fits
    assert tw.tolist() == [3, 3, 3]


def test_request_rows_and_batch_args_match_jax():
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops import quota as jquota
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu_torch.backend.device_state import DeviceState
    from kubernetes_tpu_torch.ops import quota as tquota
    from kubernetes_tpu_torch.ops.schema import Capacities

    api_t, api_j = tc.torch_api(), tc.jax_api()

    def pods(api):
        out = []
        for i, ns in enumerate(["a", "b", "x", "a", "b"]):
            pw = api.make_pod(f"p{i}", namespace=ns).req({"cpu": f"{100 * i + 50}m",
                                                         "memory": f"{i + 1}Gi"})
            if i == 4:
                pw.resource_claim("accel", template_name="t")
            out.append(pw.obj())
        return out

    table = {"a": ([1, 2, 3, 0], [5, 6, 7, 8]), "b": ([0, 0, 0, 0], [1, 1, 1, 1])}
    tds, jds = DeviceState(Capacities(nodes=16, pods=8), "cpu"), JDeviceState(JCaps(nodes=16, pods=8))
    tns, treq = tquota.build_quota_batch_args(pods(api_t), tds, table, pad_to=8)
    jns, jreq = jquota.build_quota_batch_args(pods(api_j), jds, table=table, pad_to=8)
    np.testing.assert_array_equal(tns, jns)
    np.testing.assert_array_equal(treq, jreq)
    assert tns.tolist() == [0, 1, -1, 0, 1, -1, -1, -1]
    # no pod of a screened namespace: no screen
    assert tquota.build_quota_batch_args(pods(api_t)[2:3], tds, table) == (None, None)
    assert jquota.build_quota_batch_args(pods(api_j)[2:3], jds, table=table) == (None, None)


# ----------------------------------------------------------------- the namespace rows


def test_set_ns_quota_matches_jax():
    """Content diff, growth past 8 rows, and a namespace that left the
    table, step by step against the JAX DeviceState."""
    from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
    from kubernetes_tpu.ops.schema import Capacities as JCaps
    from kubernetes_tpu_torch.backend.device_state import DeviceState
    from kubernetes_tpu_torch.ops.schema import Capacities

    tds, jds = DeviceState(Capacities(nodes=16, pods=8), "cpu"), JDeviceState(JCaps(nodes=16, pods=8))
    rng = np.random.RandomState(3)

    def row():
        return [int(v) for v in rng.randint(-5, 50, 4)]

    base = {f"ns{i}": (row(), row()) for i in range(3)}
    grown = {**base, **{f"ns{i}": (row(), [I32_MAX + 7, 1, 2, 3]) for i in range(3, 12)}}
    steps = [base, dict(base), {**base, "ns1": (row(), row())}, grown,
             {k: v for k, v in grown.items() if k != "ns2"}, {}]
    for table in steps:
        assert tds.set_ns_quota(table) == jds.set_ns_quota(table)
        assert tds.nsq_slots == jds.nsq_slots and tds.nsq_uploads == jds.nsq_uploads
        np.testing.assert_array_equal(tds.nsq_used.numpy(), np.asarray(jds.nsq_used))
        np.testing.assert_array_equal(tds.nsq_limit.numpy(), np.asarray(jds.nsq_limit))
    assert tds.nsq_used.shape == (16, 4) and tds.nsq_uploads == 5
    slot = tds.nsq_slots["ns2"]
    assert (tds.nsq_limit[slot] == I32_MAX).all() and (tds.nsq_used[slot] == 0).all()


# ----------------------------------------------------------------- the packed block


@pytest.mark.parametrize("layout", ["none", "slice", "quota", "both"])
@pytest.mark.parametrize("n", [128, 131])
def test_packed_block_quota_column_matches_jax(layout, n):
    import jax.numpy as jnp

    from kubernetes_tpu.backend import batch as jbatch
    from kubernetes_tpu_torch.backend import batch as tbatch

    rng = np.random.RandomState(n)
    idx = rng.randint(-1, n, size=16).astype(np.int32)
    ff = rng.randint(-3, 12, size=(16, n)).astype(np.int8)
    sw = rng.randint(-2**31, 2**31 - 1, size=16).astype(np.int32)
    qw = rng.randint(0, 4, size=16).astype(np.int32)
    s = sw if layout in ("slice", "both") else None
    q = qw if layout in ("quota", "both") else None
    jp = np.asarray(jbatch.pack_result_block(
        jnp.asarray(idx), jnp.asarray(ff), slice_words=None if s is None else jnp.asarray(s),
        quota_words=None if q is None else jnp.asarray(q)))
    tp = tbatch.pack_result_block(torch.from_numpy(idx), torch.from_numpy(ff),
                                  None if s is None else torch.from_numpy(s),
                                  None if q is None else torch.from_numpy(q))
    assert jp.tobytes() == tp.numpy().tobytes()
    quota_col = q is not None
    jout = jbatch.unpack_result_block(jp, n, quota_col=quota_col)
    tout = tbatch.unpack_result_block(tp, n, quota_col=quota_col)
    for a, b, want in zip(jout, tout, (idx, ff, s, q)):
        if want is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, want)


# ----------------------------------------------------------------- the ledger


def _quota_objects(api_types, cohort="pool"):
    q = api_types.SchedulingQuota
    meta = api_types.ObjectMeta
    return [q(meta=meta(name="q", namespace="own"), hard={"pods": 3, "requests.cpu": 2000}),
            q(meta=meta(name="q", namespace="lend"), hard={"pods": 4, "claims": 2},
              cohort=cohort),
            q(meta=meta(name="q", namespace="hungry"), hard={"pods": 2, "claims": 2},
              cohort=cohort),
            q(meta=meta(name="q", namespace="gangs"), hard={"pods": 5})]


def _ledger_pods(api):
    """(name, namespace, cpu, gang) in the order the sequence uses them."""
    spec = [("o0", "own", "500m", ""), ("o1", "own", "900m", ""), ("o2", "own", "700m", ""),
            ("o3", "own", "100m", ""), ("h0", "hungry", "100m", ""),
            ("h1", "hungry", "100m", ""), ("h2", "hungry", "100m", ""),
            ("h3", "hungry", "100m", ""), ("l0", "lend", "100m", ""),
            ("l1", "lend", "100m", ""), ("l2", "lend", "100m", ""),
            ("g0", "gangs", "100m", "g"), ("g1", "gangs", "100m", "g"),
            ("g2", "gangs", "100m", "g"), ("g3", "gangs", "100m", "g")]
    out = {}
    for name, ns, cpu, gang in spec:
        pw = api.make_pod(name, namespace=ns).req({"cpu": cpu, "memory": "1Gi"})
        if gang:
            pw.pod_group(gang)
        out[name] = pw.obj()
    return out


def test_quota_admission_matches_jax():
    """One sequence of PreFilter / Reserve / Unreserve / delete on both
    ledgers: own caps, a gang priced whole, a cohort loan, and a lender's
    reclaim demand that blocks a borrower. Every verdict, reason and the
    ledger and device table after each step are equal."""
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins.quota import QuotaAdmission as JQuota
    from kubernetes_tpu_torch.api import types as ttypes
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.framework.plugins.quota import QuotaAdmission

    tstore, jstore = Store(), ClusterStore()
    for tq, jq in zip(_quota_objects(ttypes), _quota_objects(jtypes)):
        tstore.create_object("SchedulingQuota", tq)
        jstore.create_object("SchedulingQuota", jq)
    for store, types_ in ((tstore, ttypes), (jstore, jtypes)):
        store.create_object("PodGroup", types_.PodGroup(
            meta=types_.ObjectMeta(name="g", namespace="gangs"), min_member=4))
    tpods, jpods = _ledger_pods(tc.torch_api()), _ledger_pods(tc.jax_api())
    # a bound pod of "own" the ledger seeds on first touch
    seed_t = tc.torch_api().make_pod("seed", namespace="own").req({"cpu": "100m"}).obj()
    seed_j = tc.to_jax(seed_t)
    seed_t.spec.node_name = seed_j.spec.node_name = "n0"
    jstore.pods[seed_j.key()] = seed_j
    tq = QuotaAdmission(tstore, lambda: [seed_t])
    jq = JQuota(client=jstore)

    def check():
        for ns in ("own", "lend", "hungry", "gangs"):
            assert tq.usage(ns) == jq.usage(ns), ns
            assert tq.borrowed(ns) == jq.borrowed(ns), ns
        assert tq.cohort_state("pool") == jq.cohort_state("pool")
        assert tq.device_quota_table() == jq.device_quota_table()
        assert tq._reclaim_demand == jq._reclaim_demand

    def pre(name):
        _, st = jq.pre_filter(CycleState(), jpods[name])
        _restrict, fail = tq.pre_filter(None, tpods[name])
        reason = fail.reason if fail is not None else None
        assert (reason is None) == st.is_success() and (reason is None or
                                                        reason == st.reasons[0]), name
        return reason

    def res(name):
        st = jq.reserve(CycleState(), jpods[name], "n1")
        reason = tq.reserve(None, tpods[name], "n1")
        assert (reason is None) == st.is_success() and (reason is None or
                                                        reason == st.reasons[0]), name
        return reason

    steps = [("res", "o0"), ("res", "o1"), ("pre", "o2"), ("res", "o2"), ("res", "o3"),
             ("unres", "o1"), ("res", "o3"),
             # gang of 4 under a pods: 5 cap: the head is priced for all four
             ("pre", "g0"), ("res", "g0"), ("res", "g1"), ("res", "g2"), ("res", "g3"),
             ("del", "g1"),
             # hungry borrows past its own 2 pods from the pool of 6
             ("res", "h0"), ("res", "h1"), ("res", "h2"), ("res", "h3"),
             # the lender fills its own caps; the pool is exhausted by loans
             ("res", "l0"), ("res", "l1"), ("pre", "l2"),
             # the lender's demand freezes new loans
             ("del", "h3"), ("pre", "h3"), ("res", "l2"), ("pre", "h3")]
    verdicts = []
    for op, name in steps:
        if op == "pre":
            verdicts.append(pre(name))
        elif op == "res":
            verdicts.append(res(name))
        elif op == "unres":
            tq.unreserve(None, tpods[name], "n1")
            jq.unreserve(CycleState(), jpods[name], "n1")
        else:
            tq.pod_deleted(tpods[name])
            jq.pod_deleted(jpods[name])
        check()
    assert tq.borrowed("hungry")["pods"] > 0
    assert any(v is not None and "cohort exhausted by loans" in v for v in verdicts)
    assert any(v is not None and "over quota" in v for v in verdicts)


def test_quota_edit_is_seen_like_jax():
    """A SchedulingQuota updated in the store after the ledger first read
    it (its cap lowered, then raised, then joined to a cohort) is seen at
    once by both ledgers: the gate's verdicts, the caps, the cohort and the
    device table follow every edit."""
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins.quota import QuotaAdmission as JQuota
    from kubernetes_tpu_torch.api import types as ttypes
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.framework.plugins.quota import QuotaAdmission

    def quotas(types_, cap, cohort=""):
        return [types_.SchedulingQuota(meta=types_.ObjectMeta(name="q", namespace=ns),
                                       hard={"pods": n}, cohort=cohort)
                for ns, n in (("a", cap), ("b", 3))]

    tstore, jstore = Store(), ClusterStore()
    for tq, jq in zip(quotas(ttypes, 4), quotas(jtypes, 4)):
        tstore.create_object("SchedulingQuota", tq)
        jstore.create_object("SchedulingQuota", jq)
    tq, jq = QuotaAdmission(tstore, lambda: []), JQuota(client=jstore)
    api = tc.torch_api()
    tpods = [api.make_pod(f"p{i}", namespace="a").req({"cpu": "100m"}).obj() for i in range(6)]
    jpods = [tc.to_jax(p) for p in tpods]

    def step(i, op):
        if op == "res":
            st = jq.reserve(CycleState(), jpods[i], "n0")
            reason = tq.reserve(None, tpods[i], "n0")
        else:
            _, st = jq.pre_filter(CycleState(), jpods[i])
            _restrict, fail = tq.pre_filter(None, tpods[i])
            reason = fail.reason if fail is not None else None
        assert (reason is None) == st.is_success(), (i, op)
        assert reason is None or reason == st.reasons[0]
        assert tq.effective_hard("a") == jq.effective_hard("a")
        assert tq.cohort_for("a") == jq.cohort_for("a")
        assert tq.device_quota_table() == jq.device_quota_table()
        assert tq.usage("a") == jq.usage("a") and tq.borrowed("a") == jq.borrowed("a")
        return reason

    def edit(cap, cohort=""):
        for tq_, jq_ in zip(quotas(ttypes, cap, cohort), quotas(jtypes, cap, cohort)):
            tstore.update_object("SchedulingQuota", tq_)
            jstore.update_object("SchedulingQuota", jq_)

    assert [step(i, "res") for i in range(3)] == [None] * 3
    edit(3)                                # lowered to what is charged
    assert "over quota" in step(3, "pre")
    edit(5)                                # raised
    assert step(3, "res") is None and step(4, "res") is None
    assert "over quota" in step(5, "pre")
    edit(5, cohort="pool")                 # joined to a pool with b's 3 free
    assert step(5, "res") is None and tq.borrowed("a")["pods"] == 1
    assert tq.device_quota_table()["a"][1][0] == 5 + 2


# ----------------------------------------------------------------- BatchScheduler


def _quota(api_types, ns, hard, cohort=""):
    return api_types.SchedulingQuota(meta=api_types.ObjectMeta(name="q", namespace=ns),
                                     hard=dict(hard), cohort=cohort)


def _cluster(api, n=4):
    return [api.NodeInfo(api.make_node(f"n{i}").capacity({"cpu": "8", "memory": "16Gi",
                                                         "pods": 20})
                         .label("kubernetes.io/hostname", f"n{i}").obj()) for i in range(n)]


def _run_port(quotas, pods_t, batch=8, groups=()):
    """The port's BatchScheduler over a 4-node cluster with the quotas and
    PodGroups ((namespace, name, min_member)); ``pods_t`` scheduled in one
    call. Returns (placements, the BatchScheduler)."""
    from kubernetes_tpu_torch.api import types as ttypes
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
    from kubernetes_tpu_torch.ops.schema import Capacities

    store = Store()
    for q in quotas:
        store.create_object("SchedulingQuota", q(ttypes))
    for ns, name, k in groups:
        store.create_object("PodGroup", ttypes.PodGroup(
            meta=ttypes.ObjectMeta(name=name, namespace=ns), min_member=k))
    sched = BatchScheduler(_cluster(tc.torch_api()),
                           caps=Capacities(nodes=16, pods=batch, value_words=32),
                           device="cpu", client=store)
    return sched.schedule(pods_t), sched


def _run_both(quotas, pods_t, batch=8, groups=()):
    """``_run_port`` and a JaxEnv over the same cluster, quotas and
    PodGroups, ``pods_t`` in one JaxEnv batch. Returns (port placements,
    the BatchScheduler, JAX placements, the JaxEnv)."""
    from kubernetes_tpu.api import types as jtypes

    placed_t, sched = _run_port(quotas, pods_t, batch, groups)
    env = tc.JaxEnv(_cluster(tc.jax_api()), dict(nodes=16, pods=batch, value_words=32))
    for q in quotas:
        env.store.create_object("SchedulingQuota", q(jtypes))
    for ns, name, k in groups:
        env.store.create_object("PodGroup", jtypes.PodGroup(
            meta=jtypes.ObjectMeta(name=name, namespace=ns), min_member=k))
    pods_j = [tc.to_jax(p) for p in pods_t]
    env.add_pods(pods_j)
    placed_j = env.schedule(pods_j)
    return placed_t, sched, placed_j, env


def _same(placed_t, sched, placed_j, env):
    assert placed_t == placed_j
    assert sched.quota_rejected == env.quota_rejected
    assert sched.retry == env.retry and sched.gang_rejected == env.gang_rejected
    assert sched.quota_flagged == env.flagged and sched.quota_gated == env.gated
    for ns in {p.split("/")[0] for p in placed_t}:
        assert sched.quota.usage(ns) == env.quota.usage(ns)
        assert sched.quota.borrowed(ns) == env.quota.borrowed(ns)


def test_in_batch_over_admission_is_screened():
    """Six pods of one namespace in one batch against pods: 2: the gate
    lets all six through, the screen flags four winners, two bind."""
    api = tc.torch_api()
    pods = [api.make_pod(f"p{i}", namespace="team-a").req({"cpu": "1", "memory": "1Gi"}).obj()
            for i in range(6)]
    out = _run_both([lambda t: _quota(t, "team-a", {"pods": 2})], pods)
    _same(*out)
    placed_t, sched = out[:2]
    assert sum(v is not None for v in placed_t.values()) == 2
    assert sched.quota_flagged == {"team-a": 4} and not sched.quota_gated
    assert sched.quota.usage("team-a")["pods"] == 2
    assert all("device screen" in r for r in sched.quota_rejected.values())
    assert not sched.nominated and not sched.fallback


def test_borrower_screened_up_to_the_pool():
    """A borrower's winners pass the screen up to its cohort's pool (own 2
    + the lender's unused 3), the rest are flagged."""
    api = tc.torch_api()
    pods = [api.make_pod(f"b{i}", namespace="hungry").req({"cpu": "1"}).obj() for i in range(7)]
    out = _run_both([lambda t: _quota(t, "lend", {"pods": 3}, "pool"),
                     lambda t: _quota(t, "hungry", {"pods": 2}, "pool")], pods)
    _same(*out)
    placed_t, sched = out[:2]
    assert sum(v is not None for v in placed_t.values()) == 5
    assert sched.quota.borrowed("hungry")["pods"] == 3


def test_two_borrowers_of_one_pool_meet_reserve():
    """Two namespaces of one cohort, both over their own caps, each screened
    against the pool's whole headroom: the screen passes both, and Reserve
    refuses the second borrower's pods once the pool is spent (``retry``)."""
    api = tc.torch_api()
    pods = []
    for i in range(3):
        for ns in ("x", "y"):
            pods.append(api.make_pod(f"{ns}{i}", namespace=ns).req({"cpu": "1"}).obj())
    out = _run_both([lambda t: _quota(t, "x", {"pods": 1}, "pool"),
                     lambda t: _quota(t, "y", {"pods": 1}, "pool"),
                     lambda t: _quota(t, "idle", {"pods": 2}, "pool")], pods)
    _same(*out)
    placed_t, sched = out[:2]
    assert sched.retry and all("QuotaExceeded" in r for r in sched.retry.values())
    assert sum(v is not None for v in placed_t.values()) == 4
    caps, used = sched.quota.cohort_state("pool")
    assert used["pods"] == caps["pods"]


def test_screened_gang_member_poisons_its_gang():
    """A gang whose head passes the gate (priced whole) loses one member to
    the screen, behind pods of its namespace earlier in the batch: the
    whole gang is rejected ("incomplete"), nothing of it binds."""
    api = tc.torch_api()
    plain = [api.make_pod(f"p{i}", namespace="g").req({"cpu": "100m"}).obj() for i in range(2)]
    gang = [api.make_pod(f"m{i}", namespace="g").req({"cpu": "100m"}).pod_group("grp").obj()
            for i in range(3)]
    out = _run_both([lambda t: _quota(t, "g", {"pods": 4})], plain + gang,
                    groups=[("g", "grp", 3)])
    _same(*out)
    placed_t, sched = out[:2]
    assert [placed_t[p.key()] is not None for p in plain] == [True, True]
    assert all(placed_t[p.key()] is None for p in gang)
    assert sched.gang_rejected == dict.fromkeys((p.key() for p in gang), "incomplete")
    assert sched.quota_flagged == {"g": 1} and sched.coscheduling.rejections == {"incomplete": 1}
    assert sched.quota.usage("g")["pods"] == 2


def test_gang_refused_at_reserve_leaves_whole():
    """The port's own behaviour (ROADMAP C12; the JAX package parks the
    siblings at Permit until its timeout, and the port has no Permit): a
    gang of a cohort borrower whose head the ledger charges, after which
    pods of another borrower of the pool spend the headroom its tail needs.
    The screen (each row sees the pool's whole headroom) passes all,
    Reserve refuses the tail, and the whole gang leaves: the head's charge
    and bind are undone, every member is in ``retry``, the other
    borrower's pods bind on their loans."""
    api = tc.torch_api()
    gang = [api.make_pod(f"y{i}", namespace="y").req({"cpu": "100m"}).pod_group("grp").obj()
            for i in range(3)]
    xs = [api.make_pod(f"x{i}", namespace="x").req({"cpu": "100m"}).obj() for i in range(4)]
    placed_t, sched = _run_port([lambda t: _quota(t, "x", {"pods": 1}, "pool"),
                                 lambda t: _quota(t, "y", {"pods": 1}, "pool"),
                                 lambda t: _quota(t, "idle", {"pods": 4}, "pool")],
                                gang[:1] + xs + gang[1:], groups=[("y", "grp", 3)])
    assert all(placed_t[p.key()] is None for p in gang)
    assert all(placed_t[p.key()] for p in xs)
    assert set(sched.retry) == {p.key() for p in gang}
    assert "a member was refused its quota" in sched.retry["y/y0"]
    assert all("QuotaExceeded" in sched.retry[k] for k in ("y/y1", "y/y2"))
    assert sched.quota.usage("x")["pods"] == 4 and sched.quota.borrowed("x")["pods"] == 3
    assert not sched.quota_flagged and sched.quota.usage("y")["pods"] == 0
    assert not sched.gang_rejected and not sched.fallback
    assert all(p.key() != "y/y0" for ni in sched.snapshot.node_info_map.values()
               for p in ni.pods)


def test_delete_pod_releases_quota_and_the_node():
    from kubernetes_tpu_torch.api import types as ttypes

    api = tc.torch_api()
    pods = [api.make_pod(f"p{i}", namespace="a").req({"cpu": "1"}).obj() for i in range(3)]
    placed, sched, _pj, _env = _run_both([lambda t: _quota(t, "a", {"pods": 2})], pods)
    bound = [k for k, v in placed.items() if v]
    assert len(bound) == 2 and sched.delete_pod(bound[0]) and not sched.delete_pod("a/none")
    assert sched.quota.usage("a")["pods"] == 1
    assert all(p.key() != bound[0] for ni in sched.snapshot.node_info_map.values()
               for p in ni.pods)
    again = sched.schedule([p for p in pods if p.key() in sched.quota_rejected])
    assert sum(v is not None for v in again.values()) == 1 and ttypes.QUOTA_PODS == "pods"


# ----------------------------------------------------------------- SchedulingSoak


@pytest.mark.parametrize("spec", ["0", "1"])
@pytest.mark.parametrize("cohort,gangs", [("", True), ("soak", True), ("", False)])
def test_small_soak_matches_jax(cohort, gangs, spec, monkeypatch):
    """SchedulingSoak at 60 nodes, scale 4, 4 rounds (and its /Cohort and
    /NoGangs variants), on the kernel's plain version (or the scan) and on
    the rounds: placements, the pods left, per-round ledgers and
    nominations, quota and gang rejections equal the JAX loop fed the same
    pods in the same order; no oversubscription. Without gangs every batch
    is in mode ``off``: the kernel's path, then the screen."""
    monkeypatch.setenv("KTPU_SPEC", spec)
    jax_out, env, port, sched = tc.run_soak_both(cohort=cohort, gangs=gangs)
    for key in ("placed", "bound", "passes", "rounds", "pending"):
        assert port[key] == jax_out[key], key
    assert port["oversubscription"] == jax_out["oversubscription"] == 0
    assert sched.quota_rejected == env.quota_rejected and sched.retry == env.retry
    assert sched.gang_rejected == env.gang_rejected and sched.quota_flagged == env.flagged
    assert sched.quota_gated == env.gated and sched.batch_modes == env.modes
    assert not sched.fallback and sched.quota_flagged and port["pending"]
    if spec == "1":
        assert set(sched.batch_paths) == {"spec"}
    if not gangs:
        assert set(sched.batch_modes) == {"off"} and not sched.gang_rejected
        if spec == "0":
            assert set(sched.batch_paths) == {"fused"}
    if cohort:
        assert any(sched.quota.borrowed(ns).get("pods") for ns in ("soak-a", "soak-b",
                                                                  "soak-c"))
