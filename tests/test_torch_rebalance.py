"""The port's continuous rebalancer (``kubernetes_tpu_torch/controllers/
rebalance.py``) against the JAX package's on the CPU, in the cases of
``tests/test_rebalance.py:72-330``.

``packing_entropy`` (the JAX package's XLA program, plain PyTorch here)
gives the JAX cases' values: 1.0 for an even spread, 0.0 for load on one
node, 0.0 on a dead axis left out of the mean, and invalid rows ignored;
on seeded inputs of the shapes the loop gives it (the snapshot's [N, 4],
the mirror's [N, 6] at N = 24, 128, 500 and 5120) it equals the JAX
program to 1e-6 absolute (measured: 2.4e-7; its logs are ``log_f32``,
bit for bit ``jnp.log``, but torch's sums are not XLA's: the order of
XLA's CPU reductions decides the last bits, and neither a sequential nor
a strided nor a blocked float32 sum reproduces them at every N).

Every other case runs the same cluster through both packages' scheduler
loops (``LoopPair``, FakeClocks; 6 nodes of cpu 4 / 16Gi / 16 pods in 2
zones, 24 pods of 200m / 512Mi placed, then all but every third bound pod
deleted: the thin smear churn leaves) with each package's ``Rebalancer``
on its own loop, and holds the two equal: the hysteresis band and the
fragmentation axis; a wave within its migration budget and the cooldown
after it (waves, migrations, the victims cordoned, the metrics); the
densest node spared; the victims' nodes reopened only after their pods
bound elsewhere, none lost; the gang gate withholding a whole gang; the
SLO guardrail opening on a tenant's p99 regression, refusing waves while
open, healing only through its half-open probe, and not judging a short
window; and ``debug_dump`` (JSON-clean, truncated to ``limit``). The
stores end equal; scores and entropies agree to 1e-6, every decision
exactly."""

import json

import numpy as np
import pytest
import torch

from _torch_cases import LoopPair, to_jax

TOL = 1e-6


def _close(a, b) -> bool:
    """Equal, floats to ``TOL``, recursively."""
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= TOL
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


# ------------------------------------------------------------------ the score


def _both_entropy(req: np.ndarray, valid: np.ndarray):
    import jax.numpy as jnp

    from kubernetes_tpu.controllers.rebalance import packing_entropy as jpe
    from kubernetes_tpu_torch.controllers.rebalance import packing_entropy

    jm, jp = jpe(jnp.asarray(req), jnp.asarray(valid))
    tm, tp = packing_entropy(torch.from_numpy(req), torch.from_numpy(valid))
    assert abs(float(tm) - float(jm)) <= TOL
    assert np.allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=0)
    return float(tm), tp.numpy()


def test_even_spread_scores_one():
    mean, per_axis = _both_entropy(np.full((8, 4), 10.0, np.float32), np.ones(8, bool))
    assert mean == pytest.approx(1.0, abs=1e-5)
    assert np.allclose(per_axis, 1.0, atol=1e-5)


def test_consolidated_scores_zero():
    req = np.zeros((8, 4), np.float32)
    req[3] = 10.0
    mean, _ = _both_entropy(req, np.ones(8, bool))
    assert mean == pytest.approx(0.0, abs=1e-5)


def test_dead_axes_excluded_from_mean():
    req = np.full((8, 4), 10.0, np.float32)
    req[:, 2] = 0.0
    mean, per_axis = _both_entropy(req, np.ones(8, bool))
    assert mean == pytest.approx(1.0, abs=1e-5)
    assert per_axis[2] == 0.0


def test_invalid_rows_ignored():
    req = np.full((8, 4), 10.0, np.float32)
    valid = np.ones(8, bool)
    valid[4:] = False
    req[4:] = 77.0
    mean, _ = _both_entropy(req, valid)
    assert mean == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("n,r", [(24, 4), (128, 6), (500, 4), (5120, 6)])
def test_entropy_matches_jax_on_seeded_rows(n, r):
    rng = np.random.default_rng(n + r)
    for _ in range(20):
        req = (rng.integers(0, 40, (n, r)) * rng.choice([1, 100, 512, 4000], r)).astype(np.float32)
        req[rng.random((n, r)) < 0.5] = 0
        _both_entropy(req, rng.random(n) < 0.9)


def test_log_f32_is_jnp_log_bit_for_bit():
    import jax
    import jax.numpy as jnp

    from kubernetes_tpu_torch.ops.topology import log_f32

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(100000), rng.random(20000) * 1e6,
                        2.0 ** rng.integers(-125, 127, 2000),
                        np.arange(2, 9000)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    got = log_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------------------ through the loops


def _pair(nodes=6, pods=24, smear=True, gang_size=0, prefix="rb") -> LoopPair:
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.perf import workloads

    pair = LoopPair(batch=16)
    for ni in workloads.scheduling_basic_nodes(nodes, 2, capacity={"cpu": "4", "memory": "16Gi",
                                                                   "pods": 16}):
        pair.jstore.create_node(to_jax(ni.node))
        pair.tstore.create_node(ni.node)
    if gang_size:
        pair.add_pod_group(f"{prefix}-pg0", gang_size)
    for j in range(pods):
        pw = make_pod(f"{prefix}-{j}").req({"cpu": "200m", "memory": "512Mi"})
        if gang_size:
            pw.pod_group(f"{prefix}-pg{j // gang_size}")
        pod = pw.obj()
        pair.jstore.create_pod(to_jax(pod))
        pair.tstore.create_pod(pod)
    pair.settle()
    if smear:
        bound = [p.key() for p in pair.tstore.pods.values() if p.spec.node_name]
        for i, key in enumerate(bound):
            if i % 3:
                pair.delete_pod(key)
    _refresh(pair)
    return pair


def _refresh(pair) -> None:
    for sched in (pair.jsched, pair.tsched):
        sched.cache.update_snapshot(sched.snapshot)


def _rebalancers(pair, **kw):
    from kubernetes_tpu.controllers.rebalance import Rebalancer as JRebalancer
    from kubernetes_tpu_torch.controllers.rebalance import Rebalancer

    return (JRebalancer(pair.jsched, now_fn=pair.jclock, **kw),
            Rebalancer(pair.tsched, now_fn=pair.tclock, **kw))


def _armed(pair, **kw):
    kw.setdefault("entropy_high", 0.05)
    kw.setdefault("entropy_low", 0.01)
    kw.setdefault("score_interval_s", 0.0)
    kw.setdefault("cooldown_s", 5.0)
    return _rebalancers(pair, **kw)


def _run(rbs, pair) -> list:
    outs = [rb.maybe_run(clock()) for rb, clock in zip(rbs, (pair.jclock, pair.tclock))]
    assert _close(outs[1], outs[0]), outs
    return outs


def _stores(pair) -> dict:
    views = []
    for store in (pair.jstore, pair.tstore):
        views.append({"pods": {k: p.spec.node_name for k, p in store.pods.items()},
                      "cordoned": sorted(n for n, node in store.nodes.items()
                                         if node.spec.unschedulable)})
    assert views[1] == views[0]
    return views[1]


def test_hysteresis_arm_and_disarm():
    pair = _pair(nodes=2, pods=0, smear=False)
    for rb in _rebalancers(pair, entropy_high=0.9, entropy_low=0.7, frag_high=0.6,
                           frag_low=0.4):
        seen = []
        for e in (0.85, 0.95, 0.75, 0.65):
            rb._update_trigger({"entropy": e, "frag_max": 0.0})
            seen.append(rb.armed)
        assert seen == [False, True, True, False]


def test_frag_axis_arms_independently():
    pair = _pair(nodes=2, pods=0, smear=False)
    for rb in _rebalancers(pair):
        rb._update_trigger({"entropy": 0.1, "frag_max": 0.9})
        assert rb.armed
        rb._update_trigger({"entropy": 0.81, "frag_max": 0.0})
        assert rb.armed


def test_wave_respects_migration_budget_and_cooldown():
    pair = _pair()
    rbs = _armed(pair, max_migrations_per_wave=3)
    out = _run(rbs, pair)[1]
    assert out["ran"], out
    assert 0 < out["wave"]["evicted"] <= 3
    rb = rbs[1]
    assert rb.waves_executed == 1 and rb.migrations == out["wave"]["evicted"]
    assert rb.drain.pending_uncordons
    assert list(rbs[0].last_waves[-1]["nodes"]) == list(rb.last_waves[-1]["nodes"])
    for name in rb.last_waves[-1]["nodes"]:
        assert pair.tstore.nodes[name].spec.unschedulable
    out2 = _run(rbs, pair)[1]
    assert not out2["ran"] and out2["reason"] == "cooldown"
    m, jm = pair.tsched.smetrics, pair.jsched.smetrics
    assert m.rebalance_waves.labels("executed") == jm.rebalance_waves.labels("executed") == 1
    assert m.rebalance_migrations.labels() == jm.rebalance_migrations.labels() == rb.migrations
    assert abs(m.packing_entropy.labels() - jm.packing_entropy.labels()) <= TOL
    assert m.packing_entropy.labels() > 0.0
    _stores(pair)


def test_densest_node_never_a_victim():
    pair = _pair()
    by_occ = sorted((ni for ni in pair.tsched.snapshot.list() if ni.pods),
                    key=lambda ni: len(ni.pods))
    densest = by_occ[-1].node.meta.name
    victims = [rb._pick_victims() for rb in _armed(pair, max_migrations_per_wave=100)]
    assert victims[1] == victims[0]
    assert victims[1] and densest not in victims[1]


def test_uncordon_after_waits_for_rebind():
    pair = _pair()
    alive = [k for k, p in pair.tstore.pods.items()]
    rbs = _armed(pair, max_migrations_per_wave=4)
    assert _run(rbs, pair)[1]["ran"]
    wave_nodes = list(rbs[1].last_waves[-1]["nodes"])
    assert [rb.drain.poll_pending_uncordons() for rb in rbs] == [[], []]
    pair.settle()
    _refresh(pair)
    reopened = [sorted(rb.drain.poll_pending_uncordons()) for rb in rbs]
    assert reopened[1] == reopened[0] == sorted(wave_nodes)
    assert not rbs[1].drain.pending_uncordons
    placed = _stores(pair)
    assert not placed["cordoned"]
    for k in alive:
        assert placed["pods"][k] and placed["pods"][k] not in wave_nodes
    pair.assert_equal()


def test_gang_atomic_disruption_gate():
    pair = _pair(nodes=4, pods=4, smear=False, gang_size=4, prefix="gangrb")
    for rb, store in zip(_armed(pair), (pair.jstore, pair.tstore)):
        pods = [store.get_pod(f"default/gangrb-{j}") for j in range(4)]
        assert all(p is not None and p.spec.node_name for p in pods)
        victim = pods[0].meta.name
        assert rb.drain._gate_whole_gangs(pods, lambda p: p.meta.name != victim) == []
        assert rb.drain._gate_whole_gangs(pods, lambda p: True) == pods


def _tripped(pair, **kw):
    """Both rebalancers with a watch armed on tenant t1, then its p99
    regressed hard and judged."""
    rbs = _rebalancers(pair, breaker_threshold=1, probe_interval_s=60.0, slo_min_samples=5,
                       **kw)
    for rb in rbs:
        hist = rb.sched.smetrics.tenant_e2e_duration
        for _ in range(10):
            hist.observe(0.01, "t1")
        rb._arm_slo_watch()
        assert "t1" in rb._slo_watch
        rb.waves_executed = 1
        for _ in range(10):
            hist.observe(5.0, "t1")
        rb._judge_slo()
    assert rbs[1]._slo_watch["t1"][0] == rbs[0]._slo_watch["t1"][0]
    return rbs


def test_regression_trips_breaker_open():
    pair = _pair(nodes=2, pods=0, smear=False)
    rbs = _tripped(pair)
    for rb in rbs:
        assert rb.suspended and rb.breaker.dump()["state"] == "open"
        assert rb.sched.smetrics.rebalance_suspended.labels() == 1
    from kubernetes_tpu_torch.api.wrappers import make_pod

    for j in range(6):
        pod = make_pod(f"rb-{j}").req({"cpu": "200m", "memory": "512Mi"}).obj()
        pair.jstore.create_pod(to_jax(pod))
        pair.tstore.create_pod(pod)
    pair.settle()
    _refresh(pair)
    for rb in rbs:
        rb.armed, rb.score_interval_s, rb.cooldown_s = True, 0.0, 0.0
    out = _run(rbs, pair)[1]
    assert not out["ran"] and out["reason"] == "slo-suspended"
    for rb in rbs:
        assert rb.sched.smetrics.rebalance_waves.labels("suspended") == 1


def test_half_open_probe_heals_on_clean_window():
    pair = _pair(nodes=2, pods=0, smear=False)
    rbs = _tripped(pair)
    states = []
    for rb in rbs:
        hist = rb.sched.smetrics.tenant_e2e_duration
        seen = []
        for _ in range(10):
            hist.observe(0.01, "t1")
        rb._judge_slo()
        seen.append(rb.breaker.dump()["state"])  # open: no heal before the probe
        rb.now_fn.advance(61.0)
        seen.append(rb.breaker.allow())
        seen.append(rb.breaker.dump()["state"])
        for _ in range(10):
            hist.observe(0.01, "t1")
        rb._judge_slo()
        seen += [rb.breaker.dump()["state"], rb.suspended,
                 rb.sched.smetrics.rebalance_suspended.labels()]
        states.append(seen)
    assert states[1] == states[0] == ["open", True, "half_open", "closed", False, 0]


def test_short_window_not_judged():
    pair = _pair(nodes=2, pods=0, smear=False)
    for rb in _rebalancers(pair, breaker_threshold=1, slo_min_samples=50):
        hist = rb.sched.smetrics.tenant_e2e_duration
        for _ in range(60):
            hist.observe(0.01, "t1")
        rb._arm_slo_watch()
        rb.waves_executed = 1
        for _ in range(5):
            hist.observe(5.0, "t1")
        rb._judge_slo()
        assert rb.breaker.dump()["state"] == "closed"


def test_guardrail_estimate_is_the_jax_registry_estimate():
    """The port's ``Histogram.estimate`` / ``estimate_since`` equal the JAX
    registry's ``percentile`` / ``percentile_since`` on the same
    observations, at the quantiles the guardrail and the replay read."""
    from kubernetes_tpu.metrics import SchedulerMetrics as JMetrics
    from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics

    rng = np.random.default_rng(3)
    jh, th = JMetrics().tenant_e2e_duration, SchedulerMetrics().tenant_e2e_duration
    for v in rng.exponential(0.4, 300).tolist() + [0.0, 500.0]:
        jh.observe(v, "t")
        th.observe(v, "t")
    jsnap, tsnap = jh.snapshot("t"), th.snapshot("t")
    for v in rng.exponential(2.0, 50):
        jh.observe(float(v), "t")
        th.observe(float(v), "t")
    for q in (0.5, 0.9, 0.99, 1.0):
        assert th.estimate(q, "t") == jh.percentile(q, "t")
        assert th.estimate_since(tsnap, q, "t") == jh.percentile_since(jsnap, q, "t")
    assert th.estimate(0.99, "none") == jh.percentile(0.99, "none") == 0.0


def test_dump_shape_and_limit():
    pair = _pair()
    rbs = _rebalancers(pair, entropy_high=0.05, entropy_low=0.01, score_interval_s=0.0,
                       cooldown_s=0.0, max_migrations_per_wave=2)
    for _ in range(3):
        _run(rbs, pair)
        pair.settle()
        _refresh(pair)
        pair.advance(1.0)
    dumps = [rb.debug_dump(limit=1) for rb in rbs]
    assert _close(dumps[1], dumps[0])
    dump, rb = dumps[1], rbs[1]
    assert rb.waves_executed >= 2
    assert dump["enabled"] and dump["waves_executed"] >= 2
    assert len(dump["last_waves"]) == 1
    assert dump["truncated"]["last_waves"] == rb.waves_executed
    assert set(dump["breaker"]) >= {"state", "opens"}
    assert {"entropy_high", "entropy_low", "frag_high", "frag_low"} <= set(dump["bands"])
    json.dumps(dump)
    _stores(pair)
