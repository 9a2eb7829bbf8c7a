"""SchedulingReplay (``kubernetes_tpu_torch/perf/workloads.py:Replay``,
``replay_rounds``) through the port's scheduler loop against the JAX loop
on the CPU, at the JAX test's small size (``tests/test_rebalance.py:
333-394``: 24 nodes, rounds 6, scale 4, 120 cycles per round, tick 0.05 s,
and its knobs: cooldown 1 s, score interval 0.25 s, band 0.80 / 0.60, 8
migrations per wave), both arms (the rebalancer on, and /NoRebalance).

``workloads.replay_rounds`` drives both packages' loops (``LoopPair``,
each on its own FakeClock, each package's latency ledger and telemetry on)
in two modes: the batch cycle (the loop's main path; at ring depth 2,
where the mirror the rebalancer scores trails the device until its
reconcile, and at depth 0) and one pod per cycle through ``schedule_one``
(the sequential path; the JAX harness's ``oracle`` backend, which the JAX
acceptance test runs). In each, the
ReplayInvariants equal the JAX loop's (PackingEff and FinalEntropy to
1e-6: the scores' sums are not XLA's; the rest exactly), and so do the
waves (when, their victim nodes, pods evicted, gangs), the placements,
queues and gang and quota state, the flight recorder's events and each
tenant's e2e observations; E2eP50 / E2eP99 are the port's exact
quantiles of those.

JAX's acceptance asserts (``tests/test_rebalance.py:363-394``) on the
port: the rebalancer ran and converged (waves and migrations with it on,
none off, no uncordon pending, no pod pending) in both modes, and not
suspended on the batch loop; no tenant's p99 moved past the fence in both
modes; packing measurably better (PackingEff up by more than 0.005 and
FinalEntropy down) in the sequential mode, the JAX test's own. On the
batch loop, the JAX loop's numbers as the port's, each round lands in a
batch cycle or two and the rebalancer, which acts on the clock the
cycles advance, gets one wave: PackingEff rises by less (0.0026 to 0.0079
over six hash seeds) and FinalEntropy ends within 0.005 of the
/NoRebalance arm's, on either side; the test asserts that outcome. The
placements, and so these margins, follow the process's string hashing
(C14), which is why each comparison runs both packages in one process; in
the sequential mode the guardrail is open at the end under some hash
seeds and closed under others, so Suspended is compared there, not
asserted."""

import os

import numpy as np
import pytest

from _torch_cases import FLIGHT_KEYS, LoopPair, Recorders, flight_view, to_jax

SMALL = dict(nodes=24, rounds=6, scale=4, cycles_per_round=120, tick_s=0.05)
KNOBS = {"cooldown_s": 1.0, "score_interval_s": 0.25, "entropy_high": 0.80,
         "entropy_low": 0.60, "max_migrations_per_wave": 8}
TOL = 1e-6
MODES = ["batch", "sequential"]
# the batch loop at ring depth 2 (the default) and 0: with the ring the
# mirror the rebalancer scores trails the device until its reconcile
PARITY_MODES = ["batch", "batch-depth0", "sequential"]


@pytest.fixture(autouse=True)
def _recorders_off(monkeypatch):
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.delenv("KTPU_PIPELINE_DEPTH", raising=False)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    yield
    from kubernetes_tpu.backend import telemetry as jtel
    from kubernetes_tpu.metrics import latency_ledger as jled
    from kubernetes_tpu_torch.backend import telemetry as ttel
    from kubernetes_tpu_torch.metrics import latency_ledger as tled

    for m in (jtel, jled, ttel, tled):
        m.disable()


def _e2e_by_tenant(ledger, tenants) -> dict:
    out = {ns: [] for ns in tenants}
    for e in ledger.timeline_entries():
        if e["closed"] is not None and e["result"] == "scheduled" and e["namespace"] in out:
            out[e["namespace"]].append(e["closed"] - e["opened"])
    return out


_RUNS = {}


def _run(rebalance: bool, mode: str):
    """Both loops through one arm in one mode (memoized): (JAX out, port
    out, JAX flight, port flight, JAX e2e, port e2e)."""
    key = (rebalance, mode)
    if key in _RUNS:
        return _RUNS[key]
    from kubernetes_tpu.controllers.rebalance import score_from_snapshot as jscore
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_replay(rebalance=KNOBS if rebalance else False, **SMALL)
    if mode == "batch-depth0":
        os.environ["KTPU_PIPELINE_DEPTH"] = "0"
    try:
        pair = LoopPair(batch=32)
    finally:
        os.environ.pop("KTPU_PIPELINE_DEPTH", None)
    for ni in w.node_infos():
        pair.jstore.create_node(to_jax(ni.node))
        pair.tstore.create_node(ni.node)
    for q in w.quotas():
        pair.add_quota(q.meta.namespace, q.hard, weight=q.weight, cohort=q.cohort)
    seq = mode == "sequential"
    with Recorders(pair, tracing=False) as rec:
        jout = workloads.replay_rounds(w, pair.jstore, pair.jsched, pair.jclock, convert=to_jax,
                                       score_fn=jscore, sequential=seq)
        tout = workloads.replay_rounds(w, pair.tstore, pair.tsched, pair.tclock, sequential=seq)
        jflight = [ev for ev in flight_view(rec.jax[0]) if ev[0] != "retrace_storm"]
        tflight = flight_view(rec.port[0])
        je2e = _e2e_by_tenant(rec.jax[1], w.tenants())
        te2e = _e2e_by_tenant(rec.port[1], w.tenants())
    pair.assert_gang_equal()
    _RUNS[key] = (jout, tout, jflight, tflight, je2e, te2e)
    return _RUNS[key]


@pytest.mark.parametrize("mode", PARITY_MODES)
@pytest.mark.parametrize("rebalance", [True, False], ids=["rebalance", "norebalance"])
def test_replay_matches_jax(rebalance, mode):
    jout, tout, jflight, tflight, je2e, te2e = _run(rebalance, mode)
    got, want = tout["invariants"], jout["invariants"]
    for key in ("PackingEff", "FinalEntropy"):
        assert abs(got[key] - want[key]) <= TOL, key
    assert {k: v for k, v in got.items() if k not in ("PackingEff", "FinalEntropy")} == {
        k: v for k, v in want.items() if k not in ("PackingEff", "FinalEntropy")}
    assert np.allclose(tout["entropies"], jout["entropies"], atol=TOL, rtol=0)
    strip = [{k: v for k, v in wv.items() if k != "entropy"} for wv in tout["waves"]]
    assert strip == [{k: v for k, v in wv.items() if k != "entropy"} for wv in jout["waves"]]
    assert np.allclose([wv["entropy"] for wv in tout["waves"]],
                       [wv["entropy"] for wv in jout["waves"]], atol=TOL, rtol=0)
    assert len(tout["waves"]) == got["Waves"]
    assert tout["cycles"] == jout["cycles"]
    assert tflight == jflight and all(len(ev) == len(FLIGHT_KEYS) for ev in tflight)
    if rebalance:
        assert any(ev[0] == "evict_wave" for ev in tflight)
        assert any(ev[0] == "rebalance_wave" for ev in tflight)
    assert te2e == je2e
    for ns, obs in te2e.items():
        t, j = tout["tenants"][ns], jout["tenants"][ns]
        assert (t["Weight"], t["E2eCount"]) == (j["Weight"], j["E2eCount"])
        assert t["E2eCount"] == len(obs) > 0
        assert t["E2eP50"] == float(np.quantile(obs, 0.50))
        assert t["E2eP99"] == float(np.quantile(obs, 0.99))


@pytest.mark.parametrize("mode", MODES)
def test_rebalancer_ran_and_converged(mode):
    on, off = _run(True, mode)[1]["invariants"], _run(False, mode)[1]["invariants"]
    assert on["Waves"] > 0 and on["Migrations"] > 0
    assert off["Waves"] == 0 and off["Migrations"] == 0
    assert on["PendingUncordons"] == 0
    assert on["PendingAtEnd"] == 0 and off["PendingAtEnd"] == 0
    if mode == "batch":
        assert not on["Suspended"]


@pytest.mark.parametrize("mode", MODES)
def test_packing_measurably_better_with_rebalancing(mode):
    on, off = _run(True, mode)[1]["invariants"], _run(False, mode)[1]["invariants"]
    if mode == "sequential":
        assert on["PackingEff"] > off["PackingEff"] + 0.005, (on["PackingEff"],
                                                              off["PackingEff"])
        assert on["FinalEntropy"] < off["FinalEntropy"]
        assert on["Waves"] > 1
    else:
        # the batch loop's finding: one wave, a smaller gain, and a final
        # score on either side of the /NoRebalance arm's
        assert on["Waves"] == 1
        assert on["PackingEff"] > off["PackingEff"]
        assert abs(on["FinalEntropy"] - off["FinalEntropy"]) < 0.01


@pytest.mark.parametrize("mode", MODES)
def test_no_tenant_p99_moved(mode):
    on, off = _run(True, mode)[1], _run(False, mode)[1]
    tol, floor = 2.0, 0.5
    assert set(on["tenants"]) == set(off["tenants"])
    for ns, t_off in off["tenants"].items():
        t_on = on["tenants"][ns]
        if t_on["E2eCount"] and t_off["E2eCount"]:
            assert t_on["E2eP99"] <= t_off["E2eP99"] * (1 + tol) + floor, ns
    assert (on["invariants"]["TenantP99Max"]
            <= off["invariants"]["TenantP99Max"] * (1 + tol) + floor)


def test_run_loop_replay_is_self_consistent():
    """``run_loop_replay`` (its own store and loop at LOOP_BATCH, the
    ledger on for the run) converges, turns the ledger off after, and its
    per-tenant counts are its e2e observations'."""
    from kubernetes_tpu_torch.metrics import latency_ledger
    from kubernetes_tpu_torch.perf import workloads

    out = workloads.run_loop_replay(workloads.scheduling_replay(rebalance=KNOBS, **SMALL), "cpu")
    inv = out["invariants"]
    assert inv["PendingAtEnd"] == 0 and inv["PendingUncordons"] == 0
    assert inv["Waves"] == len(out["waves"]) and len(out["score_s"]) > 0
    assert latency_ledger.get() is None
    for ns, obs in out["e2e"].items():
        assert len(obs) == out["tenants"][ns]["E2eCount"]
    assert all(out["placed"].values())
