"""SchedulingBorrow (``kubernetes_tpu_torch/perf/workloads.py:Borrow``,
``borrow_rounds``) through the port's scheduler loop against the JAX loop
on the CPU, at the JAX test's small size (``tests/test_borrow.py:34-38``:
16 nodes, rounds 6, scale 8, 60 cycles per round, tick 0.05 s), both arms.

``workloads.borrow_rounds`` drives both packages' loops (``LoopPair``, each
on its own FakeClock, each package's latency ledger on): the
BorrowInvariants (pool utilization mean and peak, loans outstanding peak,
reclaims, borrow-aware oversubscription) and each tenant's Admitted /
BorrowedPeak / E2eCount equal the JAX loop's, and each tenant's e2e
observations (the ledger's closed entries) equal the JAX ledger's; the
placements, queues and quota metrics too. E2eP50 / E2eP99 are the port's
exact quantiles of those observations (the JAX registry's are bucket
estimates of the same ones). Then the JAX test's bar
(``tests/test_borrow.py:50-126``) on the port: with borrowing on the mean
pool utilization rises by more than 0.10 over the /NoBorrow arm, reclaims
fund the lender's burst, the borrower's loans are recorded and the lender
never borrows, the lender's p99 holds within 3 s of the other arm, every
lender arrival is admitted in both arms, and no sample of either arm is
oversubscribed. ``run_loop_borrow`` returns the same numbers as the pair's
port side."""

import numpy as np
import pytest

from _torch_cases import LoopPair, Recorders, to_jax

SMALL = dict(nodes=16, rounds=6, scale=8, cycles_per_round=60, tick_s=0.05)


@pytest.fixture(autouse=True)
def _ledgers_off(monkeypatch):
    monkeypatch.delenv("KTPU_PIPELINE", raising=False)
    monkeypatch.delenv("KTPU_PIPELINE_DEPTH", raising=False)
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    yield
    from kubernetes_tpu.metrics import latency_ledger as jled
    from kubernetes_tpu_torch.metrics import latency_ledger as tled

    jled.disable()
    tled.disable()


def _e2e_by_tenant(ledger, tenants) -> dict:
    """namespace -> the e2e of its scheduled pods' closed entries, in close
    order."""
    out = {ns: [] for ns in tenants}
    for e in ledger.timeline_entries():
        ns = e["namespace"]
        if e["closed"] is not None and e["result"] == "scheduled" and ns in out:
            out[ns].append(e["closed"] - e["opened"])
    return out


_RUNS = {}


def _run(borrowing: bool):
    """Both loops through one arm (memoized per arm): (JAX out, port out,
    JAX e2e, port e2e, the pair's port gang state)."""
    if borrowing in _RUNS:
        return _RUNS[borrowing]
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_borrow(borrowing=borrowing, **SMALL)
    pair = LoopPair(batch=32)
    for ni in w.node_infos():
        pair.jstore.create_node(to_jax(ni.node))
        pair.tstore.create_node(ni.node)
    for q in w.quotas():
        pair.add_quota(q.meta.namespace, q.hard, weight=q.weight, cohort=q.cohort)
    with Recorders(pair, telemetry=False, tracing=False) as rec:
        jout = workloads.borrow_rounds(w, pair.jstore, pair.jsched, pair.jsched._quota_plugin(),
                                       pair.jclock, convert=to_jax)
        tout = workloads.borrow_rounds(w, pair.tstore, pair.tsched, pair.tsched._quota_plugin(),
                                       pair.tclock)
        je2e, te2e = (_e2e_by_tenant(rec.jax[1], w.tenants()),
                      _e2e_by_tenant(rec.port[1], w.tenants()))
    state = pair.assert_gang_equal()
    _RUNS[borrowing] = (jout, tout, je2e, te2e, state)
    return _RUNS[borrowing]


@pytest.mark.parametrize("borrowing", [True, False], ids=["borrow", "noborrow"])
def test_borrow_matches_jax(borrowing):
    jout, tout, je2e, te2e, _state = _run(borrowing)
    assert tout["invariants"] == jout["invariants"]
    assert tout["cycles"] == jout["cycles"]
    for ns, want in jout["tenants"].items():
        got = tout["tenants"][ns]
        for key in ("Admitted", "BorrowedPeak", "E2eCount"):
            assert got[key] == want[key], (ns, key)
    assert te2e == je2e
    for ns, obs in te2e.items():
        got = tout["tenants"][ns]
        assert got["E2eCount"] == len(obs) > 0
        assert got["E2eP50"] == float(np.quantile(obs, 0.50))
        assert got["E2eP99"] == float(np.quantile(obs, 0.99))


def test_borrowing_raises_pool_utilization():
    on, off = _run(True)[1]["invariants"], _run(False)[1]["invariants"]
    assert on["LoansOutstandingPeak"] > 0 and off["LoansOutstandingPeak"] == 0.0
    lift = on["PoolUtilizationMean"] - off["PoolUtilizationMean"]
    assert lift > 0.10, lift


def test_lender_wakeup_reclaims_and_p99_holds():
    on, off = _run(True)[1], _run(False)[1]
    assert on["invariants"]["Reclaims"] > 0
    lender_on, lender_off = on["tenants"]["borrow-lender"], off["tenants"]["borrow-lender"]
    assert lender_on["E2eCount"] > 0 and lender_off["E2eCount"] > 0
    assert lender_on["E2eP99"] <= lender_off["E2eP99"] + 3.0
    assert lender_on["Admitted"] == lender_off["Admitted"]


def test_zero_oversubscription_both_arms():
    for borrowing in (True, False):
        assert _run(borrowing)[1]["invariants"]["OversubscriptionViolations"] == 0.0


def test_borrower_loans_attributed():
    tenants = _run(True)[1]["tenants"]
    assert tenants["borrow-hungry"]["BorrowedPeak"] > 0
    assert tenants["borrow-lender"]["BorrowedPeak"] == 0.0


def test_run_loop_borrow_is_the_loop_pair_port_side():
    """``run_loop_borrow`` (its own store and loop at LOOP_BATCH, the
    ledger on for the run) gives the same invariants and tenant numbers as
    the pair's port side at batch 32 (no round brings 32 pods), turns the
    ledger off after, and holds every pod it admitted but those evicted
    and not bound again."""
    from kubernetes_tpu_torch.metrics import latency_ledger
    from kubernetes_tpu_torch.perf import workloads

    out = workloads.run_loop_borrow(workloads.scheduling_borrow(**SMALL), "cpu")
    tout = _run(True)[1]
    assert out["invariants"] == tout["invariants"]
    assert out["tenants"] == tout["tenants"]
    assert latency_ledger.get() is None
    for ns, obs in out["e2e"].items():
        assert len(obs) == out["tenants"][ns]["E2eCount"]
    bound = sum(1 for n in out["placed"].values() if n)
    admitted = sum(t["Admitted"] for t in out["tenants"].values())
    assert admitted - out["evicted"] <= bound <= admitted
