"""The port's harness phases (``kubernetes_tpu_torch/perf/harness.py``:
``soak_phase``, ``borrow_phase``, ``replay_phase``, ``elastic_phase``)
against the JAX harness on FakeClocks, at the JAX tests' small sizes
(``tests/test_soak.py:50-54``, ``tests/test_borrow.py:34-38``,
``tests/test_rebalance.py:338-346``, ``tests/test_elastic.py:518-524``).

Both harnesses run the same test case in one process (C14), each on its
own FakeClock, the port's with ``device="cpu"`` and both with
``KTPU_BATCH_DEADLINE_MS=0``. The placements, the DataItems' names,
labels, units and data keys, and every invariant DataItem (SoakInvariants,
BorrowInvariants, ElasticInvariants, ReplayInvariants) are equal exactly,
but ReplayInvariants' PackingEff and FinalEntropy (to 1e-6: the entropy's
float32 sums are not XLA's, as in ``tests/test_torch_replay.py``). Per
tenant the counts (Admitted, BorrowedPeak, Weight,
WaitP50 / WaitP99 on the harness's own clock, E2eCount) are equal; the
E2eP50 / E2eP99 items hold the port's exact quantiles of the tenant's e2e
observations, and the port histogram's bucket estimate of the same
observations (``estimate``) equals the JAX item, which is that estimate.
TenantP99Max is the largest of those estimates, as the JAX one is. The JAX
tests' own bars then hold on the port's items.

The replay cases run in a child interpreter with ``PYTHONHASHSEED`` fixed
(``in_fixed_hash_order``): both loops take new node names into the snapshot
in a Python set's order (C14), so the replay's run depends on the process's
string hashes, in both packages alike. The two packages stay equal under
any seed, but under some seeds (4, of 0-9) the rebalancer's SLO guard
suspends it in both, and the JAX acceptance bar (``not Suspended``) fails
there; a pytest-xdist worker draws a random seed."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_harness import placements, run_case

TOL = 1e-6
SOAK = dict(nodes=32, rounds=4, scale=6, cycles_per_round=80, flap=False, tick_s=0.05)
SOAK_TPU = dict(nodes=32, rounds=4, scale=6, cycles_per_round=40, tick_s=0.05)
BORROW = dict(nodes=16, rounds=6, scale=8, cycles_per_round=60, tick_s=0.05)
REPLAY_KNOBS = {"cooldown_s": 1.0, "score_interval_s": 0.25, "entropy_high": 0.80,
                "entropy_low": 0.60, "max_migrations_per_wave": 8}
REPLAY = dict(nodes=24, rounds=6, scale=4, cycles_per_round=120, tick_s=0.05)
ELASTIC = dict(nodes=24, rounds=6, pods_per_round=12, drain_nodes=3, cycles_per_round=40,
               tick_s=0.05)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("KTPU_BATCH_DEADLINE_MS", "0")
    for key in ("KTPU_PIPELINE", "KTPU_PIPELINE_DEPTH", "KTPU_COMMIT_WORKER", "KTPU_FULL_BATCH",
                "KTPU_SPEC", "KTPU_LEDGER", "KTPU_TELEMETRY", "KTPU_TRACE_FILE"):
        monkeypatch.delenv(key, raising=False)
    yield
    from kubernetes_tpu.metrics import latency_ledger as jled
    from kubernetes_tpu_torch.metrics import latency_ledger as tled

    jled.disable()
    tled.disable()


_RUNS = {}


def both(name: str, backend: str, kw: dict, **runner_kw):
    """(JAX Runner, port Runner) of one case on FakeClocks, memoized."""
    key = (name, backend, repr(sorted(kw.items())), repr(sorted(runner_kw.items())))
    if key not in _RUNS:
        from kubernetes_tpu.utils.clock import FakeClock as JClock
        from kubernetes_tpu_torch.utils.clock import FakeClock

        _RUNS[key] = (run_case("jax", name, backend, kw, now_fn=JClock(), **runner_kw),
                      run_case("port", name, backend, kw, now_fn=FakeClock(), **runner_kw))
    return _RUNS[key]


def by_name(r, name: str) -> list:
    return [it for it in r.data_items if it.labels.get("Name") == name]


def tenant_map(r, name: str) -> dict:
    return {it.labels["namespace"]: it.data for it in by_name(r, name)}


def assert_same_shape(jr, tr) -> None:
    assert placements(tr) == placements(jr)
    assert [(it.unit, sorted(it.labels.items()), sorted(it.data)) for it in tr.data_items] == [
        (it.unit, sorted(it.labels.items()), sorted(it.data)) for it in jr.data_items]


def assert_tenants(jr, tr, name: str, counts) -> None:
    """Counts equal; E2e percentiles exact on the port, the JAX items its
    bucket estimate of the same observations."""
    hist = tr.scheduler.smetrics.tenant_e2e_duration
    jt, tt = tenant_map(jr, name), tenant_map(tr, name)
    assert set(tt) == set(jt)
    for ns, t in tt.items():
        assert {k: t[k] for k in counts} == {k: jt[ns][k] for k in counts}, ns
        vals = hist.values(ns)
        assert len(vals) == t["E2eCount"]
        for q, key in ((0.5, "E2eP50"), (0.99, "E2eP99")):
            assert t[key] == (float(np.quantile(vals, q)) if vals else 0.0), (ns, key)
            assert hist.estimate(q, ns) == jt[ns][key], (ns, key)


def test_soak_matches_jax():
    jr, tr = both("SchedulingSoak", "oracle", SOAK)
    assert_same_shape(jr, tr)
    (tinv,) = by_name(tr, "SoakInvariants")
    (jinv,) = by_name(jr, "SoakInvariants")
    assert tinv.data == jinv.data
    assert_tenants(jr, tr, "SoakTenant", ("Admitted", "Weight", "WaitP50", "WaitP99",
                                          "E2eCount"))
    # the JAX test's bar (tests/test_soak.py:56-67)
    assert tinv.data["OversubscriptionViolations"] == 0.0 and tinv.data["GatedAtEnd"] > 0
    assert tinv.data["BreakerState"] == -1.0 and tinv.data["FlapBatches"] == 0.0
    tenants = tenant_map(tr, "SoakTenant")
    assert set(tenants) == {"soak-a", "soak-b", "soak-c"}
    total = sum(t["Admitted"] for t in tenants.values())
    wsum = sum(t["Weight"] for t in tenants.values())
    for ns, t in tenants.items():
        fair = t["Weight"] / wsum
        assert abs(t["Admitted"] / total - fair) <= 0.2 * fair + 2 / total, ns


def test_soak_tpu_flap_matches_jax():
    """The batched path with the scripted device flap and the comparer
    (``tests/test_soak.py:135``'s case): the flap's commits go through the
    relay death path and its breaker on both, and every SoakInvariants
    item is equal, but ComparerMismatches, where the JAX comparer also
    flags winners whose quota the batch committed before them used up
    (ROADMAP C18): the port's finds none."""
    jr, tr = both("SchedulingSoak", "tpu", SOAK_TPU, comparer_every_n=2)
    assert_same_shape(jr, tr)
    (tinv,) = by_name(tr, "SoakInvariants")
    (jinv,) = by_name(jr, "SoakInvariants")
    got, want = dict(tinv.data), dict(jinv.data)
    assert got.pop("ComparerMismatches") == 0.0 and want.pop("ComparerMismatches") >= 0.0
    assert got == want
    assert_tenants(jr, tr, "SoakTenant", ("Admitted", "Weight", "WaitP50", "WaitP99",
                                          "E2eCount"))
    # the JAX test's bar (tests/test_soak.py:139-152)
    assert got["OversubscriptionViolations"] == 0.0
    assert got["FlapBatches"] > 0 and got["DegradedSeconds"] > 0
    assert got["ComparerChecks"] > 0
    tenants = tenant_map(tr, "SoakTenant")
    assert sum(t["Admitted"] for t in tenants.values()) > 0
    assert tr.scheduler.relay_breaker.opens == jr.scheduler.relay_breaker.opens == 1


@pytest.mark.parametrize("borrowing", [True, False], ids=["borrow", "noborrow"])
def test_borrow_matches_jax(borrowing):
    check_borrow(borrowing, "oracle")


@pytest.mark.parametrize("borrowing", [True, False], ids=["borrow", "noborrow"])
def test_borrow_tpu_matches_jax(borrowing):
    check_borrow(borrowing, "tpu")


def check_borrow(borrowing: bool, backend: str) -> None:
    kw = dict(BORROW, borrowing=borrowing)
    jr, tr = both("SchedulingBorrow", backend, kw)
    assert_same_shape(jr, tr)
    (tinv,) = by_name(tr, "BorrowInvariants")
    (jinv,) = by_name(jr, "BorrowInvariants")
    assert tinv.data == jinv.data
    assert tinv.data["OversubscriptionViolations"] == 0.0
    assert (tinv.data["LoansOutstandingPeak"] > 0) == borrowing
    assert_tenants(jr, tr, "BorrowTenant", ("Admitted", "BorrowedPeak", "E2eCount"))


def test_borrow_raises_pool_utilization():
    """The JAX test's headline (``tests/test_borrow.py:43-55``) on the
    port's items: borrowing lifts mean pool utilization by more than 0.10,
    and the lender's burst is funded by reclaims."""
    on = by_name(both("SchedulingBorrow", "oracle", dict(BORROW, borrowing=True))[1],
                 "BorrowInvariants")[0].data
    off = by_name(both("SchedulingBorrow", "oracle", dict(BORROW, borrowing=False))[1],
                  "BorrowInvariants")[0].data
    assert off["LoansOutstandingPeak"] == 0.0 and on["Reclaims"] > 0
    assert on["PoolUtilizationMean"] - off["PoolUtilizationMean"] > 0.10


@pytest.mark.parametrize("rebalance", [True, False], ids=["rebalance", "norebalance"])
def test_replay_matches_jax(rebalance):
    in_fixed_hash_order("check_replay", rebalance, "oracle")


@pytest.mark.parametrize("rebalance", [True, False], ids=["rebalance", "norebalance"])
def test_replay_tpu_matches_jax(rebalance):
    in_fixed_hash_order("check_replay", rebalance, "tpu")


HASH_SEED = "0"


def in_fixed_hash_order(name: str, *args) -> None:
    """This module's ``name(*args)`` under ``PYTHONHASHSEED=HASH_SEED``:
    here when this interpreter already runs under it, else in a child
    interpreter (with this one's environment, the test's monkeypatched
    variables included) that must exit 0."""
    if os.environ.get("PYTHONHASHSEED") == HASH_SEED:
        globals()[name](*args)
        return
    tests = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{os.path.dirname(tests)!r}, {tests!r}]; "
            f"import test_torch_harness_phases as t; t.{name}(*{args!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(tests),
                          env=dict(os.environ, PYTHONHASHSEED=HASH_SEED),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout[-6000:], proc.stderr[-6000:])


def check_replay(rebalance: bool, backend: str) -> None:
    kw = dict(REPLAY, rebalance=REPLAY_KNOBS if rebalance else False)
    jr, tr = both("SchedulingReplay", backend, kw)
    assert_same_shape(jr, tr)
    (tinv,) = by_name(tr, "ReplayInvariants")
    (jinv,) = by_name(jr, "ReplayInvariants")
    got, want = tinv.data, jinv.data
    inexact = ("PackingEff", "FinalEntropy")
    for key in inexact:
        assert abs(got[key] - want[key]) <= TOL, key
    assert {k: v for k, v in got.items() if k not in inexact} == {
        k: v for k, v in want.items() if k not in inexact}
    tenants = tenant_map(tr, "ReplayTenant")
    hist = tr.scheduler.smetrics.tenant_e2e_duration
    assert got["TenantP99Max"] == max(hist.estimate(0.99, ns)
                                      for ns, t in tenants.items() if t["E2eCount"])
    assert_tenants(jr, tr, "ReplayTenant", ("Weight", "E2eCount"))
    # the JAX acceptance's bar (tests/test_rebalance.py:363-371)
    assert got["PendingAtEnd"] == 0 and got["PendingUncordons"] == 0
    if rebalance:
        assert got["Waves"] > 0 and got["Migrations"] > 0 and not got["Suspended"]
    else:
        assert got["Waves"] == 0 and got["Migrations"] == 0


def test_replay_rebalancing_packs_better():
    in_fixed_hash_order("check_packs_better")


def check_packs_better() -> None:
    on = by_name(both("SchedulingReplay", "oracle", dict(REPLAY, rebalance=REPLAY_KNOBS))[1],
                 "ReplayInvariants")[0].data
    off = by_name(both("SchedulingReplay", "oracle", dict(REPLAY, rebalance=False))[1],
                  "ReplayInvariants")[0].data
    assert on["PackingEff"] > off["PackingEff"] + 0.005
    assert on["FinalEntropy"] < off["FinalEntropy"]


def test_elastic_matches_jax():
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster

    jr, tr = both("SchedulingElastic", "tpu", ELASTIC)
    assert_same_shape(jr, tr)
    (tinv,) = by_name(tr, "ElasticInvariants")
    (jinv,) = by_name(jr, "ElasticInvariants")
    # HbmPeakBytes is the device telemetry's: off in both runs
    assert tinv.data == jinv.data
    inv = tinv.data
    # the JAX test's bar (tests/test_elastic.py:526-543)
    assert inv["LostPods"] == 0.0 and inv["Oversubscribed"] == 0.0 and inv["PendingAtEnd"] == 0.0
    assert inv["NodesRemoved"] > 0 and inv["NodesAdded"] > 0 and inv["SlotReuses"] > 0
    assert inv["EvictedPods"] > 0 and inv["UploadBytesSteady"] == 0.0
    assert inv["RowCapacity"] == float(caps_for_cluster(24).nodes)
