"""The port's metrics registry (``kubernetes_tpu_torch/metrics/registry.py``)
and the scheduler's families in it (``metrics/scheduler_metrics.py``)
against the JAX registry (``kubernetes_tpu/metrics/registry.py``) on the
CPU.

The same observation sequences go into both registries: counters, gauges
and histograms with label sets, values on and between bucket bounds, past
the last bound, repeated and awkward label values. ``expose()`` must be
byte-equal; each histogram's per-bucket counts, count and sum equal the
JAX one's; ``estimate`` / ``estimate_since`` equal the JAX ``percentile`` /
``percentile_since``; the port's ``percentile`` / ``percentile_since`` are
``numpy.quantile`` of the observations. Every family of the port's
``SchedulerMetrics`` is in its registry under the JAX family's name, label
names and buckets (the JAX ``SchedulerMetrics`` has a family of the same
attribute name); the two families the harness scrapes by default and the
port lacked, ``scheduler_scheduling_algorithm_duration_seconds`` and
``scheduler_tpu_batch_duration_seconds``, count per label set what the
JAX loop counts over a whole harness run."""

import numpy as np
import pytest

from kubernetes_tpu.metrics import registry as jreg
from kubernetes_tpu_torch.metrics import registry as treg

VALUES = [0.0005, 0.001, 0.0015, 0.002, 0.004, 0.0041, 0.1, 0.25, 1.0, 3.3, 16.384, 17.0, 400.0,
          0.002, 0.002, 1e-7]


def _fill(mod):
    reg = mod.Registry()
    c = reg.register(mod.Counter("t_ops_total", "Ops by kind.", ["kind"]))
    g = reg.register(mod.Gauge("t_level", "A level.", ["pool"]))
    h = reg.register(mod.Histogram("t_latency_seconds", "Latency.", ["point", "status"]))
    e = reg.register(mod.Histogram("t_e2e_seconds", "E2e.", ["ns"],
                                   buckets=mod.exponential_buckets(0.005, 2, 16)))
    u = reg.register(mod.Counter("t_plain_total", "No labels."))
    rng = np.random.RandomState(3)
    for i, v in enumerate(VALUES):
        h.observe(v, "filter", "Success")
        if i % 3 == 0:
            h.observe(v * 2, "bind", 'Err"or\\x\n')
        e.observe(float(rng.exponential(2.0)), f"t{i % 2}")
        c.inc("a")
        c.inc("b", value=2.5)
        g.set("p1", value=i)
    u.inc()
    g.set("p2", value=0.75)
    assert reg.register(mod.Counter("t_ops_total", "again", ["x"])) is c
    return reg, h, e


def test_expose_and_buckets_match_jax():
    jr, jh, je = _fill(jreg)
    tr, th, te = _fill(treg)
    assert tr.expose() == jr.expose()
    for j, t in ((jh, th), (je, te)):
        assert t.buckets == j.buckets and t.label_names == j.label_names
        assert sorted(t.label_sets()) == sorted(j.label_sets())
        for lv in j.label_sets():
            assert t.bucket_counts(*lv) == j._counts[lv]
            assert (t.count(*lv), t.sum(*lv)) == (j.count(*lv), j.sum(*lv))
            for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
                assert t.estimate(q, *lv) == j.percentile(q, *lv)
                assert t.percentile(q, *lv) == float(np.quantile(t.values(*lv), q))
    assert tr.get("t_level").labels("p1") == jr.get("t_level").labels("p1") == len(VALUES) - 1
    assert tr.get("nope") is None and "t_plain_total 1.0" in tr.expose()


def test_phase_deltas_match_jax():
    out = []
    for mod in (jreg, treg):
        h = mod.Histogram("d_seconds", "Delta.", ["r"])
        for v in VALUES[:6]:
            h.observe(v, "ok")
        snap = h.snapshot("ok")
        empty = h.snapshot("new")
        for v in VALUES[6:]:
            h.observe(v, "ok")
        h.observe(0.3, "new")
        out.append((h, snap, empty))
    (jh, jsnap, jempty), (th, tsnap, tempty) = out
    assert th.count_since(tsnap, "ok") == jh.count_since(jsnap, "ok") == len(VALUES) - 6
    assert th.count_since(tempty, "new") == jh.count_since(jempty, "new") == 1
    for q in (0.5, 0.9, 0.99):
        assert th.estimate_since(tsnap, q, "ok") == jh.percentile_since(jsnap, q, "ok")
        assert th.estimate_since(tempty, q, "new") == jh.percentile_since(jempty, q, "new")
        assert th.percentile_since(tsnap, q, "ok") == float(np.quantile(VALUES[6:], q))
    assert th.percentile_since(0, 0.5, "none") == 0.0 == th.estimate(0.5, "none")
    assert treg.Histogram("e_seconds", "Empty.").collect() == ["# HELP e_seconds Empty.",
                                                               "# TYPE e_seconds histogram"]


def test_scheduler_families_carry_the_jax_names():
    from kubernetes_tpu.metrics.scheduler_metrics import SchedulerMetrics as JMetrics
    from kubernetes_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics

    jm, tm = JMetrics(), SchedulerMetrics()
    families = {attr: fam for attr, fam in vars(tm).items()
                if isinstance(fam, (treg.Counter, treg.Histogram))}
    assert len(families) == tm.registry.expose().count("# TYPE ") >= 40
    for attr, fam in families.items():
        jfam = getattr(jm, attr)
        assert (fam.name, fam.label_names, type(fam).__name__) == (
            jfam.name, jfam.label_names, type(jfam).__name__), attr
        assert tm.registry.get(fam.name) is fam
        if isinstance(fam, treg.Histogram):
            assert fam.buckets == jfam.buckets, attr
    for name in ("scheduler_scheduling_algorithm_duration_seconds",
                 "scheduler_tpu_batch_duration_seconds",
                 "scheduler_framework_extension_point_duration_seconds",
                 "scheduler_plugin_execution_duration_seconds"):
        assert tm.registry.get(name) is not None


@pytest.mark.parametrize("backend", ["oracle", "tpu"])
def test_new_families_count_as_jax(monkeypatch, backend):
    """Over a whole SchedulingBasic run (init, barrier, warm sweep,
    measured pods), the two new families see as many observations per
    label set as the JAX loop's."""
    from test_torch_harness import run_case

    monkeypatch.setenv("KTPU_BATCH_DEADLINE_MS", "0")
    for key in ("KTPU_PIPELINE_DEPTH", "KTPU_COMMIT_WORKER", "KTPU_FULL_BATCH", "KTPU_SPEC"):
        monkeypatch.delenv(key, raising=False)
    kw = dict(nodes=24, init_pods=10, measured=30)
    runs = [run_case(pkg, "SchedulingBasic", backend, kw, batch_size=8) for pkg in ("jax", "port")]

    def counts(r):
        out = {}
        for name in ("scheduler_scheduling_algorithm_duration_seconds",
                     "scheduler_tpu_batch_duration_seconds"):
            h = r.scheduler.smetrics.registry.get(name)
            out[name] = {lv: h.count(*lv) for lv in h.label_sets()}
        return out

    got, want = counts(runs[1]), counts(runs[0])
    assert got == want
    algo = got["scheduler_scheduling_algorithm_duration_seconds"]
    phases = got["scheduler_tpu_batch_duration_seconds"]
    if backend == "oracle":
        assert algo == {("default-scheduler",): 40} and phases == {}
    else:
        assert algo == {} and phases[("upload",)] == phases[("commit",)] > 0
