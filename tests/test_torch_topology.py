"""The port's ops/topology.py against the JAX package's, function by
function, on seeded numpy inputs: every int and bool output equal, every
float32 output equal bit for bit. The general-mode functions run with a
domain axis of 64 and of 512, so both of JAX's ``_seg_sum`` branches (the
one-hot contraction up to 256 domains, the scatter above) are held against
the port's one scatter; some nodes lack each key, and some domain ids are
0. JAX runs jitted, as inside its batch program.

Also: ``size_log_table`` equals ``jnp.log(float32(size) + 2)`` bit for bit
for every size from 0 to 8194, where ``torch.log`` does not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import f32_bits
from kubernetes_tpu.ops import topology as jtopo
from kubernetes_tpu_torch.ops import topology as ttopo

N, K, S, T, C, A, PT = 96, 6, 6, 5, 2, 2, 2
SEEDS = (0, 1, 2)


def _case(seed: int, vd: int) -> dict:
    """One pod's topology programs and the count tables they read."""
    rng = np.random.RandomState(seed)
    top = min(vd, 300)  # value ids 1..top-1; above 256 for vd = 512
    label_val = rng.randint(1, top, size=(N, K)).astype(np.int32)
    label_val[rng.uniform(size=(N, K)) < 0.2] = 0      # nodes lacking the key
    label_val[:, 0] = 0                                 # key slot 0 is never a key
    label_val[:, 1] = rng.randint(1, 4, size=N)         # a key of few, shared domains
    label_val[rng.uniform(size=N) < 0.1, 1] = 0
    sel_counts = rng.randint(0, 4, size=(S, N)).astype(np.int32)
    sel_counts[0] = 0
    term_counts = rng.randint(0, 3, size=(T, N)).astype(np.int32)
    term_counts[0] = 0
    term_key = rng.randint(1, K, size=T).astype(np.int32)
    term_key[0] = 0

    def prog(n, rows):
        valid = rng.uniform(size=n) < 0.7
        sig = np.where(valid, rng.randint(1, rows, size=n), 0).astype(np.int32)
        key = np.where(valid, rng.choice([1, 1, 2, 3, 4, 5], size=n), 0).astype(np.int32)
        return valid, sig, key

    xs = {}
    xs["sf_valid"], xs["sf_sig"], xs["sf_key"] = prog(C, S)
    xs["sf_skew"] = rng.randint(1, 4, size=C).astype(np.int32)
    xs["sf_self"] = rng.uniform(size=C) < 0.5
    xs["sf_min_domains"] = np.where(rng.uniform(size=C) < 0.5, -1,
                                    rng.randint(1, 6, size=C)).astype(np.int32)
    xs["ss_valid"], xs["ss_sig"], xs["ss_key"] = prog(C, S)
    xs["ss_skew"] = rng.randint(1, 6, size=C).astype(np.int32)
    xs["ss_hostname"] = rng.uniform(size=C) < 0.3
    xs["ss_require_all"] = np.bool_(rng.uniform() < 0.6)
    xs["ia_valid"], xs["ia_sig"], xs["ia_key"] = prog(A, S)
    xs["ia_self_all"] = np.bool_(rng.uniform() < 0.5)
    xs["ianti_valid"], xs["ianti_sig"], xs["ianti_key"] = prog(A, S)
    xs["ip_valid"], xs["ip_sig"], xs["ip_key"] = prog(PT, S)
    xs["ip_w"] = rng.randint(-5, 6, size=PT).astype(np.int32)
    xs["term_filter_match"] = rng.uniform(size=T) < 0.4
    xs["term_score_w"] = rng.choice([-3.0, -1.0, 0.0, 1.0, 2.0], size=T).astype(np.float32)
    xs["pod_sig_mask"] = rng.uniform(size=S) < 0.5
    xs["pod_term_mask"] = rng.uniform(size=T) < 0.5
    d = {
        "xs": xs, "label_val": label_val, "sel_counts": sel_counts,
        "term_counts": term_counts, "term_key": term_key,
        "valid": rng.uniform(size=N) < 0.9, "affinity_ok": rng.uniform(size=N) < 0.8,
        "feasible": rng.uniform(size=N) < 0.7, "hostkey_ok": rng.uniform(size=N) < 0.85,
        "values": rng.randint(0, 5, size=(C, N)).astype(np.int32),
        "local_idx": np.int32(rng.randint(N)), "commit": np.bool_(rng.uniform() < 0.8),
    }
    # the existing-term tables the filters and scores read, made with numpy
    dom_t = label_val[:, term_key].T.copy()
    seg_exist = np.zeros((T, vd), np.int32)
    add = np.where(d["valid"][None, :] & (dom_t > 0), term_counts, 0)
    np.add.at(seg_exist, (np.arange(T)[:, None], dom_t), add)
    d["dom_t"], d["seg_exist"] = dom_t, seg_exist
    d["exist_at"] = np.where(dom_t > 0, np.take_along_axis(seg_exist, dom_t, axis=1), 0)
    d["host_exist"] = np.where(d["hostkey_ok"][None, :], term_counts, 0)
    return d


def _j(d, name):
    """A field inside the jitted JAX call (a tracer)."""
    return d[name]


def _t(d, name):
    v = d[name]
    if name == "xs":
        return {k: torch.from_numpy(np.asarray(x)) for k, x in v.items()}
    t = torch.from_numpy(np.asarray(v))
    return t.long() if name == "dom_t" else t


def _log_tbl(vd):
    return ttopo.size_log_table(max(N, vd) + 1, "cpu")


def _jax_run(fn, d, *args):
    """``fn`` jitted with every array of the case as a traced argument (no
    constant folding: the compiled CPU code runs, as in the batch program)."""
    return jax.jit(lambda dd: fn(dd, *args))(d)


# name -> (jax call, torch call); each returns a tuple of outputs
GENERAL = {
    "make_static": (
        lambda d, vd: tuple(jtopo.make_static(_j(d, "term_counts"), _j(d, "term_key"),
                                              _j(d, "label_val"), _j(d, "valid"), vd)),
        lambda d, vd: tuple(ttopo.make_static(_t(d, "term_counts"), _t(d, "term_key"),
                                              _t(d, "label_val"), _t(d, "valid"), vd))),
    "_seg_sum": (
        lambda d, vd: (jtopo._seg_sum(_j(d, "values"), _j(d, "label_val")[:, 1:1 + C].T,
                                      vd, None),),
        lambda d, vd: (ttopo._seg_sum(_t(d, "values"), _t(d, "label_val")[:, 1:1 + C].T.long(),
                                      vd),)),
    "_seg_counts": (
        lambda d, vd: jtopo._seg_counts(_j(d, "xs")["sf_sig"], _j(d, "xs")["sf_key"],
                                        _j(d, "sel_counts"), _j(d, "label_val"),
                                        _j(d, "affinity_ok"), vd, None),
        lambda d, vd: ttopo._seg_counts(_t(d, "xs")["sf_sig"], _t(d, "xs")["sf_key"],
                                        _t(d, "sel_counts"), _t(d, "label_val"),
                                        _t(d, "affinity_ok"), vd)),
    "spread_filter": (
        lambda d, vd: (jtopo.spread_filter(_j(d, "xs"), _j(d, "sel_counts"), _j(d, "label_val"),
                                           _j(d, "valid"), _j(d, "affinity_ok"), vd, None),),
        lambda d, vd: (ttopo.spread_filter(_t(d, "xs"), _t(d, "sel_counts"), _t(d, "label_val"),
                                           _t(d, "valid"), _t(d, "affinity_ok"), vd),)),
    "ipa_filter": (
        lambda d, vd: jtopo.ipa_filter(_j(d, "xs"), _j(d, "sel_counts"), _j(d, "seg_exist"),
                                       _j(d, "dom_t"), _j(d, "label_val"),
                                       _j(d, "valid"), vd, None),
        lambda d, vd: ttopo.ipa_filter(_t(d, "xs"), _t(d, "sel_counts"),
                                       _t(d, "seg_exist"),
                                       _t(d, "dom_t"), _t(d, "label_val"),
                                       _t(d, "valid"), vd)),
    "spread_score": (
        lambda d, vd: (jtopo.spread_score(_j(d, "xs"), _j(d, "sel_counts"), _j(d, "label_val"),
                                          _j(d, "valid"), _j(d, "affinity_ok"),
                                          _j(d, "feasible"), vd, None),),
        lambda d, vd: (ttopo.spread_score(_t(d, "xs"), _t(d, "sel_counts"), _t(d, "label_val"),
                                          _t(d, "valid"), _t(d, "affinity_ok"),
                                          _t(d, "feasible"), vd, _log_tbl(vd)),)),
    "ipa_score": (
        lambda d, vd: (jtopo.ipa_score(_j(d, "xs"), _j(d, "sel_counts"), _j(d, "exist_at"),
                                       _j(d, "label_val"), _j(d, "valid"), _j(d, "feasible"),
                                       vd, None),),
        lambda d, vd: (ttopo.ipa_score(_t(d, "xs"), _t(d, "sel_counts"),
                                       _t(d, "exist_at"), _t(d, "label_val"),
                                       _t(d, "valid"), _t(d, "feasible"), vd),)),
    "commit_update": (
        lambda d, vd: jtopo.commit_update(_j(d, "sel_counts"), _j(d, "seg_exist"),
                                          _j(d, "dom_t"), _j(d, "local_idx"),
                                          _j(d, "commit"), np.True_, _j(d, "xs")["pod_sig_mask"],
                                          _j(d, "xs")["pod_term_mask"], None),
        lambda d, vd: ttopo.commit_update(_t(d, "sel_counts"), _t(d, "seg_exist"),
                                          _t(d, "dom_t"), _t(d, "local_idx"),
                                          _t(d, "commit"), _t(d, "xs")["pod_sig_mask"],
                                          _t(d, "xs")["pod_term_mask"])),
}

HOST = {
    "spread_filter_host": (
        lambda d: (jtopo.spread_filter_host(_j(d, "xs"), _j(d, "sel_counts"), _j(d, "hostkey_ok"),
                                            _j(d, "valid"), _j(d, "affinity_ok"), None),),
        lambda d: (ttopo.spread_filter_host(_t(d, "xs"), _t(d, "sel_counts"), _t(d, "hostkey_ok"),
                                            _t(d, "valid"), _t(d, "affinity_ok")),)),
    "ipa_filter_host": (
        lambda d: jtopo.ipa_filter_host(_j(d, "xs"), _j(d, "sel_counts"), _j(d, "term_counts"),
                                        _j(d, "hostkey_ok"), _j(d, "valid"), None),
        lambda d: ttopo.ipa_filter_host(_t(d, "xs"), _t(d, "sel_counts"), _t(d, "term_counts"),
                                        _t(d, "hostkey_ok"), _t(d, "valid"))),
    "spread_score_host": (
        lambda d: (jtopo.spread_score_host(_j(d, "xs"), _j(d, "sel_counts"), _j(d, "hostkey_ok"),
                                           _j(d, "valid"), _j(d, "affinity_ok"),
                                           _j(d, "feasible"), None),),
        lambda d: (ttopo.spread_score_host(_t(d, "xs"), _t(d, "sel_counts"), _t(d, "hostkey_ok"),
                                           _t(d, "valid"), _t(d, "affinity_ok"),
                                           _t(d, "feasible"), _log_tbl(N)),)),
    "ipa_score_host": (
        lambda d: (jtopo.ipa_score_host(_j(d, "xs"), _j(d, "sel_counts"),
                                        _j(d, "host_exist"),
                                        _j(d, "hostkey_ok"), _j(d, "feasible"), None),),
        lambda d: (ttopo.ipa_score_host(_t(d, "xs"), _t(d, "sel_counts"),
                                        _t(d, "host_exist"),
                                        _t(d, "hostkey_ok"), _t(d, "feasible")),)),
    "commit_update_host": (
        lambda d: jtopo.commit_update_host(_j(d, "sel_counts"), _j(d, "term_counts"),
                                           _j(d, "local_idx"), _j(d, "commit"), np.True_,
                                           _j(d, "xs")["pod_sig_mask"],
                                           _j(d, "xs")["pod_term_mask"]),
        lambda d: ttopo.commit_update_host(_t(d, "sel_counts"), _t(d, "term_counts"),
                                           _t(d, "local_idx"), _t(d, "commit"),
                                           _t(d, "xs")["pod_sig_mask"],
                                           _t(d, "xs")["pod_term_mask"])),
}


def _assert_same(jout, tout):
    assert len(jout) == len(tout)
    for i, (a, b) in enumerate(zip(jout, tout)):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if a.dtype == np.float32:
            assert b.dtype == np.float32, i
            np.testing.assert_array_equal(f32_bits(a), f32_bits(b), err_msg=f"output {i}")
        else:
            assert a.dtype.kind == b.dtype.kind, (i, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"output {i}")


@pytest.mark.parametrize("vd", [64, 512])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_mode_function_matches_jax(name, seed, vd):
    d = _case(seed, vd)
    jfn, tfn = GENERAL[name]
    _assert_same(_jax_run(jfn, d, vd), tfn(d, vd))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(HOST))
def test_hostname_function_matches_jax(name, seed):
    d = _case(seed, 64)
    jfn, tfn = HOST[name]
    _assert_same(_jax_run(jfn, d), tfn(d))


def test_cases_exercise_every_branch():
    """The seeded inputs reach what the functions branch on: nodes without
    a key, both sides of every validity mask, and, over the seeds, a
    spread-filter failure, an anti-affinity violation and a nonzero score."""
    seen = set()
    for seed in SEEDS:
        d = _case(seed, 64)
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in d["xs"].items()}
        assert (d["label_val"][:, 1:] == 0).any() and (d["label_val"][:, 1:] > 0).any()
        ok = ttopo.spread_filter(t, _t(d, "sel_counts"), _t(d, "label_val"), _t(d, "valid"),
                                 _t(d, "affinity_ok"), 64)
        _, anti_ok, exist_ok, _ = ttopo.ipa_filter(
            t, _t(d, "sel_counts"), _t(d, "seg_exist"),
            _t(d, "dom_t"), _t(d, "label_val"), _t(d, "valid"), 64)
        sc = ttopo.spread_score(t, _t(d, "sel_counts"), _t(d, "label_val"), _t(d, "valid"),
                                _t(d, "affinity_ok"), _t(d, "feasible"), 64, _log_tbl(64))
        seen |= {("spread_fail", bool((~ok).any())), ("anti_fail", bool((~anti_ok).any())),
                 ("exist_fail", bool((~exist_ok).any())), ("score", bool((sc > 0).any()))}
    assert {("spread_fail", True), ("anti_fail", True), ("exist_fail", True),
            ("score", True)} <= seen


def test_size_log_table_matches_jnp_log():
    sizes = np.arange(8195, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: jnp.log(s.astype(jnp.float32) + 2.0))(sizes))
    got = ttopo.size_log_table(len(sizes), "cpu").numpy()
    np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
    # torch.log is correctly rounded here; XLA's float32 log is not, so a
    # table read is needed for the same bits
    plain = torch.log(torch.from_numpy(sizes).to(torch.float32) + 2.0).numpy()
    assert not np.array_equal(f32_bits(plain), f32_bits(want))


def test_spread_score_host_where_torch_log_would_round_differently():
    """1429 feasible nodes and a node holding 62 matching pods: there
    62 * log(1431) rounds one way with XLA's log and the other with
    torch.log, so only the table gives JAX's score."""
    n, size, cnt = 1536, 1429, 62
    rng = np.random.RandomState(7)
    sel_counts = np.zeros((S, n), np.int32)
    sel_counts[1] = rng.randint(0, 4, size=n)
    sel_counts[1, 3] = cnt
    sel_counts[1, 5] = 200  # the maximum, so node 3's normalized score shows the rounding
    xs = {k: np.asarray(v) for k, v in _case(0, 64)["xs"].items()}
    xs.update(ss_valid=np.array([True, False]), ss_sig=np.array([1, 0], np.int32),
              ss_skew=np.array([1, 1], np.int32), ss_require_all=np.bool_(False))
    d = {"xs": xs, "sel_counts": sel_counts, "hostkey_ok": np.ones(n, bool),
         "valid": np.ones(n, bool), "affinity_ok": np.ones(n, bool),
         "feasible": np.arange(n) < size}
    jfn, tfn = HOST["spread_score_host"]
    want = np.asarray(_jax_run(jfn, d)[0])
    got = ttopo.spread_score_host(_t(d, "xs"), _t(d, "sel_counts"), _t(d, "hostkey_ok"),
                                  _t(d, "valid"), _t(d, "affinity_ok"), _t(d, "feasible"),
                                  ttopo.size_log_table(n + 1, "cpu"))
    np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
    plain = torch.log(torch.tensor([size + 2.0]))
    table = ttopo.size_log_table(size + 1, "cpu")[size:]
    assert (torch.floor(cnt * plain + 0.5) != torch.floor(cnt * table + 0.5)).all()
