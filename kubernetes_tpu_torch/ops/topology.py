"""PodTopologySpread and InterPodAffinity inside the commit scan (PyTorch).

Counterpart of ``kubernetes_tpu/ops/topology.py``. Topology domains are
label value ids: a constraint's or term's per-domain pod counts are one
segment sum of TopoCounts rows over ``label_val[:, key]``, and a node's
count is one gather back. Every function
here runs once per pod inside the scan of ``backend/batch.py``, against the
counts as the batch's earlier pods left them; the speculative rounds there
share ``_seg_sum``, ``_fold_sum`` and the two normalizations in their
per-pod batched ([P, ...]) form.

How the JAX semantics carry over:

* Index ranges. A JAX gather clamps an out-of-range index and a JAX scatter
  drops it; torch raises (CPU) or asserts on the device (CUDA). No index
  here is ever out of range: domain ids are value ids of a key the batch
  involves, and the domain axis ``vd`` covers every value id of every such
  key (``SigTable.encode_topo``'s ``vd_needed``, or the full value vocab);
  invalid program slots use key slot 0, which is never a label key, so its
  domain id is 0; signature and term ids are rows below ``caps.sigs`` and
  ``caps.ex_terms``.
* Segment sums are an int32 ``scatter_add_`` for every ``vd``. JAX's
  one-hot float32 contraction (``vd <= 256``) gives the same integers: the
  counts stay far below 2**24.
* Integer contractions (``einsum("t,tn->n")``) are an elementwise product
  and a sum, never a matmul; their float32 forms hold whole numbers, so
  the sum is exact in any order.
* ``log(float32(size) + 2)`` is read from ``size_log_table``: XLA's float32
  ``log`` on the CPU is not the correctly rounded one that ``torch.log``
  computes, and CUDA's may differ from both.
* Nothing here reads a device value on the host: no ``.item()``, no
  data-dependent shape, no Python branch on a tensor.

Sharding (the JAX ``axis_name``): every function takes an optional
``mesh`` (``parallel/mesh.py:NodeMesh``), under which the node axis of its
inputs is this rank's window. Segment sums run over the local nodes and one
all-reduce merges the per-rank tables; per-pod reductions over the node
axis (minima, maxima, counts) reduce across ranks the same way; reads stay
local. The general mode's ``seg_exist`` table is replicated and updated on
every rank from the winner's domain column. The cross-rank winner is one
all-gather of each rank's best row (``_gfirst_max``) and values read on the
winner's rank reach the others in one packed psum (``_gowned``). With
``mesh=None`` the collectives are the identity.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INT_MAX = 2**31 - 1

_I32 = torch.int32
_F32 = torch.float32


def _gsum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``lax.psum`` over the mesh's ranks (``mesh=None``: ``x``)."""
    return x if mesh is None else mesh.all_reduce(x, "sum")


def _gmax(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``lax.pmax``; a bool goes through int32, as in the JAX program."""
    if mesh is None:
        return x
    if x.dtype == torch.bool:
        return mesh.all_reduce(x.to(_I32), "max") > 0
    return mesh.all_reduce(x, "max")


def _gmin(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``lax.pmin``."""
    return x if mesh is None else mesh.all_reduce(x, "min")


def _pack(shape, cols) -> torch.Tensor:
    """``cols`` (each of ``shape`` or ``shape + [k]``) as one int32
    ``[*shape, K]`` row: float32 by its bits, bool and ints as int32."""
    return torch.cat([(c.view(_I32) if c.dtype == _F32 else c.to(_I32)).reshape(*shape, -1)
                      for c in cols], dim=-1)


def _unpack(row: torch.Tensor, cols) -> tuple:
    """``_pack``'s inverse: ``row`` [*shape, K] back into ``cols``' shapes
    and dtypes."""
    out, at, n = [], 0, math.prod(row.shape[:-1])
    for c in cols:
        part = row[..., at:at + c.numel() // n].reshape(c.shape)
        at += c.numel() // n
        out.append(part.view(_F32) if c.dtype == _F32 else
                   part != 0 if c.dtype == torch.bool else part.to(c.dtype))
    return tuple(out)


def _gfirst_max(val: torch.Tensor, mesh, *cols) -> tuple:
    """The cross-rank first maximum of ``val`` (float32, one per pod) with
    one all-gather: every rank sends its row of ``val`` and ``cols`` and
    takes the row of the lowest rank holding the maximum, as the
    single-device argmax takes the first. The JAX program's pmax of the
    best, pmin of the rank holding it and psum of the owner's values give
    the same row, bit for bit. (A psum of a [W, ...] buffer holding each
    rank's row in its own slot moves the same rows, but gloo's round trip
    for it on the card was 1.05-1.9x the all-gather's: ``perf/sharding.py``.)
    Returns (the owner's ``cols``, mine: this rank owns the pick);
    ``mesh=None``: (``cols``, None)."""
    if mesh is None:
        return cols, None
    row = _pack(val.shape, (val,) + cols)
    rows = mesh.all_gather(row[None], 0)                              # [W, *shape, 1+K]
    owner = torch.argmax(rows[..., 0].view(_F32), dim=0)              # the first maximum
    took = torch.gather(rows, 0, owner[None, ..., None].expand(1, *rows.shape[1:]))[0]
    return _unpack(took[..., 1:], cols), owner == mesh.rank


def _gowned(mine: torch.Tensor, mesh, *cols) -> tuple:
    """Each pod's ``cols`` from the rank that owns its pick (``mine``, from
    ``_gfirst_max``), on every rank: one psum of the packed values masked to
    the owner, float32 by its bits so they arrive exact. ``mesh=None``:
    ``cols``."""
    if mesh is None:
        return cols
    row = _pack(mine.shape, cols)
    return _unpack(_gsum(torch.where(mine[..., None], row, 0), mesh), cols)


class TopoStatic(NamedTuple):
    """Per-batch static context (node labels cannot change inside a batch)."""

    dom_t: torch.Tensor       # [T, N] domain id of node n under term t's topology key
    seg_exist0: torch.Tensor  # [T, Vd] per-domain counts of pods carrying term t


# Cephes' single-precision log, in the operation order of XLA's CPU code
# generator: frexp into [0.5, 1) (shifted to [sqrt(1/2), sqrt(2)) - 1), a
# degree-8 polynomial, and the exponent times ln 2 split in two parts
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` as the fused multiply-add the JAX package's CPU
    backend contracts these steps into: the product of two float32 is exact
    in float64, so the float64 sum rounds once and the cast to float32
    rounds again. That double rounding differs from a true fused
    multiply-add only when the float64 sum lands exactly halfway between two
    float32; none of the tests' inputs do."""
    def f64(v):  # a constant is the float32 nearest it, as in the JAX code
        return v.to(torch.float64) if torch.is_tensor(v) else float(np.float32(v))

    return (f64(a) * f64(b) + f64(c)).to(_F32)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of a positive float32 tensor in the steps of
    ``jnp.log`` on the JAX package's CPU backend: its Cephes polynomial,
    each step one float32 operation of its own, or one fused multiply-add
    where that backend contracts the step into one (``_fma``). Its bits
    equal ``jnp.log``'s on all 130,998 inputs of
    ``tests/test_torch_rebalance.py::test_log_f32_is_jnp_log_bit_for_bit``
    (uniform in (0, 1) and up to 1e6, powers of two, 2..8999); ``_fma``'s
    double rounding could part from them at a halfway case, which no input
    there hits. The CPU and CUDA results are the same bits (``torch.log``
    on the card is not: settled C6). Inputs below the smallest normal
    float32 are clamped to it; zero gives that clamp's log, not -inf
    (callers mask it)."""
    bits = torch.clamp_min(x.to(_F32), 2.0 ** -126).view(_I32)  # positive: sign bit 0
    e = (bits >> 23).to(_F32) - 127.0 + 1.0                     # exponent + 1, exact
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(_F32)           # mantissa in [0.5, 1)
    low = m < _SQRTHF
    e = e - low.to(_F32)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    t = t - 0.5 * x2
    t = t + y
    return _fma(e, _LOG_Q2, t)


def size_log_table(n: int, device) -> torch.Tensor:
    """[n] float32: ``log(float32(k) + 2)`` for k = 0..n-1, with the bits of
    ``jnp.log`` on the JAX package's CPU backend (PodTopologySpread's
    topology-size weight, scoring.go:257; ``log_f32``). Built on ``device``
    in elementwise launches, once per batch."""
    return log_f32(torch.arange(n, dtype=_F32, device=device) + 2.0)


def _domains(label_val: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """[C, N] int64 domain (value) ids of every node under each key slot."""
    return label_val.index_select(1, key.long()).t().long()


def _seg_sum(values: torch.Tensor, dom: torch.Tensor, vd: int, mesh=None) -> torch.Tensor:
    """Int values summed by domain id over the last axis: [C, N] (or the
    speculative rounds' per-pod [P, C, N]) with int64 ids of the same shape
    -> [C, Vd] (or [P, C, Vd]) int32, summed over the mesh's ranks."""
    seg = torch.zeros((*dom.shape[:-1], vd), dtype=_I32, device=dom.device)
    return _gsum(seg.scatter_add_(-1, dom, values.to(_I32)), mesh)


def _seg_counts(sig, key, sel_counts, label_val, elig, vd: int, mesh=None):
    """Per-domain sums of ``sel_counts[sig]`` over eligible nodes that carry
    the key. sig/key [C]; elig [C, N] or [N]. Returns (dom [C, N] int64,
    has_key [C, N], seg [C, Vd], cnt_at [C, N])."""
    dom = _domains(label_val, key)
    has_key = dom > 0
    if elig.dim() == 1:
        elig = elig[None, :]
    cnts = sel_counts.index_select(0, sig.long())
    # nodes lacking the key are never counted (the reference skips them), so
    # segment column 0 stays empty and whole-table sums match the oracle
    seg = _seg_sum(torch.where(elig & has_key, cnts, 0), dom, vd, mesh)
    return dom, has_key, seg, torch.gather(seg, 1, dom)


def _fold_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim``, left to right: XLA's order for a float reduction
    over the constraint axis ([C, N] in the scan, [P, C, N] in the rounds)."""
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = out + x.select(dim, i)
    return out


def make_static(term_counts, term_key, label_val, valid, vd: int, mesh=None) -> TopoStatic:
    dom_t = _domains(label_val, term_key)                                 # [T, N]
    add = torch.where(valid[None, :] & (dom_t > 0), term_counts, 0)
    return TopoStatic(dom_t=dom_t, seg_exist0=_seg_sum(add, dom_t, vd, mesh))


# ----------------------------------------------------------------- filters


def spread_filter(xs, sel_counts, label_val, valid, affinity_ok, vd: int, mesh=None):
    """PodTopologySpread Filter (filtering.go:335): per DoNotSchedule
    constraint, matchNum + selfMatch - minMatchNum <= maxSkew over the
    domains of eligible nodes (matching the pod's node affinity and carrying
    every constraint's key). Returns [N] bool."""
    sf_valid = xs["sf_valid"]
    dom = _domains(label_val, xs["sf_key"])
    has_key = dom > 0
    has_all = torch.all(torch.where(sf_valid[:, None], has_key, True), dim=0)
    elig = valid & affinity_ok & has_all
    _, _, seg, cnt_at = _seg_counts(xs["sf_sig"], xs["sf_key"], sel_counts, label_val,
                                    elig, vd, mesh)
    pres = _seg_sum(elig[None, :].expand(dom.shape[0], -1), dom, vd, mesh) > 0   # [C, Vd]
    minm = torch.amin(torch.where(pres, seg, INT_MAX), dim=1)
    minm = torch.where(torch.any(pres, dim=1), minm, 0)
    ndom = torch.sum(pres, dim=1, dtype=_I32)
    min_dom = xs["sf_min_domains"]
    minm = torch.where((min_dom >= 0) & (ndom < min_dom), 0, minm)
    ok_c = has_key & (cnt_at + xs["sf_self"][:, None].to(_I32) - minm[:, None]
                      <= xs["sf_skew"][:, None])
    return torch.all(torch.where(sf_valid[:, None], ok_c, True), dim=0)


def ipa_filter(xs, sel_counts, seg_exist, dom_t, label_val, valid, vd: int, mesh=None):
    """InterPodAffinity Filter's three checks (filtering.go:377-387).
    Returns (aff_ok, anti_ok, exist_ok, exist_at); exist_at [T, N] is the
    per-node existing-term domain count, reused by the score."""
    # 1. the pod's required affinity (and the first-pod-in-cluster case)
    ia_valid = xs["ia_valid"]
    _, has_key, seg, cnt_at = _seg_counts(xs["ia_sig"], xs["ia_key"], sel_counts,
                                          label_val, valid, vd, mesh)
    pods_exist = torch.all(torch.where(ia_valid[:, None], cnt_at > 0, True), dim=0)
    all_keys = torch.all(torch.where(ia_valid[:, None], has_key, True), dim=0)
    total = torch.sum(torch.where(ia_valid[:, None], seg, 0))
    first_ok = (total == 0) & xs["ia_self_all"]
    aff_ok = ~torch.any(ia_valid) | (all_keys & (pods_exist | first_ok))

    # 2. the pod's required anti-affinity
    _, an_has_key, _, an_cnt = _seg_counts(xs["ianti_sig"], xs["ianti_key"], sel_counts,
                                           label_val, valid, vd, mesh)
    anti_ok = ~torch.any(xs["ianti_valid"][:, None] & an_has_key & (an_cnt > 0), dim=0)

    # 3. existing pods' required anti-affinity against the pod
    exist_at = torch.where(dom_t > 0, torch.gather(seg_exist, 1, dom_t), 0)   # [T, N]
    viol = torch.sum(xs["term_filter_match"].to(_I32)[:, None] * exist_at, dim=0, dtype=_I32)
    return aff_ok, anti_ok, viol == 0, exist_at


# ----------------------------------------------------------------- scores


def _row_reduce(fn, x, dim):
    """``fn`` (torch.amax, amin or any) over the whole tensor, or per row
    along ``dim`` with the axis kept (the speculative rounds' [P, N] form)."""
    return fn(x) if dim is None else fn(x, dim=dim, keepdim=True)


def _spread_normalize(raw, base, ignored, has_cons, dim=None, mesh=None):
    """Spread score normalization (scoring.go:232-271) of one pod's [N]
    scores, or with ``dim`` of every row of a [P, N] batch; the maximum,
    minimum and any() over the global node axis."""
    mx = _gmax(_row_reduce(torch.amax, torch.where(base, raw, float("-inf")), dim), mesh)
    mn = _gmin(_row_reduce(torch.amin, torch.where(base, raw, float("inf")), dim), mesh)
    norm = torch.where(mx == 0, 100.0,
                       torch.floor(100.0 * (mx + mn - raw) / torch.clamp_min(mx, 1.0)))
    any_base = _gmax(_row_reduce(torch.any, base, dim), mesh)
    norm = torch.where(ignored | ~any_base, 0.0, norm)
    return torch.where(has_cons, norm, 0.0)


def spread_score(xs, sel_counts, label_val, valid, affinity_ok, feasible, vd: int, log_tbl,
                 mesh=None):
    """PodTopologySpread Score and Normalize (scoring.go:196-271). Returns
    [N] float32 scores, 0 for ignored and infeasible nodes. ``log_tbl`` is
    ``size_log_table`` over at least max(N, vd) + 1 sizes."""
    ss_valid, ss_host = xs["ss_valid"], xs["ss_hostname"]
    require_all = xs["ss_require_all"]
    dom = _domains(label_val, xs["ss_key"])
    has_key = dom > 0
    has_all = torch.all(torch.where(ss_valid[:, None], has_key, True), dim=0)
    ignored = require_all & ~has_all                                      # [N]
    base = feasible & ~ignored

    # domain sizes over filtered non-ignored nodes; hostname counts nodes
    pres = _seg_sum(base[None, :].expand(dom.shape[0], -1), dom, vd, mesh) > 0
    sz = torch.where(ss_host, _gsum(torch.sum(base, dtype=_I32), mesh),
                     torch.sum(pres, dim=1, dtype=_I32))
    w = log_tbl.index_select(0, sz.long())                                # [C]

    # counts over eligible nodes (affinity match and the require-all key rule)
    elig = valid & affinity_ok & torch.where(require_all, has_all, True)
    _, _, _, cnt_at = _seg_counts(xs["ss_sig"], xs["ss_key"], sel_counts, label_val, elig, vd,
                                  mesh)
    cnt = torch.where(ss_host[:, None], sel_counts.index_select(0, xs["ss_sig"].long()),
                      cnt_at).to(_F32)
    contrib = torch.where(ss_valid[:, None] & has_key,
                          cnt * w[:, None] + (xs["ss_skew"][:, None].to(_F32) - 1.0), 0.0)
    raw = torch.floor(_fold_sum(contrib) + 0.5)                            # math.Round, >= 0
    return _spread_normalize(raw, base, ignored, torch.any(ss_valid), mesh=mesh)


def _ipa_normalize(raw, feasible, dim=None, mesh=None):
    """IPA score normalization, min and max clamped at 0; ``dim`` and
    ``mesh`` as above."""
    mx = torch.clamp_min(_gmax(_row_reduce(
        torch.amax, torch.where(feasible, raw, float("-inf")), dim), mesh), 0.0)
    mn = torch.clamp_max(_gmin(_row_reduce(
        torch.amin, torch.where(feasible, raw, float("inf")), dim), mesh), 0.0)
    diff = mx - mn
    return torch.where(diff > 0, torch.floor(100.0 * (raw - mn) / torch.clamp_min(diff, 1.0)), 0.0)


def ipa_score(xs, sel_counts, exist_at, label_val, valid, feasible, vd: int, mesh=None):
    """InterPodAffinity Score and Normalize (scoring.go): the pod's preferred
    terms against existing pods plus the existing terms' symmetric weights,
    normalized over the feasible set with min and max clamped at 0.
    Returns [N] float32."""
    ip_valid = xs["ip_valid"]
    _, has_key, _, cnt_at = _seg_counts(xs["ip_sig"], xs["ip_key"], sel_counts, label_val,
                                        valid, vd, mesh)
    pref = torch.sum(torch.where(ip_valid[:, None] & has_key,
                                 xs["ip_w"][:, None].to(_F32) * cnt_at, 0.0), dim=0)
    sym = torch.sum(xs["term_score_w"][:, None] * exist_at.to(_F32), dim=0)
    return _ipa_normalize(pref + sym, feasible, mesh=mesh)


# ------------------------------------------------------- hostname fast path
#
# When every involved key is kubernetes.io/hostname (and hostname values are
# node-unique) every node is its own domain: the [C, Vd] segment sums become
# direct per-node count reads, and the existing-term carry is the per-node
# [T, N] term-count table itself.


def spread_filter_host(xs, sel_counts, hostkey_ok, valid, affinity_ok, mesh=None):
    """Spread filter with hostname domains: matchNum at node n is
    sel_counts[sig, n]; minMatchNum is the minimum over eligible nodes."""
    min_dom = xs["sf_min_domains"]
    elig = valid & affinity_ok & hostkey_ok
    cnt = sel_counts.index_select(0, xs["sf_sig"].long())                 # [C, N]
    minm = _gmin(torch.amin(torch.where(elig[None, :], cnt, INT_MAX), dim=1), mesh)
    ndom = _gsum(torch.sum(elig, dtype=_I32), mesh)
    minm = torch.where(ndom > 0, minm, 0)
    minm = torch.where((min_dom >= 0) & (ndom < min_dom), 0, minm)
    ok_c = hostkey_ok[None, :] & (cnt + xs["sf_self"][:, None].to(_I32) - minm[:, None]
                                  <= xs["sf_skew"][:, None])
    return torch.all(torch.where(xs["sf_valid"][:, None], ok_c, True), dim=0)


def ipa_filter_host(xs, sel_counts, term_cnt, hostkey_ok, valid, mesh=None):
    """InterPodAffinity filter with hostname domains: a node's count is its
    own sel_counts column; exist_at is the carried per-node term count."""
    ia_valid = xs["ia_valid"]
    cnt_at = sel_counts.index_select(0, xs["ia_sig"].long())               # [A, N]
    exist = hostkey_ok[None, :] & (cnt_at > 0)
    pods_exist = torch.all(torch.where(ia_valid[:, None], exist, True), dim=0)
    all_keys = torch.all(torch.where(ia_valid[:, None], hostkey_ok[None, :], True), dim=0)
    total = _gsum(torch.sum(torch.where(ia_valid[:, None] & valid[None, :] & hostkey_ok[None, :],
                                        cnt_at, 0)), mesh)
    first_ok = (total == 0) & xs["ia_self_all"]
    aff_ok = ~torch.any(ia_valid) | (all_keys & (pods_exist | first_ok))

    an_cnt = sel_counts.index_select(0, xs["ianti_sig"].long())             # [A, N]
    anti_ok = ~torch.any(xs["ianti_valid"][:, None] & hostkey_ok[None, :] & (an_cnt > 0), dim=0)

    exist_at = torch.where(hostkey_ok[None, :], term_cnt, 0)                # [T, N]
    viol = torch.sum(xs["term_filter_match"].to(_I32)[:, None] * exist_at, dim=0, dtype=_I32)
    return aff_ok, anti_ok, viol == 0, exist_at


def spread_score_host(xs, sel_counts, hostkey_ok, valid, affinity_ok, feasible, log_tbl,
                      mesh=None):
    """Spread score with hostname domains (scoring.go:196-271): the size is
    the count of non-ignored feasible nodes, counts are read per node."""
    ss_valid = xs["ss_valid"]
    ignored = xs["ss_require_all"] & ~hostkey_ok
    base = feasible & ~ignored
    w = log_tbl.index_select(0, _gsum(torch.sum(base, dtype=torch.int64), mesh).view(1))  # [1]
    cnt = sel_counts.index_select(0, xs["ss_sig"].long()).to(_F32)          # [C, N]
    contrib = torch.where(ss_valid[:, None] & hostkey_ok[None, :],
                          cnt * w + (xs["ss_skew"][:, None].to(_F32) - 1.0), 0.0)
    raw = torch.floor(_fold_sum(contrib) + 0.5)
    return _spread_normalize(raw, base, ignored, torch.any(ss_valid), mesh=mesh)


def ipa_score_host(xs, sel_counts, exist_at, hostkey_ok, feasible, mesh=None):
    ip_valid = xs["ip_valid"]
    cnt_at = sel_counts.index_select(0, xs["ip_sig"].long())                # [PT, N]
    pref = torch.sum(torch.where(ip_valid[:, None] & hostkey_ok[None, :],
                                 xs["ip_w"][:, None].to(_F32) * cnt_at.to(_F32), 0.0), dim=0)
    sym = torch.sum(xs["term_score_w"][:, None] * exist_at.to(_F32), dim=0)
    return _ipa_normalize(pref + sym, feasible, mesh=mesh)


# ----------------------------------------------------------------- commit


def _commit_column(n: int, local_idx, commit, device) -> torch.Tensor:
    """[N] int32 one-hot of the winning node, all zero when nothing commits."""
    return ((torch.arange(n, dtype=_I32, device=device) == local_idx) & commit).to(_I32)


def commit_update_host(sel_counts, term_cnt, local_idx, commit, pod_sig_mask, pod_term_mask,
                       mine=None):
    """Hostname-mode commit: both tables are [*, N] and take a one-column
    add at the winning node (elementwise, no scatter); under a mesh only
    the rank that owns the winner (``mine``) adds it."""
    if mine is not None:
        commit = commit & mine
    col = _commit_column(sel_counts.shape[1], local_idx, commit, sel_counts.device)
    sel_counts = sel_counts + pod_sig_mask.to(_I32)[:, None] * col[None, :]
    term_cnt = term_cnt + pod_term_mask.to(_I32)[:, None] * col[None, :]
    return sel_counts, term_cnt


def commit_update(sel_counts, seg_exist, dom_t, local_idx, commit, pod_sig_mask,
                  pod_term_mask, mine=None, dom_col=None):
    """Add a committed pod's memberships to the evolving tables:
    sel_counts[:, node] += pod_sig_mask on the rank that owns the winner
    (``mine``), and the pod's carried terms to seg_exist at the winning
    node's domains on every rank. ``dom_col`` [T] is the winner's domain
    column, which under a mesh comes from its owner's row (``_gfirst_max``);
    None reads it here at ``local_idx``."""
    owned = commit if mine is None else commit & mine
    col = _commit_column(sel_counts.shape[1], local_idx, owned, sel_counts.device)
    sel_counts = sel_counts + pod_sig_mask.to(_I32)[:, None] * col[None, :]
    if dom_col is None:
        dom_col = dom_t.index_select(1, local_idx.long().view(1))[:, 0]
    dom_col = dom_col[:, None]                                              # [T, 1]
    add = torch.where(commit & (dom_col > 0), pod_term_mask.to(_I32)[:, None], 0)
    vd = seg_exist.shape[1]
    onehot = torch.arange(vd, dtype=dom_col.dtype, device=dom_col.device)[None, :] == dom_col
    return sel_counts, seg_exist + add * onehot.to(_I32)
