"""Host-side pod-set signature and term tables behind ops/schema.TopoCounts.

Own copy of ``kubernetes_tpu/backend/sig_table.py``. The reference rescans
every existing pod in each PreFilter (podtopologyspread/filtering.go:238,
interpodaffinity/filtering.go:86-135). Here the counts are kept per node
slot and keyed by registered *signatures* ((namespaces, label selector)
pairs, the unit both plugins count pods by) and *terms* (existing pods'
(anti-)affinity terms, for the symmetric checks), and they are updated per
node generation. A batch then only gathers and segment-reduces them.

The host truth is numpy; ``topo_counts`` and ``encode_topo`` put tensors on
the encoder's device. Row 0 of both tables is reserved (all zero), so
invalid program slots read zero counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from ..api.types import DO_NOT_SCHEDULE, MATCH_NOTHING, SCHEDULE_ANYWAY, Pod
from ..framework.plugins.interpodaffinity import (
    HOSTNAME_KEY,
    AffinityTerm,
    NsLabelsFn,
    preferred_affinity_terms,
    preferred_anti_affinity_terms,
    required_affinity_terms,
    required_anti_affinity_terms,
)
from ..framework.types import NodeInfo
from ..ops.encode import CapacityError, ClusterEncoder
from ..ops.schema import TopoBatch, TopoCounts

# term classes (symmetric direction: an existing pod's term against the incoming pod)
AFF_REQ = 1     # required affinity      -> scored at hardPodAffinityWeight
ANTI_REQ = 2    # required anti-affinity -> the Filter check (filtering.go:308)
AFF_PREF = 3    # preferred affinity     -> scored at +term weight
ANTI_PREF = 4   # preferred anti-affinity -> scored at -term weight

SelKey = Tuple  # canonical label-selector key
SigKey = Tuple[FrozenSet[str], Optional[SelKey], SelKey]
TermKey = Tuple[int, str, FrozenSet[str], Optional[SelKey], SelKey, int]


def _sel_canonical(sel) -> SelKey:
    return sel.signature() if sel is not None else None


@dataclass
class _Sig:
    namespaces: FrozenSet[str]
    ns_selector: object  # Optional[LabelSelector]
    selector: object     # LabelSelector

    def matches(self, pod: Pod, ns_labels_fn: NsLabelsFn) -> bool:
        if pod.meta.namespace in self.namespaces:
            ns_ok = True
        elif self.ns_selector is not None:
            ns_ok = self.ns_selector.matches(ns_labels_fn(pod.meta.namespace))
        else:
            ns_ok = False
        return ns_ok and self.selector.matches(pod.meta.labels)


@dataclass
class _Term:
    klass: int
    term: AffinityTerm


def term_key_of(term: AffinityTerm, klass: int) -> TermKey:
    return (klass, term.topology_key, term.namespaces,
            _sel_canonical(term.namespace_selector), _sel_canonical(term.selector),
            term.weight)


def _has_topology_terms(pod: Pod) -> bool:
    a = pod.spec.affinity
    return bool(pod.spec.topology_spread_constraints) or (
        a is not None and (a.pod_affinity is not None or a.pod_anti_affinity is not None))


class SigTable:
    """Registered signatures and terms, and the host-truth count matrices
    ``sel_counts[s, n]`` and ``term_counts[t, n]``. DeviceState uploads them
    when ``version`` moves past the uploaded one."""

    def __init__(self, encoder: ClusterEncoder, ns_labels_fn: Optional[NsLabelsFn] = None):
        self.encoder = encoder
        self.caps = encoder.caps
        self.device = encoder.device
        self.ns_labels_fn: NsLabelsFn = ns_labels_fn or (lambda ns: {})
        self._sigs: Dict[SigKey, int] = {}
        self._sig_rows: List[Optional[_Sig]] = [None]  # row 0 reserved
        self._terms: Dict[TermKey, int] = {}
        self._term_rows: List[Optional[_Term]] = [None]
        self.sel_counts = np.zeros((self.caps.sigs, self.caps.nodes), np.int32)
        self.term_counts = np.zeros((self.caps.ex_terms, self.caps.nodes), np.int32)
        self.term_key_slots = np.zeros(self.caps.ex_terms, np.int32)
        self.version = 0
        # node slot -> pods counted there (set by recount_node)
        self._slot_pods: Dict[int, List[Pod]] = {}
        # the all-zero TopoBatch: a topology-free batch with no registered
        # rows reuses one device copy instead of uploading 27 zero arrays
        # per batch
        self._zero_topo: Optional[TopoBatch] = None
        self.last_topo_summary: Optional[dict] = None

    @property
    def n_sigs(self) -> int:
        return len(self._sig_rows)

    @property
    def n_terms(self) -> int:
        return len(self._term_rows)

    # ---------------------------------------------------------------- register

    def sig_id(self, namespaces: FrozenSet[str], ns_selector, selector) -> int:
        key: SigKey = (namespaces, _sel_canonical(ns_selector), _sel_canonical(selector))
        sid = self._sigs.get(key)
        if sid is not None:
            return sid
        sid = len(self._sig_rows)
        if sid >= self.caps.sigs:
            raise CapacityError("sigs", sid + 1, self.caps.sigs)
        sig = _Sig(namespaces, ns_selector, selector)
        self._sigs[key] = sid
        self._sig_rows.append(sig)
        # backfill the new row over every populated node slot
        for slot, pods in self._slot_pods.items():
            c = sum(1 for p in pods if sig.matches(p, self.ns_labels_fn))
            if c:
                self.sel_counts[sid, slot] = c
        self.version += 1
        return sid

    def term_sig_id(self, term: AffinityTerm) -> int:
        return self.sig_id(term.namespaces, term.namespace_selector, term.selector)

    def term_id(self, term: AffinityTerm, klass: int) -> int:
        key = term_key_of(term, klass)
        tid = self._terms.get(key)
        if tid is not None:
            return tid
        tid = len(self._term_rows)
        if tid >= self.caps.ex_terms:
            raise CapacityError("ex_terms", tid + 1, self.caps.ex_terms)
        self._terms[key] = tid
        self._term_rows.append(_Term(klass, term))
        self.term_key_slots[tid] = self.encoder.key_slot(term.topology_key)
        for slot, pods in self._slot_pods.items():
            c = sum(1 for p in pods if key in self._pod_term_keys(p))
            if c:
                self.term_counts[tid, slot] = c
        self.version += 1
        return tid

    # ---------------------------------------------------------------- counting

    @staticmethod
    def _pod_terms(pod: Pod):
        """The pod's (klass, term) list, cached on the pod (clones share it)."""
        cached = pod.__dict__.get("_sig_terms_all")
        if cached is None:
            cached = []
            for klass, terms in ((AFF_REQ, required_affinity_terms(pod)),
                                 (ANTI_REQ, required_anti_affinity_terms(pod)),
                                 (AFF_PREF, preferred_affinity_terms(pod)),
                                 (ANTI_PREF, preferred_anti_affinity_terms(pod))):
                cached.extend((klass, t) for t in terms)
            pod.__dict__["_sig_terms_all"] = cached
        return cached

    @classmethod
    def _pod_term_keys(cls, pod: Pod) -> FrozenSet[TermKey]:
        cached = pod.__dict__.get("_sig_term_keys")
        if cached is None:
            cached = frozenset(term_key_of(t, klass) for klass, t in cls._pod_terms(pod))
            pod.__dict__["_sig_term_keys"] = cached
        return cached

    def track_slot_pods(self, slot: int, ni: Optional[NodeInfo]) -> None:
        """Keep only the backfill source fresh: with no registered signature
        or term both count tables are identically zero, so a full recount
        would change nothing."""
        pods = list(ni.pods) if ni is not None else []
        if pods:
            self._slot_pods[slot] = pods
        else:
            self._slot_pods.pop(slot, None)

    def recount_node(self, slot: int, ni: Optional[NodeInfo]) -> None:
        """Recompute both count columns of one node slot from its pod list
        (DeviceState.sync calls it for every removed or dirty node)."""
        pods = list(ni.pods) if ni is not None else []
        if not pods and slot not in self._slot_pods:
            return  # nothing stored for this slot and nothing to count
        # register every term the node's pods carry BEFORE counting, so an
        # existing pod's anti-affinity is never invisible to the batch
        for p in pods:
            for klass, t in self._pod_terms(p):
                self.term_id(t, klass)
        old_sel = self.sel_counts[:, slot].copy()
        old_term = self.term_counts[:, slot].copy()
        self.sel_counts[:, slot] = 0
        self.term_counts[:, slot] = 0
        for sid in range(1, self.n_sigs):
            sig = self._sig_rows[sid]
            self.sel_counts[sid, slot] = sum(1 for p in pods if sig.matches(p, self.ns_labels_fn))
        if self.n_terms > 1:
            for p in pods:
                for key in self._pod_term_keys(p):
                    tid = self._terms.get(key)
                    if tid is not None:
                        self.term_counts[tid, slot] += 1
        if pods:
            self._slot_pods[slot] = pods
        else:
            self._slot_pods.pop(slot, None)
        if (not np.array_equal(old_sel, self.sel_counts[:, slot])
                or not np.array_equal(old_term, self.term_counts[:, slot])):
            self.version += 1

    # ---------------------------------------------------------------- matching

    def pod_sig_mask(self, pod: Pod) -> np.ndarray:
        """[S] bool: the registered pod sets this pod belongs to (what its
        commit adds to the node it lands on)."""
        m = np.zeros(self.caps.sigs, bool)
        for sid in range(1, self.n_sigs):
            m[sid] = self._sig_rows[sid].matches(pod, self.ns_labels_fn)
        return m

    def pod_term_mask(self, pod: Pod) -> np.ndarray:
        """[T] bool: the registered term rows this pod carries."""
        m = np.zeros(self.caps.ex_terms, bool)
        for key in self._pod_term_keys(pod):
            tid = self._terms.get(key)
            if tid is not None:
                m[tid] = True
        return m

    def term_match_rows(self, pod: Pod) -> Tuple[np.ndarray, np.ndarray]:
        """For an incoming pod: ([T] bool, the required anti-affinity terms
        that match it, for the Filter check; [T] float32 symmetric score
        weights), each ``term.matches(pod)`` evaluated on the host
        (interpodaffinity filtering.go:174, scoring.go:79), with the
        plugin's default arguments: hardPodAffinityWeight 1, preferred
        terms of existing pods counted."""
        fmatch = np.zeros(self.caps.ex_terms, bool)
        w = np.zeros(self.caps.ex_terms, np.float32)
        for tid in range(1, self.n_terms):
            row = self._term_rows[tid]
            if not row.term.matches(pod, self.ns_labels_fn):
                continue
            if row.klass == ANTI_REQ:
                fmatch[tid] = True
            if row.klass == AFF_REQ:
                w[tid] = 1.0
            elif row.klass == AFF_PREF:
                w[tid] = float(row.term.weight)
            elif row.klass == ANTI_PREF:
                w[tid] = -float(row.term.weight)
        return fmatch, w

    # ---------------------------------------------------------------- encoding

    def topo_counts(self) -> TopoCounts:
        """TopoCounts on the device, a copy of the host-truth matrices."""
        return TopoCounts.from_numpy({"sel_counts": self.sel_counts,
                                      "term_counts": self.term_counts,
                                      "term_key": self.term_key_slots}, self.device)

    def _zero_arrays(self, P: int) -> dict:
        caps = self.caps
        C, A, PT, S, T = (caps.spread_cons, caps.ipa_terms, caps.ipa_pref,
                          caps.sigs, caps.ex_terms)
        z = np.zeros
        return {
            "sf_valid": z((P, C), bool), "sf_sig": z((P, C), np.int32),
            "sf_key": z((P, C), np.int32), "sf_skew": z((P, C), np.int32),
            "sf_self": z((P, C), bool), "sf_min_domains": np.full((P, C), -1, np.int32),
            "ss_valid": z((P, C), bool), "ss_sig": z((P, C), np.int32),
            "ss_key": z((P, C), np.int32), "ss_skew": z((P, C), np.int32),
            "ss_hostname": z((P, C), bool), "ss_require_all": z(P, bool),
            "ia_valid": z((P, A), bool), "ia_sig": z((P, A), np.int32),
            "ia_key": z((P, A), np.int32), "ia_self_all": z(P, bool),
            "ianti_valid": z((P, A), bool), "ianti_sig": z((P, A), np.int32),
            "ianti_key": z((P, A), np.int32),
            "ip_valid": z((P, PT), bool), "ip_sig": z((P, PT), np.int32),
            "ip_key": z((P, PT), np.int32), "ip_w": z((P, PT), np.int32),
            "term_filter_match": z((P, T), bool), "term_score_w": z((P, T), np.float32),
            "pod_sig_mask": z((P, S), bool), "pod_term_mask": z((P, T), bool),
        }

    def encode_topo(self, pods: List[Pod]) -> TopoBatch:
        """Compile a pod batch's topology programs into a TopoBatch.

        Two passes: first register every signature and term the batch
        introduces (each backfilled over the nodes, which moves
        ``version``: read DeviceState.tc only after this call), so pod i's
        match rows see pod j's terms (intra-batch symmetric anti-affinity);
        then fill the arrays. Sets ``last_topo_summary``."""
        caps = self.caps
        P = caps.pods
        if len(pods) > P:
            raise CapacityError("pods", len(pods), P)

        if self.n_sigs <= 1 and self.n_terms <= 1 and not any(map(_has_topology_terms, pods)):
            if self._zero_topo is None:
                self._zero_topo = TopoBatch.from_numpy(self._zero_arrays(P), self.device)
            self.last_topo_summary = {"hostname_only": False, "vd_needed": 1}
            return self._zero_topo

        # ---- pass 1: registration
        for pod in pods:
            for c in pod.spec.topology_spread_constraints:
                sel = c.label_selector if c.label_selector is not None else MATCH_NOTHING
                self.sig_id(frozenset({pod.meta.namespace}), None, sel)
                self.encoder.key_slot(c.topology_key)
            for klass, t in self._pod_terms(pod):
                self.term_id(t, klass)
                self.term_sig_id(t)

        # ---- pass 2: arrays
        C, A, PT = caps.spread_cons, caps.ipa_terms, caps.ipa_pref
        out = self._zero_arrays(P)
        for p, pod in enumerate(pods):
            cons = pod.spec.topology_spread_constraints
            sf = [c for c in cons if c.when_unsatisfiable == DO_NOT_SCHEDULE]
            ss = [c for c in cons if c.when_unsatisfiable == SCHEDULE_ANYWAY]
            if len(sf) > C:
                raise CapacityError("spread_cons", len(sf), C)
            if len(ss) > C:
                raise CapacityError("spread_cons", len(ss), C)
            for i, c in enumerate(sf):
                sel = c.label_selector if c.label_selector is not None else MATCH_NOTHING
                out["sf_valid"][p, i] = True
                out["sf_sig"][p, i] = self.sig_id(frozenset({pod.meta.namespace}), None, sel)
                out["sf_key"][p, i] = self.encoder.key_slot(c.topology_key)
                out["sf_skew"][p, i] = c.max_skew
                out["sf_self"][p, i] = sel.matches(pod.meta.labels)
                if c.min_domains is not None:
                    out["sf_min_domains"][p, i] = c.min_domains
            for i, c in enumerate(ss):
                sel = c.label_selector if c.label_selector is not None else MATCH_NOTHING
                out["ss_valid"][p, i] = True
                out["ss_sig"][p, i] = self.sig_id(frozenset({pod.meta.namespace}), None, sel)
                out["ss_key"][p, i] = self.encoder.key_slot(c.topology_key)
                out["ss_skew"][p, i] = c.max_skew
                out["ss_hostname"][p, i] = c.topology_key == HOSTNAME_KEY
            # pod-specified constraints => require all topology keys at PreScore
            out["ss_require_all"][p] = bool(cons)

            ia = required_affinity_terms(pod)
            if len(ia) > A:
                raise CapacityError("ipa_terms", len(ia), A)
            for i, t in enumerate(ia):
                out["ia_valid"][p, i] = True
                out["ia_sig"][p, i] = self.term_sig_id(t)
                out["ia_key"][p, i] = self.encoder.key_slot(t.topology_key)
            out["ia_self_all"][p] = all(t.matches(pod, self.ns_labels_fn) for t in ia)

            ianti = required_anti_affinity_terms(pod)
            if len(ianti) > A:
                raise CapacityError("ipa_terms", len(ianti), A)
            for i, t in enumerate(ianti):
                out["ianti_valid"][p, i] = True
                out["ianti_sig"][p, i] = self.term_sig_id(t)
                out["ianti_key"][p, i] = self.encoder.key_slot(t.topology_key)

            prefs = [(t, t.weight) for t in preferred_affinity_terms(pod)] + [
                (t, -t.weight) for t in preferred_anti_affinity_terms(pod)]
            if len(prefs) > PT:
                raise CapacityError("ipa_pref", len(prefs), PT)
            for i, (t, w) in enumerate(prefs):
                out["ip_valid"][p, i] = True
                out["ip_sig"][p, i] = self.term_sig_id(t)
                out["ip_key"][p, i] = self.encoder.key_slot(t.topology_key)
                out["ip_w"][p, i] = w

            out["term_filter_match"][p], out["term_score_w"][p] = self.term_match_rows(pod)
            out["pod_sig_mask"][p] = self.pod_sig_mask(pod)
            out["pod_term_mask"][p] = self.pod_term_mask(pod)

        # the topology-mode summary: the key slots this batch touches, plus
        # every registered term's (existing terms take part in every
        # batch), and the domain axis the general mode needs to cover every
        # value id of those keys (hostname included: a mixed batch or the
        # duplicate-hostname fallback aggregates hostname domains too)
        host_slot = self.encoder.key_slot(HOSTNAME_KEY)
        involved = set(int(k) for k in self.term_key_slots[1:self.n_terms])
        for fld in ("sf", "ss", "ia", "ianti", "ip"):
            involved.update(np.unique(out[f"{fld}_key"][out[f"{fld}_valid"]]).tolist())
        involved.discard(0)
        vd_needed = 1
        for ks in involved:
            vv = self.encoder.value_vocabs.get(ks)
            if vv is not None:
                vd_needed = max(vd_needed, len(vv))
        self.last_topo_summary = {
            "hostname_only": bool(involved) and not (involved - {host_slot}),
            "vd_needed": vd_needed,
        }
        return TopoBatch.from_numpy(out, self.device)
