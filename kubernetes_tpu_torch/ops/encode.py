"""Host-side compiler: API objects → dense device tensors (PyTorch).

Own copy of ``kubernetes_tpu/ops/encode.py``: the vocab, row and template
logic is the same numpy code; only the three places that build device
tensors differ (``encode_snapshot``, ``encode_pods`` and
``_ExprBuilder.table``), which put torch tensors on the encoder's device.

The ClusterEncoder owns every vocabulary (label keys, per-key value vocabs,
ports, images, scalar resources, node slots) and produces:

  * per-node rows (``encode_node_row``) / full snapshots (``encode_snapshot``)
    following the NodeTensors schema;
  * compiled pod batches (``encode_pods``): a deduplicated ExprTable (the
    batch's unique selector expressions) plus per-pod programs indexing it.

String semantics compiled here, evaluated on device (SURVEY.md §7 "hard parts"
#1):
  - label selector expressions → (op, key-slot, value-id-set bitset);
  - nodeSelector maps → AND-combined single-value IN exprs;
  - metadata.name matchFields → OP_NODE_NAME on the node-slot axis;
  - tolerations → (key-id, value-id, op, effect) rows;
  - host ports → exact wildcard-IP conflict semantics with two vocab bits per
    used port: ("*", proto, port) marks "any IP uses proto/port", and the
    concrete (ip, proto, port) bit preserves IP-specific matching
    (framework/types.go HostPortInfo).

Vocab ids are append-only; id 0 = absent everywhere.  Encoders raise
CapacityError when a static capacity is exceeded — callers re-encode with
``Capacities.grow_*``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import resource as resource_api
from ..api.types import (
    EXISTS,
    DOES_NOT_EXIST,
    GT,
    IN,
    LT,
    NOT_IN,
    Pod,
    Requirement,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
    Taint,
    TOLERATION_OP_EXISTS,
)
from ..framework.types import NodeInfo, nonzero_request
from ..utils.device import DeviceLike, resolve_device
from ..utils.vocab import Vocab
from . import schema
from .schema import Capacities, INT_NONE
from .tiebreak import name_hash as _name_hash, pod_seed

_EFFECT_CODE = {
    "": schema.EFFECT_NONE,
    TAINT_NO_SCHEDULE: schema.EFFECT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE: schema.EFFECT_PREFER_NO_SCHEDULE,
    TAINT_NO_EXECUTE: schema.EFFECT_NO_EXECUTE,
}

_UNSCHEDULABLE_TAINT = Taint(key="node.kubernetes.io/unschedulable", effect=TAINT_NO_SCHEDULE)

def normalized_image_name(name: str) -> str:
    """parsers.NormalizeImageRef-lite: append :latest when no tag/digest
    (the ImageLocality plugin's image key)."""
    if "@" in name:
        return name
    last = name.rsplit("/", 1)[-1]
    if ":" not in last:
        return name + ":latest"
    return name


# well-known TPU torus labels (GKE `cloud.google.com/gke-tpu-topology`-style
# keys): the superpod a host belongs to and its linear position inside that
# superpod's torus. Nodes without both labels fall back to slot-derived
# synthetic coordinates (the harness's simulated torus).
TOPO_SUPERPOD_LABEL = "cloud.google.com/gke-tpu-superpod"
TOPO_SLOT_LABEL = "cloud.google.com/gke-tpu-slot"


class CapacityError(Exception):
    """A static tensor capacity was exceeded; re-encode with larger Capacities."""

    def __init__(self, dimension: str, needed: int, capacity: int):
        self.dimension = dimension
        self.needed = needed
        self.capacity = capacity
        super().__init__(f"capacity exceeded: {dimension} needs {needed} > {capacity}")


_NEVER = "__never__"  # expr-key sentinel: term matches nothing


@dataclass
class _PodTemplate:
    """Builder-independent encode of one pod-spec shape.

    Thousands of workload pods share a handful of spec shapes (the
    scheduler_perf pod templates), so the expensive per-pod work — quantity
    canonicalization, toleration/selector/affinity compilation — is done once
    per shape. Expr *keys* (not batch-local slots) are stored; they are
    re-interned into each batch's ExprTable, which dedups by key. Vocab ids
    inside keys/arrays are append-only and therefore stable for the life of
    the encoder (growth rebuilds the encoder, resetting this cache)."""

    priority: int
    req: np.ndarray
    nzreq: np.ndarray
    tol_key: np.ndarray
    tol_val: np.ndarray
    tol_op: np.ndarray
    tol_effect: np.ndarray
    tol_prefer: np.ndarray
    tolerates_unsched: bool
    sel_keys: Tuple
    term_keys: Tuple            # ((expr_key | _NEVER, ...), ...)
    pref_terms: Tuple           # ((weight, (expr_key | _NEVER, ...)), ...)
    port_wanted: Tuple[int, ...]
    n_containers: int


class ClusterEncoder:
    def __init__(self, caps: Capacities, device: DeviceLike = None):
        self.caps = caps
        self.device = resolve_device(device)
        self.key_vocab = Vocab("label-keys")          # key string -> key slot (1-based, < K)
        self.value_vocabs: Dict[int, Vocab] = {}      # key slot -> value vocab
        self.port_vocab = Vocab("ports")              # (ip|'*', proto, port) -> id
        self.image_vocab = Vocab("images")
        self.scalar_vocab = Vocab("scalar-resources")
        # priority-class vocab (batched preemption): distinct pod priority
        # values -> class id; id 0 reserved (class_prio INT_MAX = never
        # evictable padding)
        self.prio_vocab: Dict[int, int] = {}
        self.node_slots: Dict[str, int] = {}          # node name -> slot
        self.slot_names: Dict[int, str] = {}          # live reverse map
        self._free_slots: List[int] = []
        # slot-reclamation bookkeeping (elastic clusters): a released slot is
        # a TOMBSTONE until reused — ``reclaim_gen`` is a monotonic release
        # counter and ``slot_release_gen[slot]`` the gen at the slot's last
        # release, so an in-flight batch (which captured reclaim_gen at
        # dispatch) can prove at commit time that a winner slot still names
        # the node the kernel judged (slot_stale_since). ``slot_reuses``
        # counts free-list pops (the scheduler_device_slot_reuse_total feed).
        self.reclaim_gen = 0
        self.slot_release_gen: Dict[int, int] = {}
        self.slot_reuses = 0
        # node-retained vocab refcounts: (key, value) string pairs each LIVE
        # node's labels/taints pin in the per-key value vocabs. Release at
        # refcount zero frees the id for reuse (bounded vocab consumption
        # under node churn); any free invalidates the pod-template cache,
        # whose compiled expr keys embed value ids.
        self._value_refs: Dict[Tuple[str, str], int] = {}
        self._node_value_pairs: Dict[str, frozenset] = {}
        self._pod_templates: Dict[Tuple, _PodTemplate] = {}
        self.last_has_ports = False                   # set by encode_pods
        self._template_cap = 4096                     # runaway-shape guard
        # node-STATIC row fields (labels/taints/images/allocatable) keyed by
        # (name, resourceVersion): only pod-dependent fields re-encode when a
        # row is dirty from commits alone — the reconcile hot path re-encodes
        # every committed row each batch
        self._static_rows: Dict[str, Tuple[int, Dict[str, np.ndarray]]] = {}

    # ------------------------------------------------------------- vocab plumbing

    def key_slot(self, key: str) -> int:
        slot = self.key_vocab.id(key)
        if slot >= self.caps.label_keys:
            raise CapacityError("label_keys", slot + 1, self.caps.label_keys)
        return slot

    def value_id(self, key: str, value: str) -> int:
        ks = self.key_slot(key)
        vv = self.value_vocabs.setdefault(ks, Vocab(f"values[{key}]"))
        vid = vv.id(value)
        if vid >= self.caps.value_words * 32:
            raise CapacityError(f"value vocab for {key!r}", vid + 1, self.caps.value_words * 32)
        return vid

    def scalar_col(self, resource: str) -> int:
        col = schema.N_FIXED_COLS + self.scalar_vocab.id(resource) - 1
        if col >= self.caps.resources:
            raise CapacityError("resources", col + 1, self.caps.resources)
        return col

    def resource_col(self, resource: str) -> int:
        fixed = {
            resource_api.CPU: schema.COL_CPU,
            resource_api.MEMORY: schema.COL_MEM,
            resource_api.EPHEMERAL_STORAGE: schema.COL_EPH,
            resource_api.PODS: schema.COL_PODS,
        }
        if resource in fixed:
            return fixed[resource]
        return self.scalar_col(resource)

    def port_id(self, ip: str, proto: str, port: int) -> int:
        pid = self.port_vocab.id((ip, proto, port))
        if pid >= self.caps.port_words * 32:
            raise CapacityError("ports vocab", pid + 1, self.caps.port_words * 32)
        return pid

    def image_id(self, name: str) -> int:
        iid = self.image_vocab.id(name)
        if iid >= self.caps.images:
            raise CapacityError("image vocab", iid + 1, self.caps.images)
        return iid

    def prio_class_id(self, priority: int) -> int:
        cid = self.prio_vocab.get(priority)
        if cid is None:
            cid = len(self.prio_vocab) + 1  # 0 reserved
            if cid >= self.caps.prio_classes:
                raise CapacityError("prio_classes", cid + 1, self.caps.prio_classes)
            self.prio_vocab[priority] = cid
        return cid

    def class_prio_array(self) -> np.ndarray:
        """[C] int32: priority value per class id; reserved/unused rows get
        INT_MAX so `class_prio < pod_priority` is never true for them."""
        arr = np.full(self.caps.prio_classes, 2**31 - 1, np.int32)
        for prio, cid in self.prio_vocab.items():
            arr[cid] = prio
        return arr

    def node_slot(self, name: str) -> int:
        slot = self.node_slots.get(name)
        if slot is None:
            reused = bool(self._free_slots)
            slot = self._free_slots.pop() if self._free_slots else len(self.node_slots)
            # slots are dense; a freed slot is reused before extending.
            # slot_names is node_slots' live inverse, so the check is O(1)
            if slot in self.slot_names:  # freed-list raced with dense growth; find a hole
                used = set(self.node_slots.values())
                slot = next(i for i in range(self.caps.nodes + 1) if i not in used)
            if slot >= self.caps.nodes:
                raise CapacityError("nodes", slot + 1, self.caps.nodes)
            if reused:
                self.slot_reuses += 1
            self.node_slots[name] = slot
            self.slot_names[slot] = name
        return slot

    def release_node_slot(self, name: str) -> Optional[int]:
        """Tombstone a removed node's slot: the row index goes to the
        free-list for reuse, the release generation is stamped so in-flight
        commits naming it get a typed rejection, and the node's vocab
        retentions are dropped (value ids free at refcount zero)."""
        slot = self.node_slots.pop(name, None)
        self._static_rows.pop(name, None)
        self.release_node_values(name)
        if slot is not None:
            self.slot_names.pop(slot, None)
            self._free_slots.append(slot)
            self.reclaim_gen += 1
            self.slot_release_gen[slot] = self.reclaim_gen
        return slot

    def slot_stale_since(self, slot: int, gen: int) -> bool:
        """True iff ``slot`` was released (tombstoned/reused) after an
        observer captured ``reclaim_gen == gen`` — the commit-time guard for
        placements decided before the release."""
        return self.slot_release_gen.get(slot, 0) > gen

    # ------------------------------------------------- node vocab retention

    @staticmethod
    def _node_pairs(node) -> frozenset:
        pairs = {(k, v) for k, v in node.meta.labels.items()}
        pairs.update((t.key, t.value) for t in node.spec.taints)
        return frozenset(pairs)

    def retain_node_values(self, name: str, node) -> None:
        """Refcount the (key, value) label/taint pairs ``node`` pins in the
        value vocabs (called per dirty row from DeviceState.sync — the same
        walk that encodes the row, so every retained pair is interned)."""
        new = self._node_pairs(node) if node is not None else frozenset()
        old = self._node_value_pairs.get(name, frozenset())
        if new == old:
            return
        for pair in new - old:
            self._value_refs[pair] = self._value_refs.get(pair, 0) + 1
        freed = False
        for pair in old - new:
            freed |= self._drop_value_ref(pair)
        if new:
            self._node_value_pairs[name] = new
        else:
            self._node_value_pairs.pop(name, None)
        if freed:
            # cached templates embed value ids; a freed id may be recycled
            # for a different string, so every compiled key set is suspect
            self._pod_templates.clear()

    def release_node_values(self, name: str) -> None:
        old = self._node_value_pairs.pop(name, None)
        if not old:
            return
        freed = False
        for pair in old:
            freed |= self._drop_value_ref(pair)
        if freed:
            self._pod_templates.clear()

    def _drop_value_ref(self, pair: Tuple[str, str]) -> bool:
        """Decrement one (key, value) retention; free the vocab id at zero.
        Returns True when an id was actually freed."""
        left = self._value_refs.get(pair, 0) - 1
        if left > 0:
            self._value_refs[pair] = left
            return False
        self._value_refs.pop(pair, None)
        ks = self.key_vocab.lookup(pair[0])
        vv = self.value_vocabs.get(ks)
        return vv is not None and vv.release(pair[1]) is not None

    def release_image(self, name: str) -> None:
        """Free an image vocab id once no node reports the image (driven by
        DeviceState._track_images' global refcount). Image ids are looked up
        per encode (never cached in templates), so no cache invalidation."""
        self.image_vocab.release(name)

    # ------------------------------------------------------------- resources

    def resource_vec(self, m: Dict[str, int]) -> np.ndarray:
        v = np.zeros(self.caps.resources, np.int32)
        for rname, val in m.items():
            v[self.resource_col(rname)] = min(val, 2**31 - 1)
        return v

    # ------------------------------------------------------------- node rows

    def _encode_static_fields(self, ni: NodeInfo) -> Dict[str, np.ndarray]:
        """Row fields derived from the Node OBJECT alone (labels, taints,
        images, allocatable) — cacheable by (name, resourceVersion) since
        pod commits never change them."""
        caps = self.caps
        node = ni.node
        row: Dict[str, np.ndarray] = {}
        row["valid"] = np.array(node is not None)
        row["unschedulable"] = np.array(bool(node and node.spec.unschedulable))
        row["allocatable"] = self.resource_vec(ni.allocatable.as_map())
        row["name_hash"] = np.array(
            _name_hash(node.meta.name) if node is not None else 0, np.uint32)

        label_val = np.zeros(caps.label_keys, np.int32)
        label_num = np.full(caps.label_keys, INT_NONE, np.int32)
        if node is not None:
            for k, v in node.meta.labels.items():
                ks = self.key_slot(k)
                label_val[ks] = self.value_id(k, v)
                try:
                    label_num[ks] = np.int32(int(v))
                except (ValueError, OverflowError):
                    pass
        row["label_val"] = label_val
        row["label_num"] = label_num

        tkey = np.zeros(caps.taints, np.int32)
        tval = np.zeros(caps.taints, np.int32)
        teff = np.zeros(caps.taints, np.int32)
        taints = node.spec.taints if node is not None else ()
        if len(taints) > caps.taints:
            raise CapacityError("taints", len(taints), caps.taints)
        for i, t in enumerate(taints):
            tkey[i] = self.key_slot(t.key)
            tval[i] = self.value_id(t.key, t.value)
            teff[i] = _EFFECT_CODE[t.effect]
        row["taint_key"], row["taint_val"], row["taint_effect"] = tkey, tval, teff

        ibits = np.zeros(caps.image_words, np.uint32)
        for name in ni.image_states:
            iid = self.image_id(name)
            ibits[iid >> 5] |= np.uint32(1 << (iid & 31))
        row["image_bits"] = ibits

        # torus coordinates: labeled nodes are authoritative; unlabeled ones
        # take slot-derived synthetic coords (slots are stable for a node's
        # lifetime and this cached row is dropped on release_node_slot, so
        # the slot dependence cannot go stale while cached)
        sp = pos = -1
        if node is not None:
            sp_s = node.meta.labels.get(TOPO_SUPERPOD_LABEL)
            pos_s = node.meta.labels.get(TOPO_SLOT_LABEL)
            if sp_s is not None and pos_s is not None:
                try:
                    sp, pos = int(sp_s), int(pos_s)
                except (ValueError, OverflowError):
                    sp = pos = -1
            if sp < 0 or pos < 0:
                slot = self.node_slots.get(node.meta.name)
                if slot is not None:
                    sp, pos = slot // caps.sp_slots, slot % caps.sp_slots
            if sp >= caps.superpods:
                raise CapacityError("superpods", sp + 1, caps.superpods)
            if pos >= caps.sp_slots:
                raise CapacityError("sp_slots", pos + 1, caps.sp_slots)
        row["topo_sp"] = np.array(sp, np.int32)
        row["topo_pos"] = np.array(pos, np.int32)
        return row

    def encode_dynamic_fields(self, ni: NodeInfo) -> Dict[str, np.ndarray]:
        """Row fields that pod commits change (requested/nonzero/ports/
        class_req) — the reconcile hot path re-encodes ONLY these."""
        row: Dict[str, np.ndarray] = {}
        req = ni.requested.as_map()
        req[resource_api.PODS] = len(ni.pods)
        row["requested"] = self.resource_vec(req)
        nzreq = ni.non_zero_requested.as_map()
        nzreq[resource_api.PODS] = len(ni.pods)
        row["nonzero_requested"] = self.resource_vec(nzreq)

        pbits = np.zeros(self.caps.port_words, np.uint32)
        for (ip, proto, port) in ni.used_ports:
            for pid in (self.port_id(ip, proto, port), self.port_id("*", proto, port)):
                pbits[pid >> 5] |= np.uint32(1 << (pid & 31))
        row["port_bits"] = pbits

        # priority-class-bucketed request sums (batched preemption screen),
        # from NodeInfo's incremental buckets — O(distinct priorities), not
        # O(pods on node) (this runs per dirty row on sync AND reconcile)
        creq = np.zeros((self.caps.prio_classes, self.caps.resources), np.int32)
        for prio, bucket in ni.prio_requested.items():
            cid = self.prio_class_id(prio)
            creq[cid] += self.resource_vec(bucket)
        row["class_req"] = creq
        return row

    def encode_node_row(self, ni: NodeInfo) -> Dict[str, np.ndarray]:
        """One NodeTensors row (no slot assignment here)."""
        node = ni.node
        static = None
        if node is not None:
            key = node.meta.name
            # keyed by OBJECT IDENTITY with the reference held (so the id
            # can never be recycled while cached): any replaced Node object
            # re-encodes, store-bumped or not
            cached = self._static_rows.get(key)
            if cached is not None and cached[0] is node:
                static = cached[1]
            else:
                static = self._encode_static_fields(ni)
                for arr in static.values():
                    arr.flags.writeable = False  # aliased into rows: freeze
                self._static_rows[key] = (node, static)
        else:
            static = self._encode_static_fields(ni)
        row: Dict[str, np.ndarray] = dict(static)
        row.update(self.encode_dynamic_fields(ni))
        return row

    def image_vocab_arrays(self, node_infos: Sequence[NodeInfo]) -> Tuple[np.ndarray, np.ndarray]:
        sizes = np.zeros(self.caps.images, np.int32)
        num_nodes = np.zeros(self.caps.images, np.int32)
        for ni in node_infos:
            for name, size in ni.image_states.items():
                iid = self.image_id(name)
                if num_nodes[iid] == 0:  # first occurrence wins, even a 0 size
                    sizes[iid] = min(size, 2**31 - 1)  # (cache.addNodeImageStates)
                num_nodes[iid] += 1
        return sizes, num_nodes

    def encode_snapshot(self, node_infos: Sequence[NodeInfo]) -> "schema.NodeTensors":
        """Full-snapshot encode (tests / resync path; the incremental path is
        backend/device_state.py)."""
        caps = self.caps
        if len(node_infos) > caps.nodes:
            raise CapacityError("nodes", len(node_infos), caps.nodes)
        rows = []
        for ni in node_infos:
            self.node_slot(ni.node.meta.name)  # assign slots in order
            rows.append(self.encode_node_row(ni))

        def stack(field, dtype, shape_tail):
            out = np.zeros((caps.nodes,) + shape_tail, dtype)
            if field == "label_num":
                out[:] = INT_NONE
            elif field in ("topo_sp", "topo_pos"):
                out[:] = -1  # padding rows carry no topology
            for i, r in enumerate(rows):
                out[self.node_slots[node_infos[i].node.meta.name]] = r[field]
            return out

        sizes, num_nodes = self.image_vocab_arrays(node_infos)
        d = {
            "valid": stack("valid", bool, ()),
            "unschedulable": stack("unschedulable", bool, ()),
            "allocatable": stack("allocatable", np.int32, (caps.resources,)),
            "requested": stack("requested", np.int32, (caps.resources,)),
            "nonzero_requested": stack("nonzero_requested", np.int32, (caps.resources,)),
            "label_val": stack("label_val", np.int32, (caps.label_keys,)),
            "label_num": stack("label_num", np.int32, (caps.label_keys,)),
            "taint_key": stack("taint_key", np.int32, (caps.taints,)),
            "taint_val": stack("taint_val", np.int32, (caps.taints,)),
            "taint_effect": stack("taint_effect", np.int32, (caps.taints,)),
            "port_bits": stack("port_bits", np.uint32, (caps.port_words,)),
            "image_bits": stack("image_bits", np.uint32, (caps.image_words,)),
            "image_sizes": sizes,
            "image_num_nodes": num_nodes,
            "class_req": stack("class_req", np.int32, (caps.prio_classes, caps.resources)),
            "class_prio": self.class_prio_array(),
            "name_hash": stack("name_hash", np.uint32, ()),
            "topo_sp": stack("topo_sp", np.int32, ()),
            "topo_pos": stack("topo_pos", np.int32, ()),
        }
        return schema.NodeTensors.from_numpy(d, self.device)

    # ------------------------------------------------------------- expressions

    def _expr_from_requirement(self, r: Requirement, builder: "_ExprBuilder") -> int:
        ks = self.key_slot(r.key)
        if r.operator == IN:
            ids = frozenset(self.value_id(r.key, v) for v in r.values)
            return builder.slot((schema.OP_IN, ks, 0, ids))
        if r.operator == NOT_IN:
            ids = frozenset(self.value_id(r.key, v) for v in r.values)
            return builder.slot((schema.OP_NOT_IN, ks, 0, ids))
        if r.operator == EXISTS:
            return builder.slot((schema.OP_EXISTS, ks, 0, frozenset()))
        if r.operator == DOES_NOT_EXIST:
            return builder.slot((schema.OP_NOT_EXISTS, ks, 0, frozenset()))
        if r.operator in (GT, LT):
            try:
                rhs = int(r.values[0])
            except (ValueError, IndexError):
                # unparseable Gt/Lt never matches (labels.NewRequirement errors)
                return builder.slot((schema.OP_IN, ks, 0, frozenset()))
            op = schema.OP_GT if r.operator == GT else schema.OP_LT
            return builder.slot((op, ks, rhs, frozenset()))
        raise ValueError(f"unknown operator {r.operator}")

    # ------------------------------------------------------------- pod batch

    def _pod_sig(self, pod: Pod) -> Optional[Tuple]:
        """Hashable signature of every spec field the template encodes, or
        None when the pod is uncacheable (matchFields terms embed the current
        node-slot mapping, which churns)."""
        spec = pod.spec
        a = spec.affinity
        terms: Sequence = ()
        prefs: Sequence = ()
        if a and a.node_affinity:
            if a.node_affinity.required:
                terms = a.node_affinity.required.terms
            prefs = tuple(a.node_affinity.preferred)
        for t in terms:
            if t.match_fields_name is not None:
                return None
        for wt in prefs:
            if wt.preference.match_fields_name is not None:
                return None

        def reqs(c):
            return tuple(sorted((r, str(q)) for r, q in c.requests.items()))

        def exprs(term):
            return tuple((r.key, r.operator, tuple(r.values))
                         for r in term.match_expressions)

        try:
            return (
                tuple(reqs(c) for c in spec.containers),
                tuple(reqs(c) for c in spec.init_containers),
                tuple(sorted((r, str(q)) for r, q in spec.overhead.items())),
                spec.priority,
                tuple((t.key, t.operator, t.value, t.effect) for t in spec.tolerations),
                tuple(spec.node_selector.items()),
                tuple(exprs(t) for t in terms),
                tuple((wt.weight, exprs(wt.preference)) for wt in prefs),
                tuple((cp.host_ip, cp.protocol, cp.host_port) for cp in pod.host_ports()),
                len(spec.containers),
            )
        except TypeError:  # unhashable field value: just skip caching
            return None

    def _build_template(self, pod: Pod) -> _PodTemplate:
        caps = self.caps
        kb = _KeyBuilder()

        r = dict(pod.resource_request())  # copy: resource_request() is cached
        r[resource_api.PODS] = 1
        nz = nonzero_request(pod.resource_request())
        nz[resource_api.PODS] = 1

        tols = pod.spec.tolerations
        if len(tols) > caps.tolerations:
            raise CapacityError("tolerations", len(tols), caps.tolerations)
        tol_key = np.zeros(caps.tolerations, np.int32)
        tol_val = np.zeros(caps.tolerations, np.int32)
        tol_op = np.zeros(caps.tolerations, np.int32)
        tol_effect = np.zeros(caps.tolerations, np.int32)
        tol_prefer = np.zeros(caps.tolerations, bool)
        for i, t in enumerate(tols):
            tol_key[i] = self.key_slot(t.key) if t.key else 0
            tol_op[i] = schema.TOL_EXISTS if t.operator == TOLERATION_OP_EXISTS else schema.TOL_EQUAL
            if t.key and tol_op[i] == schema.TOL_EQUAL:
                tol_val[i] = self.value_id(t.key, t.value)
            tol_effect[i] = _EFFECT_CODE[t.effect]
            tol_prefer[i] = t.effect in ("", TAINT_PREFER_NO_SCHEDULE)

        # nodeSelector map → AND of single-value IN exprs
        sel = list(pod.spec.node_selector.items())
        if len(sel) > caps.sel_exprs:
            raise CapacityError("sel_exprs", len(sel), caps.sel_exprs)
        sel_keys = tuple(
            self._expr_from_requirement(Requirement(k, IN, (v,)), kb) for k, v in sel)

        def term_key_row(term):
            n_exprs = len(term.match_expressions) + (term.match_fields_name is not None)
            if n_exprs > caps.term_exprs:
                raise CapacityError("term_exprs", n_exprs, caps.term_exprs)
            if not term.match_expressions and term.match_fields_name is None:
                # empty term matches nothing (nodeaffinity semantics)
                return (kb.never_slot(),)
            row = [self._expr_from_requirement(r_, kb) for r_ in term.match_expressions]
            if term.match_fields_name is not None:
                tgt = self.node_slots.get(term.match_fields_name, -2)
                row.append((schema.OP_NODE_NAME, 0, tgt, frozenset()))
            return tuple(row)

        a = pod.spec.affinity
        terms: Sequence = ()
        if a and a.node_affinity and a.node_affinity.required:
            terms = a.node_affinity.required.terms
        if len(terms) > caps.terms:
            raise CapacityError("terms", len(terms), caps.terms)
        term_keys = tuple(term_key_row(t) for t in terms)

        prefs = tuple(a.node_affinity.preferred) if a and a.node_affinity else ()
        if len(prefs) > caps.pref_terms:
            raise CapacityError("pref_terms", len(prefs), caps.pref_terms)
        pref_terms = tuple((wt.weight, term_key_row(wt.preference)) for wt in prefs)

        # host ports: specific IP wants (ip,…) OR (0.0.0.0,…); wildcard wants ("*",…)
        wanted: List[int] = []
        for cp in pod.host_ports():
            ip = cp.host_ip or "0.0.0.0"
            if ip == "0.0.0.0":
                wanted.append(self.port_id("*", cp.protocol, cp.host_port))
            else:
                wanted.append(self.port_id(ip, cp.protocol, cp.host_port))
                wanted.append(self.port_id("0.0.0.0", cp.protocol, cp.host_port))
        wanted = list(dict.fromkeys(wanted))  # dedupe (repeat hostPorts across containers)
        if len(wanted) > caps.ports:
            raise CapacityError("ports", len(wanted), caps.ports)
        if len(pod.spec.containers) > caps.containers:
            raise CapacityError("containers", len(pod.spec.containers), caps.containers)

        return _PodTemplate(
            priority=pod.spec.priority,
            req=self.resource_vec(r),
            nzreq=self.resource_vec(nz),
            tol_key=tol_key, tol_val=tol_val, tol_op=tol_op,
            tol_effect=tol_effect, tol_prefer=tol_prefer,
            tolerates_unsched=any(t.tolerates(_UNSCHEDULABLE_TAINT) for t in tols),
            sel_keys=sel_keys,
            term_keys=term_keys,
            pref_terms=pref_terms,
            port_wanted=tuple(wanted),
            n_containers=len(pod.spec.containers),
        )

    def _template_for(self, pod: Pod) -> _PodTemplate:
        sig = self._pod_sig(pod)
        if sig is None:
            return self._build_template(pod)
        tmpl = self._pod_templates.get(sig)
        if tmpl is None:
            tmpl = self._build_template(pod)
            if len(self._pod_templates) >= self._template_cap:
                self._pod_templates.clear()
            self._pod_templates[sig] = tmpl
        return tmpl

    def encode_pods(self, pods: Sequence[Pod], capacity: Optional[int] = None,
                    tie_seeds: Optional[Sequence[int]] = None,
                    ) -> Tuple["schema.PodBatch", "schema.ExprTable"]:
        """``capacity`` pads the pod axis to a smaller bucket than caps.pods:
        the compiled program's step count (and the speculative rounds' [P,N]
        width) is the PADDED size, so deadline-cut batches must compile at a
        matching bucket or they pay the full-capacity program anyway."""
        caps = self.caps
        P = caps.pods if capacity is None else min(int(capacity), caps.pods)
        if len(pods) > caps.pods:
            raise CapacityError("pods", len(pods), caps.pods)
        assert len(pods) <= P, "bucket smaller than the batch"
        builder = _ExprBuilder(caps, self.device)

        valid = np.zeros(P, bool)
        priority = np.zeros(P, np.int32)
        req = np.zeros((P, caps.resources), np.int32)
        nzreq = np.zeros((P, caps.resources), np.int32)
        node_name = np.full(P, -1, np.int32)
        nominated = np.full(P, -1, np.int32)
        tol_key = np.zeros((P, caps.tolerations), np.int32)
        tol_val = np.zeros((P, caps.tolerations), np.int32)
        tol_op = np.zeros((P, caps.tolerations), np.int32)
        tol_effect = np.zeros((P, caps.tolerations), np.int32)
        tol_prefer = np.zeros((P, caps.tolerations), bool)
        tolerates_unsched = np.zeros(P, bool)
        sel_idx = np.zeros((P, caps.sel_exprs), np.int32)
        term_idx = np.zeros((P, caps.terms, caps.term_exprs), np.int32)
        term_valid = np.zeros((P, caps.terms), bool)
        pref_idx = np.zeros((P, caps.pref_terms, caps.term_exprs), np.int32)
        pref_weight = np.zeros((P, caps.pref_terms), np.int32)
        port_ids = np.zeros((P, caps.ports), np.int32)
        image_ids = np.zeros((P, caps.containers), np.int32)
        num_containers = np.zeros(P, np.int32)

        for p, pod in enumerate(pods):
            tmpl = self._template_for(pod)
            valid[p] = True
            priority[p] = tmpl.priority
            req[p] = tmpl.req
            nzreq[p] = tmpl.nzreq
            tol_key[p] = tmpl.tol_key
            tol_val[p] = tmpl.tol_val
            tol_op[p] = tmpl.tol_op
            tol_effect[p] = tmpl.tol_effect
            tol_prefer[p] = tmpl.tol_prefer
            tolerates_unsched[p] = tmpl.tolerates_unsched
            for i, k in enumerate(tmpl.sel_keys):
                sel_idx[p, i] = builder.slot(k)
            for t_i, keys in enumerate(tmpl.term_keys):
                term_valid[p, t_i] = True
                for e_i, k in enumerate(keys):
                    term_idx[p, t_i, e_i] = builder.slot(k)
            for t_i, (w, keys) in enumerate(tmpl.pref_terms):
                pref_weight[p, t_i] = w
                for e_i, k in enumerate(keys):
                    pref_idx[p, t_i, e_i] = builder.slot(k)
            port_ids[p, : len(tmpl.port_wanted)] = tmpl.port_wanted
            num_containers[p] = tmpl.n_containers
            # per-pod (never cached): node-slot binding + image-vocab lookup
            # (slots churn with nodes; the image vocab grows as nodes report)
            if pod.spec.node_name:
                node_name[p] = self.node_slots.get(pod.spec.node_name, -2)  # -2: unknown ⇒ never matches
            if pod.status.nominated_node_name:
                nominated[p] = self.node_slots.get(pod.status.nominated_node_name, -1)
            imgs = [self.image_vocab.lookup(normalized_image_name(c.image))
                    for c in pod.spec.containers]
            image_ids[p, : len(imgs)] = imgs

        # host copies of the commit-relevant arrays: DeviceState.adopt_commits
        # advances its host mirror from these without a device→host read of
        # the PodBatch
        prio_class = np.zeros(P, np.int32)
        for p, pod in enumerate(pods):
            prio_class[p] = self.prio_class_id(pod.spec.priority)
        tie_seed = np.zeros(P, np.uint32)
        if tie_seeds is not None:
            tie_seed[: len(tie_seeds)] = np.asarray(tie_seeds, np.uint32)[:P]
        else:
            for p, pod in enumerate(pods):
                tie_seed[p] = pod_seed(pod.key(), 0)
        self.last_host_pb = {"req": req, "nonzero_req": nzreq,
                             "port_ids": port_ids, "prio_class": prio_class}
        self.last_has_ports = bool(port_ids.any())
        batch = schema.PodBatch.from_numpy({
            "valid": valid, "priority": priority, "prio_class": prio_class,
            "req": req, "nonzero_req": nzreq, "node_name": node_name,
            "nominated": nominated, "tol_key": tol_key, "tol_val": tol_val,
            "tol_op": tol_op, "tol_effect": tol_effect, "tol_prefer": tol_prefer,
            "tolerates_unschedulable": tolerates_unsched, "sel_idx": sel_idx,
            "term_idx": term_idx, "term_valid": term_valid,
            "pref_idx": pref_idx, "pref_weight": pref_weight,
            "port_ids": port_ids, "image_ids": image_ids,
            "num_containers": num_containers, "tie_seed": tie_seed,
        }, self.device)
        return batch, builder.table()


class _KeyBuilder:
    """Builder shim for template construction: returns expr KEYS, deferring
    slot interning to the per-batch _ExprBuilder."""

    @staticmethod
    def slot(key: Tuple) -> Tuple:
        return key

    @staticmethod
    def never_slot() -> Tuple:
        return (schema.OP_IN, 0, 0, frozenset())


class _ExprBuilder:
    """Dedup unique expressions into ExprTable slots. Slot 0 = OP_TRUE."""

    def __init__(self, caps: Capacities, device):
        self.caps = caps
        self.device = device
        self._slots: Dict[Tuple, int] = {(schema.OP_TRUE, 0, 0, frozenset()): 0}

    def slot(self, key: Tuple) -> int:
        s = self._slots.get(key)
        if s is None:
            s = len(self._slots)
            if s >= self.caps.exprs:
                raise CapacityError("exprs", s + 1, self.caps.exprs)
            self._slots[key] = s
        return s

    def never_slot(self) -> int:
        # IN with an empty value set matches nothing
        return self.slot((schema.OP_IN, 0, 0, frozenset()))

    def table(self) -> "schema.ExprTable":
        E = self.caps.exprs
        op = np.zeros(E, np.int32)
        key = np.zeros(E, np.int32)
        val = np.zeros(E, np.int32)
        bits = np.zeros((E, self.caps.value_words), np.uint32)
        for (o, k, v, ids), s in self._slots.items():
            op[s], key[s], val[s] = o, k, v
            for vid in ids:
                bits[s, vid >> 5] |= np.uint32(1 << (vid & 31))
        return schema.ExprTable.from_numpy(
            {"op": op, "key": key, "val": val, "bits": bits}, self.device)
