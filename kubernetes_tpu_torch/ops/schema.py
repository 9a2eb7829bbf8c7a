"""Dense tensor schemas for the device-resident cluster mirror (PyTorch).

The same fields, shapes and layouts as ``kubernetes_tpu/ops/schema.py``
(NodeTensors, ExprTable, PodBatch, TopoCounts, TopoBatch), as plain
dataclasses of torch tensors.

* Nodes live in fixed **slots** (stable indices into the N axis) with an
  explicit ``valid`` mask; every array is padded to static capacities.
* Labels are a dense per-key table: ``label_val[N, K]`` is the value id of
  node n for key k (0 = absent), ``label_num[N, K]`` its integer parse
  (INT_NONE when not numeric).
* Resource vectors are int32 in canonical units (api/resource.py): col 0 =
  cpu milli, 1 = memory KiB, 2 = ephemeral MiB, 3 = pod count, 4.. = scalar
  resources by scalar-vocab slot.

uint32 fields (bitsets, hashes, seeds) are held as int32 tensors carrying the
same 32 bits: PyTorch's uint32 supports few operations, and every operation
the port applies to them (and, or, xor, a bit test after a shift) gives the
same bits on int32. ``as_i32_bits`` converts a numpy uint32 array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT_NONE = np.int32(-(2**31))  # sentinel for "absent" numeric label

# resource columns
COL_CPU = 0
COL_MEM = 1
COL_EPH = 2
COL_PODS = 3
N_FIXED_COLS = 4

# expression opcodes (the selector VM)
OP_TRUE = 0       # constant true (slot 0 of every ExprTable; AND-neutral padding)
OP_IN = 1         # label_val[n, key] ∈ value-id set (bitset over the key's value vocab)
OP_NOT_IN = 2     # absent key matches (labels.Requirement semantics)
OP_EXISTS = 3
OP_NOT_EXISTS = 4
OP_GT = 5         # int(label) > val; absent/non-numeric never matches
OP_LT = 6
OP_NODE_NAME = 7  # node slot == val (compiled metadata.name matchFields)

# taint effects
EFFECT_NONE = 0
EFFECT_NO_SCHEDULE = 1
EFFECT_PREFER_NO_SCHEDULE = 2
EFFECT_NO_EXECUTE = 3

# toleration operators
TOL_EQUAL = 1
TOL_EXISTS = 2

# the uint32 fields of each dataclass (held as int32 bit patterns)
U32_FIELDS = frozenset({"port_bits", "image_bits", "name_hash", "bits", "tie_seed"})


def as_i32_bits(a) -> np.ndarray:
    """numpy uint32 (or any 32-bit pattern) -> int32 with the same bits."""
    return np.ascontiguousarray(np.asarray(a).astype(np.uint32, copy=False)).view(np.int32)


def tensor_from_numpy(name: str, a, device) -> torch.Tensor:
    """One field to a tensor on ``device``: uint32 fields keep their bits
    in int32, everything else keeps its dtype. Always a copy: the host
    arrays (encoder rows, DeviceState's mirror) keep changing."""
    a = np.asarray(a)
    if name in U32_FIELDS:
        a = as_i32_bits(a)
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


class _Tensors:
    """Shared helpers of the tensor dataclasses."""

    @classmethod
    def from_numpy(cls, d: dict, device) -> "_Tensors":
        return cls(**{f.name: tensor_from_numpy(f.name, d[f.name], device)
                      for f in dataclasses.fields(cls)})

    def to_numpy(self) -> dict:
        """Field dict of numpy arrays; uint32 fields come back as uint32."""
        out = {}
        for f in dataclasses.fields(self):
            a = getattr(self, f.name).cpu().numpy()
            out[f.name] = a.view(np.uint32) if f.name in U32_FIELDS else a
        return out


@dataclasses.dataclass
class NodeTensors(_Tensors):
    """Device-resident per-node state, [N]-padded."""

    valid: torch.Tensor          # [N] bool
    unschedulable: torch.Tensor  # [N] bool
    allocatable: torch.Tensor    # [N, R] int32 (col PODS = allowed pod count)
    requested: torch.Tensor      # [N, R] int32 (col PODS = current pod count)
    nonzero_requested: torch.Tensor  # [N, R] int32 (scoring-path requests)
    label_val: torch.Tensor      # [N, K] int32 value-id (0 absent)
    label_num: torch.Tensor      # [N, K] int32 numeric parse (INT_NONE absent)
    taint_key: torch.Tensor      # [N, T] int32 key-id (0 = no taint in slot)
    taint_val: torch.Tensor      # [N, T] int32 value-id in key's vocab
    taint_effect: torch.Tensor   # [N, T] int32 effect code
    port_bits: torch.Tensor      # [N, Wport] uint32 bits in int32
    image_bits: torch.Tensor     # [N, Wimg] uint32 bits in int32
    image_sizes: torch.Tensor    # [Vimg] int32 bytes (vocab-level, not per node)
    image_num_nodes: torch.Tensor  # [Vimg] int32 (ImageStateSummary.NumNodes)
    class_req: torch.Tensor      # [N, C, R] int32 requested by pods of priority class c
    class_prio: torch.Tensor     # [C] int32 priority value of class c
    name_hash: torch.Tensor      # [N] uint32 fnv1a(node name) bits in int32
    topo_sp: torch.Tensor        # [N] int32 superpod id (-1 absent)
    topo_pos: torch.Tensor       # [N] int32 torus slot within superpod (-1 absent)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


@dataclasses.dataclass
class ExprTable(_Tensors):
    """Batch-level deduplicated selector expressions, evaluated once per batch
    to an [E, N] match matrix. Slot 0 is OP_TRUE."""

    op: torch.Tensor      # [E] int32 opcode
    key: torch.Tensor     # [E] int32 label-key slot
    val: torch.Tensor     # [E] int32 (GT/LT compare value or NODE_NAME slot)
    bits: torch.Tensor    # [E, Wv] uint32 value-id set, bits in int32


@dataclasses.dataclass
class PodBatch(_Tensors):
    """A micro-batch of pending pods, [P]-padded, with compiled programs
    pointing into the batch ExprTable."""

    valid: torch.Tensor        # [P] bool
    priority: torch.Tensor     # [P] int32
    prio_class: torch.Tensor   # [P] int32 priority-class vocab id
    req: torch.Tensor          # [P, R] int32 (filter-path request; col PODS == 1)
    nonzero_req: torch.Tensor  # [P, R] int32 (scoring-path request)
    node_name: torch.Tensor    # [P] int32 target slot or -1 (pod.spec.nodeName)
    nominated: torch.Tensor    # [P] int32 nominatedNodeName slot or -1
    tol_key: torch.Tensor      # [P, L] int32 (0 = wildcard key)
    tol_val: torch.Tensor      # [P, L] int32
    tol_op: torch.Tensor       # [P, L] int32 (0 = empty slot)
    tol_effect: torch.Tensor   # [P, L] int32 (EFFECT_NONE = matches all effects)
    tol_prefer: torch.Tensor   # [P, L] bool: effect ∈ {"", PreferNoSchedule}
    tolerates_unschedulable: torch.Tensor  # [P] bool
    sel_idx: torch.Tensor      # [P, S] int32 expr slots, AND-combined (0 = true)
    term_idx: torch.Tensor     # [P, TERM, EXPR] int32 expr slots
    term_valid: torch.Tensor   # [P, TERM] bool (no valid terms ⇒ affinity passes)
    pref_idx: torch.Tensor     # [P, PTERM, EXPR] int32
    pref_weight: torch.Tensor  # [P, PTERM] int32
    port_ids: torch.Tensor     # [P, MP] int32 wanted-port vocab ids (0 = empty)
    image_ids: torch.Tensor    # [P, C] int32 container image vocab ids (0 = empty)
    num_containers: torch.Tensor  # [P] int32
    tie_seed: torch.Tensor     # [P] uint32 tie-break seed, bits in int32

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


@dataclasses.dataclass
class TopoCounts(_Tensors):
    """Device-resident pod-set count tables (backend/sig_table.py keeps the
    host truth). ``sel_counts[s, n]``: pods on node n that match registered
    signature s, a (namespaces, label selector) pair, the unit both topology
    plugins count by. ``term_counts[t, n]``: pods on node n that carry
    registered (anti-)affinity term t (the symmetric direction). Row 0 of
    both is reserved and stays zero."""

    sel_counts: torch.Tensor   # [S, N] int32
    term_counts: torch.Tensor  # [T, N] int32
    term_key: torch.Tensor     # [T] int32 topology-key slot of term t (0 = unused row)


@dataclasses.dataclass
class TopoBatch(_Tensors):
    """A batch's compiled topology programs, pointing into TopoCounts rows.
    Index fields are 0 where invalid (row 0 of each table is a zero row and
    key slot 0 is never a label key, so its domain id is always 0)."""

    # PodTopologySpread DoNotSchedule constraints (filter), [P, C]
    sf_valid: torch.Tensor        # bool
    sf_sig: torch.Tensor          # int32 signature row
    sf_key: torch.Tensor          # int32 topology-key slot
    sf_skew: torch.Tensor         # int32 maxSkew
    sf_self: torch.Tensor         # bool: the pod matches its own constraint selector
    sf_min_domains: torch.Tensor  # int32, -1 = unset
    # PodTopologySpread ScheduleAnyway constraints (score), [P, C]
    ss_valid: torch.Tensor
    ss_sig: torch.Tensor
    ss_key: torch.Tensor
    ss_skew: torch.Tensor
    ss_hostname: torch.Tensor     # bool: topologyKey == kubernetes.io/hostname
    ss_require_all: torch.Tensor  # [P] bool: pod-specified constraints
    # the pod's required pod-affinity terms, [P, A]
    ia_valid: torch.Tensor
    ia_sig: torch.Tensor
    ia_key: torch.Tensor
    ia_self_all: torch.Tensor     # [P] bool: the pod matches all its own affinity terms
    # the pod's required pod-anti-affinity terms, [P, A]
    ianti_valid: torch.Tensor
    ianti_sig: torch.Tensor
    ianti_key: torch.Tensor
    # the pod's preferred (anti-)affinity terms, [P, PT]
    ip_valid: torch.Tensor
    ip_sig: torch.Tensor
    ip_key: torch.Tensor
    ip_w: torch.Tensor            # int32 signed weight (negative = anti)
    # existing pods' terms against the incoming pod, [P, T]
    term_filter_match: torch.Tensor  # bool: required anti-affinity term t matches pod p
    term_score_w: torch.Tensor       # float32 symmetric score weight of term t for pod p
    # what a committing pod adds to the node it lands on
    pod_sig_mask: torch.Tensor    # [P, S] bool
    pod_term_mask: torch.Tensor   # [P, T] bool


def round_node_capacity(n: int, floor: int = 128) -> int:
    """Node-axis padding bucket: powers of two up to 1024, then multiples of
    1024 (5000 nodes pad to 5120, not 8192: every per-step tensor of the
    commit program is [N, ·], so the padding is paid on every pod)."""
    cap = max(128, floor)
    while cap < n and cap < 1024:
        cap *= 2
    if cap < n:
        cap = ((n + 1023) // 1024) * 1024
    return cap


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Static padding sizes (the same fields and defaults as the JAX
    package, so one encoded state fits both)."""

    nodes: int = 128          # N
    pods: int = 64            # P
    resources: int = 6        # R (4 fixed + scalar slots)
    label_keys: int = 16      # K
    taints: int = 4           # T per node
    tolerations: int = 4      # L per pod
    exprs: int = 64           # E per batch
    sel_exprs: int = 8        # S per pod
    terms: int = 4            # affinity terms per pod
    term_exprs: int = 4       # exprs per term
    pref_terms: int = 4       # preferred terms per pod
    value_words: int = 32     # Wv: value-vocab bitset words (per-key vocab ≤ 32*Wv)
    port_words: int = 16      # Wport
    ports: int = 8            # MP wanted ports per pod
    image_words: int = 16     # Wimg
    images: int = 1 + 16 * 32  # Vimg (vocab capacity = image_words*32, +0 slot)
    containers: int = 4       # C per pod
    sigs: int = 8             # registered pod-set signatures (topology)
    ex_terms: int = 8         # registered existing-pod terms (topology)
    spread_cons: int = 2      # spread constraints per pod per kind
    ipa_terms: int = 2        # required (anti-)affinity terms per pod
    ipa_pref: int = 2         # preferred pod-affinity terms per pod
    prio_classes: int = 32    # distinct pod priority values (+ reserved row 0)
    superpods: int = 16       # torus superpods (slice packing; later slice)
    sp_slots: int = 16        # node positions per superpod torus

    def grow_nodes(self, n: int) -> "Capacities":
        return dataclasses.replace(self, nodes=round_node_capacity(n, self.nodes))
