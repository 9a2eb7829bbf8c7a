"""Device-resident cluster mirror with generation-keyed delta uploads.

PyTorch counterpart of ``kubernetes_tpu/backend/device_state.py`` for the
main path: the host tracks the last-uploaded generation per node, ``sync``
encodes only dirty NodeInfos, skips rows whose content already matches the
device (a host mirror of every row), and writes the rest with one
``index_copy_`` per field over a power-of-two bucket of slots. Removed nodes
are tombstoned (row zeroed, slot to the encoder's free-list for reuse).
``adopt_device`` / ``adopt_commits`` take a batch's evolved carry as the new
device truth and advance the mirror by the same commits, so the next sync
uploads nothing for commit-only changes.

Device attributes (resource.k8s.io DRA) live in a table of their own,
``attr_kind`` / ``attr_val`` ([N, A] int32 on the device; kind 0 = absent,
1 = int, 2 = interned string id), outside the row mirror: no batch commit
touches them. ``sync`` records the published map of every dirty or removed
node and uploads the whole table again when one changed. The attribute-key
axis grows by doubling; string values are refcounted and their freed ids
recycled, in the JAX package's order.

Namespace quota rows live in a pair of their own, ``nsq_used`` /
``nsq_limit`` ([NS, Q] int32; ``set_ns_quota``): the ledger's view the
device screen (``ops/quota.py``) judges winners against. No batch commit
touches them; the namespace axis starts at 8 rows and doubles.

Topology counts live in a ``SigTable`` (host truth, numpy): ``sync``
recounts every removed or dirty node slot there, and ``tc`` uploads the
tables again only when the table's version moved. A batch's evolved topology
carry is not adopted: the next sync recounts the nodes it bound pods to.

Capacity growth: the encoder raises CapacityError when a vocab or axis
overflows; the caller rebuilds with grown Capacities and resyncs.

The in-flight ring's two probes (``kubernetes_tpu/backend/device_state.py
:519-618``): ``reconcile`` refreshes the uploaded generation of every row
whose only change was an adopted batch commit (it re-encodes the four
dynamic fields alone and compares them with the mirror) and leaves every
other row dirty, uploading nothing; ``has_dirty`` says whether ``sync``
would find work. While the snapshot's structure version is the one the
last full walk saw, both visit only ``changed_names`` and the rows left
pending. ``invalidate_row`` puts its row among the pending ones, so a row
the host rejected after the device committed to it is seen again (the JAX
package only drops its generation, and its probes never revisit it:
ROADMAP C5a).

Telemetry (``backend/telemetry.py``, ``:409-516``): the row upload runs
under ``dispatch("apply_rows", bucket)`` and counts its bytes (the stacked
rows and the int32 slot index, as the JAX package counts them) as an
``upload``; a removed node records ``node_remove`` and a tombstoned slot
handed to a new node ``slot_reclaim``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..api import dra
from ..cache.snapshot import Snapshot
from ..framework.types import NodeInfo
from ..ops.encode import CapacityError, ClusterEncoder
from ..ops.quota import QUOTA_DIMS, QUOTA_NO_LIMIT
from ..framework.plugins.interpodaffinity import NsLabelsFn
from ..ops.schema import Capacities, NodeTensors, TopoCounts, round_node_capacity, tensor_from_numpy
from ..utils.device import DeviceLike, resolve_device
from . import telemetry
from .sig_table import SigTable

_ROW_FIELDS = (
    ("valid", bool), ("unschedulable", bool),
    ("allocatable", np.int32), ("requested", np.int32), ("nonzero_requested", np.int32),
    ("label_val", np.int32), ("label_num", np.int32),
    ("taint_key", np.int32), ("taint_val", np.int32), ("taint_effect", np.int32),
    ("port_bits", np.uint32), ("image_bits", np.uint32), ("class_req", np.int32),
    ("name_hash", np.uint32), ("topo_sp", np.int32), ("topo_pos", np.int32),
)


def _bucket(n: int, floor: int = 8) -> int:
    """Next power of two ≥ n (≥ floor): the scatter sizes stay few."""
    b = floor
    while b < n:
        b *= 2
    return b


class DeviceState:
    def __init__(self, caps: Capacities, device: DeviceLike = None,
                 ns_labels_fn: Optional[NsLabelsFn] = None):
        self.caps = caps
        self.device = resolve_device(device)
        self.encoder = ClusterEncoder(caps, self.device)
        self.sig_table = SigTable(self.encoder, ns_labels_fn)
        self._tc: Optional[TopoCounts] = None   # device copy of the count tables
        self._tc_version = -1                    # sig_table.version it was taken at
        self._uploaded_gen: Dict[str, int] = {}   # node name -> generation on device
        self._image_counts: Dict[str, int] = {}   # image -> num nodes (host truth)
        self._image_sizes: Dict[str, int] = {}
        self._node_images: Dict[str, frozenset] = {}
        # node name -> the Node object its row was last encoded from: labels
        # and taints change only with the object, so a row dirtied by pod
        # commits alone skips the value-vocab retention and reconciles
        self._mirror_node: Dict[str, object] = {}
        # the rows reconcile left dirty, and the snapshot structure version
        # of the last full walk: while it holds, only changed_names and
        # these rows can be stale
        self._recon_pending: Set[str] = set()
        self._seen_struct = -1
        self._n_prio = len(self.encoder.prio_vocab)
        self.rows_uploaded = 0
        self.rows_elided = 0
        self.last_upload_bytes = 0  # the bytes the last sync uploaded
        self.upload_bytes = 0       # the row bytes every sync uploaded, summed
        self.nodes_removed = 0
        # host mirror of the device row content, initialized to the empty-row
        # encoding (label_num is INT_NONE-filled, topo fields -1)
        empty_row = self.encoder.encode_node_row(NodeInfo())
        self._mirror: Dict[str, np.ndarray] = {
            field: np.broadcast_to(
                np.asarray(empty_row[field], dtype),
                (caps.nodes,) + np.shape(empty_row[field])).copy()
            for field, dtype in _ROW_FIELDS
        }
        d = {field: self._mirror[field] for field, _ in _ROW_FIELDS}
        d["image_sizes"] = np.zeros(caps.images, np.int32)
        d["image_num_nodes"] = np.zeros(caps.images, np.int32)
        d["class_prio"] = self.encoder.class_prio_array()
        self.nt = NodeTensors.from_numpy(d, self.device)
        # --- device-attribute table ---------------------------------------
        self.attr_slots: Dict[str, int] = {}    # attribute key -> column
        self.attr_val_ids: Dict[str, int] = {}  # string value vocab (ids from 1)
        # per-value publishing-node counts; an id freed at refcount zero
        # joins the free list and is recycled before the counter grows.
        # Selector operands interned without a publishing node stay pinned.
        self._attr_val_refs: Dict[str, int] = {}
        self._attr_val_free: List[int] = []
        self._attr_val_next = 1
        self._node_attr_values: Dict[str, frozenset] = {}
        self._node_attrs: Dict[str, dict] = {}  # name -> last-synced mapping
        self._attr_cols = 8
        self._attr_kind_m = np.zeros((caps.nodes, self._attr_cols), np.int32)
        self._attr_val_m = np.zeros((caps.nodes, self._attr_cols), np.int32)
        self._upload_attr_table()
        # --- namespace quota rows -----------------------------------------
        self.nsq_slots: Dict[str, int] = {}  # namespace -> row
        self._nsq_rows = 8
        self._nsq_used_m = np.zeros((self._nsq_rows, QUOTA_DIMS), np.int32)
        self._nsq_limit_m = np.full((self._nsq_rows, QUOTA_DIMS), QUOTA_NO_LIMIT, np.int32)
        self.nsq_uploads = 0  # content-diffed uploads of the pair
        self._upload_nsq()

    @property
    def tc(self) -> TopoCounts:
        """Device TopoCounts, uploaded again only when the host truth moved."""
        if self._tc is None or self._tc_version != self.sig_table.version:
            self._tc = self.sig_table.topo_counts()
            self._tc_version = self.sig_table.version
        return self._tc

    @property
    def topo_enabled(self) -> bool:
        return self.sig_table.n_sigs > 1 or self.sig_table.n_terms > 1

    def _refresh_class_prio(self) -> None:
        """Upload the priority-class vocab whenever it grew."""
        if self._n_prio != len(self.encoder.prio_vocab):
            self._n_prio = len(self.encoder.prio_vocab)
            self.nt.class_prio = tensor_from_numpy(
                "class_prio", self.encoder.class_prio_array(), self.device)

    def preempt_inputs(self) -> NodeTensors:
        """The node tensors for the preemption screen, ``class_prio``
        refreshed first: a priority first seen in this batch is still
        INT_MAX on the device."""
        self._refresh_class_prio()
        return self.nt

    def sync(self, snapshot: Snapshot) -> int:
        """Upload rows for nodes whose generation advanced (removed nodes
        first, as tombstones); returns the number of rows uploaded. Raises
        CapacityError when the cluster outgrows the capacities."""
        dirty: List[Tuple[int, NodeInfo]] = []
        images_changed = False
        current = snapshot.node_info_map
        self.last_upload_bytes = 0
        # removed nodes FIRST, so a node added in the same sync reuses the
        # freed slot instead of growing the axis
        removed = [n for n in self.encoder.node_slots if n not in current]
        attr_pending: Dict[int, dict] = {}
        for name in removed:
            self._uploaded_gen.pop(name, None)
            self._mirror_node.pop(name, None)
            slot = self.encoder.release_node_slot(name)
            self.nodes_removed += 1
            telemetry.event("node_remove", node=name, slot=slot if slot is not None else -1)
            if slot is not None:
                dirty.append((slot, NodeInfo()))  # empty row: valid=False
                self.sig_table.recount_node(slot, None)
                self._track_attrs(name, None, slot, attr_pending)
            images_changed |= self._track_images(name, None)
        for name, ni in current.items():
            if self._uploaded_gen.get(name) == ni.generation:
                continue
            reuses0 = self.encoder.slot_reuses
            slot = self.encoder.node_slot(name)
            if self.encoder.slot_reuses != reuses0:
                # a tombstoned row went to this node
                telemetry.event("slot_reclaim", node=name, slot=slot)
            dirty.append((slot, ni))
            self._uploaded_gen[name] = ni.generation
            images_changed |= self._track_images(name, ni)
            self._track_attrs(name, ni, slot, attr_pending)
            if ni.node is not self._mirror_node.get(name):
                self.encoder.retain_node_values(name, ni.node)
            self.sig_table.recount_node(slot, ni)
        if removed and dirty:
            # a slot tombstoned and re-assigned in this sync appears twice:
            # keep only the last write per slot
            dirty = list({slot: (slot, ni) for slot, ni in dirty}.values())
        # the full walk leaves every generation aligned
        self._seen_struct = getattr(snapshot, "structure_version", -1)
        self._recon_pending.clear()
        getattr(snapshot, "changed_names", set()).clear()
        # the attribute table uploads even when every row below is elided
        self._upload_attrs(attr_pending)
        if not dirty:
            self._refresh_class_prio()
            return 0
        changed: List[Tuple[int, dict]] = []
        for slot, ni in dirty:
            row = self.encoder.encode_node_row(ni)
            if ni.node is not None:
                self._mirror_node[ni.node.meta.name] = ni.node
            if all(np.array_equal(np.asarray(row[f], dtype), self._mirror[f][slot])
                   for f, dtype in _ROW_FIELDS):
                self.rows_elided += 1
                continue
            for f, dtype in _ROW_FIELDS:
                self._mirror[f][slot] = np.asarray(row[f], dtype)
            changed.append((slot, row))
        self._refresh_class_prio()  # encoded rows may have grown the vocab
        if images_changed:
            self._upload_images()
        if not changed:
            return 0
        # bucket-pad the row count to a power of two; padding repeats the
        # first row (the same content to the same slot)
        n = len(changed)
        b = _bucket(n)
        slots = np.empty(b, np.int32)
        slots[:n] = [s for s, _ in changed]
        slots[n:] = slots[0]
        nbytes = slots.nbytes
        with telemetry.dispatch("apply_rows", bucket=str(b)):
            # the slots go up as int32, as the JAX package's do, and widen
            # on the device for index_copy_
            idx = torch.from_numpy(slots).to(self.device).long()
            for field, dtype in _ROW_FIELDS:
                stacked = np.empty((b,) + self._mirror[field].shape[1:], dtype)
                stacked[:n] = np.stack([r[field] for _, r in changed]).astype(dtype)
                stacked[n:] = stacked[0]
                nbytes += stacked.nbytes
                getattr(self.nt, field).index_copy_(
                    0, idx, tensor_from_numpy(field, stacked, self.device))
        self.rows_uploaded += n
        self.last_upload_bytes = nbytes
        self.upload_bytes += nbytes
        telemetry.transfer("upload", nbytes)
        return n

    def reconcile(self, snapshot: Snapshot) -> int:
        """The commit side's elide-only sync: refresh the uploaded
        generation of each dirty row whose dynamic fields (requested,
        nonzero requested, ports, class requests) equal the mirror, which
        the adopted commits advanced. Every other row (a new, removed or
        invalidated node, a new Node object or image set, or content that
        differs) stays dirty and pending: the device may already hold the
        next dispatched batch's adopted carry, and writing host rows into it
        would erase those commits. Returns the rows left dirty."""
        self._refresh_class_prio()
        left = 0
        mirror = self._mirror
        req_m, nz_m = mirror["requested"], mirror["nonzero_requested"]
        ports_m, creq_m = mirror["port_bits"], mirror["class_req"]
        if getattr(snapshot, "structure_version", None) == self._seen_struct:
            names = snapshot.changed_names | self._recon_pending
            items = [(n, snapshot.node_info_map[n]) for n in names
                     if n in snapshot.node_info_map]
            check_removals = False
        else:
            items = list(snapshot.node_info_map.items())
            check_removals = True
        pending = set()
        for name, ni in items:
            if self._uploaded_gen.get(name) == ni.generation:
                continue
            slot = self.encoder.node_slots.get(name)
            if (name not in self._uploaded_gen or slot is None
                    or ni.node is not self._mirror_node.get(name)
                    or self._node_images.get(name, frozenset()) != frozenset(ni.image_states)):
                left += 1  # needs a real upload
                pending.add(name)
                continue
            try:
                row = self.encoder.encode_dynamic_fields(ni)
            except CapacityError:
                left += 1
                pending.add(name)
                continue
            if (np.array_equal(row["requested"], req_m[slot])
                    and np.array_equal(row["nonzero_requested"], nz_m[slot])
                    and np.array_equal(row["port_bits"], ports_m[slot])
                    and np.array_equal(row["class_req"], creq_m[slot])):
                self._uploaded_gen[name] = ni.generation
                self.rows_elided += 1
                # with no signature or term registered both count tables
                # are zero: only the backfill source needs the pods
                st = self.sig_table
                if st.n_sigs > 1 or st.n_terms > 1:
                    st.recount_node(slot, ni)
                else:
                    st.track_slot_pods(slot, ni)
            else:
                left += 1
                pending.add(name)
        if check_removals:
            removed = [n for n in self.encoder.node_slots if n not in snapshot.node_info_map]
            left += len(removed)
            pending.update(removed)
            self._seen_struct = getattr(snapshot, "structure_version", -1)
        self._recon_pending = pending
        getattr(snapshot, "changed_names", set()).clear()
        return left

    def has_dirty(self, snapshot: Snapshot) -> bool:
        """Would ``sync`` find a dirty or removed node? A structure change
        reports dirty (the sync it triggers realigns the version)."""
        if getattr(snapshot, "structure_version", None) != self._seen_struct:
            return True
        for name in snapshot.changed_names | self._recon_pending:
            ni = snapshot.node_info_map.get(name)
            if ni is None or self._uploaded_gen.get(name) != ni.generation:
                return True
        return False

    def _upload_images(self) -> None:
        sizes = np.zeros(self.caps.images, np.int32)
        counts = np.zeros(self.caps.images, np.int32)
        for img, cnt in self._image_counts.items():
            iid = self.encoder.image_id(img)
            counts[iid] = cnt
            sizes[iid] = min(self._image_sizes.get(img, 0), 2**31 - 1)
        self.nt.image_sizes = tensor_from_numpy("image_sizes", sizes, self.device)
        self.nt.image_num_nodes = tensor_from_numpy("image_num_nodes", counts, self.device)

    # ------------------------------------------------------- device attributes

    def attr_slot(self, key: str) -> int:
        """Column for an attribute key, registering it (and doubling the
        axis) on first sight. Selector encoding registers keys too, so a
        selector on a never-published key reads a real, all-absent column."""
        slot = self.attr_slots.get(key)
        if slot is None:
            slot = len(self.attr_slots)
            self.attr_slots[key] = slot
            while slot >= self._attr_cols:
                self._grow_attr_cols()
        return slot

    def _grow_attr_cols(self) -> None:
        cols = self._attr_cols * 2
        pad = ((0, 0), (0, cols - self._attr_cols))
        self._attr_kind_m = np.pad(self._attr_kind_m, pad)
        self._attr_val_m = np.pad(self._attr_val_m, pad)
        self._attr_cols = cols
        self._upload_attr_table()

    def _upload_attr_table(self) -> None:
        # a copy, never an alias: the host table keeps changing
        self.attr_kind = torch.tensor(self._attr_kind_m, device=self.device)
        self.attr_val = torch.tensor(self._attr_val_m, device=self.device)

    def attr_value_id(self, value: str) -> int:
        """Interned id of a string attribute value (shared by node rows and
        selector operands: string equality becomes id equality). Freed ids
        are recycled, last freed first, before the counter grows."""
        vid = self.attr_val_ids.get(value)
        if vid is None:
            if self._attr_val_free:
                vid = self._attr_val_free.pop()
            else:
                vid = self._attr_val_next
                self._attr_val_next += 1
            self.attr_val_ids[value] = vid
        return vid

    def _retain_attr_values(self, name: str, attrs: dict) -> None:
        """Refcount the string values ``name`` publishes; a value no node
        publishes any more frees its id."""
        new = set()
        for raw in attrs.values():
            kind, val = dra.attr_kind_val(raw)
            if kind == dra.KIND_STR:
                new.add(val)
        new = frozenset(new)  # built as the JAX package builds it: same set order
        old = self._node_attr_values.get(name, frozenset())
        if new == old:
            return
        for v in new - old:
            self._attr_val_refs[v] = self._attr_val_refs.get(v, 0) + 1
        for v in old - new:
            left = self._attr_val_refs.get(v, 0) - 1
            if left > 0:
                self._attr_val_refs[v] = left
                continue
            self._attr_val_refs.pop(v, None)
            vid = self.attr_val_ids.pop(v, None)
            if vid is not None:
                self._attr_val_free.append(vid)
        if new:
            self._node_attr_values[name] = new
        else:
            self._node_attr_values.pop(name, None)

    def _track_attrs(self, name: str, ni: Optional[NodeInfo], slot: int,
                     pending: Dict[int, dict]) -> None:
        """Record a dirty or removed node's attribute map for upload when it
        changed. Values are retained before any row encodes, so an id freed
        here can be recycled by this sync's newcomers."""
        node = ni.node if ni is not None else None
        attrs = dict(node.status.device_attributes or {}) if node is not None else {}
        if self._node_attrs.get(name, {}) == attrs:
            return
        self._retain_attr_values(name, attrs)
        if attrs:
            self._node_attrs[name] = attrs
        else:
            self._node_attrs.pop(name, None)
        for key in attrs:
            self.attr_slot(key)  # register first: rows encode after growth
        pending[slot] = attrs

    def _upload_attrs(self, pending: Dict[int, dict]) -> None:
        """Encode the pending rows and upload the whole table: attribute
        maps change only with node-object churn, and [N, A] int32 is small."""
        if not pending:
            return
        for slot, attrs in pending.items():
            krow = np.zeros(self._attr_cols, np.int32)
            vrow = np.zeros(self._attr_cols, np.int32)
            for key, raw in attrs.items():
                kind, val = dra.attr_kind_val(raw)
                if kind == dra.KIND_ABSENT:
                    continue
                col = self.attr_slot(key)
                krow[col] = kind
                vrow[col] = val if kind == dra.KIND_INT else self.attr_value_id(val)
            self._attr_kind_m[slot] = krow
            self._attr_val_m[slot] = vrow
        self._upload_attr_table()

    # ------------------------------------------------ namespace quota rows

    def _upload_nsq(self) -> None:
        self.nsq_used = torch.from_numpy(self._nsq_used_m.copy()).to(self.device)
        self.nsq_limit = torch.from_numpy(self._nsq_limit_m.copy()).to(self.device)

    def _grow_nsq_rows(self) -> None:
        grow = self._nsq_rows
        self._nsq_used_m = np.concatenate(
            [self._nsq_used_m, np.zeros((grow, QUOTA_DIMS), np.int32)])
        self._nsq_limit_m = np.concatenate(
            [self._nsq_limit_m, np.full((grow, QUOTA_DIMS), QUOTA_NO_LIMIT, np.int32)])
        self._nsq_rows += grow

    def set_ns_quota(self, table: Dict[str, Tuple]) -> bool:
        """Sync the quota rows from the ledger's view (ns -> (used row,
        limit row) in QUOTA_DIM_ORDER ints, values clipped to [0, int32
        max]). ``table`` is the whole desired state: a namespace that left
        it resets to a row that never flags. Content-diffed against the
        host copy; returns whether the pair was uploaded again."""
        cap = int(QUOTA_NO_LIMIT)
        dirty = False
        for ns, slot in self.nsq_slots.items():
            if ns not in table and (self._nsq_used_m[slot].any()
                                    or (self._nsq_limit_m[slot] != cap).any()):
                self._nsq_used_m[slot] = 0
                self._nsq_limit_m[slot] = cap
                dirty = True
        for ns, (used_row, limit_row) in table.items():
            slot = self.nsq_slots.get(ns)
            if slot is None:
                slot = self.nsq_slots[ns] = len(self.nsq_slots)
                while slot >= self._nsq_rows:
                    self._grow_nsq_rows()
                dirty = True
            for mirror, row in ((self._nsq_used_m, used_row), (self._nsq_limit_m, limit_row)):
                v = np.clip(np.asarray(row, np.int64), 0, cap).astype(np.int32)
                if not np.array_equal(mirror[slot], v):
                    mirror[slot] = v
                    dirty = True
        if dirty:
            self._upload_nsq()  # [NS, Q] is tiny: the whole pair, no scatter
            self.nsq_uploads += 1
        return dirty

    # ------------------------------------------------------- batch adoption

    def adopt_device(self, result) -> None:
        """Take the batch's evolved dynamic state as the new device truth.
        The mirror owns those tensors from here on: a later ``sync`` writes
        rows into them in place."""
        self.nt.requested = result.final_requested
        self.nt.nonzero_requested = result.final_nonzero
        self.nt.port_bits = result.final_ports
        self.nt.class_req = result.final_class_req

    def adopt_commits(self, result, host_pb: dict, node_idx: np.ndarray) -> None:
        """Advance the host mirror by the batch's per-slot adds, so the next
        sync's content diff elides every row whose only change was this
        batch's commits. ``host_pb`` is the encoder's host copy of the batch
        (ClusterEncoder.last_host_pb)."""
        req = host_pb["req"]
        nz = host_pb["nonzero_req"]
        port_ids = host_pb["port_ids"]
        prio_class = host_pb["prio_class"]
        for i, slot in enumerate(node_idx):
            if slot < 0:
                continue
            self._mirror["requested"][slot] += req[i]
            self._mirror["nonzero_requested"][slot] += nz[i]
            self._mirror["class_req"][slot, prio_class[i]] += req[i]
            for pid in port_ids[i]:
                if pid > 0:
                    self._mirror["port_bits"][slot, pid >> 5] |= np.uint32(1) << np.uint32(pid & 31)

    def invalidate_row(self, name: str) -> None:
        """Forget the generation uploaded for ``name`` and mark it pending:
        ``has_dirty`` reports it, ``reconcile`` leaves it dirty, and the
        next ``sync`` re-encodes its row from the snapshot and, where the
        row differs from the mirror (which the adopted carry has advanced),
        uploads it. The one way to drop a row the host rejected after the
        device committed to it."""
        self._uploaded_gen.pop(name, None)
        self._recon_pending.add(name)

    def _track_images(self, name: str, ni) -> bool:
        """Maintain global image num-node counts (first-seen size wins,
        mirroring cache.addNodeImageStates). Returns True if they changed."""
        old = self._node_images.get(name, frozenset())
        new = frozenset(ni.image_states) if ni is not None else frozenset()
        if old == new:
            return False
        for img in new - old:
            self._image_counts[img] = self._image_counts.get(img, 0) + 1
            if img not in self._image_sizes and ni is not None:
                self._image_sizes[img] = ni.image_states[img]
        for img in old - new:
            c = self._image_counts.get(img, 0) - 1
            if c <= 0:
                self._image_counts.pop(img, None)
                self._image_sizes.pop(img, None)
                self.encoder.release_image(img)
            else:
                self._image_counts[img] = c
        if new:
            self._node_images[name] = new
        else:
            self._node_images.pop(name, None)
        return True

    def slot_to_name(self) -> Dict[int, str]:
        """LIVE reverse map (maintained by the encoder); callers read only."""
        return self.encoder.slot_names


def caps_for_cluster(n_nodes: int, batch: int = 128) -> Capacities:
    """Static capacities for a cluster size (the hostname value vocab must
    cover every node; the synthetic torus fallback needs a superpod per 16
    slots)."""
    nodes = round_node_capacity(n_nodes)
    value_words = max(32, (nodes + 2 + 31) // 32)
    superpods = max(16, (nodes + 15) // 16)
    return Capacities(nodes=nodes, pods=batch, value_words=value_words,
                      superpods=superpods)
