"""Node-axis sharding over a ``torch.distributed`` process group.

Counterpart of ``kubernetes_tpu/parallel/mesh.py``. The JAX package shards
the node axis of the device mirror over a ``jax.sharding.Mesh`` and runs
``schedule_batch_core`` under ``shard_map``; here each rank of a process
group holds one contiguous window of the node axis and runs
``schedule_batch_core(..., mesh=...)`` on it, and the collectives of
``ops/topology.py`` (``_gsum``, ``_gmax``, ``_gmin`` on
``torch.distributed.all_reduce``) stand where the JAX program has
``psum``, ``pmax`` and ``pmin``. The pods, expressions and topology
programs are replicated; the winners come back as global slot ids on every
rank. Per scan step the ranks exchange each rank's best row (its score,
global slot and what the winner carries; ``topology._gfirst_max``) and each
normalization's per-pod maximum, not any [P, N] matrix; the topology modes
add their per-domain tables ([C, Vd]) and per-pod counts.

There is no global state: a ``NodeMesh`` carries the rank, the world size,
the group, the device and the collective counters. ``parallel/launch.py``
starts one process per rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..backend.batch import DEFAULT_WEIGHTS, BatchResult, schedule_batch_core
from ..ops.schema import ExprTable, NodeTensors, PodBatch, TopoBatch, TopoCounts
from ..utils.device import DeviceLike, check_on, resolve_device

# NodeTensors fields that are vocabulary-level, not per node: replicated
# (``_REPLICATED_NT_FIELDS``, ``kubernetes_tpu/parallel/mesh.py:28``)
REPLICATED_NT_FIELDS = ("image_sizes", "image_num_nodes", "class_prio")

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

@dataclasses.dataclass
class NodeMesh:
    """One rank's view of the node mesh: its rank in the group, the world
    size, the group (None = the default group), the device its tensors live
    on and the backend's name. ``collectives`` and ``collective_bytes``
    count the all-reduces and all-gathers the sharded program issued and
    the bytes each rank sent; ``reset_counters`` zeroes them."""

    rank: int
    world: int
    group: Optional[object]
    device: torch.device
    backend: str
    collectives: int = 0
    collective_bytes: int = 0

    def reset_counters(self) -> None:
        self.collectives = self.collective_bytes = 0

    def _count(self, buf: torch.Tensor) -> None:
        self.collectives += 1
        self.collective_bytes += buf.numel() * buf.element_size()

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced elementwise over every rank (``op``: sum, max or
        min); a new tensor of ``x``'s shape and dtype. A 0-d tensor travels
        as one element."""
        buf = x.reshape(1) if x.dim() == 0 else x.contiguous()
        buf = buf.clone()
        self._count(buf)
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        return buf.reshape(x.shape)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (a
        bool or int8 travels as int32)."""
        dtype = x.dtype
        buf = x.to(torch.int32) if dtype in (torch.bool, torch.int8) else x.contiguous()
        self._count(buf)
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim=dim).to(dtype)


def make_node_mesh(device: DeviceLike = None, group=None) -> NodeMesh:
    """The mesh of an initialised ``torch.distributed`` group (None: the
    default group) on ``device`` (None: the CUDA card, which raises without
    one)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start the ranks with "
                           "parallel.launch.run_ranks or init_process_group")
    return NodeMesh(rank=dist.get_rank(group), world=dist.get_world_size(group), group=group,
                    device=resolve_device(device), backend=str(dist.get_backend(group)))


def _window(n: int, mesh: NodeMesh) -> slice:
    if n % mesh.world:
        raise ValueError(f"the node axis ({n}) is not divisible by the world size "
                         f"({mesh.world})")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_node_tensors(nt: NodeTensors, mesh: NodeMesh) -> NodeTensors:
    """This rank's window ``[rank*N/W, (rank+1)*N/W)`` of a (global)
    NodeTensors on the mesh's device: every per-node field cut on its first
    axis, the vocabulary fields replicated. Raises when N is not divisible
    by the world size."""
    win = _window(nt.capacity, mesh)
    out = {}
    for f in dataclasses.fields(NodeTensors):
        t = getattr(nt, f.name)
        if f.name not in REPLICATED_NT_FIELDS:
            t = t[win]
        out[f.name] = t.to(mesh.device).contiguous()
    return NodeTensors(**out)


def shard_topo_counts(tc: TopoCounts, mesh: NodeMesh) -> TopoCounts:
    """This rank's share of a TopoCounts: the count tables cut on their
    node (second) axis, the term keys replicated."""
    win = _window(tc.sel_counts.shape[1], mesh)
    return TopoCounts(sel_counts=tc.sel_counts[:, win].to(mesh.device).contiguous(),
                      term_counts=tc.term_counts[:, win].to(mesh.device).contiguous(),
                      term_key=tc.term_key.to(mesh.device))


def make_sharded_schedule_fn(mesh: NodeMesh, weights: Optional[Dict[str, float]] = None,
                             topo_enabled: bool = True, spec_decode: bool = False,
                             topo_mode: Optional[str] = None, host_key: int = 0,
                             vd_override: Optional[int] = None):
    """The batch program over the mesh (the JAX signature less the jit):
    ``fn(pb, et, nt_local, tc_local, tb)`` runs this rank's share, with the
    pods, expressions and topology programs replicated and ``nt_local`` /
    ``tc_local`` from ``shard_node_tensors`` / ``shard_topo_counts``, all
    on the mesh's device. Every rank of the group must call it with the
    same batch.

    ``topo_mode`` None derives from ``topo_enabled`` (``general`` or
    ``off``). ``spec_decode`` runs the speculative rounds in place of the
    scan, in every mode. The result is laid out as the JAX ``out_specs``
    (``:117-134``): ``node_idx`` (global slots), ``best_score``,
    ``any_feasible`` and, in mode ``general``, ``final_seg_exist`` are
    replicated; the static masks, ``fit_ok``, ``ports_ok``, ``spread_ok``,
    ``ipa_ok``, ``first_fail``, the ``final_*`` node carries and, in mode
    ``host``, ``final_seg_exist`` are this rank's window. There is no
    packed block."""
    if topo_mode is None:
        topo_mode = "general" if topo_enabled else "off"
    w = {**DEFAULT_WEIGHTS, **(weights or {})}

    def fn(pb: PodBatch, et: ExprTable, nt_local: NodeTensors, tc_local: TopoCounts,
           tb: TopoBatch) -> BatchResult:
        check_on(mesh.device, valid=nt_local.valid, pod_valid=pb.valid, expr_op=et.op,
                 sel_counts=tc_local.sel_counts, tb_sf_valid=tb.sf_valid)
        return schedule_batch_core(pb, et, nt_local, w, tc_local, tb, topo_mode, vd_override,
                                   host_key, spec_decode, mesh=mesh)

    fn.topo_mode = topo_mode
    return fn


# BatchResult fields cut on the node axis, by the axis they are cut on
_SHARDED_FIELDS = (("fit_ok", 1), ("ports_ok", 1), ("spread_ok", 1), ("ipa_ok", 1),
                   ("first_fail", 1), ("final_requested", 0), ("final_nonzero", 0),
                   ("final_ports", 0), ("final_class_req", 0), ("final_sel_counts", 1))


def gather_result(res: BatchResult, mesh: NodeMesh, topo_mode: str = "off") -> BatchResult:
    """The global BatchResult from every rank's share: each node-axis field
    of ``make_sharded_schedule_fn``'s layout concatenated in rank order
    (``final_seg_exist`` too in mode ``host``). Every rank must call it; for
    the tests and ``chip_smoke.py``, not the program."""
    out = dataclasses.replace(res, static_masks={
        k: mesh.all_gather(v, 1) for k, v in res.static_masks.items()})
    for name, dim in _SHARDED_FIELDS + ((("final_seg_exist", 1),) if topo_mode == "host"
                                        else ()):
        t = getattr(res, name)
        if t is not None:
            setattr(out, name, mesh.all_gather(t, dim))
    return out
