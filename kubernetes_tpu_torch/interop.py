"""Carrying one encoded state into the port.

Each function takes a dict of numpy arrays — what a caller gets from the
JAX package's dataclass with ``np.asarray`` on each field — and returns the
port's dataclass on ``device``. uint32 fields keep their bits in int32
(ops/schema.py). This is the bridge that lets the tests feed one
host-encoded state to both packages.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .backend.batch import DEFAULT_WEIGHTS, weight_vector
from .ops.schema import ExprTable, NodeTensors, PodBatch, TopoBatch, TopoCounts
from .utils.device import DeviceLike, resolve_device


def node_tensors_from_numpy(d: dict, device: DeviceLike = None) -> NodeTensors:
    return NodeTensors.from_numpy(d, resolve_device(device))


def pod_batch_from_numpy(d: dict, device: DeviceLike = None) -> PodBatch:
    return PodBatch.from_numpy(d, resolve_device(device))


def expr_table_from_numpy(d: dict, device: DeviceLike = None) -> ExprTable:
    return ExprTable.from_numpy(d, resolve_device(device))


def topo_counts_from_numpy(d: dict, device: DeviceLike = None) -> TopoCounts:
    return TopoCounts.from_numpy(d, resolve_device(device))


def topo_batch_from_numpy(d: dict, device: DeviceLike = None) -> TopoBatch:
    return TopoBatch.from_numpy(d, resolve_device(device))


def weights_from_dict(d: Dict[str, float]) -> Tuple[float, ...]:
    """Plugin weights by name (missing names take the defaults) -> the five
    commit-step weights in kernel order, as float32 values."""
    return weight_vector({**DEFAULT_WEIGHTS, **d})
