"""ImageLocality's PreScore and Score as plain functions.

An own copy of ``kubernetes_tpu/framework/plugins/imagelocality.py``
(imagelocality/image_locality.go): the raw score of a node is the sum,
over the pod's container images present there, of ``size *
nodesWithImage // totalNodes``, clamped to [23 MB, 1000 MB per container]
and scaled to [0, 100]. PreScore counts each image's nodes and keeps one
size per image (the first node's) over the snapshot's nodes. The batched
path computes the same score on the device (``ops/scores.py``); the
sequential path (``framework/runtime.py:ScoreRunner``) runs them
through the plugin object, which reads the snapshot's nodes from its
``snapshot_fn``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Optional

from ...api.types import Pod
from ..types import MAX_NODE_SCORE, NodeInfo
from . import names

MB = 1024 * 1024
MIN_THRESHOLD = 23 * MB
MAX_CONTAINER_THRESHOLD = 1000 * MB


def normalized_image_name(name: str) -> str:
    """parsers.NormalizeImageRef, short: ``:latest`` when the name has no
    tag or digest."""
    if "@" in name:
        return name
    if ":" not in name.rsplit("/", 1)[-1]:
        return name + ":latest"
    return name


class SpreadState(NamedTuple):
    num_nodes_with_image: Dict[str, int]
    sizes: Dict[str, int]  # one size per image, the first node's
    total_nodes: int


def pre_score(node_infos: Iterable[NodeInfo]) -> SpreadState:
    spread: Dict[str, int] = {}
    sizes: Dict[str, int] = {}
    n = 0
    for ni in node_infos:
        n += 1
        for img, size in ni.image_states.items():
            spread[img] = spread.get(img, 0) + 1
            sizes.setdefault(img, size)
    return SpreadState(spread, sizes, max(1, n))


def score_node(s: SpreadState, pod: Pod, ni: NodeInfo) -> int:
    total = 0
    for c in pod.spec.containers:
        img = normalized_image_name(c.image)
        if img not in ni.image_states and c.image not in ni.image_states:
            continue
        size = s.sizes.get(img, s.sizes.get(c.image, 0))
        count = s.num_nodes_with_image.get(img, s.num_nodes_with_image.get(c.image, 0))
        total += size * count // s.total_nodes
    max_threshold = MAX_CONTAINER_THRESHOLD * len(pod.spec.containers)
    total = min(max(total, MIN_THRESHOLD), max_threshold)
    return MAX_NODE_SCORE * (total - MIN_THRESHOLD) // (max_threshold - MIN_THRESHOLD)


class ImageLocality:
    def __init__(self, snapshot_fn: Optional[Callable[[], Iterable[NodeInfo]]] = None):
        self.snapshot_fn = snapshot_fn or (lambda: ())

    def name(self) -> str:
        return names.IMAGE_LOCALITY

    def pre_score(self, state, pod: Pod, feasible) -> None:
        state.data[names.IMAGE_LOCALITY] = pre_score(self.snapshot_fn())

    def score_node(self, state, pod: Pod, ni: NodeInfo) -> int:
        return score_node(state.data[names.IMAGE_LOCALITY], pod, ni)
