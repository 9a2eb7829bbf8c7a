"""Node-axis sharding of the batch program (``kubernetes_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    NodeMesh,
    gather_result,
    make_node_mesh,
    make_sharded_schedule_fn,
    shard_node_tensors,
    shard_topo_counts,
)
