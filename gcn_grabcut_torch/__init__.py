"""gcn_grabcut_torch — the PyTorch / CUDA port of gcn_grabcut_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference.  It runs the large-graph configuration of
`GCNGrabCutPipeline.segment_batch` (K > 2048 superpixels): graph build,
banded-SpMM ResGCNNet forward (hand-written CUDA kernel on the card),
trimap, GrabCut and clean-up; and the graph-sharded ResGCNNet forward and
its gradient over a ring of ranks (`make_graph_mesh`, `mesh_aggregators`),
whose halo is the hand-written ring all-gather and, backward, the ring
reduce-scatter.  Entry points run on the card unless the caller passes
device="cpu".
"""

from .core.graph import GraphBatch, make_graph_batch
from .grabcut import GrabCutConfig
from .graph_build import SuperpixelGraphConfig, build_graph_batch_arrays
from .models.convert import resgcn_from_jax
from .models.large import apply_large
from .models.resgcn import ResGCNNet
from .parallel.mesh import GraphMesh, make_graph_mesh
from .parallel.partition import mesh_aggregators, sharded_scatter_add
from .parallel.ring import ring_all_gather, ring_reduce_scatter
from .pipeline import GCNGrabCutPipeline, SegmentationResult

__all__ = [
    "GCNGrabCutPipeline", "GrabCutConfig", "GraphBatch", "GraphMesh",
    "ResGCNNet", "SegmentationResult", "SuperpixelGraphConfig",
    "apply_large", "build_graph_batch_arrays", "make_graph_batch",
    "make_graph_mesh", "mesh_aggregators", "resgcn_from_jax",
    "ring_all_gather", "ring_reduce_scatter", "sharded_scatter_add",
]
