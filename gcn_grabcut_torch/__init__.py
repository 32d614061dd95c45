"""gcn_grabcut_torch — the PyTorch / CUDA port of gcn_grabcut_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference.  It runs `GCNGrabCutPipeline.segment_batch`: graph build with
the saliency or geodesic prior, the ResGCNNet forward of one model or of
an ensemble read from the JAX package's checkpoints (`load_model_auto`)
-- dense up to 2048 superpixels, with optional multi-scale inference,
the banded SpMM (a hand-written CUDA kernel on the card) above -- then
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
from .models.factory import (ResGCNEnsemble, apply_model, build_model,
                             predict_probs)
from .models.large import apply_large
from .models.resgcn import ResGCNNet
from .parallel.mesh import GraphMesh, make_graph_mesh
from .parallel.partition import mesh_aggregators, sharded_scatter_add
from .parallel.ring import ring_all_gather, ring_reduce_scatter
from .pipeline import GCNGrabCutPipeline, SegmentationResult
from .train.checkpoints import load_model_auto

__all__ = [
    "GCNGrabCutPipeline", "GrabCutConfig", "GraphBatch", "GraphMesh",
    "ResGCNEnsemble", "ResGCNNet", "SegmentationResult",
    "SuperpixelGraphConfig", "apply_large", "apply_model",
    "build_graph_batch_arrays", "build_model", "load_model_auto",
    "make_graph_batch", "make_graph_mesh", "mesh_aggregators",
    "predict_probs", "resgcn_from_jax", "ring_all_gather",
    "ring_reduce_scatter", "sharded_scatter_add",
]
