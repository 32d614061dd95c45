"""gcn_grabcut_torch — the PyTorch / CUDA port of gcn_grabcut_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference.  It runs `GCNGrabCutPipeline.segment_batch`: graph build with
the saliency or geodesic prior, the ResGCNNet forward of one model or of
an ensemble read from the JAX package's checkpoints (`load_model_auto`)
-- dense up to 2048 superpixels, with optional multi-scale inference,
the banded SpMM (a hand-written CUDA kernel on the card) above -- then
trimap, GrabCut and clean-up; `segment_stream` over a stream of images;
`segment`'s staged options and `segment_bbox` through the scalar API
(`build_graph`, `refine_trimap`, `seed_from_prior`, the `GrabCut` class
with the device or the native C++ min-cut, `clean_mask`); the metrics;
and the graph-sharded ResGCNNet forward and its gradient over a ring of
ranks (`make_graph_mesh`, `mesh_aggregators`), whose halo is the
hand-written ring all-gather and, backward, the ring reduce-scatter.
Entry points run on the card unless the caller passes device="cpu".
"""

from .core.graph import GraphBatch, make_graph_batch
from .grabcut import GrabCut, GrabCutConfig, GrabCutSnapshot
from .graph_build import (GraphBuilder, RegionGraph, SuperpixelGraph,
                          SuperpixelGraphConfig, build_graph,
                          build_graph_batch_arrays)
from .metrics import (SegmentationMetrics, TrimapMetrics, boundary_f1,
                      evaluate, evaluate_batch, evaluate_trimap)
from .models.convert import resgcn_from_jax
from .models.factory import (ResGCNEnsemble, apply_model, build_model,
                             predict_probs, probs_to_node_trimap,
                             probs_to_trimap, project_to_pixels)
from .models.large import apply_large
from .models.resgcn import ResGCNNet
from .ops.connected import clean_mask
from .ops.image import guided_filter
from .ops.prior import compute_auto_prior
from .parallel.mesh import GraphMesh, make_graph_mesh
from .parallel.partition import mesh_aggregators, sharded_scatter_add
from .parallel.ring import ring_all_gather, ring_reduce_scatter
from .pipeline import (GCNGrabCutPipeline, SegmentationResult, colour_trimap,
                       refine_trimap, seed_from_prior)
from .train.checkpoints import load_model_auto

__all__ = [
    "GCNGrabCutPipeline", "GrabCut", "GrabCutConfig", "GrabCutSnapshot",
    "GraphBatch", "GraphBuilder", "GraphMesh", "RegionGraph",
    "ResGCNEnsemble", "ResGCNNet", "SegmentationMetrics",
    "SegmentationResult", "SuperpixelGraph", "SuperpixelGraphConfig",
    "TrimapMetrics", "apply_large", "apply_model", "boundary_f1",
    "build_graph", "build_graph_batch_arrays", "build_model", "clean_mask",
    "colour_trimap", "compute_auto_prior", "evaluate", "evaluate_batch",
    "evaluate_trimap", "guided_filter", "load_model_auto",
    "make_graph_batch", "make_graph_mesh", "mesh_aggregators",
    "predict_probs", "probs_to_node_trimap", "probs_to_trimap",
    "project_to_pixels", "refine_trimap", "resgcn_from_jax",
    "ring_all_gather", "ring_reduce_scatter", "seed_from_prior",
    "sharded_scatter_add",
]
