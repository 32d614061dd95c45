"""gcn_grabcut_torch — the PyTorch / CUDA port of gcn_grabcut_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference.  It runs `GCNGrabCutPipeline.segment_batch`: graph build with
the saliency or geodesic prior, the forward of ResGCNNet, GCNTrimapNet or
GATTrimapNet, one model or an ensemble read from the JAX package's
checkpoints (`load_model_auto`) -- dense up to 2048 superpixels, with
optional multi-scale inference; above, the banded SpMM (a hand-written
CUDA kernel on the card) or the banded GATv2 attention -- then
trimap, GrabCut and clean-up; `segment_stream` over a stream of images;
`segment`'s staged options and `segment_bbox` through the scalar API
(`build_graph`, `refine_trimap`, `seed_from_prior`, the `GrabCut` class
with the device or the native C++ min-cut, `clean_mask`); the metrics;
and the graph-sharded ResGCNNet forward and its gradient over a ring of
ranks (`make_graph_mesh`, `mesh_aggregators`), whose halo is the
hand-written ring all-gather and, backward, the ring reduce-scatter.
It trains and evaluates, on one device or data-parallel over the "data"
axis of a mesh (`make_mesh`, `Trainer(mesh=...)`, `init_distributed` for
a job of several processes): the data generators and graph preparation
(`make_hard_synthetic_dataset`, `prepare_dataset` with the JAX package's
graph cache), the losses, the `Trainer` with the optax chain of the JAX
package (AdamW or SGD-nesterov, SGDR / one-cycle / plateau), checkpoints
either package reads, and the CLIs ``python -m gcn_grabcut_torch.cli.
{train,prepare_graphs,evaluate,inference}``.  It serves: ``python -m
gcn_grabcut_torch.cli.serve`` answers HTTP requests through a
micro-batcher in front of `segment_batch`.  Around it: `FrameworkConfig`
(``config.py``), `profile_trace` on torch.profiler and `trace_span`,
which opens the program's own `layer.*` spans while a profiler records
(``utils.py``, with the span table), and the plots of ``visualise.py``.  The top level exports
every public name of the JAX package's.  Entry points run on the card
unless the caller passes device="cpu" (the CLIs: --cpu).
"""

from .core.graph import (CLASS_BG, CLASS_FG, CLASS_UNK, N_EDGE_FEATS,
                         N_IMAGE_FEATS, N_NODE_FEATS, N_PRIOR_FEATS,
                         TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_BG,
                         TRIMAP_PROB_FG, GraphBatch, Label, make_graph_batch,
                         pad_graph, single_graph, stack_graphs)
from .data.dataset import (augment_sample, derive_trimap_labels,
                           load_image_mask_dataset,
                           make_hard_synthetic_dataset,
                           make_photo_synthetic_dataset,
                           make_synthetic_dataset, prepare_dataset,
                           prepare_sample, split_dataset)
from .data.hints import encode_user_hints, sample_clicks
from .grabcut import GrabCut, GrabCutConfig, GrabCutSnapshot
from .graph_build import (GraphBuilder, RegionGraph, SuperpixelGraph,
                          SuperpixelGraphConfig, build_graph,
                          build_graph_batch_arrays)
from .metrics import (SegmentationMetrics, TrimapMetrics, boundary_f1,
                      evaluate, evaluate_batch, evaluate_trimap)
from .models.convert import model_from_jax, resgcn_from_jax
from .models.factory import (ModelEnsemble, ResGCNEnsemble, apply_model,
                             build_model, init_model, init_model_numpy,
                             is_ensemble, predict_probs,
                             probs_to_node_trimap, probs_to_trimap,
                             project_to_pixels, stack_variables)
from .models.gat import GATTrimapNet
from .models.gcn import GCNTrimapNet
from .models.large import apply_large
from .models.resgcn import ResGCNNet
from .ops.connected import clean_mask
from .ops.image import guided_filter
from .ops.prior import compute_auto_prior
from .parallel.mesh import (GraphMesh, Mesh, init_distributed,
                            make_graph_mesh, make_mesh, shard_graph_batch)
from .parallel.partition import mesh_aggregators, sharded_scatter_add
from .parallel.ring import ring_all_gather, ring_reduce_scatter
from .pipeline import (GCNGrabCutPipeline, SegmentationResult, colour_trimap,
                       refine_trimap, seed_from_prior)
from .train.checkpoints import (load_ensemble_from_checkpoints,
                                load_model_auto, load_model_from_checkpoint)
from .train.losses import (FocalLoss, LabelSmoothingCE, TrimapLoss,
                           focal_loss, label_smoothing_ce, trimap_loss)
from .train.trainer import TrainConfig, Trainer
from .visualise import (plot_confusion_matrix, plot_superpixel_graph,
                        plot_training_curves, plot_trimap_comparison,
                        save_research_report)

__all__ = [
    "CLASS_BG", "CLASS_FG", "CLASS_UNK", "Label", "N_EDGE_FEATS",
    "N_IMAGE_FEATS", "N_NODE_FEATS", "N_PRIOR_FEATS", "TRIMAP_BG",
    "TRIMAP_FG", "TRIMAP_PROB_BG", "TRIMAP_PROB_FG", "is_ensemble",
    "plot_confusion_matrix", "plot_superpixel_graph", "plot_training_curves",
    "plot_trimap_comparison", "save_research_report", "single_graph",
    "stack_variables", "visualise",
    "FocalLoss", "GATTrimapNet", "GCNGrabCutPipeline", "GCNTrimapNet",
    "GrabCut", "GrabCutConfig",
    "GrabCutSnapshot", "GraphBatch", "GraphBuilder", "GraphMesh", "Mesh",
    "LabelSmoothingCE", "RegionGraph", "ResGCNEnsemble", "ResGCNNet",
    "SegmentationMetrics", "SegmentationResult", "SuperpixelGraph",
    "SuperpixelGraphConfig", "TrainConfig", "Trainer", "TrimapLoss",
    "TrimapMetrics", "apply_large", "apply_model", "augment_sample",
    "boundary_f1", "build_graph", "build_graph_batch_arrays", "build_model",
    "clean_mask", "colour_trimap", "compute_auto_prior",
    "derive_trimap_labels", "encode_user_hints", "evaluate",
    "evaluate_batch", "evaluate_trimap", "focal_loss", "guided_filter",
    "init_distributed", "init_model", "init_model_numpy", "label_smoothing_ce", "load_ensemble_from_checkpoints",
    "load_image_mask_dataset", "load_model_auto",
    "load_model_from_checkpoint", "make_graph_batch", "make_graph_mesh",
    "make_mesh",
    "make_hard_synthetic_dataset", "make_photo_synthetic_dataset",
    "make_synthetic_dataset", "mesh_aggregators", "model_from_jax",
    "ModelEnsemble", "pad_graph",
    "predict_probs", "prepare_dataset", "prepare_sample",
    "probs_to_node_trimap", "probs_to_trimap", "project_to_pixels",
    "refine_trimap", "resgcn_from_jax", "ring_all_gather",
    "ring_reduce_scatter", "sample_clicks", "seed_from_prior",
    "shard_graph_batch", "sharded_scatter_add", "split_dataset", "stack_graphs", "trimap_loss",
]
