"""Model factory and the eval-mode prediction helpers.

Counterpart of the inference side of ``gcn_grabcut_tpu/models/factory.py``:
`build_model`, the M-member inference ensemble (the JAX package's
``stack_variables`` bundle, here a module holding its members),
`apply_model` and `predict_probs`, and the helpers that turn per-region
posteriors into trimaps and pixel planes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.graph import (CLASS_BG, CLASS_FG, N_EDGE_FEATS, N_NODE_FEATS,
                          TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_BG,
                          TRIMAP_PROB_FG, GraphBatch)
from .layers import dense_aggregators
from .resgcn import ResGCNNet


def build_model(variant: str = "resgcn", in_channels: int = N_NODE_FEATS,
                edge_channels: int = N_EDGE_FEATS,
                hidden_channels: int = 128, n_layers: int = 6,
                n_classes: int = 3,
                generator: torch.Generator | None = None) -> nn.Module:
    """variant: "resgcn"; the GCN and GAT variants raise."""
    if variant != "resgcn":
        raise NotImplementedError(
            f"variant {variant!r} comes with ROADMAP queue 1 item 6 (the "
            "GCN/GAT variants)")
    return ResGCNNet(in_channels=in_channels, edge_channels=edge_channels,
                     hidden_channels=hidden_channels, n_layers=n_layers,
                     n_classes=n_classes, generator=generator)


class ResGCNEnsemble(nn.Module):
    """M ResGCNNet members as one model.  Its forward returns the log of
    the members' mean class probability, log(mean_m softmax(logits_m) +
    1e-9), so a softmax of it reproduces that mean.  The members share one
    set of aggregators (the dense adjacencies, or the caller's SpMM plans
    on the large-graph path)."""

    supports_spmm_aggregators = True

    def __init__(self, members):
        super().__init__()
        self.members = nn.ModuleList(members)

    def forward(self, g: GraphBatch, aggregators=None) -> torch.Tensor:
        aggregators = aggregators or dense_aggregators(g)
        acc = None
        for member in self.members:
            p = torch.softmax(member(g, aggregators).float(), dim=-1)
            acc = p if acc is None else acc + p
        return torch.log(acc / len(self.members) + 1e-9)


@torch.no_grad()
def apply_model(model: nn.Module, graph: GraphBatch) -> torch.Tensor:
    """Eval forward: (G, N, n_classes) logits, or the ensemble's log mean
    probability."""
    return model(graph)


def predict_probs(model: nn.Module, graph: GraphBatch) -> torch.Tensor:
    """(G, N, n_classes) softmax class probabilities (eval mode)."""
    return torch.softmax(apply_model(model, graph).float(), dim=-1)


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))


def probs_to_node_trimap(probs, threshold_fg: float = 0.55,
                         threshold_bg: float = 0.55) -> torch.Tensor:
    """Per-region class probabilities (..., 3) -> 4-label OpenCV trimap
    labels (uint8): definite only at or above its threshold, else the more
    likely probable side."""
    probs = _tensor(probs)
    bg_p = probs[..., CLASS_BG]
    fg_p = probs[..., CLASS_FG]
    labels = torch.where(fg_p > bg_p, TRIMAP_PROB_FG, TRIMAP_PROB_BG)
    labels = torch.where(bg_p >= threshold_bg, TRIMAP_BG, labels)
    labels = torch.where(fg_p >= threshold_fg, TRIMAP_FG, labels)
    return labels.to(torch.uint8)


def project_to_pixels(node_values, segments) -> torch.Tensor:
    """Broadcast per-region values (K, ...) to pixels through the (H, W)
    label map: an exact gather."""
    return _tensor(node_values)[_tensor(segments).long()]


def project_planes(node_planes, segments) -> torch.Tensor:
    """(K, C) per-region planes -> (H, W, C) pixel planes.  The JAX
    package's one-hot matmul selects one row per pixel and so equals this
    gather bit for bit."""
    return project_to_pixels(node_planes, segments)


def probs_to_trimap(probs, segments, threshold_fg: float = 0.55,
                    threshold_bg: float = 0.55) -> np.ndarray:
    """Per-region probabilities (K, 3) -> pixel trimap (H, W) uint8."""
    node_labels = probs_to_node_trimap(probs, threshold_fg, threshold_bg)
    return project_to_pixels(node_labels, _tensor(segments).to(
        node_labels.device)).cpu().numpy()
