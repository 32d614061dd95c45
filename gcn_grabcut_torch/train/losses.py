"""Training objectives over dense (G, N, ...) batches with a node mask.

Counterpart of ``gcn_grabcut_tpu/train/losses.py``: the same formulas in
the same order, float32 whatever the logits' dtype.  Padded nodes
contribute exactly zero; the per-graph soft Dice is a masked reduction
over axis 1.

Every loss divides by sums over its whole batch (`batch_totals`).  Given
``totals=`` (those sums over a larger batch) a loss of one shard of that
batch is the shard's share of the whole batch's loss, so the shards'
losses and gradients add up to the whole batch's: the data-parallel
trainer's objective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.graph import CLASS_FG, CLASS_UNK


def _weights(weight, like: torch.Tensor) -> Optional[torch.Tensor]:
    if weight is None:
        return None
    return torch.as_tensor(weight, dtype=torch.float32, device=like.device)


def _weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                 weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-node cross-entropy with optional class weights, fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    ce = -logp.gather(-1, labels[..., None])[..., 0]
    weight = _weights(weight, ce)
    if weight is not None:
        ce = ce * weight[labels]
    return ce


def batch_totals(node_mask, area=None, graph_weight=None) -> torch.Tensor:
    """(3,) float32: the sums a loss takes over its whole batch -- the
    valid-node count and the valid nodes' area, both weighted by
    `graph_weight`, and the graph weights' sum (the graph count without
    them).  Sums over the shards of a batch give the batch's."""
    mask = node_mask
    if graph_weight is not None:
        mask = mask * graph_weight[:, None]
    area_sum = (mask.new_zeros(()) if area is None
                else (area * mask).sum())
    graphs = (graph_weight.sum() if graph_weight is not None
              else mask.new_tensor(float(mask.shape[0])))
    return torch.stack([mask.sum(), area_sum, graphs]).float()


def _n_valid(mask: torch.Tensor, totals=None) -> torch.Tensor:
    return (mask.sum() if totals is None else totals[0]).clamp_min(1.0)


def focal_loss(logits, labels, node_mask, gamma: float = 2.0,
               weight=None, totals=None) -> torch.Tensor:
    """FL = (1 - p_t)^gamma * CE, mean over valid nodes."""
    ce = _weighted_ce(logits, labels, weight)
    p_t = torch.exp(-ce)
    per_node = ((1 - p_t) ** gamma) * ce
    return (per_node * node_mask).sum() / _n_valid(node_mask, totals)


def label_smoothing_ce(logits, labels, node_mask, smoothing: float = 0.1,
                       weight=None, totals=None) -> torch.Tensor:
    """Cross-entropy against 1 - smoothing on the label and smoothing /
    (C - 1) elsewhere."""
    n_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    onehot = F.one_hot(labels, n_classes) > 0
    smooth = torch.where(onehot, torch.full_like(logp, 1.0 - smoothing),
                         torch.full_like(logp, smoothing / (n_classes - 1)))
    loss = -(smooth * logp).sum(dim=-1)
    weight = _weights(weight, loss)
    if weight is not None:
        loss = loss * weight[labels]
    return (loss * node_mask).sum() / _n_valid(node_mask, totals)


def trimap_loss(logits, labels, node_mask,
                area: Optional[torch.Tensor] = None,
                fg_ratio: Optional[torch.Tensor] = None,
                gamma: float = 2.0, weight=None, dice_weight: float = 0.5,
                area_weighted: bool = True,
                graph_weight: Optional[torch.Tensor] = None,
                eps: float = 1e-6,
                totals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area-weighted focal CE + per-graph soft Dice.

    Classification term: focal CE with the focal factor computed from the
    *detached* CE clamped at 30, weighted by region area normalised to
    unit mean over valid nodes.  Overlap term: soft Dice on the expected
    foreground coverage p = P(FG) + 0.5 P(UNK) against `fg_ratio` (or the
    hard labels), accumulated with area weights per graph, then averaged
    over graphs.  `graph_weight` (G,) weights whole graphs (0 for the
    duplicates that fill the last partial batch).  `totals`: see
    `batch_totals`."""
    mask = node_mask
    if graph_weight is not None:
        mask = mask * graph_weight[:, None]
    n_valid = _n_valid(mask, totals)

    ce = _weighted_ce(logits, labels, weight)
    if gamma > 0:
        p_t = torch.exp(-ce.detach().clamp(max=30.0))
        per_node = ((1 - p_t) ** gamma) * ce
    else:
        per_node = ce

    if area is not None and area_weighted:
        w = area * mask
        w_sum = w.sum() if totals is None else totals[1]
        w = w * (n_valid / w_sum.clamp_min(eps))
        cls_loss = (per_node * w).sum() / n_valid
    else:
        cls_loss = (per_node * mask).sum() / n_valid

    if dice_weight <= 0:
        return cls_loss

    probs = torch.softmax(logits.float(), dim=-1)
    pred = probs[..., CLASS_FG] + 0.5 * probs[..., CLASS_UNK]
    if fg_ratio is not None:
        target = fg_ratio.to(pred.dtype)
    else:
        target = ((labels == CLASS_FG).to(pred.dtype)
                  + 0.5 * (labels == CLASS_UNK).to(pred.dtype))

    a = mask if area is None else area * mask
    inter = (a * pred * target).sum(dim=1)
    sum_p = (a * pred).sum(dim=1)
    sum_t = (a * target).sum(dim=1)
    per_graph = 1.0 - (2.0 * inter + eps) / (sum_p + sum_t + eps)
    if totals is not None:
        if graph_weight is not None:
            per_graph = per_graph * graph_weight
        dice = per_graph.sum() / totals[2].clamp_min(1.0)
    elif graph_weight is not None:
        dice = ((per_graph * graph_weight).sum()
                / graph_weight.sum().clamp_min(1.0))
    else:
        dice = per_graph.mean()
    return cls_loss + dice_weight * dice


def make_loss_fn(loss_fn: str = "trimap", gamma: float = 2.0,
                 dice_weight: float = 0.5, label_smoothing: float = 0.1,
                 class_weights=None):
    """The trainer's criterion: f(logits, labels, node_mask, area=None,
    fg_ratio=None, graph_weight=None, totals=None) -> scalar."""
    w = None if class_weights is None else torch.as_tensor(
        class_weights, dtype=torch.float32)

    def graph_masked(node_mask, graph_weight):
        if graph_weight is None:
            return node_mask
        return node_mask * graph_weight[:, None]

    if loss_fn == "trimap":
        def f(logits, labels, node_mask, area=None, fg_ratio=None,
              graph_weight=None, totals=None):
            return trimap_loss(logits, labels, node_mask, area=area,
                               fg_ratio=fg_ratio, gamma=gamma, weight=w,
                               dice_weight=dice_weight,
                               graph_weight=graph_weight, totals=totals)
    elif loss_fn == "focal":
        def f(logits, labels, node_mask, area=None, fg_ratio=None,
              graph_weight=None, totals=None):
            return focal_loss(logits, labels,
                              graph_masked(node_mask, graph_weight),
                              gamma=gamma, weight=w, totals=totals)
    elif loss_fn == "smooth_ce":
        def f(logits, labels, node_mask, area=None, fg_ratio=None,
              graph_weight=None, totals=None):
            return label_smoothing_ce(logits, labels,
                                      graph_masked(node_mask, graph_weight),
                                      smoothing=label_smoothing, weight=w,
                                      totals=totals)
    else:  # plain CE
        def f(logits, labels, node_mask, area=None, fg_ratio=None,
              graph_weight=None, totals=None):
            node_mask = graph_masked(node_mask, graph_weight)
            ce = _weighted_ce(logits, labels, w)
            return (ce * node_mask).sum() / _n_valid(node_mask, totals)
    return f


class FocalLoss:
    """Callable form of :func:`focal_loss`."""

    def __init__(self, gamma: float = 2.0, weight=None):
        self.gamma = gamma
        self.weight = None if weight is None else torch.as_tensor(
            weight, dtype=torch.float32)

    def __call__(self, logits, labels, node_mask):
        return focal_loss(logits, labels, node_mask, gamma=self.gamma,
                          weight=self.weight)


class LabelSmoothingCE:
    """Callable form of :func:`label_smoothing_ce`."""

    def __init__(self, smoothing: float = 0.1, weight=None):
        self.smoothing = smoothing
        self.weight = None if weight is None else torch.as_tensor(
            weight, dtype=torch.float32)

    def __call__(self, logits, labels, node_mask):
        return label_smoothing_ce(logits, labels, node_mask,
                                  smoothing=self.smoothing,
                                  weight=self.weight)


class TrimapLoss:
    """Callable form of :func:`trimap_loss`."""

    def __init__(self, gamma: float = 2.0, dice_weight: float = 0.5,
                 weight=None, area_weighted: bool = True):
        self.gamma = gamma
        self.dice_weight = dice_weight
        self.area_weighted = area_weighted
        self.weight = None if weight is None else torch.as_tensor(
            weight, dtype=torch.float32)

    def __call__(self, logits, labels, node_mask, area=None, fg_ratio=None,
                 graph_weight=None):
        return trimap_loss(logits, labels, node_mask, area=area,
                           fg_ratio=fg_ratio, gamma=self.gamma,
                           weight=self.weight, dice_weight=self.dice_weight,
                           area_weighted=self.area_weighted,
                           graph_weight=graph_weight)
