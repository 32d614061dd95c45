"""Model factory and the eval-mode prediction helpers.

Counterpart of the inference side of ``gcn_grabcut_tpu/models/factory.py``:
`build_model` (ResGCNNet, GCNTrimapNet, GATTrimapNet), `init_model`, the
M-member inference ensemble (the JAX package's ``stack_variables`` bundle,
here a module holding its members),
`apply_model` and `predict_probs`, and the helpers that turn per-region
posteriors into trimaps and pixel planes.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..core.graph import (CLASS_BG, CLASS_FG, N_EDGE_FEATS, N_NODE_FEATS,
                          TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_BG,
                          TRIMAP_PROB_FG, GraphBatch)
from .gat import GATTrimapNet
from .gcn import GCNTrimapNet
from .layers import GCNConv, InputNorm, dense_aggregators, reset_parameters
from .resgcn import ResGCNNet


def build_model(variant: str = "resgcn", in_channels: int = N_NODE_FEATS,
                edge_channels: int = N_EDGE_FEATS,
                hidden_channels: int = 128, n_layers: int = 6,
                n_classes: int = 3, dropout: float = 0.2,
                dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> nn.Module:
    """variant: "resgcn" | "gcn" | "gat" (8 heads).  `dtype` is the compute
    dtype (None: float32); `generator` seeds the initialisation."""
    kw = dict(in_channels=in_channels, edge_channels=edge_channels,
              hidden_channels=hidden_channels, n_layers=n_layers,
              n_classes=n_classes, dropout=dropout, dtype=dtype,
              generator=generator)
    if variant == "resgcn":
        return ResGCNNet(**kw)
    if variant == "gat":
        return GATTrimapNet(**kw, n_heads=8)
    if variant == "gcn":
        return GCNTrimapNet(**kw)
    raise ValueError(f"Unknown variant '{variant}'. Choose: resgcn|gcn|gat")


def init_model(model: nn.Module, seed=0) -> nn.Module:
    """(Re)initialise `model` in place from a seed or a CPU
    torch.Generator: the JAX package's initialisers (Kaiming-normal Dense
    kernels, zero biases, unit scales, zero JK logits) and fresh running
    statistics, drawn on the CPU wherever the model lives.  Returns it."""
    generator = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    fresh = copy.deepcopy(model).cpu()
    reset_parameters(fresh, generator)
    with torch.no_grad():
        for m in fresh.modules():
            if isinstance(m, InputNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, GCNConv):
                m.bias.zero_()
        if isinstance(getattr(fresh, "jk_logits", None), nn.Parameter):
            fresh.jk_logits.zero_()
    model.load_state_dict(fresh.state_dict())
    return model


@torch.no_grad()
def init_model_numpy(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and running statistic of `model` in place from
    ``np.random.RandomState(seed)``, in state_dict order: 2-D weights
    normal with std sqrt(2 / fan_in) (Kaiming, as the JAX package's
    initialisers; the fan-in is the last axis of a port weight), norm scales
    1 + normal(0.1), other vectors normal(0.1), running means normal(0.1),
    running variances uniform in [0.5, 1.5).  numpy draws the same on
    every machine, so the weights can reach the JAX package (through
    ``models/convert.py``) and the card bit for bit.  Returns `model`."""
    r = np.random.RandomState(seed)
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            a = r.uniform(0.5, 1.5, shape)
        elif len(shape) == 2:
            a = r.standard_normal(shape) * np.sqrt(2.0 / shape[-1])
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * r.standard_normal(shape)
        else:
            a = 0.1 * r.standard_normal(shape)
        t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


class ModelEnsemble(nn.Module):
    """M members of one variant as one model.  Its forward returns the log
    of the members' mean class probability, log(mean_m softmax(logits_m)
    + 1e-9), so a softmax of it reproduces that mean.  The members share
    one set of aggregators (the dense adjacencies, or the caller's SpMM
    plans on the large-graph path) or one GatPlan; it takes the large
    path its members take."""

    def __init__(self, members):
        super().__init__()
        self.members = nn.ModuleList(members)
        for flag in ("supports_spmm_aggregators",
                     "supports_banded_attention"):
            setattr(self, flag, all(getattr(m, flag, False)
                                    for m in members))

    def forward(self, g: GraphBatch, aggregators=None, gat_plan=None,
                gat_precision: str = "default") -> torch.Tensor:
        if self.supports_banded_attention:
            kw = dict(gat_plan=gat_plan, gat_precision=gat_precision)
        else:
            kw = dict(aggregators=aggregators or dense_aggregators(g))
        acc = None
        for member in self.members:
            p = torch.softmax(member(g, **kw).float(), dim=-1)
            acc = p if acc is None else acc + p
        return torch.log(acc / len(self.members) + 1e-9)


#: The ensemble's earlier name, from when every member was a ResGCNNet.
ResGCNEnsemble = ModelEnsemble


def stack_variables(models) -> ModelEnsemble:
    """M compatible models as one inference ensemble: the port's
    counterpart of the JAX package's ``stack_variables``, which stacks M
    variable trees for its vmapped forward."""
    return ModelEnsemble(list(models))


def is_ensemble(model) -> bool:
    return isinstance(model, ModelEnsemble)


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
