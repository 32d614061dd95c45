"""The model and the eval forward.

Counterpart of the inference side of ``gcn_grabcut_tpu/models/factory.py``:
`build_model` (ResGCNNet), the M-member inference ensemble (the JAX
package's ``stack_variables`` bundle, here a module holding its members)
and `apply_model`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.graph import N_EDGE_FEATS, N_NODE_FEATS, GraphBatch
from .layers import dense_aggregators
from .resgcn import ResGCNNet


def build_model(variant: str = "resgcn", in_channels: int = N_NODE_FEATS,
                edge_channels: int = N_EDGE_FEATS,
                hidden_channels: int = 128, n_layers: int = 6,
                n_classes: int = 3, dropout: float = 0.2,
                dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> nn.Module:
    """variant: "resgcn" only here.  `dtype` is the compute dtype (None:
    float32); `generator` seeds the initialisation."""
    kw = dict(in_channels=in_channels, edge_channels=edge_channels,
              hidden_channels=hidden_channels, n_layers=n_layers,
              n_classes=n_classes, dropout=dropout, dtype=dtype,
              generator=generator)
    if variant == "resgcn":
        return ResGCNNet(**kw)
    raise ValueError(f"Unknown variant '{variant}': the reference holds "
                     "ResGCNNet only")


class ModelEnsemble(nn.Module):
    """M members as one model.  Its forward returns the log of the members'
    mean class probability, log(mean_m softmax(logits_m) + 1e-9), so a
    softmax of it reproduces that mean.  The members share one set of
    aggregators (the dense adjacencies, or the caller's SpMM plans on the
    large-graph path)."""

    def __init__(self, members):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.supports_spmm_aggregators = all(
            getattr(m, "supports_spmm_aggregators", False) for m in members)

    def forward(self, g: GraphBatch, aggregators=None) -> torch.Tensor:
        aggregators = aggregators or dense_aggregators(g)
        acc = None
        for member in self.members:
            p = torch.softmax(member(g, aggregators=aggregators).float(),
                              dim=-1)
            acc = p if acc is None else acc + p
        return torch.log(acc / len(self.members) + 1e-9)


@torch.no_grad()
def apply_model(model: nn.Module, graph: GraphBatch) -> torch.Tensor:
    """Eval forward: (G, N, n_classes) logits, or the ensemble's log mean
    probability."""
    return model(graph)


