"""GATTrimapNet, the GATv2 attention variant with edge-aware kernels.

Counterpart of ``gcn_grabcut_tpu/models/gat.py``:

    InputNorm -> Linear -> LayerNorm -> GELU (skip: Linear, no bias) ->
    [GATv2Conv -> LayerNorm -> GELU -> dropout -> edge gate] x n ->
    + skip -> GlobalContext -> Linear -> GELU -> dropout -> Linear

The edges are sorted by destination once per forward.  On the large-graph
path (``models/large.py``) every layer's attention runs banded over a
`GatPlan` (``ops/sddmm.py``) instead of over the edge list.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.graph import GraphBatch
from .layers import (EdgeInjection, GATv2Conv, GlobalContext, InputNorm,
                     Linear, dropout, gelu, layer_norm, reset_parameters,
                     set_compute_dtype, sort_edges_by_dst)


class GATTrimapNet(nn.Module):
    # 10k+-node path: attention banded over an ops.sddmm.GatPlan.
    supports_banded_attention = True

    def __init__(self, in_channels: int = 19, edge_channels: int = 5,
                 hidden_channels: int = 128, n_heads: int = 8,
                 n_layers: int = 5, n_classes: int = 3,
                 dropout: float = 0.2, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        D = hidden_channels
        head_dim = D // n_heads
        width = head_dim * n_heads
        self.n_layers = n_layers
        self.dropout = dropout
        self.in_norm = InputNorm(in_channels, momentum=0.05)
        self.input_proj = Linear(in_channels, D)
        self.input_ln = layer_norm(D)
        self.skip_proj = Linear(D, width, bias=False)
        self.convs = nn.ModuleList(
            GATv2Conv(D if i == 0 else width, head_dim, heads=n_heads,
                      edge_features=edge_channels) for i in range(n_layers))
        self.norms = nn.ModuleList(layer_norm(width) for _ in range(n_layers))
        self.edges = nn.ModuleList(EdgeInjection(edge_channels, width)
                                   for _ in range(n_layers))
        self.ctx = GlobalContext(width)
        self.head_fc1 = Linear(width, D)
        self.head_fc2 = Linear(D, n_classes)
        set_compute_dtype(self, dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)
        self.eval()    # flax's `train` defaults to False

    def forward(self, g: GraphBatch, generator: torch.Generator | None = None,
                gat_plan=None, gat_precision: str = "default"
                ) -> torch.Tensor:
        """(G, N, n_classes) logits in the compute dtype.  `gat_plan` (one
        graph) runs every layer's attention banded at `gat_precision`;
        `generator` draws dropout in training."""
        mask = g.node_mask

        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        h = self.in_norm(g.x, mask)
        h = gelu(self.input_ln(self.input_proj(h)))
        skip = self.skip_proj(h)
        e_src, e_dst, e_attr, e_mask = sort_edges_by_dst(
            g.edge_src, g.edge_dst, g.edge_attr, g.edge_mask)
        for conv, norm, gate in zip(self.convs, self.norms, self.edges):
            u = conv(h, e_src, e_dst, e_attr, e_mask, mask, pre_sorted=True,
                     plan=gat_plan, plan_precision=gat_precision)
            u = drop(gelu(norm(u)))
            h = gate(e_attr, e_dst, e_mask, u, pre_sorted=True)
        h = self.ctx(h + skip, mask)
        return self.head_fc2(drop(gelu(self.head_fc1(h))))
