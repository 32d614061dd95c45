"""GCNTrimapNet, the baseline residual GCN with a per-layer edge gate.

Counterpart of ``gcn_grabcut_tpu/models/gcn.py``:

    InputNorm -> Linear -> InputNorm -> ReLU ->
    [GCNConv -> InputNorm -> ReLU -> dropout -> + skip -> edge gate] x n ->
    concat of every layer's output -> Linear -> InputNorm -> ReLU ->
    dropout -> Linear -> ReLU -> Linear

Aggregation is the GCN propagation only: the dense normalised adjacency
by default, the banded SpMM (K1 on the card) on the large-graph path
(``models/large.py``), n_layers launches per forward.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.graph import GraphBatch
from .layers import (EdgeInjection, GCNConv, InputNorm, Linear,
                     dense_aggregators, dropout, reset_parameters,
                     set_compute_dtype, sort_edges_by_dst)


class GCNTrimapNet(nn.Module):
    # Accepts SpMM aggregators for the 10k+-node path (models/large.py).
    supports_spmm_aggregators = True

    def __init__(self, in_channels: int = 19, edge_channels: int = 5,
                 hidden_channels: int = 128, n_layers: int = 6,
                 n_classes: int = 3, dropout: float = 0.2,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        D = hidden_channels
        self.n_layers = n_layers
        self.dropout = dropout
        self.in_norm = InputNorm(in_channels, momentum=0.05)
        self.input_proj = Linear(in_channels, D)
        self.input_bn = InputNorm(D, momentum=0.1)
        self.convs = nn.ModuleList(GCNConv(D, D) for _ in range(n_layers))
        self.bns = nn.ModuleList(InputNorm(D, momentum=0.1)
                                 for _ in range(n_layers))
        self.edges = nn.ModuleList(EdgeInjection(edge_channels, D)
                                   for _ in range(n_layers))
        self.head_fc1 = Linear(D * (n_layers + 1), D)
        self.head_bn = InputNorm(D, momentum=0.1)
        self.head_fc2 = Linear(D, D // 2)
        self.head_fc3 = Linear(D // 2, n_classes)
        set_compute_dtype(self, dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)
        self.eval()    # flax's `train` defaults to False

    def forward(self, g: GraphBatch, aggregators=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(G, N, n_classes) logits in the compute dtype.  `aggregators`:
        (gcn_propagate, mean_propagate), of which only the first is used;
        None builds the dense ones.  `generator` draws dropout in
        training."""
        adj_gcn = (aggregators or dense_aggregators(g))[0]
        mask = g.node_mask

        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        h = self.in_norm(g.x, mask)
        h = torch.relu(self.input_bn(self.input_proj(h), mask))
        _, e_dst, e_attr, e_mask = sort_edges_by_dst(
            g.edge_src, g.edge_dst, g.edge_attr, g.edge_mask)
        states = [h]
        for conv, bn, gate in zip(self.convs, self.bns, self.edges):
            u = drop(torch.relu(bn(conv(h, adj_gcn), mask))) + h
            h = gate(e_attr, e_dst, e_mask, u, pre_sorted=True)
            states.append(h)
        out = self.head_fc1(torch.cat(states, dim=-1))
        out = drop(torch.relu(self.head_bn(out, mask)))
        out = torch.relu(self.head_fc2(out))
        return self.head_fc3(out)
