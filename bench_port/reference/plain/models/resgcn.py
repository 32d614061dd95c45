"""ResGCNNet — the flagship residual GCN with jumping-knowledge fusion.

Counterpart of ``gcn_grabcut_tpu/models/resgcn.py``:

    InputNorm -> InputProj -> PriorBooster -> [pre-norm ResBlock x n] ->
    SAGE branch -> JK softmax fusion -> GlobalContext -> fuse -> head

Aggregation comes from (gcn_propagate, mean_propagate) callables: the
dense adjacencies built once per forward by default, the banded SpMM on
the large-graph path (``models/large.py``).  `train()` mode computes the
InputNorm's batch statistics (and updates its running ones) and applies
dropout drawn from the forward's `generator`; `dtype=torch.bfloat16` is
flax's ``dtype=bfloat16`` (``layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.graph import GraphBatch, N_PRIOR_FEATS
from .layers import (EdgeContext, GCNConv, GlobalContext, InputNorm, Linear,
                     SAGEConv, dense_aggregators, dropout, gelu, layer_norm,
                     reset_parameters, set_compute_dtype, weighted_sum)


class ResGCNNet(nn.Module):
    # Accepts SpMM aggregators for the 10k+-node path (models/large.py).
    supports_spmm_aggregators = True

    def __init__(self, in_channels: int = 19, edge_channels: int = 5,
                 hidden_channels: int = 128, n_layers: int = 6,
                 n_classes: int = 3, dropout: float = 0.15,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        D = hidden_channels
        self.n_layers = n_layers
        self.dropout = dropout
        self.in_norm = InputNorm(in_channels)
        self.input_proj = Linear(in_channels, D)
        self.input_ln = layer_norm(D)
        self.prior_fc1 = Linear(N_PRIOR_FEATS, max(D // 4, 8))
        self.prior_fc2 = Linear(max(D // 4, 8), D)
        self.edge_ctx = EdgeContext(edge_channels, D)
        self.norms = nn.ModuleList(layer_norm(D) for _ in range(n_layers))
        self.convs = nn.ModuleList(GCNConv(D, D) for _ in range(n_layers))
        self.sage = SAGEConv(D, D)
        self.sage_norm = layer_norm(D)
        self.jk_logits = nn.Parameter(torch.zeros(n_layers + 2))
        self.ctx = GlobalContext(D)
        self.fuse_ln = layer_norm(D)
        self.fuse_fc = Linear(D, D)
        self.head = Linear(D, n_classes)
        set_compute_dtype(self, dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)
        # Built in eval mode, as flax's `train` flag defaults to False;
        # the trainer switches to train() for its steps.
        self.eval()

    def forward(self, g: GraphBatch, aggregators=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(G, N, n_classes) logits, in the compute dtype.  `aggregators` =
        (gcn_propagate, mean_propagate) callables over (G, N, D) tensors;
        None builds the dense ones from `g`.  `generator` draws the dropout
        masks in training (on the tensors' device)."""
        adj_gcn, adj_mean = aggregators or dense_aggregators(g)
        x = g.x
        prior = x[..., -N_PRIOR_FEATS:]

        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        h = self.in_norm(x, g.node_mask)
        h = gelu(self.input_ln(self.input_proj(h)))
        pb = torch.sigmoid(self.prior_fc2(gelu(self.prior_fc1(prior))))
        h = h * (1.0 + pb)

        gate = self.edge_ctx(g.edge_attr, g.edge_dst, g.edge_mask,
                             g.max_nodes).to(h.dtype)
        states = [h]
        for norm, conv in zip(self.norms, self.convs):
            h = h + drop(gelu(conv(norm(h), adj_gcn) * gate))
            states.append(h)

        sage = gelu(self.sage_norm(self.sage(h, adj_mean)))
        states.append(sage)

        h_jk = weighted_sum(torch.softmax(self.jk_logits.float(), dim=0),
                            torch.stack(states))
        h_jk = self.ctx(h_jk, g.node_mask)
        out = drop(gelu(self.fuse_fc(self.fuse_ln(h_jk))))
        return self.head(out)


