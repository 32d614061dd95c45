"""Graph-NN building blocks over dense-padded batches.

Counterpart of ``gcn_grabcut_tpu/models/layers.py`` (eval forward).  Two
flax conventions are kept so that converted weights compute the same
function: LayerNorm eps is 1e-6 (torch's default is 1e-5), and GELU is the
tanh approximation (flax ``nn.gelu`` default).

Aggregation is a callable h -> aggregated h: the dense (G, N, N)
normalised adjacencies of `dense_aggregators` (one ``torch.bmm`` per
propagation, fp32), or the banded SpMM of ``ops/spmm.py`` on the
large-graph path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import masked_softmax
from ..ops.region import segment_sum

LN_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def layer_norm(features: int) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=LN_EPS)


def dense_adjacency(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                    edge_mask: torch.Tensor, n: int) -> torch.Tensor:
    """(G, E) edge lists -> dense (G, N, N) float32 adjacency,
    A[g, dst, src] += mask: duplicate edges accumulate, padded edges add 0."""
    G = edge_src.shape[0]
    g = torch.arange(G, device=edge_src.device)[:, None]
    flat = ((g * n + edge_dst.long()) * n + edge_src.long()).reshape(-1)
    adj = torch.zeros(G * n * n, device=edge_mask.device)
    adj.index_put_((flat,), edge_mask.reshape(-1).float(), accumulate=True)
    return adj.reshape(G, n, n)


def gcn_norm_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2 with self-loops (PyG GCNConv)."""
    a_hat = adj + torch.eye(adj.shape[-1], dtype=adj.dtype,
                            device=adj.device)
    dinv = torch.rsqrt(a_hat.sum(dim=-1).clamp_min(1e-12))
    return a_hat * dinv[..., :, None] * dinv[..., None, :]


def mean_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """Row-normalised adjacency for mean aggregation (SAGE)."""
    return adj / adj.sum(dim=-1, keepdim=True).clamp_min(1.0)


def _as_aggregate(adj: torch.Tensor):
    """A dense (G, N, N) matrix as an aggregation callable, fp32."""
    def agg(h):
        return torch.bmm(adj, h.float()).to(h.dtype)
    return agg


def dense_aggregators(g) -> tuple:
    """(gcn_propagate, mean_propagate) of a GraphBatch through its dense
    adjacency, built once and shared by every layer."""
    adj = dense_adjacency(g.edge_src, g.edge_dst, g.edge_mask, g.max_nodes)
    return (_as_aggregate(gcn_norm_adjacency(adj)),
            _as_aggregate(mean_adjacency(adj)))


def kaiming_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax variance_scaling(2.0, "fan_in", "normal") on a (out, in)
    torch Linear weight: std = sqrt(2 / fan_in)."""
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / weight.shape[1]),
                       generator=generator)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation: Kaiming-normal Linear weights,
    zero biases, unit LayerNorm scales (seeded by `generator`)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            kaiming_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class GCNConv(nn.Module):
    """PyG-order GCN convolution: linear (no bias) -> propagate -> bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin = nn.Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, propagate):
        return propagate(self.lin(x)) + self.bias


class SAGEConv(nn.Module):
    """GraphSAGE with mean aggregation: lin_l(mean_nbr) + lin_r(x)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin_l = nn.Linear(in_features, features, bias=True)
        self.lin_r = nn.Linear(in_features, features, bias=False)

    def forward(self, x, propagate):
        return self.lin_l(propagate(x)) + self.lin_r(x)


class EdgeContext(nn.Module):
    """Edge features -> per-node sigmoid gate: an edge MLP, a masked mean
    over each node's incoming edges, LayerNorm, a linear gate."""

    def __init__(self, edge_features: int, hidden_dim: int):
        super().__init__()
        ctx_dim = max(hidden_dim // 2, 8)
        self.fc0 = nn.Linear(edge_features, ctx_dim)
        self.fc1 = nn.Linear(ctx_dim, ctx_dim)
        self.norm = layer_norm(ctx_dim)
        self.gate = nn.Linear(ctx_dim, hidden_dim)

    def forward(self, edge_attr, edge_dst, edge_mask, n_nodes: int):
        h = self.fc1(gelu(self.fc0(edge_attr)))             # (G, E, C)
        G, E, C = h.shape
        # Masked scatter-mean by destination, all graphs in one fixed-order
        # segment sum (the same sums in every run on the card).
        idx = (edge_dst + n_nodes * torch.arange(
            G, device=h.device)[:, None]).reshape(-1)
        w = edge_mask.reshape(-1)
        sums = segment_sum(idx, torch.cat([h.reshape(-1, C) * w[:, None],
                                           w[:, None]], dim=1), G * n_nodes)
        tot, cnt = sums[:, :C], sums[:, C]
        ctx = (tot / cnt.clamp_min(1.0)[:, None]).reshape(G, n_nodes, C)
        return torch.sigmoid(self.gate(self.norm(ctx)))


class GlobalContext(nn.Module):
    """Attention-pooled per-graph summary -> squeeze-excite node gating."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.attn = nn.Linear(hidden_dim, 1)
        self.compress = nn.Linear(hidden_dim, hidden_dim // 2)
        self.expand = nn.Linear(hidden_dim // 2, hidden_dim)

    def forward(self, x, node_mask):
        w = masked_softmax(self.attn(x)[..., 0], node_mask, dim=1)[..., None]
        g = (w.to(x.dtype) * x).sum(dim=1, keepdim=True)    # (G, 1, D)
        g = torch.sigmoid(self.expand(torch.relu(self.compress(g))))
        return x * g


class InputNorm(nn.Module):
    """Masked BatchNorm1d analog, eval mode: running statistics only."""

    def __init__(self, n_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_features))
        self.bias = nn.Parameter(torch.zeros(n_features))
        self.register_buffer("running_mean", torch.zeros(n_features))
        self.register_buffer("running_var", torch.ones(n_features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x.float() - self.running_mean) * inv * self.weight
                + self.bias).to(x.dtype)
