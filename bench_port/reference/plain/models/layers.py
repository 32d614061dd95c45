"""Graph-NN building blocks over dense-padded batches.

Counterpart of ``gcn_grabcut_tpu/models/layers.py``.  Two flax conventions
are kept so that converted weights compute the same function: LayerNorm eps
is 1e-6 (torch's default is 1e-5), and GELU is the tanh approximation (flax
``nn.gelu`` default).

A compute dtype mirrors flax's ``dtype=`` argument: parameters stay
float32, a `Linear` casts its input, weight and bias to the compute dtype,
a `LayerNorm` takes its statistics in float32 and returns the compute
dtype.  None (the default) computes in the input's dtype, float32 here.

Aggregation is a callable h -> aggregated h: the dense (G, N, N)
normalised adjacencies of `dense_aggregators` (one ``torch.bmm`` per
propagation, fp32), or the banded SpMM of ``ops/spmm.py`` on the
large-graph path.  Only what ResGCNNet evaluates is kept.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.scatter import masked_softmax
from ..ops.region import segment_sum

LN_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# A parameter's gradient is a sum over the batch's rows.  Where a layer
# computes in bfloat16, autograd would round each data-parallel rank's sum
# to bfloat16 before the ranks' gradients are added; the functions below
# take those sums in float32 (products of bfloat16 values are exact
# there), so one rank's step and several ranks' compute one function.
# Outputs and the gradients of activations are autograd's own.

def _graph_matmul(a: torch.Tensor, b: torch.Tensor, bias=None):
    """a (..., K) @ b (K, O) (+ bias), a's leading (graph) axis as the
    batch of one batched product: each graph's rows go through a product
    of the same shape whatever the number of graphs.  cuBLAS picks its
    kernel, and so its order of adds, by the whole product's shape: one
    product over 2 graphs' rows can round them otherwise than one over 8
    graphs (``chip_smoke.py`` phase 12 checks both forms on the card), and
    the data-parallel ranks must round as the single-device step does."""
    if a.dim() < 3:
        out = a.matmul(b)
        return out if bias is None else out + bias
    G = a.shape[0]
    a3, b3 = a.reshape(G, -1, a.shape[-1]), b.expand(G, *b.shape)
    out = torch.bmm(a3, b3) if bias is None else torch.baddbmm(bias, a3, b3)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _Linear(torch.autograd.Function):
    """F.linear with input, weight and bias cast to the compute dtype `dt`
    (None: the input's), graph by graph (`_graph_matmul`); the weight's
    and bias's gradients are float32 sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, dt):
        xc, wc = (x, weight) if dt is None else (x.to(dt), weight.to(dt))
        ctx.save_for_backward(xc, wc)
        ctx.x_dtype, ctx.has_bias = x.dtype, bias is not None
        return _graph_matmul(xc, wc.t(),
                             None if bias is None else bias.to(wc.dtype))


def add_bias(out: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """out + bias in out's dtype; bias's gradient a float32 sum."""
    if out.dtype == bias.dtype:
        return out + bias
    return _AddBias.apply(out, bias)


class _AddBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, bias):
        return out + bias.to(out.dtype)


def weighted_sum(w: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """sum_k w[k] stack[k] in stack's dtype; in another compute dtype than
    w's, w is rounded to it, the sum taken in float32 element by element
    and w's gradient is a float32 sum."""
    if w.dtype == stack.dtype:
        return torch.einsum("k,k...->...", w, stack)
    return _WeightedSum.apply(w, stack)


class _WeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, stack):
        wc = w.to(stack.dtype)
        ctx.save_for_backward(wc, stack)
        wf = wc.float()
        acc = wf[0] * stack[0].float()
        for k in range(1, stack.shape[0]):
            acc = acc + wf[k] * stack[k].float()
        return acc.to(stack.dtype)


class Linear(nn.Linear):
    """nn.Linear in a compute dtype (flax ``nn.Dense(dtype=...)``), graph
    by graph, its parameter gradients float32 sums (`_Linear`)."""
    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        return _Linear.apply(x, self.weight, self.bias, self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with float32 statistics, returning the compute dtype
    (flax ``nn.LayerNorm(dtype=...)``)."""
    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype or x.dtype)


def layer_norm(features: int) -> LayerNorm:
    return LayerNorm(features, eps=LN_EPS)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate); the draws come from `generator`.  Identity outside
    training."""
    if not training or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> None:
    """Set the compute dtype of every Linear, LayerNorm and InputNorm."""
    for m in module.modules():
        if isinstance(m, (Linear, LayerNorm, InputNorm)):
            m.compute_dtype = dtype


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
    """A dense (G, N, N) matrix as an aggregation callable: the matrix is
    rounded to h's dtype, the products accumulate in float32 and the
    result is h's dtype (JAX ``preferred_element_type=float32``)."""
    def agg(h):
        return torch.bmm(adj.to(h.dtype).float(), h.float()).to(h.dtype)
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
        self.lin = Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, propagate):
        return add_bias(propagate(self.lin(x)), self.bias)


class SAGEConv(nn.Module):
    """GraphSAGE with mean aggregation: lin_l(mean_nbr) + lin_r(x)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin_l = Linear(in_features, features, bias=True)
        self.lin_r = Linear(in_features, features, bias=False)

    def forward(self, x, propagate):
        return self.lin_l(propagate(x)) + self.lin_r(x)


def _flat_edges(edge_index: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(G, E) per-graph node indices -> (G·E,) indices into the G·N rows
    of the flattened batch."""
    G = edge_index.shape[0]
    base = n_nodes * torch.arange(G, device=edge_index.device)[:, None]
    return (edge_index.long() + base).reshape(-1)


class EdgeContext(nn.Module):
    """Edge features -> per-node sigmoid gate: an edge MLP, a masked mean
    over each node's incoming edges, LayerNorm, a linear gate."""

    def __init__(self, edge_features: int, hidden_dim: int):
        super().__init__()
        ctx_dim = max(hidden_dim // 2, 8)
        self.fc0 = Linear(edge_features, ctx_dim)
        self.fc1 = Linear(ctx_dim, ctx_dim)
        self.norm = layer_norm(ctx_dim)
        self.gate = Linear(ctx_dim, hidden_dim)

    def forward(self, edge_attr, edge_dst, edge_mask, n_nodes: int):
        h = self.fc1(gelu(self.fc0(edge_attr)))             # (G, E, C)
        G, E, C = h.shape
        # Masked scatter-mean by destination, all graphs in one fixed-order
        # segment sum (the same sums in every run on the card).
        w = edge_mask.reshape(-1)
        sums = segment_sum(_flat_edges(edge_dst, n_nodes),
                           torch.cat([h.reshape(-1, C) * w[:, None],
                                      w[:, None]], dim=1), G * n_nodes)
        tot, cnt = sums[:, :C], sums[:, C]
        ctx = (tot / cnt.clamp_min(1.0)[:, None]).reshape(G, n_nodes, C)
        return torch.sigmoid(self.gate(self.norm(ctx)))


class GlobalContext(nn.Module):
    """Attention-pooled per-graph summary -> squeeze-excite node gating."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.attn = Linear(hidden_dim, 1)
        self.compress = Linear(hidden_dim, hidden_dim // 2)
        self.expand = Linear(hidden_dim // 2, hidden_dim)

    def forward(self, x, node_mask):
        w = masked_softmax(self.attn(x)[..., 0], node_mask, axis=1)[..., None]
        g = (w.to(x.dtype) * x).sum(dim=1, keepdim=True)    # (G, 1, D)
        g = torch.sigmoid(self.expand(torch.relu(self.compress(g))))
        return x * g


class InputNorm(nn.Module):
    """Masked BatchNorm1d analog (JAX ``layers.py:309-351``) as evaluation
    runs it: the running statistics, float32 arithmetic, the output in the
    compute dtype, else x's."""
    compute_dtype: torch.dtype | None = None

    def __init__(self, n_features: int, momentum: float = 0.05,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_features))
        self.bias = nn.Parameter(torch.zeros(n_features))
        self.register_buffer("running_mean", torch.zeros(n_features))
        self.register_buffer("running_var", torch.ones(n_features))

    def forward(self, x, node_mask=None):
        inv = torch.rsqrt(self.running_var + self.eps)
        y = (x.float() - self.running_mean) * inv * self.weight + self.bias
        return y.to(self.compute_dtype or x.dtype)
