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
large-graph path.  `GATv2Conv` attends over the edge list (all graphs of
a batch as one flattened list, fixed-order segment reductions), or
banded over a ``GatPlan`` (``ops/sddmm.py``); `EdgeInjection` is the
GCN and GAT variants' per-layer edge gate.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import NEG_INF, masked_softmax
from ..ops.region import segment_max, segment_sum
from ..ops.sddmm import banded_gat_attention

LN_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Linear(nn.Linear):
    """nn.Linear in a compute dtype (flax ``nn.Dense(dtype=...)``)."""
    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


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


def uniform(shape, generator=None, device=None) -> torch.Tensor:
    """U[0, 1) draws of `shape` on `device` from `generator`: a
    ``torch.Generator`` (torch's default generator when None), or an
    object with its own ``rand(shape, device)``, such as the data-parallel
    trainer's per-rank slice of one draw over the whole batch
    (``parallel/data.py``)."""
    if generator is None or isinstance(generator, torch.Generator):
        return torch.rand(shape, generator=generator, device=device)
    return generator.rand(tuple(shape), device)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate); the draws come from `generator` (see `uniform`).
    Identity outside training."""
    if not training or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = uniform(x.shape, generator, x.device) < 1.0 - rate
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
    """The JAX package's initialisation: Kaiming-normal Linear weights and
    GATv2 attention vectors, zero biases, unit LayerNorm scales (seeded by
    `generator`)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            kaiming_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, GATv2Conv):
            # flax's fan-in of an (H, F) kernel is shape[-2] = H.
            with torch.no_grad():
                m.att.normal_(0.0, math.sqrt(2.0 / m.att.shape[0]),
                              generator=generator)
            nn.init.zeros_(m.bias)


class GCNConv(nn.Module):
    """PyG-order GCN convolution: linear (no bias) -> propagate -> bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin = Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, propagate):
        out = propagate(self.lin(x))
        return out + self.bias.to(out.dtype)


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


def sort_edges_by_dst(edge_src, edge_dst, edge_attr, edge_mask):
    """Each graph's edges in stable destination order (``jnp.argsort``),
    once per forward for every layer's segment reductions."""
    order = torch.argsort(edge_dst, dim=1, stable=True)
    return (edge_src.gather(1, order), edge_dst.gather(1, order),
            edge_attr.gather(1, order[..., None].expand_as(edge_attr)),
            edge_mask.gather(1, order))


class GATv2Conv(nn.Module):
    """GATv2 with edge attributes (JAX ``layers.py:118-224``):
    e_ij = att_h . LeakyReLU(W_l x_j + W_r x_i + W_e attr_ij), a softmax
    per destination over its in-edges and a self loop whose attribute is
    the graph's mean edge attribute, heads concatenated.

    The edge-list form runs all G graphs as one flattened edge list: the
    softmax statistics in float32 (-1e30 for masked slots, a 1e-12
    denominator guard), the messages flat (E, H·F) with the attention
    repeated per head.  `plan=` (an ``ops.sddmm.GatPlan``, G == 1) runs
    the banded form instead, with the same parameters."""

    def __init__(self, in_features: int, features: int, heads: int = 8,
                 edge_features: int = 5, negative_slope: float = 0.2):
        super().__init__()
        self.heads, self.features = heads, features
        self.negative_slope = negative_slope
        hf = heads * features
        self.lin_l = Linear(in_features, hf)
        self.lin_r = Linear(in_features, hf)
        self.lin_edge = Linear(edge_features, hf, bias=False)
        self.att = nn.Parameter(torch.zeros(heads, features))
        self.bias = nn.Parameter(torch.zeros(hf))

    def forward(self, x, edge_src, edge_dst, edge_attr, edge_mask, node_mask,
                pre_sorted: bool = False, plan=None,
                plan_precision: str = "default"):
        G, N, _ = x.shape
        H, Fh = self.heads, self.features
        slope = self.negative_slope
        xl = self.lin_l(x).reshape(G, N, H, Fh)
        xr = self.lin_r(x).reshape(G, N, H, Fh)
        if plan is not None:
            if G != 1:
                raise ValueError("banded attention operates on one graph")
            out = banded_gat_attention(xl[0], xr[0], plan, self.lin_edge,
                                       self.att, node_mask[0],
                                       negative_slope=slope,
                                       precision=plan_precision)
            return out.reshape(1, N, H * Fh) + self.bias.to(out.dtype)

        em = edge_mask[..., None]
        attr_mean = ((edge_attr * em).sum(dim=1, keepdim=True)
                     / em.sum(dim=1, keepdim=True).clamp_min(1.0))
        ea = self.lin_edge(edge_attr)
        ea_loop = self.lin_edge(attr_mean).reshape(G, 1, H, Fh)
        if not pre_sorted:
            edge_src, edge_dst, ea, edge_mask = sort_edges_by_dst(
                edge_src, edge_dst, ea, edge_mask)
        src, dst = _flat_edges(edge_src, N), _flat_edges(edge_dst, N)
        xl_f = xl.reshape(G * N, H, Fh)
        z = xl_f[src] + xr.reshape(G * N, H, Fh)[dst] + ea.reshape(-1, H, Fh)
        z = F.leaky_relu(z, slope)
        att = self.att.to(z.dtype)
        score = torch.einsum("ehf,hf->eh", z, att)
        zl = F.leaky_relu(xl + xr + ea_loop, slope)
        sl = torch.einsum("gnhf,hf->gnh", zl, att).float().reshape(G * N, H)
        nm = node_mask.reshape(-1, 1)
        sl = torch.where(nm > 0, sl, NEG_INF)
        m = edge_mask.reshape(-1, 1)
        s = torch.where(m > 0, score.float(), NEG_INF)
        with torch.no_grad():   # a shift the softmax does not depend on
            peak = segment_max(dst, s, G * N, is_sorted=True)
            peak = torch.maximum(
                torch.where(torch.isfinite(peak), peak, NEG_INF), sl)
        ex = torch.exp(s - peak[dst]) * m
        exl = torch.exp(sl - peak) * nm
        tot = segment_sum(dst, ex, G * N, is_sorted=True) + exl
        alpha = (ex / (tot[dst] + 1e-12)).to(z.dtype)
        alpha_l = (exl / (tot + 1e-12)).to(z.dtype)
        msg = (xl_f[src] * alpha[..., None]).reshape(-1, H * Fh)
        out = segment_sum(dst, msg, G * N, is_sorted=True).reshape(
            G * N, H, Fh) + xl_f * alpha_l[..., None]
        out = out.reshape(G, N, H * Fh)
        return out + self.bias.to(out.dtype)


class EdgeInjection(nn.Module):
    """Per-layer edge gate of the GCN and GAT variants (JAX
    ``layers.py:259-288``): sigmoid(MLP(edge attributes)), averaged over
    each node's incoming edges, multiplies the node updates."""

    def __init__(self, edge_features: int, hidden_dim: int):
        super().__init__()
        self.fc0 = Linear(edge_features, hidden_dim)
        self.fc1 = Linear(hidden_dim, hidden_dim)

    def forward(self, edge_attr, edge_dst, edge_mask, node_updates,
                pre_sorted: bool = False):
        G, N = node_updates.shape[:2]
        h = torch.sigmoid(self.fc1(torch.relu(self.fc0(edge_attr))))
        C = h.shape[-1]
        w = edge_mask.reshape(-1, 1).float()
        sums = segment_sum(_flat_edges(edge_dst, N),
                           torch.cat([h.reshape(-1, C) * w, w], dim=1),
                           G * N, is_sorted=pre_sorted)
        gates = (sums[:, :C] / sums[:, C:].clamp_min(1.0)).reshape(G, N, C)
        return node_updates * gates.to(node_updates.dtype)


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
        w = masked_softmax(self.attn(x)[..., 0], node_mask, dim=1)[..., None]
        g = (w.to(x.dtype) * x).sum(dim=1, keepdim=True)    # (G, 1, D)
        g = torch.sigmoid(self.expand(torch.relu(self.compress(g))))
        return x * g


class InputNorm(nn.Module):
    """Masked BatchNorm1d analog with running statistics (JAX
    ``layers.py:309-351``).

    Training normalises with the batch statistics over valid nodes (biased
    variance) and updates the running ones with momentum 0.05 (unbiased
    variance); with fewer than two valid nodes it uses and keeps the
    running statistics.  Evaluation uses the running statistics.  The
    arithmetic is float32; the output is the compute dtype, else x's.

    Inside `global_statistics(mean, var, count)` training normalises with
    the given statistics of a batch sharded over ranks and leaves the
    running ones alone: the data-parallel trainer sums `masked_sums` and
    then `squared_deviations` over the ranks and calls `update_running`
    once per step."""
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
        self._global = None

    @contextlib.contextmanager
    def global_statistics(self, mean: torch.Tensor, var: torch.Tensor,
                          count: torch.Tensor):
        """Normalise training forwards with these (biased) statistics over
        `count` valid nodes in all."""
        self._global = (mean, var, count)
        try:
            yield
        finally:
            self._global = None

    @staticmethod
    def masked_sums(x, node_mask) -> tuple[torch.Tensor, torch.Tensor]:
        """(sum of x over valid nodes (F,), valid-node count (1,)), float32:
        the first of the two passes."""
        m = node_mask.float()[..., None]
        return (x.float() * m).sum(dim=(0, 1)), m.sum(dim=(0, 1))

    @staticmethod
    def squared_deviations(x, node_mask, mean) -> torch.Tensor:
        """The sum of (x - mean)^2 over valid nodes (F,): the second pass."""
        m = node_mask.float()[..., None]
        return (((x.float() - mean) ** 2) * m).sum(dim=(0, 1))

    def select(self, mean, var, count):
        """The statistics a training forward uses: the batch's, or the
        running ones below two valid nodes."""
        use_batch = count >= 2.0
        return (torch.where(use_batch, mean, self.running_mean),
                torch.where(use_batch, var, self.running_var))

    @torch.no_grad()
    def update_running(self, mean, var, count) -> None:
        """One momentum update from a batch's selected statistics."""
        use_batch = count >= 2.0
        unbiased = var * count / (count - 1.0).clamp_min(1.0)
        mo = self.momentum
        self.running_mean.copy_(torch.where(
            use_batch, (1 - mo) * self.running_mean + mo * mean,
            self.running_mean))
        self.running_var.copy_(torch.where(
            use_batch, (1 - mo) * self.running_var + mo * unbiased,
            self.running_var))

    def forward(self, x, node_mask=None):
        xf = x.float()
        if self.training and self._global is not None:
            mean, var = self.select(*self._global)
        elif self.training:
            if node_mask is None:
                raise ValueError("InputNorm needs node_mask in training")
            total, count = self.masked_sums(xf, node_mask)
            count = count.clamp_min(1.0)
            mean = total / count
            var = self.squared_deviations(xf, node_mask, mean) / count
            mean, var = self.select(mean, var, count)
            self.update_running(mean, var, count)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean) * inv * self.weight + self.bias
        return y.to(self.compute_dtype or x.dtype)
