"""GATTrimapNet's forward in plain PyTorch, over one graph's edge list.

The benchmark's reference for the GAT configuration, and the one the CPU
tests hold the program to.  It imports nothing of the program and no
kernel: plain torch operations, the segment softmax and sums through
``scatter_reduce`` / ``index_add_``, no plan, no banding, no batching.

The architecture is GATv2 ("How Attentive are Graph Attention
Networks?", Brody, Alon and Yahav, ICLR 2022, arXiv:2105.14491) with edge
features, as the upstream project's ``GATTrimapNet`` stacks it
(github.com/HanielUlises/GCN-GrabCut, ``src/gcn_grabcut/model.py``
lines 323-414, PyG ``GATv2Conv(heads=8, edge_dim=5)``):

    InputNorm -> Linear -> LayerNorm -> GELU            h   (skip: Linear,
    [GATv2Conv -> LayerNorm -> GELU -> edge gate] x n   h    no bias, of h)
    h + skip -> GlobalContext -> Linear -> GELU -> Linear    logits

A GATv2 layer of H heads of F features, with W_l, W_r, W_e and att_h:

    e_ij     = att_h . LeakyReLU_0.2(W_l x_j + W_r x_i + W_e a_ij)
    alpha_ij = softmax of e_ij over the in-edges j -> i and a self loop
    out_i    = sum_j alpha_ij W_l x_j + bias, the heads concatenated

The edge gate of layer l multiplies node i's update by the mean over its
in-edges of sigmoid(fc1(relu(fc0(a_ij)))) (0 for a node with none); the
GlobalContext gates every node by sigmoid(expand(relu(compress(g)))),
g the nodes' sum weighted by a softmax of attn(h) over the valid nodes.
LayerNorm's eps is 1e-6 and GELU the tanh form (flax's defaults, whose
weights these are); InputNorm uses its running statistics (eval).
Dropout is off (eval).

Departures from upstream, each shared with the program:
- the self loop's attribute is the mean attribute of the graph's valid
  edges, where PyG's ``fill_value="mean"`` gives each node the mean of
  its own in-edges' attributes;
- an edge listed twice (the graph build can list a pair as an adjacency
  and a non-local edge above 2048 nodes) counts twice, as PyG counts it;
  the program's banded plan keeps one copy in its slot and sends the
  repeat to its fallback list to compute this same function.

Precision.  Everything is float32 with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False during the forward), except at
the attention's rounding points when `attention_dtype` is given: W_l x,
W_r x, W_e a and att_h rounded to it; z = LeakyReLU(W_l x_j + W_r x_i +
W_e a_ij) summed in float32, rounded, its LeakyReLU rounded; the scores
float32 sums of products of those values; the softmax statistics float32;
each message weight exp(e_ij - peak) rounded to it, its products with
W_l x_j summed in float32.  bfloat16 there is the program's banded
attention at its default precision; float8 e4m3 round trips are the
control's.  `compute_dtype` bfloat16 runs the Linears, LayerNorms and
InputNorm in bfloat16 (the control).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LN_EPS = 1e-6
IN_EPS = 1e-5
#: float8 e4m3's largest finite value (the control's round trips clamp
#: to it).
E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """TF32 off for float32 products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rounding(dtype: torch.dtype | None):
    """t -> t rounded to `dtype` and back to float32 (None: t as float32)."""
    if dtype is None:
        return lambda t: t.float()
    if dtype == torch.float8_e4m3fn:
        return lambda t: t.float().clamp(-E4M3_MAX, E4M3_MAX).to(
            dtype).float()
    return lambda t: t.to(dtype).float()


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class GATTrimapNet:
    """The forward of a GATTrimapNet whose parameters `params` are named
    as the program's ``state_dict`` names them (InputNorm's running
    statistics included)."""

    def __init__(self, params: dict):
        self.p = {k: v.float() for k, v in params.items()}
        self.n_layers = sum(1 for k in params if k.endswith(".att"))

    def to(self, device) -> "GATTrimapNet":
        self.p = {k: v.to(device) for k, v in self.p.items()}
        return self

    # -- layers -----------------------------------------------------------
    def _linear(self, x, name: str, dt):
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias")
        if dt is not None:
            x, w = x.to(dt), w.to(dt)
            b = None if b is None else b.to(dt)
        out = x @ w.t()
        return out if b is None else out + b

    def _layer_norm(self, x, name: str, dt):
        y = F.layer_norm(x.float(), x.shape[-1:], self.p[f"{name}.weight"],
                         self.p[f"{name}.bias"], LN_EPS)
        return y.to(dt or x.dtype)

    def _input_norm(self, x, dt):
        p = self.p
        inv = torch.rsqrt(p["in_norm.running_var"] + IN_EPS)
        y = (x.float() - p["in_norm.running_mean"]) * inv \
            * p["in_norm.weight"] + p["in_norm.bias"]
        return y.to(dt or x.dtype)

    def _gatv2(self, h, l: int, src, dst, attr, attr_mean, node_mask, dt,
               rnd):
        """Layer `l`'s GATv2 over the valid edges src -> dst."""
        name = f"convs.{l}"
        att = self.p[f"{name}.att"]
        H, Fh = att.shape
        N = h.shape[0]
        xl = self._linear(h, f"{name}.lin_l", dt)
        out_dtype = xl.dtype
        xl = rnd(xl).reshape(N, H, Fh)
        xr = rnd(self._linear(h, f"{name}.lin_r", dt)).reshape(N, H, Fh)
        ea = rnd(self._linear(attr, f"{name}.lin_edge", dt)).reshape(
            -1, H, Fh)
        ea_loop = rnd(self._linear(attr_mean, f"{name}.lin_edge", dt)
                      ).reshape(H, Fh)
        att = rnd(att)

        def score(pre):
            z = rnd(F.leaky_relu(rnd(pre), 0.2))
            return (z * att).sum(dim=-1)

        s = score(xl[src] + xr[dst] + ea)                     # (E, H)
        sl = score(xl + xr + ea_loop)                         # (N, H)
        sl = torch.where(node_mask[:, None] > 0, sl, NEG_INF)
        peak = sl.scatter_reduce(0, dst[:, None].expand(-1, H), s, "amax",
                                 include_self=True)
        ex = torch.exp(s - peak[dst])
        exl = torch.exp(sl - peak) * node_mask[:, None]
        tot = exl.index_add(0, dst, ex)
        msg = (exl[..., None] * xl).index_add(0, dst, rnd(ex)[..., None]
                                              * xl[src])
        out = msg / (tot[..., None] + 1e-12)
        return out.reshape(N, H * Fh).to(out_dtype) \
            + self.p[f"{name}.bias"].to(out_dtype)

    def _edge_gate(self, u, l: int, dst, attr, dt):
        name = f"edges.{l}"
        g = torch.sigmoid(self._linear(torch.relu(self._linear(
            attr, f"{name}.fc0", dt)), f"{name}.fc1", dt)).float()
        N, C = u.shape
        sums = torch.zeros(N, C, device=u.device).index_add(0, dst, g)
        cnt = torch.zeros(N, device=u.device).index_add(
            0, dst, torch.ones_like(dst, dtype=torch.float32))
        return u * (sums / cnt.clamp_min(1.0)[:, None]).to(u.dtype)

    def _global_context(self, x, node_mask, dt):
        a = self._linear(x, "ctx.attn", dt)[:, 0].float()
        a = torch.where(node_mask > 0, a, NEG_INF)
        ex = torch.exp(a - a.max()) * node_mask
        w = (ex / (ex.sum() + 1e-12)).to(x.dtype)
        g = (w[:, None] * x).sum(dim=0, keepdim=True)
        g = torch.sigmoid(self._linear(torch.relu(self._linear(
            g, "ctx.compress", dt)), "ctx.expand", dt))
        return x * g

    # -- forward ----------------------------------------------------------
    @torch.no_grad()
    def __call__(self, x, edge_src, edge_dst, edge_attr, node_mask,
                 edge_mask, attention_dtype: torch.dtype | None = None,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """(N, n_classes) float32 logits of one graph: x (N, 19), the
        edge list (E,), (E,), (E, 5) with its (E,) mask, node_mask (N,).
        The precisions: the module docstring."""
        dt, rnd = compute_dtype, rounding(attention_dtype)
        keep = edge_mask > 0
        src, dst = edge_src[keep].long(), edge_dst[keep].long()
        attr = edge_attr[keep].float()
        attr_mean = attr.sum(dim=0) / max(attr.shape[0], 1)
        node_mask = node_mask.float()
        with no_tf32():
            h = self._input_norm(x, dt)
            h = gelu(self._layer_norm(self._linear(h, "input_proj", dt),
                                      "input_ln", dt))
            skip = self._linear(h, "skip_proj", dt)
            for l in range(self.n_layers):
                u = self._gatv2(h, l, src, dst, attr, attr_mean, node_mask,
                                dt, rnd)
                u = gelu(self._layer_norm(u, f"norms.{l}", dt))
                h = self._edge_gate(u, l, dst, attr, dt)
            h = self._global_context(h + skip, node_mask, dt)
            out = self._linear(gelu(self._linear(h, "head_fc1", dt)),
                               "head_fc2", dt)
        return out.float()

