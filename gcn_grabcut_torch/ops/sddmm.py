"""Banded SDDMM attention: GATv2 message passing on graphs too large for
the dense path.

Counterpart of ``gcn_grabcut_tpu/ops/sddmm.py``.  SLIC numbers superpixels
in grid scan order, so almost every edge (src -> dst) lies in a window of
K blocks of R rows around its destination's block.  The graph, fixed
across layers, is compiled once into slot storage:

    attr_band[k, d, s] = attributes of the edge (src = (d//R + k - K//2)·R
                                                   + s -> dst = d)
    mask_band[k, d, s] = 1.0 where that slot holds a real edge

and per layer the scores are computed densely over each offset's window
from shifted views of the node features (no gathers), the softmax runs
over the slots, and the weighted sum is a batched matmul per block.  The
edges outside the window keep the edge-list form over a compacted,
destination-sorted list; the three parts (window, fallback, the self loop
filled with the mean edge attribute) share one peak per destination and
merge exactly (log-sum-exp).

This is PyTorch on the tensors' device, not a hand-written kernel: the
JAX package's version was never a Pallas kernel either (XLA fused it).

A slot holds one edge.  The graph build's edge list is not always
deduplicated (above 2048 nodes an adjacency edge can also be a non-local
k-NN edge: 38 of 27 068 at 320² / 2600), and the JAX package's plan
adds a repeated edge's attributes and mask into its slot, so that its
banded softmax counts exp(score(2·attr))·2 where the edge list counts
2·exp(score(attr)).  Here the first of a slot's edges (in edge order)
takes the slot and every repeat goes to the fallback list, so the banded
form computes the edge list's function on any graph; on a deduplicated
graph the plan is the JAX package's, array for array.

While a profiler records, each attention call opens the span
``layer.forward.attention`` and `counts` keeps each plan's edge counts
(``models.large.build_gat_plan_device``) and each call's shape.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.scatter import NEG_INF
from ..utils import Recorder, trace_span
from .region import Segments, segment_sum

#: What `AttentionCounts.plans` holds of each plan, beside `rebuilt`.
PLAN_COUNTS = ("in_window", "fallback", "dropped")


@dataclasses.dataclass
class GatPlan:
    """Compiled banded slot storage of one graph's attention structure."""
    n_nodes: int                # padded to a multiple of block_rows
    block_rows: int             # R
    k_blocks: int               # K (window = K·R)
    attr_band: torch.Tensor     # (K, Np, R, A) float32 edge attributes
    mask_band: torch.Tensor     # (K, Np, R) 1.0 where a real edge sits
    fb_src: torch.Tensor        # (FB,) int64 out-of-window edges,
    fb_dst: torch.Tensor        # (FB,) destination-sorted
    fb_attr: torch.Tensor       # (FB, A)
    fb_mask: torch.Tensor       # (FB,)
    attr_mean: torch.Tensor     # (A,) mean attributes of real edges
    fb_overflow: torch.Tensor   # (1,) int32 fallback edges dropped

    @property
    def n_blocks(self) -> int:
        return self.n_nodes // self.block_rows

    @property
    def window(self) -> int:
        return self.k_blocks * self.block_rows


class AttentionCounts(Recorder):
    """The banded attention's plans and calls, recorded as
    `utils.Recorder` says: after `reset()` and while a torch profiler
    records.  A plan is kept as its node slots, a small device tensor of
    its `PLAN_COUNTS` (no sync when recorded) and whether it was rebuilt
    at the exact capacity; a call as its (Np, K, R, H, F, FB)."""

    def _clear(self) -> None:
        self._plans: list = []
        self.calls: list = []

    def record_plan(self, plan: GatPlan, n_nodes: int, dropped,
                    rebuilt: bool) -> None:
        """`plan` built for `n_nodes` node slots; `dropped` the fallback
        edges the first build dropped (a (1,) tensor)."""
        if self.active:
            counts = torch.stack([plan.mask_band.sum(), plan.fb_mask.sum(),
                                  dropped.reshape(()).float()])
            self._plans.append((n_nodes, counts, rebuilt))

    @property
    def plans(self) -> list:
        """One dict a plan: nodes, in_window, fallback, dropped, rebuilt
        (a host read)."""
        return [dict(nodes=n, rebuilt=r,
                     **dict(zip(PLAN_COUNTS, map(int, c.tolist()))))
                for n, c, r in self._plans]

    def totals(self) -> dict:
        """Plans and rebuilt plans recorded, their edge counts summed, and
        the attention calls."""
        plans = self.plans
        out = dict(plans=len(plans), rebuilt=sum(p["rebuilt"] for p in plans))
        out.update({k: sum(p[k] for p in plans) for k in PLAN_COUNTS})
        return dict(out, calls=len(self.calls))


#: The plans and attention calls recorded since ``counts.reset()``, and
#: those made while a profiler records.
counts = AttentionCounts()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gat_plan_device(src, dst, attr, mask, n_nodes: int,
                    block_rows: int = 128, window: int = 512,
                    fb_capacity: int | None = None) -> GatPlan:
    """Compile a (src -> dst, attr, mask) edge list into a `GatPlan` with
    tensor ops on the edges' device (no host pull).

    The slots fill through ``segment_sum`` (fixed order: two builds give
    the same bits); a slot's repeated edges join the fallback list.
    `fb_capacity` bounds that list (default every edge, always exact);
    edges beyond it are dropped and counted in `fb_overflow`.  Masked
    tail entries of the list get destination Np - 1, so the list stays
    sorted."""
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    n_edges = src.shape[0]
    n_pad = _round_up(max(n_nodes, block_rows), block_rows)
    R, K = block_rows, max(1, -(-window // block_rows))
    fb_capacity = n_edges if fb_capacity is None else fb_capacity
    fb_capacity = max(8, min(int(fb_capacity), n_edges))

    src = src.long().clamp(0, n_pad - 1)
    dst = dst.to(src.device).long().clamp(0, n_pad - 1)
    m = torch.as_tensor(mask, device=src.device).float()
    attr = torch.as_tensor(attr, device=src.device).float()
    a_dim = attr.shape[-1]

    k = src // R - dst // R + K // 2
    in_w = (k >= 0) & (k < K) & (m > 0)
    n_slots = K * n_pad * R
    idx = torch.where(in_w, (k * n_pad + dst) * R + src % R,
                      torch.full_like(k, n_slots))
    # The first edge of each slot in edge order keeps it; repeats fall
    # back to the edge list.
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    repeat = torch.zeros_like(in_w)
    repeat[order[1:]] = (sorted_idx[1:] == sorted_idx[:-1]) \
        & (sorted_idx[1:] < n_slots)
    in_w = in_w & ~repeat
    idx = torch.where(in_w, idx, torch.zeros_like(idx))
    w_in = in_w.float()
    flat = segment_sum(idx, torch.cat([attr * w_in[:, None], w_in[:, None]],
                                      dim=1), n_slots)
    attr_band = flat[:, :a_dim].reshape(K, n_pad, R, a_dim)
    mask_band = flat[:, a_dim].reshape(K, n_pad, R)

    # Out-of-window real edges first, each part by destination: one
    # stable sort on a single key.
    is_fb = (m > 0) & ~in_w
    key = torch.where(is_fb, dst, n_pad + 1 + dst)
    fb_order = torch.argsort(key, stable=True)[:fb_capacity]
    fb_mask = is_fb[fb_order].float()
    overflow = (is_fb.float().sum() - fb_mask.sum()).int()
    fb_dst = torch.where(fb_mask > 0, dst[fb_order],
                         torch.full_like(fb_order, n_pad - 1))
    attr_mean = (attr * m[:, None]).sum(dim=0) / m.sum().clamp_min(1.0)
    return GatPlan(n_nodes=n_pad, block_rows=R, k_blocks=K,
                   attr_band=attr_band, mask_band=mask_band,
                   fb_src=src[fb_order], fb_dst=fb_dst,
                   fb_attr=attr[fb_order] * fb_mask[:, None],
                   fb_mask=fb_mask, attr_mean=attr_mean,
                   fb_overflow=overflow[None])


def _shifted_view(x_pad: torch.Tensor, k: int, n: int, R: int
                  ) -> torch.Tensor:
    """Offset k's (nb, R, D) block view of the padded rows (JAX
    ``_shifted_views_flat``, one offset at a time)."""
    return x_pad[k * R:k * R + n].reshape(n // R, R, x_pad.shape[1])


def _scores(z: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """att_h . z over the last axis as float32 products of the operands'
    values, summed in float32 (JAX's einsum with
    ``preferred_element_type=float32``)."""
    return (z.float() * att.float()).sum(dim=-1)


def banded_gat_attention(xl: torch.Tensor, xr: torch.Tensor, plan: GatPlan,
                         project_edge, att: torch.Tensor,
                         node_mask: torch.Tensor,
                         negative_slope: float = 0.2,
                         precision: str = "default") -> torch.Tensor:
    """GATv2 attention aggregation over a banded plan:
    out_i = sum_j alpha_ij (W_l x)_j + alpha_ii (W_l x)_i, the alpha the
    softmax per destination of att . LeakyReLU(W_l x_j + W_r x_i +
    W_e attr_ij) over its in-edges and the self loop, as `GATv2Conv`'s
    edge-list form.

    xl, xr       (N, H, F) projected node features
    project_edge callable (..., A) -> (..., H·F), W_e
    att          (H, F)
    node_mask    (N,)
    precision    "default": the window tensors and messages in bfloat16,
                 the contractions as float32 products of bfloat16 values
                 summed in float32, the softmax statistics in float32;
                 "highest": everything in float32.

    Memory: one offset's (nb, R, R, H·F) z tensor at a time (331 MB in
    bfloat16 at 10 000 nodes); the K score tensors (nb, R, R, H) float32
    are kept for the merge."""
    if precision not in ("default", "highest"):
        raise ValueError(f"precision must be 'default' or 'highest', "
                         f"got {precision!r}")
    if counts.active:
        counts.calls.append((plan.n_nodes, plan.k_blocks, plan.block_rows,
                             *xl.shape[1:], plan.fb_src.shape[0]))
    with trace_span("layer.forward.attention"):
        return _attend(xl, xr, plan, project_edge, att, node_mask,
                       negative_slope,
                       torch.float32 if precision == "highest"
                       else torch.bfloat16)


def _attend(xl, xr, plan: GatPlan, project_edge, att, node_mask,
            negative_slope: float, cdt: torch.dtype) -> torch.Tensor:
    """`banded_gat_attention` with its window dtype `cdt`."""
    N, H, Fh = xl.shape
    R, K, Np = plan.block_rows, plan.k_blocks, plan.n_nodes
    nb = Np // R
    if N < Np:
        xl = F.pad(xl, (0, 0, 0, 0, 0, Np - N))
        xr = F.pad(xr, (0, 0, 0, 0, 0, Np - N))
        node_mask = F.pad(node_mask, (0, Np - N))
    out_dtype = xl.dtype
    xl, xr = xl.to(cdt), xr.to(cdt)
    xl_flat = xl.reshape(Np, H * Fh)
    att_c = att.float().to(cdt)
    off0 = K // 2
    xl_pad = F.pad(xl_flat, (0, 0, off0 * R, (K - 1 - off0) * R))
    xr_b = xr.reshape(nb, R, 1, H, Fh)

    # Window scores, one offset at a time, dense over the slots.
    scores = []
    band_peak = None
    for k in range(K):
        ea_k = project_edge(plan.attr_band[k]).to(cdt).reshape(
            nb, R, R, H, Fh)
        xs_k = _shifted_view(xl_pad, k, Np, R).reshape(nb, 1, R, H, Fh)
        z = F.leaky_relu(ea_k + xs_k + xr_b, negative_slope)
        del ea_k
        s_k = torch.where(plan.mask_band[k].reshape(nb, R, R, 1) > 0,
                          _scores(z, att_c), NEG_INF)
        del z
        scores.append(s_k)
        p_k = s_k.amax(dim=2)
        band_peak = p_k if band_peak is None else torch.maximum(band_peak,
                                                                p_k)
    band_peak = band_peak.reshape(Np, H)

    # Fallback scores over the compacted out-of-window list.
    ea_fb = project_edge(plan.fb_attr).to(cdt).reshape(-1, H, Fh)
    z_fb = F.leaky_relu(xl[plan.fb_src] + xr[plan.fb_dst] + ea_fb,
                        negative_slope)
    s_fb = torch.where(plan.fb_mask[:, None] > 0, _scores(z_fb, att_c),
                       NEG_INF)
    fb_segs = Segments(plan.fb_dst, Np, is_sorted=True)
    fb_peak = fb_segs.max(s_fb)
    fb_peak = torch.where(torch.isfinite(fb_peak), fb_peak, NEG_INF)

    # The self loop, its attribute the mean edge attribute.
    ea_loop = project_edge(plan.attr_mean).to(cdt).reshape(1, H, Fh)
    sl = _scores(F.leaky_relu(xl + xr + ea_loop, negative_slope), att_c)
    sl = torch.where(node_mask[:, None] > 0, sl, NEG_INF)

    # One peak per destination; the three parts merge exactly.
    peak = torch.maximum(torch.maximum(band_peak, fb_peak), sl)
    peak_b = peak.reshape(nb, R, 1, H)
    band_sum = torch.zeros((nb, R, H), device=xl.device)
    band_msg = torch.zeros((nb, H, R, Fh), device=xl.device)
    for k in range(K):
        esc = torch.exp(scores[k] - peak_b) \
            * plan.mask_band[k].reshape(nb, R, R, 1)      # (nb, Rd, Rs, H)
        band_sum = band_sum + esc.sum(dim=2)
        xs_k = _shifted_view(xl_pad, k, Np, R).reshape(nb, R, H, Fh)
        band_msg = band_msg + torch.matmul(
            esc.to(cdt).float().permute(0, 3, 1, 2),        # (nb, H, Rd, Rs)
            xs_k.float().permute(0, 2, 1, 3))               # (nb, H, Rs, F)
    band_sum = band_sum.reshape(Np, H)
    band_msg = band_msg.permute(0, 2, 1, 3).reshape(Np, H, Fh)

    exf = torch.exp(s_fb - peak[plan.fb_dst]) * plan.fb_mask[:, None]
    fb_sum = fb_segs.sum(exf)
    # The messages are products in the compute dtype (flat (FB, H·F), the
    # attention repeated per head), summed in float32.
    fb_msg = (exf.to(cdt).repeat_interleave(Fh, dim=1)
              * xl_flat[plan.fb_src]).float()
    fb_msg = fb_segs.sum(fb_msg).reshape(Np, H, Fh)

    exl = torch.exp(sl - peak) * node_mask[:, None]
    tot = band_sum + fb_sum + exl
    out = (band_msg + fb_msg + exl[:, :, None] * xl.float()) \
        / (tot[:, :, None] + 1e-12)
    return out[:N].to(out_dtype)
