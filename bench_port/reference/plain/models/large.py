"""Large-graph execution path: the models on one 10k+-node graph without
a dense adjacency.

Counterpart of ``gcn_grabcut_tpu/models/large.py``.  ResGCNNet gets the
GCN and SAGE propagations compiled into two `SpmmPlan`s:

* GCN: D^-1/2 (A + I) D^-1/2, the normalisation folded into per-edge
  weights and the self loops added as N diagonal edges of weight 1/d_i;
* mean: per-edge weight 1/deg(dst), no self loops.

A ResGCNNet forward runs n_layers + 1 SpMMs (n_layers GCN + 1 SAGE).
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.graph import GraphBatch
from ..ops.region import segment_sum
from ..ops.spmm import SpmmPlan, banded_spmm, spmm_plan_device

#: band dtype per precision: "default" contracts in bf16 (the JAX default
#: precision), "highest" in exact float32.
PLAN_DTYPES = {"default": torch.bfloat16, "highest": torch.float32}


def _gcn_edge_weights_device(src, dst, mask, n_nodes: int):
    """GCN and mean per-edge weights from a masked edge list."""
    src = src.long().clamp(0, n_nodes - 1)
    dst = dst.long().clamp(0, n_nodes - 1)
    m = mask.float()
    deg = segment_sum(dst, m, n_nodes)     # fixed order on every device
    dhat = deg + 1.0
    dis = torch.rsqrt(dhat)
    g_w = dis[src] * dis[dst] * m          # neighbour term
    loop_w = 1.0 / dhat                    # self-loop term
    m_w = (1.0 / deg.clamp_min(1.0))[dst] * m
    return src, dst, g_w, loop_w, m_w


def build_gcn_plans_device(edge_src, edge_dst, edge_mask, n_nodes: int,
                           block_rows: int = 128, window: int = 512,
                           dtype: torch.dtype = torch.float32
                           ) -> tuple[SpmmPlan, SpmmPlan]:
    """The GCN and mean plans, with tensor ops on the edges' device;
    masked edges carry weight 0 instead of being filtered."""
    src, dst, g_w, loop_w, m_w = _gcn_edge_weights_device(
        edge_src, edge_dst, edge_mask, n_nodes)
    loops = torch.arange(n_nodes, device=src.device)
    gcn_plan = spmm_plan_device(
        torch.cat([src, loops]), torch.cat([dst, loops]),
        torch.cat([g_w, loop_w]), n_nodes, block_rows=block_rows,
        window=window, dtype=dtype)
    mean_plan = spmm_plan_device(src, dst, m_w, n_nodes,
                                 block_rows=block_rows, window=window,
                                 dtype=dtype)
    return gcn_plan, mean_plan


def spmm_aggregators(gcn_plan: SpmmPlan, mean_plan: SpmmPlan):
    """(gcn_propagate, mean_propagate) callables over (1, N, D) batches."""
    def wrap(plan):
        def agg(h):
            return banded_spmm(h[0], plan)[None].to(h.dtype)
        return agg
    return wrap(gcn_plan), wrap(mean_plan)


@torch.no_grad()
def apply_large(model, g: GraphBatch, window: int = 512, plans=None,
                precision: str = "default", device=None) -> torch.Tensor:
    """Forward one large graph (G=1) through `model`; (1, N, n_classes)
    logits.

    A model with `supports_spmm_aggregators` (ResGCNNet) aggregates
    through the banded SpMM: `plans=(gcn_plan, mean_plan)`,
    else built here, with the band in bfloat16 ("default") or float32
    ("highest").  Any other model raises ValueError.  `device` (default:
    the card) must be where the graph and the model live."""
    dev = resolve_device(device)
    if g.device != dev:
        raise ValueError(f"graph is on {g.device}, expected {dev}")
    if g.n_graphs != 1:
        raise ValueError("the large-graph path operates on one graph")
    if not getattr(model, "supports_spmm_aggregators", False):
        raise ValueError(
            f"{type(model).__name__} has no large-graph forward; the "
            "reference's banded path covers ResGCNNet.")
    if plans is None:
        plans = build_gcn_plans_device(
            g.edge_src[0], g.edge_dst[0], g.edge_mask[0], g.max_nodes,
            window=window, dtype=PLAN_DTYPES[precision])
    return model(g, aggregators=spmm_aggregators(*plans))
