"""Large-graph execution path: the models on one 10k+-node graph without
a dense adjacency.

Counterpart of ``gcn_grabcut_tpu/models/large.py``.  Models with SpMM
aggregators (ResGCNNet, GCNTrimapNet) get the GCN and SAGE propagations
compiled into two `SpmmPlan`s:

* GCN: D^-1/2 (A + I) D^-1/2, the normalisation folded into per-edge
  weights and the self loops added as N diagonal edges of weight 1/d_i;
* mean: per-edge weight 1/deg(dst), no self loops.

A ResGCNNet forward runs n_layers + 1 SpMMs (n_layers GCN + 1 SAGE), a
GCNTrimapNet forward n_layers.  GATTrimapNet gets a `GatPlan` instead
(``ops/sddmm.py``): the graph's structure in band slots, its attention
computed banded in every layer.  While a profiler records, the plan's
build opens the span ``layer.forward.plan`` and ``ops.sddmm.counts``
keeps the plan's edge counts.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graph import GraphBatch
from ..ops import sddmm
from ..ops.region import segment_sum
from ..ops.sddmm import GatPlan, gat_plan_device
from ..ops.spmm import SpmmPlan, banded_spmm, spmm_plan, spmm_plan_device
from ..utils import trace_span

#: band dtype per precision: "default" contracts in bf16 (the JAX default
#: precision), "highest" in exact float32.
PLAN_DTYPES = {"default": torch.bfloat16, "highest": torch.float32}


def build_gat_plan_device(edge_src, edge_dst, edge_attr, edge_mask,
                          n_nodes: int, window: int = 512,
                          check_overflow: bool = True) -> GatPlan:
    """The GatPlan of one graph's directed edge list, built on its device.

    The fallback capacity E//2 + 4096 assumes SLIC scan-order labels and
    the default non-local budget (the out-of-window edges are about the
    non-local half).  A graph that breaks the assumption would lose
    attention edges, so the plan's `fb_overflow` is read here (one host
    sync per plan) and an overflowing plan is rebuilt at the exact
    capacity E with a RuntimeWarning.  `check_overflow=False` skips the
    read.  ``ops.sddmm.counts`` records the plan."""
    e_budget = int(edge_src.shape[-1])
    plan = gat_plan_device(edge_src, edge_dst, edge_attr, edge_mask,
                           n_nodes, window=window,
                           fb_capacity=min(e_budget, e_budget // 2 + 4096))
    first_dropped, rebuilt = plan.fb_overflow, False
    if check_overflow:
        dropped = int(plan.fb_overflow[0])
        if dropped > 0:
            warnings.warn(
                f"banded-GAT plan dropped {dropped} out-of-window edges at "
                "the default fallback capacity (non-SLIC-banded graph "
                "structure?); rebuilding with exact capacity — pass a "
                "larger `window` to keep the fallback phase small.",
                RuntimeWarning, stacklevel=2)
            plan = gat_plan_device(edge_src, edge_dst, edge_attr, edge_mask,
                                   n_nodes, window=window,
                                   fb_capacity=e_budget)
            rebuilt = True
    sddmm.counts.record_plan(plan, n_nodes, first_dropped, rebuilt)
    return plan


def build_gcn_plans(edge_src, edge_dst, edge_mask, n_nodes: int,
                    block_rows: int = 128, window: int = 512,
                    dtype: torch.dtype = torch.float32
                    ) -> tuple[SpmmPlan, SpmmPlan]:
    """(gcn_plan, mean_plan) on the host with numpy (the oracle)."""
    edge_src = np.asarray(edge_src, np.int64)
    edge_dst = np.asarray(edge_dst, np.int64)
    keep = np.asarray(edge_mask) > 0
    src, dst = edge_src[keep], edge_dst[keep]
    deg = np.bincount(dst, minlength=n_nodes).astype(np.float64)
    dhat = deg + 1.0
    dis = 1.0 / np.sqrt(dhat)
    loops = np.arange(n_nodes)
    g_w = np.concatenate([dis[src] * dis[dst], 1.0 / dhat]).astype(np.float32)
    gcn_plan = spmm_plan(np.concatenate([src, loops]),
                         np.concatenate([dst, loops]), g_w, n_nodes,
                         block_rows=block_rows, window=window, dtype=dtype)
    m_w = (1.0 / np.maximum(deg, 1.0))[dst].astype(np.float32)
    mean_plan = spmm_plan(src, dst, m_w, n_nodes, block_rows=block_rows,
                          window=window, dtype=dtype)
    return gcn_plan, mean_plan


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
    """`build_gcn_plans` with tensor ops on the edges' device; masked
    edges carry weight 0 instead of being filtered."""
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

    A model with `supports_banded_attention` (GATTrimapNet) runs its
    attention banded over a GatPlan (`plans`, else built here), at
    `precision` ("default": bfloat16 window compute, "highest": float32).
    A model with `supports_spmm_aggregators` (ResGCNNet, GCNTrimapNet)
    aggregates through the banded SpMM: `plans=(gcn_plan, mean_plan)`,
    else built here, with the band in bfloat16 ("default") or float32
    ("highest").  Any other model raises ValueError.  `device` (default:
    the card) must be where the graph and the model live."""
    dev = resolve_device(device)
    if g.device != dev:
        raise ValueError(f"graph is on {g.device}, expected {dev}")
    if g.n_graphs != 1:
        raise ValueError("the large-graph path operates on one graph")
    if getattr(model, "supports_banded_attention", False):
        if plans is None:
            with trace_span("layer.forward.plan"):
                plans = build_gat_plan_device(
                    g.edge_src[0], g.edge_dst[0], g.edge_attr[0],
                    g.edge_mask[0], g.max_nodes, window=window)
        return model(g, gat_plan=plans, gat_precision=precision)
    if not getattr(model, "supports_spmm_aggregators", False):
        raise ValueError(
            f"{type(model).__name__} has no large-graph forward; the "
            "banded paths cover ResGCNNet, GCNTrimapNet (SpMM aggregators) "
            "and GATTrimapNet (banded SDDMM attention).")
    if plans is None:
        plans = build_gcn_plans_device(
            g.edge_src[0], g.edge_dst[0], g.edge_mask[0], g.max_nodes,
            window=window, dtype=PLAN_DTYPES[precision])
    return model(g, aggregators=spmm_aggregators(*plans))
