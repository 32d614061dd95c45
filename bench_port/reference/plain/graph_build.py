"""Superpixel graph construction: image -> padded graph arrays.

Counterpart of ``gcn_grabcut_tpu/graph_build.py``: colour conversion,
gradients, SLIC, region statistics, node features, adjacency and blocked
non-local edges, and the saliency prior, at static shapes.  The node count
is the SLIC grid size K (empty clusters are masked nodes); the edge budget
is 2·(adjacency budget + K·n_nonlocal) directed slots.  Above
LARGE_K_THRESHOLD (2048) superpixels the k-NN and the prior contrast run
blocked; below it they are dense K x K.

`_graph_arrays` builds the after-SLIC half of a batch as (B, ...) tensors
on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops import edges as edge_ops
from .ops import image as im
from .ops import prior as prior_ops
from .ops import region as region_ops
from .ops import slic as slic_ops


@dataclasses.dataclass(frozen=True)
class SuperpixelGraphConfig:
    """Same fields and defaults as the JAX package's config."""
    n_segments: int = 300
    compactness: float = 10.0
    sigma: float = 1.0
    use_lab: bool = True
    connectivity: int = 4
    n_nonlocal: int = 4
    slic_iters: int = 10
    bg_connectivity: bool = False


def _graph_arrays(rgbs: torch.Tensor, labs: torch.Tensor,
                 segments: torch.Tensor, cfg: SuperpixelGraphConfig) -> dict:
    """Everything after SLIC for a batch: (B, H, W, 3) RGB and Lab and
    (B, H, W) labels -> region statistics, features, edges and prior,
    each with a leading B axis."""
    B, H, W, _ = rgbs.shape
    k = slic_ops.slic_num_labels(H, W, cfg.n_segments)
    hsv = im.rgb_to_hsv(rgbs)
    grad = im.gradient_magnitude(im.rgb_to_gray(rgbs))
    st = region_ops.region_statistics(segments, labs, hsv, grad, k)
    node_feats = region_ops.assemble_node_features(st)

    adj_pairs, shared, adj_mask = edge_ops.adjacency_pairs(
        segments, k, cfg.connectivity)
    adj_attr = edge_ops.pair_features(adj_pairs, adj_mask, st, shared,
                                      torch.zeros_like(shared))
    nl_k = max(cfg.n_nonlocal, 1)
    if k > prior_ops.LARGE_K_THRESHOLD:
        # SLIC grid order bounds adjacent labels to ±(gw + 1).
        _, gw = slic_ops.grid_shape(H, W, cfg.n_segments)
        nl_pairs, nl_mask = edge_ops.nonlocal_pairs_banded(
            st["mean_lab"], st["valid"], k, nl_k, exclude_window=gw + 1)
    else:
        nl_pairs, nl_mask = edge_ops.nonlocal_pairs(
            adj_pairs, adj_mask, st["mean_lab"], st["valid"], k, nl_k)
    if cfg.n_nonlocal <= 0:
        nl_mask = torch.zeros_like(nl_mask)
    nl_attr = edge_ops.pair_features(nl_pairs, nl_mask, st,
                                     torch.zeros_like(nl_mask),
                                     torch.ones_like(nl_mask))
    src, dst, attr, emask = edge_ops.symmetrise(
        torch.cat([adj_pairs, nl_pairs], dim=1),
        torch.cat([adj_attr, nl_attr], dim=1),
        torch.cat([adj_mask, nl_mask], dim=1))

    # The geodesic relaxation covers the region grid's diameter (~2·sqrt(K)
    # hops).
    geo_iters = min(int(2 * k ** 0.5) + 8, 96) if cfg.bg_connectivity else 0
    pr = prior_ops.compute_auto_prior(
        segments, k, stats=(st["counts"], st["mean_lab"], st["centroids"]),
        adjacency=(adj_pairs, adj_mask) if cfg.bg_connectivity else None,
        geo_iters=geo_iters)
    return dict(
        segments=segments,
        x=torch.cat([node_feats, pr], dim=-1),      # (B, K, 19)
        edge_src=src, edge_dst=dst, edge_attr=attr, edge_mask=emask,
        node_mask=st["valid"], node_area=st["area_ratio"],
        centroids=st["centroids"], prior=pr, counts=st["counts"],
    )
