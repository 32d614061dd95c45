"""Superpixel graph construction: image -> padded graph arrays.

Counterpart of ``gcn_grabcut_tpu/graph_build.py``: colour conversion,
gradients, SLIC, region statistics, node features, adjacency and blocked
non-local edges, and the saliency prior, at static shapes.  The node count
is the SLIC grid size K (empty clusters are masked nodes); the edge budget
is 2·(adjacency budget + K·n_nonlocal) directed slots.  Above
LARGE_K_THRESHOLD (2048) superpixels the k-NN and the prior contrast run
blocked; below it they are dense K x K.

`build_graph_batch_arrays` builds a batch and keeps it on the device;
`build_graph` builds one image into a `RegionGraph`, the host view the
scalar API (the staged `segment`, `predict_probs`) works on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core.device import resolve_device
from .core.graph import GraphBatch, make_graph_batch
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


def num_nodes_for(h: int, w: int, cfg: SuperpixelGraphConfig) -> int:
    return slic_ops.slic_num_labels(h, w, cfg.n_segments)


def edge_budget_for(h: int, w: int, cfg: SuperpixelGraphConfig) -> int:
    k = num_nodes_for(h, w, cfg)
    return 2 * (edge_ops.adjacency_budget(k, cfg.connectivity)
                + edge_ops.nonlocal_budget(k, max(cfg.n_nonlocal, 1)))


def _build_graph_arrays(rgb: torch.Tensor, cfg: SuperpixelGraphConfig
                        ) -> dict:
    """One image. rgb: (H, W, 3) float32 in 0..255."""
    lab = im.rgb_to_lab(rgb)
    segments = slic_ops.slic(lab, n_segments=cfg.n_segments,
                             compactness=cfg.compactness,
                             n_iter=cfg.slic_iters, smooth_sigma=cfg.sigma)
    return _graph_arrays(rgb, lab, segments, cfg)


def _graph_arrays(rgb: torch.Tensor, lab: torch.Tensor,
                  segments: torch.Tensor, cfg: SuperpixelGraphConfig) -> dict:
    """Everything after SLIC: region statistics, features, edges, prior."""
    H, W, _ = rgb.shape
    k = slic_ops.slic_num_labels(H, W, cfg.n_segments)
    hsv = im.rgb_to_hsv(rgb)
    grad = im.gradient_magnitude(im.rgb_to_gray(rgb))
    st = region_ops.region_statistics(segments, lab, hsv, grad, k)
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
        torch.cat([adj_pairs, nl_pairs]), torch.cat([adj_attr, nl_attr]),
        torch.cat([adj_mask, nl_mask]))

    # The geodesic relaxation covers the region grid's diameter (~2·sqrt(K)
    # hops).
    geo_iters = min(int(2 * k ** 0.5) + 8, 96) if cfg.bg_connectivity else 0
    pr = prior_ops.compute_auto_prior(
        segments, k, stats=(st["counts"], st["mean_lab"], st["centroids"]),
        adjacency=(adj_pairs, adj_mask) if cfg.bg_connectivity else None,
        geo_iters=geo_iters)
    return dict(
        segments=segments,
        x=torch.cat([node_feats, pr], dim=1),       # (K, 19)
        edge_src=src, edge_dst=dst, edge_attr=attr, edge_mask=emask,
        node_mask=st["valid"], node_area=st["area_ratio"],
        centroids=st["centroids"], prior=pr, counts=st["counts"],
    )


def build_graph_batch_arrays(rgbs, config: Optional[SuperpixelGraphConfig]
                             = None, device=None) -> dict:
    """(B, H, W, 3) RGB (array or tensor, 0..255) -> dict of batched
    tensors with a leading B axis, on `device` (default: the card)."""
    cfg = config or SuperpixelGraphConfig()
    dev = resolve_device(device)
    rgbs = torch.as_tensor(rgbs, device=dev).float()
    outs = [_build_graph_arrays(rgb, cfg) for rgb in rgbs]
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


@dataclasses.dataclass
class RegionGraph:
    """Host-side view of one built graph: the label map, centroids and
    prior as numpy, the graph itself as a G=1 GraphBatch on the device."""
    segments: np.ndarray          # (H, W) int32
    graph: GraphBatch             # G=1 padded batch; x = 16 image + 3 prior
    centroids: np.ndarray         # (K, 2) normalised (y, x)
    prior: np.ndarray             # (K, 3)
    n_nodes: int                  # K (valid count <= K)

    @property
    def node_mask(self) -> np.ndarray:
        return self.graph.node_mask[0].cpu().numpy()

    @property
    def node_areas(self) -> np.ndarray:
        return self.graph.node_area[0].cpu().numpy()

    def node_input(self) -> np.ndarray:
        """(K, 19) node input: 16 image features, then the 3-d prior."""
        return self.graph.x[0].cpu().numpy()

    def edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(edge_index (2, E_valid), edge_attr (E_valid, 5), the (E,) valid
        mask) over the valid edges."""
        em = self.graph.edge_mask[0].cpu().numpy() > 0
        src = self.graph.edge_src[0].cpu().numpy()[em]
        dst = self.graph.edge_dst[0].cpu().numpy()[em]
        attr = self.graph.edge_attr[0].cpu().numpy()[em]
        return np.stack([src, dst]), attr, em

    def to_networkx(self):
        """The valid subgraph as an undirected networkx graph with `feat`
        node and `attr` edge attributes."""
        import networkx as nx
        x = self.node_input()
        G = nx.Graph()
        for i in np.nonzero(self.node_mask > 0)[0]:
            G.add_node(int(i), feat=x[i])
        edge_index, attr, _ = self.edges()
        for (s, d), a in zip(edge_index.T, attr):
            if s < d:
                G.add_edge(int(s), int(d), attr=a)
        return G

    def to_torch(self) -> dict:
        """CPU tensors in the PyG Data layout: x, edge_index, edge_attr,
        node_area."""
        edge_index, attr, _ = self.edges()
        return dict(
            x=torch.from_numpy(self.node_input()).float(),
            edge_index=torch.from_numpy(edge_index).long(),
            edge_attr=torch.from_numpy(attr).float(),
            node_area=torch.from_numpy(self.node_areas).float(),
        )


def build_graph(image: np.ndarray,
                config: Optional[SuperpixelGraphConfig] = None,
                device=None) -> RegionGraph:
    """Build the attributed superpixel graph of one (H, W, 3) uint8 RGB
    image on `device` (default: the card)."""
    cfg = config or SuperpixelGraphConfig()
    dev = resolve_device(device)
    out = _build_graph_arrays(torch.as_tensor(np.asarray(image), device=dev
                                              ).float(), cfg)
    batch = make_graph_batch(**{key: out[key][None] for key in (
        "x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area")})
    return RegionGraph(
        segments=out["segments"].cpu().numpy().astype(np.int32),
        graph=batch,
        centroids=out["centroids"].cpu().numpy(),
        prior=out["prior"].cpu().numpy(),
        n_nodes=out["x"].shape[0],
    )


SuperpixelGraph = RegionGraph


class GraphBuilder:
    """`GraphBuilder(image, config).build()` -> RegionGraph, the class form
    of `build_graph`."""

    def __init__(self, image: np.ndarray,
                 config: Optional[SuperpixelGraphConfig] = None,
                 device=None):
        self.image = image
        self.config = config or SuperpixelGraphConfig()
        self.device = resolve_device(device)

    def build(self) -> RegionGraph:
        return build_graph(self.image, self.config, device=self.device)
