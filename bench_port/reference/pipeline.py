"""The plain reference of one image through the whole path.

Runs the stages `GCNGrabCutPipeline.segment_batch` runs, one image at a
time, on the frozen plain copy in `plain/` (no kernel of the program, no
code of the program): the superpixel graph build, the forward (the dense
one up to 2048 nodes, above it the banded SpMM's plain form), the
edge-aware trimap with prior seeding, GrabCut with the plain push-relabel
min-cut, and the component clean-up.

`lower=True` is the control: the same path in the nearest precision below
the one the configuration states, at every stage the comparison reads.
The Lab image that SLIC and the region statistics read is rounded to
bfloat16; the forward's Linear, LayerNorm and InputNorm compute in
bfloat16 (stated: float32), and on the large path the SpMM band and its
operands round to float8 e4m3 (stated: bfloat16); GrabCut's pixel sums run
in float32 (stated: float64).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .plain.core.graph import (CLASS_BG, CLASS_FG, TRIMAP_BG, TRIMAP_FG,
                               TRIMAP_PROB_BG, TRIMAP_PROB_FG,
                               make_graph_batch)
from .plain.grabcut import GrabCutConfig, grabcut_batch_device
from .plain.graph_build import SuperpixelGraphConfig, _graph_arrays
from .plain.models import large
from .plain.models.factory import apply_model
from .plain.ops import gmm
from .plain.ops import image as im
from .plain.ops import slic as slic_ops
from .plain.ops.connected import _clean_mask, _per_image
from .plain.train.checkpoints import load_model_auto

#: Nodes above which the program takes the large-graph forward.
LARGE_NODE_THRESHOLD = 2048


def load_model(paths: list, device, lower: bool = False):
    """The configuration's model from its checkpoints, read by the plain
    copy's own msgpack decoder; the control's computes in bfloat16."""
    model, _ = load_model_auto([str(p) for p in paths], device=device,
                               dtype=torch.bfloat16 if lower else None)
    return model.eval()


@contextlib.contextmanager
def _float32_pixel_sums():
    """GrabCut's float64 pixel sums taken in float32 (the control)."""
    saved = gmm._pixel_sum, gmm._pixel_matmul
    gmm._pixel_sum = lambda a: a.float().sum(dim=-2)
    gmm._pixel_matmul = lambda onehot, x: (
        onehot.float().transpose(-1, -2) @ x.float())
    try:
        yield
    finally:
        gmm._pixel_sum, gmm._pixel_matmul = saved


def _build(rgbs: torch.Tensor, cfg: SuperpixelGraphConfig, lower: bool
           ) -> dict:
    labs = im.rgb_to_lab(rgbs)
    if lower:
        labs = labs.to(torch.bfloat16).float()
    segments = slic_ops.slic(labs, n_segments=cfg.n_segments,
                             compactness=cfg.compactness,
                             n_iter=cfg.slic_iters, smooth_sigma=cfg.sigma)
    return _graph_arrays(rgbs, labs, segments, cfg)


def _graph_batch(out: dict):
    return make_graph_batch(**{k: out[k] for k in (
        "x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area")})


def _probs(model, graph, lower: bool) -> torch.Tensor:
    """(1, N, 3) softmax posteriors of one graph."""
    if graph.max_nodes > LARGE_NODE_THRESHOLD:
        plans = large.build_gcn_plans_device(
            graph.edge_src[0], graph.edge_dst[0], graph.edge_mask[0],
            graph.max_nodes, dtype=torch.bfloat16)
        if lower:
            plans = tuple(dataclasses.replace(
                p, band=p.band.to(torch.float8_e4m3fn)) for p in plans)
        with torch.no_grad():
            logits = large.apply_large(model, graph, plans=plans,
                                       device=graph.x.device)
    else:
        logits = apply_model(model, graph)
    return torch.softmax(logits.float(), dim=-1)


def _project_probs(probs, segments, out_hw: tuple) -> torch.Tensor:
    b = torch.arange(probs.shape[0], device=probs.device)[:, None, None]
    px = torch.stack([probs[..., CLASS_BG], probs[..., CLASS_FG]],
                     dim=-1).float()[b, segments.long()]
    if tuple(px.shape[1:3]) != tuple(out_hw):
        px = im.resize_bilinear(px, out_hw)
    return px


def _seed_planes(prior, nm, seed_frac: float = 0.1) -> torch.Tensor:
    K = nm.shape[-1]
    n_valid = nm.sum(dim=-1).clamp_min(1.0)
    n_seed = torch.round(seed_frac * n_valid).clamp_min(1).long()
    pick = (n_seed - 1).clamp_max(K - 1)[:, None]

    def seed_mask(score):
        s = torch.where(nm > 0, score, -1.0)
        kth = torch.sort(s, dim=-1, descending=True).values.gather(-1, pick)
        return (s >= kth).float()

    return torch.stack([seed_mask(prior[..., 0]), seed_mask(prior[..., 1])],
                       dim=-1)


def _trimap(px, segments, gray, prior, node_mask, thr: float, radius: int,
            eps: float = 1e-3) -> torch.Tensor:
    b = torch.arange(px.shape[0], device=px.device)[:, None, None]
    seeds = _seed_planes(prior, node_mask)[b, segments.long()]
    p_bg = im.guided_filter(gray, px[..., 0], radius, eps).clamp(0, 1)
    p_fg = im.guided_filter(gray, px[..., 1], radius, eps).clamp(0, 1)
    tri = torch.where(p_fg > p_bg, TRIMAP_PROB_FG, TRIMAP_PROB_BG)
    tri = torch.where(p_bg >= thr, TRIMAP_BG, tri)
    tri = torch.where(p_fg >= thr, TRIMAP_FG, tri).to(torch.uint8)
    has_fg = ((tri == TRIMAP_FG) | (tri == TRIMAP_PROB_FG)).flatten(1).any(1)
    has_bg = ((tri == TRIMAP_BG) | (tri == TRIMAP_PROB_BG)).flatten(1).any(1)
    tri = torch.where(_per_image(has_fg) | (seeds[..., 0] <= 0), tri,
                      TRIMAP_PROB_FG).to(torch.uint8)
    return torch.where(_per_image(has_bg) | (seeds[..., 1] <= 0), tri,
                       TRIMAP_PROB_BG).to(torch.uint8)


@torch.no_grad()
def segment(image: np.ndarray, model, settings: dict, device,
            lower: bool = False) -> dict:
    """One (H, W, 3) uint8 image -> numpy `segments`, node input `x`,
    posteriors `probs` (valid nodes by `node_mask`), `trimap`, `grabcut`
    (the mask before clean-up) and `mask` (after it).  `settings`: the
    configuration's n_segments, bg_connectivity, threshold, filter_radius,
    ms_scales and min_area_ratio."""
    cfg = SuperpixelGraphConfig(n_segments=settings["n_segments"],
                                bg_connectivity=settings["bg_connectivity"])
    rgbs = torch.as_tensor(image[None], device=device).float()
    H, W = image.shape[:2]
    out = _build(rgbs, cfg, lower)
    probs = _probs(model, _graph_batch(out), lower)
    px = _project_probs(probs, out["segments"], (H, W))
    scales = settings.get("ms_scales") or (1.0,)
    if len(scales) > 1 and out["x"].shape[1] <= LARGE_NODE_THRESHOLD:
        px_list = [px]
        for sc in scales[1:]:
            hw = (max(int(round(H * sc)), 64), max(int(round(W * sc)), 64))
            out_s = _build(im.resize_bilinear(rgbs, hw), cfg, lower)
            px_list.append(_project_probs(
                _probs(model, _graph_batch(out_s), lower), out_s["segments"],
                (H, W)))
        px = torch.stack(px_list).mean(dim=0)
    gray = im.rgb_to_gray(rgbs) / 255.0
    thr = settings["threshold"]
    trimap = _trimap(px, out["segments"], gray, out["prior"],
                     out["node_mask"], thr, settings["filter_radius"])
    with (_float32_pixel_sums() if lower else contextlib.nullcontext()):
        cut = grabcut_batch_device(rgbs, trimap, GrabCutConfig())
    mask = _clean_mask(cut, float(settings["min_area_ratio"] * H * W),
                       False, None)
    return {"segments": out["segments"][0].cpu().numpy(),
            "x": out["x"][0].cpu().numpy(),
            "node_mask": out["node_mask"][0].cpu().numpy() > 0,
            "probs": probs[0].cpu().numpy(),
            "trimap": trimap[0].cpu().numpy(),
            "grabcut": cut[0].cpu().numpy(),
            "mask": mask[0].cpu().numpy()}
