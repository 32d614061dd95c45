"""End-to-end automatic segmentation: image -> binary mask.

Counterpart of ``gcn_grabcut_tpu/pipeline.py``'s `segment_batch`:
  1. superpixel graph build with its prior;
  2. the ResGCNNet forward (a model or an ensemble) -> posteriors: one
     stacked (B, N, N) dense forward up to LARGE_NODE_THRESHOLD nodes,
     above it the banded-SpMM forward per graph (models/large.py);
     optionally again on the image rescaled (`ms_scales`, dense graphs
     only), the pixel posteriors averaged over the scales;
  3. edge-aware trimap (guided filter) with prior seeding;
  4. GrabCut (GMMs + push-relabel min-cut);
  5. connected-component clean-up and bit-packed output.
Stages stay on the device until the one packed pull at the end.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .core.device import resolve_device, synchronize
from .core.graph import (CLASS_BG, CLASS_FG, TRIMAP_BG, TRIMAP_FG,
                         TRIMAP_PROB_BG, TRIMAP_PROB_FG, GraphBatch,
                         make_graph_batch)
from .grabcut import GrabCutConfig, grabcut_batch_device
from .graph_build import (SuperpixelGraphConfig, build_graph_batch_arrays,
                          num_nodes_for)
from .models.factory import apply_model
from .models.large import apply_large
from .ops import image as im
from .ops.connected import _clean_mask

_STAGED = "comes with ROADMAP queue 1 item 4 (the staged paths)"


@dataclasses.dataclass
class SegmentationResult:
    """All outputs of one pipeline run.  `probs` (the per-superpixel class
    posteriors, (K, 3)) is the port's addition."""
    image: np.ndarray          # original RGB
    binary_mask: np.ndarray    # (H, W) uint8 {0, 1}
    trimap: np.ndarray         # (H, W) uint8 {0, 1, 2, 3}
    segments: Optional[np.ndarray]   # (H, W) superpixel map
    overlay: np.ndarray        # RGB with coloured overlay
    rgba: np.ndarray           # RGBA with transparent background
    timing: dict = dataclasses.field(default_factory=dict)
    probs: Optional[np.ndarray] = None


def _threshold_and_seed(px1, gray, thr_fg, thr_bg, filter_radius: int):
    """(H, W, 4) planes [P(BG), P(FG), seed_fg, seed_bg] -> uint8 trimap:
    guided-filter the posteriors, threshold, and when a probable side is
    missing entirely promote the highest-prior regions to it."""
    p_bg = im.guided_filter(gray, px1[..., 0], filter_radius, 1e-3
                            ).clamp(0, 1)
    p_fg = im.guided_filter(gray, px1[..., 1], filter_radius, 1e-3
                            ).clamp(0, 1)
    tri = torch.where(p_fg > p_bg, TRIMAP_PROB_FG, TRIMAP_PROB_BG)
    tri = torch.where(p_bg >= thr_bg, TRIMAP_BG, tri)
    tri = torch.where(p_fg >= thr_fg, TRIMAP_FG, tri).to(torch.uint8)
    has_fg = ((tri == TRIMAP_FG) | (tri == TRIMAP_PROB_FG)).any()
    has_bg = ((tri == TRIMAP_BG) | (tri == TRIMAP_PROB_BG)).any()
    tri = torch.where(has_fg | (px1[..., 2] <= 0), tri, TRIMAP_PROB_FG
                      ).to(torch.uint8)
    tri = torch.where(has_bg | (px1[..., 3] <= 0), tri, TRIMAP_PROB_BG
                      ).to(torch.uint8)
    return tri


def _seed_planes(prior, nm, seed_frac: float = 0.1) -> torch.Tensor:
    """(K, 2) [seed_fg, seed_bg]: masks of the ~seed_frac highest-prior
    valid regions on each side."""
    n_valid = nm.sum().clamp_min(1.0)
    n_seed = int(torch.round(seed_frac * n_valid).clamp_min(1).item())

    def seed_mask(score):
        s = torch.where(nm > 0, score, -1.0)
        kth = torch.sort(s, descending=True).values[
            min(n_seed - 1, s.shape[0] - 1)]
        return (s >= kth).float()

    return torch.stack([seed_mask(prior[:, 0]), seed_mask(prior[:, 1])],
                       dim=-1)


def _project_probs_device(probs, segments, out_hw: tuple) -> torch.Tensor:
    """(B, K, 3) probs + (B, h, w) segments -> (B, H, W, 2) pixel planes
    [P(BG), P(FG)], bilinearly resized to `out_hw` when the graph was
    built at another scale (the multi-scale path)."""
    px = torch.stack([torch.stack([p[:, CLASS_BG], p[:, CLASS_FG]],
                                  dim=-1).float()[s.long()]
                      for p, s in zip(probs, segments)])
    if tuple(px.shape[1:3]) != tuple(out_hw):
        px = im.resize_bilinear(px, out_hw)
    return px


def _trimap_stage_device(px_probs, segments, grays, priors, node_masks,
                         thr_fg: float, thr_bg: float,
                         filter_radius: int) -> torch.Tensor:
    """(B, H, W, 2) pixel posteriors [P(BG), P(FG)] -> (B, H, W) uint8
    trimaps, the prior seed planes projected from the full-resolution
    graph."""
    out = []
    for px, seg, gray, prior, nm in zip(px_probs, segments, grays, priors,
                                        node_masks):
        seeds = _seed_planes(prior, nm)[seg.long()]
        out.append(_threshold_and_seed(torch.cat([px, seeds], dim=-1), gray,
                                       thr_fg, thr_bg, filter_radius))
    return torch.stack(out)


def _post_stage_device(masks, trimaps, segments, min_area: float,
                       keep_largest: bool, want_segments: bool = True,
                       pfg=None) -> torch.Tensor:
    """Component clean-up + output packing: one (B, bytes) uint8 buffer per
    batch -- the mask at 1 bit/px, the trimap at 2 bits/px and, optionally,
    the label map at 2 bytes/px, in the JAX package's planar layout."""
    cleaned = torch.stack([
        _clean_mask(m, min_area, keep_largest,
                    None if pfg is None else pfg[b])
        for b, m in enumerate(masks)])
    B, H, W = masks.shape
    hw = H * W

    def pack_planar(a, n_planes, bits):
        flat = torch.nn.functional.pad(a.reshape(B, hw).int(),
                                       (0, (-hw) % n_planes))
        planes = flat.reshape(B, n_planes, -1)
        byte = planes[:, 0, :]
        for i in range(1, n_planes):
            byte = byte | (planes[:, i, :] << (i * bits))
        return byte.to(torch.uint8)

    parts = [pack_planar(cleaned, 8, 1), pack_planar(trimaps, 4, 2)]
    if want_segments:
        seg16 = segments.int().reshape(B, hw) & 0xFFFF
        parts += [(seg16 & 0xFF).to(torch.uint8),
                  (seg16 >> 8).to(torch.uint8)]
    return torch.cat(parts, dim=-1)


def _unpack_post_host(packed: np.ndarray, H: int, W: int,
                      want_segments: bool):
    """Host-side inverse of `_post_stage_device`'s bit packing."""
    B = packed.shape[0]
    hw = H * W
    n8, n4 = -(-hw // 8), -(-hw // 4)

    def unpack_planar(byte, n_planes, bits):
        n = byte.shape[1]
        out = np.empty((B, n_planes * n), np.uint8)
        lo_mask = (1 << bits) - 1
        for i in range(n_planes):
            out[:, i * n:(i + 1) * n] = (byte >> (i * bits)) & lo_mask
        return out[:, :hw].reshape(B, H, W)

    masks = unpack_planar(packed[:, :n8], 8, 1)
    trimaps = unpack_planar(packed[:, n8:n8 + n4], 4, 2)
    segments = None
    if want_segments:
        off = n8 + n4
        lo = packed[:, off:off + hw].astype(np.int32)
        hi = packed[:, off + hw:off + 2 * hw].astype(np.int32)
        segments = (lo | (hi << 8)).reshape(B, H, W)
    return masks, trimaps, segments


class GCNGrabCutPipeline:
    """Full GCN-GrabCut segmentation pipeline.

    model     : a ResGCNNet or ResGCNEnsemble holding its weights (e.g.
                from train.checkpoints.load_model_auto, or seeded)
    sp_config : SuperpixelGraphConfig
    gc_config : GrabCutConfig
    device    : where every stage runs; default the card (raises without
                CUDA unless device="cpu")
    """

    # Above this many superpixels the forward runs the banded-SpMM path.
    LARGE_NODE_THRESHOLD = 2048

    def __init__(self, model, sp_config: Optional[SuperpixelGraphConfig]
                 = None, gc_config: Optional[GrabCutConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.sp_config = sp_config or SuperpixelGraphConfig()
        self.gc_config = gc_config or GrabCutConfig()

    def predict_probs(self, graph: GraphBatch) -> torch.Tensor:
        """(G, N, 3) softmax class probabilities: one stacked dense forward,
        or above LARGE_NODE_THRESHOLD one banded-SpMM forward per graph."""
        if graph.max_nodes > self.LARGE_NODE_THRESHOLD:
            logits = torch.cat([apply_large(self.model, graph.graph(b),
                                            device=self.device)
                                for b in range(graph.n_graphs)])
        else:
            logits = apply_model(self.model, graph)
        return torch.softmax(logits.float(), dim=-1)

    def _graph(self, rgbs):
        """(graph-build outputs, GraphBatch) of a (B, H, W, 3) batch."""
        out = build_graph_batch_arrays(rgbs, self.sp_config,
                                       device=self.device)
        return out, make_graph_batch(
            x=out["x"], edge_src=out["edge_src"], edge_dst=out["edge_dst"],
            edge_attr=out["edge_attr"], node_mask=out["node_mask"],
            edge_mask=out["edge_mask"], node_area=out["node_area"])

    def segment(self, image: np.ndarray, threshold_fg: float = 0.55,
                threshold_bg: float = 0.55, refine_iters: int = 0,
                min_area_ratio: float = 0.002, keep_largest: bool = False,
                edge_aware: bool = True, filter_radius: int = 8,
                ms_scales: tuple | None = None) -> SegmentationResult:
        """Image in -> mask out, through `segment_batch` at B=1."""
        if not edge_aware or refine_iters:
            raise NotImplementedError(f"the staged scalar path {_STAGED}")
        return self.segment_batch(
            [image], threshold_fg=threshold_fg, threshold_bg=threshold_bg,
            min_area_ratio=min_area_ratio, keep_largest=keep_largest,
            filter_radius=filter_radius, ms_scales=ms_scales)[0]

    def segment_batch(self, images: list, threshold_fg: float = 0.55,
                      threshold_bg: float = 0.55,
                      min_area_ratio: float = 0.002,
                      keep_largest: bool = False, filter_radius: int = 8,
                      want_segments: bool = True,
                      ms_scales: tuple | None = None,
                      sync_timing: bool = False) -> list[SegmentationResult]:
        """Segment a batch of same-size images, device-resident end to end.

        `sync_timing=True` synchronises the device at each stage boundary,
        so the per-stage times in `timing` are device times rather than
        enqueue times."""
        handle = self._dispatch_batch(
            images, threshold_fg=threshold_fg, threshold_bg=threshold_bg,
            min_area_ratio=min_area_ratio, keep_largest=keep_largest,
            filter_radius=filter_radius, want_segments=want_segments,
            sync_timing=sync_timing, ms_scales=ms_scales)
        return self._finalize_batch(handle)

    def _dispatch_batch(self, images, threshold_fg, threshold_bg,
                        min_area_ratio, keep_largest, filter_radius,
                        want_segments, sync_timing, ms_scales=None):
        """Run every device stage; the packed output stays on the device."""
        if not images:
            raise ValueError("empty batch")
        H, W = images[0].shape[:2]
        if any(x.shape[:2] != (H, W) for x in images):
            raise ValueError("segment_batch requires same-size images "
                             "(resize upstream)")
        large = num_nodes_for(H, W, self.sp_config) > self.LARGE_NODE_THRESHOLD
        # Multi-scale inference reruns the dense forward only; on a large
        # graph ms_scales is ignored, as in the JAX package.
        multi_scale = ms_scales is not None and len(ms_scales) > 1 and (
            not large)
        if multi_scale and ms_scales[0] != 1.0:
            raise ValueError("ms_scales[0] must be 1.0")
        dev = self.device
        timing: dict = {}

        def stage_done(name, t):
            if sync_timing:
                synchronize(dev)
            timing[name] = time.perf_counter() - t

        t = time.perf_counter()
        rgbs = torch.as_tensor(np.stack(images), device=dev).float()
        out, batch = self._graph(rgbs)
        stage_done("graph_build", t)

        t = time.perf_counter()
        probs = self.predict_probs(batch)
        segments = out["segments"]
        px = _project_probs_device(probs, segments, (H, W))
        if multi_scale:
            # Rebuild the graph and rerun the forward at each reduced
            # scale, resize its pixel posteriors back, and average.
            px_list = [px]
            for sc in ms_scales[1:]:
                hw = (max(int(round(H * sc)), 64), max(int(round(W * sc)), 64))
                out_s, batch_s = self._graph(im.resize_bilinear(rgbs, hw))
                px_list.append(_project_probs_device(
                    self.predict_probs(batch_s), out_s["segments"], (H, W)))
            px = torch.stack(px_list).mean(dim=0)
        grays = im.rgb_to_gray(rgbs) / 255.0
        trimaps = _trimap_stage_device(
            px, segments, grays, out["prior"], out["node_mask"],
            threshold_fg, threshold_bg, filter_radius)
        # keep_largest reads the same plane the thresholds see.
        pfg_px = px[..., 1] if keep_largest else None
        stage_done("gcn_inference", t)

        t = time.perf_counter()
        masks = grabcut_batch_device(rgbs, trimaps, self.gc_config)
        stage_done("grabcut", t)

        t = time.perf_counter()
        packed = _post_stage_device(masks, trimaps, segments,
                                    float(min_area_ratio * H * W),
                                    keep_largest, want_segments, pfg_px)
        stage_done("postprocess", t)
        return {"packed": packed, "probs": probs, "images": images,
                "H": H, "W": W, "want_segments": want_segments,
                "timing": timing}

    def _finalize_batch(self, handle) -> list[SegmentationResult]:
        """Pull the packed buffer (the one device-to-host transfer) and
        assemble SegmentationResults."""
        timing = dict(handle["timing"])
        t = time.perf_counter()
        packed = handle["packed"].cpu().numpy()
        probs = handle["probs"].cpu().numpy()
        masks_np, trimaps_np, segments_np = _unpack_post_host(
            packed, handle["H"], handle["W"], handle["want_segments"])
        timing["postprocess"] = timing.get("postprocess", 0.0) + (
            time.perf_counter() - t)

        results = []
        tint = np.array([0, 220, 100], np.float32)
        for b, image in enumerate(handle["images"]):
            mask = masks_np[b]
            binary = mask[..., None].astype(np.float32)
            overlay = np.clip(image * (1 - 0.45 * binary)
                              + tint * 0.45 * binary, 0, 255).astype(np.uint8)
            rgba = np.concatenate([image, (mask * 255)[..., None]],
                                  axis=-1).astype(np.uint8)
            results.append(SegmentationResult(
                image=image, binary_mask=mask, trimap=trimaps_np[b],
                segments=None if segments_np is None else segments_np[b],
                overlay=overlay, rgba=rgba, timing=dict(timing),
                probs=probs[b]))
        return results
