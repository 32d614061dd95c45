"""End-to-end automatic segmentation: image -> binary mask.

Counterpart of ``gcn_grabcut_tpu/pipeline.py``.  `segment_batch` (and
`segment` in its default options, at B=1) runs:
  1. superpixel graph build with its prior, the batch as (B, ...)
     tensors in one pass with no host sync;
  2. the model's forward (ResGCNNet, GCNTrimapNet, GATTrimapNet or an
     ensemble) -> posteriors: one stacked dense forward up to
     LARGE_NODE_THRESHOLD nodes, above it the large-graph forward per
     graph (models/large.py: banded SpMM or banded attention);
     optionally again on the image rescaled (`ms_scales`, dense graphs
     only), the pixel posteriors averaged over the scales;
  3. edge-aware trimap (guided filter) with prior seeding;
  4. GrabCut (GMMs + push-relabel min-cut), the batch in lock step up to
     BATCH_SOLVE_PIXEL_BUDGET pixels, above it image by image;
  5. connected-component clean-up, batched (one kernel launch on the
     card), and bit-packed output.
Stages stay on the device until the one packed pull at the end.
`segment_stream` keeps two such batches in flight.

`segment`'s staged branch (`edge_aware=False`, `refine_iters > 0`, or
the "native" GrabCut backend) runs the same stages one at a time through
the scalar API: `build_graph` -> `predict_probs` -> `refine_trimap` or
the per-region trimap -> `seed_from_prior` -> the `GrabCut` class ->
`clean_mask`.  `segment_bbox` is the classic box-initialised GrabCut.
"""

from __future__ import annotations

import dataclasses
import struct
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .core.device import resolve_device
from .core.graph import (CLASS_BG, CLASS_FG, TRIMAP_BG, TRIMAP_FG,
                         TRIMAP_PROB_BG, TRIMAP_PROB_FG, GraphBatch,
                         make_graph_batch)
from .grabcut import (GrabCut, GrabCutConfig, grabcut_batch_device,
                      run_batch_with_trimaps)
from .graph_build import (RegionGraph, SuperpixelGraphConfig,
                          build_graph, build_graph_batch_arrays,
                          num_nodes_for)
from .metrics import evaluate, evaluate_trimap
from .models.factory import (apply_model, probs_to_node_trimap,
                             project_planes)
from .models.large import apply_large
from .ops import image as im
from .ops.connected import _clean_mask, _per_image, clean_mask
from .utils import trace_span


def _batch_budget() -> int:
    """Pixels up to which `segment_batch` solves GrabCut in lock step;
    above it, image by image (the JAX package's rule)."""
    from .grabcut import BATCH_SOLVE_PIXEL_BUDGET
    return BATCH_SOLVE_PIXEL_BUDGET


def _write_png(path, img: np.ndarray) -> None:
    """Write an (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 image
    as an 8-bit PNG (no row filters, zlib level 6)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    colour_type = {1: 0, 3: 2, 4: 6}[channels]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0,
                                     0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b""))


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

    def show(self) -> None:
        """Display input | trimap | overlay panels until a key is pressed.
        Needs cv2 and a display; headless environments use save()."""
        import cv2
        panel = np.concatenate([
            cv2.resize(cv2.cvtColor(a, cv2.COLOR_RGB2BGR), (256, 256))
            for a in (self.image, colour_trimap(self.trimap), self.overlay)
        ], axis=1)
        cv2.imshow("Input | Trimap | Result", panel)
        cv2.waitKey(0)
        cv2.destroyAllWindows()

    def save(self, prefix: str = "result") -> None:
        """Write <prefix>_overlay.png, _rgba.png, _trimap_colour.png and
        _mask.png."""
        _write_png(f"{prefix}_overlay.png", self.overlay)
        _write_png(f"{prefix}_rgba.png", self.rgba)
        _write_png(f"{prefix}_trimap_colour.png", colour_trimap(self.trimap))
        _write_png(f"{prefix}_mask.png", self.binary_mask * 255)
        print(f"Saved outputs with prefix: {prefix}")

    def evaluate_against(self, gt_mask: np.ndarray):
        return evaluate(self.binary_mask, gt_mask), \
            evaluate_trimap(self.trimap, gt_mask)


def colour_trimap(trimap: np.ndarray) -> np.ndarray:
    vis = np.zeros((*trimap.shape, 3), np.uint8)
    vis[trimap == TRIMAP_BG] = [0, 0, 0]
    vis[trimap == TRIMAP_FG] = [255, 255, 255]
    vis[trimap == TRIMAP_PROB_BG] = [60, 20, 20]
    vis[trimap == TRIMAP_PROB_FG] = [0, 200, 200]
    return vis


def _threshold(p_bg, p_fg, gray, thr_fg, thr_bg, radius: int,
               eps: float = 1e-3) -> torch.Tensor:
    """Pixel P(BG), P(FG) -> uint8 trimap: guided-filter both under the
    grey image, then definite at or above a threshold, else the more
    likely probable side."""
    p_bg = im.guided_filter(gray, p_bg, radius, eps).clamp(0, 1)
    p_fg = im.guided_filter(gray, p_fg, radius, eps).clamp(0, 1)
    tri = torch.where(p_fg > p_bg, TRIMAP_PROB_FG, TRIMAP_PROB_BG)
    tri = torch.where(p_bg >= thr_bg, TRIMAP_BG, tri)
    return torch.where(p_fg >= thr_fg, TRIMAP_FG, tri).to(torch.uint8)


def refine_trimap(probs: np.ndarray, segments: np.ndarray, image: np.ndarray,
                  threshold_fg: float = 0.55, threshold_bg: float = 0.55,
                  radius: int = 8, eps: float = 1e-3,
                  device=None) -> np.ndarray:
    """Edge-aware trimap: project the (K, 3) posteriors' P(BG) and P(FG)
    to pixels, guided-filter them under the grey image and threshold, on
    `device` (default: the card).  Boundaries land on intensity edges
    rather than superpixel borders."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(probs), device=dev).float()
    seg = torch.as_tensor(np.asarray(segments), device=dev).long()
    gray = im.rgb_to_gray(torch.as_tensor(np.asarray(image), device=dev
                                          ).float()) / 255.0
    px = project_planes(p[:, [CLASS_BG, CLASS_FG]], seg)
    return _threshold(px[..., 0], px[..., 1], gray, threshold_fg,
                      threshold_bg, radius, eps).cpu().numpy()


def seed_from_prior(trimap: np.ndarray, graph: RegionGraph,
                    seed_frac: float = 0.1) -> np.ndarray:
    """Make sure both FG and BG seeds exist: when a side is missing,
    promote the ~seed_frac highest-prior valid superpixels to its probable
    label."""
    prior = graph.prior
    if prior is None or prior.size == 0:
        return trimap

    has_fg = np.isin(trimap, (TRIMAP_FG, TRIMAP_PROB_FG)).any()
    has_bg = np.isin(trimap, (TRIMAP_BG, TRIMAP_PROB_BG)).any()
    if has_fg and has_bg:
        return trimap

    node_mask = graph.node_mask
    n_valid = max(int(node_mask.sum()), 1)
    n_seed = max(1, int(round(seed_frac * n_valid)))
    trimap = trimap.copy()

    # Empty clusters rank last.
    score = np.where(node_mask > 0, prior[:, 0], -1.0)
    if not has_fg:
        ids = np.argsort(score)[::-1][:n_seed]
        trimap[np.isin(graph.segments, ids)] = TRIMAP_PROB_FG
    score_bg = np.where(node_mask > 0, prior[:, 1], -1.0)
    if not has_bg:
        ids = np.argsort(score_bg)[::-1][:n_seed]
        trimap[np.isin(graph.segments, ids)] = TRIMAP_PROB_BG
    return trimap


def _erode_box(mask: np.ndarray, size: int) -> np.ndarray:
    """cv2.erode(mask, np.ones((size, size))) of a binary mask: the minimum
    over the window at offsets -(size // 2) .. size - 1 - size // 2 (cv2's
    anchor), cut at the image edge (cv2's default border does not
    erode)."""
    H, W = mask.shape
    lo, hi = size // 2, size - 1 - size // 2
    zeros = np.pad((mask == 0).astype(np.int64), ((1, 0), (1, 0))
                   ).cumsum(0).cumsum(1)
    y0 = np.clip(np.arange(H) - lo, 0, H)
    y1 = np.clip(np.arange(H) + hi + 1, 0, H)
    x0 = np.clip(np.arange(W) - lo, 0, W)
    x1 = np.clip(np.arange(W) + hi + 1, 0, W)
    n_zero = (zeros[y1][:, x1] - zeros[y0][:, x1] - zeros[y1][:, x0]
              + zeros[y0][:, x0])
    return (n_zero == 0).astype(mask.dtype)


def _threshold_and_seed(px, gray, thr_fg, thr_bg, filter_radius: int):
    """(B, H, W, 4) planes [P(BG), P(FG), seed_fg, seed_bg] -> (B, H, W)
    uint8 trimaps: guided-filter the posteriors, threshold, and where an
    image's trimap lacks a probable side entirely promote its
    highest-prior regions to it."""
    tri = _threshold(px[..., 0], px[..., 1], gray, thr_fg, thr_bg,
                     filter_radius)
    has_fg = ((tri == TRIMAP_FG) | (tri == TRIMAP_PROB_FG)).flatten(1).any(1)
    has_bg = ((tri == TRIMAP_BG) | (tri == TRIMAP_PROB_BG)).flatten(1).any(1)
    tri = torch.where(_per_image(has_fg) | (px[..., 2] <= 0), tri,
                      TRIMAP_PROB_FG).to(torch.uint8)
    tri = torch.where(_per_image(has_bg) | (px[..., 3] <= 0), tri,
                      TRIMAP_PROB_BG).to(torch.uint8)
    return tri


def _seed_planes(prior, nm, seed_frac: float = 0.1) -> torch.Tensor:
    """(B, K, 2) [seed_fg, seed_bg]: masks of each image's ~seed_frac
    highest-prior valid regions on each side.  The count stays on the
    device, as the JAX package's does."""
    K = nm.shape[-1]
    n_valid = nm.sum(dim=-1).clamp_min(1.0)      # integer-valued: exact
    n_seed = torch.round(seed_frac * n_valid).clamp_min(1).long()
    pick = (n_seed - 1).clamp_max(K - 1)[:, None]

    def seed_mask(score):
        s = torch.where(nm > 0, score, -1.0)
        kth = torch.sort(s, dim=-1, descending=True).values.gather(-1, pick)
        return (s >= kth).float()

    return torch.stack([seed_mask(prior[..., 0]), seed_mask(prior[..., 1])],
                       dim=-1)


def _project_batch(planes: torch.Tensor, segments: torch.Tensor
                   ) -> torch.Tensor:
    """(B, K, C) per-region planes -> (B, H, W, C) pixel planes through
    each image's label map: an exact gather."""
    b = torch.arange(planes.shape[0], device=planes.device)[:, None, None]
    return planes[b, segments.long()]


def _project_probs_device(probs, segments, out_hw: tuple) -> torch.Tensor:
    """(B, K, 3) probs + (B, h, w) segments -> (B, H, W, 2) pixel planes
    [P(BG), P(FG)], bilinearly resized to `out_hw` when the graph was
    built at another scale (the multi-scale path)."""
    with trace_span("layer.project"):
        px = _project_batch(torch.stack([probs[..., CLASS_BG],
                                         probs[..., CLASS_FG]],
                                        dim=-1).float(), segments)
        if tuple(px.shape[1:3]) != tuple(out_hw):
            px = im.resize_bilinear(px, out_hw)
        return px


def _trimap_stage_device(px_probs, segments, grays, priors, node_masks,
                         thr_fg: float, thr_bg: float,
                         filter_radius: int) -> torch.Tensor:
    """(B, H, W, 2) pixel posteriors [P(BG), P(FG)] -> (B, H, W) uint8
    trimaps, the prior seed planes projected from the full-resolution
    graph.  Batched, as the JAX package's vmaps are, with no host sync."""
    seeds = _project_batch(_seed_planes(priors, node_masks), segments)
    return _threshold_and_seed(torch.cat([px_probs, seeds], dim=-1), grays,
                               thr_fg, thr_bg, filter_radius)


def _post_stage_device(masks, trimaps, segments, min_area: float,
                       keep_largest: bool, want_segments: bool = True,
                       pfg=None) -> torch.Tensor:
    """Component clean-up + output packing: one (B, bytes) uint8 buffer per
    batch -- the mask at 1 bit/px, the trimap at 2 bits/px and, optionally,
    the label map at 2 bytes/px, in the JAX package's planar layout.  The
    clean-up runs on the batch (one components kernel launch on the card),
    with no host sync."""
    with trace_span("layer.cleanup"):
        cleaned = _clean_mask(masks, min_area, keep_largest, pfg)
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


class _StageClock:
    """The stage boundaries of one batch: CUDA events on the card, recorded
    on the current stream and read once they have passed; the host clock
    elsewhere."""

    def __init__(self, dev: torch.device):
        self._card = dev.type == "cuda"
        self._stream = torch.cuda.current_stream(dev) if self._card else None
        self._marks = []
        self.mark(None)

    def mark(self, name) -> None:
        """End the stage `name` (None: the start)."""
        if self._card:
            t = torch.cuda.Event(enable_timing=True)
            t.record(self._stream)
        else:
            t = time.perf_counter()
        self._marks.append((name, t))

    def seconds(self) -> dict:
        """Seconds of each stage, in order."""
        out = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            out[name] = a.elapsed_time(b) / 1e3 if self._card else b - a
        return out


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

    model     : a ResGCNNet, GCNTrimapNet, GATTrimapNet or ModelEnsemble
                holding its weights (e.g. from
                train.checkpoints.load_model_auto, or seeded)
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

    def predict_probs(self, graph: RegionGraph) -> np.ndarray:
        """(K, 3) softmax class probabilities of one built graph (above
        LARGE_NODE_THRESHOLD nodes through the large-graph forward)."""
        return self._predict_probs_batch(graph.graph)[0].cpu().numpy()

    def _has_large_path(self) -> bool:
        return (getattr(self.model, "supports_spmm_aggregators", False)
                or getattr(self.model, "supports_banded_attention", False))

    def _predict_probs_batch(self, graph: GraphBatch) -> torch.Tensor:
        """(G, N, 3) softmax class probabilities: one stacked dense forward,
        or above LARGE_NODE_THRESHOLD one large-graph forward per graph
        (banded SpMM or banded attention) for a model that has one."""
        with trace_span("layer.forward"):
            if graph.max_nodes > self.LARGE_NODE_THRESHOLD \
                    and self._has_large_path():
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
        """Image in -> mask out.  The default options run `segment_batch`
        at B=1; `edge_aware=False`, `refine_iters > 0` and the "native"
        GrabCut backend run the staged path, which ignores `ms_scales`."""
        if (edge_aware and refine_iters == 0
                and self.gc_config.backend != "native"):
            return self.segment_batch(
                [image], threshold_fg=threshold_fg,
                threshold_bg=threshold_bg, min_area_ratio=min_area_ratio,
                keep_largest=keep_largest, filter_radius=filter_radius,
                ms_scales=ms_scales)[0]

        timing: dict = {}
        t = time.perf_counter()
        graph = build_graph(image, self.sp_config, device=self.device)
        timing["graph_build"] = time.perf_counter() - t

        t = time.perf_counter()
        probs = self.predict_probs(graph)
        if edge_aware:
            trimap = refine_trimap(probs, graph.segments, image,
                                   threshold_fg, threshold_bg,
                                   radius=filter_radius, device=self.device)
        else:
            trimap = probs_to_node_trimap(probs, threshold_fg, threshold_bg
                                          ).numpy()[graph.segments]
        timing["gcn_inference"] = time.perf_counter() - t

        # Without a user to correct it, a one-sided trimap must be repaired.
        trimap = seed_from_prior(trimap, graph)

        t = time.perf_counter()
        gc = GrabCut(image, self.gc_config, device=self.device)
        binary_mask = gc.run_with_trimap(trimap)
        if refine_iters > 0:
            binary_mask = gc.refine(refine_iters)
        timing["grabcut"] = time.perf_counter() - t

        t = time.perf_counter()
        # keep_largest reads the node posterior projected to pixels, with
        # no filter (the batched path reads the filtered plane).
        post = (probs[:, CLASS_FG].astype(np.float32)[graph.segments]
                if keep_largest else None)
        cleaned = clean_mask(binary_mask, min_area_ratio, keep_largest,
                             posterior=post, device=self.device)
        if not np.array_equal(cleaned, binary_mask):
            binary_mask = cleaned
            gc.mask = np.where(binary_mask == 1, TRIMAP_PROB_FG,
                               TRIMAP_PROB_BG).astype(np.uint8)
        timing["postprocess"] = time.perf_counter() - t

        return SegmentationResult(
            image=image, binary_mask=binary_mask, trimap=trimap,
            segments=graph.segments, overlay=gc.overlay_mask(),
            rgba=gc.crop_foreground(), timing=timing, probs=probs)

    def segment_batch(self, images: list, threshold_fg: float = 0.55,
                      threshold_bg: float = 0.55,
                      min_area_ratio: float = 0.002,
                      keep_largest: bool = False, filter_radius: int = 8,
                      want_segments: bool = True,
                      ms_scales: tuple | None = None
                      ) -> list[SegmentationResult]:
        """Segment a batch of same-size images, device-resident end to end.

        Each result's `timing` holds the batch's seconds per stage
        (graph_build, gcn_inference, grabcut, postprocess): on the card the
        device timeline between CUDA events recorded at the stage
        boundaries (read after the pull, so reading never waits; idle
        time while the host enqueues counts), elsewhere the host clock;
        postprocess adds the host's pull and unpack."""
        handle = self._dispatch_batch(
            images, threshold_fg=threshold_fg, threshold_bg=threshold_bg,
            min_area_ratio=min_area_ratio, keep_largest=keep_largest,
            filter_radius=filter_radius, want_segments=want_segments,
            ms_scales=ms_scales)
        return self._finalize_batch(handle)

    def segment_stream(self, images, batch_size: int = 8,
                       threshold_fg: float = 0.55, threshold_bg: float = 0.55,
                       min_area_ratio: float = 0.002,
                       keep_largest: bool = False, filter_radius: int = 8,
                       want_segments: bool = True,
                       ms_scales: tuple | None = None):
        """Generator of SegmentationResults over same-size images, in
        chunks of `batch_size`: chunk i+1 is dispatched before chunk i's
        packed output is pulled.  The last chunk may be shorter; it is not
        padded, since each padded image would cost a whole GrabCut solve.
        Each chunk's results equal `segment_batch`'s on that chunk."""
        pending = None
        images = list(images)
        for start in range(0, len(images), batch_size):
            handle = self._dispatch_batch(
                images[start:start + batch_size], threshold_fg=threshold_fg,
                threshold_bg=threshold_bg, min_area_ratio=min_area_ratio,
                keep_largest=keep_largest, filter_radius=filter_radius,
                want_segments=want_segments, ms_scales=ms_scales)
            if pending is not None:
                yield from self._finalize_batch(pending)
            pending = handle
        if pending is not None:
            yield from self._finalize_batch(pending)

    def _dispatch_batch(self, images, threshold_fg, threshold_bg,
                        min_area_ratio, keep_largest, filter_radius,
                        want_segments, ms_scales=None):
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
        clock = _StageClock(dev)

        with trace_span("layer.upload"):
            rgbs = torch.as_tensor(np.stack(images), device=dev).float()
        out, batch = self._graph(rgbs)
        clock.mark("graph_build")

        probs = self._predict_probs_batch(batch)
        segments = out["segments"]
        px = _project_probs_device(probs, segments, (H, W))
        if multi_scale:
            # Rebuild the graph and rerun the forward at each reduced
            # scale, resize its pixel posteriors back, and average.
            px_list = [px]
            for sc in ms_scales[1:]:
                hw = (max(int(round(H * sc)), 64), max(int(round(W * sc)), 64))
                with trace_span("layer.project"):
                    small = im.resize_bilinear(rgbs, hw)
                out_s, batch_s = self._graph(small)
                px_list.append(_project_probs_device(
                    self._predict_probs_batch(batch_s), out_s["segments"],
                    (H, W)))
            with trace_span("layer.project"):
                px = torch.stack(px_list).mean(dim=0)
        with trace_span("layer.trimap"):
            grays = im.rgb_to_gray(rgbs) / 255.0
            trimaps = _trimap_stage_device(
                px, segments, grays, out["prior"], out["node_mask"],
                threshold_fg, threshold_bg, filter_radius)
        # keep_largest reads the same plane the thresholds see.
        pfg_px = px[..., 1] if keep_largest else None
        clock.mark("gcn_inference")

        if len(images) * H * W <= _batch_budget():
            masks = grabcut_batch_device(rgbs, trimaps, self.gc_config)
        else:
            with trace_span("layer.grabcut"):
                masks = torch.as_tensor(run_batch_with_trimaps(
                    np.stack(images), trimaps.cpu().numpy(), self.gc_config,
                    device=dev), device=dev)
        clock.mark("grabcut")

        packed = _post_stage_device(masks, trimaps, segments,
                                    float(min_area_ratio * H * W),
                                    keep_largest, want_segments, pfg_px)
        clock.mark("postprocess")
        return {"packed": packed, "probs": probs, "images": images,
                "H": H, "W": W, "want_segments": want_segments,
                "clock": clock}

    def _finalize_batch(self, handle) -> list[SegmentationResult]:
        """Pull the packed buffer (the one device-to-host transfer) and
        assemble SegmentationResults."""
        with trace_span("layer.finalize"):
            t = time.perf_counter()
            with trace_span("layer.finalize.pull"):
                packed = handle["packed"].cpu().numpy()
                probs = handle["probs"].cpu().numpy()
                # The batch's events have passed: reading them never waits.
                timing = handle["clock"].seconds()
            with trace_span("layer.finalize.unpack"):
                masks_np, trimaps_np, segments_np = _unpack_post_host(
                    packed, handle["H"], handle["W"],
                    handle["want_segments"])
            timing["postprocess"] += time.perf_counter() - t

            with trace_span("layer.finalize.compose"):
                results = []
                tint = np.array([0, 220, 100], np.float32)
                for b, image in enumerate(handle["images"]):
                    mask = masks_np[b]
                    binary = mask[..., None].astype(np.float32)
                    overlay = np.clip(image * (1 - 0.45 * binary)
                                      + tint * 0.45 * binary, 0, 255
                                      ).astype(np.uint8)
                    rgba = np.concatenate([image, (mask * 255)[..., None]],
                                          axis=-1).astype(np.uint8)
                    results.append(SegmentationResult(
                        image=image, binary_mask=mask, trimap=trimaps_np[b],
                        segments=(None if segments_np is None
                                  else segments_np[b]),
                        overlay=overlay, rgba=rgba, timing=dict(timing),
                        probs=probs[b]))
                return results

    def segment_bbox(self, image: np.ndarray,
                     bbox: tuple[int, int, int, int]) -> SegmentationResult:
        """Classic GrabCut from a bounding box (x, y, w, h).  The returned
        trimap marks the box probable FG, its 30-pixel-eroded core FG and
        the rest probable BG."""
        gc = GrabCut(image, self.gc_config, device=self.device)
        binary_mask = gc.run_with_bbox(bbox)

        x, y, w, h = bbox
        H, W = image.shape[:2]
        trimap = np.full((H, W), TRIMAP_PROB_BG, np.uint8)
        trimap[y:y + h, x:x + w] = TRIMAP_PROB_FG
        inner = np.zeros((H, W), np.uint8)
        inner[y:y + h, x:x + w] = 1
        trimap[_erode_box(inner, 30) == 1] = TRIMAP_FG

        return SegmentationResult(
            image=image, binary_mask=binary_mask, trimap=trimap,
            segments=np.zeros((H, W), np.int32), overlay=gc.overlay_mask(),
            rgba=gc.crop_foreground())
