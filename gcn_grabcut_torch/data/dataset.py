"""Data layer: descriptors, decoding, augmentation, label derivation, graph
preparation with an on-disk cache, and the synthetic datasets.

Counterpart of ``gcn_grabcut_tpu/data/dataset.py``, the same functions with
the same seeds: a generator or an augmentation drawn from one
``np.random.RandomState`` seed gives the JAX package's pixels.  Graphs are
built by the port's `build_graph`, on the card unless ``device="cpu"``;
prepared samples are `GraphBatch`es with their targets (``y``,
``fg_ratio``), cached as .npz blobs in the JAX package's format and under
its key, so one cache directory serves both packages.  cv2 is imported
where it is used.  Comments citing "the reference" name the original
GCN-GrabCut code whose data distribution both packages keep.

Sample dict schema: {"image": (H, W, 3) RGB uint8, "gt_mask": (H, W)
uint8 {0,1}, "name": str}
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graph import CLASS_BG, CLASS_FG, CLASS_UNK, GraphBatch
from ..graph_build import SuperpixelGraphConfig, build_graph

logger = logging.getLogger(__name__)


# -----------------------------------------------------------------------
# Augmentation — applied as a chain of independently-gated ops, each drawn
# from its own RandomState stream position so a descriptor's pixels are a
# pure function of its seed.  The op set and magnitude ranges deliberately
# mirror the reference training distribution (flip / ±15° rotation /
# photometric jitter / 75-100% crop-zoom, reference dataset.py:107-168) so
# models trained here see the same data statistics.
# -----------------------------------------------------------------------

def augment_sample(image: np.ndarray, mask: np.ndarray,
                   rng: np.random.RandomState,
                   prob_flip: float = 0.5, prob_rotate: float = 0.3,
                   prob_color: float = 0.5, prob_crop: float = 0.3):
    """Stochastic geometric + photometric augmentation of an (image, mask)
    pair; geometry always warps both arrays with matched interpolation
    (linear for pixels, nearest for labels)."""
    import cv2
    H, W = mask.shape[:2]

    def flip(img, msk):
        return (np.ascontiguousarray(img[:, ::-1]),
                np.ascontiguousarray(msk[:, ::-1]))

    def rotate(img, msk):
        rot = cv2.getRotationMatrix2D((W / 2.0, H / 2.0),
                                      rng.uniform(-15.0, 15.0), 1.0)

        # cv2.warpAffine with BORDER_REFLECT, linear for the pixels and
        # nearest for the labels, in OpenCV 5.0's arithmetic whichever
        # OpenCV is installed (its versions part here).
        return (warp_affine_linear_reflect(img, rot, (W, H)),
                warp_affine_nearest(msk.astype(np.uint8), rot, (W, H),
                                    reflect=True))

    def recolor(img, msk):
        return _photometric_jitter(img, rng), msk

    def crop_zoom(img, msk):
        s = rng.uniform(0.75, 1.0)
        ch, cw = max(1, round(H * s)), max(1, round(W * s))
        y0 = rng.randint(0, H - ch + 1)
        x0 = rng.randint(0, W - cw + 1)

        def grow(a, interp):
            return cv2.resize(a[y0:y0 + ch, x0:x0 + cw], (W, H),
                              interpolation=interp)
        return grow(img, cv2.INTER_LINEAR), grow(msk, cv2.INTER_NEAREST)

    chain = ((prob_flip, flip), (prob_rotate, rotate),
             (prob_color, recolor), (prob_crop, crop_zoom))
    for prob, op in chain:
        if rng.rand() < prob:
            image, mask = op(image, mask)
    return image, mask


def _photometric_jitter(image: np.ndarray, rng: np.random.RandomState):
    """Brightness shift, contrast scale about mid-grey, saturation scale."""
    import cv2
    shift = rng.uniform(-40.0, 40.0)
    gain = rng.uniform(0.7, 1.3)
    sat = rng.uniform(0.7, 1.3)
    out = np.clip(image.astype(np.float32) + shift, 0.0, 255.0)
    out = np.clip(128.0 + gain * (out - 128.0), 0.0, 255.0)
    hsv = cv2.cvtColor(out.astype(np.uint8),
                       cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * sat, 0.0, 255.0)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


# -----------------------------------------------------------------------
# Label derivation (reference dataset.py:175-206)
# -----------------------------------------------------------------------

def derive_trimap_labels(segments: np.ndarray, gt_mask: np.ndarray,
                         n_nodes: int, fg_threshold: float = 0.75,
                         bg_threshold: float = 0.75) -> np.ndarray:
    """Per-superpixel 3-class label by coverage ratio."""
    flat = segments.ravel()
    counts = np.bincount(flat, minlength=n_nodes).astype(np.float64)
    fg_sum = np.bincount(flat, weights=(gt_mask.ravel() > 0).astype(
        np.float64), minlength=n_nodes)
    fg_ratio = fg_sum / np.maximum(counts, 1.0)

    labels = np.full(n_nodes, CLASS_UNK, np.int64)
    labels[fg_ratio >= fg_threshold] = CLASS_FG
    labels[fg_ratio <= 1 - bg_threshold] = CLASS_BG
    labels[counts == 0] = CLASS_UNK
    return labels


def node_fg_ratio(segments: np.ndarray, gt_mask: np.ndarray,
                  n_nodes: int) -> np.ndarray:
    flat = segments.ravel()
    counts = np.bincount(flat, minlength=n_nodes).astype(np.float64)
    fg_sum = np.bincount(flat, weights=(gt_mask.ravel() > 0).astype(
        np.float64), minlength=n_nodes)
    return (fg_sum / np.maximum(counts, 1.0)).astype(np.float32)


# -----------------------------------------------------------------------
# Prepared sample builder (reference dataset.py:213-260)
# -----------------------------------------------------------------------

def prepare_sample(sample: dict,
                   sp_config: Optional[SuperpixelGraphConfig] = None,
                   fg_threshold: float = 0.70,
                   bg_threshold: float = 0.70,
                   keep_segments: bool = True, device=None):
    """Raw sample dict → (GraphBatch with y/fg_ratio, segments or None).
    The graph is built on `device` (default: the card)."""
    rg = build_graph(sample["image"], sp_config, device=device)
    seg = rg.segments
    k = rg.n_nodes
    labels = derive_trimap_labels(seg, sample["gt_mask"], k,
                                  fg_threshold, bg_threshold)
    fgr = node_fg_ratio(seg, sample["gt_mask"], k)
    dev = rg.graph.device
    g = dataclasses.replace(
        rg.graph, y=torch.as_tensor(labels, device=dev)[None],
        fg_ratio=torch.as_tensor(fgr, device=dev)[None])
    return g, (seg if keep_segments else None)


# -----------------------------------------------------------------------
# Descriptors + decode.  A descriptor is a lazy reference to a sample —
# paths, resize target, deterministic augmentation seed — so enumerating a
# 10k-image dataset costs kilobytes and actual decoding happens only where
# the pixels are consumed (same lazy contract as the reference data layer,
# dataset.py:263-360, structured here around a single mask-directory index
# and a derived-seed helper).
# -----------------------------------------------------------------------

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}

# A GT mask smaller than this in either class cannot seed a two-sided
# colour model downstream; such samples are dropped at decode time (the
# reference applies the same 200-px rule).
MIN_CLASS_PIXELS = 200


def _derived_seed(name: str, seed: int, copy: int) -> int:
    """Deterministic, interpreter-stable augmentation seed for a named
    sample copy (Python's str hash is salted per process, so it cannot key
    caches — a digest can)."""
    digest = hashlib.sha1(f"{name}/{copy}/{seed}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def list_image_mask_pairs(images_dir, masks_dir, max_size: int = 512,
                          augment_copies: int = 0, seed: int = 0
                          ) -> list[dict]:
    """Pair every image with the mask sharing its stem and return lazy
    descriptors (augmented copies get derived seeds, not pixels)."""
    images_dir, masks_dir = Path(images_dir), Path(masks_dir)

    # Single scan of the mask directory → stem index; pairing is then a
    # dict lookup per image instead of per-extension existence probes.
    mask_for_stem: dict[str, Path] = {}
    for p in sorted(masks_dir.iterdir()):
        if p.suffix.lower() in _IMAGE_EXTS:
            mask_for_stem.setdefault(p.stem, p)

    descriptors, unmatched = [], 0
    for img_path in sorted(images_dir.iterdir()):
        if img_path.suffix.lower() not in _IMAGE_EXTS:
            continue
        mask_path = mask_for_stem.get(img_path.stem)
        if mask_path is None:
            unmatched += 1
            continue
        for copy in range(augment_copies + 1):
            descriptors.append({
                "image_path": str(img_path),
                "mask_path": str(mask_path),
                "max_size": max_size,
                "name": (img_path.stem if copy == 0
                         else f"{img_path.stem}_aug{copy - 1}"),
                "aug_seed": (None if copy == 0
                             else _derived_seed(img_path.stem, seed, copy)),
            })
    print(f"[Dataset] indexed {images_dir.name}: {len(descriptors)} "
          f"descriptor(s); {unmatched} image(s) lacked a mask")
    return descriptors


def _imread_retry(path: str, flags: Optional[int] = None,
                  attempts: int = 3) -> Optional[np.ndarray]:
    """cv2.imread signals transient I/O trouble (network mounts, eventual-
    consistency blob stores) by returning None — retry briefly with a
    growing pause before declaring the file unreadable.  `flags` defaults
    to cv2.IMREAD_COLOR."""
    import cv2
    if flags is None:
        flags = cv2.IMREAD_COLOR
    for attempt in range(attempts):
        data = cv2.imread(path, flags)
        if data is not None:
            return data
        if attempt + 1 < attempts:
            time.sleep(0.04 * (2 ** attempt))
    return None


def _fit_longest_edge(a: np.ndarray, max_size: int,
                      interp: int) -> np.ndarray:
    """Downscale so the longest edge is max_size (never upscales)."""
    import cv2
    longest = max(a.shape[:2])
    if longest <= max_size:
        return a
    s = max_size / longest
    new_wh = (max(1, round(a.shape[1] * s)), max(1, round(a.shape[0] * s)))
    return cv2.resize(a, new_wh, interpolation=interp)


def materialise(sample: dict) -> Optional[dict]:
    """Descriptor → decoded sample dict, or None if the pair is unreadable
    or its mask is degenerate (< MIN_CLASS_PIXELS in either class).
    Augmented descriptors replay their seed, so the same descriptor always
    yields the same pixels (what makes the graph cache content-stable)."""
    if "image" in sample and "gt_mask" in sample:
        return sample  # already pixel-backed
    import cv2

    bgr = _imread_retry(sample["image_path"])
    raw_mask = _imread_retry(sample["mask_path"], cv2.IMREAD_GRAYSCALE)
    if bgr is None or raw_mask is None:
        logger.warning("unreadable pair: %s", sample.get("image_path"))
        return None

    max_size = sample.get("max_size", 512)
    image = _fit_longest_edge(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB),
                              max_size, cv2.INTER_LINEAR)
    gt_mask = (_fit_longest_edge(raw_mask, max_size, cv2.INTER_NEAREST)
               > 127).astype(np.uint8)

    if sample.get("aug_seed") is not None:
        stream = np.random.RandomState(sample["aug_seed"] % (2 ** 31))
        image, gt_mask = augment_sample(image, gt_mask, stream,
                                        prob_flip=0.5, prob_rotate=0.4,
                                        prob_color=0.6, prob_crop=0.4)

    fg = int(gt_mask.sum())
    if min(fg, gt_mask.size - fg) < MIN_CLASS_PIXELS:
        return None
    return {"image": image, "gt_mask": gt_mask,
            "name": sample.get("name", "")}


# -----------------------------------------------------------------------
# Cached dataset preparation (reference dataset.py:363-582)
# -----------------------------------------------------------------------

def _cache_key(sample: dict, cfg: SuperpixelGraphConfig,
               fg_t: float, bg_t: float) -> str:
    h = hashlib.sha1()
    if "image" in sample:
        h.update(np.ascontiguousarray(sample["image"]))
        h.update(np.ascontiguousarray(sample["gt_mask"]))
    else:
        h.update(repr((sample["image_path"], sample["mask_path"],
                       sample.get("max_size"),
                       sample.get("aug_seed"))).encode())
    h.update(repr((cfg.n_segments, cfg.compactness, cfg.sigma, cfg.use_lab,
                   cfg.connectivity, cfg.n_nonlocal, cfg.slic_iters,
                   cfg.bg_connectivity, fg_t, bg_t)).encode())
    return h.hexdigest()[:20]


_GRAPH_FIELDS = ("x", "edge_src", "edge_dst", "edge_attr", "node_mask",
                 "edge_mask", "node_area", "fg_ratio", "y")
# The JAX package's dtypes: indices and labels int32, the rest float32.
_INT_FIELDS = ("edge_src", "edge_dst", "y")


def _save_cache(path: Path, g: GraphBatch, segments) -> None:
    arrays = {f: getattr(g, f).cpu().numpy().astype(
        np.int32 if f in _INT_FIELDS else np.float32) for f in _GRAPH_FIELDS}
    if segments is not None:
        arrays["segments"] = segments
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def _load_cache(path: Path, keep_segments: bool, device=None):
    """(GraphBatch on `device`, segments or None); `device` is taken as
    given (the caller resolved it)."""
    with np.load(path) as z:
        g = GraphBatch(**{f: torch.as_tensor(
            z[f].astype(np.int64) if f in _INT_FIELDS else z[f],
            device=device) for f in _GRAPH_FIELDS})
        seg = z["segments"] if (keep_segments and "segments" in z) else None
    return g, seg


def prepare_dataset(samples: list[dict],
                    sp_config: Optional[SuperpixelGraphConfig] = None,
                    fg_threshold: float = 0.70, bg_threshold: float = 0.70,
                    cache_dir=None, desc: str = "",
                    keep_segments: bool = True, device=None) -> list[tuple]:
    """Build (or load from cache) the graph for every sample, on `device`
    (default: the card).

    The cache makes a second run start training immediately.  One bad
    sample never kills the run — failures are tallied and reported.
    """
    cfg = sp_config or SuperpixelGraphConfig()
    dev = resolve_device(device)
    records, failures = [], []
    t0 = time.perf_counter()

    for i, sample in enumerate(samples):
        path = None
        if cache_dir is not None:
            path = Path(cache_dir) / (
                _cache_key(sample, cfg, fg_threshold, bg_threshold) + ".npz")
            if path.exists():
                try:
                    records.append(_load_cache(path, keep_segments, dev))
                    continue
                except Exception:
                    pass  # corrupt or stale cache entry — rebuild it
        try:
            mat = materialise(sample)
            if mat is None:
                failures.append(f"unreadable/degenerate: "
                                f"{sample.get('name', i)}")
                continue
            g, seg = prepare_sample(mat, cfg, fg_threshold, bg_threshold,
                                    keep_segments=True, device=dev)
            if path is not None:
                _save_cache(path, g, seg)
            records.append((g, seg if keep_segments else None))
        except Exception as exc:   # noqa: BLE001 — isolate bad samples
            failures.append(repr(exc))
        if desc and (i + 1) % 500 == 0:
            print(f"[Dataset] {desc}{i + 1}/{len(samples)} prepared "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)

    print(f"[Dataset] {desc}{len(records)}/{len(samples)} graphs ready in "
          f"{time.perf_counter() - t0:.1f}s"
          + (f" (cache: {cache_dir})" if cache_dir else ""))
    lost = len(samples) - len(records)
    if lost:
        distinct = list(dict.fromkeys(failures))
        print(f"[Dataset] {desc}{lost} sample(s) missing from the result; "
              f"{len(failures)} failure(s)")
        for f in distinct[:3]:
            print(f"[Dataset]   {f}")
    return records


def load_image_mask_dataset(images_dir, masks_dir, max_size: int = 512,
                            augment: bool = True, augment_factor: int = 2,
                            seed: int = 0) -> list[dict]:
    """Eager in-memory loader: decode every pair now, optionally with
    augmented copies (reference dataset.py:589-664).  Prefer
    `list_image_mask_pairs` + `prepare_dataset` for large datasets."""
    descs = list_image_mask_pairs(images_dir, masks_dir, max_size=max_size)
    samples, skipped = [], 0
    rng = np.random.RandomState(seed)
    for d in descs:
        mat = materialise(d)
        if mat is None:
            skipped += 1
            continue
        samples.append(mat)
        if augment:
            for k in range(augment_factor):
                img, msk = augment_sample(mat["image"], mat["gt_mask"], rng)
                samples.append({"image": img, "gt_mask": msk,
                                "name": f"{mat['name']}_aug{k}"})
    print(f"[Dataset] {len(samples)} samples loaded ({skipped} skipped).")
    return samples


# -----------------------------------------------------------------------
# Synthetic dataset (the CI fixture — reference dataset.py:667-749)
# -----------------------------------------------------------------------

# Distribution constants — a REFERENCE PARITY FIXTURE (the reference CI
# generator, dataset.py:667-749, draws from exactly these ranges): the same
# shape family, background/foreground palettes, geometry fractions and
# noise amplitude keep smoke-training runs and parity tests statistically
# comparable between the two frameworks.  The generator below shares only
# these constants with the reference; its structure (two-phase sampled
# paint-op lists) is this codebase's own.
_SYNTH_SHAPES = ("circle", "rect", "ellipse", "ring", "Lshape")
_SYNTH_BG = (20, 100)       # background / hole palette, per channel
_SYNTH_FG = (120, 240)      # object palette, per channel
_SYNTH_NOISE = 30           # uniform +/- pixel noise


def _sample_shape_ops(shape: str, rng: np.random.RandomState, size: int):
    """Sample one object's geometry as an ordered list of paint ops.

    Each op is ``(primitive, geometry, palette, label)``; ``label=0`` ops
    carve background-coloured holes (the ring interior, the L hollow) out
    of a previously painted ``label=1`` body.  Geometry fractions follow
    the parity fixture above.
    """
    cx = rng.randint(size // 4, 3 * size // 4)
    cy = rng.randint(size // 4, 3 * size // 4)

    def box(w, h):
        return (max(0, cx - w // 2), max(0, cy - h // 2),
                min(size - 1, cx + w // 2), min(size - 1, cy + h // 2))

    if shape == "circle":
        return [("circle", ((cx, cy), rng.randint(size // 8, size // 3)),
                 _SYNTH_FG, 1)]
    if shape == "rect":
        g = box(rng.randint(size // 6, size // 3),
                rng.randint(size // 6, size // 3))
        return [("rect", g, _SYNTH_FG, 1)]
    if shape == "ellipse":
        axes = (rng.randint(size // 8, size // 3),
                rng.randint(size // 12, size // 4))
        return [("ellipse", ((cx, cy), axes, rng.randint(0, 180)),
                 _SYNTH_FG, 1)]
    if shape == "ring":
        r_out = rng.randint(size // 5, size // 3)
        r_in = max(r_out - rng.randint(size // 15, size // 8), 1)
        return [("circle", ((cx, cy), r_out), _SYNTH_FG, 1),
                ("circle", ((cx, cy), r_in), _SYNTH_BG, 0)]
    # L-shape: solid box with a hollow offset by the arm thickness.
    x1, y1, x2, y2 = box(rng.randint(size // 6, size // 3),
                         rng.randint(size // 6, size // 3))
    t = max(size // 10, 5)
    return [("rect", (x1, y1, x2, y2), _SYNTH_FG, 1),
            ("rect", (x1 + t, y1 + t, x2 - t, y2 - t), _SYNTH_BG, 0)]


def _paint_ops(img: np.ndarray, mask: np.ndarray, ops,
               rng: np.random.RandomState) -> None:
    """Apply paint ops to the image (random colour from the op's palette)
    and the mask (the op's label) in order."""
    import cv2
    for prim, geom, palette, label in ops:
        colour = [int(c) for c in rng.randint(*palette, 3)]
        if prim == "circle":
            centre, r = geom
            cv2.circle(img, centre, r, colour, -1)
            cv2.circle(mask, centre, r, int(label), -1)
        elif prim == "rect":
            x1, y1, x2, y2 = geom
            cv2.rectangle(img, (x1, y1), (x2, y2), colour, -1)
            cv2.rectangle(mask, (x1, y1), (x2, y2), int(label), -1)
        else:  # ellipse
            centre, axes, angle = geom
            cv2.ellipse(img, centre, axes, angle, 0, 360, colour, -1)
            cv2.ellipse(mask, centre, axes, angle, 0, 360, int(label), -1)


def _warp_source(M, dsize: tuple, linear: bool):
    """(sx, sy): the float32 source coordinates of every destination pixel
    of ``cv2.warpAffine(src, M, dsize)`` in the arithmetic of OpenCV 5.0
    with 16-lane float vectors.  With the inverse map m in float64 and f =
    float32(m), the source x of the 16-pixel vectors is fma(f00, x, r),
    with the row term r = f01 * y + f02 in float32 arithmetic; for the
    last W % 16 pixels of a row it is fma(f00, x, float32(m01 * y + m02))
    (the row term in float64) when interpolating nearest, and
    (fma(f00, x, f01 * y) + f02) in float32 when linear; likewise y.  A
    float32 product is exact in float64, so one rounding there is a
    fma's."""
    W, H = dsize
    M = np.asarray(M, np.float64)
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a12 = M[1, 1] * det, -M[0, 1] * det
    a21, a22 = -M[1, 0] * det, M[0, 0] * det
    inv = np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                    [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])
    f = inv.astype(np.float32)
    xs = np.arange(W, dtype=np.float64)[None, :]
    ys = np.arange(H)
    in_vectors = xs < W - W % 16

    def fma_x(r, row):
        return (np.float64(f[r, 0]) * xs
                + row.astype(np.float64)[:, None]).astype(np.float32)

    def source(r):
        vec = fma_x(r, f[r, 1] * ys.astype(np.float32) + f[r, 2])
        if linear:
            tail = fma_x(r, (np.float64(f[r, 1]) * ys).astype(np.float32)
                         ) + f[r, 2]
        else:
            tail = fma_x(r, (inv[r, 1] * ys + inv[r, 2]).astype(np.float32))
        return np.where(in_vectors, vec, tail)
    return source(0), source(1)


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT index (fedcba|abcdefgh|hgfedcb)."""
    if n == 1:
        return np.zeros_like(i)
    i = i.copy()
    while True:
        lo, hi = i < 0, i >= n
        if not (lo.any() or hi.any()):
            return i
        i[lo] = -i[lo] - 1
        i[hi] = 2 * n - 1 - i[hi]


def warp_affine_nearest(src: np.ndarray, M, dsize: tuple,
                        reflect: bool = False) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=cv2.INTER_NEAREST)`` of a
    single-channel image, with its zero border or with ``borderMode=
    cv2.BORDER_REFLECT``, in numpy, in the arithmetic of OpenCV 5.0
    (`_warp_source`; coordinates round half to even).  OpenCV versions
    part here (4.x maps pixels in 10-bit fixed point, 5.0 in float32, and
    boundary pixels of a rotated rectangle move), so the generators and
    `augment_sample` warp this way and give the same pixels whichever
    OpenCV is installed."""
    if src.ndim != 2:
        raise ValueError(f"a single-channel image is needed, got "
                         f"{src.shape}")
    sx, sy = (np.rint(a).astype(np.int64)
              for a in _warp_source(M, dsize, linear=False))
    h, w = src.shape
    if reflect:
        return src[_reflect(sy, h), _reflect(sx, w)]
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros(sx.shape, src.dtype)
    out[inside] = src[sy[inside], sx[inside]]
    return out


def warp_affine_linear_reflect(src: np.ndarray, M, dsize: tuple
                               ) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REFLECT)`` of a uint8 image of any channels, in
    numpy, in the arithmetic of OpenCV 5.0: the source coordinates of
    `_warp_source`, their fractions a = s - floor(s) in float32, the four
    reflected neighbours p blended in float32 as v0 = fma(ax, p01 - p00,
    p00), v1 = fma(ax, p11 - p10, p10), v = fma(ay, v1 - v0, v0), rounded
    half to even and saturated."""
    sx, sy = _warp_source(M, dsize, linear=True)
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    h, w = src.shape[:2]
    xa, xb = _reflect(x0, w), _reflect(x0 + 1, w)
    ya, yb = _reflect(y0, h), _reflect(y0 + 1, h)
    p = src.astype(np.float32)
    if src.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)
    v0 = fma(ax, p[ya, xb] - p[ya, xa], p[ya, xa])
    v1 = fma(ax, p[yb, xb] - p[yb, xa], p[yb, xa])
    v = fma(ay, v1 - v0, v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def make_synthetic_dataset(n: int = 200, size: int = 128, seed: int = 42
                           ) -> list[dict]:
    """Seeded geometric shapes (circle/rect/ellipse/ring/L) + noise — the
    CI fixture.  Distribution matches the reference generator's (see the
    parity-fixture constants above); degenerate all-FG/all-BG draws are
    skipped, like the reference's."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n):
        img = rng.randint(*_SYNTH_BG, (size, size, 3), dtype=np.uint8)
        mask = np.zeros((size, size), np.uint8)
        shape = rng.choice(_SYNTH_SHAPES)
        _paint_ops(img, mask, _sample_shape_ops(shape, rng, size), rng)

        noise = rng.randint(-_SYNTH_NOISE, _SYNTH_NOISE, img.shape)
        img = np.clip(img.astype(np.int16) + noise.astype(np.int16),
                      0, 255).astype(np.uint8)
        if mask.sum() == 0 or (1 - mask).sum() == 0:
            continue
        samples.append({"image": img, "gt_mask": mask,
                        "name": f"synthetic_{i:04d}_{shape}"})
    print(f"[Dataset] Generated {len(samples)} synthetic samples.")
    return samples


def make_hard_synthetic_dataset(n: int = 200, size: int = 192,
                                seed: int = 42) -> list[dict]:
    """A harder synthetic benchmark than the shape fixture: textured and
    illumination-graded backgrounds, objects with internal texture and
    moderate colour contrast, and border-touching distractor blobs.

    Intended as the stand-in accuracy benchmark in environments without
    DUTS: it stresses the same failure modes (camouflage, distractors,
    boundary adherence) at a smaller scale.
    """
    import cv2
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n):
        # Multi-scale noise background + illumination gradient.
        base = rng.randint(30, 110, 3)
        img = np.zeros((size, size, 3), np.float32)
        for scale in (8, 32, 96):
            lowres = rng.randn(size // scale + 2, size // scale + 2, 3) * 18
            img += cv2.resize(lowres, (size, size),
                              interpolation=cv2.INTER_CUBIC)
        img += base[None, None, :]
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        ang = rng.rand() * 2 * np.pi
        grad = (np.cos(ang) * xx + np.sin(ang) * yy) * rng.uniform(-50, 50)
        img += grad[..., None]

        mask = np.zeros((size, size), np.uint8)
        cx = rng.randint(size // 3, 2 * size // 3)
        cy = rng.randint(size // 3, 2 * size // 3)
        color = base + rng.choice([-1, 1], 3) * rng.randint(50, 110, 3)
        color = np.clip(color, 0, 255)

        shape = rng.choice(["ellipse", "blob", "rect"])
        if shape == "ellipse":
            a = rng.randint(size // 7, size // 3)
            b = rng.randint(size // 8, size // 4)
            th = rng.randint(0, 180)
            cv2.ellipse(mask, (cx, cy), (a, b), th, 0, 360, 1, -1)
        elif shape == "rect":
            w, h = rng.randint(size // 6, size // 3, 2)
            cv2.rectangle(mask, (cx - w // 2, cy - h // 2),
                          (cx + w // 2, cy + h // 2), 1, -1)
            M = cv2.getRotationMatrix2D((cx, cy), rng.uniform(-40, 40), 1.0)
            mask = warp_affine_nearest(mask, M, (size, size))
        else:  # smooth random blob: union of overlapping circles
            for _ in range(rng.randint(3, 7)):
                r_ = rng.randint(size // 10, size // 5)
                dx, dy = rng.randint(-size // 8, size // 8, 2)
                cv2.circle(mask, (cx + dx, cy + dy), r_, 1, -1)

        # Object fill: base colour + its own texture.
        obj_tex = rng.randn(size, size, 3) * rng.uniform(5, 20)
        obj = color[None, None, :] + obj_tex
        img = np.where(mask[..., None] > 0, obj, img)

        # Distractor blobs (same colour family as the object, at borders).
        for _ in range(rng.randint(0, 3)):
            bx = rng.choice([rng.randint(0, size // 6),
                             rng.randint(5 * size // 6, size)])
            by = rng.randint(0, size)
            r_ = rng.randint(size // 16, size // 8)
            dcol = np.clip(color + rng.randint(-25, 25, 3), 0, 255)
            cv2.circle(img, (int(bx), int(by)), r_,
                       tuple(float(c) for c in dcol), -1)

        img = np.clip(img + rng.randn(size, size, 3) * 6, 0, 255)
        img = img.astype(np.uint8)
        if mask.sum() < 200 or (1 - mask).sum() < 200:
            continue
        samples.append({"image": img, "gt_mask": mask,
                        "name": f"hard_{i:04d}_{shape}"})
    print(f"[Dataset] Generated {len(samples)} hard synthetic samples.")
    return samples


_REAL_TEXTURE_BANK: Optional[tuple] = None


def _real_texture_bank() -> tuple:
    """Real photographs bundled with the scientific-python stack — the only
    real image pixels available in this environment (sklearn's china.jpg /
    flower.jpg, matplotlib's grace_hopper.jpg).  Crop sources for the
    photo-synthetic generator's real-texture family: foliage, sky, stone,
    water, skin and fabric patches with genuine sensor/texture statistics
    that the procedural families can only approximate.  Returns () when
    the packages are absent (the generator then skips the family)."""
    global _REAL_TEXTURE_BANK
    if _REAL_TEXTURE_BANK is not None:
        return _REAL_TEXTURE_BANK
    import cv2
    bank = []
    try:
        from sklearn import datasets as _skd
        d = Path(_skd.__file__).parent / "images"
        for f in ("china.jpg", "flower.jpg"):
            img = cv2.imread(str(d / f), cv2.IMREAD_COLOR)
            if img is not None:
                bank.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    except Exception:
        pass
    try:
        import matplotlib
        p = (Path(matplotlib.__file__).parent / "mpl-data" / "sample_data"
             / "grace_hopper.jpg")
        img = cv2.imread(str(p), cv2.IMREAD_COLOR)
        if img is not None:
            bank.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    except Exception:
        pass
    _REAL_TEXTURE_BANK = tuple(bank)
    return _REAL_TEXTURE_BANK


def _real_texture_crop(rng: np.random.RandomState, size: int,
                       bank: tuple) -> np.ndarray:
    """One colour-jittered square texture crop resized to (size, size)
    float32.  Crops are deliberately sub-object scale (12-45% of the source
    min-dimension) so they contribute texture statistics, not recognisable
    salient objects that would fight the pasted foreground's label."""
    import cv2
    src = bank[rng.randint(len(bank))]
    h, w = src.shape[:2]
    ch = max(24, int(min(h, w) * rng.uniform(0.12, 0.45)))
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - ch + 1)
    crop = src[y0:y0 + ch, x0:x0 + ch]
    if rng.rand() < 0.5:
        crop = crop[:, ::-1]
    crop = np.rot90(crop, rng.randint(4))
    interp = cv2.INTER_AREA if ch >= size else cv2.INTER_CUBIC
    crop = cv2.resize(np.ascontiguousarray(crop), (size, size),
                      interpolation=interp).astype(np.float32)
    crop = crop * rng.uniform(0.6, 1.3, 3)[None, None] \
        + rng.uniform(-25, 25, 3)[None, None]
    return np.clip(crop, 0, 255)


def make_photo_synthetic_dataset(n: int = 200, size: int = 512,
                                 seed: int = 99,
                                 real_textures: bool = False,
                                 p_piebald: float = 0.30,
                                 p_achromatic: float = 0.15,
                                 p_vegetation: float = 0.55,
                                 p_frame: float = 0.25,
                                 p_vignette: float = 0.30,
                                 p_lowkey: float = 0.30) -> list[dict]:
    """Photograph-statistics training distribution: scene-like backgrounds
    (two soft zones with a horizon, multi-scale texture, vignette), one
    salient multi-part object (overlapping ellipse parts with internal
    colour patches, contour darkening and a soft contact shadow), plus
    background distractor blobs and photometric jitter.

    Intended to close the domain gap between the geometric hard-synthetic
    fixture and real photos (demo_eval.py) when no real dataset is
    available.  Evaluation fixtures (`make_hard_synthetic_dataset`) are
    deliberately left untouched so accuracy numbers stay comparable
    across rounds.
    """
    import cv2
    rng = np.random.RandomState(seed)
    samples = []
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        # --- background ------------------------------------------------
        # Four families, matched to what real photos contain and the
        # geometric fixtures lack: textured two-zone scenes, near-smooth
        # gradients (sky/walls), out-of-focus bokeh, and streaky water.
        bank = _real_texture_bank() if real_textures else ()
        kinds = ["zones", "zones", "smooth", "bokeh", "water"]
        if bank:
            # Real-photo texture statistics (see _real_texture_bank).
            # OFF by default: with only three crop-source photos in this
            # environment, both background-heavy (2/7 share) and
            # object-heavy (full-band object texture) mixes regressed the
            # real-photo head-to-head (demo agreement 0.459 → 0.254/0.252)
            # — the model learns "real texture = BG" or "= FG" wholesale.
            # Kept as a data-only option for environments with a richer
            # texture bank.
            kinds += ["realtex"]
        bg_kind = kinds[rng.randint(len(kinds))]
        c_top = rng.randint(40, 220, 3).astype(np.float32)
        c_bot = np.clip(c_top + rng.randint(-90, 90, 3), 20, 235)
        horizon = rng.uniform(0.25, 0.75)
        softness = rng.uniform(0.02, 0.25)
        blend = 1.0 / (1.0 + np.exp(-(yy - horizon) / softness))
        img = (c_top[None, None] * (1 - blend[..., None])
               + c_bot[None, None] * blend[..., None])
        if bg_kind == "zones":
            for scale in (8, 32, 128):
                lowres = rng.randn(size // scale + 2, size // scale + 2, 3)
                img += cv2.resize(lowres, (size, size),
                                  interpolation=cv2.INTER_CUBIC
                                  ) * rng.uniform(4, 16)
        elif bg_kind == "smooth":
            # Sky / plain-wall statistics: the gradient IS the background;
            # only faint large-scale tinting, no local texture.
            lowres = rng.randn(6, 6, 3)
            img += cv2.resize(lowres, (size, size),
                              interpolation=cv2.INTER_CUBIC
                              ) * rng.uniform(0.5, 4)
        elif bg_kind == "bokeh":
            # Out-of-focus scene: big colour blobs + bright highlight
            # discs, everything heavily blurred.
            for _ in range(rng.randint(4, 10)):
                bx, by = rng.randint(0, size, 2)
                r_ = rng.randint(size // 8, size // 3)
                col = np.clip(c_top + rng.randint(-80, 80, 3), 10, 250)
                cv2.circle(img, (bx, by), r_,
                           tuple(float(c) for c in col), -1)
            for _ in range(rng.randint(2, 7)):
                bx, by = rng.randint(0, size, 2)
                r_ = rng.randint(size // 40, size // 12)
                lift = float(rng.uniform(40, 110))
                cv2.circle(img, (bx, by), r_,
                           tuple(float(min(c + lift, 255)) for c in
                                 img[min(by, size - 1),
                                     min(bx, size - 1)]), -1)
            img = cv2.GaussianBlur(img, (0, 0), size * rng.uniform(
                0.02, 0.06))
        elif bg_kind == "water":  # horizontally streaked, vertically smooth
            lowres = rng.randn(size // 8 + 2, size // 8 + 2, 3)
            tex = cv2.resize(lowres, (size, size),
                             interpolation=cv2.INTER_CUBIC
                             ) * rng.uniform(4, 12)
            tex = cv2.blur(tex, (max(size // 8, 3), 3))
            img += tex
        else:  # realtex: one or two real texture crops as the scene
            img = _real_texture_crop(rng, size, bank)
            if rng.rand() < 0.5:
                # two-zone scene from two different real textures
                second = _real_texture_crop(rng, size, bank)
                img = img * (1 - blend[..., None]) \
                    + second * blend[..., None]
            if rng.rand() < 0.3:   # out-of-focus background
                img = cv2.GaussianBlur(img, (0, 0),
                                       size * rng.uniform(0.004, 0.02))
        # vignette
        r2 = (yy - 0.5) ** 2 + (xx - 0.5) ** 2
        img *= (1.0 - rng.uniform(0.0, 0.35) * r2)[..., None]

        # --- object: multi-part union of ellipses ----------------------
        mask = np.zeros((size, size), np.uint8)
        cx = int(size * rng.uniform(0.22, 0.78))
        cy = int(size * rng.uniform(0.3, 0.82))
        scale_o = rng.uniform(0.12, 0.3) * size
        n_parts = rng.randint(2, 6)
        for p in range(n_parts):
            a = int(scale_o * rng.uniform(0.35, 1.0))
            b = int(scale_o * rng.uniform(0.25, 0.8))
            th = rng.randint(0, 180)
            dx = int(scale_o * rng.uniform(-0.8, 0.8))
            dy = int(scale_o * rng.uniform(-0.8, 0.8))
            cv2.ellipse(mask, (cx + dx, cy + dy), (max(a, 4), max(b, 4)),
                        th, 0, 360, 1, -1)

        # fur-like silhouette roughness: jitter the boundary with smoothed
        # noise so object edges are not always clean conic arcs
        if rng.rand() < 0.5:
            fuzz = cv2.GaussianBlur(
                rng.randn(size, size).astype(np.float32), (0, 0),
                size / rng.uniform(60, 150))
            band = cv2.dilate(mask, np.ones((7, 7), np.uint8)) - cv2.erode(
                mask, np.ones((7, 7), np.uint8))
            grow = (band > 0) & (fuzz > 0.3)
            shrink = (band > 0) & (fuzz < -0.3)
            mask = np.where(grow, 1, np.where(shrink, 0, mask)
                            ).astype(np.uint8)

        if mask.sum() < 400 or mask.sum() > 0.6 * size * size:
            continue

        # soft contact shadow below the object
        sh = cv2.dilate(mask, np.ones((9, 9), np.uint8))
        sh = np.roll(sh, rng.randint(5, size // 20), axis=0)
        sh = cv2.GaussianBlur(sh.astype(np.float32), (0, 0), size / 40)
        img *= (1.0 - 0.4 * np.clip(sh - mask, 0, 1))[..., None]

        # object fill: internal colour patches + texture.  Three colour
        # families, weighted to what real salient objects (DUTS-style
        # animal photos) actually look like:
        #   * piebald (30%): near-white body with dark/brown patches or the
        #     inverse — the papillon/beagle statistic.  A colour-blob model
        #     trained without this learns "white = background" and drops
        #     white fur wholesale (the round-3 demo failure).
        #   * achromatic (15%): uniformly white/black/grey animals.
        #   * free colour (55%): random base + contrasting patches.
        obj = np.zeros_like(img)
        fill_mode = rng.rand()
        if fill_mode < p_piebald:
            light = np.clip(rng.uniform(185, 248)
                            + rng.uniform(-12, 12, 3), 5, 255
                            ).astype(np.float32)
            if rng.rand() < 0.5:       # near-black patches (papillon)
                dark = rng.uniform(8, 55, 3).astype(np.float32)
            else:                      # brown patches (beagle), RGB order
                dark = np.array([rng.uniform(70, 140), rng.uniform(35, 90),
                                 rng.uniform(12, 55)], np.float32)
            if rng.rand() < 0.65:      # white-dominant body
                base_col, alt_col = light, dark
            else:
                base_col, alt_col = dark, light
            n_patch, p_lo, p_hi = rng.randint(2, 6), 0.15, 0.8
            cols = [base_col] + [
                alt_col if rng.rand() < 0.8 else
                np.clip(base_col + rng.randint(-60, 60, 3), 5, 250)
                for _ in range(5)]
        elif fill_mode < p_piebald + p_achromatic:
            g_ = float(rng.choice([rng.uniform(10, 60),
                                   rng.uniform(180, 245)]))
            base_col = np.clip(
                g_ + rng.uniform(-12, 12, 3), 5, 250).astype(np.float32)
            n_patch, p_lo, p_hi = rng.randint(1, 4), 0.4, 1.2
            cols = [base_col] + [
                np.clip(base_col + rng.randint(-120, 120, 3), 10, 245)
                for _ in range(5)]
        else:
            base_col = rng.randint(25, 230, 3).astype(np.float32)
            # Saliency statistics: saturated-green objects are rare in real
            # photos (green usually means vegetation, i.e. background) —
            # resample greenish bases once with 60% probability so the
            # colour coverage stays non-zero but the prior shifts.
            if (base_col[1] > 70 and base_col[1]
                    > 1.35 * max(base_col[0], base_col[2])
                    and rng.rand() < 0.6):
                base_col = rng.randint(25, 230, 3).astype(np.float32)
            n_patch, p_lo, p_hi = rng.randint(1, 4), 0.4, 1.2
            cols = [base_col] + [
                np.clip(base_col + rng.randint(-120, 120, 3), 10, 245)
                for _ in range(5)]
        patch_lbl = np.zeros((size, size), np.uint8)
        for q in range(n_patch):
            pm = np.zeros((size, size), np.uint8)
            a = int(scale_o * rng.uniform(p_lo, p_hi))
            b = int(scale_o * rng.uniform(0.75 * p_lo, 0.85 * p_hi))
            dx = int(scale_o * rng.uniform(-0.6, 0.6))
            dy = int(scale_o * rng.uniform(-0.6, 0.6))
            cv2.ellipse(pm, (cx + dx, cy + dy), (max(a, 4), max(b, 4)),
                        rng.randint(0, 180), 0, 360, 1, -1)
            patch_lbl[pm > 0] = 1 + (q % 5)
        for q in range(6):
            obj[patch_lbl == q] = cols[q]
        obj += rng.randn(size, size, 3) * rng.uniform(3, 14)

        # illumination gradient across the object: real subjects are lit
        # from one side, so the SAME surface spans bright and midtone
        # regions.  Flat-lit synthetic objects taught the model that the
        # shaded continuation of an object is background (the round-4
        # stage-swap diagnostic: ours p_fg 0.09 vs reference 0.42 on
        # midtone L in [128,176) object regions).
        if rng.rand() < 0.6:
            ang = rng.uniform(0, 2 * np.pi)
            ramp = ((yy - cy / size) * np.sin(ang)
                    + (xx - cx / size) * np.cos(ang))
            span = max(scale_o / size, 1e-3)
            ramp = np.clip(ramp / (2 * span) + 0.5, 0.0, 1.0)
            lo_ = rng.uniform(0.45, 0.8)
            obj *= (lo_ + (1.1 - lo_) * ramp)[..., None]
        if bank and rng.rand() < 0.5:
            # real texture on the OBJECT: full-band crop recentred on the
            # object palette (keeps fur/fabric structure at every scale
            # without leaking the source's colours) — textured foregrounds
            # are what the procedural families under-represent and what
            # real photos are full of.
            tex = _real_texture_crop(rng, size, bank)
            tex = tex - tex.mean(axis=(0, 1), keepdims=True)
            obj = np.clip(obj + tex * rng.uniform(0.4, 0.9), 0, 255)
        img = np.where(mask[..., None] > 0, obj, img)

        # contour darkening (real objects self-shadow at silhouettes)
        edge = cv2.morphologyEx(mask, cv2.MORPH_GRADIENT,
                                np.ones((3, 3), np.uint8))
        edge = cv2.GaussianBlur(edge.astype(np.float32), (0, 0), 1.5)
        img *= (1.0 - 0.25 * edge)[..., None]

        # background distractors (object-family colours allowed)
        for _ in range(rng.randint(0, 4)):
            bx, by = rng.randint(0, size, 2)
            if mask[min(by, size - 1), min(bx, size - 1)]:
                continue
            r_ = rng.randint(size // 30, size // 10)
            dcol = np.clip(base_col + rng.randint(-60, 60, 3), 0, 255)
            dist = np.zeros((size, size), np.uint8)
            cv2.circle(dist, (bx, by), r_, 1, -1)
            dist &= (1 - mask)
            img = np.where(dist[..., None] > 0,
                           dcol[None, None] + rng.randn(size, size, 3) * 8,
                           img)

        # bush/rock-sized clutter: large, textured, colour-distinct blobs
        # that sit off-centre and are NOT the object (real scenes contain
        # salient-looking vegetation/furniture; the model must not pick the
        # biggest textured blob).  Not in bokeh scenes — everything there
        # is out of focus.
        if bg_kind != "bokeh" and rng.rand() < 0.6:
            for _ in range(rng.randint(1, 3)):
                side = rng.rand()
                bx = int(size * (rng.uniform(0.0, 0.22) if side < 0.5
                                 else rng.uniform(0.78, 1.0)))
                by = int(size * rng.uniform(0.0, 1.0))
                blob = np.zeros((size, size), np.uint8)
                r0 = rng.randint(size // 8, size // 4)
                for _ in range(rng.randint(3, 7)):
                    dx, dy = rng.randint(-r0, r0, 2)
                    cv2.circle(blob, (bx + dx, by + dy),
                               rng.randint(r0 // 2, r0), 1, -1)
                blob &= (1 - mask)
                bcol = rng.randint(15, 220, 3).astype(np.float32)
                btex = bcol[None, None] + rng.randn(size, size, 3) \
                    * rng.uniform(8, 26)
                img = np.where(blob[..., None] > 0, btex, img)

        # vegetation masses: large green leafy-textured blobs anywhere in
        # the background (not only at the frame edges).  In real-photo
        # statistics vegetation is (nearly) always background; a model that
        # has never seen a salient-looking bush picks it over a pale animal
        # (the round-3 framed-beagle failure: our posterior chose the bush).
        if bg_kind != "bokeh" and rng.rand() < p_vegetation:
            for _ in range(rng.randint(1, 3)):
                vx, vy = rng.randint(0, size, 2)
                veg = np.zeros((size, size), np.uint8)
                r0 = rng.randint(size // 8, size // 3)
                for _ in range(rng.randint(4, 9)):
                    dx, dy = rng.randint(-r0, r0, 2)
                    cv2.circle(veg, (vx + dx, vy + dy),
                               rng.randint(max(r0 // 3, 3),
                                           max((2 * r0) // 3, 4)), 1, -1)
                veg &= (1 - mask)
                g_ = rng.uniform(70, 165)
                vcol = np.array([g_ * rng.uniform(0.3, 0.75), g_,
                                 g_ * rng.uniform(0.2, 0.6)], np.float32)
                vtex = np.zeros((size, size, 3), np.float32)
                for scale in (4, 12, 36):
                    lowres = rng.randn(size // scale + 2,
                                       size // scale + 2, 3)
                    vtex += cv2.resize(
                        lowres, (size, size),
                        interpolation=cv2.INTER_CUBIC) * rng.uniform(8, 24)
                shade = rng.uniform(0.55, 1.1)
                img = np.where(veg[..., None] > 0,
                               np.clip((vcol[None, None] + vtex) * shade,
                                       0, 255), img)

        # low-key scene: the subject is better-lit than its surroundings
        # (flash/porch-light statistics of curated photo sets — the demo's
        # framed-beagle photo is one).  Darkens the background strongly
        # while the object keeps most of its exposure.
        if rng.rand() < p_lowkey:
            bg_dim = rng.uniform(0.40, 0.72)
            fg_dim = rng.uniform(0.85, 1.05)
            dim = np.where(mask > 0, fg_dim, bg_dim).astype(np.float32)
            dim = cv2.GaussianBlur(dim, (0, 0), size / 80)
            img *= dim[..., None]

        # photometrics: gamma + brightness jitter + sensor noise
        g = rng.uniform(0.75, 1.3)
        img = np.clip(img, 0, 255)
        img = 255.0 * (img / 255.0) ** g
        img = np.clip(img * rng.uniform(0.85, 1.15)
                      + rng.randn(size, size, 3) * 4, 0, 255)

        # vignette: radial fall-off towards the corners (real lenses and
        # edited photos darken borders; the border-colour BG prior must not
        # read that as a distinct background class)
        if rng.rand() < p_vignette:
            r2 = (yy - 0.5) ** 2 + (xx - 0.5) ** 2
            img *= (1.0 - rng.uniform(0.25, 0.6)
                    * np.clip(r2 / 0.5, 0, 1)[..., None])

        # framed photo: a flat dark/light matte border around the image
        # (common in curated photo sets; the demo's third photo ships one).
        # Object pixels never reach under the frame, so the mask is zeroed
        # there too.
        if rng.rand() < p_frame:
            t_ = rng.randint(max(2, size // 64), size // 14)
            fcol = float(rng.choice([rng.uniform(0, 25),
                                     rng.uniform(225, 255)]))
            border = np.zeros((size, size), bool)
            border[:t_], border[-t_:] = True, True
            border[:, :t_], border[:, -t_:] = True, True
            img = np.where(border[..., None],
                           fcol + rng.randn(size, size, 3) * 2, img)
            mask = np.where(border, 0, mask).astype(np.uint8)

        img = np.clip(img, 0, 255).astype(np.uint8)

        if mask.sum() < 200 or (1 - mask).sum() < 200:
            continue
        samples.append({"image": img, "gt_mask": mask,
                        "name": f"photo_{i:04d}"})
    print(f"[Dataset] Generated {len(samples)} photo-synthetic samples.")
    return samples


def split_dataset(samples: list, val_ratio: float = 0.15,
                  test_ratio: float = 0.05, seed: int = 42):
    """Seeded shuffled train/val/test split — same contract as the
    reference (dataset.py:752-769): test and val each get at least one
    sample (``max(1, ratio·n)``), train takes the remainder.
    """
    order = np.random.RandomState(seed).permutation(len(samples))
    cuts = np.cumsum([max(1, int(len(samples) * r))
                      for r in (test_ratio, val_ratio)])
    parts = [[samples[i] for i in idx]
             for idx in np.split(order, cuts)]
    test, val, train = parts[0], parts[1], parts[2]
    print(f"[Dataset] Split → train:{len(train)} val:{len(val)} "
          f"test:{len(test)}")
    return train, val, test
