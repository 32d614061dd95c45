"""GrabCut: iterated GMM colour models + push-relabel min-cut.

Counterpart of ``gcn_grabcut_tpu/grabcut.py``.  Per iteration: assign
every pixel its best component under the carried GMMs, re-fit both
5-component GMMs, set terminal capacities from the log-likelihood ratio
(definite pixels clamped at lambda = 9·gamma), solve the 8-lattice
min-cut and relabel the probable pixels.  The device solver resumes each
cut from the previous flow (flow recycling); the "native" backend keeps
the GMM steps on the device and solves each cut on the host with the C++
push-relabel (``native/``).

`grabcut_batch_device` is the batched core of ``segment_batch``; the
`GrabCut` class is the interactive API (bounding box or trimap, further
refinement rounds, a snapshot history, overlays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import native
from .core.device import resolve_device
from .core.graph import TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_BG, TRIMAP_PROB_FG
from .ops import gmm as gmm_ops
from .ops import image as im
from .ops.maxflow import OFFSETS_8, _fresh_residuals, grid_mincut_stateful


@dataclasses.dataclass
class GrabCutConfig:
    """Same fields and defaults as the JAX package's config.  `backend`:
    "device" solves the min-cut on the tensors' device, "native" with the
    C++ solver on the host, "auto" picks "device" on the card and "native"
    on the CPU.  It selects the solver of the `GrabCut` class (and so of
    the staged `segment`); the batched `grabcut_batch_device` always runs
    the device solver, as in the JAX package."""
    n_iter: int = 5
    n_components: int = 5
    gamma: float = 50.0
    color_space: str = "rgb"   # "rgb" | "hsv" | "lab"
    backend: str = "auto"      # "auto" | "device" | "native"


@dataclasses.dataclass
class GrabCutSnapshot:
    tag: str
    fg_pixels: int
    bg_pixels: int
    fg_ratio: float
    mask_copy: np.ndarray = dataclasses.field(repr=False)


def _pairwise_caps(pix: torch.Tensor, gamma: float):
    """8-neighbour smoothness capacities gamma/dist · exp(-beta·|dz|^2) and
    beta = 1 / (2 <|dz|^2>) over all neighbour pairs (cv2's calcBeta)."""
    diffs = []
    for dy, dx in OFFSETS_8:
        sh = torch.roll(pix, (-dy, -dx), dims=(0, 1))
        d2 = ((pix - sh) ** 2).sum(dim=-1)
        if dy == -1:
            d2[0, :] = 0.0
        if dx == -1:
            d2[:, 0] = 0.0
        if dx == 1:
            d2[:, -1] = 0.0
        diffs.append(d2)
    H, W = pix.shape[:2]
    total = sum(d.sum() for d in diffs)
    n_pairs = 4 * H * W - 3 * (H + W) + 2
    beta_inv = 2.0 * total / n_pairs
    beta = torch.where(beta_inv > 1e-12, 1.0 / beta_inv,
                       torch.zeros_like(beta_inv))
    # gamma / dist rounded as the JAX package computes it, in float32.
    caps = tuple(float(np.float32(gamma) / np.float32(math.sqrt(dy * dy
                                                                + dx * dx)))
                 * torch.exp(-beta * d2)
                 for (dy, dx), d2 in zip(OFFSETS_8, diffs))
    return caps, beta


def _grabcut_solve(pix: torch.Tensor, mask: torch.Tensor,
                   comp0: torch.Tensor, gamma: float, n_iter: int,
                   n_components: int):
    """The iterated optimisation on one image with the exact flow-recycled
    min-cut (the JAX package's ml_levels=0).  pix (H, W, 3) float32, mask
    (H, W) uint8 OpenCV labels, comp0 (H, W) initial components.  Returns
    (mask, comp)."""
    pix = pix.float()
    caps, _ = _pairwise_caps(pix, gamma)
    lam = 9.0 * gamma

    def class_masks(m):
        fg = (m == TRIMAP_FG) | (m == TRIMAP_PROB_FG)
        return fg.float(), (~fg).float()

    fg_sel, bg_sel = class_masks(mask)
    fg_gmm = gmm_ops.fit_gmm(pix, fg_sel, comp0, n_components)
    bg_gmm = gmm_ops.fit_gmm(pix, bg_sel, comp0, n_components)
    r_fwd, r_bwd = _fresh_residuals(caps, OFFSETS_8)
    e_carry = torch.zeros_like(pix[..., 0])
    E_prev = torch.zeros_like(pix[..., 0])
    comp = comp0
    for _ in range(n_iter):
        fg_sel, bg_sel = class_masks(mask)
        # cv2 order: assign under the carried GMMs, then one re-fit.
        comp = torch.where(fg_sel > 0, gmm_ops.assign_components(pix, fg_gmm),
                           gmm_ops.assign_components(pix, bg_gmm))
        fg_gmm = gmm_ops.fit_gmm(pix, fg_sel, comp, n_components)
        bg_gmm = gmm_ops.fit_gmm(pix, bg_sel, comp, n_components)

        # Terminal capacities: excess = fromSource - toSink, source = FG.
        unknown = (gmm_ops.gmm_log_prob(pix, fg_gmm)
                   - gmm_ops.gmm_log_prob(pix, bg_gmm)).clamp(-lam, lam)
        E_t = torch.where(mask == TRIMAP_FG, lam,
                          torch.where(mask == TRIMAP_BG, -lam, unknown))
        # Flow recycling: add the terminal delta to the carried excess.
        fg_side, e_carry, r_fwd, r_bwd = grid_mincut_stateful(
            e_carry + (E_t - E_prev), r_fwd, r_bwd, connectivity=8)
        E_prev = E_t
        probable = (mask == TRIMAP_PROB_BG) | (mask == TRIMAP_PROB_FG)
        relabel = torch.where(fg_side, TRIMAP_PROB_FG, TRIMAP_PROB_BG
                              ).to(mask.dtype)
        mask = torch.where(probable, relabel, mask)
    return mask, comp


def _grabcut_solve_native(pix: torch.Tensor, mask: np.ndarray,
                          comp0: torch.Tensor, gamma: float, n_iter: int,
                          n_components: int):
    """The iteration with each min-cut solved on the host by the C++
    solver.  The GMM steps run on `pix`'s device; the capacities are pulled
    once and each iteration's terminal excess once.  mask (H, W) uint8
    OpenCV labels on the host.  Returns (mask numpy, comp tensor)."""
    pix = pix.float()
    caps, _ = _pairwise_caps(pix, gamma)
    caps_np = tuple(c.cpu().numpy() for c in caps)
    lam = 9.0 * gamma
    mask = np.array(mask, np.uint8)

    def fg_of(m):
        return torch.as_tensor((m == TRIMAP_FG) | (m == TRIMAP_PROB_FG),
                               device=pix.device).float()

    comp = comp0
    fg = fg_of(mask)
    fg_gmm = gmm_ops.fit_gmm(pix, fg, comp, n_components)
    bg_gmm = gmm_ops.fit_gmm(pix, 1.0 - fg, comp, n_components)
    for _ in range(n_iter):
        fg = fg_of(mask)
        # cv2 order: assign under the carried GMMs, then one re-fit.
        comp = torch.where(fg > 0, gmm_ops.assign_components(pix, fg_gmm),
                           gmm_ops.assign_components(pix, bg_gmm))
        fg_gmm = gmm_ops.fit_gmm(pix, fg, comp, n_components)
        bg_gmm = gmm_ops.fit_gmm(pix, 1.0 - fg, comp, n_components)
        excess = (gmm_ops.gmm_log_prob(pix, fg_gmm)
                  - gmm_ops.gmm_log_prob(pix, bg_gmm)).clamp(-lam, lam
                                                             ).cpu().numpy()
        excess[mask == TRIMAP_FG] = lam
        excess[mask == TRIMAP_BG] = -lam
        fg_side = native.grid_mincut_native(excess, caps_np, connectivity=8)
        probable = (mask == TRIMAP_PROB_BG) | (mask == TRIMAP_PROB_FG)
        mask[probable & fg_side] = TRIMAP_PROB_FG
        mask[probable & ~fg_side] = TRIMAP_PROB_BG
    return mask, comp


def preprocess_device(rgb: torch.Tensor, color_space: str) -> torch.Tensor:
    """GrabCut colour-space preprocessing of (..., H, W, 3) float32 RGB:
    HSV scaled to 0..255, or Lab in cv2's uint8 scaling (L·255/100,
    a + 128, b + 128)."""
    cs = color_space.lower()
    if cs == "hsv":
        return im.rgb_to_hsv(rgb) * 255.0
    if cs == "lab":
        lab = im.rgb_to_lab(rgb)
        return torch.stack([lab[..., 0] * 255.0 / 100.0, lab[..., 1] + 128.0,
                            lab[..., 2] + 128.0], dim=-1)
    return rgb


def _repair(t: torch.Tensor):
    """Promote probable labels to definite when a definite class is
    missing; report whether the trimap stays one-sided."""
    if not bool((t == TRIMAP_FG).any()):
        t = torch.where(t == TRIMAP_PROB_FG, TRIMAP_FG, t).to(t.dtype)
    if not bool((t == TRIMAP_BG).any()):
        t = torch.where(t == TRIMAP_PROB_BG, TRIMAP_BG, t).to(t.dtype)
    degenerate = not (bool((t == TRIMAP_FG).any())
                      and bool((t == TRIMAP_BG).any()))
    return t, degenerate


def grabcut_batch_device(rgb: torch.Tensor, trimaps: torch.Tensor,
                         config: Optional[GrabCutConfig] = None,
                         comp0: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, H, W, 3) float32 RGB + (B, H, W) uint8 trimaps -> (B, H, W)
    uint8 binary masks, with the device solver on the tensors' device.

    Degenerate trimaps are repaired as in the JAX package; an image whose
    trimap stays one-sided keeps its own labelling.  Initial components
    come from seeded k-means per class (seeds 0 / 1) unless `comp0`
    (B, H, W) is given."""
    config = config or GrabCutConfig()
    k = config.n_components
    out = []
    for b in range(rgb.shape[0]):
        t, degenerate = _repair(trimaps[b].to(torch.uint8))
        fg_sel = (t == TRIMAP_FG) | (t == TRIMAP_PROB_FG)
        if degenerate:
            out.append(fg_sel.to(torch.uint8))
            continue
        pix = preprocess_device(rgb[b].float(), config.color_space)
        if comp0 is None:
            fg_comp = gmm_ops.kmeans(pix, fg_sel.float(), k, seed=0)
            bg_comp = gmm_ops.kmeans(pix, (~fg_sel).float(), k, seed=1)
            c0 = torch.where(fg_sel, fg_comp, bg_comp)
        else:
            c0 = comp0[b].long()
        mask, _ = _grabcut_solve(pix, t, c0, config.gamma, config.n_iter, k)
        out.append(((mask == TRIMAP_FG) | (mask == TRIMAP_PROB_FG)
                    ).to(torch.uint8))
    return torch.stack(out)



#: Above this many pixels in a batch, `run_batch_with_trimaps` solves the
#: images one by one through the GrabCut class (the JAX package's bound on
#: its vmapped solve's memory; kept so the two choose alike).
BATCH_SOLVE_PIXEL_BUDGET = 33_554_432


def run_batch_with_trimaps(images: np.ndarray, trimaps: np.ndarray,
                           config: Optional[GrabCutConfig] = None,
                           device=None) -> np.ndarray:
    """Batched GrabCut: (B, H, W, 3) uint8 RGB + (B, H, W) trimaps ->
    (B, H, W) uint8 binary masks, on `device` (default: the card); beyond
    BATCH_SOLVE_PIXEL_BUDGET pixels through the GrabCut class, image by
    image."""
    config = config or GrabCutConfig()
    dev = resolve_device(device)
    B, H, W = images.shape[:3]
    if B * H * W > BATCH_SOLVE_PIXEL_BUDGET:
        return np.stack([GrabCut(images[b], config, device=dev
                                 ).run_with_trimap(trimaps[b])
                         for b in range(B)])
    return grabcut_batch_device(
        torch.as_tensor(np.asarray(images), device=dev).float(),
        torch.as_tensor(np.asarray(trimaps), device=dev), config
    ).cpu().numpy()


class GrabCut:
    """GrabCut on one image, with the classic wrapper's API.

        gc = GrabCut(image)                  # (H, W, 3) uint8 RGB
        mask = gc.run_with_bbox((x, y, w, h))
        mask = gc.run_with_trimap(trimap)
        mask = gc.refine(3)
        overlay = gc.overlay_mask(); rgba = gc.crop_foreground()

    The GMM steps run on `device` (default: the card); the min-cut on it
    too, or on the host with backend "native".  Masks come back as (H, W)
    uint8 numpy arrays."""

    def __init__(self, image: np.ndarray,
                 config: Optional[GrabCutConfig] = None, device=None):
        self.image = image
        self.config = config or GrabCutConfig()
        self.device = resolve_device(device)
        self.mask: Optional[np.ndarray] = None
        self._comp: Optional[torch.Tensor] = None
        self.history: List[GrabCutSnapshot] = []
        self._proc = preprocess_device(
            torch.as_tensor(np.asarray(image), device=self.device).float(),
            self.config.color_space)
        self._backend = self._pick_backend(self.config.backend)

    def _pick_backend(self, backend: str) -> str:
        """The solver: "auto" is "device" on the card and "native" on the
        CPU.  "native" builds the C++ solver now, and raises if it
        cannot."""
        if backend == "auto":
            backend = "device" if self.device.type == "cuda" else "native"
        if backend == "native":
            native.load()
        elif backend != "device":
            raise ValueError(f"unknown GrabCut backend {backend!r}")
        return backend

    def _solve(self, mask: np.ndarray, comp0: torch.Tensor, n_iter: int
               ) -> None:
        if self._backend == "native":
            self.mask, self._comp = _grabcut_solve_native(
                self._proc, mask, comp0, self.config.gamma, n_iter,
                self.config.n_components)
            return
        out, self._comp = _grabcut_solve(
            self._proc, torch.as_tensor(mask, device=self.device), comp0,
            self.config.gamma, n_iter, self.config.n_components)
        self.mask = out.cpu().numpy()

    # ------------------------------------------------------------------

    def run_with_bbox(self, bbox: Tuple[int, int, int, int]) -> np.ndarray:
        """Everything outside the box is definite background, inside it is
        probable foreground (cv2.GC_INIT_WITH_RECT)."""
        H, W = self.image.shape[:2]
        x, y, w, h = bbox
        trimap = np.full((H, W), TRIMAP_BG, np.uint8)
        trimap[max(y, 0):min(y + h, H), max(x, 0):min(x + w, W)] = \
            TRIMAP_PROB_FG
        out = self._run(trimap)
        self._snapshot("bbox_init")
        return out

    def run_with_trimap(self, trimap: np.ndarray) -> np.ndarray:
        """GrabCut seeded with a 4-label trimap."""
        if trimap.shape != self.image.shape[:2]:
            raise ValueError(
                f"Trimap shape {trimap.shape} != image shape "
                f"{self.image.shape[:2]}")
        trimap = trimap.astype(np.uint8)

        # At least one definite seed per class: promote probable labels.
        if not (trimap == TRIMAP_FG).any():
            trimap = trimap.copy()
            trimap[trimap == TRIMAP_PROB_FG] = TRIMAP_FG
        if not (trimap == TRIMAP_BG).any():
            trimap = trimap.copy()
            trimap[trimap == TRIMAP_PROB_BG] = TRIMAP_BG

        # A one-sided trimap cannot seed both GMMs: keep its labelling.
        if not (trimap == TRIMAP_FG).any() or not (trimap == TRIMAP_BG).any():
            self.mask = trimap.copy()
            self._snapshot("trimap_degenerate")
            return self._binary()

        out = self._run(trimap)
        self._snapshot("trimap_init")
        return out

    def refine(self, extra_iter: int = 3) -> np.ndarray:
        """Continue from the current mask and components (cv2.GC_EVAL)."""
        if self.mask is None:
            raise RuntimeError(
                "Call run_with_bbox or run_with_trimap first.")
        self._solve(self.mask, self._comp, extra_iter)
        self._snapshot("refinement")
        return self._binary()

    def _run(self, trimap: np.ndarray) -> np.ndarray:
        fg_sel = torch.as_tensor((trimap == TRIMAP_FG)
                                 | (trimap == TRIMAP_PROB_FG),
                                 device=self.device)
        # initGMMs: k-means per class seeds the components.
        k = self.config.n_components
        fg_comp = gmm_ops.kmeans(self._proc, fg_sel.float(), k, seed=0)
        bg_comp = gmm_ops.kmeans(self._proc, (~fg_sel).float(), k, seed=1)
        self._solve(trimap, torch.where(fg_sel, fg_comp, bg_comp),
                    self.config.n_iter)
        return self._binary()

    # ------------------------------------------------------------------

    def _binary(self) -> np.ndarray:
        return ((self.mask == TRIMAP_FG)
                | (self.mask == TRIMAP_PROB_FG)).astype(np.uint8)

    def _snapshot(self, tag: str) -> None:
        b = self._binary()
        self.history.append(GrabCutSnapshot(
            tag=tag, fg_pixels=int(b.sum()), bg_pixels=int((b == 0).sum()),
            fg_ratio=float(b.mean()), mask_copy=self.mask.copy()))

    def overlay_mask(self, alpha: float = 0.45,
                     color: Tuple = (0, 220, 100)) -> np.ndarray:
        """RGB image with a coloured foreground overlay."""
        binary = self._binary().astype(np.float32)[..., None]
        overlay = self.image.astype(np.float32)
        tint = np.zeros_like(overlay)
        tint[:] = color
        out = overlay * (1 - alpha * binary) + tint * alpha * binary
        return np.clip(out, 0, 255).astype(np.uint8)

    def crop_foreground(self) -> np.ndarray:
        """RGBA image with a transparent background."""
        rgba = np.concatenate(
            [self.image, (self._binary() * 255)[..., None]], axis=-1)
        return rgba.astype(np.uint8)

    def trimap_visualisation(self, trimap: np.ndarray) -> np.ndarray:
        vis = np.zeros((*trimap.shape, 3), np.uint8)
        vis[trimap == TRIMAP_BG] = [0, 0, 0]
        vis[trimap == TRIMAP_FG] = [255, 255, 255]
        vis[trimap == TRIMAP_PROB_BG] = [80, 0, 0]
        vis[trimap == TRIMAP_PROB_FG] = [0, 200, 200]
        return vis
