"""GrabCut: iterated GMM colour models + push-relabel min-cut.

Counterpart of ``gcn_grabcut_tpu/grabcut.py``.  Per iteration: assign
every pixel its best component under the carried GMMs, re-fit both
5-component GMMs, set terminal capacities from the log-likelihood ratio
(definite pixels clamped at lambda = 9·gamma), solve the 8-lattice
min-cut and relabel the probable pixels.  The device solver resumes each
cut from the previous flow (flow recycling); the "native" backend keeps
the GMM steps on the device and solves each cut on the host with the C++
push-relabel (``native/``).

`grabcut_batch_device` is the batched core of ``segment_batch``: the
batch's images iterate in lock step, as (B, H, W) tensors, each min-cut
stopping when its image converges (`_grabcut_solve_batch`, the JAX
package's vmapped solve).  The `GrabCut` class is the interactive API
(bounding box or trimap, further refinement rounds, a snapshot history,
overlays), one image at a time.
"""

from __future__ import annotations

import dataclasses
import math

from typing import Optional

import numpy as np
import torch

from .core.graph import TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_BG, TRIMAP_PROB_FG
from .ops import gmm as gmm_ops
from .ops import image as im
from .ops.maxflow import OFFSETS_8, _fresh_residuals, grid_mincut_batch


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
    beta = 1 / (2 <|dz|^2>) over all neighbour pairs (cv2's calcBeta), for
    (..., H, W, 3) pixels: leading dimensions are a batch, with a beta per
    image.  The |dz|^2 total is summed in float64 and rounded once (exact
    for RGB), so an image's beta does not depend on its batch."""
    diffs = []
    for dy, dx in OFFSETS_8:
        sh = torch.roll(pix, (-dy, -dx), dims=(-3, -2))
        d2 = gmm_ops._channel_sum((pix - sh) ** 2)
        if dy == -1:
            d2[..., 0, :] = 0.0
        if dx == -1:
            d2[..., :, 0] = 0.0
        if dx == 1:
            d2[..., :, -1] = 0.0
        diffs.append(d2)
    H, W = pix.shape[-3:-1]
    total = sum(d.double().sum(dim=(-2, -1)) for d in diffs).float()
    n_pairs = 4 * H * W - 3 * (H + W) + 2
    beta_inv = 2.0 * total / n_pairs
    beta = torch.where(beta_inv > 1e-12, 1.0 / beta_inv,
                       torch.zeros_like(beta_inv))[..., None, None]
    # gamma / dist rounded as the JAX package computes it, in float32.
    caps = tuple(float(np.float32(gamma) / np.float32(math.sqrt(dy * dy
                                                                + dx * dx)))
                 * torch.exp(-beta * d2)
                 for (dy, dx), d2 in zip(OFFSETS_8, diffs))
    return caps, beta


def _class_masks(m: torch.Tensor):
    fg = (m == TRIMAP_FG) | (m == TRIMAP_PROB_FG)
    return fg.float(), (~fg).float()


def _iterate(pix: torch.Tensor, mask: torch.Tensor, comp0: torch.Tensor,
             gamma: float, n_iter: int, n_components: int):
    """The iterated optimisation on a batch of same-size images in lock
    step: pix (B, H, W, 3) float32, mask (B, H, W) uint8 OpenCV labels,
    comp0 (B, H, W) initial components; returns (masks, comps).  Each
    image has its own beta, GMMs and carried flow, and ends bit for bit
    where it would alone."""
    pix = pix.float()
    caps, _ = _pairwise_caps(pix, gamma)
    lam = 9.0 * gamma

    fg_sel, bg_sel = _class_masks(mask)
    fg_gmm = gmm_ops.fit_gmm(pix, fg_sel, comp0, n_components)
    bg_gmm = gmm_ops.fit_gmm(pix, bg_sel, comp0, n_components)
    r_fwd, r_bwd = _fresh_residuals(caps, OFFSETS_8)
    e_carry = torch.zeros_like(pix[..., 0])
    E_prev = torch.zeros_like(pix[..., 0])
    comp = comp0
    for _ in range(n_iter):
        fg_sel, bg_sel = _class_masks(mask)
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
        fg_side, e_carry, r_fwd, r_bwd = grid_mincut_batch(
            e_carry + (E_t - E_prev), r_fwd, r_bwd, connectivity=8)
        E_prev = E_t
        probable = (mask == TRIMAP_PROB_BG) | (mask == TRIMAP_PROB_FG)
        relabel = torch.where(fg_side, TRIMAP_PROB_FG, TRIMAP_PROB_BG
                              ).to(mask.dtype)
        mask = torch.where(probable, relabel, mask)
    return mask, comp


def _grabcut_solve_batch(pix: torch.Tensor, masks: torch.Tensor,
                         comps: torch.Tensor, gamma: float, n_iter: int,
                         n_components: int):
    """`_grabcut_solve` over a batch of same-size images in lock step (the
    JAX package's vmapped solve, its batched-inference configuration):
    pix (B, H, W, 3), masks and comps (B, H, W) -> (masks, comps).  Every
    image's GMM fits, capacities and push-relabel sweeps run together;
    each image's min-cut stops when it converges.  The exact cut only."""
    return _iterate(pix, masks, comps, gamma, n_iter, n_components)


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
    """Promote probable labels to definite where a definite class is
    missing, branchlessly, for (..., H, W) trimaps; also return whether
    each stays one-sided ((...,) bool)."""
    def has(label):
        return (t == label).flatten(-2).any(-1)[..., None, None]

    t = torch.where(~has(TRIMAP_FG) & (t == TRIMAP_PROB_FG), TRIMAP_FG, t
                    ).to(t.dtype)
    t = torch.where(~has(TRIMAP_BG) & (t == TRIMAP_PROB_BG), TRIMAP_BG, t
                    ).to(t.dtype)
    degenerate = ~(has(TRIMAP_FG) & has(TRIMAP_BG))[..., 0, 0]
    return t, degenerate


def _initial_components(pix: torch.Tensor, fg_sel: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """initGMMs: seeded k-means per class (seeds 0 / 1)."""
    fg_comp = gmm_ops.kmeans(pix, fg_sel.float(), k, seed=0)
    bg_comp = gmm_ops.kmeans(pix, (~fg_sel).float(), k, seed=1)
    return torch.where(fg_sel, fg_comp, bg_comp)


def grabcut_batch_device(rgb: torch.Tensor, trimaps: torch.Tensor,
                         config: Optional[GrabCutConfig] = None,
                         comp0: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, H, W, 3) float32 RGB + (B, H, W) uint8 trimaps -> (B, H, W)
    uint8 binary masks, with the device solver on the tensors' device: the
    whole batch in lock step (`_grabcut_solve_batch`), as the JAX
    package's ``_grabcut_batch_jit``.

    Degenerate trimaps are repaired branchlessly as in the JAX package;
    an image whose trimap stays one-sided is solved with the others and
    keeps its own labelling.  Initial components come from seeded k-means
    per class (seeds 0 / 1) over the batch unless `comp0` (B, H, W) is
    given."""
    config = config or GrabCutConfig()
    k = config.n_components
    t, degenerate = _repair(trimaps.to(torch.uint8))
    fg_sel = (t == TRIMAP_FG) | (t == TRIMAP_PROB_FG)
    pix = preprocess_device(rgb.float(), config.color_space)
    if comp0 is None:
        comp0 = _initial_components(pix, fg_sel, k)
    masks, _ = _grabcut_solve_batch(pix, t, comp0.long(), config.gamma,
                                    config.n_iter, k)
    solved = ((masks == TRIMAP_FG) | (masks == TRIMAP_PROB_FG)
              ).to(torch.uint8)
    return torch.where(degenerate[:, None, None], fg_sel.to(torch.uint8),
                       solved)


#: Above this many pixels in a batch, `segment_batch` and
#: `run_batch_with_trimaps` solve the images one by one through the GrabCut
#: class instead of in lock step (the JAX package's bound on its vmapped
#: solve's memory; kept so the two choose alike).
BATCH_SOLVE_PIXEL_BUDGET = 33_554_432


