"""GrabCut: iterated GMM colour models + push-relabel min-cut.

Counterpart of ``gcn_grabcut_tpu/grabcut.py`` (the device path used by
``segment_batch``).  Per iteration: assign every pixel its best component
under the carried GMMs, re-fit both 5-component GMMs, set terminal
capacities from the log-likelihood ratio (definite pixels clamped at
lambda = 9·gamma), and re-solve the 8-lattice min-cut from the previous
flow (flow recycling), relabelling the probable pixels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .core.graph import TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_BG, TRIMAP_PROB_FG
from .ops import gmm as gmm_ops
from .ops.maxflow import OFFSETS_8, _fresh_residuals, grid_mincut_stateful


@dataclasses.dataclass
class GrabCutConfig:
    """Same fields and defaults as the JAX package's config.  The port
    runs the device solver ("auto" and "device"); the native host solver
    and the HSV / Lab colour spaces come with a later slice."""
    n_iter: int = 5
    n_components: int = 5
    gamma: float = 50.0
    color_space: str = "rgb"
    backend: str = "auto"


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


def preprocess_device(rgb: torch.Tensor, color_space: str) -> torch.Tensor:
    """GrabCut colour-space preprocessing of (..., H, W, 3) float32 RGB."""
    if color_space.lower() != "rgb":
        raise NotImplementedError(
            f"GrabCut color_space={color_space!r} comes with a later slice; "
            "the port runs 'rgb'")
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
    uint8 binary masks, on the tensors' device.

    Degenerate trimaps are repaired as in the JAX package; an image whose
    trimap stays one-sided keeps its own labelling.  Initial components
    come from seeded k-means per class (seeds 0 / 1) unless `comp0`
    (B, H, W) is given."""
    config = config or GrabCutConfig()
    if config.backend not in ("auto", "device"):
        raise NotImplementedError(
            f"GrabCut backend={config.backend!r} comes with a later slice")
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

