"""Training-free automatic FG/BG saliency prior.

Counterpart of ``gcn_grabcut_tpu/ops/prior.py`` for the large-graph
configuration (K > LARGE_K_THRESHOLD): spatially weighted global colour
contrast accumulated over column blocks, times a centre Gaussian (fg-ness);
a Gaussian distance to the border-region colour mean max'd with the border
ratio (bg-ness); ambiguity 1 - |fg - bg|.
"""

from __future__ import annotations

import torch

LARGE_K_THRESHOLD = 2048
_CONTRAST_BLOCK = 1024


def _contrast_blocked(mean_lab, centroids, area_w, k, contrast_sigma):
    """contrast_i = sum_j ||c_i - c_j|| exp(-d_ij^2 / 2s^2) a_j, summed
    over column blocks of _CONTRAST_BLOCK (O(K·block) memory)."""
    B = _CONTRAST_BLOCK
    kp = ((k + B - 1) // B) * B
    dev = mean_lab.device
    ml = torch.zeros((kp, 3), device=dev)
    ml[:k] = mean_lab
    ct = torch.zeros((kp, 2), device=dev)
    ct[:k] = centroids
    aw = torch.zeros(kp, device=dev)     # padded areas are 0: inert
    aw[:k] = area_w
    inv2s2 = 1.0 / (2 * contrast_sigma ** 2)
    acc = torch.zeros(kp, device=dev)
    for j0 in range(0, kp, B):
        cd = torch.linalg.vector_norm(ml[:, None, :] - ml[None, j0:j0 + B],
                                      dim=2)
        sd2 = ((ct[:, None, :] - ct[None, j0:j0 + B]) ** 2).sum(dim=2)
        w = torch.exp(-sd2 * inv2s2)
        acc = acc + (cd * w * aw[None, j0:j0 + B]).sum(dim=1)
    return acc[:k]


def _unit_norm_masked(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max to [0, 1] over valid entries; constant vectors -> zeros."""
    mn = torch.where(valid > 0, v, torch.full_like(v, 1e30)).min()
    mx = torch.where(valid > 0, v, torch.full_like(v, -1e30)).max()
    rng = mx - mn
    out = torch.where(rng < 1e-8, torch.zeros_like(v),
                      (v - mn) / (rng + 1e-12))
    return out * valid


def compute_auto_prior(segments: torch.Tensor, k: int, stats: tuple,
                       centre_sigma: float = 0.45,
                       contrast_sigma: float = 0.40) -> torch.Tensor:
    """(K, 3) prior [fg-ness, bg-ness, ambiguity], each in [0, 1].

    `stats=(counts, mean_lab, centroids)` are region_statistics' moments.
    Only the blocked contrast (K > LARGE_K_THRESHOLD) and the border-colour
    background cue are ported; the dense contrast and the geodesic cue
    (`bg_connectivity`) come with the 512 px / 500-superpixel slice."""
    if k <= LARGE_K_THRESHOLD:
        raise NotImplementedError(
            "the dense-contrast prior (K <= 2048) comes with ROADMAP queue 1 "
            "item 3 (the 512 px / 500-superpixel dense path)")
    counts, mean_lab, centroids = stats
    counts = counts.float()
    safe = counts.clamp_min(1.0)
    valid = (counts > 0).float()

    area_w = counts / counts.sum().clamp_min(1.0)
    contrast = _contrast_blocked(mean_lab, centroids, area_w, k,
                                 contrast_sigma)
    contrast = _unit_norm_masked(contrast, valid)
    centre_d = torch.linalg.vector_norm(centroids - 0.5, dim=1)
    centre_w = torch.exp(-(centre_d ** 2) / (2 * centre_sigma ** 2))
    fgness = _unit_norm_masked(contrast * centre_w, valid)

    border_ids = torch.cat([segments[0, :], segments[-1, :],
                            segments[:, 0], segments[:, -1]]).long()
    border_count = torch.zeros(k, device=segments.device).index_add_(
        0, border_ids, torch.ones(border_ids.shape, device=segments.device))
    border_ratio = border_count / safe
    total_border = border_count.sum()
    w_bg = border_count / total_border.clamp_min(1.0)
    mu_bg = (mean_lab * w_bg[:, None]).sum(dim=0)
    var_bg = (((mean_lab - mu_bg) ** 2) * w_bg[:, None]).sum()
    sigma_bg = torch.sqrt(var_bg.clamp_min(1e-6))
    d_bg = torch.linalg.vector_norm(mean_lab - mu_bg, dim=1)
    bgness = torch.exp(-(d_bg ** 2) / (2 * (sigma_bg + 1e-6) ** 2))
    bgness = torch.where(total_border > 0, bgness, torch.zeros_like(bgness))
    bgness = torch.maximum(bgness, (border_ratio * 4.0).clamp(0.0, 1.0))
    bgness = _unit_norm_masked(bgness, valid)

    ambiguity = (1.0 - (fgness - bgness).abs()) * valid
    prior = torch.stack([fgness, bgness, ambiguity], dim=1)
    return torch.nan_to_num(prior, nan=0.0, posinf=1.0, neginf=0.0)
