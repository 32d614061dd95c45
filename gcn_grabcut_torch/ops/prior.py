"""Training-free automatic FG/BG saliency prior.

Counterpart of ``gcn_grabcut_tpu/ops/prior.py``: spatially weighted
global colour contrast (dense K x K, or accumulated over column blocks
above LARGE_K_THRESHOLD) times a centre Gaussian (fg-ness); a background
cue max'd with the border ratio (bg-ness): the Gaussian distance to the
border-region colour mean, or, with `bg_connectivity`, the geodesic
boundary connectivity over the region adjacency graph; ambiguity
1 - |fg - bg|.
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


_GEO_INF = 1e30


def geodesic_distance(adj_pairs: torch.Tensor, adj_mask: torch.Tensor,
                      mean_lab: torch.Tensor, border_count: torch.Tensor,
                      valid: torch.Tensor, k: int, n_iters: int,
                      geo_floor: float = 8.0) -> torch.Tensor:
    """(K,) min-plus distance from the valid border regions over the
    adjacency graph, edge cost max(|dLab| - geo_floor, 0), relaxed
    `n_iters` times.  Padded pairs cost _GEO_INF and never relax; a min
    is exact in any order, so the scatter's order does not matter."""
    src = torch.cat([adj_pairs[:, 0], adj_pairs[:, 1]]).long()
    dst = torch.cat([adj_pairs[:, 1], adj_pairs[:, 0]]).long()
    m2 = torch.cat([adj_mask, adj_mask])
    w = torch.linalg.vector_norm(mean_lab[src] - mean_lab[dst], dim=1)
    w = (w - geo_floor).clamp_min(0.0)
    w = torch.where(m2 > 0, w, torch.full_like(w, _GEO_INF))
    d = torch.where((border_count > 0) & (valid > 0),
                    torch.zeros_like(border_count),
                    torch.full_like(border_count, _GEO_INF))
    empty = torch.full_like(d, float("inf"))
    for _ in range(n_iters):
        incoming = empty.scatter_reduce(0, dst, d[src] + w, "amin")
        d = torch.minimum(d, incoming)
    return d


def boundary_connectivity_bg(adj_pairs: torch.Tensor, adj_mask: torch.Tensor,
                             mean_lab: torch.Tensor,
                             border_count: torch.Tensor, valid: torch.Tensor,
                             k: int, n_iters: int, geo_sigma: float = 24.0,
                             geo_floor: float = 8.0) -> torch.Tensor:
    """Geodesic background weight exp(-d^2 / 2 geo_sigma^2) in [0, 1] of
    `geodesic_distance` d: high where a region is reachable from the
    border through low-contrast colour steps."""
    d = geodesic_distance(adj_pairs, adj_mask, mean_lab, border_count,
                          valid, k, n_iters, geo_floor)
    bg = torch.exp(-torch.square(d.clamp_max(1e6)) / (2.0 * geo_sigma ** 2))
    return bg * valid


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
                       contrast_sigma: float = 0.40,
                       adjacency: tuple | None = None,
                       geo_iters: int = 0) -> torch.Tensor:
    """(K, 3) prior [fg-ness, bg-ness, ambiguity], each in [0, 1].

    `stats=(counts, mean_lab, centroids)` are region_statistics' moments.
    `adjacency=(pairs, mask)` with `geo_iters > 0` (`bg_connectivity`)
    replaces the border-colour cue by `boundary_connectivity_bg`."""
    counts, mean_lab, centroids = stats
    counts = counts.float()
    safe = counts.clamp_min(1.0)
    valid = (counts > 0).float()

    area_w = counts / counts.sum().clamp_min(1.0)
    if k > LARGE_K_THRESHOLD:
        contrast = _contrast_blocked(mean_lab, centroids, area_w, k,
                                     contrast_sigma)
    else:
        colour_d = torch.linalg.vector_norm(
            mean_lab[:, None, :] - mean_lab[None, :, :], dim=2)
        spatial_d = torch.linalg.vector_norm(
            centroids[:, None, :] - centroids[None, :, :], dim=2)
        spatial_w = torch.exp(-(spatial_d ** 2) / (2 * contrast_sigma ** 2))
        # Empty clusters carry area 0, so they drop out of the sum.
        contrast = (colour_d * spatial_w * area_w[None, :]).sum(dim=1)
    contrast = _unit_norm_masked(contrast, valid)
    centre_d = torch.linalg.vector_norm(centroids - 0.5, dim=1)
    centre_w = torch.exp(-(centre_d ** 2) / (2 * centre_sigma ** 2))
    fgness = _unit_norm_masked(contrast * centre_w, valid)

    border_ids = torch.cat([segments[0, :], segments[-1, :],
                            segments[:, 0], segments[:, -1]]).long()
    border_count = torch.zeros(k, device=segments.device).index_add_(
        0, border_ids, torch.ones(border_ids.shape, device=segments.device))
    border_ratio = border_count / safe
    if adjacency is not None and geo_iters > 0:
        bgness = boundary_connectivity_bg(*adjacency, mean_lab, border_count,
                                          valid, k, n_iters=geo_iters)
    else:
        total_border = border_count.sum()
        w_bg = border_count / total_border.clamp_min(1.0)
        mu_bg = (mean_lab * w_bg[:, None]).sum(dim=0)
        var_bg = (((mean_lab - mu_bg) ** 2) * w_bg[:, None]).sum()
        sigma_bg = torch.sqrt(var_bg.clamp_min(1e-6))
        d_bg = torch.linalg.vector_norm(mean_lab - mu_bg, dim=1)
        bgness = torch.exp(-(d_bg ** 2) / (2 * (sigma_bg + 1e-6) ** 2))
        bgness = torch.where(total_border > 0, bgness,
                             torch.zeros_like(bgness))
    bgness = torch.maximum(bgness, (border_ratio * 4.0).clamp(0.0, 1.0))
    bgness = _unit_norm_masked(bgness, valid)

    ambiguity = (1.0 - (fgness - bgness).abs()) * valid
    prior = torch.stack([fgness, bgness, ambiguity], dim=1)
    return torch.nan_to_num(prior, nan=0.0, posinf=1.0, neginf=0.0)
