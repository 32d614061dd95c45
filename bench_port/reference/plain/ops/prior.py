"""Training-free automatic FG/BG saliency prior, over a batch.

Counterpart of ``gcn_grabcut_tpu/ops/prior.py`` (which the JAX package
vmaps over a batch): spatially weighted global colour contrast (dense
K x K, or accumulated over column blocks above LARGE_K_THRESHOLD) times a
centre Gaussian (fg-ness); a background cue max'd with the border ratio
(bg-ness): the Gaussian distance to the border-region colour mean, or,
with `bg_connectivity`, the geodesic boundary connectivity over the region
adjacency graph; ambiguity 1 - |fg - bg|.

Every array carries a leading B axis and every reduction is per image, so
an image's prior in a batch is its prior alone, bit for bit.  Reductions
along the last axis of a region row (norms, the dense contrast) keep an
image's bits at any batch size on the card (chip_smoke phase 17 holds
it); sums along a leading axis or down to a few values an image (the
border-colour mean and variance, the blocked contrast's column blocks),
whose kernel's order changes with the batch, are chains of adds in index
order (`ops.region.ordered_sum`).  Sums of integer-valued floats (pixel
and border counts) are exact in any order.
"""

from __future__ import annotations

import torch

from .region import ordered_sum

LARGE_K_THRESHOLD = 2048
_CONTRAST_BLOCK = 1024


def _contrast_blocked(mean_lab, centroids, area_w, k, contrast_sigma):
    """contrast_i = sum_j ||c_i - c_j|| exp(-d_ij^2 / 2s^2) a_j per image
    of (B, K, ...) statistics, summed over column blocks of
    _CONTRAST_BLOCK (O(K·block) memory per image)."""
    blk = _CONTRAST_BLOCK
    B = mean_lab.shape[0]
    kp = ((k + blk - 1) // blk) * blk
    dev = mean_lab.device
    ml = torch.zeros((B, kp, 3), device=dev)
    ml[:, :k] = mean_lab
    ct = torch.zeros((B, kp, 2), device=dev)
    ct[:, :k] = centroids
    aw = torch.zeros((B, kp), device=dev)     # padded areas are 0: inert
    aw[:, :k] = area_w
    inv2s2 = 1.0 / (2 * contrast_sigma ** 2)
    acc = torch.zeros((B, kp), device=dev)
    for j0 in range(0, kp, blk):
        cd = torch.linalg.vector_norm(ml[:, :, None, :]
                                      - ml[:, None, j0:j0 + blk], dim=-1)
        sd2 = ((ct[:, :, None, :] - ct[:, None, j0:j0 + blk]) ** 2).sum(-1)
        w = torch.exp(-sd2 * inv2s2)
        acc = acc + ordered_sum(cd * w * aw[:, None, j0:j0 + blk])
    return acc[:, :k]


_GEO_INF = 1e30


def _per_image_ids(idx: torch.Tensor, k: int) -> torch.Tensor:
    """(B, P) indices into each image's K rows -> ids into the batch's
    B·K rows, flat."""
    B = idx.shape[0]
    return (idx.long() + torch.arange(B, device=idx.device)[:, None] * k
            ).reshape(-1)


def geodesic_distance(adj_pairs: torch.Tensor, adj_mask: torch.Tensor,
                      mean_lab: torch.Tensor, border_count: torch.Tensor,
                      valid: torch.Tensor, k: int, n_iters: int,
                      geo_floor: float = 8.0) -> torch.Tensor:
    """(B, K) min-plus distance from each image's valid border regions over
    its adjacency graph, edge cost max(|dLab| - geo_floor, 0), relaxed
    `n_iters` times.  Padded pairs cost _GEO_INF and never relax; a min
    is exact in any order, so the scatter's order does not matter."""
    B = mean_lab.shape[0]
    src = torch.cat([adj_pairs[..., 0], adj_pairs[..., 1]], dim=-1)
    dst = torch.cat([adj_pairs[..., 1], adj_pairs[..., 0]], dim=-1)
    src, dst = _per_image_ids(src, k), _per_image_ids(dst, k)
    m2 = torch.cat([adj_mask, adj_mask], dim=-1).reshape(-1)
    flat_lab = mean_lab.reshape(B * k, -1)
    w = torch.linalg.vector_norm(flat_lab[src] - flat_lab[dst], dim=-1)
    w = (w - geo_floor).clamp_min(0.0)
    w = torch.where(m2 > 0, w, torch.full_like(w, _GEO_INF))
    d = torch.where((border_count > 0) & (valid > 0),
                    torch.zeros_like(border_count),
                    torch.full_like(border_count, _GEO_INF)).reshape(-1)
    empty = torch.full_like(d, float("inf"))
    for _ in range(n_iters):
        incoming = empty.scatter_reduce(0, dst, d[src] + w, "amin")
        d = torch.minimum(d, incoming)
    return d.reshape(B, k)


def boundary_connectivity_bg(adj_pairs: torch.Tensor, adj_mask: torch.Tensor,
                             mean_lab: torch.Tensor,
                             border_count: torch.Tensor, valid: torch.Tensor,
                             k: int, n_iters: int, geo_sigma: float = 24.0,
                             geo_floor: float = 8.0) -> torch.Tensor:
    """Geodesic background weight exp(-d^2 / 2 geo_sigma^2) in [0, 1] of
    `geodesic_distance` d, (B, K): high where a region is reachable from
    the border through low-contrast colour steps."""
    d = geodesic_distance(adj_pairs, adj_mask, mean_lab, border_count,
                          valid, k, n_iters, geo_floor)
    bg = torch.exp(-torch.square(d.clamp_max(1e6)) / (2.0 * geo_sigma ** 2))
    return bg * valid


def _unit_norm_masked(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max to [0, 1] over each image's valid entries of (B, K);
    constant vectors -> zeros."""
    mn = torch.where(valid > 0, v, torch.full_like(v, 1e30)).amin(
        dim=-1, keepdim=True)
    mx = torch.where(valid > 0, v, torch.full_like(v, -1e30)).amax(
        dim=-1, keepdim=True)
    rng = mx - mn
    out = torch.where(rng < 1e-8, torch.zeros_like(v),
                      (v - mn) / (rng + 1e-12))
    return out * valid


def compute_auto_prior(segments: torch.Tensor, k: int, stats: tuple,
                       centre_sigma: float = 0.45,
                       contrast_sigma: float = 0.40,
                       adjacency: tuple | None = None,
                       geo_iters: int = 0) -> torch.Tensor:
    """(B, K, 3) prior [fg-ness, bg-ness, ambiguity], each in [0, 1], of
    (B, H, W) label maps.

    `stats=(counts, mean_lab, centroids)` are region_statistics' (B, K, ...)
    moments.  `adjacency=(pairs, mask)` with `geo_iters > 0`
    (`bg_connectivity`) replaces the border-colour cue by
    `boundary_connectivity_bg`."""
    counts, mean_lab, centroids = stats
    B = segments.shape[0]
    dev = segments.device
    counts = counts.float()
    safe = counts.clamp_min(1.0)
    valid = (counts > 0).float()

    # Integer-valued: the sum is exact in any order.
    area_w = counts / counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
    if k > LARGE_K_THRESHOLD:
        contrast = _contrast_blocked(mean_lab, centroids, area_w, k,
                                     contrast_sigma)
    else:
        colour_d = torch.linalg.vector_norm(
            mean_lab[:, :, None, :] - mean_lab[:, None, :, :], dim=-1)
        spatial_d = torch.linalg.vector_norm(
            centroids[:, :, None, :] - centroids[:, None, :, :], dim=-1)
        spatial_w = torch.exp(-(spatial_d ** 2) / (2 * contrast_sigma ** 2))
        # Empty clusters carry area 0, so they drop out of the sum.
        contrast = (colour_d * spatial_w * area_w[:, None, :]).sum(dim=-1)
    contrast = _unit_norm_masked(contrast, valid)
    centre_d = torch.linalg.vector_norm(centroids - 0.5, dim=-1)
    centre_w = torch.exp(-(centre_d ** 2) / (2 * centre_sigma ** 2))
    fgness = _unit_norm_masked(contrast * centre_w, valid)

    border_ids = torch.cat([segments[:, 0, :], segments[:, -1, :],
                            segments[:, :, 0], segments[:, :, -1]], dim=-1)
    border_ids = _per_image_ids(border_ids, k)
    border_count = torch.zeros(B * k, device=dev).index_add_(
        0, border_ids, torch.ones(border_ids.shape, device=dev)
    ).reshape(B, k)
    border_ratio = border_count / safe
    if adjacency is not None and geo_iters > 0:
        bgness = boundary_connectivity_bg(*adjacency, mean_lab, border_count,
                                          valid, k, n_iters=geo_iters)
    else:
        total_border = border_count.sum(dim=-1, keepdim=True)
        w_bg = border_count / total_border.clamp_min(1.0)
        mu_bg = ordered_sum((mean_lab * w_bg[..., None]).transpose(1, 2))
        var_bg = ordered_sum((((mean_lab - mu_bg[:, None, :]) ** 2)
                              * w_bg[..., None]).reshape(B, -1))
        sigma_bg = torch.sqrt(var_bg.clamp_min(1e-6))[:, None]
        d_bg = torch.linalg.vector_norm(mean_lab - mu_bg[:, None, :], dim=-1)
        bgness = torch.exp(-(d_bg ** 2) / (2 * (sigma_bg + 1e-6) ** 2))
        bgness = torch.where(total_border > 0, bgness,
                             torch.zeros_like(bgness))
    bgness = torch.maximum(bgness, (border_ratio * 4.0).clamp(0.0, 1.0))
    bgness = _unit_norm_masked(bgness, valid)

    ambiguity = (1.0 - (fgness - bgness).abs()) * valid
    prior = torch.stack([fgness, bgness, ambiguity], dim=-1)
    return torch.nan_to_num(prior, nan=0.0, posinf=1.0, neginf=0.0)
