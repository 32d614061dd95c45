"""Full-covariance GMM colour models for GrabCut.

Counterpart of ``gcn_grabcut_tpu/ops/gmm.py``: weighted k-means seeding,
moment re-estimation with OpenCV-style covariance regularisation, component
assignment and the mixture log-likelihood, as masked dense reductions.

k-means++ draws its seeds with the JAX package's own Gumbel noise
(``ops/threefry.py`` reproduces its ``jax.random`` bits), so both packages
start GrabCut from the same components.
"""

from __future__ import annotations

import torch

from .threefry import kmeans_pp_noise

COV_REG = 0.01
DET_EPS = 1e-6
LOG_FLOOR = -80.0


def _sq_dist(flat: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return ((flat[:, None, :] - centers[None, :, :]) ** 2).sum(dim=-1)


def kmeans(pixels: torch.Tensor, weight: torch.Tensor, k: int,
           n_iter: int = 10, seed: int = 0) -> torch.Tensor:
    """Weighted Lloyd k-means over (H, W, 3) pixels -> (H, W) labels.

    k-means++ initialisation: the first centre is the max-weight pixel,
    each next one a Gumbel-max draw proportional to weight x squared
    distance to the nearest chosen centre, with the JAX package's noise
    under ``PRNGKey(seed)``."""
    H, W, C = pixels.shape
    flat = pixels.reshape(-1, C).float()
    w = weight.reshape(-1).float()
    dev = flat.device
    centers = torch.zeros((k, C), device=dev)
    centers[0] = flat[torch.argmax(w)]
    arange_k = torch.arange(k, device=dev)
    noise = kmeans_pp_noise(seed, H * W, k - 1)
    for i in range(k - 1):
        inactive = torch.where(arange_k <= i, 0.0, float("inf"))
        d2 = (_sq_dist(flat, centers) + inactive[None, :]).amin(dim=1)
        logits = torch.log((w * d2).clamp_min(1e-30))
        gumbel = torch.tensor(noise[i], device=dev)
        centers[i + 1] = flat[torch.argmax(logits + gumbel)]

    for _ in range(n_iter):
        lab = torch.argmin(_sq_dist(flat, centers), dim=1)
        onehot = torch.nn.functional.one_hot(lab, k).float() * w[:, None]
        tot = onehot.T @ flat
        cnt = onehot.sum(dim=0)[:, None]
        new = tot / cnt.clamp_min(1e-6)
        centers = torch.where(cnt > 0, new, centers)
    return torch.argmin(_sq_dist(flat, centers), dim=1).reshape(H, W)


def _inv3(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form inverse and determinant of batched 3x3 matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det.clamp_min(DET_EPS)[..., None, None], det


def fit_gmm(pixels: torch.Tensor, sel: torch.Tensor, comp: torch.Tensor,
            k: int) -> dict:
    """k-component full-covariance GMM from the selected pixels' component
    assignment: weights (k,), means (k, 3), inv_cov (k, 3, 3), log_norm
    (k,) = log w_c - 0.5 log det, counts (k,)."""
    C = pixels.shape[-1]
    flat = pixels.reshape(-1, C).float()
    m = sel.reshape(-1).float()
    onehot = torch.nn.functional.one_hot(comp.reshape(-1), k).float() \
        * m[:, None]
    cnt = onehot.sum(dim=0)
    total = m.sum().clamp_min(1.0)
    means = (onehot.T @ flat) / cnt.clamp_min(1.0)[:, None]
    xxT = torch.einsum("nk,nc,nd->kcd", onehot, flat, flat)
    cov = xxT / cnt.clamp_min(1.0)[:, None, None] \
        - means[:, :, None] * means[:, None, :]
    eye = torch.eye(C, device=flat.device)
    for _ in range(2):
        _, det = _inv3(cov)
        cov = cov + eye * COV_REG * (det < DET_EPS).float()[:, None, None]
    inv_cov, det = _inv3(cov)
    weights = cnt / total
    log_norm = torch.where(
        cnt > 0,
        torch.log(weights.clamp_min(1e-30))
        - 0.5 * torch.log(det.clamp_min(DET_EPS)),
        torch.full_like(cnt, LOG_FLOOR))
    return dict(weights=weights, means=means, inv_cov=inv_cov,
                log_norm=log_norm, counts=cnt)


def component_scores(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(H, W, k) weighted log component densities (up to a constant)."""
    d = pixels[..., None, :] - gmm["means"]               # (H, W, k, 3)
    maha = torch.einsum("...ki,kij,...kj->...k", d, gmm["inv_cov"], d)
    return gmm["log_norm"] - 0.5 * maha


def assign_components(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(H, W) best component per pixel (cv2 assignGMMsComponents)."""
    return torch.argmax(component_scores(pixels, gmm), dim=-1)


def gmm_log_prob(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(H, W) log of the weighted mixture density (up to a constant)."""
    scores = component_scores(pixels, gmm)
    peak = scores.amax(dim=-1)
    lse = peak + torch.log(torch.exp(scores - peak[..., None]).sum(dim=-1))
    return lse.clamp_min(LOG_FLOOR)
