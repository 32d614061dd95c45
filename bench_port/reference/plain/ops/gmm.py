"""Full-covariance GMM colour models for GrabCut.

Counterpart of ``gcn_grabcut_tpu/ops/gmm.py``: weighted k-means seeding,
moment re-estimation with OpenCV-style covariance regularisation, component
assignment and the mixture log-likelihood, as masked dense reductions.

k-means++ draws its seeds with the JAX package's own Gumbel noise
(``ops/threefry.py`` reproduces its ``jax.random`` bits), so both packages
start GrabCut from the same components.

Every step takes an optional leading batch dimension (the JAX package
``vmap``s them), and an image's bits do not depend on the batch it is in:
sums over pixels run in float64 and round once (exact for RGB pixels and
0 / 1 weights), and sums over colour channels and components are written
out as float32 adds of a fixed order.
"""

from __future__ import annotations

import torch

from .threefry import kmeans_pp_noise

COV_REG = 0.01
DET_EPS = 1e-6
LOG_FLOOR = -80.0


def _channel_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last (small) dimension as sequential float32 adds, so
    the order is the same at every batch size and on every device."""
    out = a[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c]
    return out


def _pixel_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the pixel axis (-2) in float64, rounded once to float32.
    The addends here are products of pixel values and 0 / 1 weights:
    integers for RGB, whose float64 sums are exact in any order, so the
    bits do not depend on the batch, the device or the library's
    summation order."""
    return a.double().sum(dim=-2).float()


def _pixel_matmul(onehot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., N, k)^T (..., N, C) -> (..., k, C) in float64, rounded once
    to float32 (exact for RGB, as `_pixel_sum`)."""
    return (onehot.double().transpose(-1, -2) @ x.double()).float()


def _sq_dist(flat: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, k, C) -> (B, N, k) squared distances."""
    return _channel_sum((flat[:, :, None, :] - centers[:, None, :, :]) ** 2)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx[b]] for (B, N, C) `a` and (B,) `idx` -> (B, C)."""
    return torch.gather(a, 1, idx[:, None, None].expand(-1, 1, a.shape[-1])
                        )[:, 0]


def kmeans(pixels: torch.Tensor, weight: torch.Tensor, k: int,
           n_iter: int = 10, seed: int = 0) -> torch.Tensor:
    """Weighted Lloyd k-means over (..., H, W, 3) pixels -> (..., H, W)
    labels; leading dimensions are a batch of images, each clustered on
    its own.

    k-means++ initialisation: the first centre is the max-weight pixel,
    each next one a Gumbel-max draw proportional to weight x squared
    distance to the nearest chosen centre, with the JAX package's noise
    under ``PRNGKey(seed)`` (the same draws for every image of a batch, as
    under the JAX package's ``vmap``)."""
    *lead, H, W, C = pixels.shape
    flat = pixels.reshape(-1, H * W, C).float()
    w = weight.reshape(-1, H * W).float()
    dev = flat.device
    centers = torch.zeros((flat.shape[0], k, C), device=dev)
    centers[:, 0] = _rows(flat, torch.argmax(w, dim=1))
    arange_k = torch.arange(k, device=dev)
    noise = kmeans_pp_noise(seed, H * W, k - 1)
    for i in range(k - 1):
        inactive = torch.where(arange_k <= i, 0.0, float("inf"))
        d2 = (_sq_dist(flat, centers) + inactive).amin(dim=-1)
        logits = torch.log((w * d2).clamp_min(1e-30))
        gumbel = torch.tensor(noise[i], device=dev)
        centers[:, i + 1] = _rows(flat, torch.argmax(logits + gumbel, dim=1))

    for _ in range(n_iter):
        lab = torch.argmin(_sq_dist(flat, centers), dim=-1)
        onehot = torch.nn.functional.one_hot(lab, k).float() * w[..., None]
        tot = _pixel_matmul(onehot, flat)
        cnt = _pixel_sum(onehot)[..., None]
        new = tot / cnt.clamp_min(1e-6)
        centers = torch.where(cnt > 0, new, centers)
    return torch.argmin(_sq_dist(flat, centers), dim=-1).reshape(*lead, H, W)


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
    (k,) = log w_c - 0.5 log det, counts (k,).  `pixels` (..., H, W, 3)
    with `sel`, `comp` (..., H, W): leading dimensions are a batch of
    images, and every entry gains them."""
    *lead, H, W, C = pixels.shape
    flat = pixels.reshape(-1, H * W, C).float()
    m = sel.reshape(-1, H * W).float()
    onehot = torch.nn.functional.one_hot(comp.reshape(-1, H * W), k).float() \
        * m[..., None]
    cnt = _pixel_sum(onehot)                                  # (B, k)
    total = _pixel_sum(m[..., None])[..., 0].clamp_min(1.0)   # (B,)
    means = _pixel_matmul(onehot, flat) / cnt.clamp_min(1.0)[..., None]
    xx = (flat[..., :, None] * flat[..., None, :]).reshape(-1, H * W, C * C)
    xxT = _pixel_matmul(onehot, xx).reshape(-1, k, C, C)
    cov = xxT / cnt.clamp_min(1.0)[..., None, None] \
        - means[..., :, None] * means[..., None, :]
    eye = torch.eye(C, device=flat.device)
    for _ in range(2):
        _, det = _inv3(cov)
        cov = cov + eye * COV_REG * (det < DET_EPS).float()[..., None, None]
    inv_cov, det = _inv3(cov)
    weights = cnt / total[:, None]
    log_norm = torch.where(
        cnt > 0,
        torch.log(weights.clamp_min(1e-30))
        - 0.5 * torch.log(det.clamp_min(DET_EPS)),
        torch.full_like(cnt, LOG_FLOOR))
    out = dict(weights=weights, means=means, inv_cov=inv_cov,
               log_norm=log_norm, counts=cnt)
    return {n: a.reshape(*lead, *a.shape[1:]) for n, a in out.items()}


def component_scores(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(..., H, W, k) weighted log component densities (up to a
    constant), each image of a batch under its own GMM.  The quadratic
    form d^T A d is written out in float32 adds of a fixed order."""
    d = pixels[..., None, :] - gmm["means"][..., None, None, :, :]
    A = gmm["inv_cov"][..., None, None, :, :, :]     # (..., 1, 1, k, 3, 3)
    C = d.shape[-1]
    maha = None
    for j in range(C):
        t = d[..., 0] * A[..., 0, j]
        for i in range(1, C):
            t = t + d[..., i] * A[..., i, j]
        maha = t * d[..., j] if maha is None else maha + t * d[..., j]
    return gmm["log_norm"][..., None, None, :] - 0.5 * maha


def assign_components(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(..., H, W) best component per pixel (cv2 assignGMMsComponents)."""
    return torch.argmax(component_scores(pixels, gmm), dim=-1)


def gmm_log_prob(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(..., H, W) log of the weighted mixture density (up to a
    constant)."""
    scores = component_scores(pixels, gmm)
    peak = scores.amax(dim=-1)
    lse = peak + torch.log(_channel_sum(torch.exp(scores - peak[..., None])))
    return lse.clamp_min(LOG_FLOOR)
