"""Image-plane primitives: colour conversions, Sobel gradients, box and
guided filters, bilinear resize.

Counterpart of ``gcn_grabcut_tpu/ops/image.py``.  Colour functions take
(..., 3) float32 RGB in 0..255 and keep the channel axis last; filters take
(..., H, W) planes, so every function takes a leading batch axis, and an
image's planes in a batch are its planes alone, bit for bit.  The box
filter keeps the cumulative-sum formulation so its float32 rounding follows
the JAX package's.  Constants reach the card by one copy from pinned
memory per device (no host sync).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_XYZ_FROM_RGB = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_WHITE_D65 = (0.95047, 1.0, 1.08883)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (cv2 COLOR_RGB2GRAY), 0..255 in and out."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _to_device(arrays, device: torch.device) -> tuple:
    """Host numpy arrays as tensors on `device`, a card's copied from
    pinned memory without blocking the host (no sync)."""
    return tuple(torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
                 if device.type == "cuda" else torch.from_numpy(a)
                 for a in arrays)


@functools.cache
def _xyz_constants(device: torch.device) -> tuple:
    """The RGB -> XYZ matrix and the D65 white point, float32 on
    `device`, copied there once."""
    return _to_device((np.asarray(_XYZ_FROM_RGB, np.float32),
                       np.asarray(_WHITE_D65, np.float32)), device)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """CIELAB (D65, 2° observer) as skimage.color.rgb2lab."""
    rgb01 = (rgb.float() / 255.0).clamp(0.0, 1.0)
    lin = srgb_to_linear(rgb01)
    m, white = _xyz_constants(rgb.device)
    # cuBLAS picks this product's kernel by its size, so a batch could
    # round an image's XYZ differently than the image alone; at the build's
    # shapes it does not (chip_smoke phase 17 holds the whole build to
    # that), and the einsum keeps the per-image build's bits.
    xyz = torch.einsum("...c,kc->...k", lin, m) / white
    eps = 0.008856
    kappa = 7.787
    f = torch.where(xyz > eps, xyz.clamp_min(0.0) ** (1.0 / 3.0),
                    kappa * xyz + 16.0 / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """HSV as skimage.color.rgb2hsv: all channels in [0, 1]."""
    rgb01 = rgb.float() / 255.0
    v = rgb01.amax(dim=-1)
    mn = rgb01.amin(dim=-1)
    delta = v - mn
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    h = torch.where(v == r, (g - b) / safe,
                    torch.where(v == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    s = torch.where(v == 0, torch.zeros_like(v),
                    delta / torch.where(v == 0, torch.ones_like(v), v))
    return torch.stack([h, s, v], dim=-1)


def reflect101_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of the last two axes (cv2 default)."""
    lead = img.shape[:-2]
    flat = img.reshape(1, -1, *img.shape[-2:])
    out = F.pad(flat, (r, r, r, r), mode="reflect")
    return out.reshape(*lead, *out.shape[-2:])


def sobel(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gx, gy of (..., H, W) planes (cv2.Sobel ksize=3)."""
    H, W = gray.shape[-2:]
    p = reflect101_pad(gray, 1)

    def sh(dy, dx):
        return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    gx = (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1)
          - sh(-1, -1) - 2 * sh(0, -1) - sh(1, -1))
    gy = (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)
          - sh(-1, -1) - 2 * sh(-1, 0) - sh(-1, 1))
    return gx, gy


def gradient_magnitude(gray: torch.Tensor) -> torch.Tensor:
    gx, gy = sobel(gray)
    return torch.sqrt(gx * gx + gy * gy)


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 mean filter of (..., H, W) planes with REFLECT_101 borders
    (cv2.blur), as two cumulative-sum window passes.  Each cumulative sum
    runs along an axis that is not the last, which CUDA scans one element
    after another per column, as the CPU does: a scan along the last axis
    may split its rows into tiles by their place in the batch, and so round
    an image's sums differently in a batch than alone."""
    if radius <= 0:
        return img
    k = 2 * radius + 1
    H, W = img.shape[-2:]
    x = reflect101_pad(img, radius)

    def window_sum(a, out_len):
        c = torch.cumsum(a, dim=-2)
        upper = c.narrow(-2, k - 1, out_len)
        lower = torch.cat([torch.zeros_like(c.narrow(-2, 0, 1)),
                           c.narrow(-2, 0, out_len - 1)], dim=-2)
        return upper - lower

    s = window_sum(x, H)
    s = window_sum(s.transpose(-1, -2), W).transpose(-1, -2)
    return s / float(k * k)


def _linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(...,
    "linear")`` along one axis, as its ``compute_weight_mat`` builds them:
    a triangle kernel at the output samples' centres, widened by
    1 / scale when downsampling (antialiasing), normalised over the taps
    inside the image."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


@functools.cache
def _resize_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero taps of `_linear_resize_weights(n_in, n_out)`: (T,
    n_out) input indices in ascending order and their weights, padded with
    index 0 and weight 0."""
    w = _linear_resize_weights(n_in, n_out)
    nz = w != 0
    taps = max(int(nz.sum(axis=0).max()), 1)
    idx = np.zeros((taps, n_out), np.int64)
    wt = np.zeros((taps, n_out), np.float32)
    for j in range(n_out):
        rows = np.nonzero(nz[:, j])[0]
        idx[:len(rows), j] = rows
        wt[:len(rows), j] = w[rows, j]
    return idx, wt


@functools.cache
def _device_taps(n_in: int, n_out: int, device: torch.device) -> tuple:
    """`_resize_taps` on `device`, copied there once."""
    return _to_device(_resize_taps(n_in, n_out), device)


def _resize_axis(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """Resample axis `dim` of `x` to `n_out` samples: each output a chain
    of multiply-adds over its taps in ascending input order."""
    idx, wt = _device_taps(x.shape[dim], n_out, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = x.index_select(dim, idx[0]) * wt[0].reshape(shape)
    for t in range(1, idx.shape[0]):
        out = out + x.index_select(dim, idx[t]) * wt[t].reshape(shape)
    return out


def resize_bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """(B, H, W, C) -> (B, H', W', C) bilinear resize with
    ``jax.image.resize(..., "linear")``'s weights (antialiased when
    downsampling), rows then columns.  The JAX package takes each axis as
    a matmul with the dense weights; here each output sums its few nonzero
    taps in a fixed order, so an image's resize in a batch is its resize
    alone, on every device."""
    H, W = x.shape[1:3]
    out = x.float()
    if out_hw[0] != H:
        out = _resize_axis(out, 1, out_hw[0])
    if out_hw[1] != W:
        out = _resize_axis(out, 2, out_hw[1])
    return out


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 8,
                  eps: float = 1e-3) -> torch.Tensor:
    """He et al. 2010 guided filter, the six-box-filter formulation."""
    mean_g = box_filter(guide, radius)
    mean_s = box_filter(src, radius)
    cov_gs = box_filter(guide * src, radius) - mean_g * mean_s
    var_g = box_filter(guide * guide, radius) - mean_g * mean_g
    a = cov_gs / (var_g + eps)
    b = mean_s - a * mean_g
    return box_filter(a, radius) * guide + box_filter(b, radius)
