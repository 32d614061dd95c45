"""SLIC superpixels on a fixed seed grid, at static shapes.

Counterpart of ``gcn_grabcut_tpu/ops/slic.py``: cluster seeds live on a
``gh x gw`` grid (K = gh·gw labels, static), each pixel searches the 3x3
grid neighbourhood of its home cell, a fixed number of k-means iterations
run in LABXY space, and connectivity is repaired by orphan absorption and a
min-label component pass.

The JAX package moves values between pixels and cells with one-hot matmuls
(a TPU workaround for slow gathers); here the same exchange is a gather
(cells -> pixels) and a fixed-order segment sum (pixels -> cells; the same
labels in every run on the card).  The sums are the same up to float32
summation order, so near-tied argmins can flip at a few pixels: compare
labels by agreement, not bit equality.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .region import segment_sum

_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_BIG = 1e9   # sentinel centre for out-of-grid candidates


def grid_shape(h: int, w: int, n_segments: int) -> tuple[int, int]:
    """Seed grid (gh, gw) with gh*gw ≈ n_segments, cells ~square."""
    step = math.sqrt(h * w / max(n_segments, 1))
    return max(1, round(h / step)), max(1, round(w / step))


def slic_num_labels(h: int, w: int, n_segments: int) -> int:
    gh, gw = grid_shape(h, w, n_segments)
    return gh * gw


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of an (H, W, C) image, reflect borders."""
    radius = max(1, int(3 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    k = k / k.sum()

    def conv_axis(a, dim):
        n = a.shape[dim]
        hwc = a.permute(2, 0, 1)[None]                   # (1, C, H, W)
        pad = (0, 0, radius, radius) if dim == 0 else (radius, radius, 0, 0)
        ap = F.pad(hwc, pad, mode="reflect")[0].permute(1, 2, 0)
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * ap.narrow(dim, i, n)
        return out

    return conv_axis(conv_axis(img, 0), 1)


def slic(lab: torch.Tensor, n_segments: int = 300, compactness: float = 10.0,
         n_iter: int = 10, smooth_sigma: float = 1.0) -> torch.Tensor:
    """Segment `lab` (H, W, 3) into K = gh*gw superpixels; (H, W) int64
    labels in [0, K)."""
    H, W, _ = lab.shape
    dev = lab.device
    gh, gw = grid_shape(H, W, n_segments)
    K = gh * gw
    sy, sx = H / gh, W / gw
    s_avg = math.sqrt(sy * sx)

    lab = lab.float()
    if smooth_sigma > 0:
        lab = _gaussian_blur(lab, smooth_sigma)

    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)

    cy = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * sy
    cx = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * sx
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), dim=-1)
    seed_y = cyx[..., 0].long().clamp(0, H - 1)
    seed_x = cyx[..., 1].long().clamp(0, W - 1)
    centers = torch.cat([lab[seed_y, seed_x], cyx], dim=-1)   # (gh, gw, 5)

    base_cy = (yy[:, 0] / sy).long().clamp(0, gh - 1)          # (H,)
    base_cx = (xx[0, :] / sx).long().clamp(0, gw - 1)          # (W,)
    inv_s2 = (compactness / s_avg) ** 2
    dys = torch.tensor([o[0] for o in _OFFSETS], device=dev)
    dxs = torch.tensor([o[1] for o in _OFFSETS], device=dev)

    def shifted_centers(c):
        """(gh, gw, 9, 5): candidate centre per cell and offset."""
        cp = F.pad(c.permute(2, 0, 1), (1, 1, 1, 1), value=_BIG)
        return torch.stack([cp[:, 1 + dy:1 + dy + gh, 1 + dx:1 + dx + gw]
                            for dy, dx in _OFFSETS], dim=-1
                           ).permute(1, 2, 3, 0)

    def assign(c):
        """Best of 9 candidates per pixel: (labels, offset index)."""
        cand = shifted_centers(c)[base_cy[:, None], base_cx[None, :]]
        d_lab = ((lab[:, :, None, :] - cand[..., :3]) ** 2).sum(dim=-1)
        d_xy = ((yy[..., None] - cand[..., 3]) ** 2
                + (xx[..., None] - cand[..., 4]) ** 2)
        choice = torch.argmin(d_lab + d_xy * inv_s2, dim=-1)   # (H, W)
        lbl = ((base_cy[:, None] + dys[choice]) * gw
               + base_cx[None, :] + dxs[choice])
        return lbl

    feats = torch.cat([lab, yy[..., None], xx[..., None],
                       torch.ones((H, W, 1), device=dev)], dim=-1)
    flat_feats = feats.reshape(-1, 6)
    for _ in range(n_iter):
        lbl = assign(centers)
        total = segment_sum(lbl.reshape(-1), flat_feats, K)
        total = total.reshape(gh, gw, 6)
        cnts = total[..., 5]
        means = total[..., :5] / cnts.clamp_min(1.0)[..., None]
        centers = torch.where((cnts > 0)[..., None], means, centers)
    labels = assign(centers)
    labels = _absorb_orphans(labels, n_sweeps=4)
    return enforce_connectivity(labels, K)


def _edge_neighbours(lb: torch.Tensor):
    """(up, down, left, right) neighbours with edge replication."""
    up = torch.cat([lb[:1], lb[:-1]], dim=0)
    dn = torch.cat([lb[1:], lb[-1:]], dim=0)
    lf = torch.cat([lb[:, :1], lb[:, :-1]], dim=1)
    rt = torch.cat([lb[:, 1:], lb[:, -1:]], dim=1)
    return up, dn, lf, rt


def _parity(H: int, W: int, device) -> torch.Tensor:
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy + xx) % 2


def _absorb_orphans(labels: torch.Tensor, n_sweeps: int = 2) -> torch.Tensor:
    """A pixel none of whose 4-neighbours shares its label adopts the most
    frequent neighbouring label (checkerboard half-sweeps)."""
    parity = _parity(*labels.shape, labels.device)

    def half_sweep(lb, phase):
        nbrs = _edge_neighbours(lb)
        same = ((nbrs[0] == lb) | (nbrs[1] == lb) | (nbrs[2] == lb)
                | (nbrs[3] == lb))
        counts = [sum((n == cand).int() for n in nbrs) for cand in nbrs]
        best, best_c = nbrs[0], counts[0]
        for cand, c in zip(nbrs[1:], counts[1:]):
            take = c > best_c
            best = torch.where(take, cand, best)
            best_c = torch.where(take, c, best_c)
        move = ~same & (parity == phase)
        return torch.where(move, best, lb)

    for _ in range(n_sweeps):
        labels = half_sweep(half_sweep(labels, 0), 1)
    return labels


def _fill_neighbours(a: torch.Tensor, fill):
    """(up, down, left, right) neighbours, out-of-image filled."""
    row = torch.full_like(a[:1], fill)
    col = torch.full_like(a[:, :1], fill)
    return (torch.cat([row, a[:-1]], dim=0), torch.cat([a[1:], row], dim=0),
            torch.cat([col, a[:, :-1]], dim=1),
            torch.cat([a[:, 1:], col], dim=1))


def enforce_connectivity(labels: torch.Tensor, k: int,
                         max_sweeps: int = 64) -> torch.Tensor:
    """Make every label one connected region: min-index components, keep
    each label's largest component, minor fragments adopt a neighbouring
    major label.  Loops test convergence once per block of steps, as the
    JAX while loops do."""
    H, W = labels.shape
    hw = H * W
    dev = labels.device
    idx = torch.arange(hw, device=dev).reshape(H, W)
    nb_l = _fill_neighbours(labels, -1)
    same = [n == labels for n in nb_l]
    big = torch.full_like(idx, hw)

    comp = idx
    for _ in range(max_sweeps):
        new = comp
        for _ in range(4):
            step = new
            for nb_c, s in zip(_fill_neighbours(new, hw), same):
                step = torch.minimum(step, torch.where(s, nb_c, big))
            new = step
        changed = bool((new < comp).any())
        comp = new
        if not changed:
            break

    flat_comp = comp.reshape(-1)
    sizes = torch.zeros(hw, dtype=torch.float32, device=dev).index_add_(
        0, flat_comp, torch.ones(hw, dtype=torch.float32, device=dev))
    comp_size = sizes[flat_comp].reshape(H, W)
    # (size, -comp) in float32, as the JAX package computes it: ties and
    # float32 rounding resolve identically.
    score = comp_size * hw - comp.float()
    label_best = torch.full((k,), float("-inf"), device=dev).scatter_reduce(
        0, labels.reshape(-1), score.reshape(-1), reduce="amax",
        include_self=True)
    minor = score < label_best[labels]

    parity = _parity(H, W, dev)
    for _ in range(max_sweeps):
        new_lab, new_minor = labels, minor
        for phase in (0, 1, 0, 1):
            cand_l = _fill_neighbours(new_lab, -1)
            cand_m = _fill_neighbours(new_minor, True)
            take = torch.full_like(new_lab, -1)
            for nl, nm in zip(cand_l, cand_m):
                ok = ~nm & (nl >= 0)
                take = torch.where((take < 0) & ok, nl, take)
            move = new_minor & (take >= 0) & (parity == phase)
            new_lab = torch.where(move, take, new_lab)
            new_minor = new_minor & ~move
        changed = bool((new_minor != minor).any())
        labels, minor = new_lab, new_minor
        if not changed:
            break
    return labels
