"""SLIC superpixels on a fixed seed grid, at static shapes, over a batch.

Counterpart of ``gcn_grabcut_tpu/ops/slic.py`` (which the JAX package
vmaps over a batch): cluster seeds live on a ``gh x gw`` grid (K = gh·gw
labels, static), each pixel searches the 3x3 grid neighbourhood of its home
cell, a fixed number of k-means iterations run in LABXY space, and
connectivity is repaired by orphan absorption and a min-label component
pass.  Images are (B, H, W, 3), labels (B, H, W).

The JAX package moves values between pixels and cells with one-hot matmuls
(a TPU workaround for slow gathers); here the same exchange is a gather
(cells -> pixels) and a fixed-order segment sum over ids b·K + label
(pixels -> cells; the same labels in every run on any device, and an image's
chains in a batch are its chains alone).  The sums are the same up to
float32 summation order, so near-tied argmins can flip at a few pixels:
compare labels with the JAX package's by agreement, not bit equality.

The connectivity repair (`repair_connectivity`: orphan absorption, then
the components' enforcement) runs eager loops that test the batch's
convergence on the host, in place of the JAX package's
``lax.while_loop``s.
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
    """Separable Gaussian of (B, H, W, C) images, reflect borders."""
    radius = max(1, int(3 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    k = k / k.sum()

    def conv_axis(a, dim):
        n = a.shape[dim]
        bchw = a.permute(0, 3, 1, 2)                     # (B, C, H, W)
        pad = (0, 0, radius, radius) if dim == 1 else (radius, radius, 0, 0)
        ap = F.pad(bchw, pad, mode="reflect").permute(0, 2, 3, 1)
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * ap.narrow(dim, i, n)
        return out

    return conv_axis(conv_axis(img, 1), 2)


def slic(lab: torch.Tensor, n_segments: int = 300, compactness: float = 10.0,
         n_iter: int = 10, smooth_sigma: float = 1.0) -> torch.Tensor:
    """Segment each image of `lab` (B, H, W, 3) into K = gh*gw
    superpixels; (B, H, W) int64 labels in [0, K)."""
    B, H, W, _ = lab.shape
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
    centers = torch.cat([lab[:, seed_y, seed_x],
                         cyx.expand(B, gh, gw, 2)], dim=-1)  # (B, gh, gw, 5)

    base_cy = (yy[:, 0] / sy).long().clamp(0, gh - 1)          # (H,)
    base_cx = (xx[0, :] / sx).long().clamp(0, gw - 1)          # (W,)
    inv_s2 = (compactness / s_avg) ** 2
    # _OFFSETS' (dy, dx), made on the device: no host copy.
    dys = torch.arange(9, device=dev) // 3 - 1
    dxs = torch.arange(9, device=dev) % 3 - 1

    def shifted_centers(c):
        """(B, gh, gw, 9, 5): candidate centre per cell and offset."""
        cp = F.pad(c.permute(0, 3, 1, 2), (1, 1, 1, 1), value=_BIG)
        return torch.stack([cp[:, :, 1 + dy:1 + dy + gh, 1 + dx:1 + dx + gw]
                            for dy, dx in _OFFSETS], dim=-1
                           ).permute(0, 2, 3, 4, 1)

    def assign(c):
        """Best of 9 candidates per pixel: (B, H, W) labels."""
        cand = shifted_centers(c)[:, base_cy[:, None], base_cx[None, :]]
        d_lab = ((lab[:, :, :, None, :] - cand[..., :3]) ** 2).sum(dim=-1)
        d_xy = ((yy[..., None] - cand[..., 3]) ** 2
                + (xx[..., None] - cand[..., 4]) ** 2)
        choice = torch.argmin(d_lab + d_xy * inv_s2, dim=-1)   # (B, H, W)
        return ((base_cy[:, None] + dys[choice]) * gw
                + base_cx[None, :] + dxs[choice])

    feats = torch.cat([lab, yy.expand(B, H, W)[..., None],
                       xx.expand(B, H, W)[..., None],
                       torch.ones((B, H, W, 1), device=dev)], dim=-1)
    flat_feats = feats.reshape(-1, 6)
    offset = torch.arange(B, device=dev).reshape(B, 1, 1) * K
    for _ in range(n_iter):
        lbl = assign(centers)
        total = segment_sum((lbl + offset).reshape(-1), flat_feats, B * K)
        total = total.reshape(B, gh, gw, 6)
        cnts = total[..., 5]
        means = total[..., :5] / cnts.clamp_min(1.0)[..., None]
        centers = torch.where((cnts > 0)[..., None], means, centers)
    return repair_connectivity(assign(centers), K)


def _edge_neighbours(lb: torch.Tensor):
    """(up, down, left, right) neighbours of (B, H, W) with edge
    replication."""
    up = torch.cat([lb[:, :1], lb[:, :-1]], dim=1)
    dn = torch.cat([lb[:, 1:], lb[:, -1:]], dim=1)
    lf = torch.cat([lb[:, :, :1], lb[:, :, :-1]], dim=2)
    rt = torch.cat([lb[:, :, 1:], lb[:, :, -1:]], dim=2)
    return up, dn, lf, rt


def _parity(H: int, W: int, device) -> torch.Tensor:
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy + xx) % 2


def absorb_orphans_plain(labels: torch.Tensor, n_sweeps: int = 2
                         ) -> torch.Tensor:
    """The plain version of `_absorb_orphans`: checkerboard half-sweeps of
    the (B, H, W) batch, eager."""
    parity = _parity(*labels.shape[1:], labels.device)

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
    """(up, down, left, right) neighbours of (B, H, W), out-of-image
    filled."""
    row = torch.full_like(a[:, :1], fill)
    col = torch.full_like(a[:, :, :1], fill)
    return (torch.cat([row, a[:, :-1]], dim=1),
            torch.cat([a[:, 1:], row], dim=1),
            torch.cat([col, a[:, :, :-1]], dim=2),
            torch.cat([a[:, :, 1:], col], dim=2))


def enforce_connectivity_plain(labels: torch.Tensor, k: int,
                               max_sweeps: int = 64) -> torch.Tensor:
    """The plain version of `enforce_connectivity` on (B, H, W): each loop
    runs until a block changes no image, or `max_sweeps` blocks.  An image
    whose block changed nothing is at its fixpoint, where further blocks
    change nothing: its labels are those of its own loops (JAX's vmapped
    while loops)."""
    B, H, W = labels.shape
    hw = H * W
    dev = labels.device
    idx = torch.arange(hw, device=dev).reshape(1, H, W).expand(B, H, W)
    nb_l = _fill_neighbours(labels, -1)
    same = [n == labels for n in nb_l]
    big = torch.full_like(idx, hw)

    comp = idx
    blocks = 0
    for blocks in range(1, max_sweeps + 1):
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

    # Component and label ids offset per image: b·hw + comp, b·k + label.
    comp_id = (comp + torch.arange(B, device=dev).reshape(B, 1, 1) * hw
               ).reshape(-1)
    sizes = torch.zeros(B * hw, dtype=torch.float32, device=dev).index_add_(
        0, comp_id, torch.ones(B * hw, dtype=torch.float32, device=dev))
    comp_size = sizes[comp_id].reshape(B, H, W)
    # (size, -comp) in float32, as the JAX package computes it: ties and
    # float32 rounding resolve identically.
    score = comp_size * hw - comp.float()
    label_id = (labels + torch.arange(B, device=dev).reshape(B, 1, 1) * k
                ).reshape(-1)
    label_best = torch.full((B * k,), float("-inf"), device=dev
                            ).scatter_reduce(0, label_id, score.reshape(-1),
                                             reduce="amax", include_self=True)
    minor = score < label_best[label_id].reshape(B, H, W)

    parity = _parity(H, W, dev)
    rounds = 0
    for rounds in range(1, max_sweeps + 1):
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


def repair_connectivity(labels: torch.Tensor, k: int, absorb_sweeps: int = 4,
                        max_sweeps: int = 64) -> torch.Tensor:
    """SLIC's connectivity repair of (B, H, W) labels in [0, k):
    `absorb_orphans_plain(labels, absorb_sweeps)`, then
    `enforce_connectivity_plain(..., k, max_sweeps)`."""
    return enforce_connectivity_plain(
        absorb_orphans_plain(labels, absorb_sweeps), k, max_sweeps)


