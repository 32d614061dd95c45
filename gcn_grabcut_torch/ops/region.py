"""Per-region (superpixel) statistics and node-feature assembly.

Counterpart of ``gcn_grabcut_tpu/ops/region.py``.  Feature layout:
  [0:3] mean LAB  [3:6] std LAB  [6:9] mean HSV  [9:11] centroid (y, x)
  [11] area ratio  [12] isoperimetric ratio  [13] mean gradient / 255
  [14] boundary-pixel ratio  [15] centre distance / 0.707
Colour statistics are min-max normalised over valid (non-empty) regions.
"""

from __future__ import annotations

import math

import torch


def _segments(index: torch.Tensor, values: torch.Tensor, n: int,
              reduce: str, is_sorted: bool) -> torch.Tensor:
    if not is_sorted:
        values = values[torch.sort(index, stable=True).indices]
    lengths = torch.bincount(index, minlength=n)
    return torch.segment_reduce(values, reduce, lengths=lengths, axis=0)


def segment_sum(index: torch.Tensor, values: torch.Tensor, n: int,
                is_sorted: bool = False) -> torch.Tensor:
    """(n, ...) sums of the rows of `values` (P, ...) by `index` (P,) in
    [0, n), each in ascending row order: a stable sort by index, then one
    sequential sum per segment.  The same float32 adds on every device and
    in every run (a float ``index_add_`` adds in no fixed order on CUDA),
    and on the CPU bit for bit ``index_add_``'s sums, which are the JAX
    package's ``segment_sum``.  `is_sorted` asserts a non-decreasing
    `index` and skips the sort."""
    return _segments(index, values, n, "sum", is_sorted)


def segment_max(index: torch.Tensor, values: torch.Tensor, n: int,
                is_sorted: bool = False) -> torch.Tensor:
    """(n, ...) maxima of the rows of `values` by `index`, as
    `segment_sum`; an empty segment gives -inf (JAX ``segment_max``)."""
    return _segments(index, values, n, "max", is_sorted)


def region_reduce(segments: torch.Tensor, planes: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Sum each of C image planes over regions: (H, W, C) -> (K, C)."""
    return segment_sum(segments.reshape(-1),
                       planes.reshape(-1, planes.shape[-1]), k)


def region_boundaries(segments: torch.Tensor) -> torch.Tensor:
    """Inner region boundaries: pixels with a 4-neighbour of another
    label (edge-replicated borders)."""
    lb = segments
    up = torch.cat([lb[:1], lb[:-1]], dim=0)
    dn = torch.cat([lb[1:], lb[-1:]], dim=0)
    lf = torch.cat([lb[:, :1], lb[:, :-1]], dim=1)
    rt = torch.cat([lb[:, 1:], lb[:, -1:]], dim=1)
    return (up != lb) | (dn != lb) | (lf != lb) | (rt != lb)


def region_statistics(segments: torch.Tensor, lab: torch.Tensor,
                      hsv: torch.Tensor, grad: torch.Tensor, k: int) -> dict:
    """All per-region reductions in one segment pass."""
    H, W = segments.shape
    dev = segments.device
    yy = (torch.arange(H, dtype=torch.float32, device=dev) / H
          )[:, None].expand(H, W)
    xx = (torch.arange(W, dtype=torch.float32, device=dev) / W
          )[None, :].expand(H, W)
    boundaries = region_boundaries(segments).float()
    grad_scaled = grad / (grad.max() + 1e-6)

    planes = torch.cat([
        torch.ones((H, W, 1), device=dev),
        lab, lab ** 2, hsv,
        yy[..., None], xx[..., None],
        boundaries[..., None], grad[..., None], grad_scaled[..., None],
    ], dim=-1)
    sums = region_reduce(segments, planes, k)          # (K, 15)

    counts = sums[:, 0]
    safe = counts.clamp_min(1.0)
    mean_lab = sums[:, 1:4] / safe[:, None]
    sq_lab = sums[:, 4:7] / safe[:, None]
    return {
        "counts": counts,
        "safe": safe,
        "area_ratio": counts / float(H * W),
        "mean_lab": mean_lab,
        "std_lab": torch.sqrt((sq_lab - mean_lab ** 2).clamp_min(0.0)),
        "mean_hsv": sums[:, 7:10] / safe[:, None],
        "centroids": torch.stack([sums[:, 10] / safe, sums[:, 11] / safe],
                                 dim=1),
        "boundary_px": sums[:, 12],
        "mean_grad": sums[:, 13] / safe,
        "mean_grad_n": sums[:, 14] / safe,
        "valid": (counts > 0).float(),
    }


def assemble_node_features(st: dict) -> torch.Tensor:
    """(K, 16) node features, colour statistics min-max normalised over
    valid regions, padded / empty regions zeroed."""
    valid = st["valid"]
    perimeter = st["boundary_px"].clamp_min(1.0)
    iso = ((4 * math.pi * st["counts"]) / perimeter ** 2).clamp(0.0, 1.0)
    centre_dist = torch.linalg.vector_norm(st["centroids"] - 0.5,
                                           dim=1) / 0.707
    feats = torch.cat([
        st["mean_lab"], st["std_lab"], st["mean_hsv"], st["centroids"],
        st["area_ratio"][:, None], iso[:, None],
        (st["mean_grad"] / 255.0)[:, None],
        (st["boundary_px"] / st["safe"])[:, None],
        centre_dist[:, None],
    ], dim=1)

    def minmax_norm(cols):
        v = valid[:, None] > 0
        mn = torch.where(v, cols, torch.full_like(cols, 1e30)).amin(dim=0)
        mx = torch.where(v, cols, torch.full_like(cols, -1e30)).amax(dim=0)
        return (cols - mn) / (mx - mn + 1e-6)

    feats = torch.cat([minmax_norm(feats[:, 0:3]), minmax_norm(feats[:, 3:6]),
                       feats[:, 6:]], dim=1)
    feats = torch.nan_to_num(feats, nan=0.0, posinf=1.0, neginf=0.0)
    return feats * valid[:, None]
