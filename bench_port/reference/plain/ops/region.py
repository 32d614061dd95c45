"""Per-region (superpixel) statistics and node-feature assembly.

Counterpart of ``gcn_grabcut_tpu/ops/region.py``.  Feature layout:
  [0:3] mean LAB  [3:6] std LAB  [6:9] mean HSV  [9:11] centroid (y, x)
  [11] area ratio  [12] isoperimetric ratio  [13] mean gradient / 255
  [14] boundary-pixel ratio  [15] centre distance / 0.707
Colour statistics are min-max normalised over valid (non-empty) regions.

Also the sums by index, `segment_sum` (on a `Segments`, an index sorted
once): a fixed-order chain of adds per segment and column, the same bits
on every run, the program's sums' plain version.
"""

from __future__ import annotations

import math

import torch

class Segments:
    """An index into `n` segments, sorted once for fixed-order reductions.

    `order` is the stable sort of `index` (None when `is_sorted` asserts a
    non-decreasing index), `ordered` the index in that order (the segment
    of each position), `offsets` the (n + 1) segment starts in that order,
    found by ``torch.searchsorted`` on the index's device: no host sync.
    `index` (P,) must lie in [0, n).  Keep one where the index is fixed
    over many sums (a plan's fallback list, a mesh's edge partition, a
    batch's destinations); `segment_sum` makes one per call."""

    def __init__(self, index: torch.Tensor, n: int, is_sorted: bool = False):
        index = index.reshape(-1).long().contiguous()
        if is_sorted:
            self.order, self.ordered = None, index
        else:
            self.ordered, self.order = torch.sort(index, stable=True)
        self.index, self.n = index, n
        self.offsets = torch.searchsorted(
            self.ordered, torch.arange(n + 1, device=index.device))

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """(n, ...) sums of the rows of `values` (P, ...) by the index."""
        return _reduce(self, values, "sum")


def _flat(values: torch.Tensor) -> torch.Tensor:
    return values.reshape(values.shape[0], math.prod(values.shape[1:]))


def segment_reduce_plain(values: torch.Tensor, segs: Segments,
                         op: str) -> torch.Tensor:
    """Rows in `segs`' order, then
    ``torch.segment_reduce`` with the offsets' lengths, one sequential
    reduction per segment and column in the values' dtype (a bfloat16 or
    float16 sum rounds after every add).  Values are flattened to (P, C):
    on CUDA a 1-D input would take a tree-ordered CUB reduction."""
    flat = _flat(values)
    if segs.order is not None:
        flat = flat[segs.order]
    out = torch.segment_reduce(flat, op, lengths=segs.offsets.diff(), axis=0)
    return out.reshape((segs.n,) + values.shape[1:])


def _reduce(segs: Segments, values: torch.Tensor, op: str) -> torch.Tensor:
    return segment_reduce_plain(values, segs, op)


def segment_sum(index: torch.Tensor, values: torch.Tensor, n: int,
                is_sorted: bool = False) -> torch.Tensor:
    """(n, ...) sums of the rows of `values` (P, ...) by `index` (P,) in
    [0, n), each a sequential chain of adds in ascending row order from 0:
    the same adds on every device and in every run (a float ``index_add_``
    adds in no fixed order on CUDA), and on the CPU bit for bit
    ``index_add_``'s sums, which are the JAX package's ``segment_sum``.
    No host sync.  `is_sorted`
    asserts a non-decreasing `index` and skips the stable sort."""
    return Segments(index, n, is_sorted).sum(values)


def ordered_sum(values: torch.Tensor) -> torch.Tensor:
    """(...) sums of `values` (..., n) over the last axis, each a chain of
    adds in index order (`segment_sum` on sorted ids): the same bits at
    every batch size and on every device, where a reduction kernel's order
    may change with the shape."""
    lead, n = values.shape[:-1], values.shape[-1]
    rows = math.prod(lead)
    idx = torch.arange(rows * n, device=values.device) // n
    return segment_sum(idx, values.reshape(-1, 1), rows,
                       is_sorted=True).reshape(lead)


def region_boundaries(segments: torch.Tensor) -> torch.Tensor:
    """Inner region boundaries of (B, H, W) label maps: pixels with a
    4-neighbour of another label (edge-replicated borders)."""
    lb = segments
    up = torch.cat([lb[:, :1], lb[:, :-1]], dim=1)
    dn = torch.cat([lb[:, 1:], lb[:, -1:]], dim=1)
    lf = torch.cat([lb[:, :, :1], lb[:, :, :-1]], dim=2)
    rt = torch.cat([lb[:, :, 1:], lb[:, :, -1:]], dim=2)
    return (up != lb) | (dn != lb) | (lf != lb) | (rt != lb)


def region_planes(segments: torch.Tensor, lab: torch.Tensor,
                  hsv: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The (B, H, W, 15) planes `region_statistics` sums over regions:
    ones, Lab, Lab², HSV, y / H, x / W, the boundary flag, the gradient and
    the gradient scaled to its image's maximum."""
    B, H, W = segments.shape
    dev = segments.device
    yy = (torch.arange(H, dtype=torch.float32, device=dev) / H
          )[:, None].expand(B, H, W)
    xx = (torch.arange(W, dtype=torch.float32, device=dev) / W
          )[None, :].expand(B, H, W)
    boundaries = region_boundaries(segments).float()
    grad_scaled = grad / (grad.amax(dim=(1, 2), keepdim=True) + 1e-6)

    return torch.cat([
        torch.ones((B, H, W, 1), device=dev),
        lab, lab ** 2, hsv,
        yy[..., None], xx[..., None],
        boundaries[..., None], grad[..., None], grad_scaled[..., None],
    ], dim=-1)


def region_statistics(segments: torch.Tensor, lab: torch.Tensor,
                      hsv: torch.Tensor, grad: torch.Tensor, k: int) -> dict:
    """All per-region reductions of (B, H, W) label maps in one segment
    pass over ids b·K + label: (B, K, ...) statistics.  A region's chain
    of adds is the same rows in the same order as its image's alone."""
    B, H, W = segments.shape
    ids = segments.long() + torch.arange(
        B, device=segments.device).reshape(B, 1, 1) * k
    planes = region_planes(segments, lab, hsv, grad)
    sums = segment_sum(ids.reshape(-1), planes.reshape(-1, planes.shape[-1]),
                       B * k).reshape(B, k, -1)                # (B, K, 15)

    counts = sums[..., 0]
    safe = counts.clamp_min(1.0)
    mean_lab = sums[..., 1:4] / safe[..., None]
    sq_lab = sums[..., 4:7] / safe[..., None]
    return {
        "counts": counts,
        "safe": safe,
        "area_ratio": counts / float(H * W),
        "mean_lab": mean_lab,
        "std_lab": torch.sqrt((sq_lab - mean_lab ** 2).clamp_min(0.0)),
        "mean_hsv": sums[..., 7:10] / safe[..., None],
        "centroids": torch.stack([sums[..., 10] / safe, sums[..., 11] / safe],
                                 dim=-1),
        "boundary_px": sums[..., 12],
        "mean_grad": sums[..., 13] / safe,
        "mean_grad_n": sums[..., 14] / safe,
        "valid": (counts > 0).float(),
    }


def assemble_node_features(st: dict) -> torch.Tensor:
    """(B, K, 16) node features, colour statistics min-max normalised over
    each image's valid regions, padded / empty regions zeroed."""
    valid = st["valid"]
    perimeter = st["boundary_px"].clamp_min(1.0)
    iso = ((4 * math.pi * st["counts"]) / perimeter ** 2).clamp(0.0, 1.0)
    centre_dist = torch.linalg.vector_norm(st["centroids"] - 0.5,
                                           dim=-1) / 0.707
    feats = torch.cat([
        st["mean_lab"], st["std_lab"], st["mean_hsv"], st["centroids"],
        st["area_ratio"][..., None], iso[..., None],
        (st["mean_grad"] / 255.0)[..., None],
        (st["boundary_px"] / st["safe"])[..., None],
        centre_dist[..., None],
    ], dim=-1)

    def minmax_norm(cols):
        v = valid[..., None] > 0
        mn = torch.where(v, cols, torch.full_like(cols, 1e30)).amin(
            dim=1, keepdim=True)
        mx = torch.where(v, cols, torch.full_like(cols, -1e30)).amax(
            dim=1, keepdim=True)
        return (cols - mn) / (mx - mn + 1e-6)

    feats = torch.cat([minmax_norm(feats[..., 0:3]),
                       minmax_norm(feats[..., 3:6]), feats[..., 6:]], dim=-1)
    feats = torch.nan_to_num(feats, nan=0.0, posinf=1.0, neginf=0.0)
    return feats * valid[..., None]
