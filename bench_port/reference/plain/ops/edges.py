"""Region-adjacency and non-local edge extraction at static shapes, over a
batch.

Counterpart of ``gcn_grabcut_tpu/ops/edges.py`` (which the JAX package
vmaps over a batch): adjacency pairs from shifted label-map comparisons
deduplicated at a static budget, dense k-NN colour edges (blocked for the
large-graph configuration), 5-d pair features and symmetric directed edge
lists.  Every function works per image along a leading B axis: sorts run
along the last axis, searches per row, maxima per image.  Sorts that feed
a dedup are stable, as ``jnp.sort``/``jnp.argsort`` are.
"""

from __future__ import annotations

import torch


def unique_counts_static(codes: torch.Tensor, size: int, sentinel: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(codes, size=size, fill_value=sentinel,
    return_counts=True)`` of each row of (B, N) `codes`: ascending uniques
    truncated at `size`, empty slots carry `sentinel` with count 0; (B,
    size) each."""
    s = torch.sort(codes, dim=-1, stable=True).values
    B, n = s.shape
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = torch.cumsum(is_new.long(), dim=-1) - 1
    starts = torch.searchsorted(
        rank, torch.arange(size + 1, device=s.device, dtype=rank.dtype
                           ).expand(B, size + 1).contiguous())
    counts = torch.diff(starts, dim=-1)
    uniq = s.gather(-1, starts[:, :size].clamp_max(n - 1))
    uniq = torch.where(counts > 0, uniq, torch.full_like(uniq, sentinel))
    return uniq, counts


def adjacency_budget(k: int, connectivity: int = 4) -> int:
    return 4 * k if connectivity == 4 else 6 * k


def nonlocal_budget(k: int, n_nonlocal: int) -> int:
    return k * n_nonlocal


def _decode(uniq: torch.Tensor, sent: int, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    mask = (uniq != sent).float()
    uniq = torch.where(uniq == sent, torch.zeros_like(uniq), uniq)
    return torch.stack([uniq // k, uniq % k], dim=-1), mask


def _empty_pairs(B: int, budget: int, dev) -> tuple:
    return (torch.zeros((B, budget, 2), dtype=torch.long, device=dev),
            torch.zeros((B, budget), device=dev))


def adjacency_pairs(segments: torch.Tensor, k: int, connectivity: int = 4):
    """Unique undirected adjacent-region pairs (B, P, 2) of (B, H, W)
    label maps, shared boundary lengths (B, P) normalised to [0, 1] per
    image, and a (B, P) mask, at the static budget P =
    adjacency_budget(k)."""
    sent = k * k
    seg = segments.long()
    B = seg.shape[0]
    shifts = [(seg[:, :, :-1], seg[:, :, 1:]), (seg[:, :-1, :], seg[:, 1:, :])]
    if connectivity == 8:
        shifts += [(seg[:, :-1, :-1], seg[:, 1:, 1:]),
                   (seg[:, :-1, 1:], seg[:, 1:, :-1])]
    codes = []
    for a, b in shifts:
        a, b = a.reshape(B, -1), b.reshape(B, -1)
        code = torch.minimum(a, b) * k + torch.maximum(a, b)
        codes.append(torch.where(a == b, torch.full_like(code, sent), code))
    uniq, counts = unique_counts_static(torch.cat(codes, dim=-1),
                                        adjacency_budget(k, connectivity),
                                        sent)
    pairs, mask = _decode(uniq, sent, k)
    counts = counts.float() * mask
    shared = counts / (counts.amax(dim=-1, keepdim=True) + 1e-6)
    return pairs, shared, mask


def nonlocal_pairs(adj_pairs: torch.Tensor, adj_mask: torch.Tensor,
                   mean_lab: torch.Tensor, valid: torch.Tensor, k: int,
                   n_nonlocal: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN colour edges in mean-Lab space, spatial neighbours excluded,
    per image of (B, K, 3) `mean_lab`: dense K x K distances with the
    adjacency, the diagonal and empty clusters masked to +inf, each node's
    n_nonlocal nearest, deduplicated.  (B, K·n_nonlocal, 2) pairs and
    mask.  Neighbours come from a stable sort, so equal distances pick the
    lower index as ``jax.lax.top_k`` does."""
    dev = mean_lab.device
    B = mean_lab.shape[0]
    budget = nonlocal_budget(k, max(n_nonlocal, 1))
    if n_nonlocal <= 0 or k <= 1:
        return _empty_pairs(B, budget, dev)
    n_nonlocal = min(n_nonlocal, k - 1)
    d = torch.linalg.vector_norm(mean_lab[:, :, None, :]
                                 - mean_lab[:, None, :, :], dim=-1)
    # The adjacency's pairs both ways; padded pairs land in a spare slot.
    spare = k * k
    p0, p1 = adj_pairs[..., 0].long(), adj_pairs[..., 1].long()
    m = adj_mask > 0
    excl = torch.zeros((B, spare + 1), dtype=torch.bool, device=dev)
    for a, b in ((p0, p1), (p1, p0)):
        excl.scatter_(1, torch.where(m, a * k + b, spare), True)
    excl = excl[:, :spare].reshape(B, k, k)
    excl |= torch.eye(k, dtype=torch.bool, device=dev)
    excl |= (valid[:, :, None] <= 0) | (valid[:, None, :] <= 0)
    d = torch.where(excl, torch.full_like(d, float("inf")), d)
    dist, nbrs = torch.sort(d, dim=-1, stable=True)
    dist, nbrs = dist[..., :n_nonlocal], nbrs[..., :n_nonlocal]
    rows = torch.arange(k, device=dev)[:, None]
    lo = torch.minimum(rows, nbrs)
    hi = torch.maximum(rows, nbrs)
    sent = k * k
    codes = torch.where(torch.isfinite(dist), lo * k + hi,
                        torch.full_like(lo, sent)).reshape(B, -1)
    uniq, _ = unique_counts_static(codes, budget, sent)
    return _decode(uniq, sent, k)


def nonlocal_pairs_banded(mean_lab: torch.Tensor, valid: torch.Tensor,
                          k: int, n_nonlocal: int, exclude_window: int,
                          block: int = 1024
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked k-NN colour edges for the large-graph configuration, per
    image of (B, K, 3) `mean_lab`: row blocks of distances, spatial
    neighbours excluded by SLIC-grid index window, (B, K·n_nonlocal, 2)
    pairs and mask."""
    dev = mean_lab.device
    B = mean_lab.shape[0]
    budget = nonlocal_budget(k, max(n_nonlocal, 1))
    if n_nonlocal <= 0 or k <= 1:
        return _empty_pairs(B, budget, dev)
    n_nonlocal = min(n_nonlocal, k - 1)
    kp = ((k + block - 1) // block) * block
    ml = torch.zeros((B, kp, 3), device=dev)
    ml[:, :k] = mean_lab
    vl = torch.zeros((B, kp), device=dev)
    vl[:, :k] = valid
    cols = torch.arange(kp, device=dev)
    sent = k * k

    codes = []
    for i0 in range(0, kp, block):
        rows = cols[i0:i0 + block]
        d = torch.linalg.vector_norm(ml[:, i0:i0 + block, None, :]
                                     - ml[:, None, :, :], dim=-1)
        excl = (rows[:, None] - cols[None, :]).abs() <= exclude_window
        excl = excl | (vl[:, i0:i0 + block, None] <= 0) | (vl[:, None, :] <= 0)
        excl |= (rows[:, None] >= k) | (cols[None, :] >= k)
        d = torch.where(excl, torch.full_like(d, float("inf")), d)
        neg_d, nbrs = torch.topk(-d, n_nonlocal, dim=-1)
        finite = torch.isfinite(neg_d)
        lo = torch.minimum(rows[:, None], nbrs)
        hi = torch.maximum(rows[:, None], nbrs)
        codes.append(torch.where(finite, lo * k + hi,
                                 torch.full_like(lo, sent)).reshape(B, -1))
    uniq, _ = unique_counts_static(torch.cat(codes, dim=-1), budget, sent)
    return _decode(uniq, sent, k)


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, K, ...) at per-image indices idx (B, P): (B, P, ...)."""
    b = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[b, idx]


def pair_features(pairs: torch.Tensor, mask: torch.Tensor, st: dict,
                  shared: torch.Tensor, nonlocal_flag: torch.Tensor
                  ) -> torch.Tensor:
    """5-d edge features per undirected pair, (B, P, 5): [ΔE LAB
    (max-normalised per image), centroid distance (max-normalised per
    image), shared boundary, gradient contrast, non-local flag]."""
    i, j = pairs[..., 0], pairs[..., 1]
    delta_e = torch.linalg.vector_norm(
        _take(st["mean_lab"], i) - _take(st["mean_lab"], j), dim=-1) * mask
    delta_e = delta_e / (delta_e.amax(dim=-1, keepdim=True) + 1e-6)
    dxy = torch.linalg.vector_norm(
        _take(st["centroids"], i) - _take(st["centroids"], j), dim=-1) * mask
    dxy = dxy / (dxy.amax(dim=-1, keepdim=True) + 1e-6)
    grad_contrast = (_take(st["mean_grad_n"], i)
                     - _take(st["mean_grad_n"], j)).abs()
    attr = torch.stack([delta_e, dxy, shared, grad_contrast, nonlocal_flag],
                       dim=-1)
    return attr * mask[..., None]


def symmetrise(pairs: torch.Tensor, attr: torch.Tensor, mask: torch.Tensor):
    """Undirected (B, P, 2) pairs -> symmetric directed (src, dst, attr,
    mask), (B, 2P, ...); padded slots keep src = dst = 0 and mask 0."""
    mask2 = torch.cat([mask, mask], dim=-1)
    keep = mask2 > 0
    zero = torch.zeros_like(pairs[..., 0])
    src = torch.where(keep, torch.cat([pairs[..., 0], pairs[..., 1]], dim=-1),
                      torch.cat([zero, zero], dim=-1))
    dst = torch.where(keep, torch.cat([pairs[..., 1], pairs[..., 0]], dim=-1),
                      torch.cat([zero, zero], dim=-1))
    return src, dst, torch.cat([attr, attr], dim=1), mask2
