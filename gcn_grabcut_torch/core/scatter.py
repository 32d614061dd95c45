"""Segment / scatter primitives and masked per-graph reductions.

Counterpart of ``gcn_grabcut_tpu/core/scatter.py``, with its names,
arguments and results.  Two families:

* **edge scatter** -- grouped reductions of the rows of `values` by an
  index vector into `num_segments` buckets.  Sums and maxima go through
  the fixed-order ``ops.region.segment_sum`` / ``segment_max`` (a stable
  sort by index, segment offsets by ``searchsorted``, then one sequential
  chain per segment and column; on the card the hand-written kernel, with
  no host sync): the same adds on every device and in every run, where a
  float ``index_add_`` on the card adds in no fixed order.
* **masked axis reductions** -- batches are dense (G, N, ...) stacks, so a
  per-graph mean, softmax or variance is a masked reduction over an axis.

This module is the port's one home of `NEG_INF` and `masked_softmax`.
"""

from __future__ import annotations

import torch

from ..ops.region import segment_max, segment_sum

NEG_INF = -1e30


def scatter_add(values: torch.Tensor, index: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    """Sum `values` (M, ...) into `num_segments` buckets by `index` (M,)."""
    return segment_sum(index, values, num_segments)


def scatter_mean(values: torch.Tensor, index: torch.Tensor, num_segments: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of `values` rows grouped by `index`; empty groups give zero.
    `weights` (M,) optionally masks or weights the rows; counts are
    clamped at 1."""
    if weights is not None:
        values = values * _expand(weights, values)
        counts = segment_sum(index, weights.to(values.dtype), num_segments)
    else:
        counts = segment_sum(index, torch.ones(index.shape, dtype=values.dtype,
                                               device=values.device),
                             num_segments)
    total = segment_sum(index, values, num_segments)
    return total / _expand(counts.clamp_min(1.0), total)


def scatter_max(values: torch.Tensor, index: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    """Per-segment maximum; an empty segment gives -inf, as JAX's
    ``segment_max`` does."""
    return segment_max(index, values, num_segments)


def scatter_softmax(scores: torch.Tensor, index: torch.Tensor,
                    num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically stable softmax of `scores` (M,) grouped by `index`, in
    float32 and cast back to the scores' dtype; masked entries get
    probability 0."""
    s = scores.float()
    if mask is not None:
        s = torch.where(mask > 0, s, NEG_INF)
    peak = segment_max(index, s, num_segments)
    peak = torch.where(torch.isfinite(peak), peak, 0.0)
    ex = torch.exp(s - peak[index])
    if mask is not None:
        ex = ex * mask
    tot = segment_sum(index, ex, num_segments)
    return (ex / (tot[index] + 1e-12)).to(scores.dtype)


# -- masked per-graph reductions on dense (G, N, ...) batches -------------

def masked_mean(h: torch.Tensor, mask: torch.Tensor, axis: int = 1,
                keepdims: bool = True) -> torch.Tensor:
    """Mean of `h` over `axis`, counting only entries where mask == 1;
    `mask` broadcasts against `h` ((G, N) against (G, N, D))."""
    m = _expand(mask, h)
    total = (h * m).sum(dim=axis, keepdim=keepdims)
    count = m.sum(dim=axis, keepdim=keepdims).clamp_min(1.0)
    return total / count


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, axis: int = 1
                   ) -> torch.Tensor:
    """Softmax over `axis` with masked entries forced to probability 0,
    computed in float32 and cast back (bfloat16 safety)."""
    dtype = scores.dtype
    s = scores.float()
    m = _expand(mask, s)
    s = torch.where(m > 0, s, NEG_INF)
    s = s - s.amax(dim=axis, keepdim=True).detach()
    ex = torch.exp(s) * m
    tot = ex.sum(dim=axis, keepdim=True)
    return (ex / (tot + 1e-12)).to(dtype)


def masked_var(h: torch.Tensor, mask: torch.Tensor, axis=None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked (mean, biased variance, count) over the given axes (all of
    them when None)."""
    def total(t):
        return t.sum() if axis is None else t.sum(dim=axis)
    m = _expand(mask, h)
    count = total(m).clamp_min(1.0)
    mean = total(h * m) / count
    var = total(((h - mean) ** 2) * m) / count
    return mean, var, count


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    m = mask.to(like.dtype)
    while m.dim() < like.dim():
        m = m[..., None]
    return m
