"""Segment / scatter primitives and masked per-graph reductions.

Counterpart of ``gcn_grabcut_tpu/core/scatter.py``: batches are dense
(G, N, ...) stacks, so a per-graph softmax is a masked reduction over an
axis.  This module is the copy's one home of `NEG_INF` and
`masked_softmax`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


# -- masked per-graph reductions on dense (G, N, ...) batches -------------


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


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    m = mask.to(like.dtype)
    while m.dim() < like.dim():
        m = m[..., None]
    return m
