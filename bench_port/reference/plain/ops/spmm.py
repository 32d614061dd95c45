"""Banded-dense SpMM: the message-passing primitive of the large-graph path.

Counterpart of ``gcn_grabcut_tpu/ops/spmm.py``.  SLIC numbers superpixels
in grid scan order, so almost every edge (src -> dst) has |src - dst| inside
a fixed window.  The graph is compiled once into banded-dense block storage:
with row blocks of R rows and K source sub-blocks at offsets k - K//2,

    band[k, i, s] = sum of weights over edges (src = (i//R + k - K//2)·R + s
                                               -> dst = i)

and the product is, per destination block b,
``out_b = sum_k band[k, bR:(b+1)R, :] @ x[(b+k-K//2)R : (b+k-K//2+1)R]``
with rows of x outside [0, n) read as zero.  Out-of-window edges go through
a segment-sum fallback outside the band.  The device plan's band and the
fallback add in a fixed order (``ops.region.segment_sum``), so two runs
give the same bits.  `banded_spmm` runs the shifted-view contraction of
the JAX package's ``_banded_spmm_xla`` on any device.

The band is stored in its compute dtype, chosen once at plan build:
bfloat16 (the JAX default precision) or float32 (JAX ``precision=
"highest"``).  Products accumulate in float32 either way.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .region import Segments, segment_sum


@dataclasses.dataclass
class SpmmPlan:
    """Compiled banded-dense adjacency (static shapes)."""
    n_nodes: int              # padded to a multiple of block_rows
    block_rows: int           # R
    k_blocks: int             # K source sub-blocks (window = K·R)
    band: torch.Tensor        # (K, n_nodes, R), bfloat16 or float32
    fb_src: torch.Tensor      # (n_fallback,) int64 out-of-window edges
    fb_dst: torch.Tensor      # (n_fallback,) int64, sorted
    fb_weight: torch.Tensor   # (n_fallback,) float32
    _fb_segments: Segments | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def fallback_segments(self) -> Segments:
        """The fallback sum's index (each band row, then the fallback
        edges' destinations), sorted on first use and kept."""
        if self._fb_segments is None:
            rows = torch.arange(self.n_nodes, device=self.fb_dst.device)
            self._fb_segments = Segments(torch.cat([rows, self.fb_dst]),
                                         self.n_nodes)
        return self._fb_segments


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _layout(n_nodes: int, block_rows: int, window: int) -> tuple[int, int]:
    return (_round_up(max(n_nodes, block_rows), block_rows),
            max(1, -(-window // block_rows)))


def spmm_plan_device(src: torch.Tensor, dst: torch.Tensor,
                     weight: torch.Tensor, n_nodes: int,
                     block_rows: int = 128, window: int = 640,
                     dtype: torch.dtype = torch.float32) -> SpmmPlan:
    """`spmm_plan` built with tensor ops on the edges' own device.

    As in the JAX package, zero-weight (masked / padded) edges are kept but
    contribute nothing, and the fallback list is all E edges with in-window
    weights zeroed rather than a compacted list (static shapes, no host
    sync).  Duplicate slots of the band add in edge order through
    ``segment_sum`` (on the CPU bit for bit ``index_add_``'s sums)."""
    n_pad, k_blocks = _layout(n_nodes, block_rows, window)
    src = src.long().clamp(0, n_pad - 1)
    dst = dst.long().clamp(0, n_pad - 1)
    weight = weight.float()

    k = src // block_rows - dst // block_rows + k_blocks // 2
    in_w = (k >= 0) & (k < k_blocks)
    idx = torch.where(in_w, (k * n_pad + dst) * block_rows
                      + src % block_rows, torch.zeros_like(k))
    w_in = torch.where(in_w, weight, torch.zeros_like(weight))
    band = segment_sum(idx, w_in, k_blocks * n_pad * block_rows)

    w_fb = torch.where(in_w, torch.zeros_like(weight), weight)
    order = torch.argsort(dst, stable=True)
    return SpmmPlan(
        n_nodes=n_pad, block_rows=block_rows, k_blocks=k_blocks,
        band=band.reshape(k_blocks, n_pad, block_rows).to(dtype),
        fb_src=src[order], fb_dst=dst[order], fb_weight=w_fb[order])


def banded_spmm_plain(x: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """The shifted-view batched
    contraction.  x (n, D) with n <= n_pad; rows of x are first rounded to
    the band's dtype, products accumulate in float32.  Returns (n_pad, D)
    float32."""
    K, n_pad, R = band.shape
    n, d = x.shape
    off0 = K // 2
    xp = F.pad(x.to(band.dtype).float(),
               (0, 0, off0 * R, (K - 1 - off0) * R + n_pad - n))
    nb = n_pad // R
    xs = torch.stack([xp[k * R:k * R + n_pad].reshape(nb, R, d)
                      for k in range(K)])                      # (K,nb,R,D)
    a = band.float().reshape(K, nb, R, R)
    return torch.einsum("kbrs,kbsd->brd", a, xs).reshape(n_pad, d)


def banded_spmm(x: torch.Tensor, plan: SpmmPlan) -> torch.Tensor:
    """out[dst] += weight * x[src] over the plan's edges.  x: (N, D) with
    N <= plan.n_nodes; returns (N, D) float32.

    The band through `banded_spmm_plain`; the out-of-window fallback
    adds each row's fallback products to it in edge order, in float32
    (``segment_sum`` over the band's rows followed by the products: on
    the CPU bit for bit an ``index_add_`` into the band's output)."""
    n = x.shape[0]
    if n > plan.n_nodes:
        raise ValueError(f"x has {n} rows, the plan {plan.n_nodes}")
    out = banded_spmm_plain(x, plan.band)
    if plan.fb_src.numel():
        xf = F.pad(x.float(), (0, 0, 0, plan.n_nodes - n))
        out = plan.fallback_segments().sum(
            torch.cat([out, xf[plan.fb_src] * plan.fb_weight[:, None]]))
    return out[:n]
