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
a segment-sum fallback outside the kernel.  The device plan's band and the
fallback add in a fixed order (``ops.region.segment_sum``), so two runs
on the card give the same bits.

On a CUDA tensor `banded_spmm` always launches the hand-written kernel
(``csrc/banded_spmm.cu``); there is no fallback to the plain version, and a
kernel that fails to build or launch raises.  On a CPU tensor it runs the
plain PyTorch version, the shifted-view contraction of the JAX package's
``_banded_spmm_xla``.

The band is stored in its compute dtype, chosen once at plan build:
bfloat16 (the JAX default precision) or float32 (JAX ``precision=
"highest"``).  Products accumulate in float32 either way.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
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


def spmm_plan(src, dst, weight, n_nodes: int, block_rows: int = 128,
              window: int = 640, dtype: torch.dtype = torch.float32
              ) -> SpmmPlan:
    """Compile (src -> dst, weight) edges on the host with numpy (the
    oracle of `spmm_plan_device`).  Zero-weight edges are dropped, duplicate
    edges accumulate, out-of-window edges form a dst-sorted fallback list.
    Tensors land on the CPU."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    keep = weight != 0
    src, dst, weight = src[keep], dst[keep], weight[keep]

    n_pad, k_blocks = _layout(n_nodes, block_rows, window)
    k = src // block_rows - dst // block_rows + k_blocks // 2
    in_window = (k >= 0) & (k < k_blocks)
    banded = np.nonzero(in_window)[0]
    fallback = np.nonzero(~in_window)[0]
    fallback = fallback[np.argsort(dst[fallback], kind="stable")]

    band = np.zeros((k_blocks, n_pad, block_rows), np.float32)
    np.add.at(band, (k[banded], dst[banded], src[banded] % block_rows),
              weight[banded])
    return SpmmPlan(
        n_nodes=n_pad, block_rows=block_rows, k_blocks=k_blocks,
        band=torch.from_numpy(band).to(dtype),
        fb_src=torch.from_numpy(src[fallback]),
        fb_dst=torch.from_numpy(dst[fallback]),
        fb_weight=torch.from_numpy(weight[fallback]))


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
    """The plain PyTorch version of the kernel: shifted-view batched
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


def banded_spmm_cuda(x: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """Launch the hand-written kernel (csrc/banded_spmm.cu) on the current
    stream.  x (n, D) and band (K, n_pad, R) share a device and a dtype
    (bfloat16 or float32) and are contiguous; returns (n_pad, D) float32."""
    if x.device.type != "cuda" or band.device != x.device:
        raise ValueError(f"banded_spmm_cuda needs x and band on one CUDA "
                         f"device, got {x.device} and {band.device}")
    if band.dtype not in (torch.bfloat16, torch.float32) \
            or x.dtype != band.dtype:
        raise TypeError(f"banded_spmm_cuda takes bfloat16 or float32 x and "
                        f"band of one dtype, got {x.dtype} and {band.dtype}")
    if band.dim() != 3 or x.dim() != 2:
        raise ValueError(f"band must be (K, n_pad, R) and x (n, D), got "
                         f"{tuple(band.shape)} and {tuple(x.shape)}")
    K, n_pad, R = band.shape
    n, d = x.shape
    if R % 64 or n_pad % R or n > n_pad or d < 1 or n_pad * max(d, R) >= 2**31:
        raise ValueError(f"unsupported shapes: band {tuple(band.shape)}, "
                         f"x {tuple(x.shape)} (need R % 64 == 0, "
                         f"n_pad % R == 0, n <= n_pad)")
    if not (x.is_contiguous() and band.is_contiguous()):
        raise ValueError("banded_spmm_cuda needs contiguous x and band")

    from ..kernels import load
    lib = load("banded_spmm")
    fn = lib.banded_spmm_bf16 if band.dtype == torch.bfloat16 \
        else lib.banded_spmm_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n_pad, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(band.data_ptr(), x.data_ptr(), out.data_ptr(),
                 n_pad, n, R, K, d, stream)
    if err != 0:
        raise RuntimeError(f"banded_spmm kernel launch failed: CUDA error "
                           f"{err}")
    banded_spmm.kernel_launches += 1
    return out


def banded_spmm(x: torch.Tensor, plan: SpmmPlan) -> torch.Tensor:
    """out[dst] += weight * x[src] over the plan's edges.  x: (N, D) with
    N <= plan.n_nodes; returns (N, D) float32.

    CUDA tensors go through the kernel, CPU tensors through
    `banded_spmm_plain`; the out-of-window fallback adds each row's
    fallback products to it in edge order, in float32 on either device
    (``segment_sum`` over the band's rows followed by the products: on
    the CPU bit for bit an ``index_add_`` into the band's output)."""
    n = x.shape[0]
    if n > plan.n_nodes:
        raise ValueError(f"x has {n} rows, the plan {plan.n_nodes}")
    if x.device.type == "cuda":
        out = banded_spmm_cuda(x.to(plan.band.dtype).contiguous(), plan.band)
    else:
        out = banded_spmm_plain(x, plan.band)
    if plan.fb_src.numel():
        xf = F.pad(x.float(), (0, 0, 0, plan.n_nodes - n))
        out = plan.fallback_segments().sum(
            torch.cat([out, xf[plan.fb_src] * plan.fb_weight[:, None]]))
    return out[:n]


#: Launches of the CUDA kernel since the count was last set to 0.
banded_spmm.kernel_launches = 0


def spmm_reference(x: torch.Tensor, src, dst, weight, n: int
                   ) -> torch.Tensor:
    """The oracle: plain weighted scatter-add."""
    src = torch.as_tensor(src, device=x.device).long()
    dst = torch.as_tensor(dst, device=x.device).long()
    w = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device
                       ).index_add_(0, dst, x[src] * w[:, None])
