"""Per-region (superpixel) statistics and node-feature assembly.

Counterpart of ``gcn_grabcut_tpu/ops/region.py``.  Feature layout:
  [0:3] mean LAB  [3:6] std LAB  [6:9] mean HSV  [9:11] centroid (y, x)
  [11] area ratio  [12] isoperimetric ratio  [13] mean gradient / 255
  [14] boundary-pixel ratio  [15] centre distance / 0.707
Colour statistics are min-max normalised over valid (non-empty) regions.

Also the port's sums by index, `segment_sum` and `segment_max` (on a
`Segments`, an index sorted once): a fixed-order chain of adds per segment
and column, the same bits on every run.  CUDA tensors go through the
hand-written kernel ``csrc/segment_sum.cu``, CPU tensors through its plain
version; neither syncs the host.  The JAX package leaves these sums to
XLA (``jax.ops.segment_sum``); it has no Pallas kernel for them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

#: The element types the kernel takes, by its dtype code.
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                torch.float16: 3}
_OPS = {"sum": 0, "max": 1}

#: Rows of a tile of the kernel's long blocks (csrc/segment_sum.cu); a
#: segment of at least this many rows is long.  A multiple of 256, <= 1024:
#: TILE_WIDE for rows of WIDE_ROW_BYTES or more (one warp walks a short
#: segment's row, and a chain of a few hundred rows already holds it back),
#: TILE_NARROW below (many short segments share a warp).
TILE_WIDE, TILE_NARROW, WIDE_ROW_BYTES = 256, 1024, 256
#: Bytes of a row's columns that one long unit (tile, group) takes.
GROUP_BYTES = 32
#: Threads of a kernel block, and the long units one long block takes.
THREADS, UNITS = 256, 8


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """The kernel's launch of one call, from host-known sizes alone: `vec`
    elements per column vector, `cv` vectors per row, `gv` vectors per
    column group, `groups` groups, `tiles` tiles of `tile` rows,
    `long_blocks` blocks for the long segments (UNITS of the tiles x
    groups units each, or none when no segment can be long) and
    `short_blocks` for the per-thread path.  `keep`, `count` and `done`
    are the int32 scratch sizes: a kept row number per row and group (a
    maximum keeps its tiles' maxima there instead), a count and a
    counter per tile and group."""
    rows: int
    vec: int
    cv: int
    gv: int
    groups: int
    tile: int
    tiles: int
    long_blocks: int
    short_blocks: int

    @property
    def keep(self) -> int:
        return self.groups * self.rows if self.long_blocks else 0

    @property
    def count(self) -> int:
        return self.groups * self.tiles if self.long_blocks else 0

    done = count


def kernel_plan(rows: int, cols: int, n: int, elt: int, aligned: bool
                ) -> KernelPlan:
    """The launch of the kernel on (rows, cols) values of `elt`-byte
    elements into `n` segments; `aligned`: the values' and the output's
    data are 16-byte aligned.  A segment is long when it has at least
    `tile` rows (by the row's bytes: TILE_WIDE or TILE_NARROW), so none is
    when rows < tile."""
    tile = TILE_WIDE if cols * elt >= WIDE_ROW_BYTES else TILE_NARROW
    wide = 16 // elt
    vec = wide if cols % wide == 0 and aligned else 1
    cv = cols // vec
    gv = GROUP_BYTES // (vec * elt)
    groups = -(-cv // gv)
    tiles = -(-rows // tile)
    long_blocks = -(-tiles * groups // UNITS) if rows >= tile else 0
    return KernelPlan(rows, vec, cv, gv, groups, tile, tiles, long_blocks,
                      -(-n * cv // THREADS))


def long_segments(offsets: torch.Tensor, tile: int) -> torch.Tensor:
    """Which of the segments with these (n + 1) offsets the kernel's long
    blocks sum (at least `tile` rows, `kernel_plan(...).tile`); the
    per-thread path sums the rest."""
    return offsets.diff() >= tile


#: The long blocks' int32 buffers per (device, stream), grown as needed:
#: the hand-off counters (_DONE), zero between calls (the block that uses
#: one last sets it back), and the keep lists and counts (_WORK), which a
#: call writes before it reads them.  Calls on one stream run in order and
#: share them; calls on two streams never do.
_DONE: dict = {}
_WORK: dict = {}


def _stream_buffer(store: dict, device: torch.device, stream: int, n: int
                   ) -> torch.Tensor:
    key = (device, stream)
    buf = store.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 0)
        buf = store[key] = torch.zeros(size, dtype=torch.int32,
                                       device=device)
    return buf


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
        # Contiguous: the kernel reads `ordered` as a dense int64 array.
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

    def max(self, values: torch.Tensor) -> torch.Tensor:
        """(n, ...) maxima of the rows of `values`; -inf where empty."""
        return _reduce(self, values, "max")


def _flat(values: torch.Tensor) -> torch.Tensor:
    return values.reshape(values.shape[0], math.prod(values.shape[1:]))


def segment_reduce_plain(values: torch.Tensor, segs: Segments,
                         op: str) -> torch.Tensor:
    """The plain version of the kernel: rows in `segs`' order, then
    ``torch.segment_reduce`` with the offsets' lengths, one sequential
    reduction per segment and column in the values' dtype (a bfloat16 or
    float16 sum rounds after every add).  Values are flattened to (P, C):
    on CUDA a 1-D input would take a tree-ordered CUB reduction."""
    flat = _flat(values)
    if segs.order is not None:
        flat = flat[segs.order]
    out = torch.segment_reduce(flat, op, lengths=segs.offsets.diff(), axis=0)
    return out.reshape((segs.n,) + values.shape[1:])


@functools.cache
def _kernel():
    """The kernel's C entry point, its argument types set once."""
    from ..kernels import load
    fn = load("segment_sum").segment_reduce
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def segment_reduce_cuda(values: torch.Tensor, segs: Segments,
                        op: str) -> torch.Tensor:
    """Launch the fixed-order kernel (csrc/segment_sum.cu) on the current
    stream: the plain version's reduction, bit for bit.  `values` (P, ...)
    is a contiguous float32, float64, bfloat16 or float16 CUDA tensor on
    `segs`' device, P < 2^31; the wrapper allocates the (n, ...) output and,
    when a segment can be long (P at least the plan's tile), hands the long
    blocks the stream's scratch (`kernel_plan`, `_stream_buffer`)."""
    if values.device.type != "cuda" or segs.offsets.device != values.device:
        raise ValueError(f"segment_reduce_cuda needs the values and the "
                         f"segments on one CUDA device, got {values.device} "
                         f"and {segs.offsets.device}")
    if values.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_reduce_cuda takes "
                        f"{', '.join(map(str, _DTYPE_CODES))}, got "
                        f"{values.dtype}")
    if op not in _OPS:
        raise ValueError(f"unknown reduction {op!r}")
    if values.dim() < 1 or values.shape[0] != segs.index.shape[0]:
        raise ValueError(f"values {tuple(values.shape)} do not match an "
                         f"index of {segs.index.shape[0]} rows")
    if not values.is_contiguous():
        raise ValueError("segment_reduce_cuda needs contiguous values")
    if segs.ordered.dtype != torch.int64 or not segs.ordered.is_contiguous():
        raise ValueError("segment_reduce_cuda needs the segments' ordered "
                         "index as contiguous int64")
    rows = values.shape[0]
    if rows >= 2 ** 31:
        raise ValueError(f"segment_reduce_cuda takes fewer than 2^31 rows, "
                         f"got {rows}")
    out = torch.empty((segs.n,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out

    fn = _kernel()
    cols = _flat(values).shape[1]
    plan = kernel_plan(rows, cols, segs.n, values.element_size(),
                       values.data_ptr() % 16 == 0
                       and out.data_ptr() % 16 == 0)
    perm = None if segs.order is None else segs.order.data_ptr()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        keep = count = done = None       # no segment can be long: none
        if plan.long_blocks:
            keep = _stream_buffer(_WORK, values.device, stream,
                                  plan.keep + plan.count).data_ptr()
            count = keep + 4 * plan.keep
            done = _stream_buffer(_DONE, values.device, stream,
                                  plan.done).data_ptr()
        err = fn(_DTYPE_CODES[values.dtype], _OPS[op], plan.vec, plan.tile,
                 values.data_ptr(), perm, segs.ordered.data_ptr(),
                 segs.offsets.data_ptr(), out.data_ptr(), rows, segs.n, cols,
                 keep, count, done, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    segment_sum.kernel_launches += 1
    return out


class _SegmentReduce(torch.autograd.Function):
    """The kernel, differentiable as ``torch.segment_reduce`` is: a sum's
    gradient is each row's segment's gradient; a max's goes to the rows
    equal to the maximum (or NaN), a positive one split evenly among ties
    (segment_reduce divides only those)."""

    @staticmethod
    def forward(ctx, values, segs, op):
        out = segment_reduce_cuda(values, segs, op)
        ctx.segs, ctx.op = segs, op
        if op == "max":
            ctx.save_for_backward(values, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        idx = ctx.segs.index
        g = grad.index_select(0, idx)
        if ctx.op == "max":
            values, out = ctx.saved_tensors
            hit = (values == out.index_select(0, idx)) | values.isnan()
            ties = segment_reduce_cuda(hit.float().contiguous(), ctx.segs,
                                       "sum").to(g.dtype)
            g = torch.where(g > 0, g / ties.index_select(0, idx), g)
            g = torch.where(hit, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device))
        return g, None, None


def _reduce(segs: Segments, values: torch.Tensor, op: str) -> torch.Tensor:
    if values.device.type == "cpu":
        return segment_reduce_plain(values, segs, op)
    return _SegmentReduce.apply(values.contiguous(), segs, op)


def segment_sum(index: torch.Tensor, values: torch.Tensor, n: int,
                is_sorted: bool = False) -> torch.Tensor:
    """(n, ...) sums of the rows of `values` (P, ...) by `index` (P,) in
    [0, n), each a sequential chain of adds in ascending row order from 0:
    the same adds on every device and in every run (a float ``index_add_``
    adds in no fixed order on CUDA), and on the CPU bit for bit
    ``index_add_``'s sums, which are the JAX package's ``segment_sum``.
    CUDA tensors go through the kernel (csrc/segment_sum.cu), CPU tensors
    through `segment_reduce_plain`; neither syncs the host.  `is_sorted`
    asserts a non-decreasing `index` and skips the stable sort."""
    return Segments(index, n, is_sorted).sum(values)


def segment_max(index: torch.Tensor, values: torch.Tensor, n: int,
                is_sorted: bool = False) -> torch.Tensor:
    """(n, ...) maxima of the rows of `values` by `index`, as
    `segment_sum` (the same kernel); an empty segment gives -inf (JAX
    ``segment_max``)."""
    return Segments(index, n, is_sorted).max(values)


#: Launches of the CUDA kernel (sums and maxima) since the count was last
#: set to 0.
segment_sum.kernel_launches = 0



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
