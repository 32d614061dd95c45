"""Connected-component labelling and small-component mask clean-up.

Counterpart of ``gcn_grabcut_tpu/ops/connected.py``, over a batch: masks
are (B, H, W).  Each sweep is one 8-neighbour min stencil followed by a
run-min along rows and along columns, repeated to the fixpoint; a
component is labelled by the minimum linear index it contains within its
image (background: H*W).

The JAX package propagates along runs with a segmented min-scan
(``lax.associative_scan``) forward and backward; together the two scans
give every foreground pixel the minimum over its maximal run, which here is
a ``scatter_reduce("amin")`` over run ids from ``cumsum(is_bg)`` and a
gather back.  Integer arithmetic: the labels equal the JAX package's
exactly.

On the card `connected_components` is one launch of the hand-written
kernel ``csrc/mask_components.cu``, which decides each image's loop there
(the JAX package's ``lax.while_loop``); on the CPU it runs
`connected_components_plain`, the eager sweeps, which test the batch's
convergence on the host once a sweep.  The two give the same labels.

The clean-up's per-component sums (sizes, border counts, posterior mass)
run in a fixed order on every device (`ops.region.segment_sum`, segment
b·H·W + label): a float ``index_add_`` adds in no fixed order on CUDA,
which could flip a runner-up sitting at the keep-largest gate from one run
to the next.  Every maximum and test of the clean-up is per image, so an
image's mask in a batch is its mask alone.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .region import segment_sum

_NEIGHBOURS_8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                 (0, 1), (1, -1), (1, 0), (1, 1))
_NEIGHBOURS_4 = ((-1, 0), (0, -1), (0, 1), (1, 0))

#: keep-largest coherence gate: a runner-up component survives when its
#: mean posterior is at least this fraction of the winner's.
KEEP_LARGEST_CONF_GATE = 0.75


def _run_min(lab: torch.Tensor, mask: torch.Tensor, bg: int, dim: int
             ) -> torch.Tensor:
    """Each foreground pixel of (B, H, W) `lab` takes the min of `lab` over
    its maximal foreground run along `dim` (2: rows, 1: columns);
    background pixels get `bg`."""
    if dim == 1:
        return _run_min(lab.transpose(1, 2), mask.transpose(1, 2), bg,
                        2).transpose(1, 2)
    B, H, W = lab.shape
    run = torch.cumsum((~mask).long(), dim=2)            # run id per row
    rows = torch.arange(B * H, device=lab.device).reshape(B, H, 1)
    key = (rows * (W + 1) + run).reshape(-1)
    mins = torch.full((B * H * (W + 1),), bg, dtype=lab.dtype,
                      device=lab.device).scatter_reduce(
        0, key, lab.reshape(-1), reduce="amin", include_self=True)
    return torch.where(mask, mins[key].reshape(B, H, W), bg)


def connected_components_plain(mask: torch.Tensor, connectivity: int = 8,
                               max_iters: int = 512) -> torch.Tensor:
    """The kernel's plain version: eager sweeps of the (B, H, W) batch
    until a sweep changes no image or `max_iters` sweeps are done.  An
    image whose sweep changed nothing is at its fixpoint, where further
    sweeps change nothing: its labels are those of its own loop."""
    B, H, W = mask.shape
    bg = H * W
    nbrs = _NEIGHBOURS_8 if connectivity == 8 else _NEIGHBOURS_4
    idx = torch.arange(H * W, device=mask.device).reshape(1, H, W)
    lab = torch.where(mask, idx, bg)
    sweeps = 0
    for sweeps in range(1, max_iters + 1):
        lp = F.pad(lab, (1, 1, 1, 1), value=bg)
        new = lab
        for dy, dx in nbrs:
            new = torch.minimum(new, lp[:, 1 - dy:1 - dy + H,
                                        1 - dx:1 - dx + W])
        new = torch.where(mask, new, bg)
        new = _run_min(new, mask, bg, 2)
        new = _run_min(new, mask, bg, 1)
        changed = bool((new < lab).any())
        lab = new
        if not changed:
            break
    connected_components_plain.last_sweeps = sweeps
    return lab.to(torch.int32)


#: The sweeps the last call ran (the kernel's are its ctrl's last word).
connected_components_plain.last_sweeps = None


# The kernel's decomposition (csrc/mask_components.cu), modelled on the CPU
# for the tests: the kernel cannot run here.  In the kernel's planes a
# background pixel holds bg = H W, above every foreground label, so the
# planes carry the mask.  BAND is the column pass's rows a segment.

BAND = 8


def stencil_separable(lab: torch.Tensor, connectivity: int, bg: int
                      ) -> torch.Tensor:
    """The sweep's min stencil as the kernel's row pass computes it, from
    the band's labels in shared memory: the minimum over three rows first,
    then over three columns of that (8-connected), or beside the pixel's
    left and right labels (4-connected); background stays bg."""
    B, H, W = lab.shape
    lp = F.pad(lab, (1, 1, 1, 1), value=bg)
    vert = torch.minimum(torch.minimum(lp[:, :-2], lp[:, 1:-1]), lp[:, 2:])
    if connectivity == 8:
        new = torch.minimum(torch.minimum(vert[:, :, :-2], vert[:, :, 1:-1]),
                            vert[:, :, 2:])
    else:
        new = torch.minimum(torch.minimum(vert[:, :, 1:-1], lp[:, 1:-1, :-2]),
                            lp[:, 1:-1, 2:])
    return torch.where(lab < bg, new, bg)


def row_run_min_in_place(v: torch.Tensor, bg: int) -> torch.Tensor:
    """The row pass's run-min in one buffer: a backward walk leaves each
    pixel the minimum from it to its run's end, and a forward walk's
    minimum of those from the run's start is the run's minimum.
    Background (bg) ends a run and stays bg."""
    v = v.clone()
    W = v.shape[-1]
    for x in range(W - 2, -1, -1):
        fg = (v[..., x] < bg) & (v[..., x + 1] < bg)
        v[..., x] = torch.where(fg, torch.minimum(v[..., x], v[..., x + 1]),
                                v[..., x])
    for x in range(1, W):
        fg = (v[..., x] < bg) & (v[..., x - 1] < bg)
        v[..., x] = torch.where(fg, torch.minimum(v[..., x], v[..., x - 1]),
                                v[..., x])
    return v


def column_run_min_bands(v: torch.Tensor, bg: int, band: int = BAND
                         ) -> torch.Tensor:
    """The column pass's run-min over segments of `band` rows.  Each
    segment's summary per column: the minimum of its top run (down to its
    first background pixel), of its bottom run, and whether it holds
    background.  Segmented minimum scans over the summaries give each
    segment the minimum entering it from above and from below; each pixel
    then takes its run's minimum within the segment, and the carries for a
    run that reaches the segment's top or bottom."""
    B, H, W = v.shape
    n = -(-H // band)
    vp = F.pad(v, (0, 0, 0, n * band - H), value=bg).reshape(B, n, band, W)
    fg = vp < bg
    top = torch.full((B, n, W), bg, dtype=v.dtype)
    bot = torch.full((B, n, W), bg, dtype=v.dtype)
    open_top = torch.ones((B, n, W), dtype=torch.bool)
    for r in range(band):
        open_top &= fg[:, :, r]
        top = torch.where(open_top, torch.minimum(top, vp[:, :, r]), top)
        bot = torch.where(fg[:, :, r], torch.minimum(bot, vp[:, :, r]), bg)
    has_bg = ~fg.all(dim=2)
    down = torch.full((B, n, W), bg, dtype=v.dtype)
    up = torch.full((B, n, W), bg, dtype=v.dtype)
    for i in range(1, n):
        down[:, i] = torch.where(has_bg[:, i - 1], bot[:, i - 1],
                                 torch.minimum(bot[:, i - 1], down[:, i - 1]))
    for i in range(n - 2, -1, -1):
        up[:, i] = torch.where(has_bg[:, i + 1], top[:, i + 1],
                               torch.minimum(top[:, i + 1], up[:, i + 1]))
    out = torch.empty_like(vp)
    pre = down.clone()
    for r in range(band):
        pre = torch.where(fg[:, :, r], torch.minimum(pre, vp[:, :, r]), bg)
        out[:, :, r] = pre
    suf = up.clone()
    for r in range(band - 1, -1, -1):
        suf = torch.where(fg[:, :, r], torch.minimum(suf, vp[:, :, r]), bg)
        out[:, :, r] = torch.minimum(out[:, :, r], suf)
    return out.reshape(B, n * band, W)[:, :H]


def components_banded(mask: torch.Tensor, connectivity: int = 8,
                      max_iters: int = 512, band: int = BAND) -> tuple:
    """The kernel's sweeps on the CPU: the separable stencil, the in-place
    row run-min and the segmented column run-min; each image stops after a
    sweep that changed none of its labels.  Returns (labels, the sweeps
    the batch ran)."""
    B, H, W = mask.shape
    bg = H * W
    lab = torch.where(mask, torch.arange(bg).reshape(1, H, W), bg)
    running = torch.ones(B, dtype=torch.bool)
    sweeps = 0
    while sweeps < max_iters and bool(running.any()):
        new = column_run_min_bands(row_run_min_in_place(
            stencil_separable(lab, connectivity, bg), bg), bg, band)
        new = torch.where(running[:, None, None], new, lab)
        running = (new < lab).flatten(1).any(dim=1)
        lab = new
        sweeps += 1
    return lab.to(torch.int32), sweeps


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build of the kernel with the argument types of its C entry points
    set: the labelling, its grid, and its grid's empty barriers."""
    lib.mask_components.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
    lib.mask_components_grid.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.mask_components_barriers.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    for fn in (lib.mask_components, lib.mask_components_grid,
               lib.mask_components_barriers):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The committed kernel's library, built at first use."""
    from ..kernels import load
    return _typed(load("mask_components"))


#: The kernel's tallies, the last words of its ctrl buffer (the pass times
#: only in a build with MASK_COMPONENTS_STATS defined).
TALLY_KEYS = ("row_ns", "column_ns", "barriers", "sweeps")
#: The kernel's grid (`kernel_grid`).
GRID_KEYS = ("blocks", "blocks_per_sm", "registers", "smem_bytes",
             "band_rows", "segment_rows")
#: The largest H and W the kernel takes: a band of the row pass and the
#: column pass's segment summaries are held in a block's shared memory.
MAX_SIDE = 29056


def connected_components_cuda(mask: torch.Tensor, connectivity: int = 8,
                              max_iters: int = 512,
                              lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """Launch csrc/mask_components.cu (or `lib`, another build of it) on
    the current stream: the plain version's labels for a (B, H, W) bool
    CUDA mask, (B, H, W) int32.  One launch, no host sync; a refused launch
    raises."""
    if mask.device.type != "cuda" or mask.dtype != torch.bool:
        raise ValueError(f"connected_components_cuda takes a bool CUDA "
                         f"mask, got {mask.dtype} on {mask.device}")
    if mask.dim() != 3 or mask.numel() == 0:
        raise ValueError(f"connected_components_cuda takes a non-empty "
                         f"(B, H, W) mask, got {tuple(mask.shape)}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity {connectivity} (4 or 8)")
    B, H, W = mask.shape
    if H * W >= 2 ** 31 - 1 or max(H, W) > MAX_SIDE:
        raise ValueError(f"connected_components_cuda takes H W < 2^31 - 1 "
                         f"and H, W <= {MAX_SIDE}, got {H} x {W}")
    mask = mask.contiguous()
    out = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
    # The row pass's output.
    work = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
    # Per image: the sweep in which it last changed (a stamp), read and
    # written in alternate slots; then the tallies.
    ctrl = torch.zeros(2 * B + len(TALLY_KEYS), dtype=torch.int32,
                       device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = (_library() if lib is None else _typed(lib)).mask_components(
            B, H, W, connectivity, max_iters, mask.data_ptr(),
            out.data_ptr(), work.data_ptr(), ctrl.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mask_components kernel launch failed: CUDA "
                           f"error {err}")
    connected_components_cuda.kernel_launches += 1
    connected_components_cuda.last_ctrl = ctrl
    return out


#: Launches of the mask-components kernel since the count was last set
#: to 0.
connected_components_cuda.kernel_launches = 0
#: The last launch's ctrl words, left on the card; the last one holds the
#: sweeps it ran.
connected_components_cuda.last_ctrl = None


def kernel_tally(ctrl: torch.Tensor) -> dict:
    """A launch's tallies (`TALLY_KEYS`, host): the row and column passes'
    device ns (with MASK_COMPONENTS_STATS, else 0), its grid-wide barriers
    and its sweeps."""
    c = ctrl.cpu()[-len(TALLY_KEYS):]
    return {key: int(v) for key, v in zip(TALLY_KEYS, c)}


def kernel_grid(H: int, W: int, lib: ctypes.CDLL | None = None) -> dict:
    """The kernel's grid for (H, W) masks on the current card
    (`GRID_KEYS`), or that of `lib`, another build of it."""
    info = (ctypes.c_int * len(GRID_KEYS))()
    err = (_library() if lib is None else _typed(lib)).mask_components_grid(
        H, W, info)
    if err != 0:
        raise RuntimeError(f"mask_components_grid failed: CUDA error {err}")
    return dict(zip(GRID_KEYS, info))


def barrier_loop_cuda(H: int, W: int, n: int, device) -> None:
    """`n` empty grid-wide barriers on the kernel's grid for (H, W): its
    barrier floor, for timing."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mask_components_barriers(H, W, n, stream)
    if err != 0:
        raise RuntimeError(f"mask_components_barriers launch failed: CUDA "
                           f"error {err}")


def connected_components(mask: torch.Tensor, connectivity: int = 8,
                         max_iters: int = 512) -> torch.Tensor:
    """Label the connected True-regions of each (H, W) image of `mask`
    (B, H, W): (B, H, W) int32, each component by its minimum linear index
    in its image, background H*W.  CUDA masks run the kernel, CPU masks
    the plain version."""
    if mask.device.type == "cpu":
        return connected_components_plain(mask, connectivity, max_iters)
    return connected_components_cuda(mask.bool(), connectivity, max_iters)


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """(B,) per-image values broadcast over (B, H, W)."""
    return v[:, None, None]


def _clean_mask(mask: torch.Tensor, min_area: float, keep_largest: bool,
                posterior: torch.Tensor | None = None) -> torch.Tensor:
    """For each (H, W) image of `mask` (B, H, W): drop components below
    `min_area` pixels (never all of them), or keep the largest
    non-frame-like component, optionally with runner-ups whose mean
    posterior is within KEEP_LARGEST_CONF_GATE of the winner's.
    (B, H, W) uint8 in {0, 1}.  No host sync: each of JAX's branches is a
    ``torch.where`` on a per-image reduction."""
    B, H, W = mask.shape
    hw = H * W
    labels = connected_components(mask > 0, connectivity=8).long()
    clamped = labels.clamp_max(hw - 1)
    seg = (clamped + torch.arange(B, device=mask.device
                                  ).reshape(B, 1, 1) * hw).reshape(-1)
    valid_px = (labels < hw).float()

    planes = [valid_px]
    if keep_largest:
        on_border = torch.zeros((H, W), device=mask.device)
        on_border[0, :] = 1.0
        on_border[-1, :] = 1.0
        on_border[:, 0] = 1.0
        on_border[:, -1] = 1.0
        planes.append(on_border * valid_px)
        if posterior is not None:
            planes.append(posterior.float() * valid_px)
    sums = segment_sum(seg, torch.stack(planes, dim=-1).reshape(B * hw, -1),
                       B * hw)

    def per_pixel(col):
        return sums[:, col][seg].reshape(B, H, W)

    comp_size = torch.where(labels < hw, per_pixel(0), 0.0)

    keep_minarea = comp_size >= min_area
    largest_sz = comp_size.amax(dim=(1, 2))
    keep_minarea = torch.where(
        _per_image(keep_minarea.any(dim=2).any(dim=1)), keep_minarea,
        (comp_size >= _per_image(largest_sz)) & (comp_size > 0))
    if not keep_largest:
        return keep_minarea.to(torch.uint8)

    # Components hugging much of the border are frame-like: demoted unless
    # nothing else exists.
    perimeter = float(2 * (H + W) - 4)
    frame_like = per_pixel(1) / perimeter > 0.3
    eff_size = torch.where(frame_like, 0.0, comp_size)
    score = torch.where(_per_image((eff_size > 0).any(dim=2).any(dim=1)),
                        eff_size, comp_size)
    keep = (score >= _per_image(score.amax(dim=(1, 2)))) & (score > 0)
    if posterior is None:
        return keep.to(torch.uint8)

    pmass_px = torch.where(labels < hw, per_pixel(2), 0.0)
    mean_p = pmass_px / comp_size.clamp_min(1.0)
    winner_mean = torch.where(keep, mean_p, 0.0).amax(dim=(1, 2))
    confident = ((eff_size > 0) & ~keep
                 & (mean_p >= KEEP_LARGEST_CONF_GATE
                    * _per_image(winner_mean))
                 & (comp_size >= min_area))
    return (keep | confident).to(torch.uint8)


def clean_mask(mask, min_area_ratio: float = 0.002,
               keep_largest: bool = False, posterior=None,
               device=None) -> np.ndarray:
    """Remove spurious connected components from a binary (H, W) mask:
    components below `min_area_ratio` of the image are dropped (never all
    of them), or only the largest non-frame-like one is kept, gated on the
    (H, W) foreground `posterior` when given.  numpy in, numpy out; runs
    on `device` (default: the card)."""
    mask = np.asarray(mask)
    if mask.sum() == 0 or (min_area_ratio <= 0 and not keep_largest):
        return mask
    dev = resolve_device(device)
    post = (None if posterior is None
            else torch.as_tensor(np.asarray(posterior), device=dev)[None])
    out = _clean_mask(torch.as_tensor(mask, device=dev)[None],
                      min_area_ratio * mask.size, keep_largest, post)
    return out[0].cpu().numpy()
