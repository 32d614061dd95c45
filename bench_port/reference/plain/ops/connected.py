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

`connected_components` runs eager sweeps that test the batch's
convergence on the host once a sweep, in place of the JAX package's
``lax.while_loop``.

The clean-up's per-component sums (sizes, border counts, posterior mass)
run in a fixed order on every device (`ops.region.segment_sum`, segment
b·H·W + label): a float ``index_add_`` adds in no fixed order on CUDA,
which could flip a runner-up sitting at the keep-largest gate from one run
to the next.  Every maximum and test of the clean-up is per image, so an
image's mask in a batch is its mask alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    """Eager sweeps of the (B, H, W) batch
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
    return lab.to(torch.int32)


def connected_components(mask: torch.Tensor, connectivity: int = 8,
                         max_iters: int = 512) -> torch.Tensor:
    """Label the connected True-regions of each (H, W) image of `mask`
    (B, H, W): (B, H, W) int32, each component by its minimum linear index
    in its image, background H*W."""
    return connected_components_plain(mask, connectivity, max_iters)


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


