"""Connected-component labelling and small-component mask clean-up.

Counterpart of ``gcn_grabcut_tpu/ops/connected.py``.  Each sweep is one
8-neighbour min stencil followed by a run-min along rows and along columns,
repeated to the fixpoint; a component is labelled by the minimum linear
index it contains (background: H*W).

The JAX package propagates along runs with a segmented min-scan
(``lax.associative_scan``) forward and backward; together the two scans
give every foreground pixel the minimum over its maximal run, which here is
a ``scatter_reduce("amin")`` over run ids from ``cumsum(is_bg)`` and a
gather back.  Integer arithmetic: the labels equal the JAX package's
exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEIGHBOURS_8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                 (0, 1), (1, -1), (1, 0), (1, 1))
_NEIGHBOURS_4 = ((-1, 0), (0, -1), (0, 1), (1, 0))

#: keep-largest coherence gate: a runner-up component survives when its
#: mean posterior is at least this fraction of the winner's.
KEEP_LARGEST_CONF_GATE = 0.75


def _run_min(lab: torch.Tensor, mask: torch.Tensor, bg: int, dim: int
             ) -> torch.Tensor:
    """Each foreground pixel takes the min of `lab` over its maximal
    foreground run along `dim`; background pixels get `bg`."""
    if dim == 0:
        return _run_min(lab.T, mask.T, bg, 1).T
    H, W = lab.shape
    run = torch.cumsum((~mask).long(), dim=1)            # run id per row
    key = (torch.arange(H, device=lab.device)[:, None] * (W + 1)
           + run).reshape(-1)
    mins = torch.full((H * (W + 1),), bg, dtype=lab.dtype,
                      device=lab.device).scatter_reduce(
        0, key, lab.reshape(-1), reduce="amin", include_self=True)
    return torch.where(mask, mins[key].reshape(H, W), bg)


def connected_components(mask: torch.Tensor, connectivity: int = 8,
                         max_iters: int = 512) -> torch.Tensor:
    """Label the connected True-regions of `mask` (H, W): (H, W) int32,
    each component by its minimum linear index, background H*W."""
    H, W = mask.shape
    bg = H * W
    nbrs = _NEIGHBOURS_8 if connectivity == 8 else _NEIGHBOURS_4
    idx = torch.arange(H * W, device=mask.device).reshape(H, W)
    lab = torch.where(mask, idx, bg)
    for _ in range(max_iters):
        lp = F.pad(lab, (1, 1, 1, 1), value=bg)
        new = lab
        for dy, dx in nbrs:
            new = torch.minimum(new, lp[1 - dy:1 - dy + H, 1 - dx:1 - dx + W])
        new = torch.where(mask, new, bg)
        new = _run_min(new, mask, bg, 1)
        new = _run_min(new, mask, bg, 0)
        changed = bool((new < lab).any())
        lab = new
        if not changed:
            break
    return lab.to(torch.int32)


def _clean_mask(mask: torch.Tensor, min_area: float, keep_largest: bool,
                posterior: torch.Tensor | None = None) -> torch.Tensor:
    """Drop components below `min_area` pixels (never all of them), or keep
    the largest non-frame-like component, optionally with runner-ups whose
    mean posterior is within KEEP_LARGEST_CONF_GATE of the winner's.
    (H, W) uint8 in {0, 1}."""
    H, W = mask.shape
    hw = H * W
    labels = connected_components(mask > 0, connectivity=8).long()
    flat = labels.reshape(-1)
    clamped = flat.clamp_max(hw - 1)
    valid_px = (flat < hw).float()

    def segsum(v):
        return torch.zeros(hw, device=v.device).index_add_(0, clamped, v)

    sizes = segsum(valid_px)
    comp_size = torch.where(labels < hw, sizes[clamped].reshape(H, W), 0.0)

    keep_minarea = comp_size >= min_area
    largest_sz = comp_size.max()
    if not bool(keep_minarea.any()):
        keep_minarea = (comp_size >= largest_sz) & (comp_size > 0)
    if not keep_largest:
        return keep_minarea.to(torch.uint8)

    # Components hugging much of the border are frame-like: demoted unless
    # nothing else exists.
    on_border = torch.zeros((H, W), device=mask.device)
    on_border[0, :] = 1.0
    on_border[-1, :] = 1.0
    on_border[:, 0] = 1.0
    on_border[:, -1] = 1.0
    border_cnt = segsum(on_border.reshape(-1) * valid_px)
    perimeter = float(2 * (H + W) - 4)
    frame_like = border_cnt[clamped].reshape(H, W) / perimeter > 0.3
    eff_size = torch.where(frame_like, 0.0, comp_size)
    score = eff_size if bool((eff_size > 0).any()) else comp_size
    keep = (score >= score.max()) & (score > 0)
    if posterior is None:
        return keep.to(torch.uint8)

    pmass = segsum(posterior.reshape(-1).float() * valid_px)
    pmass_px = torch.where(labels < hw, pmass[clamped].reshape(H, W), 0.0)
    mean_p = pmass_px / comp_size.clamp_min(1.0)
    winner_mean = torch.where(keep, mean_p, 0.0).max()
    confident = ((eff_size > 0) & ~keep
                 & (mean_p >= KEEP_LARGEST_CONF_GATE * winner_mean)
                 & (comp_size >= min_area))
    return (keep | confident).to(torch.uint8)
