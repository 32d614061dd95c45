"""Parallel push-relabel min-cut on the pixel lattice.

Counterpart of ``gcn_grabcut_tpu/ops/maxflow.py``.  Terminal arcs fold into
a signed excess e = cap_src - cap_snk (negative excess is the distributed
sink); neighbour arcs are per-direction residual pairs (r_fwd, r_bwd).
Pushes run one direction at a time so writes never conflict, heights are
refreshed by a global relabel (BFS distance to the nearest deficit pixel),
and the cut's source side is every pixel that cannot reach the sink after
the final exact relabel -- the minimal source set, so tied cuts resolve as
in the JAX package.

The solver runs a batch of same-size lattices in lock step
(``grid_mincut_batch``, the JAX package's ``vmap`` of the solve): each image
stops when it converges.  JAX's while loops become Python loops that test
convergence once per block of steps (one host sync each, for the whole
batch).  Arrays that are read shifted
(heights, backward residuals, the flow being pushed) live in buffers padded
by one pixel whose border holds the out-of-image fill value, so a shift is
a view rather than a copy; updates go to the interiors in place, with the
same float32 operations in the same order as the JAX stencils.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Undirected lattice directions: the offset (dy, dx) from p to the
# neighbour "ahead" of it (cv2.grabCut's left / up / up-left / up-right).
OFFSETS_4 = ((0, -1), (-1, 0))
OFFSETS_8 = ((0, -1), (-1, 0), (-1, -1), (-1, 1))


def _pad(a: torch.Tensor, fill) -> torch.Tensor:
    """Pad the last two dimensions by one pixel of `fill`."""
    return F.pad(a, (1, 1, 1, 1), value=fill)


def _view(ap: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., p] = a[..., p + (dy, dx)] for a one-pixel padded buffer
    `ap` (..., H + 2, W + 2) whose border holds the fill value: the JAX
    package's _shift_from(a, dy, dx, fill) as a view, and _shift_to(a, dy,
    dx) as _view(ap, -dy, -dx)."""
    H, W = ap.shape[-2] - 2, ap.shape[-1] - 2
    return ap[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _zero_border(cap: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero the capacity of arcs that would cross the image border."""
    cap = cap.clone()
    if dy == -1:
        cap[..., 0, :] = 0.0
    if dx == -1:
        cap[..., :, 0] = 0.0
    if dx == 1:
        cap[..., :, -1] = 0.0
    return cap


def _fresh_residuals(caps, offsets):
    r_fwd = tuple(_zero_border(c.float(), dy, dx)
                  for c, (dy, dx) in zip(caps, offsets))
    return r_fwd, r_fwd


def _resolve_params(H, W, connectivity, relabel_iters):
    offsets = OFFSETS_8 if connectivity == 8 else OFFSETS_4
    if relabel_iters is None:
        # The BFS must reach the full residual-path diameter; it stops at
        # the fixpoint, so the generous cap only costs on long instances.
        relabel_iters = 4 * (H + W)
    return offsets, relabel_iters


def relabel_arcs(r_fwd, rbp, offsets, inf: int) -> list:
    """The relabel's usable arcs: one ((dy, dx), addend) per direction and
    sense, the addend an int32 plane that is 1 where p -> p + (dy, dx) has
    residual capacity and `inf` where not (so the candidate is then >= inf
    and never wins, as the JAX where does).  `rbp` the backward residuals
    padded by one pixel of 0."""
    arcs = []
    for d, (dy, dx) in enumerate(offsets):
        arcs.append(((dy, dx), torch.where(r_fwd[d] > 0, 1, inf
                                           ).to(torch.int32)))
        arcs.append(((-dy, -dx), torch.where(
            _view(rbp[d], -dy, -dx) > 0, 1, inf).to(torch.int32)))
    return arcs


def relax_steps(bufs: list, cur: int, arcs: list, steps: int) -> int:
    """`steps` min-plus steps of the relabel from the padded heights
    bufs[cur] (border `inf`), ping-ponging between the two padded buffers
    of `bufs`; returns the index of the one holding the result.  Works on
    any window whose arcs and heights it is given: a pixel's step reads
    its neighbours one pixel away, so `steps` steps leave exact what lies
    `steps` pixels inside the window."""
    tmp = torch.empty(_view(bufs[cur], 0, 0).shape, dtype=torch.int32,
                      device=bufs[cur].device)
    for _ in range(steps):
        src, dst = bufs[cur], bufs[1 - cur]
        new = _view(dst, 0, 0)
        new.copy_(_view(src, 0, 0))
        for (oy, ox), add in arcs:
            torch.add(_view(src, oy, ox), add, out=tmp)
            torch.minimum(new, tmp, out=new)
        cur = 1 - cur
    return cur


def global_relabel(e, r_fwd, rbp, offsets, relabel_iters: int,
                   unroll: int, inf: int):
    """Padded heights: distance to the nearest deficit pixel along
    residual arcs, by min-plus relaxation to the fixpoint (at most
    relabel_iters steps, in blocks of `unroll` testing only each block's
    last step).  The batch relaxes until its last image's fixpoint, where
    the others' heights no longer move.  Returns (padded heights, steps
    run); one host sync per block."""
    arcs = relabel_arcs(r_fwd, rbp, offsets, inf)
    h0 = torch.where(e < 0, 0, inf).to(torch.int32)
    bufs = [_pad(h0, inf), torch.full(rbp[0].shape, inf, dtype=torch.int32,
                                      device=e.device)]
    cur, it = 0, 0
    while it < relabel_iters:
        cur = relax_steps(bufs, cur, arcs, unroll)
        it += unroll
        # Relaxation is monotone: a step that changes nothing is the
        # fixpoint, so testing the last step ends where the JAX block
        # test does.
        if not bool((_view(bufs[cur], 0, 0)
                     < _view(bufs[1 - cur], 0, 0)).any()):
            break
    return bufs[cur], it


def push_sweep(e, hp, r_fwd, rbp, fp, offsets, inf: int) -> None:
    """One lock-step push sweep over all directions, then the lift, in
    place: `e` and each `r_fwd[d]` (..., H, W), the heights `hp`, the
    backward residuals `rbp[d]` and the flow scratch `fp` padded by one
    pixel (borders inf, 0 and 0).  Works on any window it is given: a
    window `sweep_halo` pixels wider than a tile, with heights one pixel
    wider still, leaves the tile exact."""
    h = _view(hp, 0, 0)
    f = _view(fp, 0, 0)
    zero = torch.zeros((), device=e.device)
    hfin = h < inf
    for d, (dy, dx) in enumerate(offsets):
        rf, rb = r_fwd[d], _view(rbp[d], 0, 0)
        # Push p -> p + off along r_fwd.
        can = ((e > 0) & hfin & (h == _view(hp, dy, dx) + 1)
               & (rf > 0))
        torch.where(can, torch.minimum(e, rf), zero, out=f)
        rf.sub_(f)
        rb.add_(f)
        e.sub_(f).add_(_view(fp, -dy, -dx))
        # Push p -> p - off along the neighbour's r_bwd.
        res = _view(rbp[d], -dy, -dx)
        can = ((e > 0) & hfin & (h == _view(hp, -dy, -dx) + 1)
               & (res > 0))
        torch.where(can, torch.minimum(e, res), zero, out=f)
        back = _view(fp, dy, dx)
        rb.sub_(back)
        rf.add_(back)
        e.sub_(f).add_(back)
    # Relabel: overflowing pixels lift to 1 + min reachable neighbour.
    new_h = torch.full_like(h, inf)
    for d, (dy, dx) in enumerate(offsets):
        new_h = torch.minimum(new_h, torch.where(
            r_fwd[d] > 0, _view(hp, dy, dx) + 1, inf))
        new_h = torch.minimum(new_h, torch.where(
            _view(rbp[d], -dy, -dx) > 0, _view(hp, -dy, -dx) + 1, inf))
    lift = (e > 0) & hfin
    h_next = torch.where(lift, torch.maximum(h, new_h), h)
    h.copy_(torch.where(e < 0, 0, h_next))


def _build_solver(H: int, W: int, offsets, max_outer: int,
                  sweeps_per_round: int, relabel_iters: int,
                  unroll: int = 4):
    """solve(e, r_fwd, r_bwd) -> (fg, e', r_fwd', r_bwd') on a batch of B
    lattices in lock step: `e` and every residual plane (B, H, W).

    Each image's outer loop runs while that image has an active pixel
    (the JAX package's ``outer_cond`` under ``vmap``).  An image that has
    converged is frozen -- its excess and residuals are written back and
    it leaves the working set -- because sweeping it further could still
    move flow (a pixel with 0 < e <= 1e-6 pushes) and so change the flow
    its next solve resumes from.  Every stencil is elementwise, so each
    image ends bit for bit where a solve of it alone ends.  One host sync
    per outer round and one per relabel block, for the whole batch.

    Arbitrary starting residuals allow flow recycling across GrabCut
    iterations (Kohli & Torr): only the terminal capacities move, so the
    previous flow stays a valid preflow."""
    INF = H * W + 1
    n_sweeps = _n_sweeps(sweeps_per_round, unroll)
    def relabel(e, r_fwd, rbp):
        return global_relabel(e, r_fwd, rbp, offsets, relabel_iters,
                              unroll, INF)[0]

    def solve(excess, r_fwd, r_bwd):
        # Work on copies: the caller's tensors stay unchanged.
        e = excess.float().clone()
        r_fwd = [r.float().clone() for r in r_fwd]
        rbp = [_pad(r.float(), 0.0) for r in r_bwd]
        B, dev = e.shape[0], e.device
        # The working set: the images still active, by batch index, and
        # their state (the whole batch's tensors until one converges).
        live = np.arange(B)
        we, wrf, wrbp = e, r_fwd, rbp
        fp = torch.zeros(rbp[0].shape, device=dev)

        def write_back(sel):
            """Copy the working images `sel` (host bool) into the batch."""
            if we is e:
                return
            src = torch.as_tensor(np.flatnonzero(sel), device=dev)
            at = torch.as_tensor(live[sel], device=dev)
            for full, part in zip([e, *r_fwd, *rbp], [we, *wrf, *wrbp]):
                full.index_copy_(0, at, part.index_select(0, src))

        hp = relabel(e, r_fwd, rbp)
        for _ in range(max_outer):
            active = ((we > 1e-6) & (_view(hp, 0, 0) < INF)
                      ).flatten(1).any(1).cpu().numpy()
            if not active.all():
                # Freeze the converged images: back into the batch, out of
                # the working set.
                write_back(~active)
                if not active.any():
                    break
                keep = torch.as_tensor(np.flatnonzero(active), device=dev)
                we = we.index_select(0, keep)
                wrf = [r.index_select(0, keep) for r in wrf]
                wrbp = [r.index_select(0, keep) for r in wrbp]
                fp = fp[:len(keep)]
                live = live[active]
            hp = relabel(we, wrf, wrbp)
            for _ in range(n_sweeps):
                push_sweep(we, hp, wrf, wrbp, fp, offsets, INF)
        else:
            write_back(np.ones(len(live), bool))
        hp = relabel(e, r_fwd, rbp)
        return (_view(hp, 0, 0) >= INF, e, tuple(r_fwd),
                tuple(_view(r, 0, 0) for r in rbp))

    return solve


def _n_sweeps(sweeps_per_round: int, unroll: int) -> int:
    """Push sweeps per outer round: whole blocks of `unroll`."""
    return max(1, sweeps_per_round // unroll) * unroll


def grid_mincut_plain(excess: torch.Tensor, r_fwd: tuple, r_bwd: tuple,
                      connectivity: int = 8, max_outer: int = 400,
                      sweeps_per_round: int = 48,
                      relabel_iters: int | None = None, unroll: int = 4):
    """`grid_mincut_batch` in eager stencils on any device, host-side
    loops (one sync per relabel block and round)."""
    _, H, W = excess.shape
    offsets, relabel_iters = _resolve_params(H, W, connectivity,
                                             relabel_iters)
    if len(r_fwd) != len(offsets) or len(r_bwd) != len(offsets):
        raise ValueError(f"{len(r_fwd)} / {len(r_bwd)} residual planes for "
                         f"{connectivity}-connectivity")
    solve = _build_solver(H, W, offsets, max_outer, sweeps_per_round,
                          relabel_iters, unroll)
    return solve(excess, r_fwd, r_bwd)


def grid_mincut_batch(excess: torch.Tensor, r_fwd: tuple, r_bwd: tuple,
                      connectivity: int = 8, max_outer: int = 400,
                      sweeps_per_round: int = 48,
                      relabel_iters: int | None = None, unroll: int = 4):
    """The min-cut of B same-size lattices in lock step:
    `excess` and every residual plane (B, H, W).  Returns (fg, e', r_fwd',
    r_bwd') with the same leading B, each image bit for bit its solve
    alone (the solver's docstring); the caller's tensors stay unchanged."""
    return grid_mincut_plain(excess, r_fwd, r_bwd, connectivity, max_outer,
                             sweeps_per_round, relabel_iters, unroll)


