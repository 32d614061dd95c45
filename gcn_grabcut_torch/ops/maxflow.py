"""Parallel push-relabel min-cut on the pixel lattice.

Counterpart of ``gcn_grabcut_tpu/ops/maxflow.py``.  Terminal arcs fold into
a signed excess e = cap_src - cap_snk (negative excess is the distributed
sink); neighbour arcs are per-direction residual pairs (r_fwd, r_bwd).
Pushes run one direction at a time so writes never conflict, heights are
refreshed by a global relabel (BFS distance to the nearest deficit pixel),
and the cut's source side is every pixel that cannot reach the sink after
the final exact relabel -- the minimal source set, so tied cuts resolve as
in the JAX package.

Port notes.  The solver runs a batch of same-size lattices in lock step
(``grid_mincut_batch``, the JAX package's ``vmap`` of the solve): each image
stops when it converges.  On the card the whole solve is one launch of a
hand-written kernel (csrc/grid_mincut.cu) that keeps JAX's while loops and
their convergence tests on the device: no host sync inside a solve.  Its
plain version, `grid_mincut_plain`, runs every CPU solve: the while loops
become Python loops that test convergence once per block of steps (one
host sync each, for the whole batch).  Arrays that are read shifted
(heights, backward residuals, the flow being pushed) live in buffers padded
by one pixel whose border holds the out-of-image fill value, so a shift is
a view rather than a copy; updates go to the interiors in place, with the
same float32 operations in the same order as the JAX stencils.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import Recorder, trace_span

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


class SolverCounts(Recorder):
    """The device solver's work: per call, each image's outer rounds and
    push sweeps; in all, the global relabel's relaxation steps (each over
    the call's whole working set) and the host syncs.  A solve is recorded
    as `utils.Recorder` says: after `reset()` and while a torch profiler
    records.  Otherwise nothing is kept, and a kernel solve takes no pinned
    copy and no event.  `syncs`, the plain version's host syncs, is a
    plain counter.  The plain version tallies on the host as it solves.  A
    kernel solve's tallies are copied behind it into pinned host memory,
    with an event; they are read when the event has passed (checked
    without waiting at the next kernel solve) or when a count is read
    (waiting then), so the solve itself does not sync and no device
    memory is kept."""

    def _clear(self) -> None:
        # Per call: [rounds (B,) numpy, push sweeps per round, relabel
        # steps, the kernel's tally (`kernel_tally` and its grid) or None].
        self._calls: list = []
        # Kernel solves not yet read: (call, host ctrl, event).
        self._pending: list = []
        self.syncs = 0

    def _record(self, rounds, n_sweeps: int, relabel_steps: int) -> None:
        if self.active:
            self._calls.append([rounds, n_sweeps, relabel_steps, None])

    def _record_kernel(self, ctrl, done, n_sweeps: int, grid: dict) -> None:
        """A kernel solve: `ctrl` a host int32 tensor that holds the
        kernel's tallies once `done` (a CUDA event, or anything with
        query() and synchronize()) has passed; `grid` the launch's grid."""
        if not self.active:
            return
        self._read(wait=False)
        call = [None, n_sweeps, None, dict(grid)]
        self._calls.append(call)
        self._pending.append((call, ctrl, done))

    def _read(self, wait: bool) -> None:
        """Read the pending kernel tallies in order: all of them (waiting
        for each) or those whose event has passed."""
        while self._pending:
            call, ctrl, done = self._pending[0]
            if wait:
                done.synchronize()
            elif not done.query():
                return
            tally = kernel_tally(ctrl)
            call[0], call[2] = tally["rounds"], tally["relabel_steps"]
            call[3].update(tally)
            self._pending.pop(0)

    def _settled(self) -> list:
        self._read(wait=True)
        return self._calls

    @property
    def rounds(self) -> list:
        """One (B,) array of outer rounds per call."""
        return [c[0] for c in self._settled()]

    @property
    def sweeps(self) -> list:
        """One (B,) array of push sweeps per call."""
        return [c[0] * c[1] for c in self._settled()]

    @property
    def relabel_steps(self) -> int:
        return sum(c[2] for c in self._settled())

    @property
    def kernel_tallies(self) -> list:
        """One dict per kernel solve: `kernel_tally`'s keys and the
        launch's grid (blocks, blocks_per_sm, registers, the tiles, halos
        and dynamic shared memory)."""
        return [c[3] for c in self._settled() if c[3] is not None]

    def totals(self) -> dict:
        """The recorded solves summed: solves, each image's outer rounds,
        relabel steps; the kernel solves' grid barriers, sweep tiles swept
        and relax tiles relaxed (a plain solve has none); host syncs."""
        calls = self._settled()
        kernel = [c[3] for c in calls if c[3] is not None]
        return dict(solves=len(calls),
                    rounds=sum(int(np.sum(c[0])) for c in calls),
                    relabel_steps=sum(int(c[2]) for c in calls),
                    barriers=sum(t["barriers"] for t in kernel),
                    swept_tiles=sum(t["swept_tiles"] for t in kernel),
                    relax_tiles=sum(t["relax_tiles"] for t in kernel),
                    syncs=self.syncs)


#: Tallies of the solves since ``counts.reset()``, and of those launched
#: while a profiler records.
counts = SolverCounts()

# The kernel's ctrl words: relabel steps, grid barriers, relabel
# image-steps, stopped images' height copies, sweep tiles swept, relax
# tiles relaxed; in a build with GRID_MINCUT_STATS defined (else 0) quiet
# sweep tiles swept, relax tiles skipped, the push sweeps' and the
# relabels' microseconds; then each image's round number, then each
# image's relax stamp (csrc/grid_mincut.cu).
CTRL_HEAD = 10


def kernel_tally(ctrl: torch.Tensor) -> dict:
    """The kernel's tallies from its ctrl buffer (copied to the host if it
    is on the card): each image's outer rounds, the batch's relabel steps,
    the grid-wide barriers, the relabel's image-steps (the steps each
    image was relaxed, summed over the images), the height copies of
    images that stopped relaxing before their relabel's last block, the
    push sweeps' tiles swept (the others were skipped: their neighbourhood
    was quiet in the round's previous sweep) and the relax tiles relaxed.
    A build with GRID_MINCUT_STATS defined also tallies the quiet tiles
    swept (no active pixel in the window: they only add +0), the relax
    tiles skipped (no height of the window moved in the last sub-block)
    and the device microseconds spent in push sweeps and in relabels (the
    card's clock read by one thread around each phase, which ends in a
    grid barrier); the committed build leaves them 0."""
    c = ctrl.cpu().numpy().astype(np.int64)
    b = (len(c) - CTRL_HEAD) // 2
    return dict(rounds=c[CTRL_HEAD:CTRL_HEAD + b], relabel_steps=int(c[0]),
                barriers=int(c[1]), relabel_image_steps=int(c[2]),
                image_copies=int(c[3]), swept_tiles=int(c[4]),
                relax_tiles=int(c[5]), quiet_tiles=int(c[6]),
                relax_skipped=int(c[7]), sweep_us=int(c[8]),
                relabel_us=int(c[9]))


def sweep_halo(connectivity: int) -> int:
    """Pixels of halo a tile of one push sweep needs on each side so that
    its interior ends bit for bit as the whole lattice's sweep leaves it
    (csrc/grid_mincut.cu's tiles; tests/test_torch_mincut_tiles.py holds it
    exact and one less short).  Direction d's forward push, backward push
    and receive make p's excess and residuals depend on the state at p -
    off, p and p + off: one pixel along each axis on which off moves.  The
    lift reads the residuals at p - off and p, which its direction already
    made exact wherever p is, and heights never change within a sweep (a
    tile reads them one pixel further).  So the halo along an axis is the
    number of directions moving along it, and the tile's the larger: 3 at
    8-connectivity (W, NW, NE across, N, NW, NE down), 1 at 4."""
    offsets = OFFSETS_8 if connectivity == 8 else OFFSETS_4
    return max(sum(dy != 0 for dy, _ in offsets),
               sum(dx != 0 for _, dx in offsets))


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
        counts.syncs += 1
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
    steps = 0       # relabel steps of this solve

    def relabel(e, r_fwd, rbp):
        nonlocal steps
        hp, n = global_relabel(e, r_fwd, rbp, offsets, relabel_iters,
                               unroll, INF)
        steps += n
        return hp

    def solve(excess, r_fwd, r_bwd):
        # Work on copies: the caller's tensors stay unchanged.
        e = excess.float().clone()
        r_fwd = [r.float().clone() for r in r_fwd]
        rbp = [_pad(r.float(), 0.0) for r in r_bwd]
        B, dev = e.shape[0], e.device
        rounds = np.zeros(B, np.int64)
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
            counts.syncs += 1
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
            rounds[live] += 1
            hp = relabel(we, wrf, wrbp)
            for _ in range(n_sweeps):
                push_sweep(we, hp, wrf, wrbp, fp, offsets, INF)
        else:
            write_back(np.ones(len(live), bool))
        hp = relabel(e, r_fwd, rbp)
        counts._record(rounds, n_sweeps, steps)
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
    """The kernel's plain version: `grid_mincut_batch` in eager stencils on
    any device, host-side loops (one sync per relabel block and round)."""
    _, H, W = excess.shape
    offsets, relabel_iters = _resolve_params(H, W, connectivity,
                                             relabel_iters)
    if len(r_fwd) != len(offsets) or len(r_bwd) != len(offsets):
        raise ValueError(f"{len(r_fwd)} / {len(r_bwd)} residual planes for "
                         f"{connectivity}-connectivity")
    solve = _build_solver(H, W, offsets, max_outer, sweeps_per_round,
                          relabel_iters, unroll)
    return solve(excess, r_fwd, r_bwd)


def _entries(lib: ctypes.CDLL) -> tuple:
    """A built grid_mincut library's C entry points, argument types set."""
    solve = lib.grid_mincut
    solve.argtypes = [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    solve.restype = ctypes.c_int
    barriers = lib.grid_barrier_loop
    barriers.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    barriers.restype = ctypes.c_int
    return solve, barriers


# The launch's grid as grid_mincut reports it (`info`, in this order).
GRID_KEYS = ("blocks", "blocks_per_sm", "registers", "tile_h", "tile_w",
             "halo", "smem_bytes", "relax_tile_h", "relax_tile_w",
             "relax_halo")


@functools.cache
def _kernel():
    """The committed kernel's C entry points, built and loaded once."""
    from ..kernels import load
    return _entries(load("grid_mincut"))


def grid_mincut_cuda(e: torch.Tensor, r_fwd: tuple, r_bwd: tuple,
                     connectivity: int = 8, max_outer: int = 400,
                     n_sweeps: int = 48, relabel_iters: int | None = None,
                     unroll: int = 4, lib: ctypes.CDLL | None = None):
    """Launch the min-cut kernel (csrc/grid_mincut.cu, or `lib`, another
    build of it) on the current stream: the whole solve of `e` and the
    residual planes, each a contiguous float32 (B, H, W) tensor on one
    CUDA device, updated in place (`n_sweeps` push sweeps per round, whole
    blocks of `unroll`).  Returns (fg, ctrl, grid): fg (B, H, W) bool, the
    kernel's int32 tallies (`kernel_tally`), left on the card, and the
    launch's grid (`GRID_KEYS`).  One launch, no host sync; a refused
    launch or shared-memory attribute raises, and so does a launch whose
    sweep tiles were compiled with another halo than `sweep_halo`'s."""
    planes = [e, *r_fwd, *r_bwd]
    n_dirs = connectivity // 2
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity {connectivity} (4 or 8)")
    if len(r_fwd) != n_dirs or len(r_bwd) != n_dirs:
        raise ValueError(f"{len(r_fwd)} / {len(r_bwd)} residual planes for "
                         f"{connectivity}-connectivity")
    for t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"grid_mincut_cuda takes float32 planes, got "
                            f"{t.dtype}")
        if t.dim() != 3 or t.shape != e.shape:
            raise ValueError(f"plane {tuple(t.shape)} does not match the "
                             f"excess {tuple(e.shape)} (B, H, W)")
        if not t.is_contiguous():
            raise ValueError("grid_mincut_cuda needs contiguous planes")
    B, H, W = e.shape
    if e.numel() == 0 or H * W >= 2 ** 29:
        raise ValueError(f"grid_mincut_cuda takes 0 < H W < 2^29 pixels and "
                         f"B > 0, got {tuple(e.shape)}")
    if any(t.device != e.device for t in planes) or e.device.type != "cuda":
        raise ValueError(f"grid_mincut_cuda needs every plane on one CUDA "
                         f"device, got {sorted({str(t.device) for t in planes})}")
    if relabel_iters is None:
        relabel_iters = _resolve_params(H, W, connectivity, None)[1]
    if unroll < 1 or n_sweeps < 0:
        raise ValueError(f"unroll {unroll} (>= 1), n_sweeps {n_sweeps} "
                         f"(>= 0)")
    n = e.numel()
    # Two height planes (int32), the second set of the excess and residual
    # planes (the sweeps' double buffer, float32), the relabel's arc bits
    # (one byte a pixel), then two flags per sweep tile and two per relax
    # tile (room for tiles of 8 x 8).
    flags = 4 * B * -(-H // 8) * -(-W // 8)
    work = torch.empty((8 + 4 + 8 * n_dirs) * n + n + flags,
                       dtype=torch.uint8, device=e.device)
    fg = torch.empty(e.shape, dtype=torch.bool, device=e.device)
    ctrl = torch.zeros(CTRL_HEAD + 2 * B, dtype=torch.int32, device=e.device)
    ptrs = ctypes.c_void_p * 4
    rf = ptrs(*[t.data_ptr() for t in r_fwd])
    rb = ptrs(*[t.data_ptr() for t in r_bwd])
    info = (ctypes.c_int * len(GRID_KEYS))()
    solve, _ = _kernel() if lib is None else _entries(lib)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        err = solve(n_dirs, B, H, W, max_outer, n_sweeps, relabel_iters,
                    unroll, e.data_ptr(), rf, rb, work.data_ptr(),
                    fg.data_ptr(), ctrl.data_ptr(), stream, info)
    if err != 0:
        raise RuntimeError(f"grid_mincut kernel launch failed: CUDA error "
                           f"{err}")
    grid_mincut_cuda.kernel_launches += 1
    grid = dict(zip(GRID_KEYS, info))
    if grid["halo"] != sweep_halo(connectivity):
        raise RuntimeError(f"grid_mincut's sweep tiles have a halo of "
                           f"{grid['halo']}, not sweep_halo's "
                           f"{sweep_halo(connectivity)}: its output is wrong")
    return fg, ctrl, grid


#: Launches of the min-cut kernel since the count was last set to 0.
grid_mincut_cuda.kernel_launches = 0


def barrier_loop_cuda(connectivity: int, H: int, W: int, n: int,
                      device) -> None:
    """`n` empty grid-wide barriers on the grid `grid_mincut_cuda` launches
    for an H x W image: the barrier floor of a solve, for timing."""
    _, barriers = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = barriers(connectivity // 2, H, W, n, stream)
    if err != 0:
        raise RuntimeError(f"grid_barrier_loop launch failed: CUDA error "
                           f"{err}")


def grid_mincut_batch(excess: torch.Tensor, r_fwd: tuple, r_bwd: tuple,
                      connectivity: int = 8, max_outer: int = 400,
                      sweeps_per_round: int = 48,
                      relabel_iters: int | None = None, unroll: int = 4):
    """`grid_mincut_stateful` on B same-size lattices in lock step:
    `excess` and every residual plane (B, H, W).  Returns (fg, e', r_fwd',
    r_bwd') with the same leading B, each image bit for bit its solve
    alone (the solver's docstring); the caller's tensors stay unchanged.
    CUDA tensors go through the kernel (one launch, no host sync), CPU
    tensors through `grid_mincut_plain`."""
    with trace_span("layer.mincut"):
        if excess.device.type == "cpu":
            return grid_mincut_plain(excess, r_fwd, r_bwd, connectivity,
                                     max_outer, sweeps_per_round,
                                     relabel_iters, unroll)
        e, rf, rb = working_copies(excess, r_fwd, r_bwd)
        n_sweeps = _n_sweeps(sweeps_per_round, unroll)
        fg, ctrl, grid = grid_mincut_cuda(e, rf, rb, connectivity, max_outer,
                                          n_sweeps, relabel_iters, unroll)
        if counts.active:
            # The tallies go to pinned host memory behind the solve: no
            # sync, and `counts` keeps no device memory.
            host = torch.empty(ctrl.shape, dtype=ctrl.dtype,
                               pin_memory=True)
            host.copy_(ctrl, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(ctrl.device))
            counts._record_kernel(host, done, n_sweeps, grid)
        return fg, e, rf, rb


def working_copies(excess: torch.Tensor, r_fwd: tuple, r_bwd: tuple):
    """Contiguous float32 copies of a solve's planes, for the kernel to
    update in place: (e, r_fwd, r_bwd)."""
    def copy(t):
        return t.float().clone(memory_format=torch.contiguous_format)
    return (copy(excess), tuple(copy(r) for r in r_fwd),
            tuple(copy(r) for r in r_bwd))


def grid_mincut(excess: torch.Tensor, caps: tuple, connectivity: int = 8,
                max_outer: int = 400, sweeps_per_round: int = 48,
                relabel_iters: int | None = None, unroll: int = 4
                ) -> torch.Tensor:
    """s-t min-cut on an (H, W) lattice.  `excess` (H, W) = cap_src -
    cap_snk; `caps` one (H, W) undirected capacity per direction of
    OFFSETS_4 / OFFSETS_8.  Returns (H, W) bool, True on the source
    (foreground) side."""
    offsets = OFFSETS_8 if connectivity == 8 else OFFSETS_4
    if len(caps) != len(offsets):
        raise ValueError(f"{len(caps)} capacity planes for "
                         f"{connectivity}-connectivity")
    r_fwd, r_bwd = _fresh_residuals(caps, offsets)
    return grid_mincut_stateful(excess, r_fwd, r_bwd, connectivity,
                                max_outer, sweeps_per_round, relabel_iters,
                                unroll)[0]


def _coarsen_problem(excess: torch.Tensor, caps: tuple, connectivity: int):
    """Contract 2x2 pixel blocks into one node (an exact graph
    contraction; odd shapes are padded with zeros).  Block excesses sum;
    each coarse neighbour arc is the sum of the fine arcs crossing the
    block boundary, assigned by parity so that each fine arc lands in
    exactly one coarse arc (intra-block arcs vanish).  The coarse min-cut
    is the fine problem's best block-aligned cut."""
    H, W = excess.shape
    Hp, Wp = H + (H & 1), W + (W & 1)

    def pad(a):
        return F.pad(a, (0, Wp - W, 0, Hp - H))

    offsets = OFFSETS_8 if connectivity == 8 else OFFSETS_4
    e = pad(excess.float())
    c = [pad(_zero_border(x.float(), dy, dx))
         for x, (dy, dx) in zip(caps, offsets)]
    e_c = e.reshape(Hp // 2, 2, Wp // 2, 2).sum(dim=(1, 3))

    def s(a, oy, ox):
        return a[oy::2, ox::2]

    # Offsets W, N, NW, NE: W arcs cross at even x, N arcs at even y.
    c_w = s(c[0], 0, 0) + s(c[0], 1, 0)
    c_n = s(c[1], 0, 0) + s(c[1], 0, 1)
    if connectivity == 4:
        return e_c, (c_w, c_n)
    # NW at (odd y, even x) crosses westwards, at (even y, odd x)
    # northwards, at (even, even) diagonally; (odd, odd) is intra-block.
    c_w = c_w + s(c[2], 1, 0)
    c_n = c_n + s(c[2], 0, 1) + s(c[3], 0, 0)
    # NE at (odd y, odd x) joins block (Y, X) to (Y, X + 1): shifted one
    # column right, it lands on the receiving block's W arc.
    ne_shift = F.pad(c[3], (1, 0))[:, :-1]
    c_w = c_w + s(ne_shift, 1, 0)
    return e_c, (c_w, c_n, s(c[2], 0, 0), s(c[3], 0, 1))


def _boundary_band(fg: torch.Tensor, radius: int) -> torch.Tensor:
    """True within `radius` (Chebyshev) of a label boundary: a max and a
    min over (2 radius + 1)^2 windows, "SAME"-padded with -inf / +inf."""
    f = fg.float()[None, None]
    k = 2 * radius + 1
    mx = F.max_pool2d(f, k, stride=1, padding=radius)
    mn = -F.max_pool2d(-f, k, stride=1, padding=radius)
    return (mx > mn)[0, 0]


def _fold_clamps(excess, caps, band, fg_up, offsets):
    """Restrict the problem to the band: clamped (out-of-band) pixels are
    contracted into the terminals.  An arc from a band pixel to a clamped
    foreground neighbour becomes source capacity (+cap on the excess), to
    a clamped background one sink capacity (-cap).  Arcs not incident to
    the band are zeroed, so every push and relabel stays inside it."""
    e = torch.where(band, excess, 0.0)
    bandp, fgp = _pad(band, False), _pad(fg_up, False)
    folded = []
    for (dy, dx), c in zip(offsets, caps):
        c = _zero_border(c.float(), dy, dx)
        band_q, fg_q = _view(bandp, dy, dx), _view(fgp, dy, dx)
        # p in the band, q clamped: a terminal arc at p.
        e = e + torch.where(band & ~band_q, torch.where(fg_q, c, -c), 0.0)
        # p clamped, q in the band: a terminal arc at q.
        contrib = torch.where(~band & band_q, torch.where(fg_up, c, -c), 0.0)
        e = e + _view(_pad(contrib, 0.0), -dy, -dx)
        folded.append(torch.where(band & band_q, c, 0.0))
    return e, tuple(folded)


def grid_mincut_multilevel(excess: torch.Tensor, caps: tuple,
                           connectivity: int = 8, levels: int = 1,
                           band_radius: int = 8, max_outer: int = 400,
                           sweeps_per_round: int = 48, unroll: int = 4
                           ) -> torch.Tensor:
    """Coarse-to-fine banded min-cut (Lombaert et al. 2005).  Contracts
    2x2 blocks `levels` times, solves the coarsest problem exactly, then at
    each finer level re-solves only a band of `band_radius` pixels around
    the upsampled cut, everything outside it folded into the terminals
    (`_fold_clamps`).  A banded solve converges in steps of the band's
    width, not the image's diameter.

    Approximate: the result is the best cut within `band_radius` of the
    coarse one, so finer deviations further out are lost.  `levels=0` is
    `grid_mincut`; use it where the exact cut is needed."""
    if levels <= 0:
        return grid_mincut(excess, caps, connectivity=connectivity,
                           max_outer=max_outer,
                           sweeps_per_round=sweeps_per_round, unroll=unroll)
    H, W = excess.shape
    offsets = OFFSETS_8 if connectivity == 8 else OFFSETS_4
    e_c, caps_c = _coarsen_problem(excess, caps, connectivity)
    fg_c = grid_mincut_multilevel(
        e_c, caps_c, connectivity=connectivity, levels=levels - 1,
        band_radius=band_radius, max_outer=max_outer,
        sweeps_per_round=sweeps_per_round, unroll=unroll)
    fg_up = fg_c.repeat_interleave(2, 0).repeat_interleave(2, 1)[:H, :W]
    band = _boundary_band(fg_up, band_radius)
    e_b, caps_b = _fold_clamps(excess.float(), caps, band, fg_up, offsets)
    fg_b = grid_mincut(e_b, caps_b, connectivity=connectivity,
                       max_outer=max_outer,
                       sweeps_per_round=sweeps_per_round, unroll=unroll)
    return torch.where(band, fg_b, fg_up)


def grid_mincut_stateful(excess: torch.Tensor, r_fwd: tuple, r_bwd: tuple,
                         connectivity: int = 8, max_outer: int = 400,
                         sweeps_per_round: int = 48,
                         relabel_iters: int | None = None, unroll: int = 4):
    """Warm start from carried residuals (flow recycling): `excess` is the
    carried excess plus the terminal-capacity delta.  Returns (fg, e',
    r_fwd', r_bwd'), each (H, W): `grid_mincut_batch` with B = 1."""
    fg, e, r_fwd, r_bwd = grid_mincut_batch(
        excess[None], tuple(r[None] for r in r_fwd),
        tuple(r[None] for r in r_bwd), connectivity, max_outer,
        sweeps_per_round, relabel_iters, unroll)
    return fg[0], e[0], tuple(r[0] for r in r_fwd), tuple(r[0] for r in r_bwd)
