"""The min-cut kernel's tile schedule (csrc/grid_mincut.cu), emulated on the
CPU with the plain version's own steps: one push sweep and one block of
relax steps run tile by tile (8 x 8 tiles here), each tile on a window of
the lattice a halo wider whose pixels out of the image hold the plain
version's padding, and each tile's interior pasted back.  The result must
be the whole lattice's step bit for bit with the kernel's halos
(`ops.maxflow.sweep_halo` for a sweep, the step count for a relax block)
and must differ with one pixel less.  Also the per-image stop: a lock-step
relabel in which each image stops relaxing where its own relabel stops
gives the lock step's heights; and the quiet window, which the kernel
sweeps by adding +0 alone.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gcn_grabcut_torch.ops import maxflow as mf
from test_torch_cuda import mincut_lattices

torch.set_num_threads(1)

TILE = 8
# Neither a multiple of the tile, and a lattice thinner than the halo.
SHAPES = {"37x43": (37, 43), "2x43": (2, 43)}


def lattice_state(conn: int, shape: tuple, sweeps: int):
    """mincut_lattices' three images (excess, residuals) after the plain
    version's first relabel and `sweeps` push sweeps: (e, r_fwd, rbp, hp,
    offsets, inf), residuals r_bwd and heights padded by one pixel."""
    h, w = shape
    ex, caps = mincut_lattices(h=h, w=w)
    offsets = mf.OFFSETS_8 if conn == 8 else mf.OFFSETS_4
    inf = h * w + 1
    e = torch.from_numpy(ex)
    r_fwd = [mf._zero_border(torch.from_numpy(c), dy, dx)
             for c, (dy, dx) in zip(caps, offsets)]
    rbp = [mf._pad(r, 0.0) for r in r_fwd]
    hp, _ = mf.global_relabel(e, r_fwd, rbp, offsets, 4 * (h + w), 4, inf)
    fp = torch.zeros(rbp[0].shape)
    for _ in range(sweeps):
        mf.push_sweep(e, hp, r_fwd, rbp, fp, offsets, inf)
    return e, r_fwd, rbp, hp, offsets, inf


def windows(a: torch.Tensor, halo: int, fill):
    """`a` (B, H, W) padded by `halo` of `fill` on every side and by a tile
    more below and to the right, and the (y0, x0, rows, cols) of every
    tile: a tile's window is [y0, y0 + TILE + 2 halo) of it, whole even at
    the image's far edges (as the kernel's)."""
    _, H, W = a.shape
    padded = F.pad(a, (halo, halo + TILE, halo, halo + TILE), value=fill)
    tiles = [(y0, x0, min(TILE, H - y0), min(TILE, W - x0))
             for y0 in range(0, H, TILE) for x0 in range(0, W, TILE)]
    return padded, tiles


def tiled_sweep(e, r_fwd, rbp, hp, offsets, inf, halo):
    """One push sweep tile by tile: (e, r_fwd, r_bwd, heights), unpadded."""
    n = TILE + 2 * halo
    pe, tiles = windows(e, halo, 0.0)
    prf = [windows(r, halo, 0.0)[0] for r in r_fwd]
    prb = [windows(mf._view(r, 0, 0), halo, 0.0)[0] for r in rbp]
    ph = windows(mf._view(hp, 0, 0), halo + 1, inf)[0]
    out = [e.clone(), *[r.clone() for r in r_fwd],
           *[mf._view(r, 0, 0).clone() for r in rbp],
           mf._view(hp, 0, 0).clone()]
    for y0, x0, th, tw in tiles:
        win = (slice(None), slice(y0, y0 + n), slice(x0, x0 + n))
        we = pe[win].clone()
        wrf = [r[win].clone() for r in prf]
        wrbp = [mf._pad(r[win], 0.0) for r in prb]
        whp = ph[:, y0:y0 + n + 2, x0:x0 + n + 2].clone()
        mf.push_sweep(we, whp, wrf, wrbp, torch.zeros(wrbp[0].shape),
                      offsets, inf)
        inner = (slice(None), slice(halo, halo + th), slice(halo, halo + tw))
        got = [we, *wrf, *[mf._view(r, 0, 0) for r in wrbp],
               mf._view(whp, 0, 0)]
        for full, part in zip(out, got):
            full[:, y0:y0 + th, x0:x0 + tw] = part[inner]
    return out


def whole_sweep(e, r_fwd, rbp, hp, offsets, inf):
    e, r_fwd = e.clone(), [r.clone() for r in r_fwd]
    rbp, hp = [r.clone() for r in rbp], hp.clone()
    mf.push_sweep(e, hp, r_fwd, rbp, torch.zeros(rbp[0].shape), offsets, inf)
    return [e, *r_fwd, *[mf._view(r, 0, 0) for r in rbp], mf._view(hp, 0, 0)]


def same_bits(a: list, b: list) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def relax_start(conn: int, shape: tuple, steps: int):
    """Heights `steps` relax steps into the first relabel of lattice_state's
    images (padded), and the relabel's arcs."""
    e, r_fwd, rbp, _, offsets, inf = lattice_state(conn, shape, 0)
    arcs = mf.relabel_arcs(r_fwd, rbp, offsets, inf)
    h0 = torch.where(e < 0, 0, inf).to(torch.int32)
    bufs = [mf._pad(h0, inf), torch.full(rbp[0].shape, inf,
                                         dtype=torch.int32)]
    return bufs[mf.relax_steps(bufs, 0, arcs, steps)], arcs, inf


def tiled_relax(hp, arcs, steps, halo, inf):
    """`steps` relax steps tile by tile from padded heights: unpadded."""
    n = TILE + 2 * halo
    ph, tiles = windows(mf._view(hp, 0, 0), halo, inf)
    padds = [(off, windows(add, halo, inf)[0]) for off, add in arcs]
    out = mf._view(hp, 0, 0).clone()
    for y0, x0, th, tw in tiles:
        win = (slice(None), slice(y0, y0 + n), slice(x0, x0 + n))
        bufs = [mf._pad(ph[win], inf), None]
        bufs[1] = torch.full(bufs[0].shape, inf, dtype=torch.int32)
        wa = [(off, add[win]) for off, add in padds]
        res = mf._view(bufs[mf.relax_steps(bufs, 0, wa, steps)], 0, 0)
        out[:, y0:y0 + th, x0:x0 + tw] = res[:, halo:halo + th,
                                             halo:halo + tw]
    return out


def whole_relax(hp, arcs, steps, inf):
    bufs = [hp.clone(), torch.full(hp.shape, inf, dtype=torch.int32)]
    return mf._view(bufs[mf.relax_steps(bufs, 0, arcs, steps)], 0, 0)


def test_sweep_halo_is_the_kernels():
    """The halo the wrapper passes: the directions moving along an axis."""
    assert mf.sweep_halo(8) == 3 and mf.sweep_halo(4) == 1


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("conn", [8, 4])
def test_tiled_sweep_is_the_whole_sweep(conn, shape):
    """One push sweep tile by tile with sweep_halo's halo (heights one
    pixel further): e, every residual plane and the lifted heights bit
    for bit the whole lattice's, on a first sweep and a later one."""
    for sweeps in (0, 5):
        state = lattice_state(conn, shape, sweeps)
        got = tiled_sweep(*state, mf.sweep_halo(conn))
        assert same_bits(got, whole_sweep(*state))


@pytest.mark.parametrize("conn", [8, 4])
def test_tiled_sweep_one_pixel_short_differs(conn):
    """With one pixel of halo less, some tile's interior differs: the halo
    is no larger than it must be."""
    state = lattice_state(conn, SHAPES["37x43"], 5)
    got = tiled_sweep(*state, mf.sweep_halo(conn) - 1)
    assert not same_bits(got, whole_sweep(*state))


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("unroll", [2, 4])
def test_tiled_relax_block_is_the_whole_block(unroll, conn, shape):
    """A block of `unroll` relax steps tile by tile with a halo of
    `unroll`: the heights bit for bit the whole lattice's; with one pixel
    less they differ.  The block ends at step TILE, as the front from the
    third image's sink strip (its last 4 columns) crosses a tile's edge."""
    hp, arcs, inf = relax_start(conn, shape, TILE - unroll)
    want = whole_relax(hp, arcs, unroll, inf)
    assert torch.equal(tiled_relax(hp, arcs, unroll, unroll, inf), want)
    if shape == SHAPES["37x43"]:
        assert not torch.equal(tiled_relax(hp, arcs, unroll, unroll - 1,
                                           inf), want)


@pytest.mark.parametrize("conn", [8, 4])
def test_per_image_stop_gives_the_lock_steps_heights(conn):
    """A lock-step relabel in which each image stops relaxing after the
    first block that changed none of its heights (the kernel's per-image
    stop): the lock step's heights and block count, each image relaxed for
    as many steps as its relabel alone takes, fewer image-steps in all."""
    unroll, iters = 2, 200
    e, r_fwd, rbp, _, offsets, inf = lattice_state(conn, SHAPES["37x43"], 3)
    want, steps = mf.global_relabel(e, r_fwd, rbp, offsets, iters, unroll,
                                    inf)
    alone = [mf.global_relabel(e[b:b + 1], [r[b:b + 1] for r in r_fwd],
                               [r[b:b + 1] for r in rbp], offsets, iters,
                               unroll, inf)[1] for b in range(e.shape[0])]
    arcs = mf.relabel_arcs(r_fwd, rbp, offsets, inf)
    h0 = mf._pad(torch.where(e < 0, 0, inf).to(torch.int32), inf)
    bufs = [[h0[b:b + 1].clone(), torch.full_like(h0[b:b + 1], inf)]
            for b in range(e.shape[0])]
    cur = [0] * e.shape[0]
    relaxing = list(range(e.shape[0]))
    it, image_steps = 0, [0] * e.shape[0]
    while it < iters and relaxing:
        for b in relaxing:
            cur[b] = mf.relax_steps(bufs[b], cur[b], [
                (off, add[b:b + 1]) for off, add in arcs], unroll)
            image_steps[b] += unroll
        it += unroll
        relaxing = [b for b in relaxing if bool(
            (bufs[b][cur[b]] < bufs[b][1 - cur[b]]).any())]
    got = torch.cat([bufs[b][cur[b]] for b in range(e.shape[0])])
    assert torch.equal(got, want)
    assert it == steps
    assert image_steps == alone
    assert sum(image_steps) < steps * e.shape[0]


@pytest.mark.parametrize("conn", [8, 4])
def test_quiet_window_sweep_only_adds_zero(conn):
    """A window with no active pixel (e > 0 and h < INF): the sweep leaves
    every plane as x + 0 (-0 turned +0, all else the same bits) and the
    heights as they were where e >= 0, 0 where e < 0.  The kernel sweeps
    such a tile by that alone, and skips it when its neighbours' windows
    were quiet too."""
    e, r_fwd, rbp, hp, offsets, inf = lattice_state(conn, SHAPES["37x43"], 0)
    r = torch.from_numpy(np.random.RandomState(3).rand(*e.shape))
    # Deficits and zeros of both signs; positive excess only where h = INF.
    e = torch.where(r < 0.3, -0.0, torch.where(r < 0.5, 0.0, -r.float()))
    h = mf._view(hp, 0, 0)
    e = torch.where((r > 0.95) & (h >= inf), 1.0, e)
    r_fwd = [torch.where(x < 0.2, -0.0, x) for x in r_fwd]
    rbp = [torch.where(x < 0.2, -0.0, x) for x in rbp]
    assert not bool(((e > 0) & (h < inf)).any())
    got = whole_sweep(e, r_fwd, rbp, hp, offsets, inf)
    want = [e + 0.0, *[x + 0.0 for x in r_fwd],
            *[mf._view(x, 0, 0) + 0.0 for x in rbp],
            torch.where(e < 0, 0, h).to(torch.int32)]
    assert same_bits(got, want)
    assert any(bool((torch.signbit(x) & (x == 0)).any())
               for x in (e, *r_fwd))
