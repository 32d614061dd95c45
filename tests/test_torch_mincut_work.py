"""The min-cut's bytes bound counts its work on the data, whatever the
kernel's design: chip_smoke.mincut_work watches a run of the plain version
and counts, per push sweep, the live pixels and those whose window (the
sweep's reach, `ops.maxflow.sweep_halo`) can push or lift or that hold a
-0, and per relax block the pixels within its steps of a height the block
before lowered.  Held here against a count made pixel by pixel in numpy,
and the watched run against the plain solve it watches.
"""

import numpy as np
import pytest
import torch

from chip_smoke import mincut_bytes, mincut_work
from gcn_grabcut_torch.ops import maxflow as mf
from test_torch_cuda import mincut_lattices

torch.set_num_threads(1)

# A small lock step of mincut_lattices' three images (one converged from
# the start, one short, one long), a few rounds of short sweeps.
OPTS = dict(max_outer=6, sweeps_per_round=8, unroll=3)


def problem(conn: int, h: int = 14, w: int = 17):
    ex, caps = mincut_lattices(h=h, w=w)
    offsets = mf.OFFSETS_8 if conn == 8 else mf.OFFSETS_4
    r_fwd = tuple(mf._zero_border(torch.from_numpy(c), dy, dx)
                  for c, (dy, dx) in zip(caps, offsets))
    e = torch.from_numpy(ex)
    # A -0 in one plane: the first sweep must write that pixel.
    e[1, 0, 0] = -0.0
    return e, r_fwd, r_fwd


def near(mask: np.ndarray, reach: int, square: bool) -> np.ndarray:
    """Pixels within `reach` of a set pixel of `mask` (B, H, W): in both
    axes (square) or in the sum of the two (the 4-lattice's steps)."""
    B, H, W = mask.shape
    out = np.zeros_like(mask)
    for b, y, x in zip(*np.nonzero(mask)):
        for yy in range(max(0, y - reach), min(H, y + reach + 1)):
            for xx in range(max(0, x - reach), min(W, x + reach + 1)):
                if square or abs(yy - y) + abs(xx - x) <= reach:
                    out[b, yy, xx] = True
    return out


@pytest.mark.parametrize("conn", [8, 4])
def test_work_counts_match_a_pixel_by_pixel_count(conn, monkeypatch):
    """mincut_work's counts equal the same counts made pixel by pixel on
    the states its watched run passes through."""
    want = dict(swept=0, active=0, relaxed=0)
    lowered = [None]
    sweep, relax, relabel = mf.push_sweep, mf.relax_steps, mf.global_relabel

    def counted_sweep(e, hp, rf, rbp, fp, offsets, inf):
        h = mf._view(hp, 0, 0).numpy()
        ev = e.numpy()
        full = near((ev > 0) & (h < inf), mf.sweep_halo(conn), True)
        for x in (e, *rf, *(mf._view(r, 0, 0) for r in rbp)):
            x = x.numpy()
            full |= (x == 0) & np.signbit(x)
        want["swept"] += ev.size
        want["active"] += int(full.sum())
        sweep(e, hp, rf, rbp, fp, offsets, inf)

    def counted_relabel(*args):
        lowered[0] = None
        return relabel(*args)

    def counted_relax(bufs, cur, arcs, steps):
        before = mf._view(bufs[cur], 0, 0).numpy().copy()
        out = relax(bufs, cur, arcs, steps)
        if lowered[0] is None:
            want["relaxed"] += before.size
        else:
            want["relaxed"] += int(near(lowered[0], steps, conn == 8).sum())
        lowered[0] = mf._view(bufs[out], 0, 0).numpy() < before
        return out

    monkeypatch.setattr(mf, "push_sweep", counted_sweep)
    monkeypatch.setattr(mf, "relax_steps", counted_relax)
    monkeypatch.setattr(mf, "global_relabel", counted_relabel)
    got = mincut_work(*problem(conn), conn, OPTS)
    assert got == want
    assert 0 < got["active"] < got["swept"]
    assert mf.push_sweep is counted_sweep
    assert mf.relax_steps is counted_relax


@pytest.mark.parametrize("conn", [8, 4])
def test_watched_run_is_the_plain_solve(conn):
    """The watched run solves as the plain version does (the same rounds
    and relabel steps), leaves the module's steps as they were, and its
    bound charges what its counts say."""
    e, r_fwd, r_bwd = problem(conn)
    steps = (mf.push_sweep, mf.relax_steps, mf.global_relabel)
    mf.counts.reset()
    mf.grid_mincut_plain(e, r_fwd, r_bwd, conn, **OPTS)
    want = (mf.counts.rounds[0].tolist(), mf.counts.relabel_steps)
    mf.counts.reset()
    work = mincut_work(e, r_fwd, r_bwd, conn, OPTS)
    assert (mf.counts.rounds[0].tolist(), mf.counts.relabel_steps) == want
    assert (mf.push_sweep, mf.relax_steps, mf.global_relabel) == steps
    n_sweeps = mf._n_sweeps(OPTS["sweeps_per_round"], OPTS["unroll"])
    rounds = np.asarray(want[0])
    B, H, W = e.shape
    assert work["swept"] == rounds.sum() * n_sweeps * H * W
    d = conn // 2
    tests = np.minimum(rounds + 1, OPTS["max_outer"]).sum()
    fixed = ((2 + rounds).sum() * (9 + 8 * d) + tests * 8 + B * 5) * H * W
    assert mincut_bytes(work, dict(rounds=rounds), (B, H, W), d,
                        OPTS["max_outer"]) == (
        fixed + 8 * work["swept"] + (8 + 16 * d) * work["active"]
        + 9 * work["relaxed"])
