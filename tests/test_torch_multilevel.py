"""Port parity for the coarse-to-fine banded min-cut: the port's
`_coarsen_problem`, `_boundary_band`, `_fold_clamps` and
`grid_mincut_multilevel` against the JAX package's on the JAX tests'
GrabCut-shaped energies (tests/test_grabcut.py `_smooth_instance`, at 96²
and 95×97), JAX's own floors on them, and ``_grabcut_solve(ml_levels=1)``
against JAX's on one 48 px image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu import grabcut as jgc
from gcn_grabcut_tpu.ops import maxflow as jmf
from gcn_grabcut_torch import grabcut as tgc
from gcn_grabcut_torch.ops import maxflow as tmf
import test_grabcut as jtests
from test_torch_grabcut import blob_scene, jax_comp0

torch.set_num_threads(1)

ARRAY_RTOL = 1e-6       # coarse and folded arrays against JAX's
CUT_AGREE = 0.999       # the port's multilevel cut against JAX's
# JAX's own floors against the exact cut (tests/test_grabcut.py).
EXACT_AGREE = {(96, 96): 0.995, (95, 97): 0.99}
COST_RTOL = 0.01
SHAPES = [(96, 96, 0), (95, 97, 1)]


def instance(H, W, seed):
    excess, caps = jtests.TestMultilevelMinCut._smooth_instance(
        H, W, seed)
    return ((jnp.asarray(excess), tuple(map(jnp.asarray, caps))),
            (torch.from_numpy(excess), tuple(map(torch.from_numpy, caps))),
            (excess, caps))


def close(got, want, scale=None):
    """Within ARRAY_RTOL of `scale`: each element's, or for a sum whose
    addends cancel, the sum of its addends' magnitudes (XLA's order of
    a 2x2 block sum depends on the shape, so the roundings differ)."""
    want = np.asarray(want)
    scale = np.abs(want) if scale is None else np.asarray(scale)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= ARRAY_RTOL * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("H, W, seed", SHAPES)
@pytest.mark.parametrize("connectivity", [4, 8])
def test_coarsen_matches_jax(H, W, seed, connectivity):
    (je, jc), (te, tc), (excess, _) = instance(H, W, seed)
    n = connectivity // 2
    j_e, j_caps = jmf._coarsen_problem(je, jc[:n], connectivity)
    t_e, t_caps = tmf._coarsen_problem(te, tc[:n], connectivity)
    # The addends' magnitudes: the same contraction of |excess|.
    a_e, _ = tmf._coarsen_problem(te.abs().double(), tc[:n], connectivity)
    close(t_e, j_e, a_e.numpy())
    assert len(t_caps) == len(j_caps) == n
    for t, j in zip(t_caps, j_caps):
        assert t.shape == j.shape == ((H + 1) // 2, (W + 1) // 2)
        close(t, j)
    # The contraction is exact: the block excesses keep the total.
    assert abs(float(t_e.double().sum()) - float(excess.astype(
        np.float64).sum())) <= 1e-4 * np.abs(excess).sum()


@pytest.mark.parametrize("radius", [1, 3, 8])
def test_boundary_band_and_fold_match_jax(radius):
    (je, jc), (te, tc), _ = instance(95, 97, 2)
    r = np.random.RandomState(radius)
    fg = np.zeros((95, 97), bool)
    fg[20:70, 15:60] = True
    fg[r.rand(95, 97) < 0.01] ^= True
    jband = jmf._boundary_band(jnp.asarray(fg), radius)
    tband = tmf._boundary_band(torch.from_numpy(fg), radius)
    np.testing.assert_array_equal(tband.numpy(), np.asarray(jband))
    j_e, j_caps = jmf._fold_clamps(je, jc, jband, jnp.asarray(fg),
                                   jmf.OFFSETS_8)
    t_e, t_caps = tmf._fold_clamps(te, tc, tband, torch.from_numpy(fg),
                                   tmf.OFFSETS_8)
    close(t_e, j_e)
    for t, j in zip(t_caps, j_caps):
        close(t, j)


@pytest.mark.parametrize("H, W, seed", SHAPES)
@pytest.mark.parametrize("levels", [1, 2])
def test_multilevel_cut_matches_jax_and_its_floors(H, W, seed, levels):
    (je, jc), (te, tc), (excess, caps) = instance(H, W, seed)
    jfg = np.asarray(jmf.grid_mincut_multilevel(je, jc, connectivity=8,
                                                levels=levels))
    tfg = tmf.grid_mincut_multilevel(te, tc, connectivity=8,
                                     levels=levels).numpy()
    exact = tmf.grid_mincut(te, tc, connectivity=8).numpy()
    differ = int((tfg != jfg).sum())
    print(f"{H}x{W} levels {levels}: {differ} pixels differ from JAX's "
          f"multilevel cut; agreement with the exact cut "
          f"{(tfg == exact).mean():.6f}")
    assert tfg.shape == (H, W)
    assert (tfg == jfg).mean() >= CUT_AGREE
    assert (tfg == exact).mean() > EXACT_AGREE[(H, W)]
    c_exact = jtests._cut_cost_vec(excess, caps, exact.astype(int))
    c_ml = jtests._cut_cost_vec(excess, caps, tfg.astype(int))
    assert c_ml <= c_exact * (1 + COST_RTOL) + 1e-6


def test_levels_zero_is_grid_mincut():
    _, (te, tc), _ = instance(95, 97, 1)
    np.testing.assert_array_equal(
        tmf.grid_mincut_multilevel(te, tc, levels=0).numpy(),
        tmf.grid_mincut(te, tc).numpy())


def test_uniform_sides_are_trivial():
    caps = tuple(torch.ones(16, 16) for _ in tmf.OFFSETS_4)
    for v, want in ((5.0, True), (-5.0, False)):
        fg = tmf.grid_mincut_multilevel(torch.full((16, 16), v), caps,
                                        connectivity=4, levels=2)
        assert bool((fg == want).all())


def test_grabcut_solve_multilevel_matches_jax():
    """``_grabcut_solve(ml_levels=1)``: each iteration's banded cut, no
    carried flow, from JAX's initial components."""
    img, tri = blob_scene(seed=2, H=48, W=48)
    comp0 = jax_comp0(img, tri)
    jm, _ = jgc._grabcut_solve(jnp.asarray(img), jnp.asarray(tri),
                               jnp.asarray(comp0), 50.0, 5, 5, ml_levels=1)
    tm, _ = tgc._grabcut_solve(torch.from_numpy(img), torch.from_numpy(tri),
                               torch.from_numpy(comp0).long(), 50.0, 5, 5,
                               ml_levels=1)
    tm0, _ = tgc._grabcut_solve(torch.from_numpy(img),
                                torch.from_numpy(tri),
                                torch.from_numpy(comp0).long(), 50.0, 5, 5)
    agree = float((tm.numpy() == np.asarray(jm)).mean())
    print(f"ml_levels=1 GrabCut mask agreement with JAX: {agree:.6f}; with "
          f"the exact solve: {(tm == tm0).float().mean():.6f}")
    assert agree >= CUT_AGREE
