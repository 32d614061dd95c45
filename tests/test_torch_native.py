"""Port parity: the port's native host min-cut (gcn_grabcut_torch/native)
against the JAX package's, and GrabCut's "native" backend against JAX's
`_grabcut_solve_native`, on one 48x56 shape.

The solver is the same C++ source, so its cuts must be equal; the GrabCut
iterations around it fit their GMMs in another framework, so they are
held to the cut energy and to mask agreement.  A failed build raises: the
native backend never falls back to the device solver.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu import grabcut as jgc
from gcn_grabcut_tpu.native import grid_mincut_native as jax_native
from gcn_grabcut_tpu.ops import gmm as jgmm
from gcn_grabcut_torch import grabcut as tgc
from gcn_grabcut_torch import native
from gcn_grabcut_torch.ops.maxflow import OFFSETS_8
from test_torch_grabcut import blob_scene, cut_energy, jax_comp0

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler")

H, W = 48, 56


def lattice(seed, n_dirs):
    r = np.random.RandomState(seed)
    excess = (r.randn(H, W) * 3).astype(np.float32)
    caps = tuple((r.rand(H, W) * 2).astype(np.float32)
                 for _ in range(n_dirs))
    return excess, caps


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_mincut_native_equals_jax(seed, connectivity):
    excess, caps = lattice(seed, 4 if connectivity == 8 else 2)
    got = native.grid_mincut_native(excess, caps, connectivity)
    want = jax_native(excess, caps, connectivity)
    assert got.dtype == bool and got.shape == (H, W)
    np.testing.assert_array_equal(got, want)


def test_grid_mincut_native_matches_the_device_solver_energy():
    from gcn_grabcut_torch.ops.maxflow import grid_mincut
    excess, caps = lattice(3, 4)
    host = native.grid_mincut_native(excess, caps)
    dev = grid_mincut(torch.from_numpy(excess),
                      tuple(map(torch.from_numpy, caps))).numpy()
    e_host = cut_energy(excess, caps, OFFSETS_8, host)
    e_dev = cut_energy(excess, caps, OFFSETS_8, dev)
    assert abs(e_host - e_dev) <= 1e-4 * max(1.0, abs(e_dev))


def jax_first_excess(img, tri, comp0, gamma=50.0):
    """The terminal excess of a solve's first iteration, from the JAX
    package's GMM functions, and its pairwise capacities."""
    pix = jnp.asarray(img)
    caps, _ = jgc._pairwise_caps(pix, gamma)
    lam = 9.0 * gamma
    fg = jnp.asarray((tri == 1) | (tri == 3), jnp.float32)
    comp = jnp.asarray(comp0)
    fg_gmm = jgmm.fit_gmm(pix, fg, comp, 5)
    bg_gmm = jgmm.fit_gmm(pix, 1.0 - fg, comp, 5)
    comp = jnp.where(fg > 0, jgmm.assign_components(pix, fg_gmm),
                     jgmm.assign_components(pix, bg_gmm))
    fg_gmm = jgmm.fit_gmm(pix, fg, comp, 5)
    bg_gmm = jgmm.fit_gmm(pix, 1.0 - fg, comp, 5)
    excess = np.clip(np.asarray(jgmm.gmm_log_prob(pix, fg_gmm))
                     - np.asarray(jgmm.gmm_log_prob(pix, bg_gmm)), -lam, lam)
    excess[tri == 1] = lam
    excess[tri == 0] = -lam
    return excess, tuple(np.asarray(c) for c in caps)


@pytest.mark.parametrize("seed", [0, 1])
def test_grabcut_solve_native_cut_energy_matches_jax(seed):
    """One iteration from JAX's components: both cuts minimise the same
    energy, evaluated on JAX's terminal excess."""
    img, tri = blob_scene(H, W, seed)
    comp0 = jax_comp0(img, tri)
    jm, _ = jgc._grabcut_solve_native(img, tri, comp0, 50.0, 1, 5)
    tm, _ = tgc._grabcut_solve_native(torch.from_numpy(img), tri,
                                      torch.from_numpy(comp0).long(), 50.0,
                                      1, 5)
    excess, caps = jax_first_excess(img, tri, comp0)
    je = cut_energy(excess, caps, OFFSETS_8, np.isin(jm, (1, 3)))
    te = cut_energy(excess, caps, OFFSETS_8, np.isin(tm, (1, 3)))
    assert abs(te - je) <= 1e-4 * max(1.0, abs(je))
    assert float((tm == jm).mean()) >= 0.999


@pytest.mark.parametrize("seed", [0, 1])
def test_grabcut_solve_native_masks_match_jax(seed):
    img, tri = blob_scene(H, W, seed)
    comp0 = jax_comp0(img, tri)
    jm, jcomp = jgc._grabcut_solve_native(img, tri, comp0, 50.0, 5, 5)
    tm, tcomp = tgc._grabcut_solve_native(torch.from_numpy(img), tri,
                                          torch.from_numpy(comp0).long(),
                                          50.0, 5, 5)
    assert tm.dtype == np.uint8 and tm.shape == (H, W)
    assert float((tm == jm).mean()) >= 0.999
    assert float((tcomp.numpy() == np.asarray(jcomp)).mean()) >= 0.999
    # Definite labels never change.
    assert (tm[tri == 0] == 0).all() and (tm[tri == 1] == 1).all()


def test_auto_backend_on_the_cpu_is_native():
    img, tri = blob_scene(H, W, 0)
    auto = tgc.GrabCut(img.astype(np.uint8), device="cpu")
    explicit = tgc.GrabCut(img.astype(np.uint8),
                           tgc.GrabCutConfig(backend="native"), device="cpu")
    assert auto._backend == "native"
    np.testing.assert_array_equal(auto.run_with_trimap(tri),
                                  explicit.run_with_trimap(tri))


def test_native_library_is_built_once_under_its_source_hash():
    lib = native.load()
    assert native.load() is lib
    path = native._lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.native_available()


def test_failed_build_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", {})
    img, tri = blob_scene(H, W, 0)
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="cannot build"):
        tgc.GrabCut(img.astype(np.uint8),
                    tgc.GrabCutConfig(backend="native"), device="cpu")
    with pytest.raises(RuntimeError, match="cannot build"):
        tgc.GrabCut(img.astype(np.uint8), device="cpu")    # "auto"
    with pytest.raises(RuntimeError, match="cannot build"):
        native.grid_mincut_native(*lattice(0, 4))
    # The device backend does not need the library.
    gc = tgc.GrabCut(img.astype(np.uint8),
                     tgc.GrabCutConfig(backend="device"), device="cpu")
    assert gc.run_with_trimap(tri).shape == (H, W)


def test_compiler_errors_are_reported(monkeypatch, tmp_path):
    bad = tmp_path / "maxflow.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="failed on maxflow.cpp"):
        native.load()
    assert not list((tmp_path / "_build").glob("*"))
