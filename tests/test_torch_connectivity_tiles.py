"""The decompositions of the connectivity kernel (csrc/slic_connectivity.cu)
and the mask components kernel (csrc/mask_components.cu), emulated on the
CPU by their models in ops/slic.py and ops/connected.py with the plain
versions' own steps, held bit for bit against the plain versions and, where
the JAX package has the function, against JAX.  One shape, 64 x 64, with
tiles of 16 (the kernel's are 32; the models take any).

Kernel A: a super-block of S Jacobi steps run tile by tile on windows with
an S-pixel halo is the whole lattice's S steps, and one pixel less of halo
is not; tiles skipped by the skip lemma leave the components exact; the
plain version's block count recovered from the last step that changed,
with super-blocks of 8 and 16 steps and caps inside one; the fused orphan
pass of 8 half-steps; the absorption in any order within a phase (over a
shuffled list of the minor pixels) and in passes of rounds on tiles
skipped exactly.  Kernel B: the separable stencil, the in-place row
run-min and the column run-min over segments with carries, on the
serpentine, 4- and 8-connected.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import serpentine_mask, spiral_labels
from gcn_grabcut_tpu.ops import connected as jcc
from gcn_grabcut_tpu.ops import slic as jslic
from gcn_grabcut_torch.ops import connected as tcc
from gcn_grabcut_torch.ops import slic as tslic
from test_torch_slic_connectivity import fragmented_labels

torch.set_num_threads(1)

HW, TILE, K = 64, 16, 100


@pytest.fixture(scope="module")
def fragmented():
    """Two SLIC-like label maps with orphans and labels in pieces."""
    return torch.from_numpy(np.stack([fragmented_labels(s)[:HW, :HW]
                                      for s in (0, 1)]))


@pytest.fixture(scope="module")
def mixed(fragmented):
    """A spiral, whose components need hundreds of Jacobi steps, beside a
    repaired SLIC-like map whose components settle in a few dozen: tiles
    of the second go quiet while the first still changes."""
    return torch.cat([torch.from_numpy(spiral_labels(HW))[None],
                      tslic.absorb_orphans_plain(fragmented[:1], 4)])


def jacobi(labels: torch.Tensor, steps: int) -> torch.Tensor:
    """The whole lattice's components after `steps` Jacobi steps."""
    B, H, W = labels.shape
    same = tslic.same_label(labels)
    comp = torch.arange(H * W).reshape(1, H, W).expand(B, H, W)
    for _ in range(steps):
        comp = tslic.component_step(comp, same, H * W)
    return comp


def plain_components(labels: torch.Tensor, max_sweeps: int) -> torch.Tensor:
    """The plain version's components: blocks of 4 steps until a block
    changes nothing or max_sweeps blocks are done (each image stops on
    its own at its fixpoint, so the batch's loop gives its components)."""
    B, H, W = labels.shape
    same = tslic.same_label(labels)
    comp = torch.arange(H * W).reshape(1, H, W).expand(B, H, W)
    for _ in range(max_sweeps):
        new = comp
        for _ in range(4):
            new = tslic.component_step(new, same, H * W)
        changed = bool((new < comp).any())
        comp = new
        if not changed:
            break
    return comp


def jax_repair(labels: np.ndarray, k: int, absorb: int, sweeps: int):
    lab = jnp.asarray(labels.astype(np.int32))
    if absorb:
        lab = jslic._absorb_orphans(lab, n_sweeps=absorb)
    return np.asarray(jslic.enforce_connectivity(lab, k, max_sweeps=sweeps))


@pytest.mark.parametrize("steps", [8, 16])
def test_super_block_needs_its_halo(mixed, steps):
    """S steps tile by tile with an S-pixel halo are the lattice's S steps
    from any state; with one pixel less they are not."""
    same = tslic.same_label(mixed)
    start = jacobi(mixed, 5)
    want = start
    for _ in range(steps):
        want = tslic.component_step(want, same, HW * HW)
    assert torch.equal(tslic.super_block_tiled(start, same, steps, HW * HW,
                                               TILE), want)
    assert not torch.equal(tslic.super_block_tiled(
        start, same, steps, HW * HW, TILE, halo=steps - 1), want)


@pytest.mark.parametrize("steps", [8, 16])
def test_skipped_tiles_keep_the_components_exact(mixed, steps):
    """Tiles skipped by the skip lemma change nothing: the components are
    the plain version's, and the lemma skips the quiet map's tiles while
    the spiral's still change."""
    comp, _, run, skipped = tslic.components_tiled(mixed, 12, steps, TILE)
    assert torch.equal(comp, plain_components(mixed, 12))
    assert skipped > 0 and run > 0


JAX_AT_CAP: list = []


@pytest.mark.parametrize("steps", [8, 16])
@pytest.mark.parametrize("max_sweeps", [1, 2, 3, 5])
def test_recovered_block_count(mixed, steps, max_sweeps):
    """The plain version's blocks, recovered from the last step that
    changed, with the cap inside a super-block (1, 2, 3 and 5 blocks of 4
    steps); the components at the cap and the repair's labels are the plain
    version's, and at a cap of 3 the spiral's are JAX's."""
    comp, blocks, _, _ = tslic.components_tiled(mixed, max_sweeps, steps,
                                                TILE)
    assert torch.equal(comp, plain_components(mixed, max_sweeps))
    want = tslic.enforce_connectivity_plain(mixed, K, max_sweeps)
    loops = tslic.enforce_connectivity_plain.last_loops
    assert max(blocks) == loops["blocks"] == max_sweeps
    got, _, rounds = tslic.repair_tiled(mixed, K, 0, max_sweeps, steps, TILE)
    assert torch.equal(got, want) and rounds == loops["rounds"]
    if max_sweeps == 3:
        if not JAX_AT_CAP:
            JAX_AT_CAP.append(jax_repair(mixed[0].numpy(), K, 0, 3))
        np.testing.assert_array_equal(got[0].numpy(), JAX_AT_CAP[0])


def test_fused_orphan_pass(fragmented):
    """The 4 orphan sweeps (8 half-steps) in one tile pass with an 8-pixel
    halo are the plain version's and JAX's; a single sweep needs its halo
    of 2."""
    got = tslic.orphan_tiles(fragmented, 4, TILE)
    assert torch.equal(got, tslic.absorb_orphans_plain(fragmented, 4))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(
        jslic._absorb_orphans(jnp.asarray(fragmented[0].numpy().astype(
            np.int32)), n_sweeps=4)))
    assert not torch.equal(tslic.orphan_tiles(fragmented, 1, TILE, halo=1),
                           tslic.absorb_orphans_plain(fragmented, 1))


def test_absorption_over_a_shuffled_minor_list(fragmented):
    """Each phase over the minor pixels only, in three shuffled orders,
    one at a time in place: the plain version's labels and rounds."""
    labels = tslic.absorb_orphans_plain(fragmented, 4)
    comp = plain_components(labels, 64)
    minor = tslic.minor_pixels(labels, comp, K)
    assert 0 < int(minor.sum()) < minor.numel() // 4   # a minority
    want = tslic.enforce_connectivity_plain(labels, K)
    for seed in range(3):
        order = torch.randperm(labels.numel(),
                               generator=torch.Generator().manual_seed(seed))
        got, rounds = tslic.absorb_listed(labels, minor, order, 64)
        assert torch.equal(got, want)
        assert rounds == tslic.enforce_connectivity_plain.last_loops["rounds"]


@pytest.mark.parametrize("rounds", [1, 2])
def test_tiled_absorption(mixed, rounds):
    """The kernel's absorption, passes of 1 or 2 rounds on windows 4 or 8
    pixels wider, with tiles skipped where nothing beside them moved: the
    plain version's labels and rounds, and tiles skipped."""
    comp = plain_components(mixed, 64)
    minor = tslic.minor_pixels(mixed, comp, K)
    want = tslic.enforce_connectivity_plain(mixed, K)
    got, ran, run, skipped = tslic.absorb_tiled(mixed, minor, 64, rounds,
                                                TILE)
    assert torch.equal(got, want)
    assert ran == tslic.enforce_connectivity_plain.last_loops["rounds"]
    assert run > 0 and skipped > 0


def test_whole_repair_model(fragmented):
    """The kernel's whole decomposition, orphans to absorption: the plain
    version's labels and loop counts (the plain version's are JAX's:
    tests/test_torch_slic_connectivity.py)."""
    got, blocks, rounds = tslic.repair_tiled(fragmented, K, 4, 64, 16, TILE)
    want = tslic.enforce_connectivity_plain(
        tslic.absorb_orphans_plain(fragmented, 4), K)
    assert torch.equal(got, want)
    assert {"blocks": blocks, "rounds": rounds} == \
        tslic.enforce_connectivity_plain.last_loops


@pytest.mark.parametrize("connectivity", [4, 8])
def test_column_scan_over_segments(connectivity):
    """Kernel B's passes on the serpentine, 4- and 8-connected: the
    separable stencil, the in-place row run-min and the column run-min over
    segments with carries (of 8 rows, the kernel's, and of 5, which cut
    runs elsewhere) are the plain version's steps; its sweeps give the
    plain version's labels and sweeps, at a cap and converged, and JAX's
    converged (8-connected, the clean-up's)."""
    m = np.stack([serpentine_mask(HW), serpentine_mask(HW).T.copy()])
    mask = torch.from_numpy(m)
    bg = HW * HW
    lab = tcc.connected_components_plain(mask, connectivity, 3).long()
    nbrs = tcc._NEIGHBOURS_8 if connectivity == 8 else tcc._NEIGHBOURS_4
    lp = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=bg)
    want = lab
    for dy, dx in nbrs:
        want = torch.minimum(want, lp[:, 1 - dy:1 - dy + HW,
                                      1 - dx:1 - dx + HW])
    want = torch.where(mask, want, bg)
    stencil = tcc.stencil_separable(lab, connectivity, bg)
    assert torch.equal(stencil, want)
    rows = tcc.row_run_min_in_place(stencil, bg)
    assert torch.equal(rows, tcc._run_min(stencil, mask, bg, 2))
    for band in (8, 5):
        assert torch.equal(tcc.column_run_min_bands(rows, bg, band),
                           tcc._run_min(rows, mask, bg, 1))
    for iters in (2, 512):
        got, sweeps = tcc.components_banded(mask, connectivity, iters)
        assert torch.equal(got, tcc.connected_components_plain(
            mask, connectivity, iters))
        assert sweeps == tcc.connected_components_plain.last_sweeps
    if connectivity == 8:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(
            jcc.connected_components(jnp.asarray(m[0]))))
