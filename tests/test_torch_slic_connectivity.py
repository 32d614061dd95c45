"""Port parity: SLIC's connectivity repair over a batch, against the JAX
package image by image, exactly (integer labels, no tolerance).

`enforce_connectivity` and `_absorb_orphans` take (B, H, W) labels; on the
CPU they run the plain versions of csrc/slic_connectivity.cu, whose loops
stop when the batch's block changes nothing.  Each image must still get
its own labels: JAX runs each image's while loops alone.  The spiral
with max_sweeps=2 stops both loops at their cap, where the labels depend
on every Jacobi step being the plain version's.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import spiral_labels
from gcn_grabcut_tpu.ops import slic as jslic
from gcn_grabcut_torch.ops import slic as tslic

torch.set_num_threads(1)

B, HW, GRID = 3, 96, 10          # ~100 superpixels of ~10 px


def fragmented_labels(seed: int) -> np.ndarray:
    """SLIC-like labels: a 10 x 10 grid of cells whose borders wander
    pixel by pixel, so labels break into fragments and orphans."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:HW, 0:HW]
    jy = np.clip(yy + r.randint(-3, 4, (HW, HW)), 0, HW - 1)
    jx = np.clip(xx + r.randint(-3, 4, (HW, HW)), 0, HW - 1)
    cell = HW / GRID
    return ((jy // cell).astype(np.int64) * GRID
            + (jx // cell).astype(np.int64))


def jax_enforce(lab: np.ndarray, k: int, **kw) -> np.ndarray:
    return np.asarray(jslic.enforce_connectivity(
        jnp.asarray(lab.astype(np.int32)), k, **kw))


def jax_absorb(lab: np.ndarray, n: int) -> np.ndarray:
    return np.asarray(jslic._absorb_orphans(
        jnp.asarray(lab.astype(np.int32)), n_sweeps=n))


@pytest.fixture(scope="module")
def fragmented():
    return np.stack([fragmented_labels(s) for s in range(B)])


def test_fragmented_labels_are_fragmented(fragmented):
    """The case has what the repair repairs: orphans, and labels in more
    than one piece."""
    got = tslic.enforce_connectivity(torch.from_numpy(fragmented),
                                     GRID * GRID).numpy()
    assert (got != fragmented).mean() > 0.01
    assert (tslic._absorb_orphans(torch.from_numpy(fragmented), 4).numpy()
            != fragmented).any()


@pytest.mark.parametrize("max_sweeps", [64, 3])
def test_enforce_connectivity_matches_jax(fragmented, max_sweeps):
    got = tslic.enforce_connectivity(torch.from_numpy(fragmented),
                                     GRID * GRID, max_sweeps=max_sweeps)
    for b in range(B):
        np.testing.assert_array_equal(
            got[b].numpy(), jax_enforce(fragmented[b], GRID * GRID,
                                        max_sweeps=max_sweeps))


@pytest.mark.parametrize("n_sweeps", [1, 4])
def test_absorb_orphans_matches_jax(fragmented, n_sweeps):
    got = tslic._absorb_orphans(torch.from_numpy(fragmented), n_sweeps)
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(),
                                      jax_absorb(fragmented[b], n_sweeps))


def test_repair_is_absorb_then_enforce(fragmented):
    """SLIC's tail, one kernel launch on the card: JAX's two calls."""
    got = tslic.repair_connectivity(torch.from_numpy(fragmented),
                                    GRID * GRID)
    for b in range(B):
        want = jax_enforce(jax_absorb(fragmented[b], 4), GRID * GRID)
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("max_sweeps", [1, 2, 64])
def test_spiral_at_the_cap_matches_jax(max_sweeps):
    """Both loops stop at the cap (max_sweeps 1 and 2) beside images that
    converge: each image keeps its own labels, JAX's."""
    spiral = spiral_labels(48)
    batch = np.stack([spiral, spiral.T.copy(),
                      fragmented_labels(7)[:48, :48]])
    got = tslic.enforce_connectivity(torch.from_numpy(batch), GRID * GRID,
                                     max_sweeps=max_sweeps)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), jax_enforce(batch[b], GRID * GRID,
                                        max_sweeps=max_sweeps))


def test_spiral_hits_the_cap():
    """max_sweeps 2 leaves the spiral's components unconverged, so its
    labels differ from the converged repair's."""
    spiral = torch.from_numpy(spiral_labels(48))[None]
    capped = tslic.enforce_connectivity(spiral, 3, max_sweeps=2)
    full = tslic.enforce_connectivity(spiral, 3)
    assert not torch.equal(capped, full)


def test_slic_batch_equals_each_image_alone():
    r = np.random.RandomState(3)
    lab = torch.from_numpy((r.rand(B, 64, 64, 3) * [100, 60, 60]
                            - [0, 30, 30]).astype(np.float32))
    got = tslic.slic(lab, n_segments=40)
    for b in range(B):
        assert torch.equal(got[b], tslic.slic(lab[b:b + 1], n_segments=40)[0])
