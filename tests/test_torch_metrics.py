"""Port parity: gcn_grabcut_torch.metrics and the host `clean_mask`
against the JAX package, on one 40x48 shape.

The metrics must agree within 1e-6, masks that touch the image border
included (the boundary erosion must not erode from the edge); the
clean-up must agree exactly.  The clean-up's per-component sums run in a
fixed order, which on the CPU is the order of `index_add_`.
"""

import numpy as np
import pytest
import torch

from gcn_grabcut_tpu import metrics as jm
from gcn_grabcut_tpu.ops.connected import clean_mask as jclean
import gcn_grabcut_torch as gt
from gcn_grabcut_torch import metrics as tm
from gcn_grabcut_torch.ops import region as tregion

torch.set_num_threads(1)

H, W = 40, 48
TOL = 1e-6


def masks(case: str):
    """(pred, gt) uint8 masks."""
    r = np.random.RandomState(len(case))
    yy, xx = np.mgrid[0:H, 0:W]
    disc = ((yy - 20) ** 2 + (xx - 24) ** 2 < 12 ** 2).astype(np.uint8)
    if case == "noisy":
        return (r.rand(H, W) > 0.5).astype(np.uint8), disc
    if case == "shifted":
        return np.roll(disc, (2, 3), (0, 1)), disc
    if case == "border":            # both touch the image edge
        pred = np.zeros((H, W), np.uint8)
        pred[:, :20] = 1
        pred[:6, :] = 1
        gt = np.zeros((H, W), np.uint8)
        gt[:, :18] = 1
        gt[30:, 40:] = 1
        return pred, gt
    if case == "full":              # all foreground: no boundary
        return np.ones((H, W), np.uint8), np.ones((H, W), np.uint8)
    if case == "empty_pred":
        return np.zeros((H, W), np.uint8), disc
    if case == "identical":
        return disc, disc.copy()
    raise ValueError(case)


CASES = ["noisy", "shifted", "border", "full", "empty_pred", "identical"]


@pytest.mark.parametrize("case", CASES)
def test_evaluate_matches_jax(case):
    pred, gt = masks(case)
    want = jm.evaluate(pred, gt)
    got = tm.evaluate(pred, gt)
    for field, value in want.as_dict().items():
        assert abs(getattr(got, field) - getattr(want, field)) <= TOL, field
    assert str(got) == str(want)
    assert got.as_dict() == want.as_dict()
    assert isinstance(got, tm.SegmentationMetrics)


@pytest.mark.parametrize("width", [1, 3, 5])
@pytest.mark.parametrize("case", ["noisy", "shifted", "border"])
def test_boundary_f1_matches_jax(case, width):
    pred, gt = masks(case)
    assert abs(tm.boundary_f1(pred, gt, width)
               - jm.boundary_f1(pred, gt, width)) <= TOL


def test_erosion_keeps_the_image_edge():
    """A mask covering the image has no boundary; one row cut from it has
    a boundary only along that row's band."""
    m = torch.ones(H, W)
    assert float(tm._erode(m, 3).min()) == 1.0
    m[10, :] = 0.0
    band = (m - tm._erode(m, 3)) > 0
    rows = torch.nonzero(band.any(dim=1)).flatten().tolist()
    assert rows == [7, 8, 9, 11, 12, 13]


def test_evaluate_without_boundary():
    pred, gt = masks("noisy")
    assert tm.evaluate(pred, gt, boundary_width=0).boundary_f1 == 0.0


@pytest.mark.parametrize("case", ["noisy", "shifted", "border"])
def test_evaluate_trimap_matches_jax(case):
    _, gt = masks(case)
    trimap = np.random.RandomState(3).randint(0, 4, (H, W)).astype(np.uint8)
    want = jm.evaluate_trimap(trimap, gt)
    got = tm.evaluate_trimap(trimap, gt)
    for field in want.as_dict():
        assert abs(getattr(got, field) - getattr(want, field)) <= TOL, field
    assert str(got) == str(want)


def test_evaluate_batch_matches_jax():
    results = [dict(zip(("binary_mask", "gt_mask"), masks(c)))
               for c in CASES]
    want = jm.evaluate_batch(results)
    got = tm.evaluate_batch(results)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert abs(got[key] - value) <= TOL, key
    assert tm.evaluate_batch([]) == jm.evaluate_batch([])


def component_masks():
    """Masks with several components, some touching the border."""
    r = np.random.RandomState(5)
    blobs = np.zeros((H, W), np.uint8)
    blobs[5:20, 6:22] = 1
    blobs[25:35, 30:44] = 1
    blobs[2:4, 40:42] = 1
    frame = np.zeros((H, W), np.uint8)
    frame[:3, :] = frame[-3:, :] = frame[:, :3] = frame[:, -3:] = 1
    frame[15:25, 15:30] = 1
    return {"noise": (r.rand(H, W) > 0.6).astype(np.uint8), "blobs": blobs,
            "frame": frame, "empty": np.zeros((H, W), np.uint8)}


@pytest.mark.parametrize("mode", ["min_area", "zero_ratio", "keep_largest",
                                  "posterior"])
@pytest.mark.parametrize("name", ["noise", "blobs", "frame", "empty"])
def test_clean_mask_matches_jax(name, mode):
    mask = component_masks()[name]
    ratio = 0.0 if mode == "zero_ratio" else 0.01
    keep = mode in ("keep_largest", "posterior")
    post = (np.random.RandomState(1).rand(H, W).astype(np.float32)
            if mode == "posterior" else None)
    want = jclean(mask, ratio, keep, posterior=post)
    got = gt.clean_mask(mask, ratio, keep, posterior=post, device="cpu")
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    if mode == "zero_ratio" or name == "empty":
        assert got is mask          # returned unchanged


@pytest.mark.parametrize("columns", [0, 3])
def test_segment_sum_follows_index_add_on_the_cpu(columns):
    """The fixed-order segment sums (the clean-up's, SLIC's, the region
    statistics') equal index_add_'s sequential sums bit for bit on the
    CPU, labels with no pixels included."""
    r = np.random.RandomState(2)
    n = H * W
    labels = torch.from_numpy(r.randint(0, 60, n))
    labels[::5] = n - 1
    shape = (n, columns) if columns else (n,)
    values = torch.from_numpy(r.rand(*shape).astype(np.float32))
    got = tregion.segment_sum(labels, values, n)
    want = torch.zeros((n,) + shape[1:]).index_add_(0, labels, values)
    assert got.shape == want.shape and torch.equal(got, want)


def test_clean_mask_needs_cuda_unless_cpu_is_asked():
    mask = component_masks()["blobs"]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.clean_mask(mask)
