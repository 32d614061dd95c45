"""The port's batched front and back of segment_batch: an image's outputs
in a batch of three equal its outputs alone, bit for bit (on the CPU; the
card's counterpart is in chip_smoke.py).

The build (SLIC, statistics, edges, prior), the trimap stage and the
clean-up run as (B, ...) tensors with no loop over the images; every sum
is a fixed-order chain per image and every maximum per image, so a batch
changes no bit of an image's arrays.
"""

import numpy as np
import pytest
import torch

import gcn_grabcut_torch as gt
from gcn_grabcut_torch import pipeline as tpipe
from gcn_grabcut_torch.graph_build import build_graph_batch_arrays
from gcn_grabcut_torch.ops import image as im

torch.set_num_threads(1)

B, HW, N_SEGMENTS = 3, 96, 100


def images(hw: int = HW) -> np.ndarray:
    """Three noisy images with a disc each, one with a border frame."""
    out = []
    for seed in range(B):
        r = np.random.RandomState(seed)
        yy, xx = np.mgrid[0:hw, 0:hw] / hw
        img = 60 + 40 * np.stack([yy, xx, yy * xx], -1) + r.randn(hw, hw, 3) * 8
        disc = (yy - 0.5) ** 2 + (xx - 0.4 - 0.1 * seed) ** 2 < 0.06
        img[disc] = [200, 90 + 30 * seed, 60] + r.randn(disc.sum(), 3) * 10
        if seed == 2:
            img[:, :5] = 15
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality (NaN bits included)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8) if a.is_floating_point() else a,
        b.contiguous().view(torch.uint8) if b.is_floating_point() else b)


@pytest.fixture(scope="module", params=[False, True],
                ids=["border_prior", "bg_connectivity"])
def builds(request):
    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS,
                                   bg_connectivity=request.param)
    imgs = images()
    batch = build_graph_batch_arrays(imgs, cfg, device="cpu")
    alone = [build_graph_batch_arrays(imgs[b:b + 1], cfg, device="cpu")
             for b in range(B)]
    return imgs, batch, alone


def test_build_batch_equals_each_image_alone(builds):
    _, batch, alone = builds
    assert batch["segments"].shape == (B, HW, HW)
    for key, value in batch.items():
        for b in range(B):
            assert same(value[b], alone[b][key][0]), (key, b)


def test_build_images_differ(builds):
    """The images are not copies of one another, so the check above can
    tell a batch-wide reduction from a per-image one."""
    _, batch, _ = builds
    for key in ("prior", "x", "edge_attr"):
        assert not torch.equal(batch[key][0], batch[key][1])


def test_build_graph_is_the_batched_build():
    """build_graph goes through build_graph_batch_arrays at B = 1."""
    imgs = images()
    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    g = gt.build_graph(imgs[1], cfg, device="cpu")
    batch = build_graph_batch_arrays(imgs, cfg, device="cpu")
    np.testing.assert_array_equal(g.segments, batch["segments"][1].numpy())
    assert same(g.graph.x[0], batch["x"][1])
    assert same(torch.from_numpy(g.prior), batch["prior"][1])


def test_trimap_stage_batch_equals_each_image_alone(builds):
    imgs, batch, _ = builds
    r = np.random.RandomState(4)
    k = batch["x"].shape[1]
    logits = torch.from_numpy(r.randn(B, k, 3).astype(np.float32) * 2)
    logits[2, :, 2] += 6.0           # image 2 has no background side
    probs = torch.softmax(logits, dim=-1)
    grays = im.rgb_to_gray(torch.from_numpy(imgs).float()) / 255.0
    args = (batch["segments"], grays, batch["prior"], batch["node_mask"])

    px = tpipe._project_probs_device(probs, batch["segments"], (HW, HW))
    tri = tpipe._trimap_stage_device(px, *args, 0.6, 0.6, 4)
    assert (tri[2] == 2).any()       # the seeded side
    for b in range(B):
        one = tuple(a[b:b + 1] for a in args)
        px1 = tpipe._project_probs_device(probs[b:b + 1],
                                          batch["segments"][b:b + 1],
                                          (HW, HW))
        assert same(px[b], px1[0])
        assert same(tri[b], tpipe._trimap_stage_device(px1, *one, 0.6, 0.6,
                                                       4)[0])
    # The multi-scale path's resize back to full resolution.
    small = tpipe._project_probs_device(probs, batch["segments"], (72, 80))
    for b in range(B):
        assert same(small[b], tpipe._project_probs_device(
            probs[b:b + 1], batch["segments"][b:b + 1], (72, 80))[0])


@pytest.mark.parametrize("keep_largest", [False, True])
def test_post_stage_batch_equals_each_image_alone(builds, keep_largest):
    _, batch, _ = builds
    r = np.random.RandomState(5)
    masks = torch.from_numpy((r.rand(B, HW, HW) > 0.55).astype(np.uint8))
    masks[1] = 0
    masks[1, 10:14, 10:14] = 1          # one speck below min_area
    trimaps = torch.from_numpy(r.randint(0, 4, (B, HW, HW)).astype(np.uint8))
    pfg = torch.from_numpy(r.rand(B, HW, HW).astype(np.float32))
    packed = tpipe._post_stage_device(masks, trimaps, batch["segments"], 50.0,
                                      keep_largest, True, pfg)
    for b in range(B):
        one = tpipe._post_stage_device(
            masks[b:b + 1], trimaps[b:b + 1], batch["segments"][b:b + 1],
            50.0, keep_largest, True, pfg[b:b + 1])
        assert same(packed[b], one[0])


def test_segment_batch_equals_each_image_alone():
    """The whole path, multi-scale included: masks, trimaps and label maps
    of a batch of three are those of three calls at B = 1.  The forward
    (not part of the batched build) may round its products differently
    at another batch size; its posteriors agree within float32 noise."""
    model = gt.ResGCNNet(hidden_channels=16, n_layers=2,
                         generator=torch.Generator().manual_seed(1))
    pipe = gt.GCNGrabCutPipeline(
        model, gt.SuperpixelGraphConfig(n_segments=60, bg_connectivity=True),
        device="cpu")
    imgs = list(images(64))
    settings = dict(threshold_fg=0.55, threshold_bg=0.55, filter_radius=4,
                    ms_scales=(1.0, 0.75), keep_largest=True)
    res = pipe.segment_batch(imgs, **settings)
    for b, img in enumerate(imgs):
        one = pipe.segment_batch([img], **settings)[0]
        np.testing.assert_array_equal(res[b].binary_mask, one.binary_mask)
        np.testing.assert_array_equal(res[b].trimap, one.trimap)
        np.testing.assert_array_equal(res[b].segments, one.segments)
        np.testing.assert_allclose(res[b].probs, one.probs, atol=1e-6)
