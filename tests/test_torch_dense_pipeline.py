"""Port parity for the slice as a whole: the recommended configuration --
the 3-member bgc ensemble read from the repo's checkpoints,
n_segments=500 with the geodesic prior, θ 0.65, guided-filter radius 4,
ms_scales (1.0, 0.75) -- through both packages' `segment_batch` on two
hard-synthetic images at 128 px (K = 484, as at 512 px).

Checked in pipeline order: SLIC labels, posteriors, trimaps away from the
thresholds, masks by IoU (GrabCut starts from the same k-means seeds, but
near-threshold pixels may flip the trimap it starts from).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu import GCNGrabCutPipeline as JaxPipeline
from gcn_grabcut_tpu import graph_build as jgb
from gcn_grabcut_tpu import pipeline as jpipeline
from gcn_grabcut_tpu.core.graph import make_graph_batch as jmake_graph_batch
from gcn_grabcut_tpu.data.dataset import make_hard_synthetic_dataset
from gcn_grabcut_tpu.models.factory import apply_model as japply_model
from gcn_grabcut_tpu.ops import image as jim
from gcn_grabcut_tpu.train.checkpoints import load_model_auto as jload
import gcn_grabcut_torch as gt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENSEMBLE = ",".join(str(ROOT / f"examples/ensemble_r5/bgc_s4{i}.msgpack")
                    for i in (2, 3, 4))
SIZE = 128
THETA = 0.65
RADIUS = 4
MS_SCALES = (1.0, 0.75)
PROBS_ATOL = 1e-3
# Trimap labels are compared where every comparison deciding them
# (P(FG) vs θ, P(BG) vs θ, P(FG) vs P(BG)) clears this margin.
TRIMAP_EPS = 1e-3
MIN_IOU = 0.99
KEYS = ("x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area")


def jax_pixel_posteriors(jmodel, jvars, cfg, rgbs):
    """The JAX package's guided-filtered pixel P(BG), P(FG) of the
    multi-scale path, from its own stage functions, and its full-scale
    node posteriors."""
    H, W = rgbs.shape[1:3]
    px_list, probs_full = [], None
    for sc in MS_SCALES:
        hw = (max(int(round(H * sc)), 64), max(int(round(W * sc)), 64))
        rgb_s = rgbs if sc == 1.0 else jpipeline._resize_batch_device(rgbs,
                                                                      hw)
        out = jgb.build_graph_batch_arrays(rgb_s, cfg)
        probs = jax.nn.softmax(japply_model(
            jmodel, jvars, jmake_graph_batch(*(out[k] for k in KEYS))), -1)
        probs_full = probs if probs_full is None else probs_full
        px_list.append(jpipeline._project_probs_device(
            probs, out["segments"], (H, W)))
    px = jnp.mean(jnp.stack(px_list), axis=0)
    grays = jim.rgb_to_gray(rgbs) / 255.0
    filt = [np.asarray(jnp.clip(jax.vmap(
        lambda g, p: jim.guided_filter(g, p, RADIUS, 1e-3))(
            grays, px[..., c]), 0, 1)) for c in (0, 1)]
    return np.asarray(probs_full), filt[0], filt[1]


@pytest.fixture(scope="module")
def runs():
    samples = make_hard_synthetic_dataset(n=2, size=SIZE, seed=777)
    images = [s["image"] for s in samples]
    kw = dict(threshold_fg=THETA, threshold_bg=THETA, filter_radius=RADIUS,
              ms_scales=MS_SCALES)
    jmodel, jvars, _ = jload(ENSEMBLE)
    jcfg = jgb.SuperpixelGraphConfig(n_segments=500, bg_connectivity=True)
    jres = JaxPipeline(jmodel, jvars, jcfg).segment_batch(images, **kw)
    jprobs, p_bg, p_fg = jax_pixel_posteriors(
        jmodel, jvars, jcfg, jnp.asarray(np.stack(images), jnp.float32))
    tmodel, _ = gt.load_model_auto(ENSEMBLE, device="cpu")
    pipe = gt.GCNGrabCutPipeline(
        tmodel, gt.SuperpixelGraphConfig(n_segments=500,
                                         bg_connectivity=True),
        device="cpu")
    tres = pipe.segment_batch(images, **kw)
    # keep_largest gates components by the scale-averaged P(FG).
    jkeep = JaxPipeline(jmodel, jvars, jcfg).segment_batch(
        images, keep_largest=True, **kw)
    tkeep = pipe.segment_batch(images, keep_largest=True, **kw)
    return samples, jres, tres, jprobs, p_bg, p_fg, jkeep, tkeep


def test_slic_labels_agree(runs):
    _, jres, tres, *_ = runs
    for j, t in zip(jres, tres):
        agree = float((j.segments == t.segments).mean())
        print(f"SLIC label agreement: {agree:.6f}")
        assert agree >= 0.999


def test_posteriors_match(runs):
    _, jres, tres, jprobs, *_ = runs
    for b, (j, t) in enumerate(zip(jres, tres)):
        assert t.probs.shape == (484, 3)
        # A node is compared where its pixel set is the same on both sides.
        differ = j.segments != t.segments
        bad = np.zeros(484, bool)
        bad[j.segments[differ]] = True
        bad[t.segments[differ]] = True
        present = np.bincount(j.segments.ravel(), minlength=484) > 0
        ok = present & ~bad
        assert ok.sum() >= 0.99 * present.sum()
        np.testing.assert_allclose(t.probs[ok], jprobs[b][ok],
                                   atol=PROBS_ATOL)


def test_trimaps_agree_away_from_thresholds(runs):
    _, jres, tres, _, p_bg, p_fg, *_ = runs
    for b, (j, t) in enumerate(zip(jres, tres)):
        margin = np.minimum.reduce([np.abs(p_fg[b] - THETA),
                                    np.abs(p_bg[b] - THETA),
                                    np.abs(p_fg[b] - p_bg[b])])
        clear = margin >= TRIMAP_EPS
        flips = int((j.trimap != t.trimap)[clear].sum())
        print(f"trimap: {int((j.trimap != t.trimap).sum())} flips, "
              f"{flips} where the margin is >= {TRIMAP_EPS}; "
              f"{(~clear).mean():.4f} of pixels inside it")
        assert clear.mean() > 0.99
        assert flips == 0
        assert len(np.unique(t.trimap)) >= 2


def mask_iou(a, b):
    a, b = a > 0, b > 0
    return (a & b).sum() / (a | b).sum() if (a | b).any() else 1.0


def test_masks_iou(runs):
    samples, jres, tres, *_ = runs
    for s, j, t in zip(samples, jres, tres):
        iou = mask_iou(j.binary_mask, t.binary_mask)
        gt_iou = mask_iou(s["gt_mask"], t.binary_mask)
        print(f"mask IoU vs JAX {iou:.6f}; port vs ground truth {gt_iou:.4f}")
        assert t.binary_mask.shape == (SIZE, SIZE)
        assert 0.0 < t.binary_mask.mean() < 1.0
        assert iou >= MIN_IOU
    assert set(tres[0].timing) == {"graph_build", "gcn_inference",
                                   "grabcut", "postprocess"}


def test_keep_largest_masks_iou(runs):
    *_, jkeep, tkeep = runs
    for j, t in zip(jkeep, tkeep):
        assert mask_iou(j.binary_mask, t.binary_mask) >= MIN_IOU
