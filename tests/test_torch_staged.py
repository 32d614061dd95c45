"""Port parity: the scalar API and the staged paths of gcn_grabcut_torch
against the JAX package, on 96x96 images with the recommended ensemble
(the bgc_s4{2,3,4} checkpoints read by each package's own reader), 500
superpixels and the geodesic prior.

The images are noise with a bright disc.  Flat colour regions (such as
`chip_smoke.make_image`'s 8x8 blocks, only 144 colours at this size) make
both the std-Lab node feature and GrabCut's colour GMMs ill-conditioned,
so the two packages' float32 sums may part there.

Covered: `build_graph` / `RegionGraph`, `predict_probs(RegionGraph)`, the
trimap helpers, `refine_trimap`, `seed_from_prior`, `segment`'s staged
options, `segment_stream`, `segment_bbox`, `SegmentationResult.save`, the
`GrabCut` class in three colour spaces and `run_batch_with_trimaps`.
"""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcn_grabcut_tpu as jgt
from gcn_grabcut_tpu import grabcut as jgc
from gcn_grabcut_tpu import pipeline as jpipe
from gcn_grabcut_tpu.ops import image as jim
from gcn_grabcut_tpu.train.checkpoints import load_model_auto as jload
import gcn_grabcut_torch as gt
from gcn_grabcut_torch import grabcut as tgc
from gcn_grabcut_torch import pipeline as tpipe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENSEMBLE = ",".join(str(ROOT / f"examples/ensemble_r5/bgc_s4{i}.msgpack")
                    for i in (2, 3, 4))
SIZE = 96
SETTINGS = dict(threshold_fg=0.65, threshold_bg=0.65, filter_radius=4)
BBOX = (18, 20, 54, 56)
PROBS_ATOL = 1e-5
GRAPH_ATOL = 1e-4
MIN_IOU = 0.99
MIN_AGREE = 0.999
GRAPH_KEYS = ("x", "edge_src", "edge_dst", "edge_attr", "node_mask",
              "edge_mask", "node_area")


def iou(a, b):
    a, b = a > 0, b > 0
    return float((a & b).sum() / (a | b).sum()) if (a | b).any() else 1.0


@pytest.fixture(scope="module")
def models():
    jmodel, jvars, _ = jload(ENSEMBLE)
    tmodel, _ = gt.load_model_auto(ENSEMBLE, device="cpu")
    return jmodel, jvars, tmodel


def pipelines(models, backend="auto"):
    jmodel, jvars, tmodel = models
    jp = jgt.GCNGrabCutPipeline(
        jmodel, jvars, jgt.SuperpixelGraphConfig(n_segments=500,
                                                 bg_connectivity=True),
        jgt.GrabCutConfig(backend=backend))
    tp = gt.GCNGrabCutPipeline(
        tmodel, gt.SuperpixelGraphConfig(n_segments=500,
                                         bg_connectivity=True),
        gt.GrabCutConfig(backend=backend), device="cpu")
    return jp, tp


def textured_image(seed=5):
    """Noise with a bright disc."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    img = (r.rand(SIZE, SIZE, 3) * 80).astype(np.uint8)
    blob = ((yy - 48) ** 2 + (xx - 45) ** 2) < 27 ** 2
    img[blob] = (200 + r.rand(blob.sum(), 3) * 50).astype(np.uint8)
    return img


@pytest.fixture(scope="module")
def graphs():
    img = textured_image()
    jg = jgt.build_graph(img, jgt.SuperpixelGraphConfig(
        n_segments=500, bg_connectivity=True))
    tg = gt.build_graph(img, gt.SuperpixelGraphConfig(
        n_segments=500, bg_connectivity=True), device="cpu")
    return img, jg, tg


def port_graph_from_jax(jg) -> gt.RegionGraph:
    """The JAX package's graph as the port's RegionGraph (same arrays)."""
    batch = gt.make_graph_batch(**{k: np.array(getattr(jg.graph, k))
                                   for k in GRAPH_KEYS})
    return gt.RegionGraph(segments=jg.segments, graph=batch,
                          centroids=jg.centroids, prior=jg.prior,
                          n_nodes=jg.n_nodes)


def test_build_graph_matches_jax(graphs):
    _, jg, tg = graphs
    assert isinstance(tg, gt.RegionGraph) and tg.n_nodes == jg.n_nodes
    assert tg.segments.dtype == np.int32
    # SLIC agrees fully on this image, so everything downstream compares.
    assert float((tg.segments == jg.segments).mean()) == 1.0
    np.testing.assert_array_equal(tg.node_mask, jg.node_mask)
    for got, want in ((tg.node_input(), jg.node_input()),
                      (tg.prior, jg.prior), (tg.centroids, jg.centroids),
                      (tg.node_areas, jg.node_areas)):
        np.testing.assert_allclose(got, want, atol=GRAPH_ATOL)
    (t_idx, t_attr, t_em), (j_idx, j_attr, j_em) = tg.edges(), jg.edges()
    np.testing.assert_array_equal(t_em, j_em)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_allclose(t_attr, j_attr, atol=GRAPH_ATOL)


def test_region_graph_views_match_jax(graphs):
    img, jg, tg = graphs
    tt, jt = tg.to_torch(), jg.to_torch()
    assert tt.keys() == jt.keys()
    assert torch.equal(tt["edge_index"], jt["edge_index"])
    assert all(tt[k].shape == jt[k].shape and tt[k].dtype == jt[k].dtype
               for k in tt)
    tn, jn = tg.to_networkx(), jg.to_networkx()
    assert sorted(tn.nodes) == sorted(jn.nodes)
    assert sorted(tn.edges) == sorted(jn.edges)
    built = gt.GraphBuilder(img, gt.SuperpixelGraphConfig(
        n_segments=500, bg_connectivity=True), device="cpu").build()
    np.testing.assert_array_equal(built.segments, tg.segments)
    assert gt.SuperpixelGraph is gt.RegionGraph


def test_predict_probs_matches_jax(models, graphs):
    """The dense branch on the same graph arrays: (K, 3) numpy."""
    _, jg, _ = graphs
    jp, tp = pipelines(models)
    want = jp.predict_probs(jg)
    got = tp.predict_probs(port_graph_from_jax(jg))
    assert isinstance(got, np.ndarray) and got.shape == (jg.n_nodes, 3)
    np.testing.assert_allclose(got, want, atol=PROBS_ATOL)


def node_probs(k, seed=0):
    logits = 3.0 * np.random.RandomState(seed).randn(k, 3)
    return (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
            ).astype(np.float32)


def test_trimap_helpers_match_jax(graphs):
    _, jg, _ = graphs
    probs = node_probs(jg.n_nodes)
    seg = jg.segments
    np.testing.assert_array_equal(
        gt.probs_to_node_trimap(probs, 0.6, 0.5).numpy(),
        np.asarray(jgt.probs_to_node_trimap(jnp.asarray(probs), 0.6, 0.5)))
    np.testing.assert_array_equal(
        gt.project_to_pixels(torch.from_numpy(probs[:, 2]), seg).numpy(),
        np.asarray(jgt.project_to_pixels(jnp.asarray(probs[:, 2]),
                                         jnp.asarray(seg))))
    labels = np.arange(jg.n_nodes, dtype=np.uint8)
    np.testing.assert_array_equal(
        gt.project_to_pixels(torch.from_numpy(labels), seg).numpy(),
        np.asarray(jgt.project_to_pixels(jnp.asarray(labels),
                                         jnp.asarray(seg))))
    tri = gt.probs_to_trimap(probs, seg)
    np.testing.assert_array_equal(
        tri, jgt.probs_to_trimap(jnp.asarray(probs), jnp.asarray(seg)))
    assert len(np.unique(tri)) == 4
    np.testing.assert_array_equal(gt.colour_trimap(tri),
                                  jgt.colour_trimap(tri))


@pytest.mark.parametrize("side", ["no_fg", "no_bg", "both"])
def test_seed_from_prior_matches_jax(graphs, side):
    _, jg, _ = graphs
    tri = np.random.RandomState(4).randint(0, 4, jg.segments.shape
                                           ).astype(np.uint8)
    if side == "no_fg":
        tri = np.where(np.isin(tri, (1, 3)), 2, tri).astype(np.uint8)
    elif side == "no_bg":
        tri = np.where(np.isin(tri, (0, 2)), 3, tri).astype(np.uint8)
    got = gt.seed_from_prior(tri, port_graph_from_jax(jg))
    want = jgt.seed_from_prior(tri, jg)
    np.testing.assert_array_equal(got, want)
    if side == "both":
        assert got is tri
    else:
        assert not np.array_equal(got, tri)


def test_refine_trimap_matches_jax(graphs):
    """Exact except at pixels whose filtered posterior lies within 1e-5 of
    a threshold (another summation order may flip them)."""
    img, jg, _ = graphs
    probs = node_probs(jg.n_nodes, seed=1)
    want = jgt.refine_trimap(probs, jg.segments, img, 0.6, 0.55, radius=4)
    got = gt.refine_trimap(probs, jg.segments, img, 0.6, 0.55, radius=4,
                           device="cpu")
    gray = jim.rgb_to_gray(jnp.asarray(img, jnp.float32)) / 255.0
    filt = [np.clip(np.asarray(jim.guided_filter(
        gray, jnp.asarray(probs[:, c][jg.segments]), 4, 1e-3)), 0, 1)
        for c in (0, 2)]
    near = ((np.abs(filt[0] - np.float32(0.55)) < 1e-5)
            | (np.abs(filt[1] - np.float32(0.6)) < 1e-5)
            | (np.abs(filt[0] - filt[1]) < 1e-5))
    assert got.dtype == np.uint8 and len(np.unique(got)) == 4
    assert (got != want)[~near].sum() == 0


OPTIONS = {"edge_off": dict(edge_aware=False),
           "refine": dict(refine_iters=1),
           "native": dict(),
           "keep_largest": dict(edge_aware=False, keep_largest=True)}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_staged_segment_matches_jax(models, option):
    """Each staged option by mask IoU; on the CPU both packages' "auto"
    GrabCut is the native solver."""
    jp, tp = pipelines(models, "native" if option == "native" else "auto")
    img = textured_image(7)
    want = jp.segment(img, **SETTINGS, **OPTIONS[option])
    got = tp.segment(img, **SETTINGS, **OPTIONS[option])
    score = iou(got.binary_mask, want.binary_mask)
    print(f"staged {option}: mask IoU vs JAX {score:.6f} (FG "
          f"{got.binary_mask.mean():.4f} / {want.binary_mask.mean():.4f}), "
          f"trimap agreement {(got.trimap == want.trimap).mean():.6f}")
    assert score >= MIN_IOU
    assert set(got.timing) == {"graph_build", "gcn_inference", "grabcut",
                               "postprocess"}
    assert got.probs.shape == (500 - 16, 3)
    assert got.segments.shape == img.shape[:2]
    assert got.rgba.shape == (SIZE, SIZE, 4)


def test_segment_stream_equals_segment_batch(models):
    """Five images in chunks of two (the last chunk is short): each chunk
    equals segment_batch on it."""
    _, tp = pipelines(models)
    images = [textured_image(s) for s in range(5)]
    stream = list(tp.segment_stream(images, batch_size=2, **SETTINGS))
    batch = [r for i in range(0, 5, 2)
             for r in tp.segment_batch(images[i:i + 2], **SETTINGS)]
    assert len(stream) == 5
    for s, b in zip(stream, batch):
        for field in ("binary_mask", "trimap", "segments", "probs",
                      "overlay", "rgba"):
            np.testing.assert_array_equal(getattr(s, field),
                                          getattr(b, field))
    assert list(tp.segment_stream([], batch_size=2)) == []


def test_segment_bbox_matches_jax(models):
    jp, tp = pipelines(models)
    img = textured_image(6)
    want = jp.segment_bbox(img, BBOX)
    got = tp.segment_bbox(img, BBOX)
    np.testing.assert_array_equal(got.trimap, want.trimap)
    assert (got.trimap == 1).any()
    assert iou(got.binary_mask, want.binary_mask) >= MIN_IOU


@pytest.mark.parametrize("rect", [(10, 12, 60, 50), (0, 0, 40, 96),
                                  (50, 30, 60, 80), (-5, 70, 40, 40)])
def test_erode_box_matches_cv2(rect):
    """cv2's 30x30 erosion: anchor (15, 15), no erosion from the edge."""
    x, y, w, h = rect
    inner = np.zeros((SIZE, SIZE), np.uint8)
    inner[y:y + h, x:x + w] = 1
    np.testing.assert_array_equal(
        tpipe._erode_box(inner, 30),
        cv2.erode(inner, np.ones((30, 30), np.uint8)))


def test_save_writes_the_same_pngs_as_jax(tmp_path):
    r = np.random.RandomState(6)
    arrays = dict(image=r.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
                  binary_mask=(r.rand(SIZE, SIZE) > 0.5).astype(np.uint8),
                  trimap=r.randint(0, 4, (SIZE, SIZE)).astype(np.uint8),
                  segments=np.zeros((SIZE, SIZE), np.int32),
                  overlay=r.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
                  rgba=r.randint(0, 256, (SIZE, SIZE, 4)).astype(np.uint8))
    jgt.SegmentationResult(**arrays).save(str(tmp_path / "jax"))
    gt.SegmentationResult(**arrays).save(str(tmp_path / "port"))
    for part in ("overlay", "rgba", "trimap_colour", "mask"):
        want = cv2.imread(str(tmp_path / f"jax_{part}.png"),
                          cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / f"port_{part}.png"),
                         cv2.IMREAD_UNCHANGED)
        assert got is not None and got.shape == want.shape, part
        np.testing.assert_array_equal(got, want)


def test_evaluate_against(models):
    _, tp = pipelines(models)
    img = textured_image(6)
    res = tp.segment(img, edge_aware=False, **SETTINGS)
    gt_mask = np.zeros((SIZE, SIZE), np.uint8)
    gt_mask[24:72, 21:69] = 1
    seg, tri = res.evaluate_against(gt_mask)
    want_seg = gt.evaluate(res.binary_mask, gt_mask)
    assert seg.as_dict() == want_seg.as_dict()
    assert tri.as_dict() == gt.evaluate_trimap(res.trimap, gt_mask).as_dict()


def grabcut_pair(cs, img):
    return (jgc.GrabCut(img, jgc.GrabCutConfig(color_space=cs,
                                               backend="device")),
            tgc.GrabCut(img, tgc.GrabCutConfig(color_space=cs,
                                               backend="device"),
                        device="cpu"))


@pytest.mark.parametrize("cs", ["rgb", "hsv", "lab"])
def test_grabcut_class_matches_jax(cs):
    """run_with_bbox then refine(2) (and run_with_trimap in RGB) with the
    device solver in both packages."""
    img = textured_image(6)
    jgcut, tgcut = grabcut_pair(cs, img)
    np.testing.assert_allclose(
        tgcut._proc.numpy(),
        np.asarray(jgc.preprocess_device(jnp.asarray(img, jnp.float32), cs)),
        atol=1e-3)
    steps = [("run_with_bbox", BBOX), ("refine", 2)]
    if cs == "rgb":
        tri = gt.probs_to_trimap(node_probs(484, seed=2),
                                 np.arange(SIZE * SIZE).reshape(SIZE, SIZE)
                                 // (SIZE * SIZE // 484 + 1))
        steps.insert(0, ("run_with_trimap", tri))
    for name, arg in steps:
        want = getattr(jgcut, name)(arg)
        got = getattr(tgcut, name)(arg)
        agree = float((got == want).mean())
        print(f"{cs} {name}: mask agreement {agree:.6f}")
        assert got.dtype == np.uint8 and agree >= MIN_AGREE
    assert ([h.tag for h in tgcut.history]
            == [h.tag for h in jgcut.history])
    for th, jh in zip(tgcut.history, jgcut.history):
        assert abs(th.fg_pixels - jh.fg_pixels) <= (1 - MIN_AGREE) * img[
            ..., 0].size
        assert th.fg_pixels + th.bg_pixels == SIZE * SIZE
    # The same mask gives the same overlay and cut-out.
    tgcut.mask = jgcut.mask.copy()
    np.testing.assert_array_equal(tgcut.overlay_mask(), jgcut.overlay_mask())
    np.testing.assert_array_equal(tgcut.crop_foreground(),
                                  jgcut.crop_foreground())
    np.testing.assert_array_equal(tgcut.trimap_visualisation(tgcut.mask),
                                  jgcut.trimap_visualisation(jgcut.mask))


def test_grabcut_degenerate_trimap_matches_jax():
    img = textured_image(6)
    tri = np.full((SIZE, SIZE), 3, np.uint8)
    jgcut, tgcut = grabcut_pair("rgb", img)
    np.testing.assert_array_equal(tgcut.run_with_trimap(tri),
                                  jgcut.run_with_trimap(tri))
    assert [h.tag for h in tgcut.history] == ["trimap_degenerate"]
    with pytest.raises(ValueError, match="Trimap shape"):
        tgcut.run_with_trimap(tri[:10])
    with pytest.raises(RuntimeError, match="run_with_bbox"):
        tgc.GrabCut(img, device="cpu").refine()
    with pytest.raises(ValueError, match="unknown GrabCut backend"):
        tgc.GrabCut(img, tgc.GrabCutConfig(backend="tpu"), device="cpu")


def test_run_batch_with_trimaps_matches_jax():
    images = np.stack([textured_image(s) for s in (1, 3)])
    trimaps = np.full(images.shape[:3], 0, np.uint8)
    trimaps[:, 20:76, 18:72] = 3
    trimaps[:, 40:56, 36:54] = 1
    cfg = dict(backend="device")
    want = jgc.run_batch_with_trimaps(images, trimaps,
                                      jgc.GrabCutConfig(**cfg))
    got = tgc.run_batch_with_trimaps(images, trimaps,
                                     tgc.GrabCutConfig(**cfg), device="cpu")
    assert got.shape == want.shape and got.dtype == np.uint8
    assert float((got == want).mean()) >= MIN_AGREE


def test_scalar_entry_points_need_cuda_unless_cpu_is_asked():
    img = textured_image(6)
    cfg = gt.SuperpixelGraphConfig(n_segments=500, bg_connectivity=True)
    if torch.cuda.is_available():
        assert gt.GrabCut(img).device.type == "cuda"
        return
    probs = node_probs(484)
    seg = np.zeros((SIZE, SIZE), np.int32)
    for call in (lambda: gt.build_graph(img, cfg),
                 lambda: gt.GraphBuilder(img, cfg),
                 lambda: gt.GrabCut(img),
                 lambda: tgc.run_batch_with_trimaps(img[None], seg[None]),
                 lambda: gt.refine_trimap(probs, seg, img),
                 lambda: gt.clean_mask(np.ones((SIZE, SIZE), np.uint8))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
