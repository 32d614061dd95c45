"""Port parity for the data layer: gcn_grabcut_torch.data against the JAX
package's data/dataset.py and data/hints.py on the same seeds -- the three
generators, augmentation, the split, label derivation, the descriptors and
their decoding, prepare_sample, the graph cache in both directions, and
the click hints.  Plus the port's import rules for the slice's modules.
One image shape (64 px, n_segments=64) for every graph build.
"""

import ast
import dataclasses
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu.data import dataset as jds
from gcn_grabcut_tpu.data import hints as jhints
from gcn_grabcut_tpu.graph_build import SuperpixelGraphConfig as JConfig
import gcn_grabcut_torch as gt
from gcn_grabcut_torch.data import dataset as tds
from gcn_grabcut_torch.data import hints as thints

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HW = 64
N_SEGMENTS = 64
X_TOL = 1e-4          # node features, the same as the graph-build tests
CACHE_FIELDS = ("x", "edge_src", "edge_dst", "edge_attr", "node_mask",
                "edge_mask", "node_area", "fg_ratio", "y")


def assert_samples_equal(a: list, b: list) -> None:
    assert len(a) == len(b) > 0
    for s, t in zip(a, b):
        assert s["name"] == t["name"]
        assert s["image"].dtype == t["image"].dtype == np.uint8
        np.testing.assert_array_equal(s["image"], t["image"])
        np.testing.assert_array_equal(s["gt_mask"], t["gt_mask"])


@pytest.mark.parametrize("make, kwargs", [
    ("make_synthetic_dataset", dict(n=6, size=HW, seed=3)),
    ("make_hard_synthetic_dataset", dict(n=8, size=96, seed=5)),
    ("make_photo_synthetic_dataset", dict(n=4, size=128, seed=9)),
    ("make_photo_synthetic_dataset", dict(n=3, size=128, seed=11,
                                          real_textures=True)),
])
def test_generators_bit_for_bit(make, kwargs):
    assert_samples_equal(getattr(tds, make)(**kwargs),
                         getattr(jds, make)(**kwargs))


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_nearest_matches_cv2(seed):
    """The numpy warp the hard-synthetic generator rotates its rectangles
    with equals this OpenCV's (5.x) warpAffine, nearest, zero border, on
    any affine map, size and shape."""
    r = np.random.RandomState(seed)
    for t in range(40):
        h, w = r.randint(20, 200, 2)
        src = (r.rand(h, w) * 255).astype(np.uint8)
        M = cv2.getRotationMatrix2D((float(r.uniform(0, w)),
                                     float(r.uniform(0, h))),
                                    r.uniform(-180, 180), r.uniform(0.3, 3))
        M = M + r.randn(2, 3) * (0.01 if t % 2 else 0.0)
        dsize = (int(r.randint(20, 200)), int(r.randint(20, 200)))
        np.testing.assert_array_equal(
            tds.warp_affine_nearest(src, M, dsize),
            cv2.warpAffine(src, M, dsize, flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_reflect_matches_cv2(seed, channels):
    """augment_sample's numpy warps equal this OpenCV's (5.x) warpAffine
    with BORDER_REFLECT byte for byte: linear on uint8 images of 1 and 3
    channels, nearest on labels, on any affine map, size and shape
    (including maps that reach far outside the source)."""
    r = np.random.RandomState(100 + seed)
    for t in range(30):
        h, w = r.randint(20, 200, 2)
        shape = (h, w, channels) if channels > 1 else (h, w)
        src = (r.rand(*shape) * 255).astype(np.uint8)
        M = cv2.getRotationMatrix2D((float(r.uniform(0, w)),
                                     float(r.uniform(0, h))),
                                    r.uniform(-180, 180), r.uniform(0.3, 3))
        M = M + r.randn(2, 3) * (0.01 if t % 2 else 0.0)
        dsize = (int(r.randint(20, 200)), int(r.randint(20, 200)))
        np.testing.assert_array_equal(
            tds.warp_affine_linear_reflect(src, M, dsize),
            cv2.warpAffine(src, M, dsize, flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_REFLECT))
        if channels == 1:
            np.testing.assert_array_equal(
                tds.warp_affine_nearest(src, M, dsize, reflect=True),
                cv2.warpAffine(src, M, dsize, flags=cv2.INTER_NEAREST,
                               borderMode=cv2.BORDER_REFLECT))


def test_augment_sample_makes_no_warp_affine_call(monkeypatch):
    """augment_sample warps in numpy: its pixels do not depend on the
    installed OpenCV's warpAffine."""
    def refuse(*args, **kwargs):
        raise AssertionError("cv2.warpAffine called")
    monkeypatch.setattr(cv2, "warpAffine", refuse)
    s = jds.make_hard_synthetic_dataset(n=1, size=96, seed=0)[0]
    tds.augment_sample(s["image"], s["gt_mask"], np.random.RandomState(0),
                       prob_flip=1.0, prob_rotate=1.0, prob_color=1.0,
                       prob_crop=1.0)


def test_real_texture_bank_matches():
    tb, jb = tds._real_texture_bank(), jds._real_texture_bank()
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_augment_sample_exact(seed):
    s = jds.make_hard_synthetic_dataset(n=1, size=96, seed=seed)[0]
    probs = dict(prob_flip=0.5, prob_rotate=0.5, prob_color=0.5,
                 prob_crop=0.5) if seed < 3 else dict(
        prob_flip=1.0, prob_rotate=1.0, prob_color=1.0, prob_crop=1.0)
    ti, tm = tds.augment_sample(s["image"], s["gt_mask"],
                                np.random.RandomState(seed), **probs)
    ji, jm = jds.augment_sample(s["image"], s["gt_mask"],
                                np.random.RandomState(seed), **probs)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


def test_split_dataset_exact():
    samples = [{"name": f"s{i}"} for i in range(37)]
    for seed in (0, 42):
        got = tds.split_dataset(samples, seed=seed)
        want = jds.split_dataset(samples, seed=seed)
        assert [[s["name"] for s in p] for p in got] == \
            [[s["name"] for s in p] for p in want]


def test_trimap_labels_and_fg_ratio_exact():
    r = np.random.RandomState(0)
    seg = r.randint(0, 40, (48, 48))
    seg[seg == 7] = 8                    # an empty region
    mask = (r.rand(48, 48) < 0.4).astype(np.uint8)
    mask[:20, :20] = 1
    for fg_t, bg_t in ((0.7, 0.7), (0.75, 0.6)):
        np.testing.assert_array_equal(
            tds.derive_trimap_labels(seg, mask, 40, fg_t, bg_t),
            jds.derive_trimap_labels(seg, mask, 40, fg_t, bg_t))
    t = tds.node_fg_ratio(seg, mask, 40)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, jds.node_fg_ratio(seg, mask, 40))


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Images and masks in the DUTS layout: one pair larger than the
    descriptors' max_size, one image without a mask, one degenerate mask,
    a non-image file."""
    root = tmp_path_factory.mktemp("pairs")
    imgs, masks = root / "imgs", root / "masks"
    imgs.mkdir()
    masks.mkdir()
    samples = jds.make_hard_synthetic_dataset(n=3, size=96, seed=21)
    for i, s in enumerate(samples):
        cv2.imwrite(str(imgs / f"p{i}.jpg"),
                    cv2.cvtColor(s["image"], cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(masks / f"p{i}.png"), s["gt_mask"] * 255)
    big = cv2.resize(samples[0]["image"], (160, 120))
    cv2.imwrite(str(imgs / "big.png"), cv2.cvtColor(big, cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(masks / "big.png"),
                cv2.resize(samples[0]["gt_mask"] * 255, (160, 120),
                           interpolation=cv2.INTER_NEAREST))
    cv2.imwrite(str(imgs / "lonely.png"), samples[1]["image"])
    cv2.imwrite(str(imgs / "flat.png"), samples[2]["image"])
    cv2.imwrite(str(masks / "flat.png"), np.zeros((96, 96), np.uint8))
    (imgs / "notes.txt").write_text("not an image")
    return imgs, masks


def test_descriptors_and_materialise_exact(image_folder):
    imgs, masks = image_folder
    kw = dict(max_size=HW, augment_copies=2, seed=7)
    got = tds.list_image_mask_pairs(imgs, masks, **kw)
    want = jds.list_image_mask_pairs(imgs, masks, **kw)
    assert got == want and len(got) == 15
    for d in got:
        a, b = tds.materialise(d), jds.materialise(d)
        assert (a is None) == (b is None)
        if a is not None:
            assert a["name"] == b["name"]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["gt_mask"], b["gt_mask"])
    assert sum(tds.materialise(d) is None for d in got) == 3   # flat.png
    loaded = tds.load_image_mask_dataset(imgs, masks, max_size=HW,
                                         augment_factor=1, seed=3)
    assert_samples_equal(loaded, jds.load_image_mask_dataset(
        imgs, masks, max_size=HW, augment_factor=1, seed=3))


@pytest.fixture(scope="module")
def prepared():
    samples = jds.make_synthetic_dataset(n=3, size=HW, seed=8)
    cfg = dict(n_segments=N_SEGMENTS)
    j = [jds.prepare_sample(s, JConfig(**cfg)) for s in samples]
    t = [tds.prepare_sample(s, gt.SuperpixelGraphConfig(**cfg),
                            device="cpu") for s in samples]
    return samples, j, t


def test_prepare_sample_matches(prepared):
    _, jrecs, trecs = prepared
    for (jg, jseg), (tg, tseg) in zip(jrecs, trecs):
        assert tg.y.dtype == torch.int64 and tg.fg_ratio.dtype == torch.float32
        assert tg.y.shape == tg.fg_ratio.shape == tg.node_mask.shape
        agree = float((jseg == tseg).mean())
        assert agree >= 0.99
        if agree == 1.0:
            np.testing.assert_allclose(tg.x.numpy(), np.asarray(jg.x),
                                       atol=X_TOL)
        # Labels are exact on every region whose pixel set is the same.
        differ = jseg != tseg
        same = np.ones(tg.max_nodes, bool)
        same[jseg[differ]] = False
        same[tseg[differ]] = False
        np.testing.assert_array_equal(tg.y[0].numpy()[same],
                                      np.asarray(jg.y[0])[same])
        np.testing.assert_array_equal(tg.fg_ratio[0].numpy()[same],
                                      np.asarray(jg.fg_ratio[0])[same])
    assert any(float((j[1] == t[1]).mean()) == 1.0
               for j, t in zip(jrecs, trecs))


def test_cache_key_matches(image_folder):
    imgs, masks = image_folder
    samples = jds.make_synthetic_dataset(n=1, size=HW, seed=8)
    descs = jds.list_image_mask_pairs(imgs, masks, max_size=HW,
                                      augment_copies=1)
    for cfg in (dict(), dict(n_segments=N_SEGMENTS, bg_connectivity=True,
                             compactness=12.5)):
        for s in samples + descs:
            assert tds._cache_key(s, gt.SuperpixelGraphConfig(**cfg),
                                  0.7, 0.65) == \
                jds._cache_key(s, JConfig(**cfg), 0.7, 0.65)


def test_cache_round_trips_between_packages(prepared, tmp_path):
    samples, jrecs, trecs = prepared
    jcfg = JConfig(n_segments=N_SEGMENTS)
    tcfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    # JAX writes, the port reads (without building anything).
    jds.prepare_dataset(samples, jcfg, cache_dir=tmp_path / "j")
    read = tds.prepare_dataset(samples, tcfg, cache_dir=tmp_path / "j",
                               device="cpu")
    assert len(list((tmp_path / "j").iterdir())) == len(samples)
    for (tg, tseg), (jg, jseg) in zip(read, jrecs):
        np.testing.assert_array_equal(tseg, jseg)
        for f in CACHE_FIELDS:
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)))
    # The port writes, JAX reads: the arrays and their dtypes.
    tds.prepare_dataset(samples, tcfg, cache_dir=tmp_path / "t",
                        device="cpu")
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    back = jds.prepare_dataset(samples, jcfg, cache_dir=tmp_path / "t")
    for (jg, jseg), (tg, tseg) in zip(back, trecs):
        np.testing.assert_array_equal(jseg, tseg)
        for f in CACHE_FIELDS:
            a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
            assert a.dtype == (np.int32 if f in ("edge_src", "edge_dst", "y")
                               else np.float32)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_clicks_and_hints_exact(seed):
    s = jds.make_synthetic_dataset(n=1, size=HW, seed=seed + 30)[0]
    kw = dict(n_fg=4, n_bg=6, erosion_radius=3, jitter=0.05 * seed)
    tf, tb = thints.sample_clicks(s["gt_mask"],
                                  rng=np.random.RandomState(seed), **kw)
    jf, jb = jhints.sample_clicks(s["gt_mask"],
                                  rng=np.random.RandomState(seed), **kw)
    assert (tf, tb) == (jf, jb) and len(tf) == 4
    seg = np.arange(HW * HW).reshape(HW, HW) // 37
    np.testing.assert_array_equal(
        thints.encode_user_hints(seg, tf, tb + [(-1, 3)]),
        jhints.encode_user_hints(seg, jf, jb + [(-1, 3)]))


SLICE_MODULES = ("data/dataset.py", "data/hints.py", "train/losses.py",
                 "train/trainer.py", "train/checkpoints.py", "core/graph.py",
                 "models/resgcn.py", "models/layers.py", "models/factory.py",
                 "cli/train.py", "cli/prepare_graphs.py", "cli/evaluate.py",
                 "cli/inference.py")


def _module_level_imports(path: Path) -> set:
    """Top-level names imported outside any function body."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_exist_and_import_no_jax_or_cv2(module):
    """The slice's modules exist, import nothing of JAX anywhere (the
    import-rule test in test_torch_pipeline.py scans every port module),
    and import cv2 only inside the functions that use it."""
    path = ROOT / "gcn_grabcut_torch" / module
    assert path.is_file()
    assert not _module_level_imports(path) & {"cv2", "jax", "flax", "optax",
                                              "gcn_grabcut_tpu"}


def test_graph_batch_stack_and_pad():
    g = tds.prepare_sample(jds.make_synthetic_dataset(1, HW, seed=4)[0],
                           gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS),
                           device="cpu")[0]
    padded = gt.pad_graph(g, g.max_nodes + 5, g.max_edges + 7)
    both = gt.stack_graphs([padded, padded])
    assert both.n_graphs == 2 and both.max_edges == g.max_edges + 7
    for f in dataclasses.fields(g):
        a, b = getattr(g, f.name), getattr(both, f.name)
        np.testing.assert_array_equal(b[1, :a.shape[1]].numpy(), a[0].numpy())
        assert not b[:, a.shape[1]:].any()
    with pytest.raises(ValueError):
        gt.stack_graphs([g, dataclasses.replace(g, y=None)])


def test_eval_fixture_images_reproduce():
    """The port's generator draws the 512 px hard-synthetic evaluation set
    that tests/data/torch_eval_jax_ref.npz holds JAX's sha1s of (the set
    chip_smoke.py's evaluation phase checks again on the card)."""
    import hashlib
    from chip_smoke import DENSE_HW, EVAL_N, EVAL_REF, EVAL_SEED
    ref = np.load(ROOT / EVAL_REF)
    samples = tds.make_hard_synthetic_dataset(n=EVAL_N, size=DENSE_HW,
                                              seed=EVAL_SEED)
    assert len(samples) == len(ref["image_sha1"]) == EVAL_N
    for s, img_sha, mask_sha in zip(samples, ref["image_sha1"],
                                    ref["mask_sha1"]):
        assert hashlib.sha1(np.ascontiguousarray(s["image"])).hexdigest() \
            == img_sha
        assert hashlib.sha1(np.ascontiguousarray(s["gt_mask"])).hexdigest() \
            == mask_sha
