"""Port parity for the slice as a whole: gcn_grabcut_torch's
GCNGrabCutPipeline.segment_batch against the JAX pipeline at 320x320 with
2600 superpixels (K = 2601 > 2048: the banded-SpMM large path), with the
JAX model's weights converted to the port.  Plus the port's import rule
and its no-silent-CPU rule.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.random as jr

from gcn_grabcut_tpu import (GCNGrabCutPipeline as JaxPipeline,
                             SuperpixelGraphConfig as JaxConfig,
                             build_graph, build_model, init_model)
import gcn_grabcut_torch as gt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_SEGMENTS = 2600
PROBS_ATOL = 1e-3   # both sides contract in bf16; other summation orders
# Both sides' forwards contract in bf16 and may flip near-threshold
# pixels, which GrabCut spreads a little; measured IoU 0.9998 here.
MIN_IOU = 0.99


def blob_image(H=320, W=320, seed=5):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = (r.rand(H, W, 3) * 80).astype(np.uint8)
    blob = ((yy - 160) ** 2 + (xx - 150) ** 2) < 90 ** 2
    img[blob] = (200 + r.rand(blob.sum(), 3) * 50).astype(np.uint8)
    return img


@pytest.fixture(scope="module")
def runs():
    img = blob_image()
    cfg = JaxConfig(n_segments=N_SEGMENTS)
    graph = build_graph(img, cfg)
    # Init seed 1 gives a trimap with BG, probable-BG and probable-FG
    # regions, so GrabCut has real work.
    model = build_model("resgcn", hidden_channels=16, n_layers=2)
    variables = init_model(model, jr.PRNGKey(1), graph.graph)
    jres = JaxPipeline(model, variables, sp_config=cfg).segment_batch(
        [img])[0]
    jprobs = JaxPipeline(model, variables, sp_config=cfg).predict_probs(graph)
    pipe = gt.GCNGrabCutPipeline(
        gt.resgcn_from_jax(variables),
        gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS), device="cpu")
    tres = pipe.segment_batch([img])[0]
    return img, graph, jres, jprobs, tres


def test_segment_batch_mask_iou(runs):
    img, _, jres, _, tres = runs
    a, b = jres.binary_mask > 0, tres.binary_mask > 0
    iou = (a & b).sum() / max((a | b).sum(), 1)
    print(f"segment_batch mask IoU vs JAX: {iou:.6f} "
          f"(FG {a.mean():.4f} / {b.mean():.4f})")
    assert tres.binary_mask.shape == img.shape[:2]
    assert 0.0 < b.mean() < 1.0
    assert iou >= MIN_IOU


def test_segment_batch_probs_where_segments_agree(runs):
    _, graph, jres, jprobs, tres = runs
    k = graph.n_nodes
    js, ts = jres.segments.ravel(), tres.segments.ravel()
    # A node agrees when its pixel set is the same in both label maps.
    differ = js != ts
    bad = np.zeros(k, bool)
    bad[js[differ]] = True
    bad[ts[differ]] = True
    valid = (np.asarray(graph.node_mask) > 0) & ~bad
    assert valid.sum() > 0.99 * (np.asarray(graph.node_mask) > 0).sum()
    assert tres.probs.shape == (k, 3)
    np.testing.assert_allclose(tres.probs[valid], jprobs[valid],
                               atol=PROBS_ATOL)


def test_segment_batch_trimap_and_timing(runs):
    _, _, jres, _, tres = runs
    assert float((tres.trimap == jres.trimap).mean()) >= 0.999
    assert set(tres.timing) == {"graph_build", "gcn_inference", "grabcut",
                                "postprocess"}
    assert tres.rgba.shape[-1] == 4 and tres.overlay.dtype == np.uint8


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_no_jax():
    files = sorted((ROOT / "gcn_grabcut_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "profile_port.py"]
    assert len(files) > 10
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "msgpack",
                             "gcn_grabcut_tpu"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    model = gt.ResGCNNet(hidden_channels=16, n_layers=2)
    rgbs = np.zeros((1, 64, 64, 3), np.uint8)
    if torch.cuda.is_available():
        assert gt.GCNGrabCutPipeline(model).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.GCNGrabCutPipeline(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.build_graph_batch_arrays(rgbs)


def test_dense_entry_points_need_cuda_unless_cpu_is_asked():
    """The 500-superpixel path's entry points: the checkpoint loader, the
    pipeline and the graph build at K = 484 with the geodesic prior."""
    ckpt = str(ROOT / "examples/ensemble_r5/bgc_s42.msgpack")
    cfg = gt.SuperpixelGraphConfig(n_segments=500, bg_connectivity=True)
    rgbs = np.zeros((1, 128, 128, 3), np.uint8)
    if torch.cuda.is_available():
        assert gt.load_model_auto(ckpt)[0].head.weight.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.load_model_auto(ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.GCNGrabCutPipeline(gt.ResGCNNet(hidden_channels=16, n_layers=2),
                              cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.build_graph_batch_arrays(rgbs, cfg)
    model, meta = gt.load_model_auto(ckpt, device="cpu")
    assert meta["ensemble_size"] == 1 and not model.head.weight.is_cuda
    out = gt.build_graph_batch_arrays(rgbs, cfg, device="cpu")
    assert out["x"].shape == (1, 484, 19)
