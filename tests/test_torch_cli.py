"""Port parity for the CLIs: gcn_grabcut_torch.cli.{train, prepare_graphs,
evaluate, inference} against the JAX package's CLIs with the same flags on
the CPU -- the files each writes, what the other package reads back, the
evaluation report and the inference masks; cli.train --model gcn|gat.
Plus ``cli.train --model gcn --devices 2`` under torchrun against the
single-process CLI, the CLIs' refusals (--devices 2 in one process on
the CPU), and without CUDA every CLI needs --cpu.  Images are 64-128 px.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu.cli import evaluate as jeval
from gcn_grabcut_tpu.cli import inference as jinfer
from gcn_grabcut_tpu.cli import prepare_graphs as jprep
from gcn_grabcut_tpu.cli import train as jtrain
from gcn_grabcut_tpu.data import dataset as jds
from gcn_grabcut_tpu.graph_build import SuperpixelGraphConfig as JConfig
from gcn_grabcut_tpu.train import checkpoints as jckpt
from gcn_grabcut_torch.cli import evaluate as teval
from gcn_grabcut_torch.cli import inference as tinfer
from gcn_grabcut_torch.cli import prepare_graphs as tprep
from gcn_grabcut_torch.cli import train as ttrain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "examples/ensemble_r5/bgc_s42.msgpack")
REPORT_TOL = 0.005     # mean IoU of the two packages' evaluation reports
MIN_MASK_IOU = 0.99    # inference masks, port against JAX


@pytest.fixture(autouse=True)
def jax_cache(tmp_path, monkeypatch):
    """The JAX CLIs' compilation cache goes to the test's own folder."""
    monkeypatch.setenv("GCNGC_CACHE_DIR", str(tmp_path / "jax_cache"))


def iou(a, b) -> float:
    a, b = a > 0, b > 0
    return float((a & b).sum() / max((a | b).sum(), 1))


def test_train_cli_writes_jax_file_set(tmp_path):
    args = ["--synthetic", "16", "--epochs", "2", "--hidden", "16",
            "--layers", "2", "--n-segments", "100", "--cpu"]
    th = ttrain.main(args + ["--save-dir", str(tmp_path / "t")])
    jh = jtrain.main(args + ["--save-dir", str(tmp_path / "j")])
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert {"best_model.msgpack", "final_model.msgpack",
            "history.json"} <= set(names)
    saved = json.loads((tmp_path / "t" / "history.json").read_text())
    assert saved.keys() == jh.keys() == th.keys()
    assert all(len(saved[k]) == len(jh[k]) for k in jh)
    assert np.isfinite(saved["train_loss"]).all()
    # JAX rebuilds the port's model from its final checkpoint.
    model, variables, meta = jckpt.load_model_from_checkpoint(
        tmp_path / "t" / "final_model.msgpack")
    assert meta["epoch"] == 2 and meta["model_kwargs"] == dict(
        hidden_channels=16, n_layers=2, dropout=0.2)
    g = jds.prepare_sample(jds.make_synthetic_dataset(1, 64, seed=1)[0],
                           JConfig(n_segments=64))[0]
    logits = np.asarray(model.apply(variables, g, train=False))
    assert logits.shape == (1, g.max_nodes, 3) and np.isfinite(logits).all()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    imgs, masks = root / "imgs", root / "masks"
    imgs.mkdir()
    masks.mkdir()
    for i, s in enumerate(jds.make_synthetic_dataset(3, 64, seed=12)):
        cv2.imwrite(str(imgs / f"s{i}.png"),
                    cv2.cvtColor(s["image"], cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(masks / f"s{i}.png"), s["gt_mask"] * 255)
    return imgs, masks


def test_prepare_graphs_cache_reads_in_jax(pairs, tmp_path, monkeypatch):
    imgs, masks = pairs
    common = ["--images", str(imgs), "--masks", str(masks),
              "--n-segments", "64", "--augment-copies", "1"]
    tprep.main(common + ["--cache-dir", str(tmp_path / "t"), "--cpu"])
    jprep.main(common + ["--cache-dir", str(tmp_path / "j"), "--cpu"])
    # Descriptors whose mask has < 200 pixels in a class are dropped by
    # both packages alike.
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) >= 3
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    # JAX reads every port cache entry without building a graph.
    monkeypatch.setattr(jds, "prepare_sample", None)
    descs = jds.list_image_mask_pairs(imgs, masks, augment_copies=1,
                                      seed=42)
    descs = [d for d in descs if jds.materialise(d) is not None]
    recs = jds.prepare_dataset(descs, JConfig(n_segments=64),
                               cache_dir=tmp_path / "t")
    assert len(recs) == len(names)
    for g, _ in recs:
        assert np.asarray(g.y).dtype == np.int32
        assert np.asarray(g.x).shape[-1] == 19


def test_evaluate_report_matches_jax(tmp_path):
    args = ["--checkpoint", CKPT, "--synthetic", "4", "--bg-connectivity",
            "--n-segments", "100", "--cpu"]
    jr = jeval.main(args + ["--ablation"])
    tr = teval.main(args + ["--ablation", "--out",
                            str(tmp_path / "report.json")])
    assert tr.keys() == jr.keys()
    assert tr["config"] == jr["config"] and tr["n"] == jr["n"] == 4
    assert abs(tr["mean_iou"] - jr["mean_iou"]) <= REPORT_TOL
    for k in ("ablation_region_only_iou", "ablation_guided_filter_iou"):
        assert abs(tr[k] - jr[k]) <= REPORT_TOL
    assert json.loads((tmp_path / "report.json").read_text()) == tr
    # The batched branch (segment_stream) scores the same images.
    tb = teval.main(args + ["--batch", "3"])
    assert tb["n"] == 4
    assert abs(tb["mean_iou"] - jr["mean_iou"]) <= REPORT_TOL


def test_inference_matches_jax(tmp_path):
    folder = tmp_path / "in"
    folder.mkdir()
    for i, s in enumerate(jds.make_synthetic_dataset(2, 96, seed=31)):
        cv2.imwrite(str(folder / f"img{i}.png"),
                    cv2.cvtColor(s["image"], cv2.COLOR_RGB2BGR))
    args = ["--checkpoint", CKPT, "--input", str(folder), "--max-size", "96",
            "--bg-connectivity", "--save", "mask", "overlay", "rgba",
            "trimap", "--cpu"]
    jinfer.main(args + ["--output-dir", str(tmp_path / "j")])
    tinfer.main(args + ["--output-dir", str(tmp_path / "t")])
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 8
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for i in range(2):
        t = cv2.imread(str(tmp_path / "t" / f"img{i}_mask.png"), 0)
        j = cv2.imread(str(tmp_path / "j" / f"img{i}_mask.png"), 0)
        assert t.shape == (96, 96) and iou(t, j) >= MIN_MASK_IOU
    # --batch with --fixed-size: one segment_batch over both images.
    tinfer.main(args + ["--output-dir", str(tmp_path / "b"), "--batch", "2",
                        "--fixed-size", "--max-size", "64"])
    for i in range(2):
        b = cv2.imread(str(tmp_path / "b" / f"img{i}_mask.png"), 0)
        assert b.shape == (96, 96) and 0 < (b > 0).mean() < 1


@pytest.mark.parametrize("args, message", [
    (["--synthetic", "4", "--devices", "2", "--cpu"],
     "--devices 2 but only 1 device"),
])
def test_train_cli_refuses_unported_paths(args, message):
    """One process on the CPU holds one rank: --devices 2 exits with the
    JAX CLI's message (torchrun gives more, test_torch_distributed.py)."""
    with pytest.raises(SystemExit, match=message):
        ttrain.main(args)


@pytest.mark.parametrize("variant", ["gcn", "gat"])
def test_train_cli_trains_variants(tmp_path, variant):
    """--model gcn|gat trains at a tiny width and writes a checkpoint
    whose meta names the variant, which JAX's loader rebuilds."""
    ttrain.main(["--synthetic", "4", "--epochs", "1", "--hidden", "16",
                 "--layers", "2", "--n-segments", "64", "--cpu",
                 "--model", variant, "--save-dir", str(tmp_path)])
    _, _, meta = jckpt.load_checkpoint(tmp_path / "final_model.msgpack")
    assert meta["variant"] == variant
    assert meta["model_kwargs"]["hidden_channels"] == 16
    jmodel, _, _ = jckpt.load_model_from_checkpoint(
        tmp_path / "final_model.msgpack")
    assert type(jmodel).__name__ == {"gcn": "GCNTrimapNet",
                                     "gat": "GATTrimapNet"}[variant]


def test_train_cli_gcn_data_parallel_matches_solo(tmp_path):
    """cli.train --model gcn --devices 2 --cpu under torchrun: two gloo
    processes train GCNTrimapNet with its hidden InputNorms synchronised,
    and reproduce the single-process CLI's history (fp32, dropout on)."""
    import os
    import subprocess
    import sys
    args = ["--synthetic", "8", "--epochs", "2", "--hidden", "16",
            "--layers", "2", "--n-segments", "64", "--batch", "4", "--cpu",
            "--no-bf16", "--model", "gcn", "--prior-dropout", "0.2"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "gcn_grabcut_torch.cli.train", *args,
         "--devices", "2", "--save-dir", str(tmp_path / "dp")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240,
        check=False)
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]
    assert res.stdout.count("data-parallel over 2 device(s)") == 2
    ttrain.main(args + ["--save-dir", str(tmp_path / "solo")])
    dp, solo = (json.loads((tmp_path / d / "history.json").read_text())
                for d in ("dp", "solo"))
    # JAX's data-parallel bars (tests/test_losses_trainer.py).
    np.testing.assert_allclose(dp["train_loss"], solo["train_loss"],
                               rtol=2e-4)
    np.testing.assert_allclose(dp["val_score"], solo["val_score"],
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("cli, args", [
    (ttrain, ["--synthetic", "4"]),
    (tprep, ["--images", ".", "--masks", ".", "--cache-dir", "."]),
    (teval, ["--checkpoint", CKPT, "--synthetic", "1"]),
    (tinfer, ["--checkpoint", CKPT, "--input", "."]),
])
def test_clis_need_cuda_unless_cpu_is_asked(cli, args):
    if torch.cuda.is_available():
        return       # the CLIs run on the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)
