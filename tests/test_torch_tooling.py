"""Port parity for the tooling: gcn_grabcut_torch.config (the config
tests of tests/test_config_hints.py against the port, and files written
by either package read by the other), utils (profile_trace on
torch.profiler, trace_span) and visualise (the five plots, and the cv2
report grid byte for byte against the JAX package's).  64 px arrays.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu import visualise as jvis
from gcn_grabcut_tpu.config import FrameworkConfig as JConfig
from gcn_grabcut_torch import utils, visualise
from gcn_grabcut_torch.config import FrameworkConfig

torch.set_num_threads(1)

SIZE = 64


class TestConfig:
    def test_defaults(self):
        cfg = FrameworkConfig()
        assert cfg.superpixels.n_segments == 300
        assert cfg.grabcut.gamma == 50.0
        assert cfg.train.lr == 1e-3
        assert cfg.model.variant == "resgcn"
        assert cfg.to_dict() == JConfig().to_dict()

    def test_yaml_roundtrip(self, tmp_path):
        cfg = FrameworkConfig()
        cfg.train.lr = 5e-4
        cfg.save(tmp_path / "cfg.yaml")
        loaded = FrameworkConfig.load(tmp_path / "cfg.yaml")
        assert loaded.train.lr == 5e-4
        assert loaded.to_dict() == cfg.to_dict()

    def test_json_roundtrip(self, tmp_path):
        cfg = FrameworkConfig()
        cfg.model.hidden_channels = 96
        cfg.save(tmp_path / "cfg.json")
        loaded = FrameworkConfig.load(tmp_path / "cfg.json")
        assert loaded.model.hidden_channels == 96
        assert loaded.to_dict() == cfg.to_dict()

    def test_dotted_overrides(self):
        cfg = FrameworkConfig.load(
            overrides=["train.lr=3e-4", "superpixels.n_segments=500",
                       "inference.keep_largest=true"])
        assert cfg.train.lr == pytest.approx(3e-4)
        assert cfg.superpixels.n_segments == 500
        assert cfg.inference.keep_largest is True
        as_dict = FrameworkConfig.load(overrides={"train.lr": 3e-4})
        assert as_dict.train.lr == 3e-4

    @pytest.mark.parametrize("bad", [["train.nonsense=1"], ["nowhere.lr=1"],
                                     {"model.depth": 3}])
    def test_unknown_key_raises(self, bad):
        with pytest.raises(KeyError):
            FrameworkConfig.load(overrides=bad)

    def test_unknown_file_section_raises(self, tmp_path):
        (tmp_path / "cfg.json").write_text(json.dumps({"serving": {}}))
        with pytest.raises(KeyError):
            FrameworkConfig.load(tmp_path / "cfg.json")

    def test_frozen_superpixel_config_still_overridable(self):
        cfg = FrameworkConfig.load(overrides=["superpixels.compactness=20"])
        assert cfg.superpixels.compactness == 20.0


def edited(cls):
    """A FrameworkConfig of `cls` with a non-default value in every
    section, the frozen one and a tuple among them."""
    return cls.load(overrides={
        "superpixels.n_segments": 777, "superpixels.bg_connectivity": True,
        "grabcut.color_space": "lab", "model.variant": "gat",
        "train.lr": 2.5e-4, "train.class_weights": (1.0, 2.0, 3.0),
        "train.log_dir": "runs/x", "inference.filter_radius": 6})


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
@pytest.mark.parametrize("writer,reader", [(JConfig, FrameworkConfig),
                                           (FrameworkConfig, JConfig)],
                         ids=["jax_to_port", "port_to_jax"])
def test_config_files_cross_packages(tmp_path, suffix, writer, reader):
    written = edited(writer)
    written.save(tmp_path / f"cfg{suffix}")
    loaded = reader.load(tmp_path / f"cfg{suffix}")
    assert loaded.to_dict() == written.to_dict()
    assert loaded.train.class_weights == (1.0, 2.0, 3.0)


def test_profile_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with utils.profile_trace(None):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with utils.profile_trace(log_dir):
        with utils.trace_span("serve_batch"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "serve_batch" in names
    assert any("mm" in str(n) for n in names)


@pytest.fixture(scope="module")
def panels():
    """A seeded image, a trimap with all four labels, a mask, a 4x4 grid
    of superpixels with its centroids and edges."""
    r = np.random.RandomState(0)
    img = r.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    trimap = r.randint(0, 4, (SIZE, SIZE)).astype(np.uint8)
    mask = (trimap % 2).astype(np.uint8)
    segments = (np.arange(SIZE)[:, None] // 16) * 4 \
        + np.arange(SIZE)[None, :] // 16
    cells = np.arange(16)
    centroids = np.stack([(cells // 4 + 0.5) / 4, (cells % 4 + 0.5) / 4], 1)
    src = np.concatenate([cells[:-1], cells[1:]])
    dst = np.concatenate([cells[1:], cells[:-1]])
    return dict(image=img, trimap=trimap, binary_mask=mask, gt_mask=1 - mask,
                segments=segments, centroids=centroids, src=src, dst=dst)


PLOTS = {
    "training_curves": lambda p, out: visualise.plot_training_curves(
        {"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.6],
         "val_acc": [0.5, 0.7], "val_iou_fg": [0.3, 0.4],
         "lr": [1e-3, 5e-4]}, out),
    "trimap_comparison": lambda p, out: visualise.plot_trimap_comparison(
        p["image"], p["trimap"], p["gt_mask"], p["binary_mask"], out),
    "superpixel_graph": lambda p, out: visualise.plot_superpixel_graph(
        p["image"], p["segments"], p["centroids"], p["src"], p["dst"],
        np.ones(len(p["src"])), out, node_values=np.linspace(0, 1, 16)),
    "confusion_matrix": lambda p, out: visualise.plot_confusion_matrix(
        p["trimap"].ravel() % 3, p["binary_mask"].ravel() * 2, out),
    "research_report": lambda p, out: visualise.save_research_report(
        [dict(p, title="a"), {k: p[k] for k in ("image", "trimap",
                                                "binary_mask")}], out),
}


@pytest.mark.parametrize("plot", sorted(PLOTS))
def test_plot_writes_a_png(panels, tmp_path, plot):
    out = tmp_path / f"{plot}.png"
    PLOTS[plot](panels, out)
    img = cv2.imread(str(out))
    assert img is not None and img.size > 0 and img.std() > 0


def test_report_grid_equals_jax_byte_for_byte(panels, tmp_path):
    rows = [panels, dict(panels, image=panels["image"][:, :48],
                         trimap=panels["trimap"][:, :48],
                         binary_mask=panels["binary_mask"][:, :48])]
    visualise._report_cv2(rows, tmp_path / "port.png")
    jvis._report_cv2(rows, tmp_path / "jax.png")
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    grid = cv2.imread(str(tmp_path / "port.png"))
    assert grid.shape == (2 * 192, 3 * 144, 3)


def test_report_falls_back_to_cv2_without_matplotlib(panels, tmp_path,
                                                     monkeypatch):
    def no_matplotlib():
        raise ImportError("No module named 'matplotlib'")
    monkeypatch.setattr(visualise, "_plt", no_matplotlib)
    visualise.save_research_report([panels], tmp_path / "report.png")
    visualise._report_cv2([panels], tmp_path / "grid.png")
    assert (tmp_path / "report.png").read_bytes() == \
        (tmp_path / "grid.png").read_bytes()
