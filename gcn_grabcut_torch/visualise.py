"""Visualisation: training curves, trimap comparison panels,
superpixel-graph overlays, confusion matrices and multi-sample report
grids.  Counterpart of ``gcn_grabcut_tpu/visualise.py``, on numpy arrays
as there (pass ``.cpu().numpy()`` of a tensor); nothing here touches the
card.

Matplotlib is imported lazily with the Agg backend, so headless machines
work; when it is not installed, ``save_research_report`` draws its grid
with cv2 instead, as the JAX package does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .pipeline import colour_trimap


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_training_curves(history: dict, save_path: str | Path) -> None:
    """Loss / accuracy / per-class IoU / LR curves."""
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))

    ax = axes[0, 0]
    ax.plot(history.get("train_loss", []), label="train")
    if history.get("val_loss"):
        ax.plot(history["val_loss"], label="val")
    ax.set_title("Loss"), ax.set_xlabel("epoch"), ax.legend()

    ax = axes[0, 1]
    if history.get("val_acc"):
        ax.plot(history["val_acc"])
    ax.set_title("Validation accuracy"), ax.set_xlabel("epoch")

    ax = axes[1, 0]
    for key, label in (("val_iou_bg", "BG"), ("val_iou_unk", "UNK"),
                       ("val_iou_fg", "FG"), ("val_score", "score")):
        if history.get(key):
            ax.plot(history[key], label=label)
    ax.set_title("Per-class IoU"), ax.set_xlabel("epoch"), ax.legend()

    ax = axes[1, 1]
    if history.get("lr"):
        ax.plot(history["lr"])
        ax.set_yscale("log")
    ax.set_title("Learning rate"), ax.set_xlabel("epoch")

    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def plot_trimap_comparison(image: np.ndarray, pred_trimap: np.ndarray,
                           gt_mask: Optional[np.ndarray],
                           binary_mask: Optional[np.ndarray],
                           save_path: str | Path) -> None:
    """Input | predicted trimap | (GT) | (final mask) panel row."""
    plt = _plt()
    panels = [("input", image), ("trimap", colour_trimap(pred_trimap))]
    if gt_mask is not None:
        panels.append(("ground truth", gt_mask * 255))
    if binary_mask is not None:
        panels.append(("mask", binary_mask * 255))
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(img, cmap=None if img.ndim == 3 else "gray")
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def plot_graph_overlay(image: np.ndarray, segments: np.ndarray,
                       centroids: np.ndarray, edge_src: np.ndarray,
                       edge_dst: np.ndarray, edge_mask: np.ndarray,
                       save_path: str | Path,
                       node_values: Optional[np.ndarray] = None) -> None:
    """Superpixel boundaries and graph edges (the first 2000 real ones)
    over the image; `centroids` (K, 2) are (row, col) fractions."""
    plt = _plt()
    H, W = segments.shape
    bound = np.zeros_like(segments, bool)
    bound[1:, :] |= segments[1:, :] != segments[:-1, :]
    bound[:, 1:] |= segments[:, 1:] != segments[:, :-1]
    vis = image.copy()
    vis[bound] = [255, 255, 0]

    fig, ax = plt.subplots(figsize=(8, 8 * H / W))
    ax.imshow(vis)
    em = np.asarray(edge_mask) > 0
    src, dst = np.asarray(edge_src)[em], np.asarray(edge_dst)[em]
    cy = centroids[:, 0] * H
    cx = centroids[:, 1] * W
    for s, d in zip(src[:2000], dst[:2000]):
        ax.plot([cx[s], cx[d]], [cy[s], cy[d]], "c-", lw=0.3, alpha=0.4)
    c = node_values if node_values is not None else "r"
    ax.scatter(cx, cy, c=c, s=8, cmap="coolwarm")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def plot_confusion_matrix(preds: np.ndarray, labels: np.ndarray,
                          save_path: str | Path,
                          class_names: Sequence[str] = ("BG", "UNK", "FG")
                          ) -> None:
    """Row-normalised node-class confusion matrix."""
    plt = _plt()
    n = len(class_names)
    cm = np.zeros((n, n))
    for t in range(n):
        for p in range(n):
            cm[t, p] = np.sum((labels == t) & (preds == p))
    cm_norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)

    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cm_norm, cmap="Blues", vmin=0, vmax=1)
    for t in range(n):
        for p in range(n):
            ax.text(p, t, f"{cm_norm[t, p]:.2f}\n({int(cm[t, p])})",
                    ha="center", va="center", fontsize=9)
    ax.set_xticks(range(n), class_names)
    ax.set_yticks(range(n), class_names)
    ax.set_xlabel("predicted"), ax.set_ylabel("true")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def save_research_report(results: list, save_path: str | Path,
                         max_samples: int = 8) -> None:
    """Multi-sample grid: image / trimap / mask / (gt) per row, drawn with
    cv2 when matplotlib is not installed.

    `results` entries: dicts with image, trimap, binary_mask, optional
    gt_mask and title.
    """
    results = results[:max_samples]
    try:
        plt = _plt()
    except ImportError:
        _report_cv2(results, save_path)
        return

    cols = 4 if any("gt_mask" in r for r in results) else 3
    fig, axes = plt.subplots(len(results), cols,
                             figsize=(3.2 * cols, 3 * len(results)))
    axes = np.atleast_2d(axes)
    for i, r in enumerate(results):
        row = [("input", r["image"]),
               ("trimap", colour_trimap(r["trimap"])),
               ("mask", r["binary_mask"] * 255)]
        if cols == 4:
            row.append(("GT", r.get("gt_mask", np.zeros_like(
                r["binary_mask"])) * 255))
        for j, (title, img) in enumerate(row):
            ax = axes[i, j]
            ax.imshow(img, cmap=None if img.ndim == 3 else "gray")
            if i == 0:
                ax.set_title(title)
            ax.axis("off")
        if "title" in r:
            axes[i, 0].set_ylabel(r["title"], fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def _report_cv2(results: list, save_path: str | Path) -> None:
    """Rows of image | trimap | mask, each resized to 192 px high, cropped
    to the narrowest row."""
    import cv2

    def rs(img, h=192):
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        return cv2.resize(img.astype(np.uint8),
                          (int(h * img.shape[1] / img.shape[0]), h))

    rows = [np.concatenate([rs(r["image"]), rs(colour_trimap(r["trimap"])),
                            rs(r["binary_mask"] * 255)], axis=1)
            for r in results]
    w = min(r.shape[1] for r in rows)
    grid = np.concatenate([r[:, :w] for r in rows], axis=0)
    cv2.imwrite(str(save_path), cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))


#: The reference's name for plot_graph_overlay.
plot_superpixel_graph = plot_graph_overlay
