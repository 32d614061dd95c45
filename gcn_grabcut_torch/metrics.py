"""Evaluation metrics: segmentation (IoU / Dice / P / R / F1 / BF1) and
trimap quality.

Counterpart of ``gcn_grabcut_tpu/metrics.py``.  Masks come in as numpy
arrays or tensors and are reduced where they lie.  The boundary of a mask
is the mask minus its erosion by a (2w+1)^2 square whose window stops at
the image edge (the JAX package's ``reduce_window(min)`` with init 1.0 and
"SAME" padding), so the image border itself is not a boundary; the
boundary F1 ratios are computed in float32, as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .core.graph import TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_BG, TRIMAP_PROB_FG


@dataclasses.dataclass
class SegmentationMetrics:
    iou: float
    dice: float
    precision: float
    recall: float
    f1: float
    pixel_accuracy: float
    boundary_f1: float = 0.0

    def __str__(self) -> str:
        return (f"IoU={self.iou:.4f}  Dice={self.dice:.4f}  "
                f"Prec={self.precision:.4f}  Rec={self.recall:.4f}  "
                f"F1={self.f1:.4f}  PixAcc={self.pixel_accuracy:.4f}  "
                f"BF1={self.boundary_f1:.4f}")

    def as_dict(self) -> dict:
        return {k: round(float(v), 4)
                for k, v in dataclasses.asdict(self).items()}


@dataclasses.dataclass
class TrimapMetrics:
    fg_recall: float
    fg_precision: float
    bg_recall: float
    bg_precision: float
    bg_contamination: float
    unknown_fraction: float
    trimap_accuracy: float

    def __str__(self) -> str:
        return (f"FG_rec={self.fg_recall:.3f}  FG_prec={self.fg_precision:.3f}"
                f"  BG_rec={self.bg_recall:.3f}  "
                f"BG_cont={self.bg_contamination:.3f}  "
                f"Unk={self.unknown_fraction:.3f}  "
                f"Acc={self.trimap_accuracy:.3f}")

    def as_dict(self) -> dict:
        return {k: round(float(v), 4)
                for k, v in dataclasses.asdict(self).items()}


def _erode(m: torch.Tensor, width: int) -> torch.Tensor:
    """Binary erosion of (H, W) float32 `m` with a (2w+1)^2 square; the
    window is padded with 1.0, so the image edge does not erode."""
    k = 2 * width + 1
    padded = F.pad(m[None, None], (width,) * 4, value=1.0)
    return -F.max_pool2d(-padded, k, stride=1)[0, 0]


def _as_tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))


def boundary_f1(pred, gt, width: int = 3) -> float:
    """Boundary alignment F1 with a width-pixel tolerance."""
    def boundary(m):
        m = _as_tensor(m).float()
        return (m - _erode(m, width)) > 0

    pb, gb = boundary(pred), boundary(gt)
    tp = (pb & gb).sum().float()
    prec = tp / (pb.sum().float() + 1e-8)
    rec = tp / (gb.sum().float() + 1e-8)
    return float(2 * prec * rec / (prec + rec + 1e-8))


def evaluate(pred, gt, boundary_width: int = 3) -> SegmentationMetrics:
    """Full binary segmentation metrics."""
    p, g = _as_tensor(pred).bool(), _as_tensor(gt).bool()
    tp, fp, fn, tn = (float(x.sum()) for x in (p & g, p & ~g, ~p & g,
                                               ~p & ~g))
    iou = tp / (tp + fp + fn + 1e-8)
    dice = 2 * tp / (2 * tp + fp + fn + 1e-8)
    precision = tp / (tp + fp + 1e-8)
    recall = tp / (tp + fn + 1e-8)
    f1 = 2 * precision * recall / (precision + recall + 1e-8)
    pix_acc = (tp + tn) / (tp + tn + fp + fn + 1e-8)
    bf1 = boundary_f1(pred, gt, boundary_width) if boundary_width > 0 else 0.0
    return SegmentationMetrics(iou=iou, dice=dice, precision=precision,
                               recall=recall, f1=f1, pixel_accuracy=pix_acc,
                               boundary_f1=bf1)


def evaluate_trimap(trimap, gt_mask) -> TrimapMetrics:
    """Trimap quality against a binary ground-truth mask."""
    trimap = np.asarray(trimap)
    gt = np.asarray(gt_mask).astype(bool)
    n = gt.size

    pred_fg = trimap == TRIMAP_FG
    pred_bg = trimap == TRIMAP_BG
    pred_pfg = trimap == TRIMAP_PROB_FG
    pred_pbg = trimap == TRIMAP_PROB_BG

    fg_tp = (pred_fg & gt).sum()
    fg_fp = (pred_fg & ~gt).sum()
    fg_fn = (~pred_fg & gt).sum()
    bg_tp = (pred_bg & ~gt).sum()
    bg_fp = (pred_bg & gt).sum()
    bg_fn = (~pred_bg & ~gt).sum()
    pred_bin = pred_fg | pred_pfg

    return TrimapMetrics(
        fg_recall=float(fg_tp / (fg_tp + fg_fn + 1e-8)),
        fg_precision=float(fg_tp / (fg_tp + fg_fp + 1e-8)),
        bg_recall=float(bg_tp / (bg_tp + bg_fn + 1e-8)),
        bg_precision=float(bg_tp / (bg_tp + bg_fp + 1e-8)),
        bg_contamination=float(fg_fp / n),
        unknown_fraction=float((pred_pfg | pred_pbg).sum() / n),
        trimap_accuracy=float((pred_bin.ravel() == gt.ravel()).mean()),
    )


#: Aggregate keys of `evaluate_batch`, each mapped to the
#: SegmentationMetrics field it summarises.
_BATCH_FIELDS = {"iou": "iou", "dice": "dice", "bf1": "boundary_f1"}


def evaluate_batch(results: list[dict]) -> dict:
    """Mean and std of per-sample metrics over result dicts carrying
    ``binary_mask`` and ``gt_mask`` arrays."""
    per_sample = [evaluate(r["binary_mask"], r["gt_mask"]) for r in results]
    table = np.array(
        [[getattr(m, attr) for attr in _BATCH_FIELDS.values()]
         for m in per_sample],
        dtype=np.float64).reshape(len(per_sample), len(_BATCH_FIELDS))
    zeros = np.zeros(len(_BATCH_FIELDS))
    means = table.mean(axis=0) if len(per_sample) else zeros
    stds = table.std(axis=0) if len(per_sample) else zeros
    summary: dict = {"n": len(per_sample)}
    for col, key in enumerate(_BATCH_FIELDS):
        summary[f"mean_{key}"] = float(means[col])
        summary[f"std_{key}"] = float(stds[col])
    return summary
