"""Evaluation CLI: run the full pipeline over a dataset and report the
headline metrics (mean/median IoU, Pr[IoU>0.5/0.7], Dice, BF1), optionally
with the ablation rows (region-level only / + guided filter).
Counterpart of ``gcn_grabcut_tpu/cli/evaluate.py``: the same flags and the
same report keys; runs on the card unless --cpu.

Works on an images/masks directory pair (DUTS layout), --synthetic N or
--hard-synthetic N.

    python -m gcn_grabcut_torch.cli.evaluate \\
        --checkpoint examples/ensemble_r5/bgc_s42.msgpack,...s43...,...s44... \\
        --hard-synthetic 60 --hard-size 512 --batch 8 --bg-connectivity
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained model")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint path, or comma-separated paths to run "
                        "the inference ensemble")
    p.add_argument("--images", type=str, default=None)
    p.add_argument("--masks", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--hard-synthetic", type=int, default=0,
                   help="evaluate on N held-out hard-synthetic samples")
    p.add_argument("--hard-size", type=int, default=192)
    p.add_argument("--synthetic-seed", type=int, default=777)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--n-segments", type=int, default=500)
    p.add_argument("--bg-connectivity", action="store_true",
                   help="geodesic boundary-connectivity bg prior cue "
                        "(use the same setting the checkpoint was "
                        "trained with)")
    p.add_argument("--max-size", type=int, default=512)
    p.add_argument("--threshold", type=float, default=0.65)
    p.add_argument("--filter-radius", type=int, default=4)
    p.add_argument("--keep-largest", action="store_true")
    p.add_argument("--ms-scales", type=str, default="1.0,0.75",
                   help="comma-separated inference scales, first must be "
                        "1.0: per-scale class planes are averaged before "
                        "thresholding; 'none' disables multi-scale")
    p.add_argument("--batch", type=int, default=0,
                   help="segment in batches of this size (same-size images)")
    p.add_argument("--ablation", action="store_true",
                   help="also score region-only and +guided-filter variants")
    p.add_argument("--out", type=str, default=None,
                   help="write the metrics JSON here")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..core.device import resolve_device
    from ..data.dataset import (
        list_image_mask_pairs, make_hard_synthetic_dataset,
        make_synthetic_dataset, materialise)
    from ..graph_build import SuperpixelGraphConfig, build_graph
    from ..metrics import evaluate
    from ..pipeline import GCNGrabCutPipeline, refine_trimap
    from ..train.checkpoints import load_model_auto

    device = resolve_device("cpu" if args.cpu else None)
    model, meta = load_model_auto(args.checkpoint, device=device)
    if meta.get("ensemble_size", 1) > 1:
        print(f"[Eval] ensemble of {meta['ensemble_size']} checkpoints")
    sp_cfg = SuperpixelGraphConfig(n_segments=args.n_segments,
                                   bg_connectivity=args.bg_connectivity)
    pipe = GCNGrabCutPipeline(model, sp_cfg, device=device)
    ms_scales = (tuple(float(s) for s in args.ms_scales.split(","))
                 if args.ms_scales and args.ms_scales.lower() != "none"
                 else None)

    if args.hard_synthetic:
        samples = make_hard_synthetic_dataset(
            n=args.hard_synthetic, size=args.hard_size,
            seed=args.synthetic_seed)
    elif args.synthetic:
        samples = make_synthetic_dataset(n=args.synthetic,
                                         seed=args.synthetic_seed)
    else:
        if not (args.images and args.masks):
            raise SystemExit("--images/--masks or --synthetic required")
        samples = list_image_mask_pairs(args.images, args.masks,
                                        max_size=args.max_size)
    if args.limit:
        samples = samples[:args.limit]

    ious, dices, bf1s, times = [], [], [], []
    abl_region, abl_guided = [], []

    mats = [m for m in (materialise(s) for s in samples) if m is not None]

    if args.batch > 1:
        # Batched path: same-shape images go through segment_stream.
        groups: dict = {}
        for m in mats:
            groups.setdefault(m["image"].shape[:2], []).append(m)
        for group in groups.values():
            t0 = time.perf_counter()
            rs = list(pipe.segment_stream(
                [c["image"] for c in group], batch_size=args.batch,
                threshold_fg=args.threshold, threshold_bg=args.threshold,
                keep_largest=args.keep_largest,
                filter_radius=args.filter_radius, want_segments=False,
                ms_scales=ms_scales))
            dt = (time.perf_counter() - t0) / len(group)
            for r, c in zip(rs, group):
                m = evaluate(r.binary_mask, c["gt_mask"])
                ious.append(m.iou)
                dices.append(m.dice)
                bf1s.append(m.boundary_f1)
                times.append(dt)
        mats = []   # the per-image loop below is skipped

    for i, mat in enumerate(mats):
        img, gt = mat["image"], mat["gt_mask"]
        t0 = time.perf_counter()
        res = pipe.segment(
            img, threshold_fg=args.threshold, threshold_bg=args.threshold,
            keep_largest=args.keep_largest,
            filter_radius=args.filter_radius, ms_scales=ms_scales)
        times.append(time.perf_counter() - t0)
        m = evaluate(res.binary_mask, gt)
        ious.append(m.iou)
        dices.append(m.dice)
        bf1s.append(m.boundary_f1)

        if args.ablation:
            graph = build_graph(img, sp_cfg, device=device)
            probs = pipe.predict_probs(graph)
            # region-level decision only (argmax FG vs BG, no filter or
            # GrabCut)
            region_mask = (probs[:, 2] > probs[:, 0]).astype(
                np.uint8)[graph.segments]
            abl_region.append(evaluate(region_mask, gt,
                                       boundary_width=0).iou)
            # + guided filter (the refined trimap's FG sides)
            tri = refine_trimap(probs, graph.segments, img,
                                args.threshold, args.threshold,
                                radius=args.filter_radius, device=device)
            guided_mask = np.isin(tri, (1, 3)).astype(np.uint8)
            abl_guided.append(evaluate(guided_mask, gt,
                                       boundary_width=0).iou)

        if (i + 1) % 10 == 0:
            print(f"[Eval] {i + 1}/{len(samples)}  "
                  f"running mean IoU {np.mean(ious):.4f}")

    ious_np = np.asarray(ious)
    report = {
        "n": len(ious),
        "mean_iou": float(ious_np.mean()),
        "median_iou": float(np.median(ious_np)),
        "p_iou_gt_0.5": float((ious_np > 0.5).mean()),
        "p_iou_gt_0.7": float((ious_np > 0.7).mean()),
        "mean_dice": float(np.mean(dices)),
        "mean_bf1": float(np.mean(bf1s)),
        "mean_seconds_per_image": float(np.mean(times)),
        "checkpoint": str(args.checkpoint),
        "config": {"n_segments": args.n_segments,
                   "threshold": args.threshold,
                   "filter_radius": args.filter_radius,
                   "keep_largest": args.keep_largest},
    }
    if args.ablation:
        report["ablation_region_only_iou"] = float(np.mean(abl_region))
        report["ablation_guided_filter_iou"] = float(np.mean(abl_guided))
    print(json.dumps(report, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
