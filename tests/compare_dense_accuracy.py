#!/usr/bin/env python3
"""Accuracy of the port against the JAX package at the recommended
settings, on the CPU: the hard-synthetic evaluation set of
``gcn_grabcut_tpu.cli.evaluate --hard-synthetic N --hard-size 512``
(synthetic seed 777), n_segments=500 with the geodesic prior, θ 0.65,
guided-filter radius 4, ms_scales (1.0, 0.75), the bgc_s4{2,3,4} ensemble.

    JAX_PLATFORMS=cpu python tests/compare_dense_accuracy.py --n 60 \\
        --out accuracy.json

Each image goes through both packages' `segment` (the call the evaluate
CLI makes, one image at a time).  Reported: each side's mean IoU against
ground truth (the CLI's metric), and the per-image mask IoU of the port
against JAX.  These are accuracy numbers; the seconds are CPU wall times.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import gcn_grabcut_torch as gt  # noqa: E402
from gcn_grabcut_tpu import GCNGrabCutPipeline, SuperpixelGraphConfig  # noqa: E402
from gcn_grabcut_tpu.data.dataset import make_hard_synthetic_dataset  # noqa: E402
from gcn_grabcut_tpu.metrics import evaluate  # noqa: E402
from gcn_grabcut_tpu.train.checkpoints import load_model_auto  # noqa: E402

ENSEMBLE = ",".join(f"examples/ensemble_r5/bgc_s4{i}.msgpack"
                    for i in (2, 3, 4))
SETTINGS = dict(threshold_fg=0.65, threshold_bg=0.65, filter_radius=4,
                ms_scales=(1.0, 0.75))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=60)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)

    paths = ",".join(str(ROOT / q) for q in ENSEMBLE.split(","))
    jmodel, jvars, _ = load_model_auto(paths)
    jpipe = GCNGrabCutPipeline(jmodel, jvars, SuperpixelGraphConfig(
        n_segments=500, bg_connectivity=True))
    tmodel, _ = gt.load_model_auto(paths, device="cpu")
    tpipe = gt.GCNGrabCutPipeline(tmodel, gt.SuperpixelGraphConfig(
        n_segments=500, bg_connectivity=True), device="cpu")

    samples = make_hard_synthetic_dataset(n=args.n, size=args.size,
                                          seed=args.seed)
    rows = []
    for i, s in enumerate(samples):
        img, gt_mask = s["image"], s["gt_mask"]
        t = time.perf_counter()
        jmask = jpipe.segment(img, **SETTINGS).binary_mask
        t_jax = time.perf_counter() - t
        t = time.perf_counter()
        tmask = tpipe.segment(img, **SETTINGS).binary_mask
        t_port = time.perf_counter() - t
        a, b = jmask > 0, tmask > 0
        rows.append({
            "name": s["name"],
            "jax_iou": float(evaluate(jmask, gt_mask).iou),
            "port_iou": float(evaluate(tmask, gt_mask).iou),
            "port_vs_jax_iou": float((a & b).sum() / max((a | b).sum(), 1)),
            "jax_cpu_s": t_jax, "port_cpu_s": t_port})
        print(json.dumps(dict(i=i, **rows[-1])), flush=True)

    def col(key):
        return np.array([r[key] for r in rows])

    report = {
        "n": len(rows), "size": args.size, "synthetic_seed": args.seed,
        "checkpoint": ENSEMBLE, "settings": {**SETTINGS, "n_segments": 500,
                                             "bg_connectivity": True},
        "jax_mean_iou": float(col("jax_iou").mean()),
        "port_mean_iou": float(col("port_iou").mean()),
        "port_vs_jax_iou_mean": float(col("port_vs_jax_iou").mean()),
        "port_vs_jax_iou_min": float(col("port_vs_jax_iou").min()),
        "images_identical": int((col("port_vs_jax_iou") == 1.0).sum()),
        "jax_cpu_s_mean": float(col("jax_cpu_s").mean()),
        "port_cpu_s_mean": float(col("port_cpu_s").mean()),
        "images": rows,
    }
    summary = {k: v for k, v in report.items() if k != "images"}
    print(json.dumps(summary, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
