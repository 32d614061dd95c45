#!/usr/bin/env python3
"""Build tests/data/torch_eval_jax_ref.npz: the JAX package's evaluation
CLI on the 512 px hard-synthetic set, the run chip_smoke.py's evaluation
phase holds the port's CLI against:

    python -m gcn_grabcut_tpu.cli.evaluate --checkpoint <bgc_s4{2,3,4}> \\
        --hard-synthetic EVAL_N --hard-size DENSE_HW --batch EVAL_BATCH \\
        --bg-connectivity            (synthetic seed EVAL_SEED, θ 0.65,
                                      radius 4, ms_scales 1.0,0.75)

    JAX_PLATFORMS=cpu python tests/make_torch_eval_jax_ref.py

The file holds, per image of the generated set: the sha1 of the image and
of its ground-truth mask (`image_sha1`, `mask_sha1`), JAX's mask packed
with np.packbits over its pixels (`mask`), JAX's IoU against the ground
truth (`iou`); and the CLI's report as JSON (`report`).  The masks are
taken from the CLI's own run: the pipeline's segment_stream is wrapped
to record each result it yields.  Beside them, `other_sha1` holds the
sha1s of the other generators' and of augment_sample's outputs
(`other_names` says which), which chip_smoke.py reports against the
port's on the card: whether that machine's OpenCV draws them alike.
"""

import hashlib
import json
import os
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (DENSE_CHECKPOINTS, DENSE_HW, EVAL_BATCH,  # noqa: E402
                        EVAL_N, EVAL_REF, EVAL_SEED, other_generator_outputs)
import gcn_grabcut_tpu.pipeline as jax_pipeline  # noqa: E402
from gcn_grabcut_tpu.cli import evaluate as jax_evaluate  # noqa: E402
from gcn_grabcut_tpu.data import dataset as jax_dataset  # noqa: E402
from gcn_grabcut_tpu.metrics import evaluate  # noqa: E402

OUT = ROOT / EVAL_REF


def sha1(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a)).hexdigest()


def cli_args() -> list[str]:
    return ["--checkpoint", ",".join(DENSE_CHECKPOINTS),
            "--hard-synthetic", str(EVAL_N), "--hard-size", str(DENSE_HW),
            "--synthetic-seed", str(EVAL_SEED), "--batch", str(EVAL_BATCH),
            "--bg-connectivity"]


def main() -> None:
    os.chdir(ROOT)     # the checkpoints' paths, as the report records them
    samples = jax_dataset.make_hard_synthetic_dataset(
        n=EVAL_N, size=DENSE_HW, seed=EVAL_SEED)
    masks = []
    stream = jax_pipeline.GCNGrabCutPipeline.segment_stream

    def recording(self, *args, **kwargs):
        for res in stream(self, *args, **kwargs):
            masks.append(np.asarray(res.binary_mask, np.uint8))
            yield res

    jax_pipeline.GCNGrabCutPipeline.segment_stream = recording
    try:
        report = jax_evaluate.main(cli_args())
    finally:
        jax_pipeline.GCNGrabCutPipeline.segment_stream = stream
    if len(masks) != len(samples):
        raise SystemExit(f"recorded {len(masks)} masks for {len(samples)} "
                         "images")
    ious = [evaluate(m, s["gt_mask"]).iou for m, s in zip(masks, samples)]
    others = other_generator_outputs(jax_dataset)
    if abs(float(np.mean(ious)) - report["mean_iou"]) > 1e-12:
        raise SystemExit("recorded masks do not reproduce the report")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT, image_sha1=np.array([sha1(s["image"]) for s in samples]),
        mask_sha1=np.array([sha1(s["gt_mask"]) for s in samples]),
        mask=np.stack([np.packbits(m.reshape(-1) > 0) for m in masks]),
        iou=np.array(ious, np.float64),
        report=np.array(json.dumps(report)),
        other_names=np.array([name for name, _ in others]),
        other_sha1=np.array([sha1(a) for _, a in others]))
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
