"""Inference CLI: segment an image or a directory of images and write the
mask, overlay, cut-out and trimap PNGs.  Counterpart of
``gcn_grabcut_tpu/cli/inference.py``: the same flags and file names; runs
on the card unless --cpu.

Examples
--------
python -m gcn_grabcut_torch.cli.inference --checkpoint ckpt/best_model.msgpack \\
    --input photo.jpg --output-dir out/
python -m gcn_grabcut_torch.cli.inference --checkpoint ckpt/best_model.msgpack \\
    --input images_dir/ --save mask overlay --batch 8 --fixed-size
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Segment images with a trained GCN-GrabCut model")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint path, or comma-separated paths to run "
                        "the inference ensemble")
    p.add_argument("--input", required=True,
                   help="an image file or a directory of images")
    p.add_argument("--output-dir", type=str, default="outputs")
    p.add_argument("--n-segments", type=int, default=500)
    p.add_argument("--bg-connectivity", action="store_true",
                   help="geodesic boundary-connectivity bg prior cue "
                        "(match the checkpoint's training setting)")
    p.add_argument("--max-size", type=int, default=512)
    p.add_argument("--threshold", type=float, default=0.65)
    p.add_argument("--filter-radius", type=int, default=4)
    p.add_argument("--refine-iters", type=int, default=0)
    p.add_argument("--keep-largest", action="store_true")
    p.add_argument("--no-edge-aware", action="store_true")
    p.add_argument("--fixed-size", action="store_true",
                   help="resize every image to exactly max-size x max-size "
                        "(masks are resized back to the original geometry)")
    p.add_argument("--batch", type=int, default=1,
                   help="run up to N same-shape images per batch through "
                        "segment_batch (combine with --fixed-size so every "
                        "image shares one shape)")
    p.add_argument("--save", nargs="+", default=["mask", "overlay"],
                   choices=["mask", "overlay", "rgba", "trimap"])
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute for the GCN forward")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import cv2
    import torch

    from ..core.device import resolve_device
    from ..graph_build import SuperpixelGraphConfig
    from ..pipeline import GCNGrabCutPipeline, colour_trimap
    from ..train.checkpoints import load_model_auto

    device = resolve_device("cpu" if args.cpu else None)
    dtype = torch.bfloat16 if args.bf16 else None
    model, meta = load_model_auto(args.checkpoint, device=device,
                                  dtype=dtype)
    print(f"[Inference] Loaded {meta.get('variant', '?')} "
          f"(epoch {meta.get('epoch', '?')}, "
          f"score {meta.get('score', '?')}, "
          f"ensemble {meta.get('ensemble_size', 1)})")

    pipe = GCNGrabCutPipeline(
        model, SuperpixelGraphConfig(n_segments=args.n_segments,
                                     bg_connectivity=args.bg_connectivity),
        device=device)

    inp = Path(args.input)
    files = ([inp] if inp.is_file() else
             sorted(p for p in inp.iterdir()
                    if p.suffix.lower() in _IMAGE_EXTS))
    if not files:
        raise SystemExit(f"no images found at {inp}")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def emit(f, res, hw0, total):
        H0, W0 = hw0
        if (H0, W0) != res.binary_mask.shape:
            res.binary_mask = cv2.resize(res.binary_mask, (W0, H0),
                                         interpolation=cv2.INTER_NEAREST)
            res.trimap = cv2.resize(res.trimap, (W0, H0),
                                    interpolation=cv2.INTER_NEAREST)
            res.overlay = cv2.resize(res.overlay, (W0, H0),
                                     interpolation=cv2.INTER_LINEAR)
            res.rgba = cv2.resize(res.rgba, (W0, H0),
                                  interpolation=cv2.INTER_LINEAR)
        stages = "  ".join(f"{k}={v:.2f}s" for k, v in res.timing.items())
        print(f"[Inference] {f.name}: {total:.2f}s ({stages}) "
              f"fg={res.binary_mask.mean():.1%}")
        stem = out_dir / f.stem
        if "mask" in args.save:
            cv2.imwrite(f"{stem}_mask.png", res.binary_mask * 255)
        if "overlay" in args.save:
            cv2.imwrite(f"{stem}_overlay.png",
                        cv2.cvtColor(res.overlay, cv2.COLOR_RGB2BGR))
        if "rgba" in args.save:
            cv2.imwrite(f"{stem}_rgba.png",
                        cv2.cvtColor(res.rgba, cv2.COLOR_RGBA2BGRA))
        if "trimap" in args.save:
            cv2.imwrite(f"{stem}_trimap.png",
                        cv2.cvtColor(colour_trimap(res.trimap),
                                     cv2.COLOR_RGB2BGR))

    # Batched mode needs the default edge-aware, no-extra-refine
    # configuration (segment_batch's contract); otherwise per image.
    batch = max(1, args.batch)
    if batch > 1 and (args.refine_iters > 0 or args.no_edge_aware):
        print("[Inference] --batch ignored with --refine-iters/"
              "--no-edge-aware (per-image path)")
        batch = 1

    buf = []   # (path, resized RGB, (H0, W0))

    def flush():
        if not buf:
            return
        t = time.perf_counter()
        if len(buf) == 1:
            results = [pipe.segment(
                buf[0][1], threshold_fg=args.threshold,
                threshold_bg=args.threshold,
                refine_iters=args.refine_iters,
                keep_largest=args.keep_largest,
                edge_aware=not args.no_edge_aware,
                filter_radius=args.filter_radius)]
        else:
            results = pipe.segment_batch(
                [b[1] for b in buf], threshold_fg=args.threshold,
                threshold_bg=args.threshold,
                keep_largest=args.keep_largest,
                filter_radius=args.filter_radius,
                want_segments=False)   # outputs don't use the label map
        per = (time.perf_counter() - t) / len(buf)
        for (f, _, hw0), res in zip(buf, results):
            emit(f, res, hw0, per)
        buf.clear()

    for f in files:
        bgr = cv2.imread(str(f))
        if bgr is None:
            print(f"[Inference] unreadable: {f}")
            continue
        img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        H0, W0 = img.shape[:2]
        if args.fixed_size:
            img = cv2.resize(img, (args.max_size, args.max_size),
                             interpolation=cv2.INTER_LINEAR)
        else:
            scale = args.max_size / max(H0, W0)
            if scale < 1.0:
                img = cv2.resize(img, (int(W0 * scale), int(H0 * scale)),
                                 interpolation=cv2.INTER_LINEAR)
        # Same-shape runs batch together; a shape change flushes first.
        if buf and (len(buf) >= batch
                    or buf[-1][1].shape != img.shape):
            flush()
        buf.append((f, img, (H0, W0)))
        if len(buf) >= batch:
            flush()
    flush()
    print(f"[Inference] Outputs → {out_dir}")


if __name__ == "__main__":
    main()
