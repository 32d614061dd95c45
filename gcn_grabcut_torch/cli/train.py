"""Training CLI.  Counterpart of ``gcn_grabcut_tpu/cli/train.py``, with
every flag; runs on the card unless --cpu.

Examples
--------
# synthetic smoke run
python -m gcn_grabcut_torch.cli.train --synthetic 64 --epochs 5 --batch 8

# DUTS-style directory layout
python -m gcn_grabcut_torch.cli.train --images data/DUTS-TR/imgs \\
    --masks data/DUTS-TR/masks --epochs 60 --cache-dir cache/

# data-parallel over two processes (gloo on the CPU; one card each
# without --cpu, over NCCL)
torchrun --standalone --nproc_per_node 2 -m gcn_grabcut_torch.cli.train \\
    --synthetic 64 --epochs 5 --devices 2 --cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a GCN trimap model")
    p.add_argument("--images", type=str, default=None)
    p.add_argument("--masks", type=str, default=None)
    p.add_argument("--hard-synthetic", type=int, default=0,
                   help="train on N hard-synthetic samples (the DUTS "
                        "stand-in benchmark distribution)")
    p.add_argument("--photo-synthetic", type=int, default=0,
                   help="additionally mix in N photo-statistics synthetic "
                        "samples (scene backgrounds, multi-part objects)")
    p.add_argument("--hard-size", type=int, default=512)
    p.add_argument("--real-textures", action="store_true",
                   help="mix real-photo texture crops (bundled sample "
                        "images) into the photo-synthetic generator")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples instead of a dataset")
    p.add_argument("--model", choices=["resgcn", "gcn", "gat"],
                   default="resgcn")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=3e-4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--prior-dropout", type=float, default=0.0,
                   help="per-graph probability of zeroing the 3 prior "
                        "input channels during training")
    p.add_argument("--loss", choices=["trimap", "focal", "smooth_ce", "ce"],
                   default="trimap")
    p.add_argument("--scheduler",
                   choices=["cosine_warm", "onecycle", "plateau", "none"],
                   default="cosine_warm")
    p.add_argument("--n-segments", type=int, default=300)
    p.add_argument("--bg-connectivity", action="store_true",
                   help="enable the geodesic boundary-connectivity "
                        "background prior cue in the graph build — train "
                        "and infer with the same setting")
    p.add_argument("--max-size", type=int, default=512)
    p.add_argument("--augment-copies", type=int, default=0)
    p.add_argument("--limit", type=int, default=0,
                   help="cap the number of training samples (0 = all)")
    p.add_argument("--val-limit", type=int, default=0)
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--save-dir", type=str, default="checkpoints")
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume training from (the port's "
                        "or the JAX package's)")
    p.add_argument("--log-dir", type=str, default=None,
                   help="TensorBoard log directory")
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the card)")
    p.add_argument("--devices", type=int, default=0,
                   help="data-parallel training over N devices: the "
                        "processes under torchrun, else the visible cards")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..parallel.mesh import init_distributed

    # Before the device: under torchrun each process takes its card.
    joined = args.devices > 1 and init_distributed(
        device="cpu" if args.cpu else None)
    try:
        return _train(args)
    finally:
        if joined:
            # Leave the group before the interpreter exits: left to
            # interpreter teardown, gloo's threads can be destroyed while
            # still running, which aborts the process (SIGABRT) after a
            # finished run.
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args):
    from ..core.device import resolve_device
    from ..parallel.mesh import make_mesh, process_count
    from ..data.dataset import (
        list_image_mask_pairs, make_hard_synthetic_dataset,
        make_photo_synthetic_dataset, make_synthetic_dataset,
        prepare_dataset, split_dataset)
    from ..graph_build import SuperpixelGraphConfig
    from ..train.trainer import TrainConfig, Trainer

    device = resolve_device("cpu" if args.cpu else None)
    sp_cfg = SuperpixelGraphConfig(n_segments=args.n_segments,
                                   bg_connectivity=args.bg_connectivity)

    if args.hard_synthetic or args.photo_synthetic:
        samples = []
        if args.hard_synthetic:
            samples += make_hard_synthetic_dataset(
                n=args.hard_synthetic, size=args.hard_size, seed=args.seed)
        if args.photo_synthetic:
            samples += make_photo_synthetic_dataset(
                n=args.photo_synthetic, size=args.hard_size,
                seed=args.seed + 1, real_textures=args.real_textures)
        train_s, val_s, _ = split_dataset(samples, seed=args.seed)
    elif args.synthetic:
        samples = make_synthetic_dataset(n=args.synthetic, seed=args.seed)
        train_s, val_s, _ = split_dataset(samples, seed=args.seed)
    else:
        if not (args.images and args.masks):
            raise SystemExit("--images/--masks or --synthetic required")
        samples = list_image_mask_pairs(
            args.images, args.masks, max_size=args.max_size,
            augment_copies=args.augment_copies, seed=args.seed)
        train_s, val_s, _ = split_dataset(samples, seed=args.seed)

    if args.limit:
        train_s = train_s[:args.limit]
    if args.val_limit:
        # An evenly strided subset keeps the validation representative.
        stride = max(1, len(val_s) // args.val_limit)
        val_s = val_s[::stride][:args.val_limit]

    train_recs = prepare_dataset(train_s, sp_cfg, cache_dir=args.cache_dir,
                                 desc="train: ", keep_segments=False,
                                 device=device)
    val_recs = prepare_dataset(val_s, sp_cfg, cache_dir=args.cache_dir,
                               desc="val: ", keep_segments=False,
                               device=device)

    cfg = TrainConfig(
        n_epochs=args.epochs, lr=args.lr, weight_decay=args.weight_decay,
        batch_size=args.batch, loss_fn=args.loss, scheduler=args.scheduler,
        bf16=not args.no_bf16, early_stop_patience=args.patience,
        t0=max(args.epochs // 3, 1), seed=args.seed, log_dir=args.log_dir,
        prior_dropout=args.prior_dropout)

    mesh = None
    if args.devices > 1:
        # One rank per process under a process group; in one process, one
        # per visible card (one on the CPU).
        avail = (process_count() if process_count() > 1 else
                 1 if device.type == "cpu" else torch.cuda.device_count())
        if avail < args.devices:
            raise SystemExit(f"--devices {args.devices} but only {avail} "
                             "device(s) visible")
        mesh = make_mesh(n_data=args.devices, n_graph=1,
                         devices=[device] if process_count() > 1 else None)
        print(f"[Train] data-parallel over {args.devices} device(s)")

    trainer = Trainer(args.model,
                      dict(hidden_channels=args.hidden,
                           n_layers=args.layers, dropout=args.dropout),
                      cfg, save_dir=args.save_dir, device=device, mesh=mesh)
    history = trainer.fit([r[0] for r in train_recs],
                          [r[0] for r in val_recs],
                          resume_from=args.resume)

    if args.model == "resgcn":
        w = trainer.model.layer_weights().cpu().numpy()
        print("[Train] JK fusion weights [input, blocks..., sage]:",
              np.round(w, 4).tolist())
    best = max(history["val_score"]) if history["val_score"] else None
    print(f"[Train] Done. Best val score: {best}")
    return history


if __name__ == "__main__":
    main()
