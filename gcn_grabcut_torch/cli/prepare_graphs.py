"""Cache-warming CLI: builds and caches the graph of every image/mask pair
so that a later training run (of either package: the cache format and key
are the JAX package's) starts optimising at once.  Results are discarded;
the cache is the product.  Counterpart of
``gcn_grabcut_tpu/cli/prepare_graphs.py``.

    python -m gcn_grabcut_torch.cli.prepare_graphs --images imgs/ \\
        --masks masks/ --cache-dir cache/ [--cpu]
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pre-build the graph cache")
    p.add_argument("--images", required=True)
    p.add_argument("--masks", required=True)
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--n-segments", type=int, default=300)
    p.add_argument("--max-size", type=int, default=512)
    p.add_argument("--augment-copies", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="build on the CPU (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..core.device import resolve_device
    from ..data.dataset import list_image_mask_pairs, prepare_dataset
    from ..graph_build import SuperpixelGraphConfig

    device = resolve_device("cpu" if args.cpu else None)
    samples = list_image_mask_pairs(
        args.images, args.masks, max_size=args.max_size,
        augment_copies=args.augment_copies, seed=args.seed)
    if args.limit:
        samples = samples[:args.limit]
    prepare_dataset(samples,
                    SuperpixelGraphConfig(n_segments=args.n_segments),
                    cache_dir=args.cache_dir, desc="warm: ",
                    keep_segments=False, device=device)
    print(f"[Prepare] Cache ready at {args.cache_dir}")


if __name__ == "__main__":
    main()
