#!/usr/bin/env python3
"""Weights trained by the program's own `cli.train`, written as the
benchmark's checkpoints.

    python3 bench_port/weights/trained.py

trains every file of `RECIPES` beside this one, on the card, with the
recipe's flags: the hard-synthetic and photo-synthetic generators draw
the data from the recipe's seed, so nothing is downloaded.  The file
holds the best validation epoch's parameters and InputNorm statistics
(no optimiser state), written by the program's ``save_checkpoint`` with
the trainer's `meta` and the recipe's command line under
``meta["recipe"]``; the training history goes beside it as
``<stem>.history.json``.  The card's arithmetic decides the bits, so a
run on other hardware writes other weights: the committed file is data,
and its `meta` says how it was made.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: file name -> `cli.train` flags (the flagship ResGCNNet's data recipe,
#: examples/ensemble_r5/README.md, for a GATTrimapNet D=128 n=6)
RECIPES = {
    "gat_d128_n6_s42.msgpack": [
        "--model", "gat", "--hidden", "128", "--layers", "6",
        "--hard-synthetic", "300", "--photo-synthetic", "400",
        "--hard-size", "512", "--epochs", "60", "--batch", "8",
        "--seed", "42"],
}


def command(argv: list) -> str:
    return " ".join(["python", "-m", "gcn_grabcut_torch.cli.train", *argv])


def write(path: Path, argv: list, extra: list = ()) -> dict:
    """Train with `argv` (+ `extra`, flags left out of the recorded
    recipe, such as --cpu) and write the best epoch to `path`; returns
    its meta."""
    from gcn_grabcut_torch.cli import train
    from gcn_grabcut_torch.train.checkpoints import (load_checkpoint,
                                                     save_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        train.main([*argv, *extra, "--save-dir", tmp])
        params, batch_stats, meta = load_checkpoint(
            Path(tmp) / "best_model.msgpack")
        meta = {**meta, "recipe": command(argv)}
        save_checkpoint(path, params, batch_stats, meta=meta)
        shutil.copyfile(Path(tmp) / "history.json",
                        path.with_suffix(".history.json"))
    return meta


def main() -> int:
    sys.path.insert(0, str(HERE.parents[1]))
    for name, recipe in RECIPES.items():
        meta = write(HERE / name, recipe)
        print(json.dumps({"file": str(HERE / name), "epoch": meta["epoch"],
                          "score": meta["score"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
