"""Closed-loop stream: `GCNGrabCutPipeline.segment_stream` over a pool.

Traffic parameters (``bench_port/traffic/<name>.json``, kind "stream"):

    pool           images in the fixed pool
    pool_seed      the generator seed of the fixed pool: every run times
                   the same images, in an order drawn from its own seed
    batch_size     segment_stream's batch_size
    ms_scales      segment_stream's ms_scales (null: single scale)
    max_images     length of the image list handed to segment_stream
    check_images   images drawn from the run's seed, put into the stream
                   at seeded positions, which the check compares
    check_within   the positions they take lie below this
    trace_seconds  the traced run's window

The stream is the fixed pool in consecutive seeded permutations, with the
`check_images` fresh images of this seed among its first `check_within`
positions; it runs until `--seconds` have passed and the batch in hand is
complete.  So every seed times the same work but for a few images, and
every seed checks images no other seed sees.  The window runs from the
first dispatch to the last image pulled, and the rate is all images
completed over it.  The fixed pool is made once per checkout and kept in
``.bench_cache/pools/`` (set-up then reads it back); the fresh images are
made in every run's set-up.
"""

from __future__ import annotations

import os
import time

import numpy as np

from .. import harness
from ..gen import hard_synthetic
from ..hooks import Hooks
from ..trace import Window


def fixed_pool(n: int, size: int, seed: int) -> list:
    """`hard_synthetic.images(n, size, seed)`, made once per checkout and
    read back from ``.bench_cache/pools/`` after that."""
    path = harness.CACHE / "pools" / f"hard_synthetic_{size}_{n}_{seed}.npy"
    if path.exists():
        arr = np.load(path)
        if arr.shape == (n, size, size, 3) and arr.dtype == np.uint8:
            return list(arr)
    images = hard_synthetic.images(n, size, seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(path.name + ".part")
    with open(part, "wb") as f:
        np.save(f, np.stack(images))
    os.replace(part, path)
    return images


def inputs(cell: harness.Cell) -> tuple[list, np.ndarray, list]:
    """(images, stream order of image indices, checked positions): the
    fixed pool, then the fresh images of this seed; the order, the fresh
    images and their positions drawn from the seed."""
    tr = cell.traffic
    size = cell.config["image_size"]
    words = harness.seed_words(cell.seed, 3)
    pool = fixed_pool(tr["pool"], size, tr["pool_seed"])
    fresh = hard_synthetic.images(tr["check_images"], size, words[2])
    rng = np.random.RandomState(words[0])
    laps = -(-tr["max_images"] // len(pool))
    order = list(np.concatenate([rng.permutation(len(pool))
                                 for _ in range(laps)]))
    check = sorted(int(p) for p in np.random.RandomState(words[1]).choice(
        tr["check_within"], size=len(fresh), replace=False))
    for j, pos in enumerate(check):     # ascending: each lands at `pos`
        order.insert(pos, len(pool) + j)
    return pool + fresh, np.asarray(order[:tr["max_images"]]), check


def call_settings(cell: harness.Cell) -> dict:
    cfg, tr = cell.config, cell.traffic
    return dict(threshold_fg=cfg["threshold"], threshold_bg=cfg["threshold"],
                filter_radius=cfg["filter_radius"],
                min_area_ratio=cfg["min_area_ratio"],
                ms_scales=tuple(tr["ms_scales"]) if tr.get("ms_scales")
                else None)


def run(cell: harness.Cell, mark_setup_done, dev,
        control: bool = False) -> harness.Outcome:
    tr, bs = cell.traffic, cell.traffic["batch_size"]
    stages = harness.Stages()
    images, order, check = inputs(cell)
    stages.mark("inputs")
    kw = call_settings(cell)
    pipe = harness.load_pipeline(cell.config, dev)
    stages.mark("load")
    # Warm the cell's one shape: a batch of `bs` at its scales.
    pipe.segment_batch([images[i] for i in order[:bs]], **kw)
    harness.sync(dev)
    stages.mark("warm")

    seconds = min(cell.seconds, tr["trace_seconds"]) if cell.trace \
        else cell.seconds
    hooks = Hooks(pipe, cell.config["image_size"], spans=cell.trace,
                  keep_batches=frozenset(p // bs for p in check))
    kept = {}
    with hooks.installed():
        stream = pipe.segment_stream([images[i] for i in order],
                                     batch_size=bs, **kw)
        mark_setup_done()
        with Window(cell.trace) as window:
            hooks.counting = cell.trace
            t0 = time.perf_counter()
            deadline, done = t0 + seconds, 0
            for res in stream:
                if done in check:
                    kept[done] = {"segments": res.segments,
                                  "trimap": res.trimap,
                                  "mask": res.binary_mask,
                                  "probs": res.probs}
                done += 1
                if done % bs == 0 and time.perf_counter() >= deadline:
                    break
            t_end = time.perf_counter()
            hooks.counting = False
            stream.close()
        if done == len(order):
            raise RuntimeError(f"the stream ran out of images after "
                               f"{done}: raise max_images")
    harness.sync(dev)
    peak = harness.memory_peak(dev)

    for pos, prog in kept.items():
        b, i = divmod(pos, bs)
        prog["x"] = hooks.kept_x[b][i].cpu().numpy()
        prog["grabcut"] = hooks.kept_cut[b][i].cpu().numpy()
    record = None
    if cell.trace:
        record = _record(cell, hooks, window.trace)
    del pipe, hooks, stream
    harness.free_cache(dev)

    items = {pos: (images[order[pos]], prog) for pos, prog in kept.items()}
    numbers = reference_numbers(cell, items, dev)
    if len(items) < len(check):
        numbers = {}      # a checked image never came: nothing passes
    return harness.Outcome(
        e2e={"images_per_s": done / (t_end - t0)}, attempted=done,
        failed=0, numbers=numbers, memory_peak_bytes=peak, record=record,
        control_numbers=reference_numbers(cell, items, dev, lower=True)
        if control else None,
        extra={"setup_stages_s": stages.times,
               "window_images_per_s": done / (t_end - t0),
               "window_traced": cell.trace})


def reference_numbers(cell: harness.Cell, items: dict, dev,
                      lower: bool = False) -> dict:
    """The compared numbers over {position: (image, program outputs)},
    the reference run image by image on the card after the window."""
    from ..reference import compare
    from ..reference import pipeline as ref
    if not items:
        return {}
    model = ref.load_model([harness.ROOT / p
                            for p in cell.config["checkpoints"]], dev, lower)
    st = harness.settings(cell.config, cell.traffic)
    per_image = [compare.image_numbers(prog, ref.segment(img, model, st, dev,
                                                         lower))
                 for img, prog in items.values()]
    return compare.worst(per_image)


def _record(cell: harness.Cell, hooks: Hooks, trace) -> harness.Record:
    from ..count import flops
    images = dict(hooks.images)
    images["layer.forward"] = images.get("layer.build", 0)
    nodes, edges = hooks.graph_sizes()
    m = cell.config["model"]
    counters = {
        "mincut_bytes": hooks.mincut_bytes,
        "gcn_flops": flops.forward_flops(nodes, edges, len(
            cell.config["checkpoints"]), m["hidden_channels"],
            m["n_layers"]),
    }
    return harness.Record(trace, images, counters, harness.peaks())
