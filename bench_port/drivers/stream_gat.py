"""Closed-loop stream with a GATTrimapNet: the `stream` driver, its
inputs, settings, fixed pool and window unchanged, with the check's
reference the plain GAT (``reference/gat_pipeline.py``) and the traced
record's model FLOPs and attention bytes counted for the GAT
(``count/gat_flops.py``, ``count/attention_bytes.py``).

Traffic parameters (kind "stream_gat"): those of `stream`.
"""

from __future__ import annotations

import sys

from .. import harness
from ..hooks import Hooks
from . import stream

SDDMM = "gcn_grabcut_torch.ops.sddmm"


def run(cell: harness.Cell, mark_setup_done, dev,
        control: bool = False) -> harness.Outcome:
    """`stream.run` with this module's `reference_numbers` and `_record`;
    `extra` also holds the attention plans the program recorded in a
    traced window, where it keeps such a counter."""
    saved = stream.reference_numbers, stream._record
    stream.reference_numbers, stream._record = reference_numbers, _record
    try:
        out = stream.run(cell, mark_setup_done, dev, control)
    finally:
        stream.reference_numbers, stream._record = saved
    counts = getattr(sys.modules.get(SDDMM), "counts", None)
    if cell.trace and hasattr(counts, "totals"):
        out.extra["attention_plans"] = counts.totals()
    return out


def reference_numbers(cell: harness.Cell, items: dict, dev,
                      lower: bool = False) -> dict:
    """The compared numbers over {position: (image, program outputs)},
    the GAT reference run image by image on the card after the window,
    its stages after the forward fed the program's posteriors, and
    `own_numbers` against the reference run end to end from its own
    (``reference/gat_pipeline.py``)."""
    from ..reference import compare
    from ..reference import gat_pipeline as ref
    if not items:
        return {}
    model = ref.load_model([harness.ROOT / p
                            for p in cell.config["checkpoints"]], dev)
    st = harness.settings(cell.config, cell.traffic)
    per_image = []
    for img, prog in items.values():
        out = ref.segment(img, model, st, dev, lower, prog["probs"])
        per_image.append({**compare.image_numbers(prog, out),
                          **ref.own_numbers(prog, out)})
    return compare.worst(per_image)


def _record(cell: harness.Cell, hooks: Hooks, trace) -> harness.Record:
    from ..count import attention_bytes, gat_flops
    images = dict(hooks.images)
    images["layer.forward"] = images.get("layer.build", 0)
    nodes, edges = hooks.graph_sizes()
    m = cell.config["model"]
    shape = dict(n_layers=m["n_layers"], heads=m["heads"],
                 head_dim=m["head_dim"])
    counters = {
        "mincut_bytes": hooks.mincut_bytes,
        "gcn_flops": m["members"] * gat_flops.forward_flops(
            nodes, edges, m["hidden_channels"], **shape),
        "attention_bytes": m["members"] * attention_bytes.forward_bytes(
            nodes, edges, **shape),
    }
    return harness.Record(trace, images, counters, harness.peaks())
