"""The program's own counters, read after a traced window.

``gcn_grabcut_torch.ops.maxflow.counts`` records every min-cut solve
launched while a torch profiler records: the kernel's tallies are copied
behind each solve into pinned host memory, with no sync, and read here
once their events have passed.  So after the window it holds the solves
launched inside it.  A program that records nothing there without a
``counts.reset()`` (which the benchmark never calls) has no tallies, and
the readers of these counters return None.
"""

from __future__ import annotations

import sys

MAXFLOW = "gcn_grabcut_torch.ops.maxflow"


def mincut_tallies() -> list:
    """One dict per kernel solve recorded (``kernel_tally``'s keys), or
    none where the program is not loaded."""
    maxflow = sys.modules.get(MAXFLOW)
    if maxflow is None:
        return []
    return list(maxflow.counts.kernel_tallies)


def mincut_per_image(rec, key: str) -> float | None:
    """The recorded kernel solves' `key` summed, per image entering
    GrabCut in the window."""
    tallies = mincut_tallies()
    n = rec.images.get("layer.grabcut", 0)
    if not tallies or not n:
        return None
    return sum(t[key] for t in tallies) / n
