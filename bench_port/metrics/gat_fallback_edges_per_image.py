"""The banded attention's fallback edges (those outside the plan's window,
attended over the edge list) per image entering the build: the `fallback`
counts of the plans the program records in ``ops.sddmm.counts`` while the
traced window's profiler runs.  None where the program keeps no such
counter or recorded no plan."""

import sys

SDDMM = "gcn_grabcut_torch.ops.sddmm"


def read(rec):
    counts = getattr(sys.modules.get(SDDMM), "counts", None)
    plans = getattr(counts, "plans", None)
    n = rec.images.get("layer.build", 0)
    if not plans or not n:
        return None
    return sum(p["fallback"] for p in plans) / n
