"""GrabCut's colour-model pass launches (csrc/gmm_passes.cu: the k-means,
fit and score passes, each serving a whole batch) per image entering
GrabCut: the passes that the program records in ``ops.gmm.counts`` while
the traced window's profiler runs.  None where the program keeps no such
counter (an older program) or recorded no pass."""

import sys

GMM = "gcn_grabcut_torch.ops.gmm"


def read(rec):
    counts = getattr(sys.modules.get(GMM), "counts", None)
    passes = getattr(counts, "passes", None)
    n = rec.images.get("layer.grabcut", 0)
    if not passes or not n:
        return None
    return len(passes) / n
