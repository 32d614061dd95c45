"""Device milliseconds per image in GrabCut's colour models: the program's
`layer.grabcut.kmeans` and `layer.grabcut.gmm` spans (ops/gmm.py: the
seeded k-means, the fits' float64 moment sums, the component scores and
the terminal capacities), per image entering GrabCut.  None where the
program opens neither span."""

SPANS = ("layer.grabcut.kmeans", "layer.grabcut.gmm")


def read(rec):
    times = [rec.device_s(s) for s in SPANS]
    n = rec.images.get("layer.grabcut", 0)
    if not n or all(t is None for t in times):
        return None
    return 1e3 * sum(t or 0.0 for t in times) / n
