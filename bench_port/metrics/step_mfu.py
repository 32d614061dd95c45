"""The whole step's model FLOPs over the traced window at the card's
published bf16 dense peak, in %: the graph convolutions of every forward
the window ran (bench_port/count/flops.py, on the valid nodes and edges
of each graph, each ensemble member and each scale)."""


def read(rec):
    flops = rec.counters.get("gcn_flops", 0)
    window = rec.trace.window_s()
    if not flops or window <= 0:
        return None
    return 100.0 * flops / (window * rec.peaks["bf16_dense_flops_per_s"])
