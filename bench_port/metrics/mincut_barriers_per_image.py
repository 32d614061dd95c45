"""The min-cut kernel's grid-wide barriers per image entering GrabCut: the
summed `barriers` of the kernel tallies that the program records in
``ops.maxflow.counts`` while the traced window's profiler runs
(bench_port/counters.py).  None where the program recorded none."""

from bench_port.counters import mincut_per_image


def read(rec):
    return mincut_per_image(rec, "barriers")
