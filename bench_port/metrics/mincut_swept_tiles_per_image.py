"""The min-cut kernel's push-sweep tiles swept (those not skipped as
quiet) per image entering GrabCut: the summed `swept_tiles` of the kernel
tallies that the program records in ``ops.maxflow.counts`` while the
traced window's profiler runs (bench_port/counters.py).  None where the
program recorded none."""

from bench_port.counters import mincut_per_image


def read(rec):
    return mincut_per_image(rec, "swept_tiles")
