"""The min-cut kernel's share of its roofline, in %: the least time its
calls could take (each call's input planes read once and its outputs
written once, counted from the shapes by bench_port/count/bytes.py, at
the HBM peak of bench_port/count/peaks.json) over the device time of the
activities launched inside the `layer.mincut` spans."""


def read(rec):
    device = rec.device_s("layer.mincut")
    n_bytes = rec.counters.get("mincut_bytes", 0)
    if not device or not n_bytes:
        return None
    return 100.0 * n_bytes / rec.peaks["hbm_bytes_per_s"] / device
