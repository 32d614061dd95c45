"""The banded attention's share of its roofline, in %: the least time its
layers could take (their compulsory bytes, counted from the graph's valid
nodes and edges and the configuration's widths by
bench_port/count/attention_bytes.py, at the HBM peak of
bench_port/count/peaks.json) over the device time of the activities
launched inside the `layer.forward.attention` spans.  None where the
program opens no such span.  Its time comes through the same linking as
`attention_device_ms`, and backs no claim until that linking is
repaired."""


def read(rec):
    device = rec.device_s("layer.forward.attention")
    n_bytes = rec.counters.get("attention_bytes", 0)
    if not device or not n_bytes:
        return None
    return 100.0 * n_bytes / rec.peaks["hbm_bytes_per_s"] / device
