"""Device milliseconds per image in GATTrimapNet's banded attention: the
program's `layer.forward.attention` spans (ops/sddmm.py
`banded_gat_attention`, one a layer), per image entering the build.
None where the program opens no such span.  The span's activities come
through `trace.py`'s correlation-id linking, which can put a whole
min-cut launch inside the span (PERF.md, section 7): until that linking
keeps runtime and driver launches only, it has read 10-65% away from the
runtime-linked time on an H100, and backs no claim."""


def read(rec):
    return rec.per_image_ms("layer.forward.attention", "layer.build")
