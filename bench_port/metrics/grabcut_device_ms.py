"""Device milliseconds per image in the GrabCut span (pipeline.grabcut_batch_device: grabcut.py, ops/gmm.py, ops/maxflow.py and its min-cut kernel), per image entering it.  Read from the traced run's
device activities launched inside the span."""


def read(rec):
    return rec.per_image_ms("layer.grabcut", "layer.grabcut")
