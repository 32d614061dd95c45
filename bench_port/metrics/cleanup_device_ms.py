"""Device milliseconds per image in the clean-up span (pipeline._post_stage_device: ops/connected.py, kernel B, the bit packing), per image entering it.  Read from the traced run's
device activities launched inside the span."""


def read(rec):
    return rec.per_image_ms("layer.cleanup", "layer.cleanup")
