"""Device milliseconds per image in the program's `layer.upload` span:
the batch's host-to-device copy and its conversion to float32, per
full-scale image built.  None where the program opens no such span."""


def read(rec):
    return rec.per_image_ms("layer.upload", "layer.build")
