"""Device milliseconds per image in the forward span (GCNGrabCutPipeline._predict_probs_batch: models/, with K1 and the segment sums on the large path), every scale, per image entering the build.  Read from the traced run's
device activities launched inside the span."""


def read(rec):
    return rec.per_image_ms("layer.forward", "layer.build")
