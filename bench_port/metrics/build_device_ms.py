"""Device milliseconds per image in the graph build span (graph_build.py, ops/{image,slic,region,edges,prior}.py, kernel A), both scales of a multi-scale batch, per image entering the build.  Read from the traced run's
device activities launched inside the span."""


def read(rec):
    return rec.per_image_ms("layer.build", "layer.build")
