"""Device milliseconds per image between the forward and GrabCut: the
program's `layer.project` spans (the posteriors projected to pixels at
every scale, the resize to a reduced scale, the scales' average) and its
`layer.trimap` span (grey image, guided filter, thresholds, prior seeds),
per full-scale image built.  None where the program opens no
`layer.project` span."""


def read(rec):
    project = rec.device_s("layer.project")
    n = rec.images.get("layer.build", 0)
    if project is None or not n:
        return None
    return 1e3 * (project + (rec.device_s("layer.trimap") or 0.0)) / n
