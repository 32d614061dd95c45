"""Device milliseconds per image in the banded attention's plan: the
program's `layer.forward.plan` spans (models/large.py
`build_gat_plan_device`, its overflow read included), per image entering
the build.  None where the program opens no such span."""


def read(rec):
    return rec.per_image_ms("layer.forward.plan", "layer.build")
