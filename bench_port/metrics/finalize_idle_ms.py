"""Milliseconds per image in which the card sat idle while the host was in
`layer.finalize` or one of its children (`layer.finalize.pull`,
`.unpack`, `.compose`): the idle gaps of the traced window labelled by
the innermost span open at each gap's start, per image entering GrabCut.
None where no such span was opened."""


def _finalize(name: str) -> bool:
    return name == "layer.finalize" or name.startswith("layer.finalize.")


def read(rec):
    n = rec.images.get("layer.grabcut", 0)
    if not n or not any(_finalize(s[0]) for s in rec.trace.spans):
        return None
    idle = rec.trace.idle_by_host_span(n=len(rec.trace.spans) + 1)
    return 1e3 * sum(s for name, s in idle if _finalize(name)) / n
