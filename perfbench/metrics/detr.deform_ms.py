"""Device time per batch of the work launched inside the program's span
``detr.deform``, which ``models/rtdetr.py::MSDeformableAttention`` opens
once per decoder layer around the sampling core (each level's values split
off, the bilinear samples, the weighted sum; not the value and output
projections), summed over a forward's layers; None where the program opens
no such span."""

NAME = "detr.deform"


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    return 1e3 * t.busy_s(inside=NAME) / t.count("model.forward")
