"""Device time per batch of the work launched inside the program's span
``detr.decoder``, which ``models/yolov3.py::_walk`` opens once per RT-DETR
forward around the decoder (``models/rtdetr.py``); None where the program
opens no such span."""

NAME = "detr.decoder"


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    return 1e3 * t.busy_s(inside=NAME) / t.count("model.forward")
