"""Device time per batch of the work launched inside the program's span
``forward.sppcspc``, which ``models/yolov3.py::_walk`` opens once per
forward on a YOLOv7 plan (its seven convs, three pools and two concats);
None where the program opens no such span."""

NAME = "forward.sppcspc"


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    return 1e3 * t.busy_s(inside=NAME) / t.count("model.forward")
