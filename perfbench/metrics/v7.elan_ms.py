"""Device time per batch of the work launched inside the program's spans
``forward.elan``, which ``models/yolov3.py::_walk`` opens once per ELAN and
ELAN-H of a YOLOv7 plan (8 per forward): the ELANs' convs and concats;
None where the program opens no such span."""

NAME = "forward.elan"


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    return 1e3 * t.busy_s(inside=NAME) / t.count("model.forward")
