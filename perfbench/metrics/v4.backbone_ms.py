"""Device time per batch of the work launched inside the program's span
``forward.backbone``, which ``FoldedYOLOv3.forward`` opens once per forward on a
YOLOv4 plan (``models/yolov3.py::_parts``); None where the program
opens no such span."""

NAME = "forward.backbone"


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    return 1e3 * t.busy_s(inside=NAME) / t.count("model.forward")
