"""Device time per batch of the work launched inside the program's span
``forward.pool``, which ``models/blocks.py`` opens around every max pool of
the forward (``maxpool_pyramid``: YOLOv4's SPP, YOLOv7's SPPCSPC;
``maxpool2d``: YOLOv7's five MP pools); None where the program opens no
such span."""

NAME = "forward.pool"


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    return 1e3 * t.busy_s(inside=NAME) / t.count("model.forward")
