"""Host time per request in ``predict_image.pad``: the centred pad of the
resized frame to a square (``data/augment.py::pad_center``), one of the
three parts of ``predict_image.letterbox``. From the program's span log
(``perfbench/spanlog.py``); nothing where the program logs no such span."""

from perfbench import spanlog


def read(run):
    return spanlog.host_ms_per_root(run, "predict_image", "predict_image.pad")
