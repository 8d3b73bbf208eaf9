"""Host time per request in ``predict_image.resize``: PIL's resize of the
host frame's longest side to the model's side
(``data/augment.py::resize_longest``), one of the three parts of
``predict_image.letterbox``. From the program's span log
(``perfbench/spanlog.py``); nothing where the program logs no such span."""

from perfbench import spanlog


def read(run):
    return spanlog.host_ms_per_root(run, "predict_image", "predict_image.resize")
