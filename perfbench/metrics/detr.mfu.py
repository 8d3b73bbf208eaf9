"""RT-DETR's forward operations (``reference/rtdetr.py::forward_flops``:
its convs in deploy form, linear layers and attention products, 2 x MACs,
about 134 GFLOP per image at 640px) times the images of the quiet traced
window (the device alone), over its seconds, as a share of the bf16 peak:
the share of the whole step, the postprocess included in the time."""

from perfbench import roofline
from perfbench.reference import rtdetr


def read(run):
    if run.quiet is None:
        return None
    ops = rtdetr.forward_flops(run.cfg, run.cfg["image_size"])
    images = sum(n for _, _, n in run.records)
    return 100.0 * ops * images / run.quiet.window_s() / roofline.PEAKS["bf16_flops"]
