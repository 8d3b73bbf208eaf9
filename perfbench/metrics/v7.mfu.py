"""YOLOv7's forward operations (the reference's conv table,
``reference/yolov7.py``: 104.51 GFLOP per image at 640px) times the images
of the quiet traced window (the device alone), over its seconds, as a share
of the bf16 peak: the share of the whole step, decode and NMS included in
the time."""

from perfbench import roofline
from perfbench.reference import yolov7


def read(run):
    if run.quiet is None:
        return None
    ops = yolov7.forward_flops(run.cfg, run.cfg["image_size"])
    images = sum(n for _, _, n in run.records)
    return 100.0 * ops * images / run.quiet.window_s() / roofline.PEAKS["bf16_flops"]
