"""Three forwards' operations (the benchmark's layer table) times the
images of the steps in the quiet traced window (the device alone), over
its seconds, as a share of the bf16 peak."""

from perfbench import roofline


def read(run):
    if run.quiet is None:
        return None
    ops = roofline.train_flops(run.cfg, run.cfg["image_size"])
    images = sum(n for _, _, n in run.records)
    return 100.0 * ops * images / run.quiet.window_s() / roofline.PEAKS["bf16_flops"]
