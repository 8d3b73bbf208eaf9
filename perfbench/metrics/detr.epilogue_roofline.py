"""K5's least time per forward over the device time of its launches per
forward: the conv epilogue's share of its bound on RT-DETR.

The least time is the epilogue's bytes (``reference/rtdetr.py::
epilogue_bytes``: every conv's output read and written once in bf16, and
the residual read by a bottleneck's last conv and by CSPRep's second conv)
over the HBM rate. The time is the union of the intervals of the traced
window's device kernels whose name is K5's
(``csrc/epilogue.cu::conv_epilogue_kernel``), over the forwards of that
window. None where no such kernel ran (a program without K5 there)."""

from perfbench import roofline
from perfbench.reference import rtdetr
from perfbench.trace import clip, total, union

KERNEL = "conv_epilogue_kernel"


def read(run):
    t = run.trace
    if t is None or not t.count("model.forward"):
        return None
    lo, hi = t.window()
    spans = [t._interval(e) for e in t.events() if KERNEL in e["name"]]
    took = total(clip(union(spans), lo, hi)) / t.count("model.forward")
    if took <= 0:
        return None
    nbytes = rtdetr.epilogue_bytes(run.cfg, run.cfg["image_size"], run.mix["batch"])
    return 100.0 * nbytes / roofline.PEAKS["hbm_bytes_per_s"] / took
