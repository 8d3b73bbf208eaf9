"""The int8 conv products' least time per forward over the device time of
what the program launched inside its span ``int8.conv`` (one per int8 conv
product, ``models/quantize.py::_conv_i8``), per forward; None where the
program opens no such span.

The least time is the products' operations over the s8 tensor peak,
counted from the configuration's layer list for exactly the convs that
``int8.epilogue_roofline`` counts: every conv but the heads' (bf16) and the
512-channel residual stage's at side 26 (K4's, which computes its products
in its own kernel). A conv that reads an upsample's concat as two products
counts its operations once, as the layer list does. Operations alone are
counted, so the metric reads the same work whatever computes the products."""

from perfbench import roofline
from perfbench.reference.model import parse

NAME = "int8.conv"
STAGE_CHANNELS, STAGE_SIDE = 512, 26


def conv_ops(cfg: dict, size: int, batch: int) -> float:
    plan = parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    stage = {c["path"] for c in roofline.stage_convs(cfg, size, STAGE_CHANNELS, STAGE_SIDE)}
    return batch * sum(c["flops"] for c in roofline.conv_table(cfg, size)
                       if plan[c["path"][0]]["kind"] != "head" and c["path"] not in stage)


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    took = t.busy_s(inside=NAME) / t.count("model.forward")
    if took <= 0:
        return None
    ops = conv_ops(run.cfg, run.cfg["image_size"], run.mix["batch"])
    return 100.0 * ops / roofline.PEAKS["int8_ops"] / took
