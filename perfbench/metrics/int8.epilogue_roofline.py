"""The int8 conv epilogue's least time per forward over the device time of
what the program launched inside its span ``int8.epilogue`` (one per int8
conv's epilogue, ``models/quantize.py::_epilogue``), per forward; None where
the program opens no such span.

The least time is the epilogue's bytes over the HBM rate, counted from the
configuration's layer list: every conv but the heads' (bf16) and the
512-channel residual stage's at side 26 (K4's, which requantizes in its own
registers) reads its i32 output once (4 bytes an element) and writes its s8
codes once (1), reads the block input's codes where it ends a residual block
(1), and the second branch's i32 output where it reads an upsample's concat
as two convs (4)."""

from perfbench import roofline
from perfbench.reference.model import parse

NAME = "int8.epilogue"
STAGE_CHANNELS, STAGE_SIDE = 512, 26


def epilogue_bytes(cfg: dict, size: int, batch: int) -> float:
    plan = parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    stage = {c["path"] for c in roofline.stage_convs(cfg, size, STAGE_CHANNELS, STAGE_SIDE)}
    total = 0.0
    for c in roofline.conv_table(cfg, size):
        i = c["path"][0]
        e = plan[i]
        if e["kind"] == "head" or c["path"] in stage:
            continue
        per_element = 4 + 1
        if e["kind"] == "res" and e["residual"] and c["path"][-1] == "conv2":
            per_element += 1
        if e["kind"] == "conv" and i > 0 and plan[i - 1]["kind"] == "up":
            per_element += 4
        total += batch * c["side_out"] ** 2 * c["cout"] * per_element
    return total


def read(run):
    t = run.trace
    if t is None or not t.count(NAME) or not t.count("model.forward"):
        return None
    took = t.busy_s(inside=NAME) / t.count("model.forward")
    if took <= 0:
        return None
    nbytes = epilogue_bytes(run.cfg, run.cfg["image_size"], run.mix["batch"])
    return 100.0 * nbytes / roofline.PEAKS["hbm_bytes_per_s"] / took
