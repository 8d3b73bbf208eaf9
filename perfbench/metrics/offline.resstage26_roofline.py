"""The 26x26x512 residual stage's least time at the cell's batch (the
benchmark's count of its operations and bytes on one H100) over the device
time of everything launched inside that stage: the same work, whatever
implements it (K2 on the card)."""

from perfbench import roofline

CHANNELS, SIDE = 512, 26
NAME = f"resstage.{CHANNELS}x{SIDE}x{SIDE}"


def read(run):
    t = run.trace
    if t is None or not t.count(NAME):
        return None
    took = t.busy_s(inside=NAME) / t.count(NAME)
    if took <= 0:
        return None
    bound = roofline.stage_bound_s(run.cfg, run.cfg["image_size"], CHANNELS, SIDE,
                                   run.mix["batch"])
    return 100.0 * bound / took
