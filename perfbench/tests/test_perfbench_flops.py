"""The benchmark's operation counts against the published figures."""

import json

import pytest

from perfbench import roofline
from perfbench.manifest import HERE


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_yolov3_416_within_one_percent_of_published():
    cfg = config("yolov3-coco416")
    ops = roofline.forward_flops(cfg, 416)
    assert ops == pytest.approx(cfg["published_gflop_per_image"] * 1e9, rel=0.01)
    assert len(roofline.conv_table(cfg, 416)) == 75


def test_resstage_26x26x512_and_its_bound_at_b128():
    cfg = config("yolov3-coco416")
    stage = roofline.stage_convs(cfg, 416, 512, 26)
    assert len(stage) == 16  # 8 blocks of a 1x1 and a 3x3
    assert sum(c["flops"] for c in stage) == pytest.approx(14.18e9, rel=1e-3)
    assert roofline.stage_bound_s(cfg, 416, 512, 26, 128) * 1e3 == pytest.approx(1.835, rel=1e-3)


def test_train_step_is_three_forwards_and_head_width_follows_classes():
    coco, turb = config("yolov3-coco416"), config("yolov3-turbines416")
    assert roofline.train_flops(turb, 416) == 3 * roofline.forward_flops(turb, 416)
    # only the three heads' last 1x1 differ: 255 outputs against 21
    diff = roofline.forward_flops(coco, 416) - roofline.forward_flops(turb, 416)
    assert diff == pytest.approx(2 * (255 - 21) * (1024 * 13**2 + 512 * 26**2 + 256 * 52**2))


def test_sides_follow_strides():
    cfg = config("yolov3-coco416")
    heads = [c for c in roofline.conv_table(cfg, 416) if not c["bn"]]
    assert [c["side_out"] for c in heads] == [13, 26, 52]
