"""YOLOv3-tiny: the two-scale family as an explicit plan (counterpart of
``yolo_for_turbines_tpu/models/yolov3_tiny.py``).

The layers of the official yolov3-tiny.cfg, so that the official
``yolov3-tiny.weights`` (8,858,734 floats for 80 classes) reads through
the darknet reader:

    conv16 -> pool/2 -> conv32 -> pool/2 -> conv64 -> pool/2 -> conv128
    -> pool/2 -> conv256 [route] -> pool/2 -> conv512 -> pool/1 (SAME)
    -> conv1024 -> conv256 (1x1) -> HEAD (3x3 512, 1x1 out)    # 13x13
    -> conv128 (1x1) -> up2x + concat(route 256)               # 26x26, 384ch
    -> HEAD (3x3 256, 1x1 out)

Heads are branches (the trunk continues from their input). Use
``ModelConfig(backbone="yolov3_tiny", strides=(32, 16))`` with
``config.TINY_ANCHORS``.
"""

from __future__ import annotations

from ..config import ModelConfig
from .yolov3 import Plan, PlanConv, PlanHead, PlanMaxPool, PlanRoute, PlanUpsample


def build_tiny_plan(cfg: ModelConfig) -> Plan:
    c = cfg.num_classes
    a = cfg.anchors_per_scale
    return (
        PlanConv(cfg.in_channels, 16, 3, 1),
        PlanMaxPool(2, 2),
        PlanConv(16, 32, 3, 1),
        PlanMaxPool(2, 2),
        PlanConv(32, 64, 3, 1),
        PlanMaxPool(2, 2),
        PlanConv(64, 128, 3, 1),
        PlanMaxPool(2, 2),
        PlanConv(128, 256, 3, 1),
        PlanRoute(),
        PlanMaxPool(2, 2),
        PlanConv(256, 512, 3, 1),
        PlanMaxPool(2, 1),  # SAME padding keeps 13x13
        PlanConv(512, 1024, 3, 1),
        PlanConv(1024, 256, 1, 1),
        PlanHead(256, c, a, mid_ch=512),  # 13x13 head
        PlanConv(256, 128, 1, 1),
        PlanUpsample(128),  # concat with the 256-channel route -> 384
        PlanHead(384, c, a, mid_ch=256),  # 26x26 head
    )
