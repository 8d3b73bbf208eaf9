"""Darknet-53 YOLOv3 in PyTorch: the trainable module and the folded
inference module. The exports of ``yolo_for_turbines_tpu/models`` but its
functional ``init`` and ``apply``, which here are the modules' constructors
(``YOLOv3``, ``FoldedYOLOv3``, ``init_plan``) and ``forward``."""
from .yolov3 import YOLOv3, FoldedYOLOv3, LAYER_CONFIG, build_plan, init_plan, param_count
from .cspdarknet import CSP_LAYER_CONFIG
