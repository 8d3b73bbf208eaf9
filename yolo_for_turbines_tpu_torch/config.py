"""Model configuration, serving and eval constants of the port.

The port's own copy of what it reads from ``yolo_for_turbines_tpu/config.py``
(which it never imports). ``ModelConfig`` and ``EvalConfig`` keep the same
field names, types, defaults and order, so a bundle manifest written by the
JAX package's ``serving.save_predictor`` builds it with
``ModelConfig(**manifest)``. ``tests/test_torch_config.py`` holds this copy
to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

DEF_IMAGE_SIZE = 416
MAP_IOU_THRESHOLD = 0.5
CONF_THRESHOLD = 0.5
NMS_IOU_THRESHOLD = 0.45

# Normalized (w, h) anchors per scale, large scale (stride 32) first.
ANCHORS = (
    ((0.28, 0.22), (0.38, 0.48), (0.9, 0.78)),
    ((0.07, 0.15), (0.15, 0.11), (0.14, 0.29)),
    ((0.02, 0.03), (0.04, 0.07), (0.08, 0.06)),
)

TURBINE_ANCHORS = (
    ((0.215, 0.461), (0.992, 0.349), (0.436, 0.952)),
    ((0.06, 0.143), (0.143, 0.189), (0.408, 0.181)),
    ((0.016, 0.0349), (0.0408, 0.0598), (0.110, 0.0777)),
)

STRIDES = (32, 16, 8)

TURBINE_LABELS = ("dirt", "damage")
NUM_TURBINE_CLASSES = len(TURBINE_LABELS)

NUM_COCO_CLASSES = 80


def grid_sizes_for(image_size: int, strides: Sequence[int] = STRIDES) -> tuple:
    """Grid sizes for the detection scales at a given image size."""
    return tuple(image_size // s for s in strides)


def anchors_array(anchors=ANCHORS) -> np.ndarray:
    """Anchors as a (3, 3, 2) float32 array (scale, anchor, wh), normalized."""
    return np.asarray(anchors, dtype=np.float32)


def scaled_anchors_array(anchors, image_size: int = DEF_IMAGE_SIZE) -> np.ndarray:
    """Anchors times their scale's grid size, (3, 3, 2): widths and heights
    in cell units."""
    a = anchors_array(anchors)
    gs = np.asarray(grid_sizes_for(image_size), dtype=np.float32)
    return a * gs[:, None, None]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs."""

    num_classes: int = NUM_COCO_CLASSES
    in_channels: int = 3
    activation: str = "leaky_relu"  # or "mish"
    backbone: str = "darknet53"  # or "cspdarknet53" or "yolov3_tiny"
    anchors_per_scale: int = 3
    # Output stride per detection scale, coarsest first.
    strides: tuple = (32, 16, 8)
    # Optional custom architecture through the layer DSL of
    # models/yolov3.py (overrides the backbone choice when set).
    layer_config: Optional[tuple] = None
    # Inference: run the residual stages that ``stage_wins`` selects
    # through the fused residual-stage kernel (ops/kernels/resblock_kernel.py)
    # on CUDA; the same arithmetic as the layer-by-layer path.
    fuse_resblocks: bool = True
    # The JAX package's space-to-depth stem layout, arithmetically the same
    # as the plain stem; the port runs the plain stem and ignores it.
    s2d_stem: bool = True

    @property
    def channels_per_anchor(self) -> int:
        return self.num_classes + 5


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    conf_threshold: float = CONF_THRESHOLD
    nms_iou_threshold: float = NMS_IOU_THRESHOLD
    map_iou_threshold: float = MAP_IOU_THRESHOLD
    max_boxes: int = 256  # fixed NMS capacity per image (padded/masked)
    box_format: str = "center"
