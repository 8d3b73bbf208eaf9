"""Model configuration and serving constants of the port.

The port's own copy of what it reads from ``yolo_for_turbines_tpu/config.py``
(which it never imports). ``ModelConfig`` keeps the same field names, types,
defaults and order, so a bundle manifest written by the JAX package's
``serving.save_predictor`` builds it with ``ModelConfig(**manifest)``.
``tests/test_torch_config.py`` holds this copy to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

DEF_IMAGE_SIZE = 416
CONF_THRESHOLD = 0.5
NMS_IOU_THRESHOLD = 0.45

# Normalized (w, h) anchors per scale, large scale (stride 32) first.
ANCHORS = (
    ((0.28, 0.22), (0.38, 0.48), (0.9, 0.78)),
    ((0.07, 0.15), (0.15, 0.11), (0.14, 0.29)),
    ((0.02, 0.03), (0.04, 0.07), (0.08, 0.06)),
)

STRIDES = (32, 16, 8)

NUM_COCO_CLASSES = 80


def grid_sizes_for(image_size: int, strides: Sequence[int] = STRIDES) -> tuple:
    """Grid sizes for the detection scales at a given image size."""
    return tuple(image_size // s for s in strides)


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
    # A train-mode stem layout of the JAX package; folded inference, the
    # only mode the port runs, ignores it.
    s2d_stem: bool = True

    @property
    def channels_per_anchor(self) -> int:
        return self.num_classes + 5
