"""Model, training and eval configuration and constants of the port.

The port's own copy of what it reads from ``yolo_for_turbines_tpu/config.py``
(which it never imports). ``ModelConfig``, ``EvalConfig`` and
``TrainConfig`` keep the same field names, types, defaults and order, so a
bundle manifest written by the JAX package's ``serving.save_predictor``
builds it with ``ModelConfig(**manifest)`` and a run config or HPO result
written by either package reads in the other. ``tests/test_torch_config.py``
holds this copy to the original.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

DEF_IMAGE_SIZE = 416
MAP_IOU_THRESHOLD = 0.5
CONF_THRESHOLD = 0.5
NMS_IOU_THRESHOLD = 0.45

# Multi-scale training buckets (reference: code/config.py:43-45)
MULTI_SCALE_TRAIN_SIZES = (416, 448, 480, 512, 544, 576, 608)

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

# Official yolov3-tiny anchors (pixel values / 416), 2 scales x 3 anchors,
# coarse (stride 32) scale first.
TINY_ANCHORS = (
    ((81 / 416, 82 / 416), (135 / 416, 169 / 416), (344 / 416, 319 / 416)),
    ((10 / 416, 14 / 416), (23 / 416, 27 / 416), (37 / 416, 58 / 416)),
)

# yolov4.cfg's anchors (pixels / 608), finest scale (stride 8) first: the
# order of YOLOv4's heads
YOLOV4_ANCHORS = (
    ((12 / 608, 16 / 608), (19 / 608, 36 / 608), (40 / 608, 28 / 608)),
    ((36 / 608, 75 / 608), (76 / 608, 55 / 608), (72 / 608, 146 / 608)),
    ((142 / 608, 110 / 608), (192 / 608, 243 / 608), (459 / 608, 401 / 608)),
)

# yolov7.yaml's anchors (YOLOv4's nine, in pixels / 640), finest scale
# (stride 8) first: the order of YOLOv7's heads
YOLOV7_ANCHORS = (
    ((12 / 640, 16 / 640), (19 / 640, 36 / 640), (40 / 640, 28 / 640)),
    ((36 / 640, 75 / 640), (76 / 640, 55 / 640), (72 / 640, 146 / 640)),
    ((142 / 640, 110 / 640), (192 / 640, 243 / 640), (459 / 640, 401 / 640)),
)

STRIDES = (32, 16, 8)

TURBINE_LABELS = ("dirt", "damage")
NUM_TURBINE_CLASSES = len(TURBINE_LABELS)

# reference: code/config.py:119-200
COCO_LABELS = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)
NUM_COCO_CLASSES = len(COCO_LABELS)


def grid_sizes_for(image_size: int, strides: Sequence[int] = STRIDES) -> tuple:
    """Grid sizes for the detection scales at a given image size."""
    return tuple(image_size // s for s in strides)


def strides_for(backbone: str) -> tuple:
    """Output strides of a backbone's heads: two scales for ``yolov3_tiny``,
    three for the others (as the JAX package's ``load_predictor`` sets
    them), finest first for ``yolov4``, ``yolov7`` and ``rtdetr_r50vd``
    (RT-DETR's three feature levels)."""
    return {"yolov3_tiny": (32, 16), "yolov4": (8, 16, 32),
            "yolov7": (8, 16, 32), "rtdetr_r50vd": (8, 16, 32)}.get(backbone, STRIDES)


def anchors_array(anchors=ANCHORS) -> np.ndarray:
    """Anchors as a (scales, 3, 2) float32 array (scale, anchor, wh),
    normalized."""
    return np.asarray(anchors, dtype=np.float32)


def scaled_anchors_array(anchors, image_size: int = DEF_IMAGE_SIZE) -> np.ndarray:
    """Anchors times their scale's grid size, (3, 3, 2): widths and heights
    in cell units."""
    a = anchors_array(anchors)
    gs = np.asarray(grid_sizes_for(image_size), dtype=np.float32)
    return a * gs[:, None, None]


@dataclasses.dataclass(frozen=True)
class Paths:
    """Filesystem layout (reference: code/config.py:22-33)."""

    project: str = "."

    @property
    def image_folder(self) -> Path:
        return Path(self.project) / "data" / "images"

    @property
    def annotation_folder(self) -> Path:
        return Path(self.project) / "data" / "labels"

    @property
    def weights_folder(self) -> Path:
        return Path(self.project) / "weights"

    @property
    def model_folder(self) -> Path:
        return Path(self.project) / "models"

    @property
    def csv_folder(self) -> Path:
        return Path(self.project) / "data"

    @property
    def coco_weights(self) -> Path:
        return self.weights_folder / "yolov3.weights"

    @property
    def darknet_weights(self) -> Path:
        return self.weights_folder / "darknet53.conv.74"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs."""

    num_classes: int = NUM_COCO_CLASSES
    in_channels: int = 3
    activation: str = "leaky_relu"  # or "mish", or "silu" (YOLOv7)
    # or "cspdarknet53", "yolov3_tiny", "yolov4", "yolov7" or "rtdetr_r50vd"
    backbone: str = "darknet53"
    anchors_per_scale: int = 3
    # Output stride per detection scale, coarsest first.
    strides: tuple = (32, 16, 8)
    # Optional custom architecture through the layer DSL of
    # models/yolov3.py (overrides the backbone choice when set).
    layer_config: Optional[tuple] = None
    # Inference: run the residual stages that ``stage_wins`` selects
    # through the fused residual-stage kernel (ops/kernels/resblock_kernel.py)
    # on CUDA, and a quantized predictor's through the int8 one
    # (ops/kernels/resblock_int8_kernel.py); the same arithmetic as the
    # layer-by-layer path.
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters; keys mirror the reference HPO config
    (reference: code/train.py:171-202,298-301)."""

    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    batch_size: int = 32
    max_num_steps: int = 10000
    warmup: float = 0.01  # fraction of max_num_steps spent in linear warmup
    activation: str = "mish"
    image_size: int = DEF_IMAGE_SIZE
    multi_scale: bool = True
    mosaic: bool = False
    # RAM-cache decoded train/val images across epochs
    cache_images: bool = False
    freeze_backbone: bool = False
    load_weights: bool = False
    load_checkpoint: bool = False
    warmup_enabled: bool = True
    decay_lr: bool = False
    num_batch_to_resize: int = 10
    ignore_iou_threshold: float = 0.5
    seed: int = 424242
    # "bfloat16": the f32 module runs under torch.autocast(bfloat16), with
    # f32 parameters, BN statistics and loss and no GradScaler; "float32":
    # TF32 off (models/blocks.py::full_f32)
    compute_dtype: str = "bfloat16"
    # mAP of the every-10th-epoch eval on the device
    # (ops/map.py::calc_map_device_batched); False: host calc_map
    device_eval: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        return TrainConfig(**{k: v for k, v in d.items() if k in fields})


def load_hyperparam_config(model_folder, config_name: str) -> dict:
    """Read a best_config.json written by HPO (its "config" entry, or the
    whole file when it has none)."""
    with open(Path(model_folder) / config_name, "r") as f:
        payload = json.load(f)
    return payload["config"] if "config" in payload else payload
