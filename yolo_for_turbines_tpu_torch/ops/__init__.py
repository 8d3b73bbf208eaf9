"""Decode, IoU and NMS on torch tensors, plus the CUDA kernels; the
package exports of ``yolo_for_turbines_tpu/ops``."""
from .iou import iou_aligned, calc_iou
from .decode import (
    cells_to_boxes,
    decode_scale,
    decode_all_scales,
    decode_raw_scale,
    decode_raw_all,
)
from .nms import non_max_suppression, batched_nms, nms_single, nms_to_list
from .map import calc_map, calc_map_device
