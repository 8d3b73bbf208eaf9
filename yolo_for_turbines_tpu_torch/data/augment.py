"""Host-side image augmentations in numpy + PIL: the port's copy of
``yolo_for_turbines_tpu/data/augment.py`` (whose package imports jax).

Replicates the reference's Albumentations pipelines
(reference: code/config.py:60-113):

- train: LongestMaxSize + center PadIfNeeded (letterbox) -> HSV jitter
  (hue 2/180, sat 50/255, val 40/255, p=0.5) -> shift-scale (scale 1..1.5,
  shift +-6.25%, p=0.5, constant border) -> horizontal flip (p=0.5) ->
  normalize /255. Boxes are yolo-normalized [cx, cy, w, h, class]; after
  geometric transforms they are clipped to the image and dropped when less
  than 40% of the transformed box remains visible (min_visibility=0.4).
- test: letterbox + normalize.
- image-only: letterbox + normalize, no box handling.

Randomness comes from an explicit np.random.Generator, drawn in the JAX
package's order, so the same generator gives the same labels (and, on the
numpy path, the same pixels) in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

MIN_VISIBILITY = 0.4  # reference: code/config.py:82


def resize_longest(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the longest side equals `size`, keeping aspect ratio."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    if (nh, nw) == (h, w):
        return img
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def pad_center(
    img: np.ndarray, min_h: int, min_w: int, fill: int = 0
) -> Tuple[np.ndarray, int, int]:
    """Center-pad to at least (min_h, min_w). Returns (img, pad_top, pad_left)."""
    h, w = img.shape[:2]
    pad_h, pad_w = max(0, min_h - h), max(0, min_w - w)
    top, left = pad_h // 2, pad_w // 2
    if pad_h == 0 and pad_w == 0:
        return img, 0, 0
    out = np.full((h + pad_h, w + pad_w) + img.shape[2:], fill, dtype=img.dtype)
    out[top : top + h, left : left + w] = img
    return out, top, left


def letterbox_box_geometry(h0: int, w0: int, size: int) -> Tuple[int, int, int, int]:
    """(nh, nw, top, left) of a letterbox from (h0, w0) to (size, size)."""
    scale = size / max(h0, w0)
    nh, nw = max(1, round(h0 * scale)), max(1, round(w0 * scale))
    return nh, nw, (size - nh) // 2, (size - nw) // 2


def letterbox_boxes(boxes: np.ndarray, h0: int, w0: int, size: int) -> np.ndarray:
    """Box-only letterbox transform (same mapping `letterbox` applies)."""
    nh, nw, top, left = letterbox_box_geometry(h0, w0, size)
    boxes = np.asarray(boxes, np.float64).copy()
    if len(boxes):
        boxes[:, 0] = (boxes[:, 0] * nw + left) / size
        boxes[:, 1] = (boxes[:, 1] * nh + top) / size
        boxes[:, 2] = boxes[:, 2] * nw / size
        boxes[:, 3] = boxes[:, 3] * nh / size
    return boxes


def letterbox(
    img: np.ndarray, boxes: Optional[np.ndarray], size: int, fill: int = 0
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """LongestMaxSize + center pad to (size, size); adjusts normalized boxes."""
    h0, w0 = img.shape[:2]
    img = resize_longest(img, size)
    img, _, _ = pad_center(img, size, size, fill)
    if boxes is not None and len(boxes):
        boxes = letterbox_boxes(boxes, h0, w0, size)
    return img, boxes


def unletterbox_boxes(
    boxes: Sequence[Sequence[float]], original_hw: Tuple[int, int],
    resized_hw: Tuple[int, int],
) -> List[List[float]]:
    """Map normalized letterboxed boxes back to the original image frame."""
    o_h, o_w = original_hw
    r_h, r_w = resized_hw
    scale = min(r_w / o_w, r_h / o_h)
    new_w, new_h = int(o_w * scale), int(o_h * scale)
    pad_w, pad_h = (r_w - new_w) // 2, (r_h - new_h) // 2
    out = []
    for box in boxes:
        out.append(
            [
                (box[0] * r_w - pad_w) / new_w,
                (box[1] * r_h - pad_h) / new_h,
                box[2] * r_w / new_w,
                box[3] * r_h / new_h,
            ]
            + list(box[4:])
        )
    return out


def clip_boxes_min_visibility(
    boxes: np.ndarray, min_visibility: float = MIN_VISIBILITY
) -> np.ndarray:
    """Clip normalized cxcywh boxes to [0, 1]; drop those with less than
    `min_visibility` of their (pre-clip) area remaining, and zero-area boxes."""
    if len(boxes) == 0:
        return boxes
    b = np.asarray(boxes, np.float64)
    x1 = b[:, 0] - b[:, 2] / 2
    y1 = b[:, 1] - b[:, 3] / 2
    x2 = b[:, 0] + b[:, 2] / 2
    y2 = b[:, 1] + b[:, 3] / 2
    area = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    cx1, cy1 = np.clip(x1, 0, 1), np.clip(y1, 0, 1)
    cx2, cy2 = np.clip(x2, 0, 1), np.clip(y2, 0, 1)
    carea = np.maximum(0, cx2 - cx1) * np.maximum(0, cy2 - cy1)
    with np.errstate(invalid="ignore", divide="ignore"):
        vis = np.where(area > 0, carea / area, 0.0)
    keep = (vis >= min_visibility) & (carea > 0)
    out = b[keep].copy()
    if len(out):
        out[:, 0] = (cx1[keep] + cx2[keep]) / 2
        out[:, 1] = (cy1[keep] + cy2[keep]) / 2
        out[:, 2] = cx2[keep] - cx1[keep]
        out[:, 3] = cy2[keep] - cy1[keep]
    return out


# ---------------------------------------------------------------------------
# Photometric / geometric random augs
# ---------------------------------------------------------------------------


def _draw_hsv_shifts(
    rng: np.random.Generator,
    hue_shift: float = 2.0,
    sat_shift: float = 50.0,
    val_shift: float = 40.0,
) -> Tuple[float, float, float]:
    """(dh, ds, dv) in [0,1]-HSV units (OpenCV-unit limits: H/180, S,V/255)."""
    return (
        rng.uniform(-hue_shift, hue_shift) / 180.0,
        rng.uniform(-sat_shift, sat_shift) / 255.0,
        rng.uniform(-val_shift, val_shift) / 255.0,
    )


def apply_hsv_shift(img: np.ndarray, dh: float, ds: float, dv: float) -> np.ndarray:
    """Shift HSV of a uint8 RGB image; vectorized f32 (matplotlib's
    rgb_to_hsv/hsv_to_rgb round-trip costs ~79 ms per 416px image on one
    core; this runs in ~8 ms, and the C++ fused path does it per-pixel)."""
    rgb = img.astype(np.float32) / 255.0
    mx = rgb.max(axis=-1)
    mn = rgb.min(axis=-1)
    d = mx - mn
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        hr = np.where(mx == r, (g - b) / d, 0.0)
        hg = np.where((mx == g) & (mx != r), 2.0 + (b - r) / d, 0.0)
        hb = np.where((mx == b) & (mx != r) & (mx != g), 4.0 + (r - g) / d, 0.0)
        h = np.where(d > 0, (hr + hg + hb) / 6.0, 0.0)
        s = np.where(mx > 0, d / mx, 0.0)
    h = (h + dh) % 1.0
    s = np.clip(s + ds, 0.0, 1.0)
    v = np.clip(mx + dv, 0.0, 1.0)

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.empty_like(rgb)
    # sector tables (one np.choose gather per channel beats 6 np.select masks)
    out[..., 0] = np.choose(i, (v, q, p, p, t, v))
    out[..., 1] = np.choose(i, (t, v, v, q, p, p))
    out[..., 2] = np.choose(i, (p, p, t, v, v, q))
    return (out * 255.0).astype(img.dtype)


def hsv_jitter(
    img: np.ndarray,
    rng: np.random.Generator,
    hue_shift: float = 2.0,
    sat_shift: float = 50.0,
    val_shift: float = 40.0,
) -> np.ndarray:
    """HueSaturationValue with OpenCV-unit limits (H/180, S,V/255)."""
    dh, ds, dv = _draw_hsv_shifts(rng, hue_shift, sat_shift, val_shift)
    return apply_hsv_shift(img, dh, ds, dv)


def shift_scale(
    img: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    shift_limit: float = 0.0625,
    scale_low: float = 1.0,
    scale_high: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """ShiftScaleRotate with rotate=0: scale about the center + translate.

    scale_limit=(0, 0.5) in the reference means scale factor in [1.0, 1.5]
    (reference: code/config.py:72); shift_limit is Albumentations' default.
    Border is constant 0.
    """
    h, w = img.shape[:2]
    s = rng.uniform(scale_low, scale_high)
    dx = rng.uniform(-shift_limit, shift_limit)
    dy = rng.uniform(-shift_limit, shift_limit)

    # PIL's AFFINE takes the *inverse* map: output (x, y) -> input coords.
    # Forward: x' = (x - cx) * s + cx + dx*w  =>  x = (x' - cx - dx*w)/s + cx
    cx, cy = w / 2.0, h / 2.0
    inv = (
        1 / s, 0.0, cx - (cx + dx * w) / s,
        0.0, 1 / s, cy - (cy + dy * h) / s,
    )
    out = np.asarray(
        Image.fromarray(img).transform((w, h), Image.AFFINE, inv, Image.BILINEAR)
    )
    return out, shift_scale_boxes(boxes, s, dx, dy)


def shift_scale_boxes(boxes: np.ndarray, s: float, dx: float, dy: float) -> np.ndarray:
    """Box-only shift-scale (same mapping `shift_scale` applies), with the
    min-visibility clip."""
    if not len(boxes):
        return boxes
    b = np.asarray(boxes, np.float64).copy()
    b[:, 0] = (b[:, 0] - 0.5) * s + 0.5 + dx
    b[:, 1] = (b[:, 1] - 0.5) * s + 0.5 + dy
    b[:, 2] *= s
    b[:, 3] *= s
    return clip_boxes_min_visibility(b)


def hflip(img: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    img = img[:, ::-1].copy()
    if len(boxes):
        boxes = np.asarray(boxes, np.float64).copy()
        boxes[:, 0] = 1.0 - boxes[:, 0]
    return img, boxes


# ---------------------------------------------------------------------------
# Composed pipelines (reference transform-factory equivalents)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Transform:
    """A composed augmentation pipeline over (image, yolo boxes).

    Calling convention mirrors Albumentations Compose:
    `t(image=img, bboxes=boxes, rng=...)` -> {"image": ..., "bboxes": ...}.
    Output image is float32 HWC in [0, 1] (NHWC, as the model takes it;
    the reference emits CHW tensors via ToTensorV2).
    """

    size: Optional[int]
    train: bool
    letterbox_first: bool = True
    use_native: bool = True  # fused C++ path when the library is available

    def __call__(self, image, bboxes=None, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        boxes = (
            np.asarray(bboxes, np.float64).reshape(-1, 5)
            if bboxes is not None and len(bboxes)
            else np.zeros((0, 5))
        )
        if self.train and self.use_native and self.size is not None:
            out = self._native_train(image, boxes, rng)
            if out is not None:
                return out
        if self.letterbox_first and self.size is not None:
            image, boxes = letterbox(image, boxes, self.size)
            boxes = clip_boxes_min_visibility(boxes) if len(boxes) else boxes
        if self.train:
            if rng.uniform() < 0.5:
                image = hsv_jitter(image, rng)
            if rng.uniform() < 0.5:
                image, boxes = shift_scale(image, boxes, rng)
            if rng.uniform() < 0.5:
                image, boxes = hflip(image, boxes)
        image = image.astype(np.float32) / 255.0
        return {"image": image, "bboxes": boxes}

    def _native_train(self, image, boxes, rng):
        """Fused C++ train path: ONE resample for letterbox+shift-scale+flip,
        HSV + /255 in the same pass (native/augment.cpp::train_augment_one).

        Draws from `rng` in exactly the numpy path's order (hsv gate,
        hsv shifts, affine gate, affine params, flip gate) and applies the
        identical parameters to the boxes in numpy, so labels match the
        numpy path bit-for-bit for a given generator state. Returns None when
        the native library or input dtype is unusable (the caller then
        takes the numpy path).

        Documented pixel-level divergences from the numpy path (within
        augmentation noise; distributions identical): single resample
        instead of letterbox-then-affine, HSV applied after the geometry
        instead of between, pad pixels stay 0 instead of receiving the HSV
        value shift.
        """
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            return None
        from ..native import train_augment

        use_hsv = rng.uniform() < 0.5
        dh, ds, dv = _draw_hsv_shifts(rng) if use_hsv else (0.0, 0.0, 0.0)
        use_affine = rng.uniform() < 0.5
        if use_affine:
            s = rng.uniform(1.0, 1.5)
            dx = rng.uniform(-0.0625, 0.0625)
            dy = rng.uniform(-0.0625, 0.0625)
        else:
            s, dx, dy = 1.0, 0.0, 0.0
        use_flip = rng.uniform() < 0.5

        h0, w0 = image.shape[:2]
        out = train_augment(
            image,
            self.size,
            do_affine=use_affine, scale=s, dx=dx, dy=dy,
            flip=use_flip,
            do_hsv=use_hsv, dh=dh, ds=ds, dv=dv,
        )
        if out is None:
            return None

        if self.letterbox_first:
            boxes = letterbox_boxes(boxes, h0, w0, self.size)
            boxes = clip_boxes_min_visibility(boxes) if len(boxes) else boxes
        if use_affine:
            boxes = shift_scale_boxes(boxes, s, dx, dy)
        if use_flip and len(boxes):
            boxes = np.asarray(boxes, np.float64).copy()
            boxes[:, 0] = 1.0 - boxes[:, 0]
        return {"image": out, "bboxes": boxes}


def set_train_transforms(image_size: int, mosaic: bool = True) -> Transform:
    """Train pipeline; when mosaic, the image is already (size, size) so the
    letterbox stage is skipped (reference: code/config.py:77-87)."""
    return Transform(size=image_size, train=True, letterbox_first=not mosaic)


def test_transforms(image_size: int) -> Transform:
    return Transform(size=image_size, train=False)


# Reference-parity name starts with "test_"; keep pytest from collecting it.
test_transforms.__test__ = False


def set_only_image_transforms(image_size: int) -> Transform:
    return Transform(size=image_size, train=False)
