"""Host-side plotting of detections with PIL (counterpart of
``yolo_for_turbines_tpu/utils/plotting.py``; reference: code/utils.py:418-501).

The JAX package draws with matplotlib; the port draws the same boxes with
``PIL.ImageDraw``, which is all it needs: the same colours (matplotlib's
``tab20b`` sampled at ``linspace(0, 1, n_classes)``), the same line width
and a class label at each box's top-left corner, on an image of the
original size.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# matplotlib's "tab20b" listed colormap, 8-bit RGB
TAB20B = (
    (57, 59, 121), (82, 84, 163), (107, 110, 207), (156, 158, 222),
    (99, 121, 57), (140, 162, 82), (181, 207, 107), (206, 219, 156),
    (140, 109, 49), (189, 158, 57), (231, 186, 82), (231, 203, 148),
    (132, 60, 57), (173, 73, 74), (214, 97, 107), (231, 150, 156),
    (123, 65, 115), (165, 81, 148), (206, 109, 189), (222, 158, 214),
)


def class_colors(n_classes: int) -> List[Tuple[int, int, int]]:
    """``tab20b`` at ``np.linspace(0, 1, n_classes)``, as matplotlib's
    ListedColormap indexes it (``int(v * N)``, the last entry for 1.0)."""
    n = len(TAB20B)
    return [TAB20B[min(int(v * n), n - 1)] for v in np.linspace(0, 1, n_classes)]


def box_corners(box, im_h: int, im_w: int, margin: int = 0) -> Tuple[int, int, int, int]:
    """A normalized [cx, cy, w, h, ...] box -> the pixel corners (x0, y0,
    x1, y1) its outline is drawn on, each kept within ``margin`` pixels of
    the image: an edge beyond that stays off the image, and a huge box (an
    untrained head's exp) is not rasterized over its whole extent."""
    x, y, w, h = (float(v) for v in box[:4])
    tl_x, tl_y = (x - w / 2) * im_w, (y - h / 2) * im_h
    xs = np.clip([tl_x, tl_x + w * im_w], -margin, im_w + margin)
    ys = np.clip([tl_y, tl_y + h * im_h], -margin, im_h + margin)
    return (round(xs[0]), round(ys[0]), round(xs[1]), round(ys[1]))


def plot_image_with_boxes(
    image, boxes: Sequence[Sequence[float]], class_list: Sequence[str],
    image_name: str = "example", savefig: bool = False,
):
    """Draw [cx, cy, w, h, score, class] boxes (normalized) on an image.

    Returns a PIL RGB image of the image's size; with no boxes, the image
    unchanged (a PIL image for uint8 input). ``savefig`` also writes
    ``{image_name}.png``."""
    image = np.array(image)
    if len(boxes) == 0:
        return Image.fromarray(image) if image.dtype == np.uint8 else image

    colors = class_colors(len(class_list))
    im_h, im_w = image.shape[0], image.shape[1]
    out = Image.fromarray(image).convert("RGB")
    draw = ImageDraw.Draw(out)
    font = ImageFont.load_default()
    width = max(1, int(0.003 * max(im_h, im_w)))
    for box in boxes:
        if not np.isfinite(box[:4]).all():
            continue
        label = int(box[5])
        x0, y0, x1, y1 = box_corners(box, im_h, im_w, margin=width + 1)
        draw.rectangle((x0, y0, x1, y1), outline=colors[label], width=width)
        text = class_list[label]
        tx, ty = x0 - 2, y0 - 2
        l, t, r, b = draw.textbbox((tx, ty), text, font=font)
        draw.rectangle((l, t, r, b), fill=colors[label])
        draw.text((tx, ty), text, fill=(255, 255, 255), font=font)
    if savefig:
        out.save(f"{image_name}.png")
    return out


def plot_original(
    original_image, resized_hw, boxes: Sequence[Sequence[float]],
    class_list: Sequence[str],
):
    """Un-letterbox boxes to the original image and plot
    (reference: code/utils.py:475-501)."""
    from ..data.augment import unletterbox_boxes

    o_h, o_w = np.asarray(original_image).shape[:2]
    adjusted = unletterbox_boxes(boxes, (o_h, o_w), resized_hw)
    return plot_image_with_boxes(original_image, adjusted, class_list)
