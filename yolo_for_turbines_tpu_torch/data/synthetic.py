"""Synthetic detection dataset generator (shape-based, 2 classes; the
port's copy of ``yolo_for_turbines_tpu/data/synthetic.py``: the same seed
writes the same bytes).

The reference's own proof of life is a trained detector on a private
wind-turbine dataset (reference: README.md:40, code/train.py:158-239) that
is not public. This module generates a
turbine-like stand-in — JPEG photos with box-annotated "defects" — good
enough to drive the FULL training loop (multi-scale buckets, mosaic, fused
C++ augmenter, device eval, checkpoint/resume) to a converged mAP on real
hardware, which exercises loss -> gradients -> BN stats -> decode -> NMS ->
mAP agreement end to end.

Design constraints that make the task learnable but not trivial:
- class is SHAPE (0 = filled rectangle, 1 = filled ellipse), not color —
  the train transforms jitter hue/saturation, so a color-keyed class would
  be corrupted by the reference's own augmentation pipeline;
- object colors and background texture are randomized so the detector must
  key on geometry;
- 1-3 objects per image with free overlap, sizes 12-35% of the short side.

Every image gets a label file (no negatives): the reference's CSV split
tooling pads negatives to EQUAL the positive count when any exist
(code/utils.py:803-848), which would halve the effective train set here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw


def generate_synthetic_dataset(
    root,
    num_images: int = 416,
    image_size=(640, 480),
    num_classes: int = 2,
    max_objects: int = 3,
    seed: int = 0,
    quality: int = 90,
    box_frac=(0.12, 0.35),
) -> Path:
    """Write images/*.jpg + labels/*.txt under `root`. Returns root.

    `box_frac`: object width range as a fraction of the short side. The
    default makes objects several stride-8 cells wide at 416px; a small
    range like (0.02, 0.045) on high-resolution sources (e.g. 1280x960)
    produces defects that letterbox down to ~6-14px at 416 -- the regime
    the reference's demo throws away by resizing every upload to one
    416px tile (reference: code/demo.py:37-39) and that high-resolution
    inference recovers."""
    root = Path(root)
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = image_size
    short = min(w, h)

    for i in range(num_images):
        # textured background: low-frequency noise around a random gray
        base = rng.uniform(60, 180)
        noise = rng.normal(0, 18, (h // 8, w // 8, 3))
        bg = np.clip(
            base
            + np.kron(noise, np.ones((8, 8, 1)))[:h, :w, :]
            + rng.normal(0, 6, (h, w, 3)),
            0,
            255,
        ).astype(np.uint8)
        img = Image.fromarray(bg)
        draw = ImageDraw.Draw(img)

        rows = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cls = int(rng.integers(num_classes))
            bw = int(rng.uniform(*box_frac) * short)
            bh = int(bw * rng.uniform(0.7, 1.4))
            x0 = int(rng.uniform(0, w - bw))
            y0 = int(rng.uniform(0, h - bh))
            # bright-ish random color, clearly off-background
            color = tuple(int(c) for c in rng.uniform(120, 255, 3))
            outline = tuple(max(0, c - 90) for c in color)
            box = (x0, y0, x0 + bw, y0 + bh)
            # outline scales with the box so small defects aren't all edge
            lw = max(1, min(3, bw // 12))
            if cls == 0:
                draw.rectangle(box, fill=color, outline=outline, width=lw)
            else:
                draw.ellipse(box, fill=color, outline=outline, width=lw)
            cx, cy = (x0 + bw / 2) / w, (y0 + bh / 2) / h
            rows.append(f"{cls} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}")

        img.save(img_dir / f"syn{i:05d}.jpg", quality=quality)
        (lbl_dir / f"syn{i:05d}.txt").write_text("\n".join(rows) + "\n")
    return root


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-images", type=int, default=416)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--splits", default="train:0.85,val:0.15",
        help="comma list of name:frac; also writes split CSVs",
    )
    args = ap.parse_args()
    root = generate_synthetic_dataset(
        args.out, num_images=args.num_images, seed=args.seed
    )
    if args.splits:
        from .splits import create_csv_files

        split_map = {
            name: float(frac)
            for name, frac in (s.split(":") for s in args.splits.split(","))
        }
        create_csv_files(
            root / "images", root / "labels", root, split_map, image_ext=".jpg"
        )
    print(f"wrote {args.num_images} images under {root}")


if __name__ == "__main__":
    main()
