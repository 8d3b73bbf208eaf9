"""Dataset split tooling: label validation + train/val/test CSV generation
(the port's copy of ``yolo_for_turbines_tpu/data/splits.py``).

Parity with reference code/utils.py:786-848: intersect image/label stems,
validate box ranges, sample an equal count of negative (label-less) images
with a seeded rng(3407), shuffle, and write split CSVs by fraction.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import numpy as np


def check_boxes(annotation_folder, name: str) -> bool:
    """Validate a label txt: cx, cy in [0, 1]; w, h in (0, 1]
    (reference: code/utils.py:786-801)."""
    file_boxes = np.loadtxt(Path(annotation_folder) / name)
    if file_boxes.ndim == 1:
        file_boxes = file_boxes[None, :]
    file_boxes = file_boxes[:, 1:]
    valid_xy = np.logical_and(file_boxes[:, :2] >= 0, file_boxes[:, :2] <= 1)
    valid_wh = np.logical_and(file_boxes[:, 2:] > 0, file_boxes[:, 2:] <= 1)
    return bool(np.all(valid_xy) and np.all(valid_wh))


def create_csv_files(
    image_folder,
    annotation_folder,
    split_folder,
    split_map: Dict[str, float],
    image_ext: str = ".png",
    seed: int = 3407,
) -> None:
    """Write {split}.csv files of (image, label) rows
    (reference: code/utils.py:803-848; same seed and sampling scheme)."""
    images = np.array(sorted(os.listdir(image_folder)))
    labels = np.array(os.listdir(annotation_folder))

    image_names = set(im[: -len(Path(im).suffix)] for im in images)
    label_names = set(lb[: -len(Path(lb).suffix)] for lb in labels)
    common = image_names.intersection(label_names)

    data_list, noobj_list = [], []
    for name in sorted(image_names):
        if name in common and check_boxes(annotation_folder, name + ".txt"):
            data_list.append([name + image_ext, name + ".txt"])
        else:
            noobj_list.append([name + image_ext, "None"])

    rng = np.random.default_rng(seed=seed)
    data_arr = np.array(data_list) if data_list else np.zeros((0, 2), dtype="<U1")
    negative_count = len(common)
    if noobj_list and negative_count:
        noobj_arr = np.array(noobj_list)
        pick = rng.integers(len(noobj_arr), size=negative_count)
        noobj_arr = noobj_arr[pick]
        final = np.concatenate([data_arr, noobj_arr], axis=0)
    else:
        final = data_arr
    shuffle = rng.integers(len(final), size=len(final))
    final = final[shuffle]

    Path(split_folder).mkdir(parents=True, exist_ok=True)
    start = 0
    for split, frac in split_map.items():
        end = start + int(frac * len(final))
        np.savetxt(
            Path(split_folder) / f"{split}.csv",
            final[start:end],
            fmt="%s",
            delimiter=",",
        )
        start = end


def main(argv=None):
    """CSV split CLI (reference: code/utils.py:862-863 runs create_csv_files
    as __main__ with a 70/20/10 split)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", required=True, help="image folder")
    ap.add_argument("--labels", required=True, help="label txt folder")
    ap.add_argument("--out", required=True, help="folder for {split}.csv files")
    ap.add_argument("--train", type=float, default=0.7)
    ap.add_argument("--val", type=float, default=0.2)
    ap.add_argument("--test", type=float, default=0.1)
    ap.add_argument("--image-ext", default=".png")
    ap.add_argument("--seed", type=int, default=3407)
    args = ap.parse_args(argv)
    split_map = {
        k: v
        for k, v in (("train", args.train), ("val", args.val), ("test", args.test))
        if v > 0
    }
    create_csv_files(
        args.images, args.labels, args.out, split_map,
        image_ext=args.image_ext, seed=args.seed,
    )
    print(f"wrote {', '.join(s + '.csv' for s in split_map)} under {args.out}")


if __name__ == "__main__":
    main()
