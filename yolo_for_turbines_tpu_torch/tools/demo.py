"""Inference demo CLI (counterpart of ``yolo_for_turbines_tpu/tools/demo.py``;
reference: code/demo.py): load a model, letterbox an image, run the
forward -> decode -> NMS pipeline (one ``predict_image``: on the card the
letterbox is K10 on the device and K1 runs once), and draw class-labelled
boxes on the original image.

    python -m yolo_for_turbines_tpu_torch.tools.demo --weights weights/yolov3.weights \\
        --image examples/Tram.jpg --out out.png

A trained turbine model from the port's trainer, with its k-means anchors
(``tools/anchors.py``):

    python -m yolo_for_turbines_tpu_torch.tools.demo \\
        --checkpoint models/best_model_x.ckpt --anchors anchors.json \\
        --num-classes 2 --activation mish --image photo.jpg

The model runs on ``--device``: ``cuda`` unless told otherwise; with no
CUDA device it raises. The JAX package's Streamlit app is not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image

from .. import config as cfg
from ..inference import Predictor, load_predictor, load_predictor_from_checkpoint
from ..utils.plotting import plot_image_with_boxes


def predict(predictor: Predictor, np_image: np.ndarray, class_list):
    """One image -> (rows of (label, score), boxes in original frame)
    (reference: code/demo.py:30-66)."""
    boxes = predictor.predict_image(np_image)
    rows = [
        {"label": class_list[int(b[5])], "confidence": round(float(b[4]), 4)}
        for b in boxes
    ]
    return rows, boxes


def run_cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="darknet weight file")
    src.add_argument("--checkpoint",
                     help="checkpoint of the port's trainer (a trained turbine model)")
    ap.add_argument("--anchors", default=None,
                    help="anchors JSON from tools/anchors.py; a --checkpoint trained "
                         "with k-means anchors needs its own (defaults: COCO anchors "
                         "for --weights, TURBINE_ANCHORS for --checkpoint)")
    ap.add_argument("--backbone", default="darknet53",
                    choices=("darknet53", "cspdarknet53", "yolov3_tiny"))
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default="prediction.png")
    ap.add_argument("--num-classes", type=int, default=cfg.NUM_COCO_CLASSES)
    ap.add_argument("--activation", default="leaky_relu")
    ap.add_argument("--conf", type=float, default=cfg.CONF_THRESHOLD)
    ap.add_argument("--nms-iou", type=float, default=cfg.NMS_IOU_THRESHOLD)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    model_path = args.weights or args.checkpoint
    for path_arg, what in ((model_path, "model"), (args.image, "image")):
        if not Path(path_arg).exists():
            print(f"error: {what} file not found: {path_arg}", file=sys.stderr)
            raise SystemExit(2)

    anchors = None
    if args.anchors:
        anchors = np.asarray(
            json.loads(Path(args.anchors).read_text())["anchors"], np.float32
        )

    class_list = (
        cfg.COCO_LABELS if args.num_classes == cfg.NUM_COCO_CLASSES
        else cfg.TURBINE_LABELS
    )
    kw = {"num_classes": args.num_classes, "activation": args.activation,
          "conf_threshold": args.conf, "nms_iou_threshold": args.nms_iou,
          "backbone": args.backbone, "device": args.device}
    if args.checkpoint:
        predictor = load_predictor_from_checkpoint(
            args.checkpoint,
            anchors=anchors if anchors is not None else cfg.TURBINE_ANCHORS, **kw)
    else:
        predictor = load_predictor(
            args.weights, anchors=anchors if anchors is not None else cfg.ANCHORS, **kw)
    image = np.array(Image.open(args.image).convert("RGB"), dtype=np.uint8)
    rows, boxes = predict(predictor, image, class_list)
    for r in rows:
        print(f"{r['label']}: {r['confidence']}")
    rendered = plot_image_with_boxes(image, boxes, class_list)
    rendered.convert("RGB").save(args.out)
    print(f"Saved {args.out} ({len(boxes)} detections)")


if __name__ == "__main__":
    run_cli()
