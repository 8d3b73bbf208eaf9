"""Training CLI: ``python -m yolo_for_turbines_tpu_torch.train ...``

Mirrors the reference's ``python train.py`` entry (reference:
code/train.py:291-309): seed everything, load a best_config.json if given,
run train() on ``--device`` (``cuda`` unless told otherwise; with no CUDA
device it raises).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..config import TrainConfig
from ..utils.seed import seed_everything
from .hpo import load_config
from .trainer import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv-folder", default="data")
    ap.add_argument("--image-folder", default=None)
    ap.add_argument("--annotation-folder", default=None)
    ap.add_argument("--model-folder", default="models")
    ap.add_argument("--identifier", default="run")
    ap.add_argument("--config", default=None,
                    help="best_config.json from HPO (reference: train.py:298)")
    ap.add_argument("--weights", default=None,
                    help="darknet53.conv.74 backbone (enables --load-weights)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--backbone", default="darknet53",
                    choices=("darknet53", "cspdarknet53"))
    ap.add_argument("--early-stop", type=int, default=100)
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=424242)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-num-steps", type=int, default=None)
    ap.add_argument("--activation", default=None)
    ap.add_argument("--mosaic", action="store_true")
    ap.add_argument("--cache-images", action="store_true")
    ap.add_argument("--freeze-backbone", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    seed_everything(args.seed)

    overrides = {}
    if args.config:
        path = Path(args.config)
        overrides.update(load_config(path.parent, path.name))
    for k in ("lr", "batch_size", "max_num_steps", "activation"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.mosaic:
        overrides["mosaic"] = True
    if args.cache_images:
        overrides["cache_images"] = True
    if args.freeze_backbone:
        overrides["freeze_backbone"] = True
    if args.weights:
        overrides["load_weights"] = True
    if args.checkpoint:
        overrides["load_checkpoint"] = True
    tc = TrainConfig(
        **{k: v for k, v in overrides.items() if k in TrainConfig.__dataclass_fields__}
    )
    print("TrainConfig:", json.dumps(json.loads(tc.to_json()), indent=2))

    best_map = train(
        tc,
        args.csv_folder,
        args.model_folder,
        identifier=args.identifier,
        early_stop=args.early_stop,
        checkpoint_name=args.checkpoint,
        image_folder=args.image_folder,
        annotation_folder=args.annotation_folder,
        weights_path=args.weights,
        num_workers=args.num_workers,
        backbone=args.backbone,
        device=args.device,
    )
    print(f"Best mAP: {best_map}")


if __name__ == "__main__":
    main()
