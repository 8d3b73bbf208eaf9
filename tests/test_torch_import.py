"""Torch port: importing it, serving with it (folded and int8; Darknet-53,
CSPDarknet-53 and tiny; from a darknet file and a checkpoint; from a bundle
it writes and from the program it exports there; the demo CLI), tuning it
(a toy ASHA search), evaluating with it (``evaluate_map_device`` of the
trainable module) and training with it (``train()``, the data layer, the
darknet loader, the CLI module) imports neither jax nor any module of the
JAX package (yolo_for_turbines_tpu).

Runs in a subprocess because this test process has jax loaded already
(tests/conftest.py).
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
import numpy as np
import torch

import yolo_for_turbines_tpu_torch
from yolo_for_turbines_tpu_torch.config import ANCHORS, ModelConfig
from yolo_for_turbines_tpu_torch import inference, serving
from yolo_for_turbines_tpu_torch.tools import profile_serving
from yolo_for_turbines_tpu_torch.models import quantize
from yolo_for_turbines_tpu_torch.ops.kernels import iou_kernel, resblock_int8_kernel
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan, init_plan
from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
from yolo_for_turbines_tpu_torch.data.dataset import assign_targets
from yolo_for_turbines_tpu_torch.train.evaluate import evaluate_map_device
from yolo_for_turbines_tpu_torch.ops import map as map_ops

sys.path.insert(0, "tests")
from helpers import MINI_LAYERS  # plain data, no jax

cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
plan = build_plan(cfg)
model = folded_from_numpy(plan, init_plan(plan, torch.Generator().manual_seed(0)), cfg)
pred = inference.Predictor(model, device="cpu", image_size=64, max_boxes=8)
x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
images = [np.random.default_rng(1).integers(0, 256, (48, 80, 3), dtype=np.uint8)]
kept, mask = pred.predict_batch(x)
assert tuple(kept.shape) == (2, 8, 6) and mask.dtype == torch.bool
assert bool(torch.isfinite(kept).all())
assert len(pred.predict_images(images)) == 1  # the host letterbox packer too
pred.quantize(x)  # the int8 path: calibrate, quantize, serve
kept, mask = pred.predict_batch(x)
assert tuple(kept.shape) == (2, 8, 6) and bool(torch.isfinite(kept).all())
assert len(pred.predict_images(images)) == 1
# the CSPDarknet-53 and tiny families, bf16 and int8
from helpers import MINI_CSP_LAYERS
from yolo_for_turbines_tpu_torch.config import TINY_ANCHORS
for fam_cfg, anchors in ((ModelConfig(num_classes=2, layer_config=MINI_CSP_LAYERS), ANCHORS),
                         (ModelConfig(num_classes=2, backbone="yolov3_tiny", strides=(32, 16)),
                          TINY_ANCHORS)):
    tree = init_plan(build_plan(fam_cfg), torch.Generator().manual_seed(1))
    fam = inference.Predictor.from_folded(fam_cfg, tree, device="cpu", anchors=anchors,
                                          image_size=64, max_boxes=8,
                                          compute_dtype=torch.bfloat16)
    assert bool(torch.isfinite(fam.predict_batch(x)[0]).all())
    assert len(fam.predict_images(images)) == 1
    fam.quantize(x)
    assert bool(torch.isfinite(fam.predict_batch(x)[0]).all())
iou = iou_kernel.pairwise_iou(torch.rand(5, 4))
assert tuple(iou.shape) == (5, 5)
# one eval of the trainable module on the CPU
trainable = YOLOv3(cfg, generator=torch.Generator().manual_seed(0))
grids = (2, 4, 8)
targets = assign_targets([[0.4, 0.5, 0.3, 0.2, 1]], np.reshape(ANCHORS, (9, 2)), grids)
targets = [np.stack([t, t]) for t in targets]
m = evaluate_map_device([(x, targets)], trainable, ANCHORS, num_classes=2,
                        compute_dtype=torch.float32)
assert 0.0 <= m <= 1.0
assert map_ops.calc_map([], [[0, 0.5, 0.5, 0.1, 0.1, 1, 0]], num_classes=2) == 0.0
# the two loaders: a tiny darknet file the port writes, and a checkpoint
import tempfile
from pathlib import Path
from yolo_for_turbines_tpu_torch.models import darknet_weights
from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
from yolo_for_turbines_tpu_torch.train.checkpoint import save_checkpoint
from yolo_for_turbines_tpu_torch.train.steps import create_train_state
from yolo_for_turbines_tpu_torch.config import TrainConfig
tiny_cfg = ModelConfig(num_classes=2, backbone="yolov3_tiny", strides=(32, 16))
tiny = YOLOv3(tiny_cfg, generator=torch.Generator().manual_seed(2))
with tempfile.TemporaryDirectory() as tmp:
    darknet_weights.export_darknet_weights(tiny.plan, *trainable_to_numpy(tiny),
                                           str(Path(tmp) / "tiny.weights"))
    p = inference.load_predictor(Path(tmp) / "tiny.weights", num_classes=2,
                                 anchors=TINY_ANCHORS, image_size=64, backbone="yolov3_tiny",
                                 device="cpu")
    assert bool(torch.isfinite(p.predict_batch(x)[0]).all())
    save_checkpoint(create_train_state(tiny, TrainConfig()), Path(tmp) / "tiny.ckpt")
    p = inference.load_predictor_from_checkpoint(
        Path(tmp) / "tiny.ckpt", activation="leaky_relu", anchors=TINY_ANCHORS, image_size=64,
        backbone="yolov3_tiny", device="cpu")
    assert bool(torch.isfinite(p.predict_batch(x)[0]).all())
    # the deployment path: an int8 bundle with an exported program served
    # from it, the demo CLI on the tiny file, a toy ASHA search
    import json
    from PIL import Image
    from yolo_for_turbines_tpu_torch.tools import demo
    from yolo_for_turbines_tpu_torch.train.hpo import Choice, tune_model
    bundle = serving.save_predictor(pred, Path(tmp) / "bundle")
    serving.add_export_to_bundle(bundle, batch_size=2, platforms=("cpu",))
    exported = serving.ExportedPredictor(bundle, device="cpu").predict_batch(x)
    live = serving.load_predictor_bundle(bundle, device="cpu").predict_batch(x)
    assert torch.equal(exported[0], live[0]) and torch.equal(exported[1], live[1])
    Image.fromarray(images[0]).save(Path(tmp) / "img.jpg")
    (Path(tmp) / "anchors.json").write_text(json.dumps({"anchors": TINY_ANCHORS}))
    demo.run_cli(["--weights", str(Path(tmp) / "tiny.weights"), "--backbone", "yolov3_tiny",
                  "--num-classes", "2", "--anchors", str(Path(tmp) / "anchors.json"),
                  "--image", str(Path(tmp) / "img.jpg"), "--out", str(Path(tmp) / "p.png"),
                  "--device", "cpu"])
    assert Image.open(Path(tmp) / "p.png").size == (80, 48)
    best = tune_model(lambda c, n, r: (-abs(c["lr"] - 0.01), None),
                      {"lr": Choice((0.1, 0.01))}, num_samples=2, model_folder_path=tmp,
                      grace_period=1, max_epochs=2)
    assert best["config"]["lr"] == 0.01
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "yolo_for_turbines_tpu"))
assert not bad, bad
print("OK")
"""


def test_port_imports_and_serves_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


TRAIN_SCRIPT = r"""
import sys
import tempfile
from pathlib import Path

import torch

from yolo_for_turbines_tpu_torch.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu_torch.data.splits import create_csv_files
from yolo_for_turbines_tpu_torch.data.synthetic import generate_synthetic_dataset
from yolo_for_turbines_tpu_torch.models import darknet_weights
from yolo_for_turbines_tpu_torch.train import __main__ as cli
from yolo_for_turbines_tpu_torch.train import trainer
from yolo_for_turbines_tpu_torch.utils import checked_loss, seed_everything

sys.path.insert(0, "tests")
from helpers import MINI_LAYERS  # plain data, no jax

seed_everything(0)
orig = trainer.Trainer.__init__


def mini(self, train_cfg, model_cfg=None, **kw):
    orig(self, train_cfg, model_cfg=ModelConfig(num_classes=2, layer_config=MINI_LAYERS), **kw)


trainer.Trainer.__init__ = mini
with tempfile.TemporaryDirectory() as tmp:
    root = generate_synthetic_dataset(Path(tmp) / "syn", num_images=6, image_size=(96, 72))
    create_csv_files(root / "images", root / "labels", root, {"train": 0.5, "val": 0.5},
                     image_ext=".jpg")
    tc = TrainConfig(batch_size=2, max_num_steps=2, multi_scale=False, image_size=64,
                     compute_dtype="float32")
    best = trainer.train(tc, root, Path(tmp) / "out", "imp", early_stop=2, num_workers=1,
                         image_folder=root / "images", annotation_folder=root / "labels",
                         device="cpu")
    assert 0.0 <= best <= 1.0
    assert (Path(tmp) / "out" / "best_model_imp.ckpt").exists()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "yolo_for_turbines_tpu"))
assert not bad, bad
print("OK")
"""


def test_port_trains_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # beside other test workers: one thread
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


PARALLEL_SCRIPT = r"""
import datetime
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from yolo_for_turbines_tpu_torch.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan, init_plan
from yolo_for_turbines_tpu_torch.parallel import (
    create_mesh, create_spatial_mesh, shard_batch, shard_spatial_batch)
from yolo_for_turbines_tpu_torch.train.steps import create_train_state, make_train_step

sys.path.insert(0, "tests")
from helpers import MINI_LAYERS  # plain data, no jax

torch.set_num_threads(1)
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    targets = tuple(np.zeros((2, 3, 64 // s, 64 // s, 6), np.float32) for s in (32, 16, 8))
    anchors = torch.ones(3, 3, 2)
    tree = init_plan(build_plan(cfg), torch.Generator().manual_seed(0))
    for mesh, shard in ((create_mesh(device="cpu"), None),
                        (create_spatial_mesh(device="cpu"), shard_spatial_batch)):
        assert mesh.group is not None  # the collectives run, over gloo
        pred = Predictor.from_folded(cfg, tree, mesh=mesh, image_size=64, max_boxes=8)
        kept, mask = pred.predict_batch(x)
        assert tuple(kept.shape) == (2, 8, 6) and bool(torch.isfinite(kept).all())
        model = YOLOv3(cfg, generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, TrainConfig(compute_dtype="float32"))
        xs, ys = (shard_batch((x, targets), mesh) if shard is None
                  else shard(x, targets, mesh))
        m = make_train_step(TrainConfig(compute_dtype="float32"), mesh)(state, xs, ys, anchors)
        assert np.isfinite(float(m["loss"]))
    dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "yolo_for_turbines_tpu"))
assert not bad, bad
print("OK")
"""


def test_port_runs_data_and_spatial_parallelism_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
