"""Torch port: the convergence recipes of ``tools/convergence.py`` against
the JAX package's ``benchmarks/convergence_run.py`` and ``Trainer``, on the
CPU.

- R1's and R2's TrainConfig equal, field by field, the JAX TrainConfig that
  ``convergence_run.py`` builds from the recipe's flags.
- The recipe's set and split (``make_set``) equal the JAX generator's and
  splitter's byte for byte, at 12 images.
- The recipe path (mosaic, the image cache, warmup then cosine, no
  multi-scale) through the port's Trainer against the JAX Trainer, on the
  mini model at 64px in float32, one step per epoch: the lr each logs for
  every step agrees within 1e-6 of the peak lr (optax computes the warmup
  as init + (end - init) * frac in f32; measured 5.8e-8), and the loss
  terms of the first step and of each later step, taken from the JAX
  state before it (free runs part after one step, as in
  tests/test_torch_train_steps.py), agree with each other and with a
  float64 forward within MOSAIC_LOSS_RTOL.
- The tool end to end in its own processes: the tiny backbone at 64px, 16
  images, 10 steps (a fused eval at epoch 9), served.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from helpers import MINI_LAYERS
from torch_eval_weights import eval_weights
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.config import TrainConfig as JaxTrainConfig
from yolo_for_turbines_tpu.data import loader as jloader
from yolo_for_turbines_tpu.data import splits as jsplits
from yolo_for_turbines_tpu.data import synthetic as jsynth
from yolo_for_turbines_tpu.parallel.mesh import create_mesh
from yolo_for_turbines_tpu.train import trainer as jtrainer
from yolo_for_turbines_tpu_torch.config import ModelConfig, TURBINE_ANCHORS
from yolo_for_turbines_tpu_torch.data import loader
from yolo_for_turbines_tpu_torch.models.convert import load_trainable, trainable_to_numpy
from yolo_for_turbines_tpu_torch.tools import convergence as conv
from yolo_for_turbines_tpu_torch.train import trainer
from yolo_for_turbines_tpu_torch.train.loss import total_yolo_loss

REPO = Path(__file__).resolve().parents[1]
# loss terms, relative, between the frameworks and of each against a
# float64 forward of the same state and batch. On these mosaic batches both
# frameworks' f32 train-mode terms sit far from float64: over the five steps
# the port's up to 4.2e-4, JAX's up to 1.8e-4, the two apart by up to 4.4e-4
# (obj_loss), where the steps of tests/test_torch_train_steps.py on noise
# batches read 4.5e-6 against their 1e-4. The gate is set above that
# rounding; the float64 terms show that it is rounding on both sides.
MOSAIC_LOSS_RTOL = 1e-3
LR_TOL = 1e-6  # of the peak lr
SIZE = 64


def _convergence_run_config(args: dict) -> JaxTrainConfig:
    """``benchmarks/convergence_run.py``'s TrainConfig for parsed flags
    (its lines building ``tc``), without resume or weight import."""
    return JaxTrainConfig(
        lr=args["lr"], batch_size=args["batch_size"], max_num_steps=args["max_num_steps"],
        multi_scale=not args["no_multi_scale"], mosaic=args["mosaic"], cache_images=True,
        load_checkpoint=False, decay_lr=args["decay_lr"], warmup=args["warmup"],
        load_weights=False, freeze_backbone=False)


# the flags of each JAX run (benchmarks/RESULTS.md): R1 the mosaic run,
# R2 the CSPDarknet-53 run; batch size 32 and 416 images are the defaults
_JAX_FLAGS = {
    "R1": dict(lr=1e-3, warmup=0.05, max_num_steps=550, backbone="darknet53"),
    "R2": dict(lr=5e-4, warmup=0.1, max_num_steps=700, backbone="cspdarknet53"),
}


@pytest.mark.parametrize("name", ["R1", "R2"])
def test_recipe_config_equals_convergence_run(name):
    flags = _JAX_FLAGS[name]
    recipe = conv.RECIPES[name]
    want = _convergence_run_config(dict(flags, batch_size=32, no_multi_scale=True,
                                        mosaic=True, decay_lr=True))
    got = recipe.train_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (recipe.backbone, recipe.num_images, recipe.batch_size) == (flags["backbone"], 416, 32)
    assert recipe.model_config().backbone == flags["backbone"]


def test_recipe_set_and_split_equal_jax_byte_for_byte(tmp_path):
    got = conv.make_set(tmp_path / "port", 12)
    want = tmp_path / "jax"
    jsynth.generate_synthetic_dataset(want, num_images=12)
    jsplits.create_csv_files(want / "images", want / "labels", want,
                             {"train": 0.85, "val": 0.15}, image_ext=".jpg")
    files = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    assert {"train.csv", "val.csv"} <= {str(f) for f in files} and len(files) == 26
    for f in files:
        assert (got / f).read_bytes() == (want / f).read_bytes(), f


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, d):
        self.rows.append(dict(d))


def _set_port_state(pt, jstate):
    """The port Trainer's module, momentum buffers and step from a JAX
    TrainState."""
    load_trainable(pt.model, jax.tree_util.tree_map(np.asarray, jstate.params),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    trace = optax.tree_utils.tree_get(jstate.opt_state, "trace")
    twin = type(pt.model)(pt.model.cfg, generator=torch.Generator().manual_seed(0))
    load_trainable(twin, jax.tree_util.tree_map(np.asarray, trace),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    opt = pt.state.optimizer
    for p, buf in zip(pt.model.parameters(), twin.parameters()):
        opt.state[p]["momentum_buffer"] = buf.detach().clone()
    pt.state.step = int(jstate.step)


def _calibrated(batches):
    """``eval_weights`` with the running statistics taken again over the
    images of ``batches``, as tests/test_torch_train_steps.py's
    ``step_weights`` does: the JAX train-mode moments are shifted by the
    running mean and lose f32 digits when it is far from the batch's."""
    model, params, stats = eval_weights(seed=23, size=SIZE, calibrated=True)
    port = trainer.YOLOv3(model.cfg, generator=torch.Generator().manual_seed(0))
    load_trainable(port, params, stats)
    with torch.no_grad():
        for bn in (m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.reset_running_stats()
            bn.momentum = None  # the cumulative average of one batch is that batch
        port.train()(torch.from_numpy(np.concatenate([x for x, _ in batches])))
    return trainable_to_numpy(port)


def _f64_terms(model, batch, size=SIZE):
    """The train-mode loss terms of ``model``'s state on ``batch`` in
    float64 (a copy; the module is left as it was)."""
    x, y = batch
    twin = copy.deepcopy(model).double().train()
    anchors = trainer.scaled_anchors_for(TURBINE_ANCHORS, size, twin.strides)
    with torch.no_grad():
        _, terms = total_yolo_loss(twin(torch.from_numpy(x).double()),
                                   [torch.from_numpy(t).double() for t in y],
                                   torch.from_numpy(anchors).double())
    return {f"train_{k}": float(v) for k, v in terms.items()}


def test_recipe_path_steps_as_the_jax_trainer(tmp_path):
    """Five one-step epochs of R1's recipe at max_num_steps 40 (2 warmup
    steps, then the cosine), the mini model at 64px, B = 4 over 6 train
    images (1 batch an epoch, drop_last)."""
    root = tmp_path / "data"
    jsynth.generate_synthetic_dataset(root, num_images=8, image_size=(96, 72), seed=4)
    jsplits.create_csv_files(root / "images", root / "labels", root, conv.SPLIT,
                             image_ext=".jpg")
    tc = conv.R1.train_config(batch_size=4, max_num_steps=40, image_size=SIZE,
                              compute_dtype="float32")
    kw = dict(batch_size=4, anchors=TURBINE_ANCHORS, num_workers=1, image_size=SIZE,
              mosaic=True, cache_images=True, **conv.folders(root))
    # loaders of their own draw the batches the trainers' loaders will: the
    # port's mosaic batches equal the JAX loader's bit for bit
    twin, jtwin = loader.get_loaders(root, **kw)[0], jloader.get_loaders(root, **kw)[0]
    batches = [b for _ in range(5) for b in twin]
    jbatches = [b for _ in range(5) for b in jtwin]
    for (x, y), (jx, jy) in zip(batches, jbatches, strict=True):
        assert np.array_equal(x, np.asarray(jx))
        assert all(np.array_equal(t, np.asarray(j)) for t, j in zip(y, jy, strict=True))
    params, stats = _calibrated(batches)
    jt = jtrainer.Trainer(JaxTrainConfig(**dataclasses.asdict(tc)), mesh=create_mesh(1),
                          model_cfg=JaxModelConfig(num_classes=2, layer_config=MINI_LAYERS))
    jt.state = jt.state._replace(params=jax.tree_util.tree_map(np.array, params),
                                 batch_stats=jax.tree_util.tree_map(np.array, stats))
    pt = trainer.Trainer(tc, ModelConfig(num_classes=2, layer_config=MINI_LAYERS), device="cpu")
    jtrain, _, jds = jloader.get_loaders(root, **kw)
    ptrain, _, pds = loader.get_loaders(root, **kw)
    assert len(ptrain) == len(jtrain) == 1
    lrs = []
    for epoch, batch in enumerate(batches):
        _set_port_state(pt, jt.state)
        exact = _f64_terms(pt.model, batch)
        jrows, prows = _Rows(), _Rows()
        jt.train_one_epoch(jds, jtrain, jrows)
        pt.train_one_epoch(pds, ptrain, prows)
        assert pt.state.step == int(jt.state.step) == epoch + 1
        plr = [r["lr"] for r in prows.rows if "lr" in r]
        jlr = [r["lr"] for r in jrows.rows if "lr" in r]
        assert len(plr) == len(jlr) == 1
        assert abs(plr[0] - jlr[0]) <= LR_TOL * tc.lr, (epoch, plr, jlr)
        lrs.append(plr[0])
        got, want = prows.rows[-1], jrows.rows[-1]
        assert got.keys() == want.keys()
        for k, v in exact.items():
            assert abs(got[k] - want[k]) <= MOSAIC_LOSS_RTOL * abs(want[k]), (epoch, k)
            for name, terms in (("port", got), ("jax", want)):
                assert abs(terms[k] - v) <= MOSAIC_LOSS_RTOL * abs(v), (epoch, name, k, terms[k], v)
    # warmup from 1e-6 of the peak, the peak, then the cosine's decay
    assert lrs[0] == pytest.approx(1e-9, rel=1e-6)
    assert lrs[2] == pytest.approx(tc.lr, rel=1e-6) and lrs[4] < lrs[3] < lrs[2]


def test_converge_mode_end_to_end_on_the_cpu(tmp_path):
    """The tool's own CLI: the set made once, the seed trained in a fresh
    process, its best checkpoint served in float32 (the CPU's compute
    dtype) and int8, then deleted."""
    cmd = [sys.executable, "-m", "yolo_for_turbines_tpu_torch.tools.convergence",
           "--recipe", "R1", "--seeds", "3", "--serve", "--device", "cpu",
           "--work-dir", str(tmp_path), "--num-images", "16", "--backbone", "yolov3_tiny",
           "--batch-size", "8", "--max-num-steps", "10", "--image-size", "64",
           "--compute-dtype", "float32"]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          cwd=REPO, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert done.returncode == 0, done.stderr[-3000:]
    rows = [json.loads(line) for line in done.stdout.splitlines()]
    assert len(rows) == 1
    r = rows[0]
    assert (r["recipe"], r["seed"], r["backbone"], r["steps"]) == ("R1", 3, "yolov3_tiny", 10)
    assert r["nan_stop"] is False and len(r["map_trajectory"]) == 1
    assert r["best_map"] == max(r["map_trajectory"]) and 0.0 <= r["best_map"] <= 1.0
    assert len(r["train_loss_by_epoch"]) == len(r["val_loss_by_epoch"]) == 10
    assert all(np.isfinite(r["train_loss_by_epoch"]))
    assert r["wall_s"] > 0 and r["loader_s_per_batch"] > 0
    s = r["serve"]
    assert s["trainer_map_device"] == pytest.approx(s["trainer_map_host"], abs=1e-5)
    for dtype in ("bf16", "int8"):
        served = s[f"served_{dtype}"]
        assert 0.0 <= served["map"] <= 1.0 and served["calls"] == s["val_batches"]
        assert served["survivors_per_image"] >= 0
    # the CPU serves in float32: the float32 predictor's heads are the same
    assert s["served_bf16"]["compute_dtype"] == "float32" and s["heads_vs_f32"] == 0.0
    assert (tmp_path / "data" / "train.csv").exists()
    assert not list(tmp_path.glob("models_*"))  # the checkpoints went with the process
