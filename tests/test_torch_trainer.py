"""Torch port: the Trainer, ``train()`` and the training CLI
(``yolo_for_turbines_tpu_torch/train/trainer.py``, ``train/__main__.py``)
against the JAX package's, on the mini model (tests/helpers.py) at 64px,
float32, on the CPU (``device="cpu"``; without it they need a CUDA device).

The epoch comparisons load the same calibrated weights
(``torch_eval_weights.py``: objectness spread around the 0.5 threshold) into
both trainers and read the same batches (one loader worker), so the logged
losses, accuracies and mAP agree: the losses within 1e-4 relative
(measured 1.4e-6), the accuracies and mAP within 1e-6.
"""

import json

import jax
import numpy as np
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
from yolo_for_turbines_tpu_torch.config import ModelConfig, TrainConfig, TURBINE_ANCHORS
from yolo_for_turbines_tpu_torch.data import loader
from yolo_for_turbines_tpu_torch.models.convert import load_trainable
from yolo_for_turbines_tpu_torch.train import __main__ as cli
from yolo_for_turbines_tpu_torch.train import trainer
from yolo_for_turbines_tpu_torch.train.checkpoint import load_checkpoint

LOSS_RTOL = 1e-4
SIZE = 64
BASE = dict(lr=1e-3, batch_size=4, max_num_steps=10, warmup_enabled=False, multi_scale=False,
            image_size=SIZE, compute_dtype="float32")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """14 synthetic JPEGs with 1-3 boxes each, split 60 / 40."""
    root = tmp_path_factory.mktemp("trainer")
    jsynth.generate_synthetic_dataset(root, num_images=14, image_size=(96, 72), seed=2)
    jsplits.create_csv_files(root / "images", root / "labels", root,
                             {"train": 0.6, "val": 0.4}, image_ext=".jpg")
    return root


@pytest.fixture
def mini(monkeypatch):
    """train() builds the mini model instead of full Darknet-53."""
    orig = trainer.Trainer.__init__

    def patched(self, train_cfg, model_cfg=None, **kw):
        orig(self, train_cfg, model_cfg=ModelConfig(num_classes=2, activation=train_cfg.activation,
                                                    layer_config=MINI_LAYERS), **kw)

    monkeypatch.setattr(trainer.Trainer, "__init__", patched)


def _folders(root):
    return dict(image_folder=root / "images", annotation_folder=root / "labels")


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, d):
        self.rows.append(dict(d))

    def merged(self):
        out = {}
        for r in self.rows:
            out.update(r)
        return out


def test_train_end_to_end_on_the_cpu(mini, data_dir, tmp_path):
    """10 epochs of two steps: the fused eval at epoch 9, metrics, and a
    checkpoint that loads back into a Trainer and resumes at its step."""
    tc = TrainConfig(**{**BASE, "max_num_steps": 20})
    maps = []
    best = trainer.train(tc, data_dir, tmp_path, identifier="e2e", early_stop=5,
                         num_workers=2, device="cpu", report_callback=maps.append,
                         **_folders(data_dir))
    assert 0.0 <= best <= 1.0 and len(maps) == 1  # epoch 9 only
    lines = [json.loads(line) for line in open(tmp_path / "YOLOv3_Turbine_Detection_e2e_metrics.jsonl")]
    keys = set().union(*lines)
    assert {"train_loss", "val_loss", "lr", "mAP", "class_accuracy", "obj_accuracy",
            "noobj_accuracy", "time_elapsed_in_hours", "config"} <= keys
    assert sum("lr" in line for line in lines) == 20
    assert lines[0]["config"]["anchors"] == np.asarray(TURBINE_ANCHORS, np.float32).tolist()
    ckpt = tmp_path / "best_model_e2e.ckpt"
    t = trainer.Trainer(tc, ModelConfig(num_classes=2, layer_config=MINI_LAYERS), device="cpu")
    load_checkpoint(t.state, ckpt)
    assert 0 <= t.state.step <= 20
    # a resumed run at the step cap trains no further
    resumed = TrainConfig(**{**BASE, "max_num_steps": 20, "load_checkpoint": True})
    trainer.train(resumed, data_dir, tmp_path, identifier="e2e_resume", early_stop=5,
                  checkpoint_name=ckpt.name, num_workers=2, device="cpu", **_folders(data_dir))


@pytest.fixture(scope="module")
def pair(data_dir):
    """A JAX Trainer and a port Trainer holding the same calibrated weights,
    with their val loaders."""
    model, params, stats = eval_weights(seed=21, size=SIZE, calibrated=True)
    jt = jtrainer.Trainer(JaxTrainConfig(**BASE), mesh=create_mesh(1),
                          model_cfg=JaxModelConfig(num_classes=2, layer_config=MINI_LAYERS))
    jt.state = jt.state._replace(params=jax.tree_util.tree_map(np.array, params),
                                 batch_stats=jax.tree_util.tree_map(np.array, stats))
    pt = trainer.Trainer(TrainConfig(**BASE), ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                         device="cpu")
    load_trainable(pt.model, params, stats)
    kw = dict(batch_size=4, anchors=TURBINE_ANCHORS, num_workers=1, image_size=SIZE,
              **_folders(data_dir))
    return jt, pt, jloader.get_loaders(data_dir, **kw), loader.get_loaders(data_dir, **kw)


def _close(got, want):
    for k, v in want.items():
        if k.startswith(("val_", "train_")):
            assert abs(got[k] - v) <= LOSS_RTOL * abs(v), (k, got[k], v)
        else:
            assert got[k] == pytest.approx(v, abs=1e-6), k


@pytest.mark.parametrize("epoch", [0, 9])
def test_val_epoch_matches_jax(pair, epoch):
    jt, pt, jl, pl = pair
    jrows, prows = _Rows(), _Rows()
    want = jt.val_one_epoch(jl[1], epoch, jrows)
    got = pt.val_one_epoch(pl[1], epoch, prows)
    assert (got[1] is None) == (want[1] is None) == (epoch != 9)
    assert prows.merged().keys() == jrows.merged().keys()
    _close(prows.merged(), jrows.merged())
    if epoch == 9:
        assert got[1] == pytest.approx(want[1], abs=1e-6)


def test_fused_eval_host_map_equals_device_map(pair):
    _, pt, _, pl = pair
    dev = pt.val_one_epoch(pl[1], 9, _Rows())[1]
    host = trainer.Trainer(TrainConfig(**{**BASE, "device_eval": False}),
                           ModelConfig(num_classes=2, layer_config=MINI_LAYERS), device="cpu")
    host.model.load_state_dict(pt.model.state_dict())
    assert host.val_one_epoch(pl[1], 9, _Rows())[1] == pytest.approx(dev, abs=1e-5)


def test_train_epoch_matches_jax(data_dir):
    """One epoch (one step) from the same weights over the same batch: the
    logged train losses and lr agree. The JAX trainer runs on one CPU device
    (its data-parallel mesh waits for the port's parallel slice)."""
    model, params, stats = eval_weights(seed=22, size=SIZE, calibrated=True)
    cfg = {**BASE, "max_num_steps": 1}
    jt = jtrainer.Trainer(JaxTrainConfig(**cfg), mesh=create_mesh(1),
                          model_cfg=JaxModelConfig(num_classes=2, layer_config=MINI_LAYERS))
    jt.state = jt.state._replace(params=jax.tree_util.tree_map(np.array, params),
                                 batch_stats=jax.tree_util.tree_map(np.array, stats))
    pt = trainer.Trainer(TrainConfig(**cfg), ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                         device="cpu")
    load_trainable(pt.model, params, stats)
    kw = dict(batch_size=4, anchors=TURBINE_ANCHORS, num_workers=1, image_size=SIZE,
              **_folders(data_dir))
    jtrain, _, jds = jloader.get_loaders(data_dir, **kw)
    ptrain, _, pds = loader.get_loaders(data_dir, **kw)
    jrows, prows = _Rows(), _Rows()
    want = jt.train_one_epoch(jds, jtrain, jrows)
    got = pt.train_one_epoch(pds, ptrain, prows)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert [r["lr"] for r in prows.rows if "lr" in r] == pytest.approx(
        [r["lr"] for r in jrows.rows if "lr" in r], rel=1e-6)
    _close(prows.merged(), {k: v for k, v in jrows.merged().items() if k != "lr"})
    assert pt.state.step == int(jt.state.step) == 1


def test_nan_loss_raises(data_dir):
    pt = trainer.Trainer(TrainConfig(**{**BASE, "lr": 1e30, "max_num_steps": 3}),
                         ModelConfig(num_classes=2, layer_config=MINI_LAYERS), device="cpu")
    train_loader, _, train_ds = loader.get_loaders(
        data_dir, batch_size=2, anchors=TURBINE_ANCHORS, num_workers=1, image_size=SIZE,
        **_folders(data_dir))
    with pytest.raises(ValueError, match="Nan loss"):
        pt.train_one_epoch(train_ds, train_loader, _Rows())


def test_prewarm_leaves_the_state_untouched():
    pt = trainer.Trainer(TrainConfig(**{**BASE, "batch_size": 2}),
                         ModelConfig(num_classes=2, layer_config=MINI_LAYERS), device="cpu")
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    pt.prewarm(sizes=(64, 96))
    assert pt.state.step == 0 and not pt.state.optimizer.state
    assert all(torch.equal(before[k], v) for k, v in pt.model.state_dict().items())


def test_seeded_init_and_scaled_anchors():
    a = trainer.Trainer(TrainConfig(**{**BASE, "seed": 3}),
                        ModelConfig(num_classes=2, layer_config=MINI_LAYERS), device="cpu")
    b = trainer.Trainer(TrainConfig(**{**BASE, "seed": 3}),
                        ModelConfig(num_classes=2, layer_config=MINI_LAYERS), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))
    for size in (64, 416, 608):
        np.testing.assert_array_equal(trainer.scaled_anchors_for(TURBINE_ANCHORS, size),
                                      jtrainer.scaled_anchors_for(TURBINE_ANCHORS, size))


def test_without_cuda_nothing_runs_unless_the_cpu_is_asked_for(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.Trainer(TrainConfig(**BASE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(TrainConfig(**BASE), data_dir, tmp_path, identifier="x", early_stop=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--csv-folder", str(data_dir), "--model-folder", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # raised before writing anything


def test_cli_flags_reach_train(data_dir, tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(cli, "train", lambda tc, *a, **kw: seen.update(tc=tc, args=a, **kw) or 0.5)
    (tmp_path / "best_config.json").write_text(json.dumps(
        {"config": {"lr": 3e-4, "momentum": 0.8, "unknown": 1}, "mAP": 0.4}))
    cli.main(["--csv-folder", str(data_dir), "--config", str(tmp_path / "best_config.json"),
              "--batch-size", "8", "--mosaic", "--weights", "w.conv.74", "--device", "cpu",
              "--identifier", "cli"])
    tc = seen["tc"]
    assert (tc.lr, tc.momentum, tc.batch_size, tc.mosaic, tc.load_weights) == (
        3e-4, 0.8, 8, True, True)
    assert seen["device"] == "cpu" and seen["identifier"] == "cli"
    assert seen["weights_path"] == "w.conv.74"
    assert cli.load_config(tmp_path, "best_config.json") == {
        "lr": 3e-4, "momentum": 0.8, "unknown": 1}
