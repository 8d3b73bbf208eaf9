"""Torch port: the fine-tune and high-resolution recipes of
``tools/convergence.py`` (R3, R3F, R4 and R4's fine-tune) against the JAX
package's ``benchmarks/convergence_run.py``, ``benchmarks/hires_eval.py``
and the functions they call, on the CPU.

- Each recipe's TrainConfig equals, field by field, the JAX TrainConfig its
  driver builds from its flags.
- The high-resolution set and split equal JAX's byte for byte (4 images),
  and the k-means anchors on its labels equal JAX's ``tools/anchors.py``.
- The anchor-assignment check passes on k-means anchors (as the JAX
  driver's does on the same anchors), fails the divergence check on the
  default anchors and follows anchor content, not position (the cases of
  tests/test_convergence_driver.py).
- A ``.conv.74`` written by the port reads the same in both packages (every
  array equal), and the frozen sets agree: the port's frozen parameter names
  are JAX's mask leaves, ``FROZEN_CONV74`` of them.
- One frozen train step from the same state equals JAX's ``make_train_step``
  with that mask at tests/test_torch_train_steps.py's gates; frozen
  parameters stay bit for bit.
- ``train(load_checkpoint=True)`` at a new size (``run_finetune``) restores
  the step and schedule as JAX's ``load_checkpoint(..., lr_override)`` does,
  and logs the lr JAX's schedule gives at every resumed step, 0 past
  ``total_steps`` in both.
- ``map_by_size`` of one checkpoint at three sizes equals JAX's
  ``evaluate_map_device`` on the same weights and the host ``calc_map``.

The mini model (tests/helpers.py) stands in for Darknet-53: it has the same
layer sequence at 1/8 width (so the same 37 conv layers inside cutoff 74),
which ``test_mini_plan_has_darknet53_layout`` checks.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_steps as tsteps
from helpers import MINI_LAYERS, mini_model
from torch_eval_weights import eval_weights
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import TrainConfig as JaxTrainConfig
from yolo_for_turbines_tpu.data import loader as jloader
from yolo_for_turbines_tpu.data import splits as jsplits
from yolo_for_turbines_tpu.data import synthetic as jsynth
from yolo_for_turbines_tpu.models import darknet_weights as jdw
from yolo_for_turbines_tpu.tools import anchors as janchors
from yolo_for_turbines_tpu.train import checkpoint as jckpt
from yolo_for_turbines_tpu.train import evaluate as jevaluate
from yolo_for_turbines_tpu.train import steps as jsteps
from yolo_for_turbines_tpu_torch.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu_torch.data.synthetic import generate_synthetic_dataset
from yolo_for_turbines_tpu_torch.models import darknet_weights as dw
from yolo_for_turbines_tpu_torch.models.convert import load_trainable, trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan
from yolo_for_turbines_tpu_torch.tools import convergence as conv
from yolo_for_turbines_tpu_torch.train import trainer
from yolo_for_turbines_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from yolo_for_turbines_tpu_torch.train.steps import create_train_state

REPO = Path(__file__).resolve().parents[1]
MINI = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
# lr of the resumed steps against JAX's in-step schedule: the same f32
# operations (tests/test_torch_train_steps.py measured 0)
LR_RTOL = 1e-6
# mAP of the same checkpoint, port against JAX and device against host, in
# float32 on calibrated weights (tests/test_torch_trainer.py's gate)
MAP_ATOL = 1e-6


# ---------------------------------------------------------------- configs

def _convergence_run_config(f: dict) -> JaxTrainConfig:
    """``benchmarks/convergence_run.py``'s TrainConfig for parsed flags
    (its lines building ``tc``)."""
    load_weights = f["load_weights"] or f["freeze_backbone"]
    return JaxTrainConfig(
        lr=f["lr"], batch_size=f["batch_size"], max_num_steps=f["max_num_steps"],
        multi_scale=not f["no_multi_scale"], mosaic=f["mosaic"], cache_images=True,
        load_checkpoint=False, decay_lr=f["decay_lr"], warmup=f["warmup"],
        load_weights=load_weights, freeze_backbone=f["freeze_backbone"])


def _hires_eval_config(f: dict) -> JaxTrainConfig:
    """``benchmarks/hires_eval.py``'s base TrainConfig for parsed flags."""
    return JaxTrainConfig(lr=f["lr"], batch_size=f["batch_size"],
                          max_num_steps=f["max_num_steps"], multi_scale=True,
                          cache_images=True, decay_lr=True, warmup=0.05)


def _hires_finetune_config(f: dict) -> JaxTrainConfig:
    """``hires_eval.py``'s fine-tune TrainConfig for parsed flags."""
    return JaxTrainConfig(lr=f["finetune_lr"], batch_size=f["finetune_batch_size"],
                          max_num_steps=f["finetune_total_steps"], multi_scale=False,
                          image_size=f["finetune_size"], cache_images=True,
                          load_checkpoint=True)


# convergence_run.py's defaults (lr 1e-3, B = 32, warmup 0.05) with each
# run's flags (benchmarks/RESULTS.md: R3 the composed recipe, R3F it
# with --freeze-backbone)
_R3_FLAGS = dict(lr=1e-3, batch_size=32, warmup=0.05, max_num_steps=700, no_multi_scale=False,
                 mosaic=True, decay_lr=True, load_weights=True, freeze_backbone=False)
_JAX = {
    "R3": _convergence_run_config(_R3_FLAGS),
    "R3F": _convergence_run_config(dict(_R3_FLAGS, freeze_backbone=True)),
    # hires_eval.py's defaults
    "R4": _hires_eval_config(dict(lr=1e-3, batch_size=32, max_num_steps=700)),
}


@pytest.mark.parametrize("name", ["R3", "R3F", "R4"])
def test_recipe_config_equals_the_jax_driver(name):
    recipe = conv.RECIPES[name]
    assert dataclasses.asdict(recipe.train_config()) == dataclasses.asdict(_JAX[name])
    assert (recipe.backbone, recipe.num_images, recipe.kmeans_anchors) == ("darknet53", 416, True)
    assert recipe.hires == (name == "R4")


def test_finetune_config_equals_hires_eval():
    """``--skip-train --finetune-size 832`` with its defaults, for the total
    step count of a base checkpoint at step 660 plus 440."""
    ft = conv.R4.finetune
    want = _hires_finetune_config(dict(finetune_lr=1e-4, finetune_batch_size=8,
                                       finetune_total_steps=660 + 440, finetune_size=832))
    assert dataclasses.asdict(ft.train_config(660 + 440)) == dataclasses.asdict(want)
    assert ft.steps == (440,) and conv.R4.eval_sizes == (416, 608, 832)


# ---------------------------------------------------------- set and anchors

@pytest.fixture(scope="module")
def hires_root(tmp_path_factory):
    return conv.make_set(tmp_path_factory.mktemp("hires") / "port", 12, hires=True)


def test_hires_set_and_split_equal_jax_byte_for_byte(tmp_path):
    got = conv.make_set(tmp_path / "port", 4, hires=True)
    want = tmp_path / "jax"
    jsynth.generate_synthetic_dataset(want, num_images=4, image_size=(1280, 960),
                                      max_objects=6, box_frac=(0.02, 0.045))
    jsplits.create_csv_files(want / "images", want / "labels", want,
                             {"train": 0.85, "val": 0.15}, image_ext=".jpg")
    files = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    assert len(files) == 4 * 2 + 2
    for f in files:
        assert (got / f).read_bytes() == (want / f).read_bytes(), f


def test_kmeans_anchors_equal_jax(hires_root):
    anchors, meta = conv.run_anchors(conv.R4, hires_root)
    whs = janchors.load_wh_boxes(hires_root / "labels")
    centroids, mean_iou = janchors.kmeans_anchors(whs, k=9)
    want = np.asarray(janchors.group_by_scale(centroids), np.float32)
    assert anchors.shape == (3, 3, 2) and np.array_equal(anchors, want)
    assert meta["kmeans_mean_iou"] == mean_iou and meta["kmeans_num_boxes"] == len(whs)
    assert meta["anchor_assignment_diverges_from_default"] is True


@pytest.fixture(scope="module")
def check_root(tmp_path_factory):
    """tests/test_convergence_driver.py's set: 24 images at 320x240."""
    root = tmp_path_factory.mktemp("anchor_check")
    generate_synthetic_dataset(root, num_images=24, image_size=(320, 240))
    return root


@pytest.fixture(scope="module")
def jax_driver():
    spec = importlib.util.spec_from_file_location(
        "convergence_run", REPO / "benchmarks" / "convergence_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kmeans(root):
    return conv.run_anchors(conv.R3, root)[0]


def test_anchor_check_passes_on_kmeans_anchors_as_jax(check_root, jax_driver):
    anchors = _kmeans(check_root)
    got = conv.check_custom_anchor_assignment(anchors, check_root)
    assert got == jax_driver._assert_custom_anchor_assignment(anchors, check_root)
    assert got == {"anchor_assignment_spot_checks": conv.ANCHOR_CHECK_FILES,
                   "anchor_assignment_diverges_from_default": True}


def test_anchor_check_fails_divergence_on_default_anchors(check_root):
    from yolo_for_turbines_tpu_torch.config import TURBINE_ANCHORS

    with pytest.raises(ValueError, match="identical assignments"):
        conv.check_custom_anchor_assignment(np.asarray(TURBINE_ANCHORS, np.float32), check_root)


def test_anchor_check_tracks_content_not_position(check_root):
    permuted = _kmeans(check_root)[:, ::-1, :].copy()  # reversed within each scale
    meta = conv.check_custom_anchor_assignment(permuted, check_root)
    assert meta["anchor_assignment_diverges_from_default"] is True


# ------------------------------------------------------ backbone and freeze

def test_mini_plan_has_darknet53_layout():
    """The mini model's plan is Darknet-53's at other widths: what a cutoff
    counts in one it counts in the other."""
    def layout(plan):
        return [(type(e).__name__, getattr(e, "num_blocks", None)) for e in plan]

    assert layout(build_plan(MINI)) == layout(build_plan(ModelConfig(num_classes=2)))


def test_conv74_reads_the_same_in_both_packages(tmp_path):
    path = conv.write_backbone(tmp_path / conv.BACKBONE_FILE, MINI)
    jmodel = mini_model(2, "mish")
    start = YOLOv3(MINI, generator=torch.Generator().manual_seed(5))
    params, stats = trainable_to_numpy(start)
    jp, js, mask, consumed = jdw.load_darknet_weights(str(path), jmodel.plan, params, stats,
                                                      freeze=True)
    names, got_consumed = dw.load_darknet_into(str(path), start, freeze=True)
    gp, gs = trainable_to_numpy(start)
    for got, want in ((gp, jp), (gs, js)):
        g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))
    assert got_consumed == consumed
    # the frozen sets: the port's names are JAX's mask leaves
    assert sorted(names) == sorted(dw.frozen_parameter_names(start, mask))
    assert sum(jax.tree_util.tree_leaves(mask)) == len(names) == conv.FROZEN_CONV74
    # and the file is the seeded init the tool writes, whatever model it loads into
    seeded = YOLOv3(MINI, generator=torch.Generator().manual_seed(conv.BACKBONE_SEED))
    sp = dict(seeded.named_parameters())
    assert all(torch.equal(p, sp[n]) for n, p in start.named_parameters() if n in set(names))


def test_frozen_step_equals_jax(tmp_path):
    """One train step, float32, from calibrated weights written as a
    ``.conv.74`` and imported frozen by both packages."""
    model, params, stats = tsteps.step_weights()
    path = tmp_path / conv.BACKBONE_FILE
    dw.export_darknet_weights(build_plan(model.cfg), params, stats, str(path))
    jp, js, mask, _ = jdw.load_darknet_weights(str(path), model.plan, params, stats, freeze=True)
    port = tsteps._port(model, params, stats)
    names, _ = dw.load_darknet_into(str(path), port, freeze=True)
    assert len(names) == conv.FROZEN_CONV74
    cfg, jcfg = tsteps._cfg()
    batches = tsteps._batches(13)[:1]
    want = tsteps._jax_run(model, jp, js, jcfg, batches, frozen_mask=mask)[0]
    state, got = tsteps._port_run(port, cfg, batches, frozen=names)
    got = got[0]
    assert not any(p.requires_grad for n, p in port.named_parameters() if n in set(names))
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == len(list(port.parameters())) - conv.FROZEN_CONV74
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= tsteps.LOSS_RTOL * abs(v), k
    flags = [f for _, f in tsteps._leaves(mask)]
    moved = tsteps._sub(got["params"], params)
    want_moved = tsteps._sub(want["params"], params)
    for flag, (path_, a), (_, b), (_, gp), (_, wp), (_, p0) in zip(
            flags, tsteps._leaves(moved), tsteps._leaves(want_moved),
            tsteps._leaves(got["params"]), tsteps._leaves(want["params"]),
            tsteps._leaves(params)):
        if flag:
            assert np.array_equal(gp, p0) and np.array_equal(wp, p0), path_
        else:
            assert tsteps._rel_rms(a, b) <= tsteps.LEAF_RTOL, path_
            assert np.any(a != 0), path_
    # frozen BN layers update their running statistics in both
    assert tsteps._worst(got["stats"], want["stats"]) <= tsteps.STATS_RTOL


# ------------------------------------------------------- resume and eval

@pytest.fixture
def mini(monkeypatch):
    """train() and the tool build the mini model instead of Darknet-53."""
    orig = trainer.Trainer.__init__

    def patched(self, train_cfg, model_cfg=None, **kw):
        orig(self, train_cfg, model_cfg=ModelConfig(num_classes=2, activation=train_cfg.activation,
                                                    layer_config=MINI_LAYERS), **kw)

    monkeypatch.setattr(trainer.Trainer, "__init__", patched)
    monkeypatch.setattr(conv.Recipe, "model_config",
                        lambda self: ModelConfig(num_classes=2, activation="mish",
                                                 layer_config=MINI_LAYERS))


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """14 JPEGs at 96x72, split 85 / 15: 11 train images, 2 batches of 4."""
    root = tmp_path_factory.mktemp("small")
    generate_synthetic_dataset(root, num_images=14, image_size=(96, 72), seed=2)
    jsplits.create_csv_files(root / "images", root / "labels", root, conv.SPLIT,
                             image_ext=".jpg")
    return root


BASE_STEP = 5
BASE = dict(lr=1e-3, batch_size=4, max_num_steps=8, warmup=0.25, decay_lr=True,
            multi_scale=False, image_size=64, compute_dtype="float32")


def test_resume_restores_step_and_schedule_as_jax(mini, small_root, tmp_path):
    """A base state at step 5 of an 8-step cosine schedule (2 warmup steps),
    resumed at 96px for 7 steps with lr 1e-4: steps 5 to 11, the last four
    past ``total_steps``."""
    pt = trainer.Trainer(TrainConfig(**BASE), device="cpu")
    pt.state.step = BASE_STEP
    base = tmp_path / "best_model_base.ckpt"
    save_checkpoint(pt.state, base)
    jmodel = mini_model(2, "mish")
    jstate, _, _ = jsteps.create_train_state(jmodel, JaxTrainConfig(**BASE),
                                             rng=jax.random.PRNGKey(0))
    jckpt.save_checkpoint(jstate._replace(step=jnp.asarray(BASE_STEP, jnp.int32)),
                          tmp_path / "jax_base")

    recipe = dataclasses.replace(conv.R4, finetune=conv.Finetune(size=96, batch_size=4))
    steps_past = 7
    ft = recipe.finetune.train_config(BASE_STEP + steps_past)
    jtemplate, _, _ = jsteps.create_train_state(
        jmodel, JaxTrainConfig(**dataclasses.asdict(ft)), rng=jax.random.PRNGKey(1))
    jrestored = jckpt.load_checkpoint(jtemplate, tmp_path / "jax_base", lr_override=ft.lr)
    jhyper = {k: float(v) for k, v in jrestored.hyper.items()}

    # the port's load_checkpoint alone
    state = load_checkpoint(trainer.Trainer(ft, device="cpu").state, base, lr_override=ft.lr)
    assert state.step == int(jrestored.step) == BASE_STEP
    assert {k: np.float32(v) for k, v in state.hyper.items()} == \
        {k: np.float32(v) for k, v in jhyper.items()}

    # train(load_checkpoint=True) through the tool
    r = conv.run_finetune(recipe, 0, small_root, tmp_path, base, BASE_STEP, steps_past, "cpu",
                          conv.run_anchors(recipe, small_root)[0], compute_dtype="float32")
    assert r["restored_step"] == BASE_STEP and r["steps"] == steps_past
    assert r["lr_by_step_is_restored_schedule"] and r["saved_hyper_is_restored"]
    want = [float(jsteps.scheduled_lr(jnp.asarray(s, jnp.int32), jrestored.hyper))
            for s in range(BASE_STEP, BASE_STEP + steps_past)]
    np.testing.assert_allclose(r["lr_by_step"], want, rtol=LR_RTOL, atol=0)
    assert r["first_resumed_lr"] == r["lr_by_step"][0] > 0
    # past total_steps (8) the lr is exactly 0 in both
    assert r["lr_by_step"][-4:] == want[-4:] == [0.0] * 4
    assert r["lr_zero_from_step"] == BASE["max_num_steps"]
    # no eval in 7 steps: the saved checkpoint is the restored state
    assert r["checkpoint_step"] == BASE_STEP
    assert r["moved_parameters"] == r["moved_bn_buffers"] == 0


@pytest.fixture(scope="module")
def big_box_root(tmp_path_factory):
    """14 JPEGs at 96x72 with one object of 45-60% of the short side each:
    random calibrated weights then hit some of them (a nonzero mAP)."""
    root = tmp_path_factory.mktemp("big_boxes")
    generate_synthetic_dataset(root, num_images=14, image_size=(96, 72), seed=3,
                               max_objects=1, box_frac=(0.45, 0.6))
    jsplits.create_csv_files(root / "images", root / "labels", root, conv.SPLIT,
                             image_ext=".jpg")
    return root


def test_map_by_size_equals_jax_and_host(mini, big_box_root, tmp_path):
    """One checkpoint of calibrated weights at 64, 96 and 128px, float32."""
    small_root = big_box_root
    jmodel, params, stats = eval_weights(seed=31, size=64, calibrated=True,
                                         model=mini_model(2, "mish"))
    port = YOLOv3(ModelConfig(num_classes=2, activation="mish", layer_config=MINI_LAYERS),
                  generator=torch.Generator().manual_seed(0))
    load_trainable(port, params, stats)
    ckpt = tmp_path / "best_model_x.ckpt"
    save_checkpoint(create_train_state(port, TrainConfig(**BASE)), ckpt)
    anchors, _ = conv.run_anchors(conv.R4, small_root)
    sizes = (64, 96, 128)
    got = conv.map_by_size(ckpt, small_root, conv.R4, anchors, "cpu", sizes, "float32")
    jstate, _, _ = jsteps.create_train_state(jmodel, JaxTrainConfig(**BASE),
                                             params=params, batch_stats=stats)
    for size in sizes:
        _, val_loader, _ = jloader.get_loaders(
            small_root, batch_size=32, anchors=anchors, num_workers=1, image_size=size,
            image_folder=small_root / "images", annotation_folder=small_root / "labels")
        want = jevaluate.evaluate_map_device(val_loader, jmodel, jstate, anchors, num_classes=2,
                                             compute_dtype=jnp.float32)
        g = got[str(size)]
        assert g["device_map"] == pytest.approx(float(want), abs=MAP_ATOL), size
        assert g["device_map"] == pytest.approx(g["host_map"], abs=MAP_ATOL), size
        assert g["val_batches"] == 1
    maps = [g["device_map"] for g in got.values()]
    assert max(maps) > 0 and len(set(maps)) > 1, maps  # nothing vacuous; the sizes differ
