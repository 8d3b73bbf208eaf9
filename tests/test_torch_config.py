"""Torch port: its own copies of the JAX package's config and letterbox
packer (``yolo_for_turbines_tpu_torch/config.py``, ``native/``) agree with
the originals, so the port never needs to import them."""

import dataclasses

import numpy as np
import pytest

from yolo_for_turbines_tpu import config as jax_cfg
from yolo_for_turbines_tpu import native as jax_native
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch import native


def test_model_config_fields_match_jax():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_cfg.ModelConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(cfg.ModelConfig)]
    assert got == want
    assert cfg.ModelConfig().channels_per_anchor == jax_cfg.ModelConfig().channels_per_anchor


@pytest.mark.parametrize(
    "name", ["ANCHORS", "DEF_IMAGE_SIZE", "CONF_THRESHOLD", "NMS_IOU_THRESHOLD",
             "STRIDES", "NUM_COCO_CLASSES", "MAP_IOU_THRESHOLD", "TURBINE_ANCHORS",
             "TURBINE_LABELS", "NUM_TURBINE_CLASSES", "TINY_ANCHORS", "COCO_LABELS"])
def test_constants_match_jax(name):
    assert getattr(cfg, name) == getattr(jax_cfg, name)


def test_eval_config_matches_jax():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_cfg.EvalConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(cfg.EvalConfig)]
    assert got == want
    assert dataclasses.asdict(cfg.EvalConfig(max_boxes=64)) == dataclasses.asdict(
        jax_cfg.EvalConfig(max_boxes=64))


@pytest.mark.parametrize("anchors", ["ANCHORS", "TURBINE_ANCHORS"])
@pytest.mark.parametrize("size", [64, 416, 608])
def test_anchor_arrays_match_jax(anchors, size):
    a = getattr(cfg, anchors)
    got = cfg.anchors_array(a)
    assert got.dtype == np.float32 and got.shape == (3, 3, 2)
    np.testing.assert_array_equal(got, jax_cfg.anchors_array(a))
    np.testing.assert_array_equal(cfg.scaled_anchors_array(a, size),
                                  jax_cfg.scaled_anchors_array(a, size))
    np.testing.assert_array_equal(cfg.anchors_array(), jax_cfg.anchors_array())


@pytest.mark.parametrize("size", [320, 416, 608])
def test_grid_sizes_match_jax(size):
    assert cfg.grid_sizes_for(size) == jax_cfg.grid_sizes_for(size)
    assert cfg.grid_sizes_for(size, (32, 16)) == jax_cfg.grid_sizes_for(size, (32, 16))


def test_bundle_manifest_builds_both():
    # what serving.save_predictor writes (JSON turns tuples into lists; the
    # bundle reader turns them back)
    manifest = dataclasses.asdict(jax_cfg.ModelConfig(num_classes=2, activation="mish"))
    manifest["strides"] = tuple(manifest["strides"])
    got, want = cfg.ModelConfig(**manifest), jax_cfg.ModelConfig(**manifest)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.channels_per_anchor == 7


@pytest.mark.parametrize("hw", [(480, 640), (300, 500), (720, 400), (416, 416)])
def test_letterbox_packer_matches_jax_bit_for_bit(hw):
    rng = np.random.default_rng(sum(hw))
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8),
              rng.integers(0, 256, (hw[1], hw[0], 3), dtype=np.uint8)]
    if jax_native.load_library() is None:
        pytest.fail("the JAX package's packer did not build: g++ is needed here")
    want = jax_native.batch_letterbox(images, 416, num_threads=2)
    got = native.batch_letterbox(images, 416, num_threads=2)
    assert got is not None, "the port's letterbox packer did not build"
    assert got.dtype == np.float32 and got.shape == (2, 416, 416, 3)
    np.testing.assert_array_equal(got, want)


def test_train_config_fields_match_jax():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_cfg.TrainConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(cfg.TrainConfig)]
    assert got == want
    assert cfg.TrainConfig().compute_dtype == "bfloat16"  # autocast in the port
    assert cfg.MULTI_SCALE_TRAIN_SIZES == jax_cfg.MULTI_SCALE_TRAIN_SIZES


def test_train_config_json_reads_in_both_packages():
    tc = cfg.TrainConfig(lr=3e-4, batch_size=8, decay_lr=True, compute_dtype="float32")
    assert tc.to_json() == jax_cfg.TrainConfig(**dataclasses.asdict(tc)).to_json()
    assert dataclasses.asdict(jax_cfg.TrainConfig.from_json(tc.to_json())) == dataclasses.asdict(tc)
    extra = tc.to_json()[:-1] + ', "anchors": [1, 2]}'
    assert cfg.TrainConfig.from_json(extra) == tc


@pytest.mark.parametrize("payload", [{"config": {"lr": 0.01}, "mAP": 0.5}, {"lr": 0.02}])
def test_load_hyperparam_config_matches_jax(tmp_path, payload):
    import json

    (tmp_path / "best.json").write_text(json.dumps(payload))
    assert cfg.load_hyperparam_config(tmp_path, "best.json") == jax_cfg.load_hyperparam_config(
        tmp_path, "best.json")
