"""Torch port: ``tools/convergence.py``'s fine-tune and high-resolution
recipes end to end on the CPU, in processes of their own.

- R3F's child (the composed recipe with the backbone frozen: k-means
  anchors checked, the seeded ``backbone.conv.74`` written and imported
  frozen, multi-scale, the frozen check of its checkpoint) on the mini
  model at 64px, in a fresh interpreter: it prints one JSON line and leaves
  no module of jax or of the JAX package in ``sys.modules``.
- R4 with ``--finetune``: the high-resolution set, the base run, then two
  chained fine-tune stages, each in its own process, on Darknet-53 at 64px
  (base) and 96px (fine-tune), B = 4: each stage restores the previous
  stage's checkpoint (step and schedule) and every checkpoint is evaluated
  at two sizes, device mAP equal to host ``calc_map``; the last process
  deletes the checkpoints.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from yolo_for_turbines_tpu_torch.tools import convergence as conv

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}

SCRIPT = r"""
import json, sys
sys.path.insert(0, "tests")
from helpers import MINI_LAYERS  # plain data, no jax
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.tools import convergence as conv
from yolo_for_turbines_tpu_torch.train import trainer

mini = lambda act="mish": ModelConfig(num_classes=2, activation=act, layer_config=MINI_LAYERS)
orig = trainer.Trainer.__init__
trainer.Trainer.__init__ = lambda self, tc, model_cfg=None, **kw: orig(
    self, tc, model_cfg=mini(tc.activation), **kw)
conv.Recipe.model_config = lambda self: mini()
work = sys.argv[1]
conv.make_set(conv.R3F.set_dir(work), 16)
conv.main(["--recipe", "R3F", "--device", "cpu", "--work-dir", work, "--batch-size", "4",
           "--max-num-steps", "6", "--image-size", "64", "--compute-dtype", "float32",
           "--seed", "0"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.split(".")[0] == "yolo_for_turbines_tpu")
print(json.dumps({"jax_modules": bad}))
"""


def test_r3f_child_on_the_cpu_imports_no_jax(tmp_path):
    done = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, cwd=REPO, timeout=300, env=ENV)
    assert done.returncode == 0, done.stderr[-3000:]
    *rows, modules = [json.loads(line) for line in done.stdout.splitlines()]
    assert modules == {"jax_modules": []}
    assert len(rows) == 1
    r = rows[0]
    assert (r["recipe"], r["load_weights"], r["freeze_backbone"]) == ("R3F", True, True)
    assert r["multi_scale"] and r["mosaic"] and r["steps"] == 6 and not r["nan_stop"]
    assert r["anchors_source"] == "kmeans++ on run labels" and 0 < r["kmeans_mean_iou"] <= 1
    assert r["anchor_assignment_spot_checks"] == conv.ANCHOR_CHECK_FILES
    assert np.asarray(r["anchors"]).shape == (3, 3, 2)
    f = r["frozen"]
    assert f["frozen_count"] == r["frozen_count"] == conv.FROZEN_CONV74
    assert f["frozen_bitwise_unchanged"] is True
    assert f["frozen_changed"] == [] and f["unfrozen_count"] > 0
    assert (tmp_path / "data" / conv.BACKBONE_FILE).exists()
    assert not list(tmp_path.glob("models_*"))


def test_r4_finetune_chain_end_to_end_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "yolo_for_turbines_tpu_torch.tools.convergence",
           "--recipe", "R4", "--finetune", "96", "--finetune-steps", "3", "6",
           "--finetune-batch-size", "4", "--eval-sizes", "64", "96", "--num-images", "16",
           "--batch-size", "4", "--max-num-steps", "6", "--image-size", "64",
           "--compute-dtype", "float32", "--device", "cpu", "--work-dir", str(tmp_path)]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          cwd=REPO, timeout=600, env=ENV)
    assert done.returncode == 0, done.stderr[-3000:]
    base, ft1, ft2 = [json.loads(line) for line in done.stdout.splitlines()]
    assert base["recipe"] == "R4" and ft1["recipe"] == ft2["recipe"] == "R4-ft96"
    assert base["steps"] == 6 and base["image_size"] == 64 and base["multi_scale"]
    # JAX's numbers stand at the recipe's own sizes; none at +3 or +6 steps
    assert base["jax_best_map"] == 0.567
    assert base["jax_map_by_size"] == {"416": 0.567, "608": 0.811, "832": 0.192}
    assert ft1["jax_map_by_size"] == ft2["jax_map_by_size"] == {}
    # 13 train images: 3 steps an epoch, no eval in 6 steps, so the best
    # checkpoint is the run's start
    assert base["checkpoint_step"] == 0
    for ft, src, past in ((ft1, base, 3), (ft2, ft1, 6)):
        assert ft["restored_from"] == Path(src["checkpoint"]).name
        assert ft["restored_step"] == src["checkpoint_step"] and ft["base_step"] == 0
        assert ft["steps_past_base"] == past and ft["max_num_steps"] == past
        assert (ft["image_size"], ft["batch_size"], ft["lr"]) == (96, 4, 1e-4)
        assert not ft["multi_scale"] and not ft["nan_stop"]
        assert ft["lr_by_step_is_restored_schedule"] and ft["saved_hyper_is_restored"]
        assert ft["first_resumed_lr"] == ft["lr_by_step"][0]
        assert ft["restored_hyper"]["total_steps"] == 6.0  # the base run's schedule
    assert ft1["steps"] == 3 and ft2["steps"] == 6
    for r in (base, ft1, ft2):
        assert set(r["map_by_size"]) == {"64", "96"}
        for v in r["map_by_size"].values():
            assert v["device_map"] == pytest.approx(v["host_map"], abs=1e-6)
            assert v["val_batches"] == 1 and v["k1_launches"] == 0  # no kernel on the CPU
        assert r["anchors"] == base["anchors"]
    assert (tmp_path / "data_hires" / "train.csv").exists()
    assert not list(tmp_path.glob("models_*"))
