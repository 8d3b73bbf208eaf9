"""Torch port: the ASHA driver (train/hpo.py) and its train function
(train/trainer.py::HPOTrainFn) against the JAX package's.

- tests/test_hpo.py's cases on the port's driver;
- the port's and the JAX ``tune_model`` with the same deterministic toy
  objective: the same sampled configs, the same rung budgets in the same
  order, identical ``best_config.json`` files (numpy only on both sides,
  the same RNG draws);
- ``HPOTrainFn``: picklable, resumes across rungs, names its trial logs as
  the JAX adapter does, and a two-trial search with the real trainer on the
  mini model (tests/test_hpo_integration.py), on the CPU.
"""

import hashlib
import json
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from helpers import MINI_LAYERS
from torch_hpo_fns import AlwaysFails, FailingOnBadLr, RecordingTrainFn, toy_score
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.train import hpo as jhpo
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.train.hpo import (
    ASHAScheduler,
    Choice,
    GridSearch,
    LogUniform,
    Trial,
    Uniform,
    expand_grid,
    load_config,
    sample_config,
    tune_model,
)


def test_search_space_sampling():
    rng = np.random.default_rng(0)
    space = {
        "lr": LogUniform(1e-4, 1e-1),
        "momentum": Uniform(0.8, 0.99),
        "activation": Choice(("mish", "leaky_relu")),
        "batch_size": 16,
    }
    cfgs = [sample_config(space, rng) for _ in range(50)]
    assert all(1e-4 <= c["lr"] <= 1e-1 for c in cfgs)
    assert all(0.8 <= c["momentum"] <= 0.99 for c in cfgs)
    assert {c["activation"] for c in cfgs} == {"mish", "leaky_relu"}
    assert all(c["batch_size"] == 16 for c in cfgs)
    # the JAX driver's draws, one for one
    jspace = {"lr": jhpo.LogUniform(1e-4, 1e-1), "momentum": jhpo.Uniform(0.8, 0.99),
              "activation": jhpo.Choice(("mish", "leaky_relu")), "batch_size": 16}
    jrng = np.random.default_rng(0)
    assert cfgs == [jhpo.sample_config(jspace, jrng) for _ in range(50)]


def test_asha_rung_budgets():
    s = ASHAScheduler(grace_period=2, reduction_factor=2, max_t=16)
    assert s.rung_budget(0, 0) == 2
    assert s.rung_budget(0, 1) == 4
    assert s.rung_budget(1, 0) == 4
    assert s.rung_budget(0, 3) == 16


def test_asha_promotes_good_kills_bad():
    s = ASHAScheduler(grace_period=2, reduction_factor=2, brackets=1, max_t=8)
    good = Trial(config={}, id=0, bracket=0)
    bad = Trial(config={}, id=1, bracket=0)
    assert s.on_result(good, 0.9)  # first at rung: promoted
    assert not s.on_result(bad, 0.1)  # below the median cutoff


def test_tune_model_finds_optimum(tmp_path):
    """Objective: mAP = 1 - |lr - 0.01| * 10, improves with epochs; ASHA must
    prefer lr near 0.01."""

    def train_fn(config, num_epochs, resume):
        epochs = (resume or 0) + num_epochs
        return toy_score(config["lr"], epochs, 8), epochs

    best = tune_model(train_fn, {"lr": LogUniform(1e-4, 1e-1)}, num_samples=16,
                      model_folder_path=tmp_path, max_epochs=8, seed=0)
    assert abs(best["config"]["lr"] - 0.01) < 0.05
    # best_config.json round-trips through load_config (reference parity)
    assert load_config(tmp_path, "best_config.json") == best["config"]


def test_grid_search_expansion(tmp_path):
    seen = []

    def train_fn(config, num_epochs, resume):
        seen.append(config["warmup"])
        return config["warmup"], None

    tune_model(train_fn, {"warmup": GridSearch((0.01, 0.02, 0.03))}, num_samples=3,
               model_folder_path=tmp_path, max_epochs=2)
    assert set(seen) == {0.01, 0.02, 0.03}
    assert expand_grid({"a": GridSearch((1, 2)), "b": GridSearch((3,)), "c": 4}) == [
        {"a": 1, "b": 3}, {"a": 2, "b": 3}]


@pytest.mark.parametrize("brackets", [1, 2])
def test_tune_model_runs_the_jax_drivers_schedule(tmp_path, brackets):
    """The same toy objective through both drivers: the same calls (config,
    added epochs) in the same order and the same best_config.json bytes."""
    space = {"lr": LogUniform(1e-4, 1e-1), "momentum": Uniform(0.8, 0.99),
             "mosaic": Choice((True, False)), "warmup": GridSearch((0.01, 0.02))}
    jspace = {"lr": jhpo.LogUniform(1e-4, 1e-1), "momentum": jhpo.Uniform(0.8, 0.99),
              "mosaic": jhpo.Choice((True, False)), "warmup": jhpo.GridSearch((0.01, 0.02))}

    def recorder(calls):
        def train_fn(config, num_epochs, resume):
            calls.append((dict(config), num_epochs))
            epochs = (resume or 0) + num_epochs
            return toy_score(config["lr"], epochs, 8) + config["warmup"], epochs
        return train_fn

    kw = dict(num_samples=10, grace_period=1, reduction_factor=2, brackets=brackets,
              max_epochs=8, seed=3)
    got, want = [], []
    best = tune_model(recorder(got), space, model_folder_path=tmp_path / "port", **kw)
    jbest = jhpo.tune_model(recorder(want), jspace, model_folder_path=tmp_path / "jax", **kw)
    assert got == want and len(got) > 10
    assert best == jbest
    assert ((tmp_path / "port" / "best_config.json").read_bytes()
            == (tmp_path / "jax" / "best_config.json").read_bytes())


# ---------------------------------------------------------------------------
# Concurrent (spawned subprocess) trials
# ---------------------------------------------------------------------------


def test_tune_model_concurrent_subprocess_trials(tmp_path):
    """max_concurrent=2 must run trials in >=2 distinct OS processes with
    overlapping run intervals (the reference runs <=2 concurrent Ray trials,
    code/train.py:258-264), and still converge like the sequential path."""
    best = tune_model(RecordingTrainFn(tmp_path), {"lr": Choice((0.3, 0.05, 0.012, 0.001))},
                      num_samples=4, model_folder_path=tmp_path, max_epochs=4,
                      grace_period=1, seed=0, max_concurrent=2)
    assert abs(best["config"]["lr"] - 0.012) < 1e-9

    runs = []
    for p in tmp_path.glob("run_*.txt"):
        pid, start, end = p.read_text().split()
        runs.append((int(pid), float(start), float(end)))
    pids = {r[0] for r in runs}
    assert len(pids) >= 2, f"expected >=2 worker processes, saw {pids}"
    overlap = any(a[0] != b[0] and a[1] < b[2] and b[1] < a[2] for a in runs for b in runs)
    assert overlap, "no two runs from different processes overlapped in time"


def test_tune_model_concurrent_survives_worker_error(tmp_path):
    """A crashing trial scores -inf and the search completes."""
    best = tune_model(FailingOnBadLr(), {"lr": Choice((0.5, 0.01))}, num_samples=2,
                      model_folder_path=tmp_path, max_epochs=2, grace_period=1, seed=0,
                      max_concurrent=2)
    assert best["config"]["lr"] == 0.01


def test_tune_model_concurrent_all_failed_raises(tmp_path):
    """When every subprocess trial fails, tune_model must raise with the
    trial errors instead of writing a garbage best_config.json."""
    with pytest.raises(RuntimeError, match="every HPO trial failed.*boom"):
        tune_model(AlwaysFails(), {"lr": Choice((0.5, 0.01))}, num_samples=2,
                   model_folder_path=tmp_path, max_epochs=2, grace_period=1, seed=0,
                   max_concurrent=2)
    assert not (tmp_path / "best_config.json").exists()


# ---------------------------------------------------------------------------
# HPOTrainFn with the real trainer
# ---------------------------------------------------------------------------


def test_hpo_train_fn_is_picklable_and_needs_a_card(tmp_path, monkeypatch):
    from yolo_for_turbines_tpu_torch.train.trainer import make_hpo_train_fn

    fn = make_hpo_train_fn(tmp_path, tmp_path, num_workers=2, device="cpu")
    fn2 = pickle.loads(pickle.dumps(fn))
    assert fn2.num_workers == 2 and fn2.device == "cpu"
    assert str(fn2.csv_folder_path) == str(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_hpo_train_fn(tmp_path, tmp_path)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from yolo_for_turbines_tpu_torch.data.splits import create_csv_files

    root = tmp_path_factory.mktemp("hposynth")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(11)
    for i in range(8):
        img = rng.uniform(0, 255, (64, 64, 3)).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"im{i}.png")
        np.savetxt(root / "labels" / f"im{i}.txt", np.array([[i % 2, 0.5, 0.5, 0.4, 0.4]]),
                   fmt="%.6f")
    create_csv_files(root / "images", root / "labels", root,
                     {"train": 0.5, "val": 0.25, "test": 0.25})
    return root


@pytest.fixture
def mini_trainer(monkeypatch):
    """The Trainer builds the mini model of the run's activation."""
    import yolo_for_turbines_tpu_torch.train.trainer as trainer_mod

    orig_init = trainer_mod.Trainer.__init__

    def mini(self, train_cfg, model_cfg=None, **kw):
        model_cfg = ModelConfig(num_classes=2, activation=train_cfg.activation,
                                layer_config=MINI_LAYERS)
        orig_init(self, train_cfg, model_cfg=model_cfg, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", mini)


SPACE = {"batch_size": 2, "max_num_steps": 100, "warmup_enabled": False,
         "multi_scale": False, "image_size": 64, "compute_dtype": "float32"}


def test_hpo_train_fn_resumes_and_names_its_logs(synth, tmp_path, mini_trainer):
    from yolo_for_turbines_tpu_torch.train.trainer import make_hpo_train_fn

    fn = make_hpo_train_fn(synth, tmp_path, image_folder=synth / "images",
                           annotation_folder=synth / "labels", num_workers=1, device="cpu")
    config = {"lr": 1e-3, **SPACE}
    score, state = fn(config, 1, None)
    trainer, loaders, logger, epoch = state
    assert epoch == 1 and 0.0 <= score <= 1.0
    step = trainer.state.step
    score2, state2 = fn(config, 2, state)
    assert state2[0] is trainer and state2[1] is loaders and state2[2] is logger
    assert state2[3] == 3 and trainer.state.step == 3 * step
    # the JAX adapter's name: sha1 of the sorted config, 8 hex digits
    name = hashlib.sha1(str(sorted(config.items())).encode()).hexdigest()[:8]
    rows = [json.loads(line) for line in open(tmp_path / f"hpo_trial_{name}_metrics.jsonl")]
    assert [r["epoch"] for r in rows if "epoch" in r] == [1, 3]
    assert [r["mAP"] for r in rows if "epoch" in r] == [score, score2]


def test_asha_with_real_trainer(synth, tmp_path, mini_trainer):
    from yolo_for_turbines_tpu_torch.train.trainer import make_hpo_train_fn

    train_fn = make_hpo_train_fn(synth, tmp_path, image_folder=synth / "images",
                                 annotation_folder=synth / "labels", num_workers=2,
                                 device="cpu")
    space = {"lr": Choice((1e-3, 5e-4)), **SPACE}
    best = tune_model(train_fn, space, num_samples=2, model_folder_path=tmp_path,
                      grace_period=1, max_epochs=2, seed=0)
    assert "config" in best and "mAP" in best
    assert best["config"]["lr"] in (1e-3, 5e-4)
    assert load_config(tmp_path, "best_config.json") == best["config"]
    assert list(tmp_path.glob("hpo_trial_*_metrics.jsonl"))
