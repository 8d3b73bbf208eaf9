"""Torch port: the profiler of predict_batch, the eval step and the train
step (tools/profile_serving.py).

On the CPU the profiler sees no device, so the summary's device time is 0
and its idle share 1; the card's numbers come only from a run on a GPU.
"""

import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.tools import profile_serving
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan, init_plan

from helpers import MINI_LAYERS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _predictor():
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    tree = init_plan(build_plan(cfg), torch.Generator().manual_seed(0))
    return Predictor.from_folded(cfg, tree, device="cpu", image_size=64, max_boxes=8)


@pytest.mark.parametrize("int8", [False, True])
def test_profile_predict_batch_on_cpu(int8):
    pred = _predictor()
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    if int8:
        pred.quantize(x)
    summary, table = profile_serving.profile_predict_batch(pred, x, iters=1, warmup=1)
    assert summary["wall_ms"] > 0
    assert summary["device_busy_ms"] == 0 and summary["idle_share"] == 1.0
    assert summary["top"] == []
    # the int8 forward opens a span round every conv's product and one round
    # its epilogue
    assert sorted(summary["host_ms"]) == ["int8.conv", "int8.epilogue"] * int8 + [
        "predict_batch", "predict_batch.forward", "predict_batch.input",
        "predict_batch.postprocess"]
    assert all(v > 0 for v in summary["host_ms"].values())
    assert "Self CPU" in table


def test_profile_eval_step_on_cpu():
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    model = YOLOv3(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32))
    targets = [torch.zeros(2, cfg.anchors_per_scale, s, s, 6) for s in (2, 4, 8)]
    summary, table = profile_serving.profile_eval_step(model, x, targets, iters=1, warmup=1)
    assert summary["wall_ms"] > 0 and summary["device_busy_ms"] == 0
    assert summary["host_ms"] == {}  # the eval step opens no span
    assert "Self CPU" in table


def test_profile_train_step_on_cpu():
    from yolo_for_turbines_tpu_torch.config import TrainConfig
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    trainer = Trainer(TrainConfig(batch_size=2, compute_dtype="float32"), cfg, device="cpu")
    x, targets = profile_serving.train_batch(2, 64, "cpu")
    assert x.shape == (2, 64, 64, 3) and [t.shape[2] for t in targets] == [2, 4, 8]
    # assign_targets gives each box an anchor in every scale
    assert all(float(t[..., 4].max()) == 1.0 for t in targets)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    summary, table = profile_serving.profile_train_step(trainer, x, targets, iters=1, warmup=1)
    assert summary["wall_ms"] > 0 and summary["device_busy_ms"] == 0
    assert sorted(summary["host_ms"]) == ["train_step", "train_step.backward",
                                          "train_step.forward", "train_step.optimizer"]
    assert "Self CPU" in table
    # the profiled steps ran on a copy of the state
    assert trainer.state.step == 0
    assert all(torch.equal(before[k], v) for k, v in trainer.model.state_dict().items())


def test_profiling_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        profile_serving.main([])


def test_eval_profiling_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        profile_serving.main(["--eval"])


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2), (1, 3), (5, 6)], 4.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),   # nested
    ([(5, 6), (0, 1), (0.5, 5.5)], 6.0),  # out of order, chained
    ([(1, 2), (2, 3)], 2.0),             # touching
])
def test_union_length_counts_overlaps_once(intervals, want):
    assert profile_serving.union_length(intervals) == pytest.approx(want)


def test_only_kernels_copies_and_memsets_count_as_device_time():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(device, annotation):
        return SimpleNamespace(device_type=device, is_user_annotation=annotation)

    assert profile_serving._on_device(event(DeviceType.CUDA, False))
    assert not profile_serving._on_device(event(DeviceType.CUDA, True))  # a range's projection
    assert not profile_serving._on_device(event(DeviceType.CPU, False))
    assert not profile_serving._on_device(event(DeviceType.CPU, True))
