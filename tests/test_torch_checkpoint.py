"""Torch port: checkpoints (``yolo_for_turbines_tpu_torch/train/checkpoint.py``).

A round trip through the file is exact bit for bit: the module's
``state_dict`` (running statistics included), the SGD momentum buffers,
the step and the schedule's numbers; a restored state steps on exactly as
the saved one does. ``lr_override`` replaces the restored peak lr, as the
JAX package's ``load_checkpoint`` does.
"""

import numpy as np
import pytest
import torch

from helpers import MINI_LAYERS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu_torch.config import (
    ANCHORS,
    ModelConfig,
    TrainConfig,
    scaled_anchors_array,
)
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3
from yolo_for_turbines_tpu_torch.train import steps
from yolo_for_turbines_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

SIZE = 64
CFG = TrainConfig(lr=1e-3, batch_size=2, max_num_steps=50, warmup=0.1, decay_lr=True,
                  compute_dtype="float32")


def _state(seed, cfg=CFG, frozen=()):
    model = YOLOv3(ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                   generator=torch.Generator().manual_seed(seed))
    return steps.create_train_state(model, cfg, frozen)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32))
    y = []
    for s in (2, 4, 8):
        t = np.zeros((2, 3, s, s, 6), np.float32)
        t[:, 0, s // 2, s // 2] = [0.5, 0.5, 1.0, 1.5, 1.0, 1.0]
        y.append(torch.from_numpy(t))
    anchors = torch.from_numpy(scaled_anchors_array(ANCHORS, SIZE))
    return x, tuple(y), anchors


def _assert_same(a: steps.TrainState, b: steps.TrainState):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        ma = a.optimizer.state.get(p, {}).get("momentum_buffer")
        mb = b.optimizer.state.get(q, {}).get("momentum_buffer")
        assert (ma is None) == (mb is None)
        if ma is not None:
            assert torch.equal(ma, mb)
    assert a.step == b.step and a.hyper == b.hyper


@pytest.fixture(scope="module")
def trained():
    state = _state(0)
    step = steps.make_train_step(CFG)
    for i in range(3):
        step(state, *_batch(i))
    return state


def test_round_trip_is_bit_for_bit(trained, tmp_path):
    path = tmp_path / "ckpt.pt"
    save_checkpoint(trained, path)
    other = _state(1)
    assert not torch.equal(next(other.model.parameters()), next(trained.model.parameters()))
    restored = load_checkpoint(other, path)
    assert restored is other
    _assert_same(trained, restored)
    # the file holds tensors, numbers and containers only
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"model", "optimizer", "step", "hyper"}
    assert payload["step"] == 3
    assert any(k.endswith("running_var") for k in payload["model"])


def test_restored_state_steps_on_identically(trained, tmp_path):
    path = tmp_path / "ckpt.pt"
    save_checkpoint(trained, path)
    a, b = load_checkpoint(_state(2), path), load_checkpoint(_state(3), path)
    step = steps.make_train_step(CFG)
    ma, mb = step(a, *_batch(7)), step(b, *_batch(7))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    _assert_same(a, b)


def test_snapshot_is_a_host_copy(trained, tmp_path):
    snap = trained.snapshot()
    state = load_checkpoint(_state(4), _saved(snap, tmp_path))
    steps.make_train_step(CFG)(state, *_batch(9))
    # the live state moved on; the snapshot did not
    assert snap["step"] == 3 and state.step == 4
    key = next(k for k in snap["model"] if k.endswith("weight"))
    assert not torch.equal(snap["model"][key], state.model.state_dict()[key])
    again = load_checkpoint(_state(5), _saved(snap, tmp_path))
    _assert_same(again, load_checkpoint(_state(6), _saved(trained.snapshot(), tmp_path)))


def _saved(payload, tmp_path):
    path = tmp_path / "snap.pt"
    save_checkpoint(payload, path)
    return path


@pytest.mark.parametrize("override", [None, 5e-2])
def test_lr_override_replaces_the_peak_lr(trained, tmp_path, override):
    path = tmp_path / "ckpt.pt"
    save_checkpoint(trained, path)
    state = load_checkpoint(_state(8), path, lr_override=override)
    want = dict(trained.hyper)
    if override is not None:
        want["lr"] = override
    assert state.hyper == want
    steps.make_train_step(CFG)(state, *_batch(10))
    # the step wrote the schedule's lr of step 3 under the restored numbers
    lr = state.optimizer.param_groups[0]["lr"]
    assert lr == steps.scheduled_lr(3, want)
    # step 3 of a 5-step warmup: 60% of the way to the (overridden) peak
    peak = trained.hyper["lr"] if override is None else override
    assert lr == pytest.approx(peak * 0.6, rel=1e-5)


def test_frozen_state_round_trips(tmp_path):
    names = ["layers.0.conv.weight", "layers.0.bn.weight", "layers.0.bn.bias"]
    state = _state(11, frozen=names)
    steps.make_train_step(CFG)(state, *_batch(12))
    path = tmp_path / "frozen.pt"
    save_checkpoint(state, path)
    restored = load_checkpoint(_state(13, frozen=names), path)
    _assert_same(state, restored)
