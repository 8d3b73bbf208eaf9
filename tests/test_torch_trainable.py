"""Torch port: the trainable YOLOv3 module, its weight bridge and ``fold()``
against the JAX package.

The mini model (tests/helpers.py) at 64px, the same numpy trees in both
packages, float32 on the CPU, on two kinds of weights
(``torch_eval_weights.py``): randomised BN statistics, whose heads are a
constant plus a small variation, and calibrated ones, whose every layer
carries signal. Eval heads within 1e-5 relative RMS of ``apply`` on the
first and 1e-4 on the second, where f32 rounding through 75 normalized
layers reaches 1.3e-5 (train-mode heads 5.7e-5 on either); train-mode
running statistics within 1e-5; the folded tree within 1e-6 of
``fold_params``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_LAYERS
from torch_eval_weights import eval_weights
from yolo_for_turbines_tpu.models import yolov3 as jyolo
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.models.convert import (
    folded_from_numpy,
    trainable_from_numpy,
    trainable_to_numpy,
)
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan

SIZE = 64
# relative RMS of the heads: eval mode on randomised statistics, and where
# every layer is normalized (calibrated weights, or train mode)
HEAD_RTOL = {"random": 1e-5, "calibrated": 1e-4}
TRAIN_HEAD_RTOL = 1e-4


def _trees(kind):
    model, params, stats = eval_weights(seed=3, size=SIZE, calibrated=kind == "calibrated")
    x = np.random.default_rng(4).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    return model, params, stats, x, HEAD_RTOL[kind]


@pytest.fixture(scope="module", params=["random", "calibrated"])
def trees(request):
    return _trees(request.param)


@pytest.fixture(scope="module")
def calibrated():
    """Train mode takes its moments in one pass shifted by the running mean
    in the JAX package, exact only while that mean tracks the batch mean:
    true of calibrated statistics, not of random ones."""
    return _trees("calibrated")


def _port(model, params, stats):
    return trainable_from_numpy(build_plan(model.cfg), params, stats, model.cfg, device="cpu")


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_apply(model, params, stats, x, train, s2d):
    return jyolo.apply(model.plan, params, stats, jnp.asarray(x), activation=model.cfg.activation,
                       train=train, compute_dtype=jnp.float32, s2d_stem=s2d)


@pytest.mark.parametrize("s2d", [True, False])
def test_eval_heads_match_jax(trees, s2d):
    model, params, stats, x, rtol = trees
    port = _port(model, params, stats).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want, _ = _jax_apply(model, params, stats, x, False, s2d)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _rel_rms(g.numpy(), w) <= rtol


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("s2d", [True, False])
def test_train_mode_heads_and_running_stats_match_jax(calibrated, s2d):
    model, params, stats, x, _ = calibrated
    port = _port(model, params, stats).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want, want_stats = _jax_apply(model, params, stats, x, True, s2d)
    for g, w in zip(got, want):
        assert _rel_rms(g.numpy(), w) <= TRAIN_HEAD_RTOL
    _, got_stats = trainable_to_numpy(port)
    got_leaves, want_leaves = _leaves(got_stats), _leaves(want_stats)
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # the statistics moved: train mode updated them, eval mode does not
    assert any(not np.array_equal(g, s) for g, s in zip(got_leaves, _leaves(stats)))
    before = copy.deepcopy(port.state_dict())
    with torch.no_grad():
        port.eval()(torch.from_numpy(x))
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())


def test_fold_matches_fold_params(trees):
    model, params, stats, _, _ = trees
    got = _port(model, params, stats).fold()
    want = jyolo.fold_params(model.plan, params, stats)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_folded_module_matches_eval_module(trees):
    model, params, stats, x, rtol = trees
    port = _port(model, params, stats).eval()
    folded = folded_from_numpy(build_plan(model.cfg), port.fold(), model.cfg).eval()
    with torch.no_grad():
        heads = port(torch.from_numpy(x))
        raw = folded(torch.from_numpy(x))
    for h, r in zip(heads, raw):
        b, a, s, _, c = h.shape
        got = r.reshape(b, s, s, a, c).permute(0, 3, 1, 2, 4)
        assert _rel_rms(got.numpy(), h.numpy()) <= rtol


def test_bridge_round_trip_is_exact(trees):
    model, params, stats, _, _ = trees
    p2, s2 = trainable_to_numpy(_port(model, params, stats))
    for a, b in zip(_leaves((params, stats)), _leaves((p2, s2))):
        np.testing.assert_array_equal(a, b)
    assert [s["conv2"] for s, e in zip(s2, model.plan) if isinstance(e, jyolo.PlanHead)] \
        == [None] * 3


def test_bridge_takes_an_explicit_device(trees):
    model, params, stats, _, _ = trees
    with pytest.raises(TypeError):
        trainable_from_numpy(build_plan(model.cfg), params, stats, model.cfg)
    with pytest.raises(ValueError):
        trainable_from_numpy(build_plan(model.cfg), params[:-1], stats, model.cfg, device="cpu")


def test_seeded_init_is_reproducible_and_bounded():
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    a = YOLOv3(cfg, generator=torch.Generator().manual_seed(5))
    b = YOLOv3(cfg, generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    conv = a.layers[0].conv
    assert conv.bias is None and float(conv.weight.detach().abs().max()) <= 1 / (3 * 9) ** 0.5
    bn = a.layers[0].bn
    assert (bn.eps, bn.momentum) == (1e-5, 0.1)
    assert torch.equal(bn.running_var, torch.ones(4)) and torch.equal(bn.weight, torch.ones(4))
