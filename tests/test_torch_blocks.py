"""Torch port: building blocks and the folded forward against the JAX package.

Same numpy inputs (seeded) go through the JAX function and its counterpart
in yolo_for_turbines_tpu_torch; everything runs in float32 on the CPU.
Tolerances are atol=1e-5, rtol=1e-4 unless stated: the two frameworks sum
convolutions in different orders, so results agree to f32 rounding, not
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_LAYERS, mini_model
from yolo_for_turbines_tpu.models import blocks as jblocks
from yolo_for_turbines_tpu_torch.models import blocks as tblocks
from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan

ATOL, RTOL = 1e-5, 1e-4


def _nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def test_fold_conv_bn_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    params = {"w": w, "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, 6).astype(np.float32)}
    want = jblocks.fold_conv_bn({k: jnp.asarray(v) for k, v in params.items()},
                                {k: jnp.asarray(v) for k, v in stats.items()})
    got = tblocks.fold_conv_bn(
        {"w": _hwio_to_oihw(w), "scale": torch.from_numpy(params["scale"]),
         "bias": torch.from_numpy(params["bias"])},
        {k: torch.from_numpy(v) for k, v in stats.items()},
    )
    np.testing.assert_allclose(got["w"].numpy(), np.transpose(np.asarray(want["w"]), (3, 2, 0, 1)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv_padding_matches_jax(kernel, stride):
    # odd spatial sizes: stride-2 floor sizes must agree with the explicit
    # ((1, 1), (1, 1)) padding of the JAX conv
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 5, 6)).astype(np.float32)
    pad = 1 if kernel == 3 else 0
    want = np.asarray(jblocks.conv2d(jnp.asarray(x), jnp.asarray(w), stride, pad))
    got = tblocks.conv2d(_nhwc_to_nchw(x), _hwio_to_oihw(w), stride, pad)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_upsample2x_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 5, 4)).astype(np.float32)
    want = np.asarray(jblocks.upsample2x(jnp.asarray(x)))
    got = tblocks.upsample2x(_nhwc_to_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["leaky_relu", "mish"])
def test_activations_match_jax(name):
    # the JAX leaky_relu is an algebraic TPU form of the same function; the
    # two agree to the last bits of f32
    x = np.random.default_rng(3).normal(scale=4.0, size=1000).astype(np.float32)
    want = np.asarray(jblocks.get_activation(name)(jnp.asarray(x)))
    got = tblocks.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _random_bn_stats(stats, seed):
    """Non-trivial BN running stats so the fold is exercised (var stays > 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.3, a.shape).astype(np.float32), stats
    )


@pytest.mark.parametrize("activation", ["leaky_relu", "mish"])
def test_weight_bridge_raw_heads_match_jax(activation):
    model = mini_model(activation=activation)
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = jax.tree_util.tree_map(
        np.asarray, model.fold(params, _random_bn_stats(stats, 5))
    )
    x = np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = model.apply_folded(folded, jnp.asarray(x), compute_dtype=jnp.float32,
                              raw_heads=True)

    plan = build_plan(model.cfg)
    assert plan == tuple(_as_port_plan(model.plan))
    port = folded_from_numpy(plan, folded, model.cfg).eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _as_port_plan(jax_plan):
    """The JAX plan's entries as the port's dataclasses (same fields)."""
    import dataclasses

    from yolo_for_turbines_tpu_torch.models import yolov3 as ty

    return [getattr(ty, type(e).__name__)(**dataclasses.asdict(e)) for e in jax_plan]


def test_full_plan_matches_jax():
    """The 80-class Darknet-53 plan (pure Python, no forward) is the JAX one."""
    from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
    from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu_torch.config import ModelConfig

    assert build_plan(ModelConfig()) == tuple(_as_port_plan(YOLOv3(JaxModelConfig()).plan))
    assert build_plan(ModelConfig(layer_config=MINI_LAYERS)) == tuple(
        _as_port_plan(mini_model(num_classes=80).plan)
    )
