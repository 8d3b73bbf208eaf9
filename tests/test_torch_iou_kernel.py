"""Torch port: pairwise IoU (kernel K3's plain version) against the JAX Pallas
kernel run in interpret mode, as tests/test_inference.py runs it.

K = 200 takes the Pallas wrapper's padding path (zero-area boxes up to 256),
K = 256 none. Both versions compute in f32 in the same operation order, so
they agree to rounding: atol 2.5e-7 on values in [0, 1], rtol 0.
"""

import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from yolo_for_turbines_tpu.ops.pallas import iou_kernel as jax_iou_kernel
from yolo_for_turbines_tpu_torch.ops.iou import calc_iou
from yolo_for_turbines_tpu_torch.ops.kernels import iou_kernel as ik


def _boxes(k, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.1, 0.9, (k, 2))
    wh = rng.uniform(0.02, 0.4, (k, 2))
    return np.concatenate([xy, wh], axis=1).astype(np.float32)


def _jax_iou(boxes, box_format):
    orig = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
        return np.asarray(jax_iou_kernel.pairwise_iou_pallas.__wrapped__(boxes, box_format))


@pytest.mark.parametrize("box_format", ["center", "top_left"])
@pytest.mark.parametrize("k", [200, 256])
def test_plain_matches_jax_kernel(k, box_format):
    boxes = _boxes(k, k)
    want = _jax_iou(boxes, box_format)
    got = ik.pairwise_iou(torch.from_numpy(boxes), box_format)
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-7)


def test_plain_matches_calc_iou():
    boxes = torch.from_numpy(_boxes(64, 1))
    got = ik.pairwise_iou(boxes, "center")
    want = calc_iou(boxes[:, None, :], boxes[None, :, :], "center")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2.5e-7)
    # a box against itself: area / (area + 1e-6), up to the rounding of
    # (x + w) - x against w (about 1 ulp of x, 3e-6 relative for w >= 0.02)
    area = boxes[:, 2] * boxes[:, 3]
    np.testing.assert_allclose(got.diagonal().numpy(), (area / (area + 1e-6)).numpy(),
                               rtol=0, atol=1e-5)


def test_rejects_bad_input():
    with pytest.raises(ValueError, match=r"\(K, 4\)"):
        ik.pairwise_iou(torch.zeros(3, 5))
    # only CPU tensors take the plain version, never a silent fallback
    with pytest.raises(ValueError, match="unsupported device"):
        ik.pairwise_iou(torch.zeros(8, 4, device="meta"))


@pytest.mark.parametrize("k,vector", [(1, False), (255, False), (256, True), (1000, True),
                                      (1001, False)])
def test_launcher_store_variant(k, vector):
    # rows of a (K, K) f32 matrix are 16-byte aligned only when K % 4 == 0;
    # other K take the scalar-store variant of the kernel
    assert ik.vector_stores(k) is vector
    assert vector == ((k * 4) % 16 == 0)


@pytest.mark.parametrize("box_format", ["center", "top_left"])
@pytest.mark.parametrize("k", [1, 200, 255, 256])
def test_per_box_precompute_equals_plain(k, box_format):
    # the CUDA kernel computes x2, y2 and the area once per box (csrc/boxes.cuh,
    # emulated by tests/k1_sweep.py); the plain version computes them per
    # pair. Same operations on the same inputs: equal bit for bit, also on
    # NaN and infinite boxes
    from k1_sweep import pairwise_iou_once

    boxes = torch.from_numpy(_boxes(k, k + 1))
    if k > 8:
        boxes[3, 2] = float("nan")
        boxes[5, 0] = float("inf")
    got = pairwise_iou_once(boxes, box_format)
    want = ik.pairwise_iou(boxes, box_format)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0))


@pytest.mark.parametrize("box_format", ["center", "top_left"])
@pytest.mark.parametrize("k", [200, 256])
def test_per_box_precompute_matches_jax_kernel(k, box_format):
    # against the Pallas kernel in interpret mode: the tolerance of
    # test_plain_matches_jax_kernel (XLA may fuse the f32 ops differently)
    from k1_sweep import pairwise_iou_once

    boxes = _boxes(k, k)
    got = pairwise_iou_once(torch.from_numpy(boxes), box_format)
    np.testing.assert_allclose(got.numpy(), _jax_iou(boxes, box_format), rtol=0, atol=2.5e-7)
