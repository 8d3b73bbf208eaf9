"""Torch port: IoU, decode and greedy NMS against the JAX package.

NMS inputs follow tests/test_inference.py (3 images x 400 boxes, 3 classes)
but with distinct scores, so both top-k implementations order the same
candidates. Keep masks must be equal, not close: the port's plain NMS (and
the CUDA kernel, on the card) repeat the JAX arithmetic operation for
operation in f32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu.ops import decode as jdecode
from yolo_for_turbines_tpu.ops import iou as jiou
from yolo_for_turbines_tpu.ops import nms as jnms
from yolo_for_turbines_tpu_torch.ops import decode as tdecode
from yolo_for_turbines_tpu_torch.ops import iou as tiou
from yolo_for_turbines_tpu_torch.ops import nms as tnms
from yolo_for_turbines_tpu_torch.ops.kernels import nms_kernel


def _boxes(seed=0, b=3, n=400):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, n, 6), np.float32)
    boxes[..., 0:2] = rng.uniform(0.2, 0.8, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.05, 0.4, (b, n, 2))
    boxes[..., 4] = (rng.permutation(b * n).reshape(b, n) + 0.5) / (b * n)
    boxes[..., 5] = rng.integers(0, 3, (b, n))
    return boxes


@pytest.mark.parametrize("box_format", ["center", "corners"])
def test_calc_iou_matches_jax(box_format):
    b = _boxes(1)[0, :64, :4]
    want = np.asarray(jiou.calc_iou(b[:, None, :], b[None, :, :], box_format))
    t = torch.from_numpy(b)
    got = tiou.calc_iou(t[:, None, :], t[None, :, :], box_format).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_greedy_interpret(cand, valid, thr, box_format):
    from jax.experimental import pallas as pl

    from yolo_for_turbines_tpu.ops.pallas import nms_kernel as jkernel

    orig = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
        return np.asarray(jkernel.greedy_nms_pallas.__wrapped__(
            jnp.asarray(cand), jnp.asarray(valid), thr, box_format=box_format))


@pytest.mark.parametrize("box_format", ["center", "corners"])
def test_greedy_reference_matches_pallas_interpret(box_format):
    boxes = _boxes(2)
    cand, valid = tnms._top_k_candidates(torch.from_numpy(boxes), 0.3, 128)
    want = _jax_greedy_interpret(cand.numpy(), valid.numpy(), 0.45, box_format)
    got = nms_kernel.greedy_nms_reference(cand, valid, 0.45, box_format)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors dispatch to the same plain version
    assert torch.equal(nms_kernel.greedy_nms(cand, valid, 0.45, box_format), got)


@pytest.mark.parametrize("max_boxes", [128, 256])
def test_batched_nms_matches_jax(max_boxes):
    boxes = _boxes(0)
    kept_j, keep_j = jnms.batched_nms(boxes, 0.45, 0.3, max_boxes=max_boxes)
    kept_t, keep_t = tnms.batched_nms(torch.from_numpy(boxes), 0.45, 0.3,
                                      max_boxes=max_boxes)
    assert keep_t.dtype == torch.bool and kept_t.shape == kept_j.shape
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_j))


def test_nms_single_and_list_match_jax():
    boxes = _boxes(3, b=1)[0]
    kept_j, keep_j = jnms.nms_single(boxes, 0.5, 0.4, max_boxes=64)
    kept_t, keep_t = tnms.nms_single(torch.from_numpy(boxes), 0.5, 0.4, max_boxes=64)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert tnms.nms_to_list(kept_t, keep_t) == jnms.nms_to_list(kept_j, keep_j)


def test_decode_raw_all_matches_jax():
    # 64px image, 2 classes: grids 2, 4, 8 with 3 anchors of 7 channels
    rng = np.random.default_rng(5)
    grid_sizes = (2, 4, 8)
    raws = [rng.normal(scale=2.0, size=(2, s, s, 3 * 7)).astype(np.float32)
            for s in grid_sizes]
    anchors = np.asarray(
        [[[0.28, 0.22], [0.38, 0.48], [0.9, 0.78]],
         [[0.07, 0.15], [0.15, 0.11], [0.14, 0.29]],
         [[0.02, 0.03], [0.04, 0.07], [0.08, 0.06]]], np.float32,
    ) * np.asarray(grid_sizes, np.float32).reshape(-1, 1, 1)
    want = np.asarray(jdecode.decode_raw_all(
        [jnp.asarray(r) for r in raws], jnp.asarray(anchors), grid_sizes, 2))
    got = tdecode.decode_raw_all(
        [torch.from_numpy(r) for r in raws], torch.from_numpy(anchors), grid_sizes, 2)
    assert tuple(got.shape) == want.shape == (2, 3 * (4 + 16 + 64), 6)
    # exp and sigmoid of the two libraries differ by an ulp or two: atol for
    # the normalized coordinates, rtol for widths that exp makes large
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cuda_wrapper_rejects_unsupported_device():
    cand = torch.zeros(1, 4, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nms_kernel.greedy_nms(cand, torch.ones(1, 4, dtype=torch.bool, device="meta"), 0.5)
